#!/usr/bin/env python3
"""A model of K1's lane schedules: how many warp steps each one takes.

    JAX_PLATFORMS=cpu python3 tests/torch_lane_model.py [--res N] [--spp S]
                                                        [--depth D] [scene ...]

Each path's length (the bounces it enters live) comes from the port's
plain tracer run one bounce at a time on the CPU
(``megakernel.init_state``/``megakernel.bounces``).  From the lengths it
counts the steps of a warp of 32 lanes (a step: one bounce of each lane
that has a path) under:

* ``lockstep``: the loop of K1 before the lane schedule: a thread per
  pixel, ``for sample { for d < depth { bounce } }``; a warp of 32
  neighbouring pixels takes, per sample, as many steps as its longest path;
* ``pool(k)``: the lane schedule (``csrc/megakernel.cu`` ``k1_trace``): a
  block of 128 lanes takes a pool of 128 k neighbouring pixels, each lane
  the pool's next pixel (in lane order) once its own has run its samples;
  a lane starts its pixel's next sample in the step after its path ends;
  ``pool(1)`` is that in-lane start alone.

It prints each schedule's lane use: the live bounces over the lane slots
of the warp steps.  These are step counts, not times: the card decides
how much of a step count becomes time.
"""

import argparse
import dataclasses
import os
import sys

import numpy as np
import torch

HERE = os.path.dirname(os.path.abspath(__file__))
sys.path.insert(0, os.path.dirname(HERE))

WARP, BLOCK = 32, 128


def path_lengths(job, it0, n_spp):
    """(n_spp, P) int64: the bounces each path of each sample enters live,
    from the plain tracer (``megakernel.prepare``'s ``job``, on the CPU)."""
    from pathtrace_tpu_torch.ops.cuda import megakernel as K

    width, height, depth = job["width"], job["height"], job["depth"]
    sc = K.plain_scene(**job)
    pix = torch.arange(width * height, dtype=torch.int64)
    out = np.zeros((n_spp, pix.numel()), np.int64)
    counts = torch.zeros(depth, dtype=torch.int64)
    for s in range(n_spp):
        it = (it0 + s) & 0xFFFFFFFF
        st = K.init_state(sc, it, pix, width, height)
        for d in range(depth):
            out[s] += st["live"].numpy()
            st = K.bounces(sc, st, it, pix, d, d + 1, counts)
    return out


def lockstep(lengths, depth):
    """The lockstep loop: (warp steps, per-sample counts (n_spp, depth)
    from its ballots: the lanes live entering each bounce)."""
    n_spp, n = lengths.shape
    pad = np.zeros((n_spp, -(-n // WARP) * WARP), np.int64)
    pad[:, :n] = lengths
    warps = pad.reshape(n_spp, -1, WARP)
    counts = np.array([[int((warps[s] > d).sum()) for d in range(depth)]
                       for s in range(n_spp)], np.int64)
    return int(warps.max(axis=2).sum()), counts


def pool(lengths, lane_px, trace=False):
    """The lane schedule with pools of ``BLOCK * lane_px`` pixels: (warp
    steps, and with ``trace`` each lane's steps as (block, lane) -> list
    of (pixel, sample, bounce))."""
    n_spp, n = lengths.shape
    per = BLOCK * lane_px
    n_blocks = -(-n // per)
    steps = 0
    lanes = {}
    for b in range(n_blocks):
        size = min(per, n - b * per)
        work = lengths[:, b * per:b * per + size]  # (n_spp, size)
        pixel = np.arange(BLOCK)
        done = pixel >= size
        sample = np.zeros(BLOCK, np.int64)
        bnc = np.zeros(BLOCK, np.int64)
        taken = BLOCK
        finish = np.zeros(BLOCK, np.int64)
        t = 0
        while not done.all():
            run = ~done
            if trace:
                for ln in np.flatnonzero(run):
                    lanes.setdefault((b, int(ln)), []).append(
                        (b * per + int(pixel[ln]), int(sample[ln]),
                         int(bnc[ln])))
            t += 1
            bnc[run] += 1
            ended = run & (bnc >= work[np.minimum(sample, n_spp - 1),
                                       np.minimum(pixel, size - 1)])
            sample[ended] += 1
            bnc[ended] = 0
            need = ended & (sample == n_spp)
            finish[need] = t
            # the lanes that need a pixel take the pool's next, in lane order
            q = taken + np.cumsum(need) - 1
            taken += int(need.sum())
            pixel = np.where(need, q, pixel)
            sample[need] = 0
            done = done | (need & (q >= size))
        steps += int(finish.reshape(-1, WARP).max(axis=1).sum())
    return (steps, lanes) if trace else steps


def lane_use(lengths, steps):
    return float(lengths.sum()) / (steps * WARP)


def main(argv):
    p = argparse.ArgumentParser()
    p.add_argument("scenes", nargs="*", default=["cornell", "cornell_mesh"])
    p.add_argument("--res", type=int, default=64)
    p.add_argument("--spp", type=int, nargs="+", default=[8, 1])
    p.add_argument("--depth", type=int, default=8)
    p.add_argument("--k", type=int, nargs="+", default=[1, 2, 4, 8, 16])
    args = p.parse_args(argv)
    import pathtrace_tpu_torch as ptt
    from pathtrace_tpu_torch.ops.cuda import megakernel as K

    for name in args.scenes:
        scene = ptt.load_scene(os.path.join(os.path.dirname(HERE), "scenes",
                                            f"{name}.txt"))
        scene = dataclasses.replace(scene, resolution=(args.res, args.res),
                                    trace_depth=args.depth)
        job = K.prepare(scene, "cpu")
        lengths = path_lengths(job, 1, max(args.spp))
        for spp in args.spp:
            ln = lengths[:spp]
            slots = ln.sum() / ln.shape[1] / spp
            base, _ = lockstep(ln, args.depth)
            line = [f"lockstep {lane_use(ln, base):.4f} "
                    f"({base * WARP / ln.shape[1]:.2f} slots a pixel-lane)"]
            for k in args.k:
                st = pool(ln, k)
                line.append(f"pool({k}) {lane_use(ln, st):.4f} "
                            f"({st * WARP / ln.shape[1]:.2f}, "
                            f"{base / st:.3f}x fewer steps)")
            print(f"{name} {args.res}x{args.res} d{args.depth} {spp} spp: "
                  f"mean path {slots:.3f} bounces; " + "; ".join(line),
                  flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main(sys.argv[1:]))
