"""Headless CLI: ``python -m pathtrace_tpu_torch.cli scene.txt``.

Counterpart of ``pathtrace_tpu/cli.py`` (the role of the reference's
src/main.cpp): parse the scene, run ITERATIONS samples per pixel in
chunks, log each chunk (ms/iter, Mrays/s of live path segments, or a
JSON line with ``--stats``), and save
``<FILE>.<start time>.<N>samp.png``.

``--device cuda`` (the default) runs the CUDA megakernel K1 (with
``--nee``, its NEE section K2; on a mesh scene, its BVH section K3; on a
scene with TEXTURE or BUMPTEX maps, its texture section K4) and raises
when there is no GPU; ``--split-depth N`` runs the split engine and
``--engine sorted`` the sorted engine instead, on the span kernel K5
(and the split engine's tile table on the scan K6), with K1's image.
``--engine xla`` runs the wavefront integrator
(``render/integrator.pathtrace_batch``, torch ops on the device), whose
``--compaction sort`` densifies the live rays after every bounce on the
scan K6; ``--engine planes`` runs the megakernel's plain version
(``megakernel.trace_plain``) on the device, the role of the reference's
fused-plane engine, its texels read from a float table (a map off the u8
grid renders there).  ``--device cpu`` runs the plain PyTorch versions
(``--interpret``, the reference's flag for its kernels' CPU mode, means
the same).  A chunk is one call of K1, or ``--chunk`` samples of an
engine's per-sample loop.  ``--compaction sort`` on the other engines
renders with masking, as the reference's tiled engines do, after a
warning.

The progressive render's options, on every engine, as the reference's:
``--checkpoint FILE`` with ``--checkpoint-every K`` saves the
accumulation and the iteration count every K iterations and at the end
(``utils/checkpoint.py``), and
``--resume`` continues from FILE at its iteration, bit-identical to a
render that never stopped (the chunk boundaries are the same);
``--preview-every K`` writes ``<image name>.preview.png`` in the
temporary directory every K iterations (``tools/watch.py`` draws it);
``--interactive CTRL`` polls the control file CTRL between chunks
(``render/interact.py``): a camera key restarts the accumulation at
iteration 0, space saves the image, esc or q stops.  The accumulation
stays on the device; it is copied to the host for a checkpoint, a
preview or the image.

``--shard`` renders through ``parallel/shard.make_sharded_renderer``,
sample-sharded, as the reference's: ``--engine pallas`` on K1,
``planes`` on the planes engine, every other engine (``sorted`` too, as
the reference's) on the wavefront, ``--split-depth`` ignored.  Under
``torchrun`` (``RANK``, ``WORLD_SIZE``, ``LOCAL_RANK`` in the
environment) each process joins the group on ``--device``'s backend
(nccl for the card, gloo for the CPU) and renders on
``cuda:{LOCAL_RANK}``; without it, a world of this process alone.  Each
chunk's samples must divide among the processes.  Every rank holds the
whole image; rank 0 alone prints, writes the image, the checkpoints and
the previews and polls ``--interactive``'s file, whose events it sends to
the others.
"""

from __future__ import annotations

import argparse
import dataclasses
import json
import os
import sys
import tempfile
import time

import torch

PREFIX = "[pathtrace_tpu_torch]"


def preview_path(image_name):
    """Where ``--preview-every`` writes: ``<image_name>.preview.png`` in
    the temporary directory (``$TMPDIR``, else /tmp, as the reference's
    /tmp)."""
    return os.path.join(tempfile.gettempdir(), f"{image_name}.preview.png")


def build_parser() -> argparse.ArgumentParser:
    p = argparse.ArgumentParser(
        prog="pathtrace_tpu_torch",
        description="path tracer on PyTorch + a hand-written CUDA "
                    "megakernel",
    )
    p.add_argument("scene", help="scene file (reference text format)")
    p.add_argument("--spp", type=int, default=None,
                   help="override ITERATIONS (samples per pixel)")
    p.add_argument("--depth", type=int, default=None,
                   help="override DEPTH (max bounces)")
    p.add_argument("--res", type=int, nargs=2, default=None,
                   metavar=("W", "H"), help="override RES")
    p.add_argument("--out", default=None,
                   help="output path (default: reference naming convention)")
    p.add_argument("--hdr", action="store_true",
                   help="also write a Radiance .hdr")
    p.add_argument("--chunk", type=int, default=8,
                   help="samples per pixel per kernel launch")
    p.add_argument("--seed", type=int, default=0,
                   help="iteration-stream offset (0 matches the reference)")
    p.add_argument("--stats", action="store_true",
                   help="emit per-chunk JSON stats lines")
    p.add_argument("--device", choices=["cuda", "cpu"], default="cuda",
                   help="cuda = the CUDA kernels (raises without a GPU); "
                        "cpu = their plain PyTorch versions")
    p.add_argument("--engine", choices=["pallas", "sorted", "planes", "xla"],
                   default="pallas",
                   help="pallas = the forward megakernel (K1); sorted = one "
                        "span kernel (K5) per bounce, the rays re-sorted "
                        "between bounces; planes = the megakernel's plain "
                        "version in torch ops; xla = the wavefront "
                        "integrator in torch ops (sort-compaction on K6)")
    p.add_argument("--compaction", choices=["mask", "sort"], default="mask",
                   help="sort = the wavefront's sort-densify mode (--engine "
                        "xla); the other engines mask dead lanes instead "
                        "(same image)")
    p.add_argument("--split-depth", type=int, default=0,
                   help="pallas engine: trace bounces [0, N) on every "
                        "pixel, then [N, depth) on the tiles with a live "
                        "path (span kernel K5, tile table by the scan K6)")
    p.add_argument("--nee", action="store_true",
                   help="next-event estimation: one light sample and shadow "
                        "ray per light at each non-refractive hit")
    p.add_argument("--rr", action="store_true",
                   help="Russian roulette from bounce 3 on")
    p.add_argument("--preview-every", type=int, default=0, metavar="K",
                   help="write a preview PNG every K iterations")
    p.add_argument("--shard", action="store_true",
                   help="shard the samples over the processes of the "
                        "torchrun group (a world of one without torchrun)")
    p.add_argument("--checkpoint", default=None,
                   help="checkpoint file for save/resume")
    p.add_argument("--checkpoint-every", type=int, default=0, metavar="K")
    p.add_argument("--resume", action="store_true",
                   help="resume from --checkpoint if it exists")
    p.add_argument("--interactive", default=None, metavar="CTRL",
                   help="poll the CTRL file for key events between chunks "
                        "(written by tools.watch --ctrl): arrows orbit, "
                        "wasd/rf move, space saves, esc or q quits; a "
                        "camera key restarts the accumulation")
    p.add_argument("--interpret", action="store_true",
                   help="the reference's CPU mode of its kernels: here "
                        "--device cpu, the plain versions")
    return p


def _engine(scene, device, args):
    """(the engine's name, ``run(it0, n)``: the radiance (P,3) summed over
    ``n`` samples from iteration ``it0`` and the counts), the scene's
    tables resident on ``device`` for the whole render."""
    if args.shard:
        from pathtrace_tpu_torch.parallel import shard

        # the reference's CLI: only the wavefront densifies
        compaction = args.compaction if args.engine == "xla" else "mask"
        name = {"pallas": "pallas (K1)",
                "planes": "planes (the megakernel's plain version)"}.get(
            args.engine, f"xla (wavefront, compaction {compaction})")
        return f"{name}, sample-sharded", shard.make_sharded_renderer(
            scene, compaction, engine=args.engine, nee=args.nee, rr=args.rr,
            device=device)
    if args.engine == "xla":
        from pathtrace_tpu_torch.ops.cuda.megakernel import resolve_device
        from pathtrace_tpu_torch.render import integrator

        scene = integrator.resident(scene, resolve_device(device))

        def run(it0, n):
            return integrator.pathtrace_batch(
                scene, it0, n, args.compaction, remat=False, nee=args.nee,
                rr=args.rr, device=device)
        return f"xla (wavefront, compaction {args.compaction})", run
    from pathtrace_tpu_torch.ops.cuda import span
    from pathtrace_tpu_torch.ops.cuda.megakernel import prepare, trace_plain

    job = prepare(scene, device, nee=args.nee, rr=args.rr,
                  texels="f32" if args.engine == "planes" else "u32")
    if args.engine == "planes":
        def run(it0, n):
            return trace_plain(**job, it0=it0, n_spp=n)
        return "planes (the megakernel's plain version)", run
    return span.engine(
        scene, job, split=args.split_depth if args.split_depth > 0 else None,
        sort=args.engine == "sorted")


def main(argv=None) -> int:
    args = build_parser().parse_args(argv)
    if args.interpret:
        args.device = "cpu"
    if not args.shard:
        return _render(args, None)
    from pathtrace_tpu_torch.parallel import shard

    made = shard.join_world(args.device)
    try:
        return _render(args, shard.make_mesh(device=args.device))
    finally:
        if made:
            torch.distributed.destroy_process_group()


def _render(args, mesh):
    """The render of ``main``; ``mesh``: ``--shard``'s
    (``parallel/shard.Mesh``), or None."""
    lead = mesh is None or mesh.rank == 0

    def say(*a, **k):  # rank 0 alone prints
        if lead:
            print(*a, **k)

    if mesh is not None:
        say(f"{PREFIX} --shard: a world of {mesh.size} process(es), "
            f"backend {torch.distributed.get_backend(mesh.group)}, rank 0 "
            f"on {mesh.device}", flush=True)
    if args.compaction == "sort" and args.engine != "xla":
        say(f"{PREFIX} WARNING: --compaction sort is a wavefront-engine "
            f"mode; the {args.engine} engine masks dead lanes instead "
            f"(same image, no densify pass), so rendering proceeds on "
            f"{args.engine} with masking.  Use --engine xla to run the "
            f"sort-densify wavefront.", flush=True)

    import pathtrace_tpu_torch as ptt
    from pathtrace_tpu_torch.io import image_io
    from pathtrace_tpu_torch.utils import checkpoint as ckpt

    scene = ptt.load_scene(args.scene)
    if args.res:
        scene = dataclasses.replace(scene, resolution=tuple(args.res))
    if args.depth:
        scene = dataclasses.replace(scene, trace_depth=args.depth)
    n_iters = args.spp if args.spp is not None else scene.iterations
    width, height = scene.resolution
    depth = int(scene.trace_depth)
    device = torch.device(args.device) if mesh is None else mesh.device
    engine, run = _engine(scene, device, args)

    say(
        f"{PREFIX} {args.scene}: {width}x{height}, {n_iters} spp, "
        f"depth {depth}, device={device}, engine {engine}"
        f"{', nee' if args.nee else ''}{', rr' if args.rr else ''}",
        flush=True,
    )

    start_time = image_io.timestamp()
    accum = torch.zeros((scene.pixel_count, 3), dtype=torch.float32,
                        device=device)
    done = 0
    if args.resume and args.checkpoint and os.path.exists(args.checkpoint):
        saved, done = ckpt.load(args.checkpoint, scene)
        accum.copy_(torch.from_numpy(saved))
        say(f"{PREFIX} resumed at iteration {done}", flush=True)
    session = None
    if args.interactive and lead:
        from pathtrace_tpu_torch.render.interact import InteractiveSession

        session = InteractiveSession(args.interactive)

    def save_image(samples):
        if not lead:
            return
        img = image_io.to_display(accum.cpu().numpy(), width, height,
                                  samples)
        out = args.out or image_io.render_filename(
            scene.image_name, start_time, samples)
        image_io.save_png(out, img)
        say(f"{PREFIX} saved {out}", flush=True)
        if args.hdr:
            hdr_out = os.path.splitext(out)[0] + ".hdr"
            image_io.save_hdr(hdr_out, img)
            say(f"{PREFIX} saved {hdr_out}", flush=True)

    rays_total = 0
    steady_rays = 0
    steady_time = 0.0
    first_chunk = True
    t_start = time.time()
    while done < n_iters:
        if args.interactive:
            poll = session.poll(scene.camera) if lead else None
            if mesh is not None:  # rank 0's events on every rank
                from pathtrace_tpu_torch.parallel import shard

                poll = shard.broadcast(poll, mesh)
            camera, changed, save_req, quit_req = poll
            if changed:
                # the reference's rule (src/main.cpp:74,91-94): a camera
                # change sets the iteration to 0, the accumulation restarts
                scene = dataclasses.replace(scene, camera=camera)
                engine, run = _engine(scene, device, args)
                accum.zero_()
                done = rays_total = steady_rays = 0
                steady_time = 0.0
                first_chunk = True
                say(f"{PREFIX} camera changed -> accumulation restarted",
                    flush=True)
            if save_req and done:
                save_image(done)
            if quit_req:
                break
        step = min(args.chunk, n_iters - done)
        t0 = time.time()
        rad, counts = run(args.seed + done + 1, step)
        accum += rad
        # the (tiny) counts copy waits for the launch, keeping dt honest
        counts = counts.cpu().numpy()
        dt = time.time() - t0
        done += step
        segs = int(counts.sum())
        rays_total += segs
        if first_chunk:
            first_chunk = False  # holds the kernel build; not averaged
        else:
            steady_rays += segs
            steady_time += dt
        if args.stats:
            say(json.dumps(dict(
                iter=done,
                ms_per_iter=round(dt / step * 1e3, 2),
                mrays_per_s=round(segs / dt / 1e6, 2),
                live_per_bounce=counts.tolist(),
            )), flush=True)
        else:
            say(
                f"{PREFIX} iter {done}/{n_iters} "
                f"({dt / step * 1e3:.1f} ms/iter, "
                f"{segs / dt / 1e6:.1f} Mrays/s)",
                flush=True,
            )
        if lead and args.preview_every and done % args.preview_every < step:
            image_io.save_png(preview_path(scene.image_name),
                              image_io.to_display(accum.cpu().numpy(), width,
                                                  height, done))
        if (lead and args.checkpoint and args.checkpoint_every
                and done % args.checkpoint_every < step):
            ckpt.save(args.checkpoint, accum, done, scene)

    wall = time.time() - t_start
    steady = (
        f", {steady_rays / steady_time / 1e6:.1f} Mrays/s steady-state"
        if steady_time > 0 else ""
    )
    say(
        f"{PREFIX} {done} iterations in {wall:.1f}s "
        f"({rays_total / max(wall, 1e-9) / 1e6:.1f} Mrays/s avg{steady})",
        flush=True,
    )
    if lead and args.checkpoint and done:
        ckpt.save(args.checkpoint, accum, done, scene)
    if done:
        save_image(done)
    return 0


if __name__ == "__main__":
    sys.exit(main())
