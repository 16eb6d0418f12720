#!/usr/bin/env python3
"""Smoke run of the PyTorch/CUDA port (``pathtrace_tpu_torch``) on one GPU.

    python3 chip_smoke.py

Phases, each of which raises on failure (exit code non-zero):

1. the card: ``nvidia-smi`` name and power limit;
2. build the CUDA kernel K1 from ``pathtrace_tpu_torch/csrc`` (timed);
3. K1 against its plain PyTorch version on the card, cornell.txt and
   sphere.txt at 800x800, depth 8, 1 spp: under 0.5% of pixels may differ
   by more than 1e-3, bounce 0 must count every pixel and the other
   bounces must agree within 0.5%;
4. the main path through the CLI entry point (``cli.main``, default
   ``--device cuda``): cornell.txt at 64 spp to a PNG, which must have a
   plausible mean, a red left third and a green right third; the kernel's
   launch count is reset before and read after this phase;
5. timing on cornell 800x800 depth 8: warm, tables resident on the
   device, CUDA events, median of k calls of 8 spp, for K1 and for the
   plain version; Mrays/s counts live path segments.

The line before the last is a JSON object describing each kernel; the
last line is ``{"ok": true, "device": {...}}``.  Without a CUDA GPU it
prints no result and exits non-zero.  It imports nothing of JAX.
"""

from __future__ import annotations

import json
import os
import statistics
import subprocess
import sys
import tempfile
import time

HERE = os.path.dirname(os.path.abspath(__file__))
TIE_SHARE = 0.005      # share of pixels allowed to differ by > 1e-3
COUNT_RTOL = 0.005     # per-bounce live counts after bounce 0
SPP_PER_CALL = 8


def card_line():
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"],
        capture_output=True, text=True, check=True, timeout=60)
    return out.stdout.strip().splitlines()[0]


def compare(name, K, torch):
    """K1 (through pathtrace_batch_cuda) against trace_plain, 1 spp."""
    import pathtrace_tpu_torch as ptt

    scene = ptt.load_scene(os.path.join(HERE, "scenes", f"{name}.txt"))
    width, height = scene.resolution
    n_pix = width * height
    before = K.LAUNCHES
    rad, counts = K.pathtrace_batch_cuda(scene, 1, 1, device="cuda")
    torch.cuda.synchronize()
    if K.LAUNCHES != before + 1:
        raise RuntimeError(f"{name}: K1 was not launched")
    tables = K.pack_scene(scene, "cuda")
    ref, ref_counts = K.trace_plain(*tables, scene.geoms.type, width, height,
                                    int(scene.trace_depth), 1, 1)
    torch.cuda.synchronize()
    if rad.shape != (n_pix, 3) or not bool(torch.isfinite(rad).all()):
        raise RuntimeError(f"{name}: bad radiance {tuple(rad.shape)}")
    diff = (rad - ref).abs().amax(dim=-1)
    share = float((diff > 1e-3).float().mean())
    max_err = float(diff.max())
    counts, ref_counts = counts.tolist(), ref_counts.tolist()
    print(f"compare {name} 800x800 d8 1spp: share>1e-3 {share:.6f} "
          f"max_abs_err {max_err:.3g} exact {float((diff == 0).float().mean()):.6f} "
          f"counts k1 {counts} plain {ref_counts}", flush=True)
    if share >= TIE_SHARE:
        raise RuntimeError(f"{name}: {share:.4%} of pixels differ > 1e-3")
    if counts[0] != n_pix or ref_counts[0] != n_pix:
        raise RuntimeError(f"{name}: bounce-0 count is not {n_pix}")
    for d, (a, b) in enumerate(zip(counts, ref_counts)):
        if abs(a - b) > COUNT_RTOL * max(b, 1):
            raise RuntimeError(f"{name}: bounce {d} count {a} vs {b}")
    return max_err


def cli_main_path(K, np):
    """The main path as a user runs it; returns K1's launches in it."""
    from PIL import Image

    from pathtrace_tpu_torch import cli

    with tempfile.TemporaryDirectory() as tmp:
        out = os.path.join(tmp, "cornell.png")
        K.LAUNCHES = 0
        rc = cli.main([os.path.join(HERE, "scenes", "cornell.txt"),
                       "--spp", "64", "--out", out])
        launches = K.LAUNCHES
        if rc != 0 or not os.path.exists(out):
            raise RuntimeError(f"CLI returned {rc}, wrote no {out}")
        img = np.asarray(Image.open(out), dtype=np.float32) / 255.0
    mean = float(img.mean())
    third = img.shape[1] // 3
    left = img[:, :third].reshape(-1, 3).mean(axis=0)
    right = img[:, -third:].reshape(-1, 3).mean(axis=0)
    print(f"cli cornell 64spp: {img.shape} mean {mean:.4f} "
          f"left rgb {left.round(4).tolist()} right rgb "
          f"{right.round(4).tolist()} K1 launches {launches}", flush=True)
    if not (np.isfinite(mean) and 0.02 < mean < 0.6):
        raise RuntimeError(f"implausible image mean {mean}")
    if not (left[0] > left[1] and right[1] > right[0]):
        raise RuntimeError("orientation: left third must be red, right green")
    if launches == 0:
        raise RuntimeError("the main path did not launch K1")
    return launches


def median_ms(fn, torch, k):
    """Median over k calls of fn's CUDA-event time, after one warm call."""
    out = fn()
    torch.cuda.synchronize()
    times = []
    for _ in range(k):
        start = torch.cuda.Event(enable_timing=True)
        stop = torch.cuda.Event(enable_timing=True)
        start.record()
        out = fn()
        stop.record()
        torch.cuda.synchronize()
        times.append(start.elapsed_time(stop))
    return statistics.median(times), times, out


def main():
    import torch

    if not torch.cuda.is_available():
        print("chip_smoke: torch.cuda.is_available() is False; this smoke "
              "run needs a CUDA GPU", file=sys.stderr)
        return 2
    import numpy as np

    sys.path.insert(0, HERE)
    import pathtrace_tpu_torch as ptt
    from pathtrace_tpu_torch.ops.cuda import build
    from pathtrace_tpu_torch.ops.cuda import megakernel as K

    card = card_line()
    kind = torch.cuda.get_device_name(0)
    print(f"card: {card} | torch {torch.__version__} cuda "
          f"{torch.version.cuda} | {kind}", flush=True)

    t0 = time.perf_counter()
    build.load_k1()
    build_s = time.perf_counter() - t0
    ptxas = build.BUILD_INFO.get("k1", (0.0, "(library found built)"))[1]
    usage = [ln.strip() for ln in ptxas.splitlines()
             if "registers" in ln or "spill" in ln]
    print(f"build K1: {build_s:.2f} s, nvcc {' '.join(build.NVCC_FLAGS)} | "
          f"{' | '.join(usage)}", flush=True)

    max_err = max(compare(name, K, torch) for name in ("cornell", "sphere"))
    launches = cli_main_path(K, np)

    scene = ptt.load_scene(os.path.join(HERE, "scenes", "cornell.txt"))
    width, height = scene.resolution
    depth = int(scene.trace_depth)
    tables = K.prepare(scene, "cuda")
    args = (scene.geoms.type, width, height, depth, 1, SPP_PER_CALL)
    ms_k1, all_k1, (_, counts) = median_ms(
        lambda: K.trace_k1(*tables, *args), torch, k=9)
    ms_plain, all_plain, _ = median_ms(
        lambda: K.trace_plain(*tables, *args), torch, k=5)
    segs = int(counts.sum())
    for label, ms, runs in (("K1", ms_k1, all_k1),
                            ("plain", ms_plain, all_plain)):
        print(f"time {label} cornell 800x800 d8 {SPP_PER_CALL}spp/call: "
              f"median {ms:.4f} ms/call = {ms / SPP_PER_CALL:.4f} ms/iter, "
              f"{segs / (ms / 1e3) / 1e6:.1f} Mrays/s ({segs} live segments"
              f"/call; runs {[round(t, 4) for t in runs]}) on {card}",
              flush=True)

    print(card, flush=True)
    print(json.dumps({"kernels": [{
        "name": "k1_trace",
        "route": "cuda",
        "source": "pathtrace_tpu_torch/csrc/megakernel.cu",
        "replaces": "pathtrace_tpu/ops/pallas/megakernel.py:2424",
        "launches": launches,
        "max_abs_err": max_err,
        "ms": ms_k1 / SPP_PER_CALL,
        "plain_ms": ms_plain / SPP_PER_CALL,
    }]}), flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": kind,
        "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
