#!/usr/bin/env python3
"""Smoke run of the PyTorch/CUDA port (``pathtrace_tpu_torch``) on one GPU.

    python3 chip_smoke.py

Phases, each of which raises on failure (exit code non-zero):

1. the card: ``nvidia-smi`` name and power limit;
2. build every variant of the CUDA kernel K1 that the phases run, one per
   feature set (with NEE, its section K2), from
   ``pathtrace_tpu_torch/csrc``, all ``nvcc`` processes at once (timed;
   each build's registers and spills printed);
3. the main path per configuration at 800x800, depth 8, 1 spp, through
   ``pathtrace_batch`` (the variant's launch count is reset before and
   read after), held against the plain PyTorch version on the same
   tables: cornell.txt and sphere.txt (feature-free), cornell with NEE
   and with Russian roulette, cornell_glass.txt with and without NEE,
   cornell_checker.txt, and a bump + SSS variant of cornell_glass.  Under
   0.5% of pixels may differ by more than 1e-3, bounce 0 must count every
   pixel and the other bounces must agree within 0.5%; the share of
   bit-equal pixels is printed;
4. the main path through the CLI entry point (``cli.main``, default
   ``--device cuda``), launch counts reset before and read after:
   cornell.txt and cornell_glass.txt --nee at 64 spp to PNGs, which must
   have a plausible mean, a red left third and a green right third;
5. timing of each variant at 800x800 depth 8: warm, tables resident on
   the device, CUDA events, median of k calls of 8 spp (runs listed), for
   the kernel and for the plain version; Mrays/s counts live path
   segments.

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
K1_SITE = "pathtrace_tpu/ops/pallas/megakernel.py:2424"   # _kernel
K2_SITE = "pathtrace_tpu/ops/pallas/megakernel.py:2223"   # _nee_add

# bump on the diffuse white, a dense medium in the glass sphere
BUMP = ("EMITTANCE   0\n\n// Diffuse red",
        "EMITTANCE   0\nBUMP        2 0.6\n\n// Diffuse red")
SSS = ("REFRIOR     1.5\nEMITTANCE   0\n",
       "REFRIOR     1.5\nEMITTANCE   0\nSSS         6.0 .9 .6 .4\n")
# (label, scene file, text replacements, nee, rr); the first of each
# feature set is the one timed
CONFIGS = [
    ("cornell", "cornell", (), False, False),
    ("sphere", "sphere", (), False, False),
    ("cornell NEE", "cornell", (), True, False),
    ("cornell RR", "cornell", (), False, True),
    ("cornell_glass", "cornell_glass", (), False, False),
    ("cornell_glass NEE", "cornell_glass", (), True, False),
    ("cornell_checker", "cornell_checker", (), False, False),
    ("cornell_glass bump+SSS", "cornell_glass", (BUMP, SSS), False, False),
]


def card_line():
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"],
        capture_output=True, text=True, check=True, timeout=60)
    return out.stdout.strip().splitlines()[0]


def load(ptt, name, edits):
    with open(os.path.join(HERE, "scenes", f"{name}.txt")) as f:
        text = f.read()
    for old, new in edits:
        if text.count(old) != 1:
            raise RuntimeError(f"{name}: replacement not found: {old!r}")
        text = text.replace(old, new)
    return ptt.parse_scene(text)


def mask_of(K, scene, nee, rr):
    return K.feature_mask(K.scene_features(scene), nee, rr)


def kernel_name(K, mask):
    on = [n for i, n in enumerate(K.FEATURE_NAMES) if mask >> i & 1]
    if mask & K.RR_BIT:
        on.append("russian roulette")
    name = "k1_trace+k2_nee" if mask & K.NEE_BIT else "k1_trace"
    return f"{name}[{','.join(on)}]" if on else name


def compare(ptt, K, torch, label, scene, nee, rr, mask):
    """The main path (pathtrace_batch) for one configuration, 1 spp,
    against trace_plain; returns (launches, max abs error)."""
    width, height = scene.resolution
    n_pix = width * height
    K.LAUNCHES.clear()
    rad, counts = ptt.pathtrace_batch(scene, 1, 1, device="cuda", nee=nee,
                                      rr=rr)
    torch.cuda.synchronize()
    launches = K.LAUNCHES[mask]
    if launches != 1 or sum(K.LAUNCHES.values()) != 1:
        raise RuntimeError(f"{label}: launches {dict(K.LAUNCHES)}, want one "
                           f"of mask {mask}")
    job = K.prepare(scene, "cuda", nee=nee, rr=rr)
    ref, ref_counts = K.trace_plain(**job, it0=1, n_spp=1)
    torch.cuda.synchronize()
    if rad.shape != (n_pix, 3) or not bool(torch.isfinite(rad).all()):
        raise RuntimeError(f"{label}: bad radiance {tuple(rad.shape)}")
    diff = (rad - ref).abs().amax(dim=-1)
    share = float((diff > 1e-3).float().mean())
    max_err = float(diff.max())
    counts, ref_counts = counts.tolist(), ref_counts.tolist()
    print(f"compare {label} {width}x{height} d{len(counts)} 1spp (mask "
          f"{mask}): share>1e-3 {share:.6f} max_abs_err {max_err:.3g} exact "
          f"{float((diff == 0).float().mean()):.6f} counts kernel {counts} "
          f"plain {ref_counts}", flush=True)
    if share >= TIE_SHARE:
        raise RuntimeError(f"{label}: {share:.4%} of pixels differ > 1e-3")
    if counts[0] != n_pix or ref_counts[0] != n_pix:
        raise RuntimeError(f"{label}: bounce-0 count is not {n_pix}")
    for d, (a, b) in enumerate(zip(counts, ref_counts)):
        if abs(a - b) > COUNT_RTOL * max(b, 1):
            raise RuntimeError(f"{label}: bounce {d} count {a} vs {b}")
    return launches, max_err


def cli_main_path(K, np, scene_file, flags):
    """The main path as a user runs it; returns the launches by mask."""
    from PIL import Image

    from pathtrace_tpu_torch import cli

    with tempfile.TemporaryDirectory() as tmp:
        out = os.path.join(tmp, "render.png")
        K.LAUNCHES.clear()
        rc = cli.main([os.path.join(HERE, "scenes", scene_file),
                       "--spp", "64", "--out", out, *flags])
        launches = dict(K.LAUNCHES)
        if rc != 0 or not os.path.exists(out):
            raise RuntimeError(f"CLI returned {rc}, wrote no {out}")
        img = np.asarray(Image.open(out), dtype=np.float32) / 255.0
    mean = float(img.mean())
    third = img.shape[1] // 3
    left = img[:, :third].reshape(-1, 3).mean(axis=0)
    right = img[:, -third:].reshape(-1, 3).mean(axis=0)
    print(f"cli {scene_file} {' '.join(flags)} 64spp: {img.shape} mean "
          f"{mean:.4f} left rgb {left.round(4).tolist()} right rgb "
          f"{right.round(4).tolist()} launches by mask {launches}",
          flush=True)
    if not (np.isfinite(mean) and 0.02 < mean < 0.6):
        raise RuntimeError(f"implausible image mean {mean}")
    if not (left[0] > left[1] and right[1] > right[0]):
        raise RuntimeError("orientation: left third must be red, right green")
    if not launches:
        raise RuntimeError(f"the CLI on {scene_file} launched no kernel")
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

    configs = []
    for label, name, edits, nee, rr in CONFIGS:
        scene = load(ptt, name, edits)
        configs.append((label, scene, nee, rr, mask_of(K, scene, nee, rr)))
    masks = sorted({c[4] for c in configs})

    t0 = time.perf_counter()
    build.build_k1(masks)
    print(f"build K1 variants {masks}: {time.perf_counter() - t0:.2f} s, "
          f"nvcc {' '.join(build.NVCC_FLAGS)} -DPT_FEATURES=<mask>",
          flush=True)
    for mask in masks:
        sec, log = build.BUILD_INFO.get(f"k1_m{mask}",
                                        (0.0, "(library found built)"))
        usage = [ln.strip() for ln in log.splitlines()
                 if "registers" in ln or "spill" in ln]
        print(f"build {kernel_name(K, mask)} (mask {mask}): {sec:.2f} s | "
              f"{' | '.join(usage)}", flush=True)

    launches = dict.fromkeys(masks, 0)
    max_err = dict.fromkeys(masks, 0.0)
    for label, scene, nee, rr, mask in configs:
        n, err = compare(ptt, K, torch, label, scene, nee, rr, mask)
        launches[mask] += n
        max_err[mask] = max(max_err[mask], err)
    for scene_file, flags in (("cornell.txt", []),
                              ("cornell_glass.txt", ["--nee"])):
        for mask, n in cli_main_path(K, np, scene_file, flags).items():
            launches[mask] += n
    missing = [m for m in masks if not launches[m]]
    if missing:
        raise RuntimeError(f"the main path launched no kernel of masks "
                           f"{missing}")

    timed = {}
    for label, scene, nee, rr, mask in configs:
        if mask in timed:
            continue
        job = K.prepare(scene, "cuda", nee=nee, rr=rr)
        ms_k, runs_k, (_, counts) = median_ms(
            lambda: K.trace_k1(**job, it0=1, n_spp=SPP_PER_CALL), torch, k=9)
        ms_p, runs_p, _ = median_ms(
            lambda: K.trace_plain(**job, it0=1, n_spp=SPP_PER_CALL), torch,
            k=5)
        timed[mask] = (ms_k / SPP_PER_CALL, ms_p / SPP_PER_CALL)
        segs = int(counts.sum())
        for version, ms, runs in (("kernel", ms_k, runs_k),
                                  ("plain", ms_p, runs_p)):
            print(f"time {version} {label} 800x800 d8 {SPP_PER_CALL}spp/call "
                  f"({kernel_name(K, mask)}): median {ms:.4f} ms/call = "
                  f"{ms / SPP_PER_CALL:.4f} ms/iter, "
                  f"{segs / (ms / 1e3) / 1e6:.1f} Mrays/s ({segs} live "
                  f"segments/call; runs {[round(t, 4) for t in runs]}) on "
                  f"{card}", flush=True)

    print(card, flush=True)
    print(json.dumps({"kernels": [{
        "name": kernel_name(K, mask),
        "route": "cuda",
        "source": "pathtrace_tpu_torch/csrc/megakernel.cu",
        "replaces": K2_SITE if mask & K.NEE_BIT else K1_SITE,
        "launches": launches[mask],
        "max_abs_err": max_err[mask],
        "ms": timed[mask][0],
        "plain_ms": timed[mask][1],
    } for mask in masks]}), flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": kind,
        "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
