#!/usr/bin/env python3
"""Where K1's and K5's time goes: the breakdown of PERF.md section 5, on
the card.

    python3 tests/torch_k1_breakdown.py [variant ...]

Each variant of ``VARIANTS`` changes ``pathtrace_tpu_torch/csrc/
megakernel.cu`` in a copy of the sources in a temporary directory (the
checkout is never touched): one of the designs of K1's lane schedule or
of K5's spans taken back out, or K1's pool held at a fixed size.  K1's
designs: the pool of pixels a block shares (taken out: one pixel a lane,
the lane's next sample started in the step its path ends, alone; or a
fixed number of pixels a lane in place of the host's choice), the count
of the live paths (one shared atomic a lane and step; taken out: one
ballot for each bounce that the warp's lanes are at), the launch bound
(7 blocks an SM; taken out, or 6) and the mesh builds' smaller pool
(taken out: up to 8 pixels a lane, as the other builds).  K5's: the live prefix of the sorted
engine (taken out: every tile runs) and the state a ray moves (taken out:
every ray loads and stores every plane).  Each variant's K1 libraries
(with K5) of ``MASKS`` are compiled, all variants at once; then the
checkout's own and each variant's are timed, the checkout's own first and
last: K1's ms/iter on ``K1_JOBS``, depth 8 (the median of 9 calls of 8
samples, or 1, as ``tests/torch_digest.py --time`` times them) and K5's ms a launch on ``torch_digest.K5_TIMED`` (as
``--k5-time``).  Prints the card, each build's registers and each time;
exits 1 without a CUDA GPU.
"""

import os
import shutil
import statistics
import subprocess
import sys
import tempfile
import time

HERE = os.path.dirname(os.path.abspath(__file__))
REPO = os.path.dirname(HERE)
MASKS = (0, 128, 512)
# (label, scene file, NEE, mask, resolution or None for the file's,
# samples a call)
K1_JOBS = (("cornell", "cornell", False, 0, None, 8),
           ("cornell NEE", "cornell", True, 128, None, 8),
           ("cornell_mesh", "cornell_mesh", False, 512, None, 8),
           ("cornell_bigmesh", "cornell_bigmesh", False, 512, None, 8),
           ("cornell_bigmesh", "cornell_bigmesh", False, 512, None, 1),
           ("cornell_bigmesh", "cornell_bigmesh", False, 512, (800, 800), 8),
           ("cornell_hugemesh", "cornell_hugemesh", False, 512, None, 8))
DEPTH, CALLS = 8, 9

POOL = ("  const int lane_px = k1_lane_pixels(n_local, static_cast<long long>(sms) * "
        "per_sm);\n")


def _pool(k):
    return [(POOL, f"  const int lane_px = {k};\n")]


# name: replacements (old, new) in megakernel.cu, each old found once
VARIANTS = {
    "one pixel a lane (the in-lane start alone)": _pool(1),
    "2 pixels a lane": _pool(2),
    "4 pixels a lane": _pool(4),
    "8 pixels a lane": _pool(8),
    "16 pixels a lane": _pool(16),
    "counts: a ballot a bounce the lanes are at": [(
        """      if (!done) {
        // a live path entering bounce d
        atomicAdd(s_counts + (kPerSample ? (sample - c0) * depth + d : d), 1u);
""",
        """      {
        const int row = kPerSample ? (sample - c0) * depth + d : d;
        unsigned todo = __ballot_sync(kFull, !done);
        while (todo != 0u) {
          const int r = __shfl_sync(kFull, row, __ffs(todo) - 1);
          const unsigned g = __ballot_sync(kFull, !done && row == r);
          if (lane == 0) atomicAdd(s_counts + r, static_cast<unsigned>(__popc(g)));
          todo &= ~g;
        }
      }
      if (!done) {
""")],
    "K1 without its launch bound": [(
        "__global__ void __launch_bounds__(kBlock, 7)\nk1_trace(",
        "__global__ void __launch_bounds__(kBlock)\nk1_trace(")],
    "K1 at 6 blocks an SM": [(
        "__global__ void __launch_bounds__(kBlock, 7)\nk1_trace(",
        "__global__ void __launch_bounds__(kBlock, 6)\nk1_trace(")],
    "the mesh builds' pool as the others' (8 pixels a lane at most)": [(
        "constexpr int kLanePxMax = kMesh ? 4 : 8;",
        "constexpr int kLanePxMax = 8;")],
    "K5: every tile runs (no live prefix)": [(
        """  } else if (n_live != nullptr && tile * kBlock >= static_cast<long long>(__ldg(n_live))) {
    return;  // past the live prefix: every ray of the tile is dead
  }""", "  }")],
    "K5: every ray loads and stores every plane": [
        ("""  } else if (valid && state[kKeyLive * n_rays + slot] != 0.f) {
    load_state(p, state, n_rays, slot);""",
         """  } else if (valid) {
    load_state(p, state, n_rays, slot);
    p.live = state[kKeyLive * n_rays + slot] != 0.f;"""),
        ("  const bool ran = p.live;", "  const bool ran = valid;"),
        ("""  if (last) return;
  st[kKeyLive * n + i] = p.live ? 1.f : 0.f;
  if (!p.live) return;""", "  st[kKeyLive * n + i] = p.live ? 1.f : 0.f;")],
}


def variant(tmp, name):
    """A copy of ``csrc`` in ``tmp`` with ``name``'s replacements; returns
    (its csrc, its build directory)."""
    # a plain directory name: nvcc reads a comma in a path as a list
    root = os.path.join(tmp, f"v{list(VARIANTS).index(name)}")
    csrc = os.path.join(root, "csrc")
    shutil.copytree(os.path.join(REPO, "pathtrace_tpu_torch", "csrc"), csrc)
    path = os.path.join(csrc, "megakernel.cu")
    with open(path) as f:
        text = f.read()
    for old, new in VARIANTS[name]:
        if text.count(old) != 1:
            raise RuntimeError(f"{name}: {old[:60]!r} is in megakernel.cu "
                               f"{text.count(old)} times, not once")
        text = text.replace(old, new)
    with open(path, "w") as f:
        f.write(text)
    return csrc, os.path.join(root, "build")


def use(B, csrc, build_dir):
    """Point the build module at these sources and this build directory,
    and forget the K1 libraries loaded from others."""
    from pathlib import Path

    B.CSRC, B.BUILD_DIR = Path(csrc), Path(build_dir)
    for m in MASKS:
        B._LIBS.pop(m, None)


def build_all(csrc, build_dir):
    """Child process: K1 (with K5) of MASKS from ``csrc`` into
    ``build_dir``; prints each kernel's registers and spills."""
    sys.path.insert(0, REPO)
    from pathtrace_tpu_torch.ops.cuda import build as B
    from torch_digest import ptxas_usage

    use(B, csrc, build_dir)
    logs = {}
    B.build_many([B._k1_job(m) for m in MASKS], logs)
    for m in MASKS:
        log = logs.get(f"k1_m{m}", (0.0, ""))[1]  # "": built before
        for fn, usage in ptxas_usage(log).items():
            print(f"regs {csrc} mask {m} {fn}: {usage}", flush=True)


def k1_jobs(ptt, K):
    """(label, mask, job) of each of K1_JOBS, the tables on the card (they
    do not depend on the library that traces them)."""
    import dataclasses

    obj = os.path.join(REPO, "scenes", "gen_icosphere7.obj")
    if not os.path.exists(obj):
        subprocess.run([sys.executable, os.path.join(REPO, "tools",
                                                     "gen_mesh.py"), "7", obj],
                       check=True, stdout=subprocess.DEVNULL)
    out = []
    for name, scene_file, nee, mask, res, spp in K1_JOBS:
        scene = ptt.load_scene(os.path.join(REPO, "scenes",
                                            f"{scene_file}.txt"))
        scene = dataclasses.replace(scene, trace_depth=DEPTH,
                                    resolution=res or scene.resolution)
        out.append((f"{name} {scene.resolution[0]}x{scene.resolution[1]} "
                    f"{spp} spp a call", mask, spp,
                    K.prepare(scene, "cuda", nee=nee)))
    return out


def k1_times(torch, K, jobs, label):
    for name, mask, spp, job in jobs:
        K.trace_k1(job, 1, spp)
        runs = []
        for _ in range(CALLS):
            start, stop = (torch.cuda.Event(enable_timing=True)
                           for _ in range(2))
            start.record()
            K.trace_k1(job, 1, spp)
            stop.record()
            torch.cuda.synchronize()
            runs.append(start.elapsed_time(stop) / spp)
        print(f"k1 {name} d{DEPTH} mask {mask} ({label}): "
              f"{statistics.median(runs):.4f} ms/iter, runs "
              f"{[round(t, 4) for t in runs]}", flush=True)


def main(names):
    import torch

    if not torch.cuda.is_available():
        print("no CUDA GPU", file=sys.stderr)
        return 1
    sys.path.insert(0, REPO)
    sys.path.insert(0, HERE)
    import chip_smoke as CS
    import pathtrace_tpu_torch as ptt
    import torch_digest as TD
    from pathtrace_tpu_torch.ops.cuda import build as B
    from pathtrace_tpu_torch.ops.cuda import megakernel as K

    print(f"card: {CS.card_line()}", flush=True)
    tmp = tempfile.mkdtemp(prefix="k1_breakdown_")
    try:
        t0 = time.perf_counter()
        own = (str(B.CSRC), str(B.BUILD_DIR))
        dirs = {n: variant(tmp, n) for n in names}
        procs = [(n, subprocess.Popen(
            [sys.executable, __file__, "--build", *d]))
            for n, d in [("as it is", own), *dirs.items()]]
        for n, proc in procs:
            if proc.wait():
                raise RuntimeError(f"the K1 build of {n!r} failed")
        print(f"built K1 {MASKS} of the checkout and {len(names)} variants:"
              f" {time.perf_counter() - t0:.1f} s", flush=True)
        jobs = k1_jobs(ptt, K)
        for name, d in [("as it is", own), *dirs.items(), ("as it is", own)]:
            print(f"variant {name!r}: {d[0]}", flush=True)
            use(B, *d)
            k1_times(torch, K, jobs, name)
            TD.k5_times(REPO, torch, ptt, K, label=name)
    finally:
        shutil.rmtree(tmp, ignore_errors=True)
    return 0


if __name__ == "__main__":
    if sys.argv[1:2] == ["--build"]:
        sys.path.insert(0, HERE)
        build_all(sys.argv[2], sys.argv[3])
        sys.exit(0)
    sys.exit(main(sys.argv[1:] or list(VARIANTS)))
