#!/usr/bin/env python3
"""Where K8's time goes: the breakdown of PERF.md section 5, on the card.

    python3 tests/torch_k8_breakdown.py [--spp N] [variant ...]

Each variant of ``VARIANTS`` changes ``pathtrace_tpu_torch/csrc/
megakernel.cu`` in a copy of the sources in a temporary directory (the
checkout is never touched): one of the reverse sweep's designs taken back
out (the carried winner, the carried shadow visibility, the skipped zero
hit adjoint, either kernel's launch bound, the pools of several pixels a
lane, a flush every several samples), a design that was measured and not
kept put in (a warp's digits summed before one lane adds them), the adds
cut apart (their digits read but not added; one atomic of each term's
bits, no digits), or the adds taken away (their digits and atomics; the
adjoint arithmetic that feeds them stays: an upper bound of what the adds
cost; only their time means anything, their tables are wrong).  Each
variant's K8 builds of ``MASKS`` are compiled at once, one variant after
another; then the checkout's own K8 and each variant's are timed on the
scenes of ``tests/torch_digest.py``'s ``K8_JOBS`` at their own size,
depth 8, ``--spp`` samples a call (default 1), as ``torch_digest.py
--k8-time`` times them, the checkout's own first and last, each with
the device time of its kernels a call (``k8_vjp_fwd``, the forward sweep
with its tape; ``k8_vjp_rev``, the adjoints with their adds;
``fx_round``; ``torch.profiler``).  Prints the card, each build's
registers and each time; exits 1 without a CUDA GPU.
"""

import os
import shutil
import subprocess
import sys
import tempfile
import time

HERE = os.path.dirname(os.path.abspath(__file__))
REPO = os.path.dirname(HERE)
# without NEE, with it, the mesh with NEE, the mesh variant with NEE
MASKS = (0, 128, 640, 665)

def launch_bound(kernel, blocks=None):
    """The replacement that takes ``kernel``'s launch bound out, or asks
    for ``blocks`` blocks an SM instead of 7."""
    bound = "kBlock" if blocks is None else f"kBlock, {blocks}"
    return (f"__global__ void __launch_bounds__(kBlock, 7)\n{kernel}(",
            f"__global__ void __launch_bounds__({bound})\n{kernel}(")


# name: replacements (old, new) in megakernel.cu, each old found once
VARIANTS = {
    "winner not carried": [(
        """  Hit h = nearest<false>(sv.ox, sv.oy, sv.oz, sv.dx, sv.dy, sv.dz, time, s.gmat + g * kGeomCols,
                         s.types + g, 1, M(nullptr, nullptr, nullptr, 0));
  h.geom += g;
  return h;""",
        """  return nearest<false>(sv.ox, sv.oy, sv.oz, sv.dx, sv.dy, sv.dz, time, s.gmat, s.types,
                        s.n_geoms, M(nullptr, nullptr, nullptr, 0));""")],
    "visibility not carried": [
        ("""                        unsigned long long vis, const float* ct, float* g_t, float* gp,
                        float* gn, const Fx& ga, const GradTab& G) {""",
         """                        unsigned long long vis, const float* ct, float* g_t, float* gp,
                        float* gn, const Fx& ga, const GradTab& G, const Mesh mesh) {"""),
        ("""    if (!((vis >> k) & 1ull)) continue;  // not seen: no term
""", ""),
        ("""    const float sd[3] = {wl[0] * inv_dl, wl[1] * inv_dl, wl[2] * inv_dl};
    const float cs_raw""",
         """    const float sd[3] = {wl[0] * inv_dl, wl[1] * inv_dl, wl[2] * inv_dl};
    const Hit sh = nearest<true>(h.px, h.py, h.pz, sd[0], sd[1], sd[2], time, s.gmat, s.types,
                                 s.n_geoms, mesh);
    const float tol = fmaxf(1e-3f, 5e-3f * dist_l);
    if (sh.geom != static_cast<int>(lr[0]) || !(fabsf(sh.dist - dist_l) < tol)) continue;
    const float cs_raw"""),
        ("nee_adj(tr, h, n, al, time, it, pix, dep, s, sv.vis, ct, g_t, gp, gn, ga, G);",
         "nee_adj(tr, h, n, al, time, it, pix, dep, s, sv.vis, ct, g_t, gp, gn, ga, G, mesh);"),
    ],
    "zero hit adjoint computed": [(
        """  if (gp[0] == 0.f && gp[1] == 0.f && gp[2] == 0.f && gn[0] == 0.f && gn[1] == 0.f &&
      gn[2] == 0.f)
    return;
""", "")],
    "no launch bound (forward)": [launch_bound("k8_vjp_fwd")],
    "no launch bound (reverse)": [launch_bound("k8_vjp_rev")],
    "reverse at 6 blocks an SM": [launch_bound("k8_vjp_rev", 6)],
    "reverse at 8 blocks an SM": [launch_bound("k8_vjp_rev", 8)],
    "one pixel a lane": [
        ("    const int fwd_px = k1_lane_pixels(n_px, res);",
         "    const int fwd_px = 1;"),
        ("    int rev_px = k1_lane_pixels(n_px, res);", "    int rev_px = 1;")],
    "gadd not inlined": [(
        "__device__ __forceinline__ void gadd(const Fx& p, float v) { fx_add(p, v); }",
        "__device__ __noinline__ void gadd(const Fx p, float v) { fx_add(p, v); }")],
    "the last bounce a step of its own": [(
        "        d = end_adj(rec, static_cast<int>(__ldg(n_live + path)) - 1, s, ct + 3ll * pix_u, c, G);",
        "        d = static_cast<int>(__ldg(n_live + path)) - 1;")],
    "one sample a pass": [("constexpr int kRevPass = 2;", "constexpr int kRevPass = 1;")],
    "four samples a pass": [("constexpr int kRevPass = 2;", "constexpr int kRevPass = 4;")],
    "one pass of a chunk's samples": [("constexpr int kRevPass = 2;",
                                        "constexpr int kRevPass = 1 << 20;")],
    "a warp's digits summed first": [(
        """  const unsigned long long m = (b & 0x7fffffu) | 0x800000u;
  const int k = sh < 0 ? 0 : sh / 12;  // the lowest limb the digits go to
  const unsigned long long t = sh < 0 ? m >> -sh : m << (sh - 12 * k);
  const bool neg = (b >> 31) != 0u;
  unsigned* limb = e.w + k * e.n + e.i;
  for (int j = 0; j < 3; ++j) {
    const unsigned d = static_cast<unsigned>(t >> (12 * j)) & 0xfffu;
    if (d) atomicAdd(limb + j * e.n, neg ? 0u - d : d);
  }""",
        """  const unsigned act = __activemask();  // the lanes past the early returns
  const unsigned long long m = (b & 0x7fffffu) | 0x800000u;
  const int k = sh < 0 ? 0 : sh / 12;
  const unsigned long long t = sh < 0 ? m >> -sh : m << (sh - 12 * k);
  const bool neg = (b >> 31) != 0u;
  int dg[3];
  for (int j = 0; j < 3; ++j) {
    const int d = static_cast<int>((t >> (12 * j)) & 0xfffull);
    dg[j] = neg ? -d : d;
  }
  unsigned* limb = e.w + e.i;
  const unsigned grp = __match_any_sync(act, e.i);  // the lanes on this entry
  if ((grp & (grp - 1u)) == 0u) {
    for (int j = 0; j < 3; ++j)
      if (dg[j]) atomicAdd(limb + (k + j) * e.n, static_cast<unsigned>(dg[j]));
    return;
  }
  const int lo = __reduce_min_sync(grp, k), hi = __reduce_max_sync(grp, k + 2);
  const bool lead = static_cast<int>(threadIdx.x & 31u) == __ffs(grp) - 1;
  for (int j = lo; j <= hi; ++j) {
    const int d = j == k ? dg[0] : j == k + 1 ? dg[1] : j == k + 2 ? dg[2] : 0;
    const int sum = __reduce_add_sync(grp, d);
    if (lead && sum) atomicAdd(limb + j * e.n, static_cast<unsigned>(sum));
  }""")],
    "digits read, not added": [(
        """  for (int j = 0; j < 3; ++j) {
    const unsigned d = static_cast<unsigned>(t >> (12 * j)) & 0xfffu;
    if (d) atomicAdd(limb + j * e.n, neg ? 0u - d : d);
  }""",
        """  unsigned x = 0u;
  for (int j = 0; j < 3; ++j) {
    const unsigned d = static_cast<unsigned>(t >> (12 * j)) & 0xfffu;
    x += static_cast<unsigned>(limb - e.w) + j * e.n + (neg ? 0u - d : d);
  }
  if (x == 0x9e3779b9u) atomicAdd(e.w, 1u);  // keeps the digits read""")],
    "digits read, one atomic a term": [(
        """  for (int j = 0; j < 3; ++j) {
    const unsigned d = static_cast<unsigned>(t >> (12 * j)) & 0xfffu;
    if (d) atomicAdd(limb + j * e.n, neg ? 0u - d : d);
  }""",
        """  unsigned x = 0u;
  for (int j = 0; j < 3; ++j) {
    const unsigned d = static_cast<unsigned>(t >> (12 * j)) & 0xfffu;
    x += neg ? 0u - d : d;
  }
  atomicAdd(limb, x);""")],
    "one atomic of the bits": [(
        """  const uint32_t b = __float_as_uint(v);
""",
        """  const uint32_t b = __float_as_uint(v);
  if (b << 1 != 0u) atomicAdd(e.w + e.i, b);
  return;
""")],
    "adds taken away": [(
        """  if (ex == 0 || sh <= -24) return;  // zero, subnormal or below 2^-64""",
        """  if (ex == 0 || sh <= -24 || ex != 0xff) return;""")],
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
    and forget the K8 libraries loaded from others."""
    from pathlib import Path

    B.CSRC, B.BUILD_DIR = Path(csrc), Path(build_dir)
    for m in MASKS:
        B._LIBS.pop(("k8", m), None)


def build_all(csrc, build_dir):
    """Child process: K8 of MASKS from ``csrc`` into ``build_dir``."""
    sys.path.insert(0, REPO)
    from pathtrace_tpu_torch.ops.cuda import build as B

    use(B, csrc, build_dir)
    logs = {}
    B.build_many([B._k8_job(m) for m in MASKS], logs)
    from torch_digest import ptxas_usage

    for m in MASKS:
        log = logs.get(f"k8_m{m}", (0.0, ""))[1]  # "": built before
        for fn, usage in ptxas_usage(log).items():
            if fn.startswith("k8_vjp"):
                print(f"regs {csrc} mask {m} {fn}: {usage}", flush=True)


def main(names, spp=1):
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
    from pathtrace_tpu_torch.ops.cuda import vjp as VJ

    print(f"card: {CS.card_line()}", flush=True)
    tmp = tempfile.mkdtemp(prefix="k8_breakdown_")
    try:
        t0 = time.perf_counter()
        own = (str(B.CSRC), str(B.BUILD_DIR))
        dirs = {n: variant(tmp, n) for n in names}
        # one variant at a time, its builds at once
        for n, d in [("as it is", own), *dirs.items()]:
            cmd = [sys.executable, __file__, "--build", *d]
            if subprocess.run(cmd).returncode:
                raise RuntimeError(f"the K8 build of {n!r} failed")
            print(f"variant {n!r}: {d[0]}", flush=True)
        print(f"built K8 {MASKS} of the checkout and {len(names)} variants:"
              f" {time.perf_counter() - t0:.1f} s", flush=True)
        for name, d in [("as it is", own), *dirs.items(), ("as it is", own)]:
            use(B, *d)
            TD.k8_times(REPO, torch, ptt, K, VJ, MASKS, label=name, spp=spp)
    finally:
        shutil.rmtree(tmp, ignore_errors=True)
    return 0


if __name__ == "__main__":
    if sys.argv[1:2] == ["--build"]:
        sys.path.insert(0, HERE)
        build_all(sys.argv[2], sys.argv[3])
        sys.exit(0)
    argv, spp = sys.argv[1:], 1
    if argv[:1] == ["--spp"]:
        spp, argv = int(argv[1]), argv[2:]
    sys.exit(main(argv or list(VARIANTS), spp))
