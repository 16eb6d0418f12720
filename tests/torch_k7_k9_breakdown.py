#!/usr/bin/env python3
"""Where K7's and K9's time goes: their breakdown in PERF.md section 5,
on the card.

    python3 tests/torch_k7_k9_breakdown.py [variant ...]

Each variant of ``VARIANTS`` changes ``pathtrace_tpu_torch/csrc/
megakernel.cu`` (K7) or ``csrc/probe_trav.cu`` (K9) in a copy of the
sources in a temporary directory (the checkout is never touched): a
design of the final source taken out, or one that was measured and left
out put back in. K7's: the pool of pixels a block shares (taken out: one
pixel a lane, or a fixed number of pixels a lane in place of the host's
choice), the launch bound (7 blocks an SM; taken out, or 6), the flush
rule (taken out: a flush after every sample, as the lockstep kernel
made), and put in: a path's first 4 (or 2) distinct factors folded once
each with their count, folds in batches of a warp's lanes, a table for
each warp; and for reference (wrong results) the fold without its
atomics, without its divisions and without any fold. K9's: the prefetch
of both of the next step's nodes, the leaf list summed after the walk
(taken out: thread 0 adds each leaf's rows inside the walk) and the
layout (16 blocks x 256 threads x 1 ray; others in its place), and put
in: an early out of a thread's ray tests (at 4 rays a thread), the
cluster's vote through its hardware barrier or through tagged slots in
place of the atomic words; and for reference a step without its tests
(the walk enters every node). Each variant's K7 libraries (masks 0 and
512) and K9 library are compiled, all variants at once; then the
checkout's own and each variant's are timed, the checkout's own first
and last: K7's ms a call on ``K7_JOBS`` (the median of 9 calls, CUDA
events) beside K1's on the same tables, and K9's on the bigmesh tables'
32x128 bundle (around the call, the median of 9, and on the device
alone, ``torch.profiler``). Prints the card, each build's registers and
each time; exits 1 without a CUDA GPU.
"""

import os
import re
import shutil
import subprocess
import sys
import tempfile
import time

HERE = os.path.dirname(os.path.abspath(__file__))
REPO = os.path.dirname(HERE)
K7_MASKS = (0, 512)
# (scene file, mask, samples a call), the files' own size, depth 8
K7_JOBS = (("cornell", 0, 1), ("cornell", 0, 8), ("cornell_mesh", 512, 1))
CALLS = 9

POOL = ("  const int lane_px = k1_lane_pixels(n_pix, static_cast<long long>(sms) * "
        "per_sm);\n")
K7_BOUND = "__global__ void __launch_bounds__(kBlock, 7)\nk7_grads("


def _pool(k):
    return [("megakernel.cu", POOL, f"  const int lane_px = {k};\n")]


LANE_TOP = """    for (;;) {
      bool need = false;  // the lane's pixel has run the chunk
      if (!done && !fresh && (!p.live || d == depth)) {
        grad_fold(p, ct + 3 * idx, mtab, mat_of, n_mats, tab);
"""
LANE_BOUNCE = """      if (!done) {
        // a live path entering bounce d
        atomicAdd(s_counts + d, 1u);
"""


def _batch(k):
    """A lane whose path ends holds it until k lanes of its warp hold one
    (or none has a path left to trace); then they fold together."""
    return [("megakernel.cu", LANE_TOP, f"""    bool held = false;
    for (;;) {{
      bool need = false;  // the lane's pixel has run the chunk
      if (!done && !fresh && !held && (!p.live || d == depth)) held = true;
      const unsigned hold = __ballot_sync(kFull, held);
      const unsigned busy = __ballot_sync(kFull, !done && !held);
      if (held && (__popc(hold) >= {k} || busy == 0u)) {{
        held = false;
        grad_fold(p, ct + 3 * idx, mtab, mat_of, n_mats, tab);
"""), ("megakernel.cu", LANE_BOUNCE,
       LANE_BOUNCE.replace("if (!done) {", "if (!done && !held) {"))]


FOLD_EVENT = """    const uint32_t kind = p.ev[e] & 7u;
    const int m = __ldg(mat_of + (p.ev[e] >> 3));
"""
FOLD_ADDS = """      if (x > eps) fx_add(tab + ((col + c) * n_mats + m), w[c] / x);
    }
    if (kind == 2u) {
      const float x = __ldg(mv + 6);
      if (x > eps) fx_add(tab + (6 * n_mats + m), wsum / x);
    }
    if (kind <= 1u) {
      const float pm = fminf(fmaxf(__ldg(mv + 7), 0.f), 1.f);
      if (kind == 1u && pm > eps) fx_add(tab + (7 * n_mats + m), -(wsum / pm));
      if (kind == 0u && 1.f - pm > eps) fx_add(tab + (7 * n_mats + m), wsum / (1.f - pm));
    }
  }
}
"""


def _counted(k):
    """The fold with a path's first k distinct (material, kind) gathered
    in one 64-bit register (16 bits each: the key, 10 bits, and its count,
    6), each folded once with its count (its digits times the count), and
    every event of a later one on its own."""
    adds = re.sub(r"fx_add\((.*)\);", r"fx_add_n(\1, cnt);", FOLD_ADDS)
    return [("megakernel.cu", "__device__ __forceinline__ void grad_fold(",
             """__device__ __forceinline__ void fx_add_n(const Fx& e, float v, unsigned cnt) {
  const uint32_t b = __float_as_uint(v);
  const int ex = static_cast<int>((b >> 23) & 0xffu);
  const int sh = ex - 86;
  if (ex == 0 || sh <= -24) return;
  if (ex == 0xff || sh > 102) {
    atomicOr(e.w + kFxLimbs * e.n + (e.i >> 5), 1u << (e.i & 31));
    return;
  }
  const unsigned long long mm = (b & 0x7fffffu) | 0x800000u;
  const int k = sh < 0 ? 0 : sh / 12;
  const unsigned long long t = sh < 0 ? mm >> -sh : mm << (sh - 12 * k);
  const bool neg = (b >> 31) != 0u;
  unsigned* limb = e.w + k * e.n + e.i;
  for (int j = 0; j < 3; ++j) {
    const unsigned d = (static_cast<unsigned>(t >> (12 * j)) & 0xfffu) * cnt;
    if (d) atomicAdd(limb + j * e.n, neg ? 0u - d : d);
  }
}

__device__ __forceinline__ void fold_factor(uint32_t key, unsigned cnt, const float* w,
                                            float wsum, const float* mtab, int n_mats,
                                            const Fx& tab) {
  constexpr float eps = 1e-8f;
  {
    const uint32_t kind = key & 7u;
    const int m = static_cast<int>(key >> 3);
    const float* mv = mtab + kGradRows * m;
    const int col = (kind == 1u || kind == 3u) ? 3 : 0;
    for (int c = 0; c < 3; ++c) {
      const float x = __ldg(mv + col + c);
""" + adds + """
__device__ __forceinline__ void grad_fold("""),
            ("megakernel.cu", """  for (int e = 0; e < p.n_ev; ++e) {
""" + FOLD_EVENT, f"""  unsigned long long keys = 0ull;
  for (int e = 0; e < p.n_ev; ++e) {{
    const uint32_t key =
        static_cast<uint32_t>(__ldg(mat_of + (p.ev[e] >> 3))) << 3 | (p.ev[e] & 7u);
    int q = 0;
    unsigned slot = 0u;
    for (; q < {k}; ++q) {{
      slot = static_cast<unsigned>(keys >> (16 * q)) & 0xffffu;
      if (slot == 0u || slot >> 6 == key) break;
    }}
    if (q < {k}) {{
      keys += static_cast<unsigned long long>(slot == 0u ? key << 6 | 1u : 1u) << (16 * q);
      continue;
    }}
    fold_factor(key, 1u, w, wsum, mtab, n_mats, tab);
  }}
  for (int q = 0; q < {k}; ++q) {{
    const unsigned slot = static_cast<unsigned>(keys >> (16 * q)) & 0xffffu;
    if (slot == 0u) break;
    fold_factor(slot >> 6, slot & 63u, w, wsum, mtab, n_mats, tab);
  }}
  if (false) for (int e = 0; e < p.n_ev; ++e) {{
""" + FOLD_EVENT)]


# a table for each of the block's 4 warps in shared memory
WARP_TABLES = [
    ("megakernel.cu", """  for (int i = threadIdx.x; i < fx_smem_words(n_grad); i += kBlock) s_grad[i] = 0u;
  const Fx tab{s_grad, n_grad, 0};""", """  for (int i = threadIdx.x; i < kWarps * fx_smem_words(n_grad); i += kBlock) s_grad[i] = 0u;
  const Fx tab{s_grad + (threadIdx.x >> 5) * fx_smem_words(n_grad), n_grad, 0};"""),
    ("megakernel.cu", "    fx_flush(s_grad, n_grad, gtab);\n",
     "    for (int w = 0; w < kWarps; ++w)\n"
     "      fx_flush(s_grad + w * fx_smem_words(n_grad), n_grad, gtab);\n"),
    ("megakernel.cu",
     "  const size_t smem = grad_off + sizeof(unsigned) * fx_smem_words(kGradRows * n_mats);",
     "  const size_t smem = grad_off + sizeof(unsigned) * kWarps * "
     "fx_smem_words(kGradRows * n_mats);")]

LAYOUT = "constexpr int kCluster = 16;\nconstexpr int kThreads = 256;\nconstexpr int kRays = 1;\n"


def _layout(blocks, threads, rays):
    """K9 on a cluster of ``blocks`` blocks of ``threads`` threads,
    ``rays`` rays a thread."""
    return [("probe_trav.cu", LAYOUT,
             f"constexpr int kCluster = {blocks};\nconstexpr int kThreads = "
             f"{threads};\nconstexpr int kRays = {rays};\n")]


PREFETCH = """  Node cur = load_node(nodes, 0, n_nodes);
  while (n < n_nodes && steps < max_steps) {
    // float-coded integers, truncated as the reference's astype
    const int skip = static_cast<int>(cur.b.z);
    // both candidates of the next step, in flight during this one
    const Node next_in = load_node(nodes, n + 1, n_nodes);
    const Node next_skip = load_node(nodes, skip, n_nodes);
"""
VOTE = """    const bool block_hit = __syncthreads_or(hit) != 0;
    // the block's vote into word `par` of every block: one arrival, and a
    // hit in the high half; complete when the arrivals reach kCluster a
    // step of this parity.  The words only grow (mod 2^32), so no block
    // clears one that another may still be adding into.
    const int par = steps & 1;
    if (threadIdx.x < kCluster)
      atomicAdd(cluster.map_shared_rank(&vote[par], threadIdx.x),
                1u + (block_hit ? 0x10000u : 0u));
    const unsigned want = static_cast<unsigned>(kCluster) * (static_cast<unsigned>(steps >> 1) + 1u);
    unsigned v;
    do {
      v = *reinterpret_cast<volatile unsigned*>(&vote[par]);
    } while (((v - want) & 0xffffu) != 0u);
    const unsigned hits = (v - want) >> 16;  // mod 2^16: at most kCluster more a step
    const bool any_hit = hits != seen[par];
    seen[par] = hits;
"""
SLOTS = ("probe_trav.cu",
         "  __shared__ unsigned vote[2];  // the cluster's votes, by the step's parity\n",
         "  __shared__ unsigned vote[2];  // the cluster's votes, by the step's parity\n"
         "  __shared__ unsigned slot[2][kCluster];\n")


def _vote(code):
    """The cluster's vote as ``code`` in place of the atomic words."""
    return [SLOTS, ("probe_trav.cu", VOTE,
                    "    const bool block_hit = __syncthreads_or(hit) != 0;\n"
                    "    bool any_hit = false;\n" + code)]


# the block's vote into its slot of every block, then the cluster's
# barrier (release, acquire), then the slots read
VOTE_BARRIER = """    {
      const int par = steps & 1;
      if (threadIdx.x < kCluster)
        *cluster.map_shared_rank(&slot[par][rank], threadIdx.x) = block_hit ? 1u : 0u;
      cluster.sync();
      unsigned v = 0u;
      for (int r = 0; r < kCluster; ++r) v |= slot[par][r];
      any_hit = v != 0u;
    }
"""
# the block's vote, tagged with the step, into its slot of every block;
# complete when each slot of this parity holds this step's tag (a tag no
# step has, before the first)
VOTE_SLOTS = """    {
      const int par = steps & 1;
      if (steps < 2) {  // before any block's vote of this parity
        if (threadIdx.x < kCluster) slot[par][threadIdx.x] = ~0u;
        cluster.sync();
      }
      const unsigned tagged = static_cast<unsigned>(steps) << 1 | (block_hit ? 1u : 0u);
      if (threadIdx.x < kCluster)
        *cluster.map_shared_rank(&slot[par][rank], threadIdx.x) = tagged;
      const int lane = threadIdx.x & 31;
      unsigned v;
      do {
        v = lane < kCluster ? *reinterpret_cast<volatile unsigned*>(&slot[par][lane]) : tagged;
      } while (!__all_sync(0xffffffffu, (v >> 1) == static_cast<unsigned>(steps)));
      any_hit = __any_sync(0xffffffffu, (v & 1u) != 0u);
    }
"""


# name: replacements (file in csrc, old, new), each old found once
VARIANTS = {
    "K7: one pixel a lane": _pool(1),
    "K7: 2 pixels a lane": _pool(2),
    "K7: 8 pixels a lane": _pool(8),
    "K7 without its launch bound": [(
        "megakernel.cu", K7_BOUND,
        "__global__ void __launch_bounds__(kBlock)\nk7_grads(")],
    "K7 at 6 blocks an SM": [(
        "megakernel.cu", K7_BOUND,
        "__global__ void __launch_bounds__(kBlock, 6)\nk7_grads(")],
    "K7: a flush after every sample": [(
        "megakernel.cu", "  const int chunk = k7_chunk(flush_paths, lane_px);\n",
        "  const int chunk = 1;\n")],
    "K7: a path's first 4 distinct factors counted": _counted(4),
    "K7: a path's first 2 distinct factors counted": _counted(2),
    "K7: folds in batches of 8 lanes": _batch(8),
    "K7: folds in batches of 32 lanes": _batch(32),
    "K7: a table for each warp": WARP_TABLES,
    "K7: plain shared adds for the atomics (wrong sums; for reference)": [(
        "megakernel.cu",
        "    if (d) atomicAdd(limb + j * e.n, neg ? 0u - d : d);\n  }\n}\n\n// Adds",
        "    if (d) limb[j * e.n] += neg ? 0u - d : d;\n  }\n}\n\n// Adds")],
    "K7: products for the divisions (wrong terms; for reference)": [
        ("megakernel.cu", "m), w[c] / x);", "m), w[c] * x);"),
        ("megakernel.cu", "m), wsum / x);", "m), wsum * x);"),
        ("megakernel.cu", "m), -(wsum / pm));", "m), -(wsum * pm));"),
        ("megakernel.cu", "m), wsum / (1.f - pm));", "m), wsum * (1.f - pm));")],
    "K7 without the fold (no gradient; for reference)": [(
        "megakernel.cu",
        "  if (w[0] == 0.f && w[1] == 0.f && w[2] == 0.f) return;  // every term is 0\n",
        "  return;\n")],
    "K9 without the prefetch": [
        ("probe_trav.cu", PREFETCH, """  Node cur{};
  while (n < n_nodes && steps < max_steps) {
    cur = load_node(nodes, n, n_nodes);
    const int skip = static_cast<int>(cur.b.z);
"""),
        ("probe_trav.cu", "    cur = take_skip ? next_skip : next_in;\n", "")],
    "K9: the leaves summed inside the walk": [
        ("probe_trav.cu", "  Node cur = load_node(nodes, 0, n_nodes);\n",
         "  float tsum = 0.f;\n  Node cur = load_node(nodes, 0, n_nodes);\n"),
        ("probe_trav.cu",
         "      if (walker) list[leaves] = make_int2(static_cast<int>(cur.b.w), count);\n",
         "      const int start = static_cast<int>(cur.b.w);\n"
         "      if (walker)\n"
         "        for (int j = start; j < start + count; ++j) tsum = tsum + __ldg(tri + 16 * j);\n"),
        ("probe_trav.cu", "  float tsum = 0.f;\n  __syncthreads();  // the list",
         "  __syncthreads();  // the list"),
        ("probe_trav.cu", "for (int base = 0; base < leaves; base += kThreads) {",
         "for (int base = 0; base < 0; base += kThreads) {")],
    "K9: the cluster's vote through its barrier": _vote(VOTE_BARRIER),
    "K9: the cluster's vote through tagged slots": _vote(VOTE_SLOTS),
    "K9 at 16 x 64 x 4": _layout(16, 64, 4),
    "K9 at 16 x 64 x 4 with an early out of a thread's tests": _layout(
        16, 64, 4) + [("probe_trav.cu", "      float ta[3], tb[3];\n",
                       "      if (hit) break;\n      float ta[3], tb[3];\n")],
    "K9 at 1 x 1024 x 4 (one block)": _layout(1, 1024, 4),
    "K9 at 1 x 256 x 16 (one block)": _layout(1, 256, 16),
    "K9 at 4 x 256 x 4": _layout(4, 256, 4),
    "K9 at 8 x 128 x 4": _layout(8, 128, 4),
    "K9 at 8 x 256 x 2": _layout(8, 256, 2),
    "K9 at 16 x 128 x 2": _layout(16, 128, 2),
    "K9 at 8 x 512 x 1": _layout(8, 512, 1),
    "K9: a step without its tests (every node entered; for reference)": [(
        "probe_trav.cu", "const bool block_hit = __syncthreads_or(hit) != 0;",
        "const bool block_hit = __syncthreads_or(1) != 0;")],
}


def variant(tmp, name):
    """A copy of ``csrc`` in ``tmp`` with ``name``'s replacements; returns
    (its csrc, its build directory)."""
    # a plain directory name: nvcc reads a comma in a path as a list
    root = os.path.join(tmp, f"v{list(VARIANTS).index(name)}")
    csrc = os.path.join(root, "csrc")
    shutil.copytree(os.path.join(REPO, "pathtrace_tpu_torch", "csrc"), csrc)
    for fname, old, new in VARIANTS[name]:
        path = os.path.join(csrc, fname)
        with open(path) as f:
            text = f.read()
        if text.count(old) != 1:
            raise RuntimeError(f"{name}: {old[:60]!r} is in {fname} "
                               f"{text.count(old)} times, not once")
        with open(path, "w") as f:
            f.write(text.replace(old, new))
    return csrc, os.path.join(root, "build")


def use(B, csrc, build_dir):
    """Point the build module at these sources and this build directory,
    and forget the K7 and K9 libraries loaded from others."""
    from pathlib import Path

    B.CSRC, B.BUILD_DIR = Path(csrc), Path(build_dir)
    for m in K7_MASKS:
        B._LIBS.pop(("k7", m), None)
    B._LIBS.pop("k9", None)


def build_all(csrc, build_dir):
    """Child process: K7 of K7_MASKS and K9 from ``csrc`` into
    ``build_dir``; prints each kernel's registers and spills."""
    sys.path.insert(0, REPO)
    from pathtrace_tpu_torch.ops.cuda import build as B
    from torch_digest import ptxas_usage

    use(B, csrc, build_dir)
    B.build_many([B._k7_job(m) for m in K7_MASKS] + [B.K9_JOB])
    for name in [f"k7_m{m}" for m in K7_MASKS] + ["k9_probe"]:
        log = B.BUILD_INFO.get(name, (0.0, ""))[1]  # "": built before
        for fn, usage in ptxas_usage(log).items():
            print(f"regs {csrc} {name} {fn}: {usage}", flush=True)


def k7_jobs(torch, ptt, K, MG, TD):
    """(label, mask, spp, (job, mtab, mat_of, ct)) of each of K7_JOBS,
    the tables on the card (they do not depend on the library)."""
    out = []
    for name, mask, spp in K7_JOBS:
        job = TD.k7_job(REPO, torch, ptt, K, MG, name, None, 8)
        out.append((f"{name} {job[0]['width']}x{job[0]['height']} d8 {spp} "
                    f"spp a call", mask, spp, job))
    return out


def times(torch, K, MG, P, TD, jobs, probe_args, label):
    for name, mask, spp, (job, mtab, mat_of, ct) in jobs:
        k7, runs = TD.events_ms(
            torch, lambda: MG.trace_k7(job, mtab, mat_of, ct, 1, spp), CALLS)
        k1, _ = TD.events_ms(
            torch, lambda: K.trace_k1(**job, it0=1, n_spp=spp), CALLS)
        print(f"k7 {name} mask {mask} ({label}): {k7:.4f} ms a call, runs "
              f"{[round(t, 4) for t in runs]}; k1 {k1:.4f}; k7 / k1 "
              f"{k7 / k1:.3f}", flush=True)
    res = P.probe_k9(*probe_args)
    ms, _ = TD.events_ms(torch, lambda: P.probe_k9(*probe_args), CALLS)
    dev = TD.device_ms(torch, lambda: P.probe_k9(*probe_args),
                       name="k9_probe")
    print(f"k9 ({label}): around the call {ms:.4f} ms, device alone "
          f"{dev:.5f} ms, {1e3 * dev / res[1]:.4f} us a step ({res[1]} "
          f"steps, {res[2]} leaves)", flush=True)


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
    from pathtrace_tpu_torch.ops.cuda import matgrad as MG
    from pathtrace_tpu_torch.ops.cuda import megakernel as K
    from pathtrace_tpu_torch.ops.cuda import probe as P

    print(f"card: {CS.card_line()}", flush=True)
    tmp = tempfile.mkdtemp(prefix="k7_k9_breakdown_")
    try:
        t0 = time.perf_counter()
        own = (str(B.CSRC), str(B.BUILD_DIR))
        dirs = {n: variant(tmp, n) for n in names}
        procs = [(n, subprocess.Popen(
            [sys.executable, __file__, "--build", *d]))
            for n, d in [("as it is", own), *dirs.items()]]
        for n, proc in procs:
            if proc.wait():
                raise RuntimeError(f"the K7/K9 build of {n!r} failed")
        print(f"built K7 {K7_MASKS} and K9 of the checkout and {len(names)} "
              f"variants: {time.perf_counter() - t0:.1f} s", flush=True)
        B.build_kernels(set(K7_MASKS))  # K1 beside K7, from the checkout
        jobs = k7_jobs(torch, ptt, K, MG, TD)
        scene = ptt.load_scene(os.path.join(REPO, "scenes",
                                            "cornell_bigmesh.txt"))
        tri, nodes, meta = K.pack_mesh(scene, "cuda")
        probe_args = (nodes, tri, meta[0])
        want = P.probe_plain(*probe_args)
        for name, d in [("as it is", own), *dirs.items(), ("as it is", own)]:
            print(f"variant {name!r}: {d[0]}", flush=True)
            use(B, *d)
            got = P.probe_k9(*probe_args)
            if got != want and "for reference" not in name:
                raise RuntimeError(f"{name}: K9 {got} != plain {want}")
            times(torch, K, MG, P, TD, jobs, probe_args, name)
    finally:
        shutil.rmtree(tmp, ignore_errors=True)
    return 0


if __name__ == "__main__":
    if sys.argv[1:2] == ["--build"]:
        sys.path.insert(0, HERE)
        build_all(sys.argv[2], sys.argv[3])
        sys.exit(0)
    sys.exit(main(sys.argv[1:] or list(VARIANTS)))
