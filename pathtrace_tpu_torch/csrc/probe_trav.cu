// K9 — BVH traversal probe for NVIDIA Hopper (sm_90a).
//
// Replaces the Pallas TPU kernel `kernel` of tools/probe_trav.py (reached
// from its pallas_call, and in interpret mode from the second one): a fixed
// bundle of object-space rays walks one geom's skip-link BVH (scene/bvh.py)
// as ONE cursor, the way the reference's tile walk does: it enters a node
// when any ray of the bundle meets its box (tnear <= tfar, tnear < 1e10)
// and takes the skip link otherwise, under a cap on the steps.  It returns
// what the reference counts: the final cursor, the steps, the leaves
// fetched, and the float32 sum of column 0 of the fetched triangle rows
// (summed in walk order, then truncated to int32).
//
// The bundle: ray (row, lane) for row < rows, lane < lanes starts at
// (-3 + 0.01 row, 0.005 lane - 0.3, 0) with direction (1, 0.001 row,
// 0.0005 lane) / |.|, computed as the reference computes it.
//
// What bounds it: the walk is a chain of dependent steps (607 on the
// bigmesh tables), each a load of the cursor's node, the bundle's box
// tests and a vote of every ray; the card's operations bound (4096 tests a
// step) is three orders below what the chain's latency allows.  The
// design shortens a step:
// - the cursor only moves forward (n + 1 into a node, or its skip link,
//   the first node after its subtree), so once node n is read both of the
//   next step's candidates are known: their loads start before n's tests,
//   and the next step never waits on a global load;
// - the leaves fetched go to a list in global memory, and their rows are
//   summed after the walk, in walk order (the float32 sum keeps its bits),
//   a chunk of leaves' rows loaded at once, not one dependent load after
//   another inside the walk;
// - the bundle's tests, the step's work (4096 at 32x128), are spread over
//   a cluster of blocks on as many SMs (kCluster, kThreads, kRays),
//   whose votes meet through distributed shared memory: each block adds
//   its vote into a word of every block of the cluster, and reads its own.
// Measured and left out (PERF.md section 5): a thread's early out at its
// first hit (its branch cost more than the tests it skipped), the
// cluster's hardware barrier for the vote, and tagged vote slots.
// Any layout walks the same cursor, to the same result.
// Built with -fmad=false and IEEE division and square root, as the plain
// version (ops/cuda/probe.py probe_plain) rounds.

#include <cmath>
#include <cstdint>

#include <cooperative_groups.h>
#include <cuda_runtime.h>

namespace {

namespace cg = cooperative_groups;

constexpr int kMaxRays = 4096;
constexpr int kLeafK = 8;  // scene/bvh.py LEAF_K: a leaf's rows staged at once
// The layout: a cluster of kCluster blocks (one SM each) of kThreads
// threads, kRays rays a thread; ray i of the bundle is thread
// i mod (kCluster kThreads) of the cluster's, its (i / (kCluster
// kThreads))-th.  The fastest of those measured (PERF.md section 5).
constexpr int kCluster = 16;
constexpr int kThreads = 256;
constexpr int kRays = 1;
static_assert(kCluster * kThreads * kRays >= kMaxRays && kThreads >= kCluster);

// A node's first 48 bytes: min xyz, max x | max yz, skip, start | count.
struct Node {
  float4 a, b, c;
};

__device__ __forceinline__ Node load_node(const float4* __restrict__ nodes, int n, int n_nodes) {
  Node v{};
  if (n < n_nodes) {
    v.a = __ldg(nodes + 4 * n);
    v.b = __ldg(nodes + 4 * n + 1);
    v.c = __ldg(nodes + 4 * n + 2);
  }
  return v;
}

// `list` holds at least n_nodes (start, count) pairs: a leaf is fetched at
// most once, the cursor moving forward.
__global__ void __launch_bounds__(kThreads)
k9_probe(const float4* __restrict__ nodes, const float* __restrict__ tri, int n_nodes, int rows,
         int lanes, int max_steps, int2* __restrict__ list, int* __restrict__ out) {
  __shared__ unsigned vote[2];  // the cluster's votes, by the step's parity
  __shared__ float s_rows[kThreads * kLeafK];
  __shared__ int s_start[kThreads], s_count[kThreads];
  cg::cluster_group cluster = cg::this_cluster();
  const unsigned rank = cluster.block_rank();
  if (threadIdx.x < 2) vote[threadIdx.x] = 0u;
  cluster.sync();  // every block's words zeroed before a vote
  const int n_rays = rows * lanes;
  // this thread's rays: origin and 1/direction
  float o[kRays][3], ird[kRays][3];
  bool mine[kRays];
#pragma unroll
  for (int k = 0; k < kRays; ++k) {
    const int i = static_cast<int>(rank) * kThreads + threadIdx.x + k * (kCluster * kThreads);
    mine[k] = i < n_rays;
    const float row = static_cast<float>(i / lanes);
    const float lane = static_cast<float>(i % lanes);
    o[k][0] = -3.f + row * 0.01f;
    o[k][1] = lane * 0.005f - 0.3f;
    o[k][2] = 0.f;
    float d[3] = {1.f, row * 0.001f, lane * 0.0005f};
    const float n2 = sqrtf(d[0] * d[0] + d[1] * d[1] + d[2] * d[2]);
#pragma unroll
    for (int ax = 0; ax < 3; ++ax) ird[k][ax] = 1.f / (d[ax] / n2);
  }
  const bool walker = rank == 0 && threadIdx.x == 0;  // writes the list
  int n = 0, steps = 0, leaves = 0;
  unsigned seen[2] = {0u, 0u};  // the cluster's hits counted so far, by parity
  Node cur = load_node(nodes, 0, n_nodes);
  while (n < n_nodes && steps < max_steps) {
    // float-coded integers, truncated as the reference's astype
    const int skip = static_cast<int>(cur.b.z);
    // both candidates of the next step, in flight during this one
    const Node next_in = load_node(nodes, n + 1, n_nodes);
    const Node next_skip = load_node(nodes, skip, n_nodes);
    const float lo[3] = {cur.a.x, cur.a.y, cur.a.z};
    const float hi[3] = {cur.a.w, cur.b.x, cur.b.y};
    int hit = 0;
#pragma unroll
    for (int k = 0; k < kRays; ++k) {
      float ta[3], tb[3];
#pragma unroll
      for (int ax = 0; ax < 3; ++ax) {
        const float t1 = (lo[ax] - o[k][ax]) * ird[k][ax];
        const float t2 = (hi[ax] - o[k][ax]) * ird[k][ax];
        // a NaN frees the axis, as the reference's guard does
        const bool nan = isnan(t1) || isnan(t2);
        ta[ax] = nan ? -INFINITY : fminf(t1, t2);
        tb[ax] = nan ? INFINITY : fmaxf(t1, t2);
      }
      const float tnear = fmaxf(fmaxf(ta[0], ta[1]), fmaxf(ta[2], 0.f));
      const float tfar = fminf(fminf(tb[0], tb[1]), tb[2]);
      hit |= mine[k] && tnear <= tfar && tnear < 1e10f;
    }
    const bool block_hit = __syncthreads_or(hit) != 0;
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
    const int count = static_cast<int>(cur.c.x);
    const bool leaf = count > 0;
    if (leaf && any_hit) {
      if (walker) list[leaves] = make_int2(static_cast<int>(cur.b.w), count);
      ++leaves;
    }
    const bool take_skip = leaf || !any_hit;
    cur = take_skip ? next_skip : next_in;
    n = take_skip ? skip : n + 1;
    ++steps;
  }
  cluster.sync();  // every vote landed before a block exits
  if (rank != 0) return;
  // the fetched rows in walk order: a chunk of kThreads leaves staged at
  // once, one leaf a thread, then added one after another by thread 0
  float tsum = 0.f;
  __syncthreads();  // the list, written by thread 0, read by all
  for (int base = 0; base < leaves; base += kThreads) {
    const int q = base + static_cast<int>(threadIdx.x);
    if (q < leaves) {
      const int2 lf = list[q];
      s_start[threadIdx.x] = lf.x;
      s_count[threadIdx.x] = lf.y;
#pragma unroll
      for (int j = 0; j < kLeafK; ++j)
        if (j < lf.y) s_rows[threadIdx.x * kLeafK + j] = __ldg(tri + 16 * (lf.x + j));
    }
    __syncthreads();
    if (threadIdx.x == 0) {
      const int m = min(kThreads, leaves - base);
      for (int t = 0; t < m; ++t) {
        const int cnt = s_count[t];
#pragma unroll
        for (int j = 0; j < kLeafK; ++j)
          if (j < cnt) tsum = tsum + s_rows[t * kLeafK + j];
        for (int j = kLeafK; j < cnt; ++j) tsum = tsum + __ldg(tri + 16 * (s_start[t] + j));
      }
    }
    __syncthreads();
  }
  if (threadIdx.x == 0) {
    out[0] = n;
    out[1] = steps;
    out[2] = leaves;
    out[3] = static_cast<int>(tsum);
  }
}

}  // namespace

// Launches K9 on `stream`: the rows x lanes bundle walks `nodes` (n_nodes
// rows of 16 floats, 16-byte aligned: one geom's table) with leaf starts in
// `tri` (rows of 16 floats from the geom's first triangle), for at most
// max_steps steps; `list` (n_nodes int32 pairs) takes the fetched leaves;
// out (4,) int32 gets (cursor, steps, leaves, tsum).  Returns the
// cudaError_t of the launch (0 = success).
extern "C" int pt_k9_probe(const float* nodes, const float* tri, int n_nodes, int rows,
                           int lanes, int max_steps, int* list, int* out, void* stream) {
  if (n_nodes <= 0 || rows <= 0 || lanes <= 0 || max_steps < 0 ||
      static_cast<long long>(rows) * lanes > kMaxRays)
    return static_cast<int>(cudaErrorInvalidValue);
  if (kCluster > 8) {  // past the portable cluster size
    const cudaError_t e =
        cudaFuncSetAttribute(k9_probe, cudaFuncAttributeNonPortableClusterSizeAllowed, 1);
    if (e != cudaSuccess) return static_cast<int>(e);
  }
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3(kCluster);
  cfg.blockDim = dim3(kThreads);
  cfg.stream = static_cast<cudaStream_t>(stream);
  cudaLaunchAttribute attr[1];
  attr[0].id = cudaLaunchAttributeClusterDimension;
  attr[0].val.clusterDim.x = kCluster;
  attr[0].val.clusterDim.y = 1;
  attr[0].val.clusterDim.z = 1;
  cfg.attrs = attr;
  cfg.numAttrs = 1;
  const cudaError_t e =
      cudaLaunchKernelEx(&cfg, k9_probe, reinterpret_cast<const float4*>(nodes), tri, n_nodes,
                         rows, lanes, max_steps, reinterpret_cast<int2*>(list), out);
  return static_cast<int>(e != cudaSuccess ? e : cudaGetLastError());
}

extern "C" const char* pt_cuda_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}
