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
// One block walks the whole bundle, each thread up to kRaysPerThread rays,
// computed once and held in registers: the any-ray test is
// __syncthreads_or, so the cursor and the counters are the same in every
// thread, and thread 0 sums the leaves.  What bounds it: one dependent node
// load and one block barrier per step.
// Built with -fmad=false and IEEE division and square root, as the plain
// version (ops/cuda/probe.py probe_plain) rounds.

#include <cmath>
#include <cstdint>

#include <cuda_runtime.h>

namespace {

constexpr int kMaxBlock = 1024;
constexpr int kRaysPerThread = 4;

__global__ void __launch_bounds__(kMaxBlock)
k9_probe(const float4* __restrict__ nodes, const float* __restrict__ tri,
         int n_nodes, int rows, int lanes, int max_steps,
         int* __restrict__ out) {
  const int n_rays = rows * lanes;
  // this thread's rays: origin and 1/direction
  float o[kRaysPerThread][3], ird[kRaysPerThread][3];
  bool mine[kRaysPerThread];
#pragma unroll
  for (int k = 0; k < kRaysPerThread; ++k) {
    const int i = threadIdx.x + k * blockDim.x;
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
  int n = 0, steps = 0, leaves = 0;
  float tsum = 0.f;
  while (n < n_nodes && steps < max_steps) {
    const float4 na = __ldg(nodes + 4 * n);      // min xyz, max x
    const float4 nb = __ldg(nodes + 4 * n + 1);  // max yz, skip, start
    const float4 nc = __ldg(nodes + 4 * n + 2);  // count
    const float lo[3] = {na.x, na.y, na.z};
    const float hi[3] = {na.w, nb.x, nb.y};
    int hit = 0;
#pragma unroll
    for (int k = 0; k < kRaysPerThread; ++k) {
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
    const bool any_hit = __syncthreads_or(hit) != 0;
    // float-coded integers, truncated as the reference's astype
    const int count = static_cast<int>(nc.x);
    const bool leaf = count > 0;
    if (leaf && any_hit) {
      ++leaves;
      if (threadIdx.x == 0) {
        const int start = static_cast<int>(nb.w);
        for (int j = start; j < start + count; ++j) tsum = tsum + __ldg(tri + 16 * j);
      }
    }
    n = (leaf || !any_hit) ? static_cast<int>(nb.z) : n + 1;
    ++steps;
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
// max_steps steps; out (4,) int32 gets (cursor, steps, leaves, tsum).
// Returns the cudaError_t of the launch (0 = success).
extern "C" int pt_k9_probe(const float* nodes, const float* tri, int n_nodes,
                           int rows, int lanes, int max_steps, int* out,
                           void* stream) {
  if (n_nodes <= 0 || rows <= 0 || lanes <= 0 || max_steps < 0 ||
      static_cast<long long>(rows) * lanes > kMaxBlock * kRaysPerThread)
    return static_cast<int>(cudaErrorInvalidValue);
  const long long n_rays = static_cast<long long>(rows) * lanes;
  const int block = n_rays >= kMaxBlock ? kMaxBlock : static_cast<int>((n_rays + 31) / 32 * 32);
  k9_probe<<<1, block, 0, static_cast<cudaStream_t>(stream)>>>(
      reinterpret_cast<const float4*>(nodes), tri, n_nodes, rows, lanes, max_steps, out);
  return static_cast<int>(cudaGetLastError());
}

extern "C" const char* pt_cuda_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}
