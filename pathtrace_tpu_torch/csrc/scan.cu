// K6 — exclusive prefix sum of int32 values for NVIDIA Hopper (sm_90a).
//
// Replaces the Pallas TPU kernel `_scan_kernel` of pathtrace_tpu/ops/scan.py
// (reached from the pallas_call in `_prefix_sum_impl`), under
// `prefix_sum`, `compact_indices` and `compact` (ops/scan.py); the split
// engine's live-tile table is its `compact_indices`.
//
// The TPU kernel did each row's scan as a product with a triangular matrix
// on the MXU and carried the running total through its sequential grid in
// SMEM.  Here blocks run in parallel and in no order, so the scan is GPU
// Gems 3 ch. 39's work-efficient one, in three steps:
// 1. k6_scan_tiles: each block scans its tile of kTile values in shared
//    memory (each thread its kItems values in registers, then a warp-shuffle
//    scan of the thread totals, then one of the warp totals) and writes the
//    tile's total;
// 2. the tile totals are scanned by the same steps (recursively while there
//    is more than one tile);
// 3. k6_add_offsets adds each tile's offset to its values.
// Integer adds, so the result is exact (int32 wraps past 2^31 - 1).
//
// What bounds it: memory.  Each value is read once and written once (the
// offsets add a read and a write of each value again when there is more than
// one tile); a few integer adds per value.  Loads and stores are coalesced
// through shared memory; its rows are padded by one word per 32, so that the
// threads of a warp, each reading its kItems neighbouring values, fall on 32
// different banks.

#include <cstdint>

#include <cuda_runtime.h>

namespace {

constexpr int kThreads = 512;
constexpr int kItems = 4;
constexpr int kTile = kThreads * kItems;
constexpr int kWarps = kThreads / 32;

__host__ __device__ constexpr int pad(int i) { return i + (i >> 5); }

__global__ void __launch_bounds__(kThreads)
k6_scan_tiles(const int* __restrict__ x, int* __restrict__ out, int* __restrict__ totals,
              long long n) {
  __shared__ int s[pad(kTile)];
  __shared__ int s_warp[kWarps];
  const long long base = static_cast<long long>(blockIdx.x) * kTile;
#pragma unroll
  for (int j = 0; j < kItems; ++j) {
    const int i = threadIdx.x + j * kThreads;
    s[pad(i)] = base + i < n ? x[base + i] : 0;
  }
  __syncthreads();
  int v[kItems];
  int sum = 0;
#pragma unroll
  for (int k = 0; k < kItems; ++k) {
    v[k] = s[pad(threadIdx.x * kItems + k)];
    sum += v[k];
  }
  // inclusive scan of the thread totals across the warp
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  int incl = sum;
#pragma unroll
  for (int o = 1; o < 32; o <<= 1) {
    const int t = __shfl_up_sync(0xffffffffu, incl, o);
    if (lane >= o) incl += t;
  }
  if (lane == 31) s_warp[warp] = incl;
  __syncthreads();
  if (warp == 0) {  // inclusive scan of the warp totals
    int w = lane < kWarps ? s_warp[lane] : 0;
#pragma unroll
    for (int o = 1; o < 32; o <<= 1) {
      const int t = __shfl_up_sync(0xffffffffu, w, o);
      if (lane >= o) w += t;
    }
    if (lane < kWarps) s_warp[lane] = w;
  }
  __syncthreads();
  int run = incl - sum + (warp > 0 ? s_warp[warp - 1] : 0);
#pragma unroll
  for (int k = 0; k < kItems; ++k) {
    s[pad(threadIdx.x * kItems + k)] = run;
    run += v[k];
  }
  __syncthreads();
#pragma unroll
  for (int j = 0; j < kItems; ++j) {
    const int i = threadIdx.x + j * kThreads;
    if (base + i < n) out[base + i] = s[pad(i)];
  }
  if (threadIdx.x == 0) totals[blockIdx.x] = s_warp[kWarps - 1];
}

__global__ void __launch_bounds__(kThreads)
k6_add_offsets(int* __restrict__ out, const int* __restrict__ offsets, long long n) {
  const long long base = static_cast<long long>(blockIdx.x) * kTile;
  const int off = offsets[blockIdx.x];
#pragma unroll
  for (int j = 0; j < kItems; ++j) {
    const long long i = base + threadIdx.x + j * kThreads;
    if (i < n) out[i] += off;
  }
}

long long tiles_of(long long n) { return (n + kTile - 1) / kTile; }

// The scratch ints a scan of n values takes: its tile totals, and when
// there is more than one tile, their scan and what that scan takes.
long long scratch_of(long long n) {
  const long long t = tiles_of(n);
  return t > 1 ? 2 * t + scratch_of(t) : t;
}

int scan(const int* x, int* out, int* scratch, long long n, cudaStream_t stream) {
  const long long tiles = tiles_of(n);
  if (tiles > 0x7fffffffLL) return static_cast<int>(cudaErrorInvalidValue);
  k6_scan_tiles<<<static_cast<unsigned>(tiles), kThreads, 0, stream>>>(x, out, scratch, n);
  cudaError_t e = cudaGetLastError();
  if (e != cudaSuccess || tiles == 1) return static_cast<int>(e);
  int* offsets = scratch + tiles;
  const int r = scan(scratch, offsets, offsets + tiles, tiles, stream);
  if (r != 0) return r;
  k6_add_offsets<<<static_cast<unsigned>(tiles), kThreads, 0, stream>>>(out, offsets, n);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// Values a scan tile holds.
extern "C" long long pt_k6_tile() { return kTile; }

// The int32 scratch pt_k6_scan needs for n values.
extern "C" long long pt_k6_scratch(long long n) { return n > 0 ? scratch_of(n) : 0; }

// Exclusive prefix sum of x (n int32) into out (n int32, not x) on
// `stream`, with `scratch` (pt_k6_scratch(n) int32).  Returns the
// cudaError_t of the launches (0 = success).
extern "C" int pt_k6_scan(const int* x, int* out, int* scratch, long long n, void* stream) {
  if (n <= 0 || x == out) return static_cast<int>(cudaErrorInvalidValue);
  return scan(x, out, scratch, n, static_cast<cudaStream_t>(stream));
}

extern "C" const char* pt_cuda_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}
