// K6 — exclusive prefix sum of int32 values for NVIDIA Hopper (sm_90a).
//
// Replaces the Pallas TPU kernel `_scan_kernel` of pathtrace_tpu/ops/scan.py
// (reached from the pallas_call in `_prefix_sum_impl`), under
// `prefix_sum`, `compact_indices` and `compact` (ops/scan.py); the split
// engine's live-tile table is its `compact_indices`.
//
// The TPU kernel did each row's scan as a product with a triangular matrix
// on the MXU and carried the running total through its sequential grid in
// SMEM.  Here blocks run in parallel, so the carry between tiles is a
// decoupled look-back (Merrill and Garland, "Single-pass Parallel Prefix
// Scan with Decoupled Look-back", 2016), in one launch for any n:
// 1. each block takes its tile number from an atomic ticket, so tiles are
//    taken in the order the blocks start and a tile's predecessors are
//    already running (no block waits on one that is not resident);
// 2. it loads its tile of kTile values (128-bit loads through shared
//    memory), scans it in registers and warp shuffles (each thread its
//    kItems neighbouring values, then the thread totals, then the warp
//    totals) and publishes the tile's total, the aggregate;
// 3. its first warp looks back over the predecessors' status words, 32 a
//    step, summing aggregates until it meets an inclusive prefix, and
//    publishes its own inclusive prefix;
// 4. the block adds that exclusive prefix to its values and stores them.
// A status word (64 bits, one per tile) holds the value in its low 32 bits,
// the flag (1: aggregate, 2: inclusive prefix) in bits 32-33 and the
// call's tag in bits 34-63, written and read whole, so a value is never
// seen without its flag, and a word left by an earlier call (another tag)
// reads as not yet published.  The block that takes the last ticket resets
// the ticket for the next call.  The status words and the ticket live
// across calls (the wrapper keeps them per device), so a call allocates
// and clears nothing but its output.  Integer adds, so the result is exact
// (int32 wraps past 2^31 - 1).
//
// What bounds it: memory, each value read once and written once; a few
// integer adds per value.  The tile is 4096 values: 256 threads of 16, so
// that an 800x800 image's tile table of 5,000 values is 2 tiles and a
// 2,073,600-value mask 507, all resident at once on 132 SMs.

#include <cstdint>

#include <cuda_runtime.h>

namespace {

constexpr int kThreads = 256;
constexpr int kItems = 16;  // a multiple of 4: whole 128-bit loads
constexpr int kTile = kThreads * kItems;
constexpr int kWarps = kThreads / 32;
constexpr unsigned kFull = 0xffffffffu;
constexpr unsigned long long kAggregate = 1ull << 32;
constexpr unsigned long long kInclusive = 2ull << 32;

// shared rows padded by one word per 32, so that a warp's threads, each at
// its kItems neighbouring values, fall on 32 different banks
__host__ __device__ constexpr int pad(int i) { return i + (i >> 5); }

__device__ __forceinline__ unsigned long long load_status(const unsigned long long* p) {
  unsigned long long v;
  asm volatile("ld.relaxed.gpu.global.u64 %0, [%1];" : "=l"(v) : "l"(p) : "memory");
  return v;
}

__device__ __forceinline__ void store_status(unsigned long long* p, unsigned long long v) {
  asm volatile("st.relaxed.gpu.global.u64 [%0], %1;" ::"l"(p), "l"(v) : "memory");
}

// The exclusive prefix of tile `tile` (> 0): warp 0 reads the status words of
// the 32 tiles before `pred` at once; where each is an aggregate, it adds
// them all and steps back 32; where the nearest that is not an aggregate is
// an inclusive prefix, it adds the aggregates before it and that prefix and
// stops; where it is not published yet, it reads them again.
__device__ __forceinline__ int look_back(const unsigned long long* status, long long tile,
                                         unsigned long long tag, int lane) {
  int excl = 0;
  for (long long pred = tile - 1;; pred -= 32) {
    const long long j = pred - lane;
    unsigned flag;
    int val;
    for (;;) {
      flag = 2u;  // before tile 0: an inclusive prefix of 0
      val = 0;
      if (j >= 0) {
        const unsigned long long st = load_status(status + j);
        flag = (st >> 34) == tag ? static_cast<unsigned>(st >> 32) & 3u : 0u;
        val = static_cast<int>(static_cast<unsigned>(st));
      }
      const unsigned stop = __ballot_sync(kFull, flag != 1u);
      if (stop == 0u || __shfl_sync(kFull, flag, __ffs(stop) - 1) != 0u) break;
    }
    const unsigned incl = __ballot_sync(kFull, flag == 2u);
    const int last = incl ? __ffs(incl) - 1 : 31;
    int v = lane <= last ? val : 0;
#pragma unroll
    for (int o = 16; o > 0; o >>= 1) v += __shfl_xor_sync(kFull, v, o);
    excl += v;
    if (incl) return excl;
  }
}

__global__ void __launch_bounds__(kThreads)
k6_scan(const int* __restrict__ x, int* __restrict__ out, unsigned long long* __restrict__ status,
        unsigned* __restrict__ ticket, long long n, unsigned n_tiles, unsigned long long tag) {
  __shared__ int s[pad(kTile)];
  __shared__ int s_warp[kWarps];
  __shared__ unsigned s_tile;
  __shared__ int s_prefix;
  if (threadIdx.x == 0) {
    const unsigned t = atomicAdd(ticket, 1u);
    if (t == n_tiles - 1) atomicExch(ticket, 0u);  // every ticket taken
    s_tile = t;
  }
  __syncthreads();
  const long long tile = s_tile;
  const long long base = tile * kTile;
  const bool whole = base + kTile <= n;
  const bool aligned = (reinterpret_cast<uintptr_t>(x) & 15u) == 0u;
  if (whole && aligned) {
    const int4* xv = reinterpret_cast<const int4*>(x + base);
#pragma unroll
    for (int j = 0; j < kItems / 4; ++j) {
      const int v = threadIdx.x + j * kThreads;
      const int4 q = __ldcs(xv + v);  // read once: streamed past L1
      s[pad(4 * v)] = q.x;
      s[pad(4 * v + 1)] = q.y;
      s[pad(4 * v + 2)] = q.z;
      s[pad(4 * v + 3)] = q.w;
    }
  } else {
#pragma unroll
    for (int j = 0; j < kItems; ++j) {
      const int i = threadIdx.x + j * kThreads;
      s[pad(i)] = base + i < n ? x[base + i] : 0;
    }
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
    const int t = __shfl_up_sync(kFull, incl, o);
    if (lane >= o) incl += t;
  }
  if (lane == 31) s_warp[warp] = incl;
  __syncthreads();
  if (warp == 0) {  // the warp totals' inclusive scan, then the look-back
    int w = lane < kWarps ? s_warp[lane] : 0;
#pragma unroll
    for (int o = 1; o < 32; o <<= 1) {
      const int t = __shfl_up_sync(kFull, w, o);
      if (lane >= o) w += t;
    }
    if (lane < kWarps) s_warp[lane] = w;
    const int agg = __shfl_sync(kFull, w, kWarps - 1);
    const unsigned long long head = tag << 34;
    int prefix = 0;
    if (tile > 0) {
      if (lane == 0) store_status(status + tile, head | kAggregate | static_cast<unsigned>(agg));
      prefix = look_back(status, tile, tag, lane);
    }
    if (lane == 0) {
      store_status(status + tile, head | kInclusive | static_cast<unsigned>(prefix + agg));
      s_prefix = prefix;
    }
  }
  __syncthreads();
  int run = s_prefix + incl - sum + (warp > 0 ? s_warp[warp - 1] : 0);
#pragma unroll
  for (int k = 0; k < kItems; ++k) {
    s[pad(threadIdx.x * kItems + k)] = run;
    run += v[k];
  }
  __syncthreads();
  if (whole) {  // out is the wrapper's own allocation: 16-byte aligned
    int4* ov = reinterpret_cast<int4*>(out + base);
#pragma unroll
    for (int j = 0; j < kItems / 4; ++j) {
      const int q = threadIdx.x + j * kThreads;
      __stcs(ov + q, make_int4(s[pad(4 * q)], s[pad(4 * q + 1)], s[pad(4 * q + 2)],
                               s[pad(4 * q + 3)]));
    }
  } else {
#pragma unroll
    for (int j = 0; j < kItems; ++j) {
      const int i = threadIdx.x + j * kThreads;
      if (base + i < n) out[base + i] = s[pad(i)];
    }
  }
}

}  // namespace

// Values a scan tile holds.
extern "C" long long pt_k6_tile() { return kTile; }

// The largest call tag (tags run 1 .. pt_k6_max_tag(); a status word of
// tag 0 is one that was never written).
extern "C" long long pt_k6_max_tag() { return (1ll << 30) - 1; }

// Exclusive prefix sum of x (n int32, 0 < n < 2^31) into out (n int32, not
// x, 16-byte aligned) on `stream`, in one launch.  `state` is the scan's own
// scratch: the ticket (the low 32 bits of state[0], 0 between calls), then
// one status word per tile (at least ceil(n / pt_k6_tile())), zeroed when
// first made; `tag` (1 .. pt_k6_max_tag()) must differ from the tag of the
// calls that wrote the words since they were zeroed.  Returns the
// cudaError_t of the launch (0 = success).
extern "C" int pt_k6_scan(const int* x, int* out, unsigned long long* state, long long n,
                          long long tag, void* stream) {
  if (n <= 0 || n > 0x7fffffffLL || x == out || tag <= 0 || tag > pt_k6_max_tag() ||
      (reinterpret_cast<uintptr_t>(out) & 15u) != 0u)
    return static_cast<int>(cudaErrorInvalidValue);
  const long long tiles = (n + kTile - 1) / kTile;
  k6_scan<<<static_cast<unsigned>(tiles), kThreads, 0, static_cast<cudaStream_t>(stream)>>>(
      x, out, state + 1, reinterpret_cast<unsigned*>(state), n, static_cast<unsigned>(tiles),
      static_cast<unsigned long long>(tag));
  return static_cast<int>(cudaGetLastError());
}

extern "C" const char* pt_cuda_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}
