// Counter-based RNG on the device: every draw is a pure function of
// (iter, pixel, depth, draw).  Bit-identical to pathtrace_tpu_torch/core/rng.py
// (and so to the reference's core/rng.py): pcg4d-style mixing in native
// uint32_t arithmetic, which wraps mod 2^32 as the reference's uint32 does.
#pragma once

#include <cstdint>

namespace pt {

__device__ __forceinline__ uint32_t hash_u32(uint32_t a, uint32_t b,
                                             uint32_t c, uint32_t d) {
  a = a * 1664525u + 1013904223u;
  b = b * 1664525u + 1013904223u;
  c = c * 1664525u + 1013904223u;
  d = d * 1664525u + 1013904223u;
  a += b * d;
  b += c * a;
  c += a * b;
  d += b * c;
  a ^= a >> 16;
  b ^= b >> 16;
  c ^= c >> 16;
  d ^= d >> 16;
  a += b * d;
  b += c * a;
  c += a * b;
  d += b * c;
  return a ^ d;
}

// U[0,1) from the top 24 bits, exactly representable in float32.
__device__ __forceinline__ float uniform(uint32_t it, uint32_t pixel,
                                         uint32_t depth, uint32_t draw) {
  const int32_t top24 = static_cast<int32_t>(hash_u32(it, pixel, depth, draw) >> 8);
  return static_cast<float>(top24) * (1.0f / 16777216.0f);
}

// Draw slots (core/rng.py Draw): depth slot 0 is raygen, bounce d uses d+1.
constexpr uint32_t kDrawAaX = 0;
constexpr uint32_t kDrawAaY = 1;
constexpr uint32_t kDrawDofU = 2;
constexpr uint32_t kDrawDofV = 3;
constexpr uint32_t kDrawTime = 4;
constexpr uint32_t kDrawLobe = 0;
constexpr uint32_t kDrawDiffU1 = 1;
constexpr uint32_t kDrawDiffU2 = 2;
constexpr uint32_t kDrawFresnel = 3;
constexpr uint32_t kDrawSpecU1 = 4;
constexpr uint32_t kDrawSpecU2 = 5;
constexpr uint32_t kDrawRr = 6;
constexpr uint32_t kDrawSssStep = 8;
constexpr uint32_t kDrawSssU = 9;
constexpr uint32_t kDrawSssV = 10;
constexpr uint32_t kDrawNeeBase = 16;  // light k: kDrawNeeBase + 3k .. +3k+2

}  // namespace pt
