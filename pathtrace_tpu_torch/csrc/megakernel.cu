// K1 — forward path-trace megakernel for NVIDIA Hopper (sm_90a).
//
// Replaces the Pallas TPU kernel `_kernel` of
// pathtrace_tpu/ops/pallas/megakernel.py (its body is `_make_tracer`; it is
// reached from the pallas_call in `_run`) with every scene-feature section
// compiled out: spheres and cubes; diffuse, mirror and emissive materials;
// no depth of field, motion, checker, bump, subsurface scattering, glass,
// imperfect specular, NEE, Russian roulette, meshes, textures or gradients.
//
// What bounds it on the card: ALU work and divergence.  There is no
// device-memory traffic to speak of: the scene tables are a few hundred
// floats, and each pixel writes 12 bytes once per call.  Per sample and
// bounce a live path pays one ray test per geom (about 80 float32
// operations each, IEEE divisions and square roots among them), up to three
// hashes, and a shade with one sin and one cos on the diffuse lobe.
//
// What this first, simple design does about that:
// * one thread per pixel, looping over samples, then bounces, then geoms;
//   the branch on the geom type is the same for every thread of a warp;
// * the tables are staged once per block in shared memory, where the
//   threads of a warp all read the same word (a broadcast);
// * a path that has ended skips its bounce, so a dead path costs only
//   divergence (the reference computes masked lanes instead);
// * each thread sums its radiance in registers, in sample order, and writes
//   it once;
// * live counts: one __ballot_sync/__popc per warp and bounce, summed per
//   warp in shared memory, then one 64-bit atomicAdd per warp and bounce.
//   The reference keeps int32 counts; at 800x800 and 5000 samples a single
//   bounce sees 3.2e9 paths, which int32 cannot hold.
// It is built with -fmad=false and IEEE division and square root, so that
// it rounds as its plain PyTorch version (ops/cuda/megakernel.py
// trace_plain) does.

#include <cstdint>

#include <cuda_runtime.h>

#include "rng.cuh"

namespace {

constexpr int kBlock = 128;
constexpr int kWarps = kBlock / 32;
constexpr int kCamCols = 16;
constexpr int kMatCols = 24;
constexpr int kGeomCols = 40;
constexpr int kSphere = 0;
constexpr float kNoHit = 1e30f;
constexpr float kRayOffset = 1e-4f;
constexpr float kTwoPi = 6.2831853071795864769f;
constexpr float kSqrtThird = 0.5773502691896257645f;

// x * (1/sqrt(x.x)), never rsqrtf: the reference's rounding.
__device__ __forceinline__ void normalize3(float& x, float& y, float& z) {
  const float inv = 1.0f / sqrtf(x * x + y * y + z * z);
  x *= inv;
  y *= inv;
  z *= inv;
}

struct Hit {
  float dist, px, py, pz, nx, ny, nz;
  int geom;  // -1: no hit
};

// Nearest hit by world-space distance.  The strict `<` keeps the lower geom
// index on a tie.  gmat rows: forward 3x4 (0..11), inverse 3x4 (12..23),
// inverse-transpose 3x3 (24..32).
__device__ Hit nearest(float ox, float oy, float oz, float dx, float dy,
                       float dz, const float* gmat, const int* types,
                       int n_geoms) {
  Hit best{kNoHit, ox, oy, oz, 0.f, 0.f, 0.f, -1};
  for (int g = 0; g < n_geoms; ++g) {
    const float* m = gmat + g * kGeomCols;
    const float rox = m[12] * ox + m[13] * oy + m[14] * oz + m[15];
    const float roy = m[16] * ox + m[17] * oy + m[18] * oz + m[19];
    const float roz = m[20] * ox + m[21] * oy + m[22] * oz + m[23];
    float rdx = m[12] * dx + m[13] * dy + m[14] * dz;
    float rdy = m[16] * dx + m[17] * dy + m[18] * dz;
    float rdz = m[20] * dx + m[21] * dy + m[22] * dz;
    normalize3(rdx, rdy, rdz);

    bool hit;
    float qx, qy, qz, nx, ny, nz;
    if (types[g] == kSphere) {
      // radius 0.5 is implicit: r^2 = 0.25
      const float vdd = rox * rdx + roy * rdy + roz * rdz;
      const float rad2 = vdd * vdd - (rox * rox + roy * roy + roz * roz - 0.25f);
      const bool has_root = rad2 >= 0.f;
      const float sq = sqrtf(has_root ? rad2 : 1.f);
      const float t1 = -vdd + sq;
      const float t2 = -vdd - sq;
      const bool both_neg = t1 < 0.f && t2 < 0.f;
      const bool both_pos = t1 > 0.f && t2 > 0.f;
      const float t_use = both_pos ? fminf(t1, t2) : fmaxf(t1, t2);
      hit = has_root && !both_neg;
      const float tofs = t_use - kRayOffset;
      qx = rox + tofs * rdx;
      qy = roy + tofs * rdy;
      qz = roz + tofs * rdz;
      nx = m[24] * qx + m[25] * qy + m[26] * qz;
      ny = m[27] * qx + m[28] * qy + m[29] * qz;
      nz = m[30] * qx + m[31] * qy + m[32] * qz;
      normalize3(nx, ny, nz);
      const float flip = both_pos ? 1.f : -1.f;
      nx *= flip;
      ny *= flip;
      nz *= flip;
    } else {
      // cube: slab test with sequential per-axis updates.  A zero direction
      // component divides to +-inf; 0/0 gives NaN, which marks a miss.
      // (fminf/fmaxf drop a NaN where the reference keeps it, but such a
      // geom is a miss either way.)
      float tmin = -1e38f, tmax = 1e38f;
      float nmin[3] = {0.f, 0.f, 0.f};
      float nmax[3] = {0.f, 0.f, 0.f};
      bool nan_axis = false;
      const float qo[3] = {rox, roy, roz};
      const float qd[3] = {rdx, rdy, rdz};
#pragma unroll
      for (int ax = 0; ax < 3; ++ax) {
        const float t1 = (-0.5f - qo[ax]) / qd[ax];
        const float t2 = (0.5f - qo[ax]) / qd[ax];
        const float ta = fminf(t1, t2);
        const float tb = fmaxf(t1, t2);
        nan_axis = nan_axis || isnan(t1) || isnan(t2);
        const float sign = t2 < t1 ? 1.f : -1.f;
        if (ta > 0.f && ta > tmin) {
          tmin = ta;
#pragma unroll
          for (int k = 0; k < 3; ++k) nmin[k] = k == ax ? sign : 0.f;
        }
        if (tb < tmax) {
          tmax = tb;
#pragma unroll
          for (int k = 0; k < 3; ++k) nmax[k] = k == ax ? sign : 0.f;
        }
      }
      hit = tmax >= tmin && tmax > 0.f && !nan_axis;
      const bool inside = tmin <= 0.f;
      const float t_use = inside ? tmax : tmin;
      const float tofs = t_use - kRayOffset;
      qx = rox + tofs * rdx;
      qy = roy + tofs * rdy;
      qz = roz + tofs * rdz;
      const float nox = inside ? nmax[0] : nmin[0];
      const float noy = inside ? nmax[1] : nmin[1];
      const float noz = inside ? nmax[2] : nmin[2];
      // quirk kept from the reference: the box normal goes through the
      // FORWARD transform (src/intersections.h:85)
      nx = m[0] * nox + m[1] * noy + m[2] * noz;
      ny = m[4] * nox + m[5] * noy + m[6] * noz;
      nz = m[8] * nox + m[9] * noy + m[10] * noz;
      normalize3(nx, ny, nz);
    }
    const float pxw = m[0] * qx + m[1] * qy + m[2] * qz + m[3];
    const float pyw = m[4] * qx + m[5] * qy + m[6] * qz + m[7];
    const float pzw = m[8] * qx + m[9] * qy + m[10] * qz + m[11];
    const float ddx = ox - pxw, ddy = oy - pyw, ddz = oz - pzw;
    const float dist = hit ? sqrtf(ddx * ddx + ddy * ddy + ddz * ddz) : kNoHit;
    if (dist < best.dist) best = Hit{dist, pxw, pyw, pzw, nx, ny, nz, g};
  }
  return best;
}

__global__ void __launch_bounds__(kBlock)
k1_trace(const float* __restrict__ cam_g, const float* __restrict__ mats_g,
         const float* __restrict__ gmat_g, const int* __restrict__ types_g,
         int n_geoms, int width, int height, int depth, uint32_t it0,
         int n_spp, long long pix0, long long n_local,
         float* __restrict__ rad, unsigned long long* __restrict__ counts) {
  // shared: per-warp live counts [kWarps][depth], then cam, mats, gmat, types
  extern __shared__ unsigned long long smem[];
  unsigned long long* s_counts = smem;
  float* s_cam = reinterpret_cast<float*>(s_counts + kWarps * depth);
  float* s_mats = s_cam + kCamCols;
  float* s_gmat = s_mats + n_geoms * kMatCols;
  int* s_types = reinterpret_cast<int*>(s_gmat + n_geoms * kGeomCols);
  for (int i = threadIdx.x; i < kCamCols; i += kBlock) s_cam[i] = cam_g[i];
  for (int i = threadIdx.x; i < n_geoms * kMatCols; i += kBlock) s_mats[i] = mats_g[i];
  for (int i = threadIdx.x; i < n_geoms * kGeomCols; i += kBlock) s_gmat[i] = gmat_g[i];
  for (int i = threadIdx.x; i < n_geoms; i += kBlock) s_types[i] = types_g[i];
  for (int i = threadIdx.x; i < kWarps * depth; i += kBlock) s_counts[i] = 0ull;
  __syncthreads();

  const int warp = threadIdx.x >> 5;
  const int lane = threadIdx.x & 31;
  const long long idx = static_cast<long long>(blockIdx.x) * kBlock + threadIdx.x;
  const long long pixel = pix0 + idx;
  // threads past the end still run the loops: every lane joins the ballots
  const bool valid = idx < n_local && pixel < static_cast<long long>(width) * height;
  const uint32_t pix_u = static_cast<uint32_t>(pixel);
  const float fx = static_cast<float>(pixel % width);
  const float fy = static_cast<float>(pixel / width);
  const float sx_scale = static_cast<float>(2.0 / width);
  const float sy_scale = static_cast<float>(2.0 / height);
  const float pos_x = s_cam[0], pos_y = s_cam[1], pos_z = s_cam[2];
  const float v_x = s_cam[3], v_y = s_cam[4], v_z = s_cam[5];
  const float r_x = s_cam[6], r_y = s_cam[7], r_z = s_cam[8];
  const float u_x = s_cam[9], u_y = s_cam[10], u_z = s_cam[11];
  const float tan_x = s_cam[12], tan_y = s_cam[13];

  float acc_r = 0.f, acc_g = 0.f, acc_b = 0.f;
  for (int s = 0; s < n_spp; ++s) {
    const uint32_t it = it0 + static_cast<uint32_t>(s);
    // raygen with antialias jitter
    const float ujx = pt::uniform(it, pix_u, 0u, pt::kDrawAaX);
    const float ujy = pt::uniform(it, pix_u, 0u, pt::kDrawAaY);
    const float sx = (fx + ujx) * sx_scale - 1.f;
    const float sy = (fy + ujy) * sy_scale - 1.f;
    float dx = v_x - r_x * (tan_x * sx) - u_x * (tan_y * sy);
    float dy = v_y - r_y * (tan_x * sx) - u_y * (tan_y * sy);
    float dz = v_z - r_z * (tan_x * sx) - u_z * (tan_y * sy);
    normalize3(dx, dy, dz);
    float ox = pos_x, oy = pos_y, oz = pos_z;
    float tr = 1.f, tg = 1.f, tb = 1.f;
    float rr = 0.f, rg = 0.f, rb = 0.f;
    bool live = valid;

    for (int d = 0; d < depth; ++d) {
      const unsigned ballot = __ballot_sync(0xffffffffu, live);
      if (lane == 0) s_counts[warp * depth + d] += __popc(ballot);
      if (!live) continue;
      const Hit h = nearest(ox, oy, oz, dx, dy, dz, s_gmat, s_types, n_geoms);
      if (h.geom < 0) {  // miss: the path ends
        live = false;
        continue;
      }
      const float* mt = s_mats + h.geom * kMatCols;
      const float emit = mt[10];
      if (emit > 0.f) {  // emissive hit: collect and end
        rr = rr + tr * mt[0] * emit;
        rg = rg + tg * mt[1] * emit;
        rb = rb + tb * mt[2] * emit;
        live = false;
        continue;
      }
      const uint32_t dep = static_cast<uint32_t>(d) + 1u;
      const float u_lobe = pt::uniform(it, pix_u, dep, pt::kDrawLobe);
      const float p_spec = fminf(fmaxf(mt[7], 0.f), 1.f);
      const bool take_spec = u_lobe < p_spec;
      const float p_safe = fmaxf(take_spec ? p_spec : 1.f - p_spec, 1e-8f);
      float ndx, ndy, ndz;
      if (take_spec) {  // mirror
        const float ndoti = h.nx * dx + h.ny * dy + h.nz * dz;
        ndx = dx - 2.f * ndoti * h.nx;
        ndy = dy - 2.f * ndoti * h.ny;
        ndz = dz - 2.f * ndoti * h.nz;
      } else {  // cosine hemisphere with the Peter-Kutz frame
        const float u_d1 = pt::uniform(it, pix_u, dep, pt::kDrawDiffU1);
        const float u_d2 = pt::uniform(it, pix_u, dep, pt::kDrawDiffU2);
        const float up = sqrtf(u_d1);
        const float over = sqrtf(fmaxf(1.f - up * up, 0.f));
        const float around = u_d2 * kTwoPi;
        const bool use_x = fabsf(h.nx) < kSqrtThird;
        const bool use_y = !use_x && fabsf(h.ny) < kSqrtThird;
        const float nn_x = use_x ? 1.f : 0.f;
        const float nn_y = use_y ? 1.f : 0.f;
        const float nn_z = (use_x || use_y) ? 0.f : 1.f;
        float p1x = h.ny * nn_z - h.nz * nn_y;
        float p1y = h.nz * nn_x - h.nx * nn_z;
        float p1z = h.nx * nn_y - h.ny * nn_x;
        normalize3(p1x, p1y, p1z);
        float p2x = h.ny * p1z - h.nz * p1y;
        float p2y = h.nz * p1x - h.nx * p1z;
        float p2z = h.nx * p1y - h.ny * p1x;
        normalize3(p2x, p2y, p2z);
        const float ca = cosf(around);
        const float sa = sinf(around);
        ndx = up * h.nx + ca * over * p1x + sa * over * p2x;
        ndy = up * h.ny + ca * over * p1y + sa * over * p2y;
        ndz = up * h.nz + ca * over * p1z + sa * over * p2z;
      }
      const float* tint = take_spec ? mt + 3 : mt;  // spec color or albedo
      tr = tr * (tint[0] / p_safe);
      tg = tg * (tint[1] / p_safe);
      tb = tb * (tint[2] / p_safe);
      ox = h.px;
      oy = h.py;
      oz = h.pz;
      dx = ndx;
      dy = ndy;
      dz = ndz;
    }
    acc_r = acc_r + rr;
    acc_g = acc_g + rg;
    acc_b = acc_b + rb;
  }
  if (idx < n_local) {
    rad[3 * idx + 0] = acc_r;
    rad[3 * idx + 1] = acc_g;
    rad[3 * idx + 2] = acc_b;
  }
  if (lane == 0) {
    for (int d = 0; d < depth; ++d) {
      const unsigned long long c = s_counts[warp * depth + d];
      if (c) atomicAdd(&counts[d], c);
    }
  }
}

}  // namespace

// Launches K1 on `stream` over pixels pix0 .. pix0+n_local-1: n_spp samples
// each, iterations it0 .. it0+n_spp-1.  rad (n_local,3) float32 is written;
// counts (depth,) must be zeroed by the caller and is added into.  Returns
// the cudaError_t of the launch (0 = success).
extern "C" int pt_k1_trace(const float* cam, const float* mats,
                           const float* gmat, const int* geom_types,
                           int n_geoms, int width, int height, int depth,
                           unsigned int it0, int n_spp, long long pix0,
                           long long n_local, float* rad,
                           unsigned long long* counts, void* stream) {
  const size_t smem = sizeof(unsigned long long) * kWarps * depth +
                      sizeof(float) * (kCamCols + n_geoms * (kMatCols + kGeomCols)) +
                      sizeof(int) * n_geoms;
  if (smem > 48 * 1024) {
    const cudaError_t e = cudaFuncSetAttribute(
        k1_trace, cudaFuncAttributeMaxDynamicSharedMemorySize, static_cast<int>(smem));
    if (e != cudaSuccess) return static_cast<int>(e);
  }
  const long long blocks = (n_local + kBlock - 1) / kBlock;
  if (blocks <= 0 || blocks > 0x7fffffffLL) return static_cast<int>(cudaErrorInvalidValue);
  k1_trace<<<static_cast<unsigned>(blocks), kBlock, smem,
             static_cast<cudaStream_t>(stream)>>>(
      cam, mats, gmat, geom_types, n_geoms, width, height, depth, it0, n_spp,
      pix0, n_local, rad, counts);
  return static_cast<int>(cudaGetLastError());
}

extern "C" const char* pt_cuda_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}
