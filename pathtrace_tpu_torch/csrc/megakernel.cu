// K1 — forward path-trace megakernel for NVIDIA Hopper (sm_90a), with its
// NEE section K2, its triangle-mesh section K3 and its image-texture
// section K4.
//
// Replaces the Pallas TPU kernel `_kernel` of
// pathtrace_tpu/ops/pallas/megakernel.py (its body is `_make_tracer`; it is
// reached from the pallas_call in `_run`) for scenes of spheres, cubes and
// triangle meshes: diffuse, mirror, imperfect-specular (power cosine), glass
// (Schlick + Snell), emissive and subsurface (random-walk medium) materials;
// depth of field, motion blur, checker and bump; next-event estimation
// (`_nee_add`: one area sample and one shadow ray per light and bounce),
// Russian roulette, and image textures (albedo TEXTURE maps and BUMPTEX
// height maps).
//
// Built with -DPT_GRAD=1, the library also holds K7, the analytic material
// gradients (k7_grads: the reference's grad mode of `_kernel`, with
// `_grad_accumulate`); built with -DPT_VJP=1, K8, the reverse sweep
// (k8_vjp: the reference's `_vjp_kernel`).  Both run the same init_state and
// bounce as K1; the forward builds are compiled without them, and they
// without K1 and K5.
//
// The same library holds K5, the span kernel of the split and sorted
// engines (k5_span, at the end): bounces [d0, d1) on path state kept in
// global memory.  K1's depth loop and K5 call one init_state and one
// bounce, as the reference's kernels share `_make_tracer`.
//
// Like Mosaic's kernel, it is specialized at compile time on the feature
// set: PT_FEATURES (ops/cuda/megakernel.py feature_mask) holds one bit per
// scene feature, then NEE, Russian roulette, meshes, albedo maps and
// BUMPTEX maps, and each section is an `if constexpr`.  With PT_FEATURES=0
// it is the feature-free kernel.
//
// What bounds it on the card: ALU work and divergence.  There is no
// device-memory traffic to speak of: the scene and light tables are a few
// hundred floats, and each pixel writes 12 bytes once per call.  Per sample
// and bounce a live path pays one ray test per geom (about 80 float32
// operations each, IEEE divisions and square roots among them), up to a
// dozen hashes, a shade with a few transcendentals, and with NEE one more
// ray test over every geom per light.
//
// What the design does about that:
// * one path per lane at a time, looping over bounces, then geoms; the
//   branch on the geom type is the same for every thread of a warp, and so
//   is the branch on the light type in the NEE loop;
// * the lane schedule (k1_trace): a lane whose path ends starts its pixel's
//   next sample in the same step, and a lane whose pixel has run its
//   samples takes the next pixel of its block's pool, so its warp no longer
//   waits, sample by sample, for its longest path (48% of the lane-steps of
//   a thread-per-pixel loop held a dead path on cornell, d8, 8 spp:
//   tests/torch_lane_model.py);
// * the tables are staged once per block in shared memory, where the
//   threads of a warp all read the same word (a broadcast);
// * the nearest-hit fold carries only the winner's geometry; its material
//   fields, checker albedo and bump normal are computed once after the fold
//   from its object-space point and its table rows (the same arithmetic on
//   the same inputs as the reference's per-geom selects);
// * a shade computes only the lobe it takes (the reference computes masked
//   lanes instead);
// * a pixel's lane sums its radiance in registers, in sample order, and
//   writes it once (per sample, once a chunk of samples: the sum so far
//   waits in rad for the next chunk);
// * live counts: the lanes of a warp sit at different bounces and samples,
//   so each live path entering a bounce adds one to a 32-bit word of its
//   block in shared memory (a native shared atomic), and the block adds its
//   words into the 64-bit global counts once it has run a chunk of samples:
//   one word a bounce (summed), or one a sample and a bounce (per sample,
//   the reference's (n_iters, depth), k1_trace<true>).  Shadow rays are not
//   counted.  The reference keeps int32 counts; at
//   800x800 and 5000 samples a single bounce sees 3.2e9 paths, which int32
//   cannot hold.
// K3, meshes (the reference's BVH walk `trav_w`/`leaf_w` and its winner
// fold `mt_shade_fold`): per MESH geom, after the spheres and cubes, each
// thread walks the geom's skip-link BVH (scene/bvh.py: DFS order, no stack)
// on its own ray, reading the node and triangle tables from global memory
// as float4s through the read-only cache.  They fit in the 50 MB L2: 16
// floats a node and a triangle, 7.3 MB for an 81,920-triangle mesh.  What
// bounds the walk is latency: one dependent node load per step, a few
// hundred steps on a big mesh, warps diverging as their rays take different
// paths.  The walk carries only (winner row, t_loc); the shading fold runs
// once, afterwards, on the winner's reloaded row, with the same arithmetic
// as the walk's test, so the winner and its distance are the ones the
// reference's winner fold finds.
// K3-linear, a mesh without a BVH (the reference's `tri_body`, mask bit
// 4096 beside 512): every triangle, in index order, is one candidate of
// the world-space fold.  It is the gradients' oracle, not a fast path: it
// costs a ray test per triangle, and the triangle rows (read in order,
// the same rows by every thread of a warp) come through the L1 and L2.
// K4, image textures (the reference's `_bilin3`, `_lum`, the UV charts of
// its fold and the `_atan2`/`_asin` polynomials; not its row sweep or slab
// server, which exist for the TPU's gather): once per hit, after the fold,
// where the winner has a chart.  Its UV comes from what the fold carried
// (a cube's face chart, a triangle's interpolated vt) or, on a sphere, from
// its object-space point; then 4 taps for the albedo map and 16 for the
// BUMPTEX map's central differences.  A tap is one 32-bit load of a texel
// word (r | g << 8 | b << 16) through the read-only cache and a byte / 255
// IEEE division, the loader's own value.  The maps are small beside the
// 50 MB L2 (a 512x512 map is 1 MB), so what bounds the section is the
// latency of the dependent loads and the integer wrap arithmetic, not
// bandwidth; the weights are computed in float32 as the reference's, never
// by texture hardware, whose 8-bit fixed-point weights would round
// differently.
//
// It is built with -fmad=false and IEEE division and square root, so that
// it rounds as its plain PyTorch version (ops/cuda/megakernel.py
// trace_plain) does.

#include <cmath>
#include <cstdint>
#include <type_traits>

#include <cuda_runtime.h>

#include "rng.cuh"

#ifndef PT_FEATURES
#define PT_FEATURES 0
#endif
#ifndef PT_GRAD
#define PT_GRAD 0
#endif
#ifndef PT_VJP
#define PT_VJP 0
#endif

namespace {

constexpr unsigned kFeatures = PT_FEATURES;
constexpr bool kGlass = kFeatures & 1u;
constexpr bool kImperfect = kFeatures & 2u;
constexpr bool kDof = kFeatures & 4u;
constexpr bool kMotion = kFeatures & 8u;
constexpr bool kChecker = kFeatures & 16u;
constexpr bool kBump = kFeatures & 32u;
constexpr bool kSss = kFeatures & 64u;
constexpr bool kNee = kFeatures & 128u;
constexpr bool kRr = kFeatures & 256u;
constexpr bool kMesh = kFeatures & 512u;
constexpr bool kTex = kFeatures & 1024u;   // an albedo map on some geom
constexpr bool kBtex = kFeatures & 2048u;  // a BUMPTEX map on some geom
constexpr bool kTexAny = kTex || kBtex;
// K3-linear: the meshes have no BVH, and every triangle is folded (with
// kMesh)
constexpr bool kLinear = kFeatures & 4096u;
static_assert(!kLinear || kMesh, "the linear fold is a form of the mesh section");

constexpr int kBlock = 128;
constexpr int kWarps = kBlock / 32;
constexpr int kCamCols = 16;
constexpr int kMatCols = 24;
constexpr int kGeomCols = 40;
constexpr int kLightCols = 128;
constexpr int kSphere = 0;
constexpr int kMeshType = 2;
constexpr int kMetaCols = 5;  // geom, node_off, n_nodes, tri_off, n_tris
// float4s per triangle row: v0 e1 e2 n_obj pad, and in the texture builds
// the vt corners and the BUMPTEX UV gradients (pack_mesh)
constexpr int kTriF4 = kTexAny ? 6 : 4;
constexpr int kChartCols = 6;  // albedo offset, H, W; BUMPTEX offset, H, W
constexpr float kNoHit = 1e30f;
constexpr float kRayOffset = 1e-4f;
// slack of the object-space pruning bound, float32(1 + 1e-5)
constexpr float kBoundSlack = static_cast<float>(1.0 + 1e-5);
constexpr float kTwoPi = 6.2831853071795864769f;
constexpr float kSqrtThird = 0.5773502691896257645f;
// float32 of the double constants, as the reference rounds them
constexpr double kPiD = 3.14159265358979323846;
constexpr float kPi = static_cast<float>(kPiD);
constexpr float kInvPi = static_cast<float>(1.0 / kPiD);
constexpr float kHalfPi = static_cast<float>(0.5 * kPiD);
constexpr float kInvTwoPi = static_cast<float>(1.0 / (2.0 * kPiD));
constexpr float kThird = static_cast<float>(1.0 / 3.0);

// x * (1/sqrt(x.x)), never rsqrtf: the reference's rounding.
__device__ __forceinline__ void normalize3(float& x, float& y, float& z) {
  const float inv = 1.0f / sqrtf(x * x + y * y + z * z);
  x *= inv;
  y *= inv;
  z *= inv;
}

struct HitPlain {
  float dist, px, py, pz, nx, ny, nz;
  float qx, qy, qz;  // object-space point: checker, bump, textures
  int geom;          // -1: no hit
  bool outside;      // entering the geom (glass, SSS)
#if PT_VJP
  int row = -1;  // K8: the winning triangle's row (-1: not a triangle)
#endif
};
// The texture builds also carry the winner's chart coordinates (a cube's
// face chart, a triangle's interpolated vt; a sphere's come from q after the
// fold) and its triangle row (-1: not a triangle).  The other builds keep
// HitPlain, so that their code does not change.
struct HitTex {
  float dist, px, py, pz, nx, ny, nz;
  float qx, qy, qz;
  int geom;
  bool outside;
  float u = 0.f, v = 0.f;
  int row = -1;
};
using Hit = std::conditional_t<kTexAny, HitTex, HitPlain>;

template <typename H>
__device__ __forceinline__ void set_tex(H& h, float u, float v, int row) {
  if constexpr (kTexAny) {
    h.u = u;
    h.v = v;
    h.row = row;
  }
}

// The triangle meshes.  Rows of kTriF4 float4s: tri (pack_mesh) v0 e1 e2
// n_obj pad (and vt, UV gradients), in BVH order; nodes (scene/bvh.py) min
// max skip start count pad, 4 float4s.  meta: kMetaCols ints per MESH geom.
// An empty struct in the builds without meshes, so that their code does not
// change.
template <bool kOn>
struct MeshTables {
  __device__ MeshTables(const float4* t, const float4* n, const int* m, int c)
      : tri(t), nodes(n), meta(m), n_meta(c) {}
  const float4* tri;
  const float4* nodes;
  const int* meta;
  int n_meta;
};
template <>
struct MeshTables<false> {
  __device__ MeshTables(const float4*, const float4*, const int*, int) {}
};
using Mesh = MeshTables<kMesh>;

// The image textures: one uint32 word per texel (pack_textures) in global
// memory; the kChartCols chart ints per geom are staged in shared memory.
// An empty struct in the builds without textures.
template <bool kOn>
struct TexTables {
  __device__ explicit TexTables(const uint32_t* t) : texels(t) {}
  const uint32_t* texels;
};
template <>
struct TexTables<false> {
  __device__ explicit TexTables(const uint32_t*) {}
};
using Tex = TexTables<kTexAny>;

// The albedo: a pointer into the material (or checker) row, and in the
// texture builds three floats, which the albedo map multiplies.
struct Rgb {
  __device__ Rgb(const float* p) : c{p[0], p[1], p[2]} {}
  __device__ float operator[](int i) const { return c[i]; }
  float c[3];
};
using Albedo = std::conditional_t<kTexAny, Rgb, const float*>;

// A lobe's throughput: the specular colour spec or the albedo al, over
// p_safe.
template <typename A>
__device__ __forceinline__ void lobe_tint(const float* spec, const A& al, bool take_spec,
                                          float p_safe, float& r, float& g, float& b) {
  if constexpr (std::is_pointer_v<A>) {
    const float* tint = take_spec ? spec : al;
    r = tint[0] / p_safe;
    g = tint[1] / p_safe;
    b = tint[2] / p_safe;
  } else {
    r = (take_spec ? spec[0] : al[0]) / p_safe;
    g = (take_spec ? spec[1] : al[1]) / p_safe;
    b = (take_spec ? spec[2] : al[2]) / p_safe;
  }
}

// One axis of the ray/box slab test: t entering and leaving.  A NaN (origin
// on the slab plane, zero direction component) frees the axis, as the
// reference's guard does; fminf/fmaxf would drop it instead.
__device__ __forceinline__ void slab(float mn, float mx, float o, float ird,
                                     float& ta, float& tb) {
  const float t1 = (mn - o) * ird;
  const float t2 = (mx - o) * ird;
  const bool nan = isnan(t1) || isnan(t2);
  ta = nan ? -INFINITY : fminf(t1, t2);
  tb = nan ? INFINITY : fmaxf(t1, t2);
}

// Moller-Trumbore against the triangle row at t (3 float4 loads): the hit
// distance along the object-space ray in tt, and with kBary the
// barycentrics of v1 and v2 in *bu, *bv.
template <bool kBary = false>
__device__ __forceinline__ bool tri_test(float rox, float roy, float roz,
                                         float rdx, float rdy, float rdz,
                                         const float4* t, float& tt,
                                         float* bu = nullptr, float* bv = nullptr) {
  const float4 a = __ldg(t), b = __ldg(t + 1), c = __ldg(t + 2);
  const float v0x = a.x, v0y = a.y, v0z = a.z;
  const float e1x = a.w, e1y = b.x, e1z = b.y;
  const float e2x = b.z, e2y = b.w, e2z = c.x;
  const float pvx = rdy * e2z - rdz * e2y;
  const float pvy = rdz * e2x - rdx * e2z;
  const float pvz = rdx * e2y - rdy * e2x;
  const float det = pvx * e1x + pvy * e1y + pvz * e1z;
  const bool ok = fabsf(det) > 1e-12f;
  const float inv_det = 1.f / (ok ? det : 1.f);
  const float tvx = rox - v0x, tvy = roy - v0y, tvz = roz - v0z;
  const float u = (tvx * pvx + tvy * pvy + tvz * pvz) * inv_det;
  const float qvx = tvy * e1z - tvz * e1y;
  const float qvy = tvz * e1x - tvx * e1z;
  const float qvz = tvx * e1y - tvy * e1x;
  const float vv = (rdx * qvx + rdy * qvy + rdz * qvz) * inv_det;
  tt = (e2x * qvx + e2y * qvy + e2z * qvz) * inv_det;
  if constexpr (kBary) {
    *bu = u;
    *bv = vv;
  }
  return ok && u >= 0.f && vv >= 0.f && u + vv <= 1.f && tt > 0.f;
}

// The hit of a fold's winning triangle, row `row` (at t) of geom g (gmat row
// m), from the ray (o, d) at shutter time `time`: the object ray,
// Moller-Trumbore's distance, the point and its world distance, the
// ray-facing normal through invT (not in the shadow form) and, in the
// texture builds, the interpolated vt.  The arithmetic of the folds' tests,
// so the distance is the bits they compared.  K3-linear's shading and K8's
// recomputed winner.
template <bool kShadow>
__device__ __forceinline__ Hit tri_hit(const float* m, int g, const float4* t, int row,
                                       float ox, float oy, float oz, float dx, float dy,
                                       float dz, float time) {
  float gox = ox, goy = oy, goz = oz;
  if constexpr (kMotion) {
    gox = ox - time * m[33];
    goy = oy - time * m[34];
    goz = oz - time * m[35];
  }
  const float rox = m[12] * gox + m[13] * goy + m[14] * goz + m[15];
  const float roy = m[16] * gox + m[17] * goy + m[18] * goz + m[19];
  const float roz = m[20] * gox + m[21] * goy + m[22] * goz + m[23];
  float rdx = m[12] * dx + m[13] * dy + m[14] * dz;
  float rdy = m[16] * dx + m[17] * dy + m[18] * dz;
  float rdz = m[20] * dx + m[21] * dy + m[22] * dz;
  normalize3(rdx, rdy, rdz);
  float tt;
  [[maybe_unused]] float bu = 0.f, bv = 0.f;
  tri_test<kTexAny>(rox, roy, roz, rdx, rdy, rdz, t, tt, &bu, &bv);
  const float tofs = tt - kRayOffset;
  const float qx = rox + tofs * rdx;
  const float qy = roy + tofs * rdy;
  const float qz = roz + tofs * rdz;
  float nx = 0.f, ny = 0.f, nz = 0.f;
  bool outside = false;
  if constexpr (!kShadow) {
    const float4 c = __ldg(t + 2);  // e2z, n_obj
    const float face = rdx * c.y + rdy * c.z + rdz * c.w;
    const float flip = face < 0.f ? 1.f : -1.f;
    nx = (m[24] * c.y + m[25] * c.z + m[26] * c.w) * flip;
    ny = (m[27] * c.y + m[28] * c.z + m[29] * c.w) * flip;
    nz = (m[30] * c.y + m[31] * c.z + m[32] * c.w) * flip;
    normalize3(nx, ny, nz);
    outside = face < 0.f;
  }
  float pxw = m[0] * qx + m[1] * qy + m[2] * qz + m[3];
  float pyw = m[4] * qx + m[5] * qy + m[6] * qz + m[7];
  float pzw = m[8] * qx + m[9] * qy + m[10] * qz + m[11];
  const float ddx = gox - pxw, ddy = goy - pyw, ddz = goz - pzw;
  if constexpr (kMotion) {
    pxw = pxw + time * m[33];
    pyw = pyw + time * m[34];
    pzw = pzw + time * m[35];
  }
  const float dist = sqrtf(ddx * ddx + ddy * ddy + ddz * ddz);
  Hit h{dist, pxw, pyw, pzw, nx, ny, nz, qx, qy, qz, g, outside};
  if constexpr (kTexAny && !kShadow) {
    const float4 d = __ldg(t + 3);  // u0 v0 u1 v1
    const float4 e = __ldg(t + 4);  // u2 v2, grad_u xy
    const float bw = 1.f - bu - bv;
    set_tex(h, bw * d.x + bu * d.z + bv * e.x, bw * d.y + bu * d.w + bv * e.y, row);
  }
  return h;
}

// Nearest hit by world-space distance: the spheres and cubes in index
// order, then (mesh builds) each MESH geom in meta order.  The strict `<`
// keeps the geom folded first on a tie.  gmat rows: forward 3x4 (0..11),
// inverse 3x4 (12..23), inverse-transpose 3x3 (24..32), velocity (33..35).
// `time` is the ray's shutter time (motion blur).  The shadow form (NEE
// visibility) skips the normals; its distances and winners are those of the
// full fold.
template <bool kShadow, typename M>
__device__ Hit nearest(float ox, float oy, float oz, float dx, float dy,
                       float dz, float time, const float* gmat,
                       const int* types, int n_geoms, const M mesh) {
  Hit best{kNoHit, ox, oy, oz, 0.f, 0.f, 0.f, 0.f, 0.f, 0.f, -1, false};
  for (int g = 0; g < n_geoms; ++g) {
    if constexpr (kMesh) {
      if (types[g] == kMeshType) continue;  // walked below
    }
    const float* m = gmat + g * kGeomCols;
    // motion blur: the ray origin moves back by time * velocity
    float gox = ox, goy = oy, goz = oz;
    if constexpr (kMotion) {
      gox = ox - time * m[33];
      goy = oy - time * m[34];
      goz = oz - time * m[35];
    }
    const float rox = m[12] * gox + m[13] * goy + m[14] * goz + m[15];
    const float roy = m[16] * gox + m[17] * goy + m[18] * goz + m[19];
    const float roz = m[20] * gox + m[21] * goy + m[22] * goz + m[23];
    float rdx = m[12] * dx + m[13] * dy + m[14] * dz;
    float rdy = m[16] * dx + m[17] * dy + m[18] * dz;
    float rdz = m[20] * dx + m[21] * dy + m[22] * dz;
    normalize3(rdx, rdy, rdz);

    bool hit, outside;
    float qx, qy, qz, nx = 0.f, ny = 0.f, nz = 0.f;
    [[maybe_unused]] float tu = 0.f, tv = 0.f;  // chart coordinates (cube)
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
      outside = both_pos;
      const float tofs = t_use - kRayOffset;
      qx = rox + tofs * rdx;
      qy = roy + tofs * rdy;
      qz = roz + tofs * rdz;
      if constexpr (!kShadow) {
        nx = m[24] * qx + m[25] * qy + m[26] * qz;
        ny = m[27] * qx + m[28] * qy + m[29] * qz;
        nz = m[30] * qx + m[31] * qy + m[32] * qz;
        normalize3(nx, ny, nz);
        const float flip = both_pos ? 1.f : -1.f;
        nx *= flip;
        ny *= flip;
        nz *= flip;
      }
    } else {
      // cube: slab test with sequential per-axis updates.  A zero direction
      // component divides to +-inf; 0/0 gives NaN, which marks a miss.
      // (fminf/fmaxf drop a NaN where the reference keeps it, but nan_axis
      // makes such a geom a miss either way.)
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
          if constexpr (!kShadow) {
#pragma unroll
            for (int k = 0; k < 3; ++k) nmin[k] = k == ax ? sign : 0.f;
          }
        }
        if (tb < tmax) {
          tmax = tb;
          if constexpr (!kShadow) {
#pragma unroll
            for (int k = 0; k < 3; ++k) nmax[k] = k == ax ? sign : 0.f;
          }
        }
      }
      hit = tmax >= tmin && tmax > 0.f && !nan_axis;
      const bool inside = tmin <= 0.f;
      outside = !inside;
      const float t_use = inside ? tmax : tmin;
      const float tofs = t_use - kRayOffset;
      qx = rox + tofs * rdx;
      qy = roy + tofs * rdy;
      qz = roz + tofs * rdz;
      if constexpr (!kShadow) {
        const float nox = inside ? nmax[0] : nmin[0];
        const float noy = inside ? nmax[1] : nmin[1];
        const float noz = inside ? nmax[2] : nmin[2];
        // quirk kept from the reference: the box normal goes through the
        // FORWARD transform (src/intersections.h:85)
        nx = m[0] * nox + m[1] * noy + m[2] * noz;
        ny = m[4] * nox + m[5] * noy + m[6] * noz;
        nz = m[8] * nox + m[9] * noy + m[10] * noz;
        normalize3(nx, ny, nz);
        if constexpr (kTexAny) {
          // the face chart: planar in the two axes off the face normal
          tu = (fabsf(nox) > 0.f ? qz : qx) + 0.5f;
          tv = (fabsf(noy) > 0.f ? qz : qy) + 0.5f;
        }
      }
    }
    float pxw = m[0] * qx + m[1] * qy + m[2] * qz + m[3];
    float pyw = m[4] * qx + m[5] * qy + m[6] * qz + m[7];
    float pzw = m[8] * qx + m[9] * qy + m[10] * qz + m[11];
    const float ddx = gox - pxw, ddy = goy - pyw, ddz = goz - pzw;
    if constexpr (kMotion) {
      // the hit point back at shutter time t, on the moved object
      pxw = pxw + time * m[33];
      pyw = pyw + time * m[34];
      pzw = pzw + time * m[35];
    }
    const float dist = hit ? sqrtf(ddx * ddx + ddy * ddy + ddz * ddz) : kNoHit;
    if (dist < best.dist) {
      best = Hit{dist, pxw, pyw, pzw, nx, ny, nz, qx, qy, qz, g, outside};
      if constexpr (kTexAny && !kShadow) set_tex(best, tu, tv, -1);
    }
  }
  if constexpr (kMesh && !kLinear) {
    for (int e = 0; e < mesh.n_meta; ++e) {
      const int* me = mesh.meta + e * kMetaCols;
      const int g = me[0], n_nodes = me[2];
      const float4* nodes = mesh.nodes + 4ll * me[1];
      const float4* tri = mesh.tri + static_cast<long long>(kTriF4) * me[3];
      const float* m = gmat + g * kGeomCols;
      float gox = ox, goy = oy, goz = oz;
      if constexpr (kMotion) {
        gox = ox - time * m[33];
        goy = oy - time * m[34];
        goz = oz - time * m[35];
      }
      const float rox = m[12] * gox + m[13] * goy + m[14] * goz + m[15];
      const float roy = m[16] * gox + m[17] * goy + m[18] * goz + m[19];
      const float roz = m[20] * gox + m[21] * goy + m[22] * goz + m[23];
      float rdx = m[12] * dx + m[13] * dy + m[14] * dz;
      float rdy = m[16] * dx + m[17] * dy + m[18] * dz;
      float rdz = m[20] * dx + m[21] * dy + m[22] * dz;
      normalize3(rdx, rdy, rdz);
      const float irdx = 1.f / rdx, irdy = 1.f / rdy, irdz = 1.f / rdz;
      // exact object-space pruning bound from the winner so far: dist =
      // (t - RAY_OFFSET) * |L rd| with L the linear part of the forward
      // transform, so t_bound = dist / |L rd| + RAY_OFFSET (+ slack)
      const float wdx = m[0] * rdx + m[1] * rdy + m[2] * rdz;
      const float wdy = m[4] * rdx + m[5] * rdy + m[6] * rdz;
      const float wdz = m[8] * rdx + m[9] * rdy + m[10] * rdz;
      const float s_ray = sqrtf(wdx * wdx + wdy * wdy + wdz * wdz);
      float t_loc = best.dist / fmaxf(s_ray, 1e-20f) * kBoundSlack + kRayOffset + 1e-4f;
      // the walk: enter a node whose box the ray meets before t_loc, else
      // take its skip link; in a leaf, a nearer hit becomes the winner
      int win = -1;
      for (int n = 0; n < n_nodes;) {
        const float4 na = __ldg(nodes + 4 * n);      // min xyz, max x
        const float4 nb = __ldg(nodes + 4 * n + 1);  // max yz, skip, start
        const float4 nc = __ldg(nodes + 4 * n + 2);  // count
        float tax, tbx, tay, tby, taz, tbz;
        slab(na.x, na.w, rox, irdx, tax, tbx);
        slab(na.y, nb.x, roy, irdy, tay, tby);
        slab(na.z, nb.y, roz, irdz, taz, tbz);
        const float tnear = fmaxf(fmaxf(tax, tay), fmaxf(taz, 0.f));
        const float tfar = fminf(fminf(tbx, tby), tbz);
        const bool box_hit = tnear <= tfar && tnear < t_loc;
        // float-coded integers, truncated as the reference's astype
        const int count = static_cast<int>(nc.x);
        if (box_hit && count > 0) {
          const int start = static_cast<int>(nb.w);
          for (int k = start; k < start + count; ++k) {
            float tt;
            if (tri_test(rox, roy, roz, rdx, rdy, rdz, tri + kTriF4 * k, tt) && tt < t_loc) {
              t_loc = tt;
              win = k;
            }
          }
        }
        n = (count > 0 || !box_hit) ? static_cast<int>(nb.z) : n + 1;
      }
      if (win < 0) continue;
      // the shading fold, once, on the winner
      float tt;
      [[maybe_unused]] float bu, bv;
      if constexpr (kTexAny) {
        if (!tri_test<true>(rox, roy, roz, rdx, rdy, rdz, tri + kTriF4 * win, tt, &bu, &bv))
          continue;
      } else {
        if (!tri_test(rox, roy, roz, rdx, rdy, rdz, tri + kTriF4 * win, tt)) continue;
      }
      const float tofs = tt - kRayOffset;
      const float qx = rox + tofs * rdx;
      const float qy = roy + tofs * rdy;
      const float qz = roz + tofs * rdz;
      float nx = 0.f, ny = 0.f, nz = 0.f;
      bool outside = false;
      if constexpr (!kShadow) {
        // the ray-facing geometric normal through invT
        const float4 c = __ldg(tri + kTriF4 * win + 2);  // e2z, n_obj
        const float face = rdx * c.y + rdy * c.z + rdz * c.w;
        const float flip = face < 0.f ? 1.f : -1.f;
        nx = (m[24] * c.y + m[25] * c.z + m[26] * c.w) * flip;
        ny = (m[27] * c.y + m[28] * c.z + m[29] * c.w) * flip;
        nz = (m[30] * c.y + m[31] * c.z + m[32] * c.w) * flip;
        normalize3(nx, ny, nz);
        outside = face < 0.f;
      }
      float pxw = m[0] * qx + m[1] * qy + m[2] * qz + m[3];
      float pyw = m[4] * qx + m[5] * qy + m[6] * qz + m[7];
      float pzw = m[8] * qx + m[9] * qy + m[10] * qz + m[11];
      const float ddx = gox - pxw, ddy = goy - pyw, ddz = goz - pzw;
      if constexpr (kMotion) {
        pxw = pxw + time * m[33];
        pyw = pyw + time * m[34];
        pzw = pzw + time * m[35];
      }
      const float dist = sqrtf(ddx * ddx + ddy * ddy + ddz * ddz);
      if (dist < best.dist) {
        best = Hit{dist, pxw, pyw, pzw, nx, ny, nz, qx, qy, qz, g, outside};
        if constexpr (kTexAny && !kShadow) {
          // the vt corners, interpolated at the hit
          const float4 d = __ldg(tri + kTriF4 * win + 3);  // u0 v0 u1 v1
          const float4 e = __ldg(tri + kTriF4 * win + 4);  // u2 v2, grad_u xy
          const float bw = 1.f - bu - bv;
          set_tex(best, bw * d.x + bu * d.z + bv * e.x, bw * d.y + bu * d.w + bv * e.y,
                  me[3] + win);
        }
#if PT_VJP
        best.row = me[3] + win;  // K8 carries the winner to the reverse sweep
#endif
      }
    }
  }
  if constexpr (kLinear) {
    // K3-linear (the reference's `tri_body`, a mesh without a BVH): every
    // triangle in index order is a candidate of the world-space fold,
    // after the primitives, with the strict `<`.  A meta entry is a run of
    // triangles of one geom (geom, 0, 0, tri_off, n_tris): the object ray
    // is made once a run.  The loop keeps the winner's row and run; its
    // shading runs once, afterwards, with the arithmetic of the loop's
    // test, as in K3.  The reference's linear fold leaves a mesh's BUMPTEX
    // inert; pack_mesh writes zero UV gradients in this form, so the
    // texture builds tilt no normal here either.
    int win = -1, win_e = 0;
    float win_dist = best.dist;
    for (int e = 0; e < mesh.n_meta; ++e) {
      const int* me = mesh.meta + e * kMetaCols;
      const float* m = gmat + me[0] * kGeomCols;
      float gox = ox, goy = oy, goz = oz;
      if constexpr (kMotion) {
        gox = ox - time * m[33];
        goy = oy - time * m[34];
        goz = oz - time * m[35];
      }
      const float rox = m[12] * gox + m[13] * goy + m[14] * goz + m[15];
      const float roy = m[16] * gox + m[17] * goy + m[18] * goz + m[19];
      const float roz = m[20] * gox + m[21] * goy + m[22] * goz + m[23];
      float rdx = m[12] * dx + m[13] * dy + m[14] * dz;
      float rdy = m[16] * dx + m[17] * dy + m[18] * dz;
      float rdz = m[20] * dx + m[21] * dy + m[22] * dz;
      normalize3(rdx, rdy, rdz);
      for (int k = me[3]; k < me[3] + me[4]; ++k) {
        float tt;
        if (!tri_test(rox, roy, roz, rdx, rdy, rdz, mesh.tri + kTriF4 * k, tt)) continue;
        const float tofs = tt - kRayOffset;
        const float qx = rox + tofs * rdx;
        const float qy = roy + tofs * rdy;
        const float qz = roz + tofs * rdz;
        const float ddx = gox - (m[0] * qx + m[1] * qy + m[2] * qz + m[3]);
        const float ddy = goy - (m[4] * qx + m[5] * qy + m[6] * qz + m[7]);
        const float ddz = goz - (m[8] * qx + m[9] * qy + m[10] * qz + m[11]);
        const float dist = sqrtf(ddx * ddx + ddy * ddy + ddz * ddz);
        if (dist < win_dist) {
          win_dist = dist;
          win = k;
          win_e = e;
        }
      }
    }
    if (win >= 0) {
      // the shading fold, once, on the winner
      const int g = mesh.meta[win_e * kMetaCols];
      best = tri_hit<kShadow>(gmat + g * kGeomCols, g, mesh.tri + kTriF4 * win, win, ox, oy, oz,
                              dx, dy, dz, time);
    }
  }
  return best;
}

// Procedural bump (BUMP): tilt the shading normal by the analytic gradient
// of h = sin(w qx) sin(w qy) sin(w qz), through the geom's inverse-transpose
// t (9 floats); for strength bk > 0.
__device__ __forceinline__ void bump_perturb(float& nx, float& ny, float& nz,
                                             float qx, float qy, float qz,
                                             float bs, float bk,
                                             const float* t) {
  const float w = bs * kTwoPi;
  const float ph = 0.5f;  // phase: non-degenerate on cube faces
  const float sx = sinf(w * qx + ph), cx = cosf(w * qx + ph);
  const float sy = sinf(w * qy + ph), cy = cosf(w * qy + ph);
  const float sz = sinf(w * qz + ph), cz = cosf(w * qz + ph);
  const float gx_o = w * cx * sy * sz;
  const float gy_o = w * sx * cy * sz;
  const float gz_o = w * sx * sy * cz;
  const float gx = t[0] * gx_o + t[1] * gy_o + t[2] * gz_o;
  const float gy = t[3] * gx_o + t[4] * gy_o + t[5] * gz_o;
  const float gz = t[6] * gx_o + t[7] * gy_o + t[8] * gz_o;
  const float gdn = gx * nx + gy * ny + gz * nz;
  float px = nx - bk * (gx - gdn * nx);
  float py = ny - bk * (gy - gdn * ny);
  float pz = nz - bk * (gz - gdn * nz);
  normalize3(px, py, pz);
  nx = px;
  ny = py;
  nz = pz;
}

// K4.  The reference's degree-11 odd minimax atan on [0, 1] (`_atan_poly`):
// its float32 coefficients (rounded from the same doubles), its Horner order.
__device__ __forceinline__ float atan_poly(float t) {
  constexpr float c0 = static_cast<float>(0.9999993329);
  constexpr float c1 = static_cast<float>(-0.3332985605);
  constexpr float c2 = static_cast<float>(0.1994653599);
  constexpr float c3 = static_cast<float>(-0.1390853351);
  constexpr float c4 = static_cast<float>(0.0964200441);
  constexpr float c5 = static_cast<float>(-0.0559098861);
  constexpr float c6 = static_cast<float>(0.0218612288);
  constexpr float c7 = static_cast<float>(-0.0040540580);
  const float t2 = t * t;
  return t * (c0 + t2 * (c1 + t2 * (c2 + t2 * (c3 + t2 * (c4 + t2 * (c5 + t2 * (c6 + t2 * c7)))))));
}

// atan2 by the polynomial and quadrant selects (`_atan2`), never libm's: the
// sphere chart's boundary texels depend on its bits.
__device__ __forceinline__ float atan2_poly(float y, float x) {
  const float ax = fabsf(x), ay = fabsf(y);
  const float hi = fmaxf(ax, ay), lo = fminf(ax, ay);
  float r = atan_poly(lo / fmaxf(hi, static_cast<float>(1e-30)));
  if (ay > ax) r = kHalfPi - r;
  if (x < 0.f) r = kPi - r;
  return y < 0.f ? -r : r;
}

// The unit sphere's chart at object-space point q (`_one_sphere`'s UV).
__device__ __forceinline__ void sphere_uv(float qx, float qy, float qz, float& u, float& v) {
  u = 0.5f + atan2_poly(qz, qx) * kInvTwoPi;
  const float t = fminf(fmaxf(2.f * qy, -1.f), 1.f);
  v = 0.5f + atan2_poly(t, sqrtf(fmaxf(1.f - t * t, 0.f))) * kInvPi;  // asin
}

// A floored texel coordinate as an int: held inside +-2^24 first, so that a
// wild UV never meets an out-of-range float-to-int cast.
__device__ __forceinline__ int tap(float x0f) {
  return static_cast<int>(fminf(fmaxf(x0f, -16777216.f), 16777216.f));
}

// a mod w with the sign of w (jnp.mod), for w > 0
__device__ __forceinline__ int wrap(int a, int w) {
  const int r = a % w;
  return r < 0 ? r + w : r;
}

// Channel c of a texel word, as the loader's float32: byte / 255.
__device__ __forceinline__ float texel(uint32_t w, int c) {
  return static_cast<float>((w >> (8 * c)) & 255u) / 255.f;
}

// Bilinear rgb sample of the map (offset off, th rows, tw columns) at (u, v)
// (`_bilin3`): repeat wrap of each tap, then the filter; texel centres at
// integer + 0.5.
__device__ __forceinline__ void bilin3(const uint32_t* texels, int off, int th, int tw,
                                       float u, float v, float out[3]) {
  const float x = u * static_cast<float>(tw) - 0.5f;
  const float y = v * static_cast<float>(th) - 0.5f;
  const float x0f = floorf(x), y0f = floorf(y);
  const float fx = x - x0f, fy = y - y0f;
  const int wi = max(tw, 1), hi = max(th, 1);
  const int x0 = wrap(tap(x0f), wi), x1 = wrap(x0 + 1, wi);
  const int y0 = wrap(tap(y0f), hi), y1 = wrap(y0 + 1, hi);
  const uint32_t w00 = __ldg(texels + off + y0 * wi + x0);
  const uint32_t w01 = __ldg(texels + off + y0 * wi + x1);
  const uint32_t w10 = __ldg(texels + off + y1 * wi + x0);
  const uint32_t w11 = __ldg(texels + off + y1 * wi + x1);
#pragma unroll
  for (int c = 0; c < 3; ++c) {
    const float top = texel(w00, c) * (1.f - fx) + texel(w01, c) * fx;
    const float bot = texel(w10, c) * (1.f - fx) + texel(w11, c) * fx;
    out[c] = top * (1.f - fy) + bot * fy;
  }
}

// The height map's luminance at (u, v): (r + g + b) / 3 (`_lum`).
__device__ __forceinline__ float luminance(const uint32_t* texels, const int* ch, float u,
                                           float v) {
  float s[3];
  bilin3(texels, ch[0], ch[1], ch[2], u, v, s);
  return (s[0] + s[1] + s[2]) * kThird;
}

// K4 at the winner of a hit (kind: its geom type; ch: its kChartCols chart
// ints; bk: its BUMPTEX strength; tinv: its inverse-transpose): the albedo
// map multiplies the albedo, except on a checker's odd cells; then BUMPTEX
// tilts the (already bumped) shading normal: central differences of the
// luminance in (u, v), chained through the chart's object-space gradients
// (sphere; cube face by the dominant |q| axis, the first of equal ones; a
// triangle's carried (grad_u, grad_v)) and tinv, projected tangentially.
template <typename A, typename H, typename X, typename M>
__device__ __forceinline__ void tex_section(A& albedo, float& nx, float& ny, float& nz,
                                            const H& h, int kind, const int* ch, float bk,
                                            const float* tinv, bool odd, const X tex,
                                            const M mesh) {
  if constexpr (kTexAny) {
    const bool a_on = kTex && ch[0] >= 0 && !odd;
    const bool b_on = kBtex && ch[3] >= 0 && bk > 0.f;
    if (!a_on && !b_on) return;
    float u = h.u, v = h.v;
    if (kind == kSphere) sphere_uv(h.qx, h.qy, h.qz, u, v);
    if (a_on) {
      float s[3];
      bilin3(tex.texels, ch[0], ch[1], ch[2], u, v, s);
#pragma unroll
      for (int c = 0; c < 3; ++c) albedo.c[c] = albedo.c[c] * s[c];
    }
    if (!b_on) return;
    const float eu = 1.f / fmaxf(static_cast<float>(ch[5]), 1.f);
    const float ev = 1.f / fmaxf(static_cast<float>(ch[4]), 1.f);
    const float hu = (luminance(tex.texels, ch + 3, u + eu, v) -
                      luminance(tex.texels, ch + 3, u + -eu, v)) / (2.f * eu);
    const float hv = (luminance(tex.texels, ch + 3, u, v + ev) -
                      luminance(tex.texels, ch + 3, u, v + -ev)) / (2.f * ev);
    const float qx = h.qx, qy = h.qy, qz = h.qz;
    float gux, guy = 0.f, guz, gvx = 0.f, gvy, gvz;
    if (kind == kSphere) {
      const float r2s = fmaxf(qx * qx + qz * qz, static_cast<float>(1e-12));
      const float inv2pir2 = 1.f / (kTwoPi * r2s);
      const float den = sqrtf(fmaxf(1.f - 4.f * qy * qy, static_cast<float>(1e-12)));
      gux = -qz * inv2pir2;
      guz = qx * inv2pir2;
      gvy = 2.f / (kPi * den);
      gvz = 0.f;
    } else if (kMesh && kind == kMeshType) {
      if constexpr (kMesh) {
        const float4* r = mesh.tri + static_cast<long long>(kTriF4) * h.row;
        const float4 e = __ldg(r + 4), f = __ldg(r + 5);
        gux = e.z;
        guy = e.w;
        guz = f.x;
        gvx = f.y;
        gvy = f.z;
        gvz = f.w;
      }
    } else {
      const float aqx = fabsf(qx), aqy = fabsf(qy), aqz = fabsf(qz);
      const bool ax0 = aqx >= aqy && aqx >= aqz;
      const bool ax1 = !ax0 && aqy >= aqz;
      gux = ax0 ? 0.f : 1.f;
      guz = ax0 ? 1.f : 0.f;
      gvy = ax1 ? 0.f : 1.f;
      gvz = ax1 ? 1.f : 0.f;
    }
    const float gox = hu * gux + hv * gvx;
    const float goy = hu * guy + hv * gvy;
    const float goz = hu * guz + hv * gvz;
    const float gwx = tinv[0] * gox + tinv[1] * goy + tinv[2] * goz;
    const float gwy = tinv[3] * gox + tinv[4] * goy + tinv[5] * goz;
    const float gwz = tinv[6] * gox + tinv[7] * goy + tinv[8] * goz;
    const float gdn = gwx * nx + gwy * ny + gwz * nz;
    const float pxn = nx - bk * (gwx - gdn * nx);
    const float pyn = ny - bk * (gwy - gdn * ny);
    const float pzn = nz - bk * (gwz - gdn * nz);
    const float len2 = pxn * pxn + pyn * pyn + pzn * pzn;
    const float nrm = sqrtf(len2 > 0.f ? len2 : 1.f);
    nx = pxn / nrm;
    ny = pyn / nrm;
    nz = pzn / nrm;
  }
}

// Power-cosine sample about the mirror direction mr (GPU Gems 3 ch. 20),
// exponent m_ex > 0, written over mr.
__device__ __forceinline__ void imperfect_specular(float m_ex, float& mrx,
                                                   float& mry, float& mrz,
                                                   float u_s1, float u_s2) {
  const float n1 = 1.f / (m_ex + 1.f);
  const float cos_t = powf(fmaxf(u_s1, 1e-12f), n1);
  const float sin_t = sqrtf(fmaxf(1.f - cos_t * cos_t, 0.f));
  const float phi = u_s2 * kTwoPi;
  const bool use_x = fabsf(mrx) < kSqrtThird;
  const bool use_y = !use_x && fabsf(mry) < kSqrtThird;
  const float nm_x = use_x ? 1.f : 0.f;
  const float nm_y = use_y ? 1.f : 0.f;
  const float nm_z = (use_x || use_y) ? 0.f : 1.f;
  float q1x = mry * nm_z - mrz * nm_y;
  float q1y = mrz * nm_x - mrx * nm_z;
  float q1z = mrx * nm_y - mry * nm_x;
  normalize3(q1x, q1y, q1z);
  float q2x = mry * q1z - mrz * q1y;
  float q2y = mrz * q1x - mrx * q1z;
  float q2z = mrx * q1y - mry * q1x;
  normalize3(q2x, q2y, q2z);
  const float cp = cosf(phi), sp = sinf(phi);
  const float ix = cos_t * mrx + cp * sin_t * q1x + sp * sin_t * q2x;
  const float iy = cos_t * mry + cp * sin_t * q1y + sp * sin_t * q2y;
  const float iz = cos_t * mrz + cp * sin_t * q1z + sp * sin_t * q2z;
  mrx = ix;
  mry = iy;
  mrz = iz;
}

// K2, next-event estimation at hit h (shading normal n, albedo al): per
// light one area sample and one shadow ray; where the sample is seen, the
// albedo/pi lobe's direct light is added to the radiance r.  Light rows
// (pack_lights): 0 geom | 1 type | 2-4 emission | cube: 5 area, 6-11 face
// cdf, 12-29 origins, 30-47 e_b, 48-65 e_c, 66-83 normals | sphere: 12-20
// forward 3x3, 21-23 center, 24-32 invT 3x3, 33 |det| | 120-122 velocity.
template <typename M, typename A>
__device__ __forceinline__ void nee_add(
    float& rr, float& rg, float& rb, float tr, float tg, float tb,
    const Hit& h, float nx, float ny, float nz, const A al, float time,
    uint32_t it, uint32_t pix, uint32_t dep, const float* lights,
    int n_lights, const float* gmat, const int* types, int n_geoms,
    const M mesh
#if PT_VJP
    , unsigned long long& vis  // K8: bit k set where light k's sample is seen
#endif
    ) {
  for (int k = 0; k < n_lights; ++k) {
    const float* lr = lights + k * kLightCols;
    const uint32_t base = pt::kDrawNeeBase + 3u * static_cast<uint32_t>(k);
    const float u_sel = pt::uniform(it, pix, dep, base);
    const float u1 = pt::uniform(it, pix, dep, base + 1u);
    const float u2 = pt::uniform(it, pix, dep, base + 2u);
    float lpx, lpy, lpz, lnx, lny, lnz, w_area;
    if (lr[1] == static_cast<float>(kSphere)) {
      // uniform direction on the unit sphere -> forward transform; the
      // area weight pi |det M| |M^-T w| is exact for any transform
      const float z = 1.f - 2.f * u1;
      const float r = sqrtf(fmaxf(1.f - z * z, 0.f));
      const float phi = u2 * kTwoPi;
      const float wx = r * cosf(phi), wy = r * sinf(phi), wz = z;
      const float hx = 0.5f * wx, hy = 0.5f * wy, hz = 0.5f * wz;
      lpx = lr[12] * hx + lr[13] * hy + lr[14] * hz + lr[21];
      lpy = lr[15] * hx + lr[16] * hy + lr[17] * hz + lr[22];
      lpz = lr[18] * hx + lr[19] * hy + lr[20] * hz + lr[23];
      lnx = lr[24] * wx + lr[25] * wy + lr[26] * wz;
      lny = lr[27] * wx + lr[28] * wy + lr[29] * wz;
      lnz = lr[30] * wx + lr[31] * wy + lr[32] * wz;
      const float n_len = sqrtf(lnx * lnx + lny * lny + lnz * lnz);
      w_area = kPi * lr[33] * n_len;
      const float inv_nl = 1.f / n_len;
      lnx *= inv_nl;
      lny *= inv_nl;
      lnz *= inv_nl;
    } else {
      // cube (and, as in the reference, any light that is not a sphere):
      // face f covers [cdf[f-1], cdf[f]) of u_sel, the last face the rest;
      // then (s, t) on its parallelogram
      int f = 0;
      while (f < 5 && !(u_sel < lr[6 + f])) ++f;
      const float ss = u1 - 0.5f, tt = u2 - 0.5f;
      const float* fo = lr + 12 + 3 * f;
      const float* eb = lr + 30 + 3 * f;
      const float* ec = lr + 48 + 3 * f;
      const float* fn = lr + 66 + 3 * f;
      lpx = fo[0] + ss * eb[0] + tt * ec[0];
      lpy = fo[1] + ss * eb[1] + tt * ec[1];
      lpz = fo[2] + ss * eb[2] + tt * ec[2];
      lnx = fn[0];
      lny = fn[1];
      lnz = fn[2];
      w_area = lr[5];
    }
    if constexpr (kMotion) {
      // a moving light: the sample point at the ray's time
      lpx = lpx + time * lr[120];
      lpy = lpy + time * lr[121];
      lpz = lpz + time * lr[122];
    }
    const float wlx = lpx - h.px, wly = lpy - h.py, wlz = lpz - h.pz;
    const float r2 = wlx * wlx + wly * wly + wlz * wlz;
    const float r2_safe = fmaxf(r2, 1e-8f);
    const float dist_l = sqrtf(fmaxf(r2, 1e-12f));
    const float inv_dl = 1.f / dist_l;
    const float sdx = wlx * inv_dl, sdy = wly * inv_dl, sdz = wlz * inv_dl;
    const Hit sh = nearest<true>(h.px, h.py, h.pz, sdx, sdy, sdz, time, gmat,
                                 types, n_geoms, mesh);
    // seen: the nearest hit along the shadow ray is the light, at the
    // sampled distance
    const float tol = fmaxf(1e-3f, 5e-3f * dist_l);
    if (sh.geom != static_cast<int>(lr[0]) || !(fabsf(sh.dist - dist_l) < tol))
      continue;
#if PT_VJP
    vis |= 1ull << k;
#endif
    const float cos_s = fmaxf(nx * sdx + ny * sdy + nz * sdz, 0.f);
    const float cos_l = fmaxf(-(lnx * sdx + lny * sdy + lnz * sdz), 0.f);
    const float gterm = cos_s * cos_l / r2_safe * w_area;
    // (1/pi) * emission is one product, as XLA folds the reference's
    rr = rr + tr * al[0] * (kInvPi * lr[2]) * gterm;
    rg = rg + tg * al[1] * (kInvPi * lr[3]) * gterm;
    rb = rb + tb * al[2] * (kInvPi * lr[4]) * gterm;
  }
}

// The state a path carries from one bounce to the next: the reference's
// `init_state` planes (`_state_keys`), which K5 keeps in global memory
// between its spans and K1 in registers.
struct PathState {
  float ox, oy, oz, dx, dy, dz;
  float tr, tg, tb;  // throughput
  float rr, rg, rb;  // radiance gathered so far
  bool live;
  float time;  // shutter time (motion blur)
  // SSS: the medium the path is in (sigma 0: none) and its albedo
  float med_s, med_r, med_g, med_b;
  // NEE: emission found by the BSDF counts only after a non-diffuse
  // bounce (or from the camera), so direct light is not counted twice
  bool emit_ok;
#if PT_GRAD
  // K7: the factor each bounce multiplied into the path, as geom << 3 |
  // kind (grad_fold); at most one a bounce
  int n_ev;
  uint32_t ev[64];
#endif
#if PT_VJP
  // K8: what the last bounce's forward found, which the reverse sweep takes
  // as it is: the winning geom (-1: none) and, in the mesh builds, its
  // triangle row (-1: not a triangle); with NEE, the lights whose samples
  // its shadow rays saw (bit k: light k)
  int win_geom, win_row;
  unsigned long long nee_vis;
#endif
};

// The camera row (pack_scene's cam) but aperture and focal distance, which
// the thin lens reads from the staged row itself.
struct Camera {
  float pos_x, pos_y, pos_z, v_x, v_y, v_z, r_x, r_y, r_z, u_x, u_y, u_z, tan_x, tan_y;
};

__device__ __forceinline__ Camera load_camera(const float* s_cam) {
  return Camera{s_cam[0], s_cam[1], s_cam[2],  s_cam[3],  s_cam[4],  s_cam[5],  s_cam[6],
                s_cam[7], s_cam[8], s_cam[9], s_cam[10], s_cam[11], s_cam[12], s_cam[13]};
}

// The scene tables staged in shared memory, as the bounce reads them.
struct Tables {
  const float* cam;
  const float* mats;
  const float* gmat;
  const float* lights;
  const int* types;
  const int* meta;
  const int* charts;
  int n_geoms;
  int n_lights;
};

// Stages the tables in shared memory behind kWarps * n_bounces per-warp
// live counts, which it zeroes: cam, mats, gmat, lights (NEE), types, mesh
// meta (meshes), texture charts (textures).  The caller synchronizes.
__device__ __forceinline__ Tables stage_tables(
    unsigned long long* smem, int n_bounces, const float* __restrict__ cam_g,
    const float* __restrict__ mats_g, const float* __restrict__ gmat_g,
    const int* __restrict__ types_g, const float* __restrict__ lights_g,
    const int* __restrict__ meta_g, const int* __restrict__ charts_g, int n_geoms,
    int n_lights, int n_meta) {
  float* s_cam = reinterpret_cast<float*>(smem + kWarps * n_bounces);
  float* s_mats = s_cam + kCamCols;
  float* s_gmat = s_mats + n_geoms * kMatCols;
  float* s_lights = s_gmat + n_geoms * kGeomCols;
  int* s_types = reinterpret_cast<int*>(s_lights + (kNee ? n_lights * kLightCols : 0));
  for (int i = threadIdx.x; i < kCamCols; i += kBlock) s_cam[i] = cam_g[i];
  for (int i = threadIdx.x; i < n_geoms * kMatCols; i += kBlock) s_mats[i] = mats_g[i];
  for (int i = threadIdx.x; i < n_geoms * kGeomCols; i += kBlock) s_gmat[i] = gmat_g[i];
  if constexpr (kNee) {
    for (int i = threadIdx.x; i < n_lights * kLightCols; i += kBlock) s_lights[i] = lights_g[i];
  }
  for (int i = threadIdx.x; i < n_geoms; i += kBlock) s_types[i] = types_g[i];
  int* s_meta = s_types + n_geoms;
  if constexpr (kMesh) {
    for (int i = threadIdx.x; i < n_meta * kMetaCols; i += kBlock) s_meta[i] = meta_g[i];
  }
  int* s_charts = s_meta + n_meta * kMetaCols;
  if constexpr (kTexAny) {
    for (int i = threadIdx.x; i < n_geoms * kChartCols; i += kBlock) s_charts[i] = charts_g[i];
  }
  for (int i = threadIdx.x; i < kWarps * n_bounces; i += kBlock) smem[i] = 0ull;
  return Tables{s_cam, s_mats, s_gmat, s_lights, s_types, s_meta, s_charts, n_geoms, n_lights};
}

// K1's live counts, kept per block in shared memory as 32-bit words (one
// a bounce; per sample, one a sample and a bounce of a chunk of samples)
// and added into the 64-bit global counts once the block has run the
// chunk.  A chunk is as many samples as those words can count: per sample
// at most kK1CountWords words, summed at most 2^20 samples (a block's 2^11
// pixels at most, so a word stays under 2^32).
constexpr int kK1CountWords = 512;
__host__ __device__ constexpr int k1_count_chunk(bool per_sample, int n_spp, int depth) {
  return !per_sample      ? (n_spp < (1 << 20) ? (n_spp < 1 ? 1 : n_spp) : (1 << 20))
         : n_spp < 1      ? 1
         : n_spp * depth <= kK1CountWords ? n_spp
         : kK1CountWords / depth > 0     ? kK1CountWords / depth
                                         : 1;
}
__host__ __device__ constexpr int k1_count_rows(bool per_sample, int chunk, int depth) {
  return per_sample ? chunk * depth : depth;
}
// The 64-bit per-warp slots of stage_tables that hold the count words and,
// after them, the pool's taken word.
__host__ __device__ constexpr int k1_count_slots(int rows) {
  return (rows + 1 + 2 * kWarps - 1) / (2 * kWarps);
}

// K1's pixel pool: a block takes kBlock * lane_px neighbouring pixels, the
// host's choice from the blocks the card keeps resident: as many as
// kLanePxMax a lane while the grid still fills the card once (more pixels a
// lane leave SMs idle; fewer leave each lane's last pixel a longer tail).
// A BVH walk's cost varies more from pixel to pixel, so the mesh builds
// keep more, shorter blocks (measured: PERF.md section 5).
constexpr int kLanePxMax = kMesh ? 4 : 8;
inline int k1_lane_pixels(long long n_local, long long resident) {
  const long long k = n_local / (static_cast<long long>(kBlock) * (resident > 0 ? resident : 1));
  return static_cast<int>(k < 1 ? 1 : k > kLanePxMax ? kLanePxMax : k);
}

// The shared memory stage_tables takes.
inline size_t tables_smem(int n_bounces, int n_geoms, int n_lights, int n_meta) {
  return sizeof(unsigned long long) * kWarps * n_bounces +
         sizeof(float) * (kCamCols + n_geoms * (kMatCols + kGeomCols) + n_lights * kLightCols) +
         sizeof(int) * (n_geoms + n_meta * kMetaCols + (kTexAny ? n_geoms * kChartCols : 0));
}

// Raygen with antialias jitter, then the thin lens: the state of pixel
// (fx, fy) entering bounce 0 of iteration `it` (the reference's
// `init_state`); a lane past the image (!valid) starts dead.
__device__ __forceinline__ void init_state(PathState& p, const Camera& c, const float* s_cam,
                                           uint32_t it, uint32_t pix_u, float fx, float fy,
                                           float sx_scale, float sy_scale, bool valid) {
  const float ujx = pt::uniform(it, pix_u, 0u, pt::kDrawAaX);
  const float ujy = pt::uniform(it, pix_u, 0u, pt::kDrawAaY);
  const float sx = (fx + ujx) * sx_scale - 1.f;
  const float sy = (fy + ujy) * sy_scale - 1.f;
  float dx = c.v_x - c.r_x * (c.tan_x * sx) - c.u_x * (c.tan_y * sy);
  float dy = c.v_y - c.r_y * (c.tan_x * sx) - c.u_y * (c.tan_y * sy);
  float dz = c.v_z - c.r_z * (c.tan_x * sx) - c.u_z * (c.tan_y * sy);
  normalize3(dx, dy, dz);
  float ox = c.pos_x, oy = c.pos_y, oz = c.pos_z;
  if constexpr (kDof) {
    // thin lens: origin on the aperture, through the focal plane
    const float aperture = s_cam[14], focal = s_cam[15];
    if (aperture > 0.f) {
      const float u1 = pt::uniform(it, pix_u, 0u, pt::kDrawDofU);
      const float u2 = pt::uniform(it, pix_u, 0u, pt::kDrawDofV);
      const float r_lens = aperture * sqrtf(u1);
      const float theta = u2 * kTwoPi;
      const float lc = r_lens * cosf(theta), ls = r_lens * sinf(theta);
      const float off_x = c.r_x * lc + c.u_x * ls;
      const float off_y = c.r_y * lc + c.u_y * ls;
      const float off_z = c.r_z * lc + c.u_z * ls;
      const float cos_v = dx * c.v_x + dy * c.v_y + dz * c.v_z;
      const float ft = focal / fmaxf(cos_v, 1e-6f);
      const float pfx = ox + dx * ft, pfy = oy + dy * ft, pfz = oz + dz * ft;
      ox = ox + off_x;
      oy = oy + off_y;
      oz = oz + off_z;
      dx = pfx - ox;
      dy = pfy - oy;
      dz = pfz - oz;
      normalize3(dx, dy, dz);
    }
  }
  p.ox = ox;
  p.oy = oy;
  p.oz = oz;
  p.dx = dx;
  p.dy = dy;
  p.dz = dz;
  p.tr = p.tg = p.tb = 1.f;
  p.rr = p.rg = p.rb = 0.f;
  p.live = valid;
  p.time = 0.f;
  if constexpr (kMotion) p.time = pt::uniform(it, pix_u, 0u, pt::kDrawTime);
  p.med_s = 0.f;
  p.med_r = p.med_g = p.med_b = 1.f;
  p.emit_ok = true;
#if PT_GRAD
  p.n_ev = 0;
#endif
}

// Bounce d of a path (the reference's `_make_tracer.bounce`): nearest hit,
// surface, emission, scatter, NEE, the medium and Russian roulette, on the
// state p.  A dead path returns at once; a path that ends is marked dead.
// K1's depth loop and K5's span run this one body.
template <typename M, typename X>
__device__ __forceinline__ void bounce(PathState& p, int d, uint32_t it, uint32_t pix_u,
                                       const Tables& s, const M mesh, const X tex) {
  if (!p.live) return;
  const Hit h = nearest<false>(p.ox, p.oy, p.oz, p.dx, p.dy, p.dz, p.time, s.gmat, s.types,
                               s.n_geoms, mesh);
#if PT_VJP
  p.win_geom = h.geom;
  if constexpr (kMesh) p.win_row = h.row;
  if constexpr (kNee) p.nee_vis = 0ull;
#endif
  if (h.geom < 0) {  // miss: the path ends
    p.live = false;
    return;
  }
  const float* mt = s.mats + h.geom * kMatCols;
  const float* gm = s.gmat + h.geom * kGeomCols;
  // the winner's albedo (checker, albedo map) and shading normal (bump,
  // BUMPTEX map)
  Albedo albedo = mt;
  float nx = h.nx, ny = h.ny, nz = h.nz;
  [[maybe_unused]] bool odd = false;
  if constexpr (kChecker) {
    const float cs = mt[11];
    const float ph = 0.015625f;
    const float cells = floorf(h.qx * cs - ph) + floorf(h.qy * cs - ph) +
                        floorf(h.qz * cs - ph);
    if (cs > 0.f && cells - 2.f * floorf(cells * 0.5f) >= 1.f) albedo = mt + 12;
    if constexpr (kTexAny) odd = cs > 0.f && cells - 2.f * floorf(cells * 0.5f) >= 1.f;
  }
  if constexpr (kBump) {
    if (mt[16] > 0.f) bump_perturb(nx, ny, nz, h.qx, h.qy, h.qz, mt[15], mt[16], gm + 24);
  }
  if constexpr (kTexAny) {
    tex_section(albedo, nx, ny, nz, h, s.types[h.geom], s.charts + h.geom * kChartCols,
                mt[21], gm + 24, odd, tex, mesh);
  }
  const float emit = mt[10];
  if (emit > 0.f) {  // emissive hit: collect and end
    if (!kNee || p.emit_ok) {
      p.rr = p.rr + p.tr * albedo[0] * emit;
      p.rg = p.rg + p.tg * albedo[1] * emit;
      p.rb = p.rb + p.tb * albedo[2] * emit;
#if PT_GRAD
      p.ev[p.n_ev++] = static_cast<uint32_t>(h.geom) << 3 | 2u;  // lit
#endif
    }
    p.live = false;
    return;
  }
  const uint32_t dep = static_cast<uint32_t>(d) + 1u;
  const float dx = p.dx, dy = p.dy, dz = p.dz;
  float ndx, ndy, ndz, thr_r, thr_g, thr_b;
  bool took_diffuse = false, took_refract = false;
  if (kGlass && mt[8] > 0.f) {
    // Fresnel glass: Schlick's choice between the mirror and the Snell
    // refraction (the mirror under total internal reflection); no
    // division by the choice's probability
    const float ndoti = nx * dx + ny * dy + nz * dz;
    const float cos_i = fminf(fmaxf(-ndoti, 0.f), 1.f);
    const float ior = mt[9];
    const float r0b = (1.f - ior) / (1.f + ior);
    const float r0 = r0b * r0b;
    const float mm = fmaxf(1.f - cos_i, 0.f);
    const float refl_p = r0 + (1.f - r0) * mm * mm * mm * mm * mm;
    const float eta = h.outside ? 1.f / fmaxf(ior, 1e-6f) : ior;
    const float kk = 1.f - eta * eta * (1.f - ndoti * ndoti);
    const float u_fr = pt::uniform(it, pix_u, dep, pt::kDrawFresnel);
    if (u_fr < refl_p || !(kk >= 0.f)) {
      ndx = dx - 2.f * ndoti * nx;
      ndy = dy - 2.f * ndoti * ny;
      ndz = dz - 2.f * ndoti * nz;
      thr_r = mt[3];
      thr_g = mt[4];
      thr_b = mt[5];
    } else {
      const float sqk = sqrtf(kk);
      ndx = eta * dx - (eta * ndoti + sqk) * nx;
      ndy = eta * dy - (eta * ndoti + sqk) * ny;
      ndz = eta * dz - (eta * ndoti + sqk) * nz;
      thr_r = albedo[0];
      thr_g = albedo[1];
      thr_b = albedo[2];
      took_refract = true;
    }
  } else {
    const float u_lobe = pt::uniform(it, pix_u, dep, pt::kDrawLobe);
    const float p_spec = fminf(fmaxf(mt[7], 0.f), 1.f);
    const bool take_spec = u_lobe < p_spec;
    const float p_safe = fmaxf(take_spec ? p_spec : 1.f - p_spec, 1e-8f);
    if (take_spec) {  // mirror, or the power-cosine lobe about it
      const float ndoti = nx * dx + ny * dy + nz * dz;
      ndx = dx - 2.f * ndoti * nx;
      ndy = dy - 2.f * ndoti * ny;
      ndz = dz - 2.f * ndoti * nz;
      if constexpr (kImperfect) {
        if (mt[6] > 0.f)
          imperfect_specular(mt[6], ndx, ndy, ndz,
                             pt::uniform(it, pix_u, dep, pt::kDrawSpecU1),
                             pt::uniform(it, pix_u, dep, pt::kDrawSpecU2));
      }
    } else {  // cosine hemisphere with the Peter-Kutz frame
      const float u_d1 = pt::uniform(it, pix_u, dep, pt::kDrawDiffU1);
      const float u_d2 = pt::uniform(it, pix_u, dep, pt::kDrawDiffU2);
      const float up = sqrtf(u_d1);
      const float over = sqrtf(fmaxf(1.f - up * up, 0.f));
      const float around = u_d2 * kTwoPi;
      const bool use_x = fabsf(nx) < kSqrtThird;
      const bool use_y = !use_x && fabsf(ny) < kSqrtThird;
      const float nn_x = use_x ? 1.f : 0.f;
      const float nn_y = use_y ? 1.f : 0.f;
      const float nn_z = (use_x || use_y) ? 0.f : 1.f;
      float p1x = ny * nn_z - nz * nn_y;
      float p1y = nz * nn_x - nx * nn_z;
      float p1z = nx * nn_y - ny * nn_x;
      normalize3(p1x, p1y, p1z);
      float p2x = ny * p1z - nz * p1y;
      float p2y = nz * p1x - nx * p1z;
      float p2z = nx * p1y - ny * p1x;
      normalize3(p2x, p2y, p2z);
      const float ca = cosf(around);
      const float sa = sinf(around);
      ndx = up * nx + ca * over * p1x + sa * over * p2x;
      ndy = up * ny + ca * over * p1y + sa * over * p2y;
      ndz = up * nz + ca * over * p1z + sa * over * p2z;
    }
    lobe_tint(mt + 3, albedo, take_spec, p_safe, thr_r, thr_g, thr_b);
    took_diffuse = !take_spec;
  }
#if PT_GRAD
  // K7: diffuse 0, specular 1, glass reflection 3, refraction 4
  p.ev[p.n_ev++] = static_cast<uint32_t>(h.geom) << 3 |
                   (took_refract ? 4u : kGlass && mt[8] > 0.f ? 3u : took_diffuse ? 0u : 1u);
#endif
  float opx = h.px, opy = h.py, opz = h.pz;
  if (took_refract) {  // past the interface, so as not to hit it again
    opx = opx + gm[36] * ndx;
    opy = opy + gm[36] * ndy;
    opz = opz + gm[36] * ndz;
  }
  // SSS: inside a medium the path samples an exponential free path;
  // ending before the surface, it scatters there
  bool in_med = false, scatter_inside = false;
  float sss_step = 0.f;
  if constexpr (kSss) {
    in_med = p.med_s > 0.f;
    const float u_step = pt::uniform(it, pix_u, dep, pt::kDrawSssStep);
    sss_step = -logf(fmaxf(1.f - u_step, 1e-7f)) / fmaxf(p.med_s, 1e-8f);
    scatter_inside = in_med && sss_step < h.dist;
  }
  if constexpr (kNee) {
    // at every surface hit that is not refractive, whichever lobe was
    // taken (the reference's rule)
    if (!scatter_inside && !(mt[8] > 0.f))
      nee_add(p.rr, p.rg, p.rb, p.tr, p.tg, p.tb, h, nx, ny, nz, albedo, p.time, it, pix_u,
              dep, s.lights, s.n_lights, s.gmat, s.types, s.n_geoms, mesh
#if PT_VJP
              , p.nee_vis
#endif
              );
  }
  if constexpr (kSss) {
    if (scatter_inside) {
      // isotropic, attenuated by the medium's albedo
      const float zi = 1.f - 2.f * pt::uniform(it, pix_u, dep, pt::kDrawSssU);
      const float ri = sqrtf(fmaxf(1.f - zi * zi, 0.f));
      const float phi = pt::uniform(it, pix_u, dep, pt::kDrawSssV) * kTwoPi;
      opx = p.ox + sss_step * dx;
      opy = p.oy + sss_step * dy;
      opz = p.oz + sss_step * dz;
      ndx = ri * cosf(phi);
      ndy = ri * sinf(phi);
      ndz = zi;
      thr_r = p.med_r;
      thr_g = p.med_g;
      thr_b = p.med_b;
    } else if (took_refract) {
      // the medium changes only at refractions: entering a geom with
      // sigma > 0 from outside, or leaving from inside
      if (mt[17] > 0.f && h.outside) {
        p.med_s = mt[17];
        p.med_r = mt[18];
        p.med_g = mt[19];
        p.med_b = mt[20];
      } else if (in_med && !h.outside) {
        p.med_s = 0.f;
        p.med_r = p.med_g = p.med_b = 1.f;
      }
    }
  }
  if constexpr (kRr) {
    // Russian roulette from bounce 3 on, after NEE: survive with the
    // post-bounce throughput's largest channel, boosted by 1/p
    if (d >= 3) {
      const float p_srv =
          fminf(fmaxf(fmaxf(p.tr * thr_r, fmaxf(p.tg * thr_g, p.tb * thr_b)), 0.05f), 1.f);
      if (!(pt::uniform(it, pix_u, dep, pt::kDrawRr) < p_srv)) {
        p.live = false;
        return;
      }
      const float boost = 1.f / p_srv;
      thr_r = thr_r * boost;
      thr_g = thr_g * boost;
      thr_b = thr_b * boost;
    }
  }
  p.tr = p.tr * thr_r;
  p.tg = p.tg * thr_g;
  p.tb = p.tb * thr_b;
  p.ox = opx;
  p.oy = opy;
  p.oz = opz;
  p.dx = ndx;
  p.dy = ndy;
  p.dz = ndz;
  if constexpr (kNee) p.emit_ok = !took_diffuse || scatter_inside;
}

#if !PT_GRAD && !PT_VJP  // K1 and K5: the forward builds only
// kPerSample: the live counts of each sample, counts[sample][d] (the
// reference's (n_iters, depth); pathtrace_batch), else summed over the
// samples, counts[d] (every other caller).
//
// The lane schedule: a lane keeps one path at a time.  When it ends (dead,
// or past the last bounce) the lane adds its radiance to its pixel's sum
// and starts the pixel's next sample at once, in the same step; when the
// pixel has run its samples (of the chunk) the lane writes its sum and
// takes the next pixel of the block's pool.  So a lane idles only once the
// pool is empty, and a warp's step no longer waits for the longest path
// of each sample.  Each pixel's samples are still added in sample order by
// one thread, and every draw is keyed on (iteration, pixel, bounce, draw),
// so the image and the counts are the lockstep loop's, bit for bit.
template <bool kPerSample>
__global__ void __launch_bounds__(kBlock, 7)
k1_trace(const float* __restrict__ cam_g, const float* __restrict__ mats_g,
         const float* __restrict__ gmat_g, const int* __restrict__ types_g,
         const float* __restrict__ lights_g, const float4* __restrict__ tri_g,
         const float4* __restrict__ nodes_g, const int* __restrict__ meta_g,
         const uint32_t* __restrict__ texels_g, const int* __restrict__ charts_g,
         int n_geoms, int n_lights, int n_meta, int width, int height,
         int depth, uint32_t it0, int n_spp, long long pix0,
         long long n_local, int lane_px, float* __restrict__ rad,
         unsigned long long* __restrict__ counts) {
  // shared: the count words (k1_count_rows) and the pool's taken word,
  // then the tables
  extern __shared__ unsigned long long smem[];
  const int chunk = k1_count_chunk(kPerSample, n_spp, depth);
  const int rows = k1_count_rows(kPerSample, chunk, depth);
  const Tables s = stage_tables(smem, k1_count_slots(rows), cam_g, mats_g, gmat_g, types_g,
                                lights_g, meta_g, charts_g, n_geoms, n_lights, n_meta);
  unsigned* s_counts = reinterpret_cast<unsigned*>(smem);
  unsigned* s_taken = s_counts + rows;  // the pool's pixels taken past its first kBlock
  const Mesh mesh(tri_g, nodes_g, s.meta, n_meta);
  const Tex tex(texels_g);
  __syncthreads();

  constexpr unsigned kFull = 0xffffffffu;
  const int lane = threadIdx.x & 31;
  const unsigned below = (1u << lane) - 1u;
  // the pool: local pixels first .. first + pool - 1
  const long long first = static_cast<long long>(blockIdx.x) * kBlock * lane_px;
  const int pool = static_cast<int>(
      min(static_cast<long long>(kBlock) * lane_px, n_local - first));
  const float sx_scale = static_cast<float>(2.0 / width);
  const float sy_scale = static_cast<float>(2.0 / height);
  const Camera cam = load_camera(s.cam);
  if (n_spp == 0) {
    for (int q = threadIdx.x; q < pool; q += kBlock)
      rad[3 * (first + q) + 0] = rad[3 * (first + q) + 1] = rad[3 * (first + q) + 2] = 0.f;
    return;
  }

  for (int c0 = 0; c0 < n_spp; c0 += chunk) {
    const int c1 = min(n_spp, c0 + chunk);
    long long idx = 0;  // the lane's local pixel
    uint32_t pix_u = 0u;
    float fx = 0.f, fy = 0.f, acc_r = 0.f, acc_g = 0.f, acc_b = 0.f;
    int sample = c0, d = 0;
    // the pool's pixel q: its sum so far (the chunks before) and sample c0
    const auto take = [&](int q) {
      idx = first + q;
      const long long pixel = pix0 + idx;
      pix_u = static_cast<uint32_t>(pixel);
      fx = static_cast<float>(pix_u % static_cast<uint32_t>(width));
      fy = static_cast<float>(pix_u / static_cast<uint32_t>(width));
      acc_r = acc_g = acc_b = 0.f;
      if (c0 > 0) {
        acc_r = rad[3 * idx + 0];
        acc_g = rad[3 * idx + 1];
        acc_b = rad[3 * idx + 2];
      }
      sample = c0;
    };
    bool done = static_cast<int>(threadIdx.x) >= pool;
    bool fresh = !done;  // a sample to start
    if (!done) take(threadIdx.x);
    PathState p;
    p.live = false;
    for (;;) {
      bool need = false;  // the lane's pixel has run the chunk
      if (!done && !fresh && (!p.live || d == depth)) {
        acc_r = acc_r + p.rr;
        acc_g = acc_g + p.rg;
        acc_b = acc_b + p.rb;
        if (++sample < c1) {
          fresh = true;
        } else {
          rad[3 * idx + 0] = acc_r;
          rad[3 * idx + 1] = acc_g;
          rad[3 * idx + 2] = acc_b;
          need = true;
        }
      }
      // the lanes that need a pixel take the pool's next ones, in lane order
      const unsigned want = __ballot_sync(kFull, need);
      if (want != 0u) {
        const int leader = __ffs(want) - 1;
        unsigned got = 0u;
        if (lane == leader) got = atomicAdd(s_taken, static_cast<unsigned>(__popc(want)));
        got = __shfl_sync(kFull, got, leader);
        if (need) {
          const int q = kBlock + static_cast<int>(got) + __popc(want & below);
          done = q >= pool;
          fresh = !done;
          if (!done) take(q);
        }
      }
      if (__all_sync(kFull, done)) break;
      if (fresh) {
        init_state(p, cam, s.cam, it0 + static_cast<uint32_t>(sample), pix_u, fx, fy, sx_scale,
                   sy_scale, true);
        d = 0;
        fresh = false;
      }
      if (!done) {
        // a live path entering bounce d
        atomicAdd(s_counts + (kPerSample ? (sample - c0) * depth + d : d), 1u);
        bounce(p, d, it0 + static_cast<uint32_t>(sample), pix_u, s, mesh, tex);
        ++d;
      }
    }
    // the chunk's counts, summed over the block, into the global ones
    __syncthreads();
    const int used = kPerSample ? (c1 - c0) * depth : depth;
    for (int i = threadIdx.x; i < used; i += kBlock) {
      const unsigned c = s_counts[i];
      s_counts[i] = 0u;
      if (c) atomicAdd(&counts[(kPerSample ? static_cast<long long>(c0) * depth : 0) + i],
                       static_cast<unsigned long long>(c));
    }
    if (threadIdx.x == 0) *s_taken = 0u;
    __syncthreads();
  }
}

// K5's state planes: the rows of a (keys, n_rays) float32 array, in the
// order of ops/cuda/megakernel.py state_keys (the reference's `_state_keys`):
// ox oy oz dx dy dz tr tg tb rr rg rb live, then emit_ok (NEE), time
// (motion), med_s med_r med_g med_b (SSS).  live and emit_ok hold 1 or 0.
// The sorted engine appends the pixel id plane (int32 bits), at pix_key.
constexpr int kKeyRad = 9;
constexpr int kKeyLive = 12;
constexpr int kKeyEmitOk = kKeyLive + 1;
constexpr int kKeyTime = kKeyEmitOk + (kNee ? 1 : 0);
constexpr int kKeyMed = kKeyTime + (kMotion ? 1 : 0);
constexpr int kStateKeys = kKeyMed + (kSss ? 4 : 0);

// The planes of a ray that enters a span live (its `live` plane, already
// read, is 1).
__device__ __forceinline__ void load_state(PathState& p, const float* st, long long n,
                                           long long i) {
  p.ox = st[i];
  p.oy = st[n + i];
  p.oz = st[2 * n + i];
  p.dx = st[3 * n + i];
  p.dy = st[4 * n + i];
  p.dz = st[5 * n + i];
  p.tr = st[6 * n + i];
  p.tg = st[7 * n + i];
  p.tb = st[8 * n + i];
  p.rr = st[kKeyRad * n + i];
  p.rg = st[(kKeyRad + 1) * n + i];
  p.rb = st[(kKeyRad + 2) * n + i];
  p.live = true;
  p.emit_ok = true;
  if constexpr (kNee) p.emit_ok = st[kKeyEmitOk * n + i] != 0.f;
  p.time = 0.f;
  if constexpr (kMotion) p.time = st[kKeyTime * n + i];
  p.med_s = 0.f;
  p.med_r = p.med_g = p.med_b = 1.f;
  if constexpr (kSss) {
    p.med_s = st[kKeyMed * n + i];
    p.med_r = st[(kKeyMed + 1) * n + i];
    p.med_g = st[(kKeyMed + 2) * n + i];
    p.med_b = st[(kKeyMed + 3) * n + i];
  }
}

__device__ __forceinline__ void store_rad(const PathState& p, float* st, long long n,
                                          long long i) {
  st[kKeyRad * n + i] = p.rr;
  st[(kKeyRad + 1) * n + i] = p.rg;
  st[(kKeyRad + 2) * n + i] = p.rb;
}

// What a ray that entered a span live leaves: every plane of a path still
// live after a span that is not the last; the radiance and `live` of one
// that ended in it (its other planes are never read again); the radiance
// alone after the last span.
__device__ __forceinline__ void store_state(const PathState& p, float* st, long long n,
                                            long long i, bool last) {
  store_rad(p, st, n, i);
  if (last) return;
  st[kKeyLive * n + i] = p.live ? 1.f : 0.f;
  if (!p.live) return;
  st[i] = p.ox;
  st[n + i] = p.oy;
  st[2 * n + i] = p.oz;
  st[3 * n + i] = p.dx;
  st[4 * n + i] = p.dy;
  st[5 * n + i] = p.dz;
  st[6 * n + i] = p.tr;
  st[7 * n + i] = p.tg;
  st[8 * n + i] = p.tb;
  if constexpr (kNee) st[kKeyEmitOk * n + i] = p.emit_ok ? 1.f : 0.f;
  if constexpr (kMotion) st[kKeyTime * n + i] = p.time;
  if constexpr (kSss) {
    st[kKeyMed * n + i] = p.med_s;
    st[(kKeyMed + 1) * n + i] = p.med_r;
    st[(kKeyMed + 2) * n + i] = p.med_g;
    st[(kKeyMed + 3) * n + i] = p.med_b;
  }
}

// K5 — the span kernel (replaces the Pallas `_span_kernel` of
// pathtrace_tpu/ops/pallas/megakernel.py, reached from the pallas_call in
// `_run_span`): bounces [d0, d1) of iteration `it` for the rays of one tile
// per block (kBlock slots of the state planes), through the same
// init_state and bounce as K1, so a trace cut into spans is bit-equal to
// K1's.  d0 = 0 runs raygen; a later span loads the state its ray left.
// Each ray's pixel is its slot, or (pix_key >= 0, the sorted engine) the
// pixel id carried in plane pix_key, written by the first span.  With a
// table (the split engine's resumed span), block b takes tile tbl[b] while
// b < *n_live (a count left on the card by the scan), and exits otherwise:
// the grid covers every tile, so no count comes back to the host.  Without
// a table, `n_live` (a later span of the sorted engine, whose dead rays
// are sorted last) is the count of live rays, which the span before it
// added into its `live_out`: the blocks whose first slot is past it exit.
// Live counts at the absolute bounce, as K1's.  State in, state out, in
// place.
//
// What bounds it: as K1, the bounce's ALU work and divergence; each span
// boundary adds the state a ray needs, coalesced (a warp's 32 rays are 32
// neighbouring floats of each plane).  Once most paths have ended that is
// little: a ray that enters dead reads its `live` plane and nothing else
// and writes nothing (its planes already hold its radiance), a path that
// ends writes its radiance and `live` (4 planes), only a path still live
// writes every plane, and after the last span only the radiance is
// written; the sorted engine's blocks past the live prefix read nothing.
__global__ void __launch_bounds__(kBlock)
k5_span(const float* __restrict__ cam_g, const float* __restrict__ mats_g,
        const float* __restrict__ gmat_g, const int* __restrict__ types_g,
        const float* __restrict__ lights_g, const float4* __restrict__ tri_g,
        const float4* __restrict__ nodes_g, const int* __restrict__ meta_g,
        const uint32_t* __restrict__ texels_g, const int* __restrict__ charts_g, int n_geoms,
        int n_lights, int n_meta, int width, int height, float* __restrict__ state,
        long long n_rays, int pix_key, const int* __restrict__ tbl,
        const int* __restrict__ n_live, long long n_tiles, int* __restrict__ live_out, int d0,
        int d1, int depth, uint32_t it, unsigned long long* __restrict__ counts) {
  long long tile = blockIdx.x;
  if (tbl != nullptr) {
    if (static_cast<long long>(blockIdx.x) >= static_cast<long long>(__ldg(n_live))) return;
    tile = __ldg(tbl + blockIdx.x);
    if (tile < 0 || tile >= n_tiles) return;  // not a tile: nothing to trace
  } else if (n_live != nullptr && tile * kBlock >= static_cast<long long>(__ldg(n_live))) {
    return;  // past the live prefix: every ray of the tile is dead
  }
  const int span = d1 - d0;
  extern __shared__ unsigned long long smem[];
  unsigned long long* s_counts = smem;
  const Tables s = stage_tables(smem, span, cam_g, mats_g, gmat_g, types_g, lights_g, meta_g,
                                charts_g, n_geoms, n_lights, n_meta);
  const Mesh mesh(tri_g, nodes_g, s.meta, n_meta);
  const Tex tex(texels_g);
  __syncthreads();

  const int warp = threadIdx.x >> 5;
  const int lane = threadIdx.x & 31;
  const long long slot = tile * kBlock + threadIdx.x;
  // slots past the end still run the loop: every lane joins the ballots
  const bool valid = slot < n_rays;
  int* pix_plane = pix_key >= 0 ? reinterpret_cast<int*>(state + pix_key * n_rays) : nullptr;
  long long pixel = slot;
  PathState p = PathState{0.f, 0.f, 0.f, 0.f, 0.f, 0.f, 1.f, 1.f, 1.f, 0.f,
                          0.f, 0.f, false, 0.f, 0.f, 1.f, 1.f, 1.f, true};
  if (d0 == 0) {
    const float fx = static_cast<float>(pixel % width);
    const float fy = static_cast<float>(pixel / width);
    const float sx_scale = static_cast<float>(2.0 / width);
    const float sy_scale = static_cast<float>(2.0 / height);
    init_state(p, load_camera(s.cam), s.cam, it, static_cast<uint32_t>(pixel), fx, fy,
               sx_scale, sy_scale, valid);
  } else if (valid && state[kKeyLive * n_rays + slot] != 0.f) {
    load_state(p, state, n_rays, slot);
    if (pix_plane != nullptr) pixel = pix_plane[slot];
  }
  const bool ran = p.live;  // entered live: the rays whose planes are written
  const uint32_t pix_u = static_cast<uint32_t>(pixel);
  for (int d = d0; d < d1; ++d) {
    const unsigned ballot = __ballot_sync(0xffffffffu, p.live);
    if (lane == 0) s_counts[warp * span + (d - d0)] += __popc(ballot);
    bounce(p, d, it, pix_u, s, mesh, tex);
  }
  if (live_out != nullptr) {
    const unsigned ballot = __ballot_sync(0xffffffffu, p.live);
    if (lane == 0 && ballot != 0u) atomicAdd(live_out, __popc(ballot));
  }
  if (ran) {
    store_state(p, state, n_rays, slot, d1 == depth);
    if (d0 == 0 && pix_plane != nullptr) pix_plane[slot] = static_cast<int>(slot);
  }
  if (lane == 0) {
    for (int j = 0; j < span; ++j) {
      const unsigned long long c = s_counts[warp * span + j];
      if (c) atomicAdd(&counts[d0 + j], c);
    }
  }
}

#endif  // !PT_GRAD && !PT_VJP

#if PT_GRAD || PT_VJP
// K7's and K8's gradient tables are exact sums of their float32 terms, so
// that two calls give the same bits whatever order the threads add in.
// They are fixed point, in units of 2^-64.  A term |v| 2^64 = m 2^sh (m its
// 24-bit significand, sh <= 102) spans at most three 12-bit digits, which
// are added (negated for a negative term) into three of the entry's
// kFxLimbs 32-bit limbs in the block's table in shared memory, limb k
// weighing 2^(12 k): integer atomics, which commute, need no carry and run
// natively on 32-bit words in shared memory (64-bit ones, integer or
// float, are compare-and-swap loops there).  A limb holds any sum of digits
// below 2^31 in absolute value: 2^19 digits of up to 2^12 - 1, however
// they are grouped into adds, so after each sample the block adds its
// limbs, as one 128-bit two's-complement integer an entry, into the one
// table in global memory (fx_flush) and starts again from zero; a sample
// adds at most 128 threads x depth x (n_lights + 3) terms to an entry, one
// digit each to a limb (kFxMaxLights).  Each lane adds its own terms: the
// atomics need no result, so a lane does not wait on them, where summing a
// warp's digits first (__match_any_sync, __reduce_add_sync) chains warp
// collectives on every add and made K8 2-13 times slower (PERF.md).  A
// term below 2^-64 adds nothing; one that is not finite or reaches 2^62
// sets the entry's flag bit, and the entry comes out NaN.  fx_round rounds
// the global table to float32.  The sums are exact while the absolute
// values of an entry's terms add up to less than 2^63.
constexpr int kFxLimbs = 11;     // 11 x 12 bits cover the 128
constexpr int kFxMaxLights = 64;  // 128 x 32 x (64 + 3) < 2^19

struct Fx {
  unsigned* w;  // the block's table: kFxLimbs n limbs, then flag words
  int n;        // its entries
  int i;        // this entry
  __device__ __forceinline__ Fx operator+(int k) const { return Fx{w, n, i + k}; }
};

// The words of a table of n entries: a block's in shared memory (32-bit:
// the limbs, then a flag bit an entry) and the one in global memory
// (64-bit: low words, high words, then a flag bit an entry).
__host__ __device__ constexpr int fx_smem_words(int n) { return kFxLimbs * n + (n + 31) / 32; }
__host__ __device__ constexpr int fx_words(int n) { return 2 * n + (n + 63) / 64; }

__device__ __forceinline__ void fx_add(const Fx& e, float v) {
  const uint32_t b = __float_as_uint(v);
  const int ex = static_cast<int>((b >> 23) & 0xffu);
  const int sh = ex - 86;  // |v| 2^64 = m 2^sh
  if (ex == 0 || sh <= -24) return;  // zero, subnormal or below 2^-64
  if (ex == 0xff || sh > 102) {      // inf, NaN, or 2^62 and more
    atomicOr(e.w + kFxLimbs * e.n + (e.i >> 5), 1u << (e.i & 31));
    return;
  }
  const unsigned long long m = (b & 0x7fffffu) | 0x800000u;
  const int k = sh < 0 ? 0 : sh / 12;  // the lowest limb the digits go to
  const unsigned long long t = sh < 0 ? m >> -sh : m << (sh - 12 * k);
  const bool neg = (b >> 31) != 0u;
  unsigned* limb = e.w + k * e.n + e.i;
  for (int j = 0; j < 3; ++j) {
    const unsigned d = static_cast<unsigned>(t >> (12 * j)) & 0xfffu;
    if (d) atomicAdd(limb + j * e.n, neg ? 0u - d : d);
  }
}

// Adds the block's table s (fx_smem_words(n) words) into the global one g
// (fx_words(n)) and zeroes it: each entry's limbs as one 128-bit integer,
// added with a carry from the low word to the high one.  Every thread of
// the block calls it, between two __syncthreads.
__device__ __forceinline__ void fx_flush(unsigned* s, int n, unsigned long long* g) {
  for (int i = threadIdx.x; i < n; i += kBlock) {
    unsigned long long lo = 0ull, hi = 0ull;
    for (int k = 0; k < kFxLimbs; ++k) {
      const long long v = static_cast<int>(s[k * n + i]);
      s[k * n + i] = 0u;
      // v 2^(12 k), sign-extended to 128 bits
      const int sk = 12 * k;
      const unsigned long long u = static_cast<unsigned long long>(v);
      const unsigned long long a_lo = sk < 64 ? u << sk : 0ull;
      const unsigned long long a_hi =
          sk == 0  ? (v < 0 ? ~0ull : 0ull)
          : sk < 64 ? static_cast<unsigned long long>(v >> (64 - sk))
                    : u << (sk - 64);
      lo += a_lo;
      hi += a_hi + (lo < a_lo ? 1ull : 0ull);
    }
    if (lo == 0ull && hi == 0ull) continue;
    const unsigned long long old = atomicAdd(g + i, lo);
    const unsigned long long h = hi + (old + lo < old ? 1ull : 0ull);
    if (h) atomicAdd(g + n + i, h);
  }
  unsigned* flags = s + kFxLimbs * n;
  const int n_flags = (n + 31) / 32;
  for (int q = threadIdx.x; 2 * q < n_flags; q += kBlock) {
    const unsigned long long hi_half = 2 * q + 1 < n_flags ? flags[2 * q + 1] : 0u;
    const unsigned long long f = flags[2 * q] | hi_half << 32;
    if (f) {
      atomicOr(g + 2 * n + q, f);
      flags[2 * q] = 0u;
      if (2 * q + 1 < n_flags) flags[2 * q + 1] = 0u;
    }
  }
}

// The table g (fx_words(n) words) rounded to float32, one thread an
// entry: the nearest float32 to the double nearest to each entry, NaN
// where flagged.
__global__ void __launch_bounds__(kBlock)
fx_round(const unsigned long long* __restrict__ g, int n, float* __restrict__ out) {
  const int i = blockIdx.x * kBlock + threadIdx.x;
  if (i >= n) return;
  unsigned long long lo = g[i], hi = g[n + i];
  if ((g[2 * n + (i >> 6)] >> (i & 63)) & 1ull) {
    out[i] = nanf("");
    return;
  }
  const bool neg = static_cast<long long>(hi) < 0;
  if (neg) {  // -(hi, lo)
    lo = ~lo + 1ull;
    hi = ~hi + (lo == 0ull ? 1ull : 0ull);
  }
  const double v = static_cast<double>(hi) + static_cast<double>(lo) * 0x1p-64;
  out[i] = static_cast<float>(neg ? -v : v);
}

// The start of a block's gradient table in shared memory: past the tables,
// aligned for its 64-bit words.
inline size_t grad_smem_offset(size_t tables_bytes) {
  constexpr size_t a = alignof(unsigned long long);
  return (tables_bytes + a - 1) & ~(a - 1);
}
#endif

#if PT_GRAD
// K7 — the analytic material gradients (replaces the grad mode of the
// Pallas `_kernel`, reached from `material_grads_pallas` through `_run`):
// K1's trace, whose bounce also records the factor it multiplies into the
// path (PathState::ev), and at the end of each path `_grad_accumulate`'s
// fold of the path's factors.  At fixed random draws the radiance is a
// product of the factors, so d(ct . radiance)/d(x) is w / x for each time
// the path met the factor x (w = ct * radiance): a diffuse bounce color and
// 1/(1-p), a specular one spec_color and 1/p, an emissive hit color and
// emittance, a glass reflection spec_color, a refraction color (p =
// clip(has_reflective, 0, 1)).  The table: rows 0-2 d/d color rgb, 3-5 d/d
// spec_color rgb, 6 d/d emittance, 7 d/d has_reflective, n_mats columns.
//
// The reference counts the factors per material as base-64 digits of one
// float32 per lane; here each path keeps its list of (geom, kind), at most
// one a bounce, in local memory.  A lane adds its path's terms (float32)
// into its block's table in shared memory, exactly (fx_add), and the block
// adds its table into the global one (fx_flush), which fx_round rounds to
// float32.
//
// The schedule is K1's (k1_trace): a lane folds its path the step it ends,
// starts its pixel's next sample at once and takes the next pixel of its
// block's pool (k1_lane_pixels) when the pixel's samples are done, so a
// warp never waits for its longest path.  The block synchronises only at
// the end of each chunk of samples: it adds its counts and its table into
// the global ones there.  A chunk is as many samples as keep every limb
// under 2^19 digits (fx_add): a path adds at most one term an event to an
// entry, one digit a limb, and meets at most depth events, so a block may
// fold flush_paths paths between two flushes where flush_paths x depth <
// 2^19 (ops/cuda/matgrad.py k7_flush_paths, which the host passes and
// pt_k7_grads checks); a chunk is flush_paths / (kBlock x lane_px) samples
// of the block's pool.  The exact sum does not depend on the order or the
// grouping of its terms, so the table's bits are those of any other
// schedule.
//
// What bounds it: K1's operations (the fold adds a few per scatter,
// bound.k7_extra).  Measured (PERF.md section 5): the fold is most of what
// K7 adds to K1's time, its float divisions more than its atomics; a path
// folding each repeated (material, kind) once with its count, folds batched
// over a warp's lanes and a table for each warp did not pay.
constexpr int kGradRows = 8;
constexpr long long kFxLimbDigits = 1ll << 19;

__device__ __forceinline__ void grad_fold(const PathState& p, const float* ct,
                                          const float* mtab, const int* mat_of, int n_mats,
                                          const Fx& tab) {
  const float w[3] = {ct[0] * p.rr, ct[1] * p.rg, ct[2] * p.rb};
  if (w[0] == 0.f && w[1] == 0.f && w[2] == 0.f) return;  // every term is 0
  const float wsum = w[0] + w[1] + w[2];
  constexpr float eps = 1e-8f;
  for (int e = 0; e < p.n_ev; ++e) {
    const uint32_t kind = p.ev[e] & 7u;
    const int m = __ldg(mat_of + (p.ev[e] >> 3));
    const float* mv = mtab + kGradRows * m;
    // color (diffuse, lit, refraction) or spec_color (specular, reflection)
    const int col = (kind == 1u || kind == 3u) ? 3 : 0;
#pragma unroll
    for (int c = 0; c < 3; ++c) {
      const float x = __ldg(mv + col + c);
      if (x > eps) fx_add(tab + ((col + c) * n_mats + m), w[c] / x);
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

// The samples of a chunk: flush_paths paths a block at most between two
// flushes, the pool holding kBlock x lane_px pixels (0: too few paths a
// flush for one sample of the pool).
__host__ __device__ constexpr int k7_chunk(int flush_paths, int lane_px) {
  return flush_paths / (kBlock * lane_px);
}

__global__ void __launch_bounds__(kBlock, 7)
k7_grads(const float* __restrict__ cam_g, const float* __restrict__ mats_g,
         const float* __restrict__ gmat_g, const int* __restrict__ types_g,
         const float* __restrict__ lights_g, const float4* __restrict__ tri_g,
         const float4* __restrict__ nodes_g, const int* __restrict__ meta_g,
         const uint32_t* __restrict__ texels_g, const int* __restrict__ charts_g, int n_geoms,
         int n_lights, int n_meta, int width, int height, int depth, uint32_t it0, int n_spp,
         int lane_px, int chunk, const float* __restrict__ mtab, const int* __restrict__ mat_of,
         int n_mats, const float* __restrict__ ct, float* __restrict__ rad,
         unsigned long long* __restrict__ counts, unsigned long long* __restrict__ gtab,
         size_t grad_off) {
  // shared: the count words (one a bounce) and the pool's taken word, the
  // tables, and at byte grad_off the block's gradient table
  extern __shared__ unsigned long long smem[];
  const Tables s = stage_tables(smem, k1_count_slots(depth), cam_g, mats_g, gmat_g, types_g,
                                lights_g, meta_g, charts_g, n_geoms, n_lights, n_meta);
  unsigned* s_counts = reinterpret_cast<unsigned*>(smem);
  unsigned* s_taken = s_counts + depth;  // the pool's pixels taken past its first kBlock
  unsigned* s_grad = reinterpret_cast<unsigned*>(reinterpret_cast<char*>(smem) + grad_off);
  const int n_grad = kGradRows * n_mats;
  for (int i = threadIdx.x; i < fx_smem_words(n_grad); i += kBlock) s_grad[i] = 0u;
  const Fx tab{s_grad, n_grad, 0};
  const Mesh mesh(tri_g, nodes_g, s.meta, n_meta);
  const Tex tex(texels_g);
  __syncthreads();

  constexpr unsigned kFull = 0xffffffffu;
  const int lane = threadIdx.x & 31;
  const unsigned below = (1u << lane) - 1u;
  const long long n_pix = static_cast<long long>(width) * height;
  // the pool: pixels first .. first + pool - 1
  const long long first = static_cast<long long>(blockIdx.x) * kBlock * lane_px;
  const int pool = static_cast<int>(min(static_cast<long long>(kBlock) * lane_px, n_pix - first));
  const float sx_scale = static_cast<float>(2.0 / width);
  const float sy_scale = static_cast<float>(2.0 / height);
  const Camera cam = load_camera(s.cam);
  if (n_spp == 0) {
    for (int q = threadIdx.x; q < pool; q += kBlock)
      rad[3 * (first + q) + 0] = rad[3 * (first + q) + 1] = rad[3 * (first + q) + 2] = 0.f;
    return;
  }

  for (int c0 = 0; c0 < n_spp; c0 += chunk) {
    const int c1 = min(n_spp, c0 + chunk);
    long long idx = 0;  // the lane's pixel
    uint32_t pix_u = 0u;
    float fx = 0.f, fy = 0.f, acc_r = 0.f, acc_g = 0.f, acc_b = 0.f;
    int sample = c0, d = 0;
    // the pool's pixel q: its sum so far (the chunks before) and sample c0
    const auto take = [&](int q) {
      idx = first + q;
      pix_u = static_cast<uint32_t>(idx);
      fx = static_cast<float>(pix_u % static_cast<uint32_t>(width));
      fy = static_cast<float>(pix_u / static_cast<uint32_t>(width));
      acc_r = acc_g = acc_b = 0.f;
      if (c0 > 0) {
        acc_r = rad[3 * idx + 0];
        acc_g = rad[3 * idx + 1];
        acc_b = rad[3 * idx + 2];
      }
      sample = c0;
    };
    bool done = static_cast<int>(threadIdx.x) >= pool;
    bool fresh = !done;  // a sample to start
    if (!done) take(threadIdx.x);
    PathState p;
    p.live = false;
    for (;;) {
      bool need = false;  // the lane's pixel has run the chunk
      if (!done && !fresh && (!p.live || d == depth)) {
        grad_fold(p, ct + 3 * idx, mtab, mat_of, n_mats, tab);
        acc_r = acc_r + p.rr;
        acc_g = acc_g + p.rg;
        acc_b = acc_b + p.rb;
        if (++sample < c1) {
          fresh = true;
        } else {
          rad[3 * idx + 0] = acc_r;
          rad[3 * idx + 1] = acc_g;
          rad[3 * idx + 2] = acc_b;
          need = true;
        }
      }
      // the lanes that need a pixel take the pool's next ones, in lane order
      const unsigned want = __ballot_sync(kFull, need);
      if (want != 0u) {
        const int leader = __ffs(want) - 1;
        unsigned got = 0u;
        if (lane == leader) got = atomicAdd(s_taken, static_cast<unsigned>(__popc(want)));
        got = __shfl_sync(kFull, got, leader);
        if (need) {
          const int q = kBlock + static_cast<int>(got) + __popc(want & below);
          done = q >= pool;
          fresh = !done;
          if (!done) take(q);
        }
      }
      if (__all_sync(kFull, done)) break;
      if (fresh) {
        init_state(p, cam, s.cam, it0 + static_cast<uint32_t>(sample), pix_u, fx, fy, sx_scale,
                   sy_scale, true);
        d = 0;
        fresh = false;
      }
      if (!done) {
        // a live path entering bounce d
        atomicAdd(s_counts + d, 1u);
        bounce(p, d, it0 + static_cast<uint32_t>(sample), pix_u, s, mesh, tex);
        ++d;
      }
    }
    // the chunk's counts and gradients, summed over the block, into the
    // global ones
    __syncthreads();
    for (int i = threadIdx.x; i < depth; i += kBlock) {
      const unsigned c = s_counts[i];
      s_counts[i] = 0u;
      if (c) atomicAdd(&counts[i], static_cast<unsigned long long>(c));
    }
    fx_flush(s_grad, n_grad, gtab);
    if (threadIdx.x == 0) *s_taken = 0u;
    __syncthreads();
  }
}
#endif  // PT_GRAD

#if PT_VJP
static_assert((kFeatures & ~(127u | 128u | 512u)) == 0,
              "K8 is built for the scene sections (bits 0-6), NEE and BVH meshes: not for "
              "Russian roulette, image textures or K3-linear");

// K8 — the reverse sweep (replaces the Pallas `_vjp_kernel`, reached from
// `render_vjp_pallas` through `_run_vjp`): per sample, the forward sweep
// through K1's init_state and bounce, keeping the state entering each bounce
// and what the bounce found (Saved), then the bounces' adjoints from the
// last to the first and raygen's, which give the gradient of ct . radiance
// with respect to every table entry.  The reference transposes its tracer
// with jax.vjp; CUDA has none, so each step's adjoint is written here by
// hand, beside the forward code it follows.  The estimator is the
// reference's: the nearest hit, the lobe, the light face and visibility are
// detached; the winner's hit point and normal, the lobe's direction and
// throughput, the emission and NEE's cos cos' / r^2 term carry gradients.
//
// The cotangent of the radiance is ct at every bounce (the radiance only
// adds up), so the sweep carries the cotangents of the ray (o, d) and of the
// throughput (and, with SSS, of the medium).  Table gradients go into the
// block's table in shared memory, exactly (fx_add), which each block adds
// into the global one after each sample (fx_flush); fx_round rounds that to
// float32.  Table layout: cam 16 | mats n_geoms x 24 | gmat n_geoms x 40 |
// lights n_lights x 128 (the packed tables' own).
//
// The sections (bits 0-6 of the mask), each adjoint beside its forward
// code, every choice detached as the reference's selects are:
// * depth of field: the thin lens in raygen's adjoint (aperture cam[14],
//   focal distance cam[15]; the lens draws are constants);
// * motion: every hit and shadow test at origin - time velocity, the hit
//   point moved back by time velocity (gmat 33..35, the lights' 120..122);
//   the time is drawn again, not stored;
// * checker: the albedo row is the checker's (mats 12..14) on odd cells, for
//   the emission, the diffuse and refraction tints and NEE;
// * bump: the tilted normal's adjoint (bump_adj) to the geometric normal,
//   the object-space hit point, bump scale and strength (mats 15, 16) and
//   the inverse-transpose (gmat 24..32);
// * imperfect specular: the power-cosine lobe about the mirror direction
//   (spec_lobe_adj; the exponent, mats 6, through pow(u, 1/(m+1)));
// * glass: Schlick's choice detached; the mirror, or Snell's direction
//   (ior, mats 9) and the push past the interface (gmat 36); no NEE on it;
// * SSS: the medium (sigma, albedo rgb) is state, kept in Saved and carried
//   by the cotangent: an inside scatter's free path moves the ray's origin
//   (sigma) and tints by the medium's albedo; entering a medium loads mats
//   17..20.
//
// The reverse sweep does not repeat the forward's search.  The forward
// keeps each bounce's winning geom (and in the mesh builds, the reference's
// "carry" form of bvh_grad, its triangle row) beside its state, so
// bounce_adj recomputes only the winner's own test (the carried triangle's
// hit, tri_hit, or the primitive's, the fold over that one geom) and
// differentiates it (tri_adj, hit_adj).  With NEE, nee_add keeps a bit per
// light, set where the shadow test saw the sample, and nee_adj takes it:
// no shadow ray is traced and no BVH walked in the reverse sweep.  The
// winner, the row, the face it shows and the visibility are detached, as
// the reference's selects and carried row are: the triangles get no
// gradient (render_vjp returns tri_verts None, as the reference does).
//
// What bounds it: K1's operations, plus K7's fold without NEE (the only
// gradient that is not zero there is the materials') or the adjoints with
// NEE (bound.k8_extra), and the states each live bounce keeps, written and
// read once.  It runs far from that: the adjoints and their exact adds
// (fx_add) take about half of its time, the forward sweep at K8's register
// count the rest (PERF.md section 5).  The states live in local memory
// (kVjpMaxDepth of them a thread): in shared memory they would cost more
// occupancy than they save.
constexpr int kVjpMaxDepth = 32;
// raygen's camera gradients: pos, view, right, up, tan (and the lens)
constexpr int kCamGrads = kDof ? 16 : 14;

// The state entering a bounce and what its forward found: the winning geom
// (-1: none) and, in the mesh builds, its triangle row (-1: a primitive);
// with NEE, the lights whose samples its shadow rays saw (bit k: light k);
// in the SSS builds also the medium the path is in.
struct SavedCore {
  float ox, oy, oz, dx, dy, dz, tr, tg, tb;
  int geom;
  bool live, emit_ok;
};
template <bool> struct SavedRow {};
template <> struct SavedRow<true> { int row; };
template <bool> struct SavedMed {};
template <> struct SavedMed<true> { float med_s, med_r, med_g, med_b; };
template <bool> struct SavedVis {};
template <> struct SavedVis<true> { unsigned long long vis; };
struct Saved : SavedCore, SavedRow<kMesh>, SavedMed<kSss>, SavedVis<kNee> {};

// The state entering a bounce, into sv.
template <typename S>
__device__ __forceinline__ void keep_state(S& sv, const PathState& p) {
  sv.ox = p.ox;
  sv.oy = p.oy;
  sv.oz = p.oz;
  sv.dx = p.dx;
  sv.dy = p.dy;
  sv.dz = p.dz;
  sv.tr = p.tr;
  sv.tg = p.tg;
  sv.tb = p.tb;
  sv.live = p.live;
  sv.emit_ok = p.emit_ok;
  if constexpr (kSss) {
    sv.med_s = p.med_s;
    sv.med_r = p.med_r;
    sv.med_g = p.med_g;
    sv.med_b = p.med_b;
  }
}

// What the bounce's forward found, into sv: its winner and visibility.
template <typename S>
__device__ __forceinline__ void keep_found(S& sv, const PathState& p) {
  sv.geom = p.win_geom;
  if constexpr (kMesh) sv.row = p.win_row;
  if constexpr (kNee) sv.vis = p.nee_vis;
}

// The cotangents of the ray and the throughput a bounce hands on, and in
// the SSS builds of the medium (sigma ms, albedo m).
struct CotRay {
  float o[3], d[3], t[3];
};
struct CotMed {
  float o[3], d[3], t[3];
  float ms, m[3];
};
using Cot = std::conditional_t<kSss, CotMed, CotRay>;

struct GradTab {
  Fx cam;
  Fx mats;
  Fx gmat;
  Fx lights;
};

__device__ __forceinline__ void gadd(const Fx& p, float v) { fx_add(p, v); }

// The adjoint of normalize3: given x (before normalizing) and the cotangent
// g of x / |x|, writes the cotangent of x over g.
__device__ __forceinline__ void normalize3_adj(float x, float y, float z, float* g) {
  const float inv = 1.f / sqrtf(x * x + y * y + z * z);
  const float nx = x * inv, ny = y * inv, nz = z * inv;
  const float dot = g[0] * nx + g[1] * ny + g[2] * nz;
  g[0] = inv * (g[0] - nx * dot);
  g[1] = inv * (g[1] - ny * dot);
  g[2] = inv * (g[2] - nz * dot);
}

// c += a x b
__device__ __forceinline__ void cross_add(const float* a, const float* b, float* c) {
  c[0] += a[1] * b[2] - a[2] * b[1];
  c[1] += a[2] * b[0] - a[0] * b[2];
  c[2] += a[0] * b[1] - a[1] * b[0];
}

// The origin a winner's object ray starts from: o, or (motion) o moved back
// by time * the geom's velocity (gmat row m, 33..35).
__device__ __forceinline__ void moved_origin(const float* m, const float* o, float time,
                                             float* go) {
  for (int k = 0; k < 3; ++k) go[k] = o[k];
  if constexpr (kMotion) {
    for (int k = 0; k < 3; ++k) go[k] = o[k] - time * m[33 + k];
  }
}

// The adjoint of a winner's object ray, rd = normalize(rdr), rdr = M^-1 d,
// ro = M^-1 go + the inverse's translation (gmat row m, 12..23), go the
// origin moved back by time * velocity (motion; o itself otherwise): from
// the cotangents g_ro, g_rd (g_rd is overwritten), adds the ray's into
// c.o, c.d and the inverse's (and the velocity's) into tg.
template <typename C>
__device__ __forceinline__ void ray_adj(const float* m, const float* go, const float* d,
                                        const float* rdr, const float* g_ro, float* g_rd,
                                        float time, const Fx& tg, C& c) {
  normalize3_adj(rdr[0], rdr[1], rdr[2], g_rd);
  float g_go[3] = {0.f, 0.f, 0.f};
  for (int i = 0; i < 3; ++i) {
    for (int j = 0; j < 3; ++j) {
      gadd(tg + 12 + 4 * i + j, g_ro[i] * go[j] + g_rd[i] * d[j]);
      g_go[j] += m[12 + 4 * i + j] * g_ro[i];
      c.d[j] += m[12 + 4 * i + j] * g_rd[i];
    }
    gadd(tg + 12 + 4 * i + 3, g_ro[i]);
  }
  for (int j = 0; j < 3; ++j) {
    c.o[j] += g_go[j];
    // go = o - time * velocity
    if constexpr (kMotion) gadd(tg + 33 + j, -g_go[j] * time);
  }
}

// The adjoint of the world hit point p = F q + t (+ time * velocity with
// motion) to the forward rows and the velocity (tg) and, into g_q, to the
// object-space point q; gq (bump builds) adds the point's own cotangent.
__device__ __forceinline__ void point_adj(const float* m, const float* q, const float* gp,
                                          const float* gq, float time, const Fx& tg,
                                          float* g_q) {
  for (int j = 0; j < 3; ++j) g_q[j] = m[j] * gp[0] + m[4 + j] * gp[1] + m[8 + j] * gp[2];
  if constexpr (kBump) {
    for (int j = 0; j < 3; ++j) g_q[j] += gq[j];
  }
  for (int i = 0; i < 3; ++i) {
    for (int j = 0; j < 3; ++j) gadd(tg + 4 * i + j, gp[i] * q[j]);
    gadd(tg + 4 * i + 3, gp[i]);
  }
  if constexpr (kMotion) {
    for (int i = 0; i < 3; ++i) gadd(tg + 33 + i, gp[i] * time);
  }
}

// The winner's hit (nearest<false>'s sphere and cube sections, for geom row
// m of type `type`) from the ray (o, d) at shutter time `time`: recomputed,
// then its adjoint.  gp, gn, gq: the cotangents of the world hit point, the
// normal and (bump builds) the object-space point; adds the ray's into c.o,
// c.d and the row's into tg (the geom's gmat gradient row).  The slab and
// root choices are detached, as the reference's selects are.
template <typename C>
__device__ void hit_adj(const float* m, int type, const float* o, const float* d, float time,
                        const float* gp, const float* gn, const float* gq, const Fx& tg,
                        C& c) {
  float go[3];
  moved_origin(m, o, time, go);
  const float ro[3] = {m[12] * go[0] + m[13] * go[1] + m[14] * go[2] + m[15],
                       m[16] * go[0] + m[17] * go[1] + m[18] * go[2] + m[19],
                       m[20] * go[0] + m[21] * go[1] + m[22] * go[2] + m[23]};
  const float rdr[3] = {m[12] * d[0] + m[13] * d[1] + m[14] * d[2],
                        m[16] * d[0] + m[17] * d[1] + m[18] * d[2],
                        m[20] * d[0] + m[21] * d[1] + m[22] * d[2]};
  float rd[3] = {rdr[0], rdr[1], rdr[2]};
  normalize3(rd[0], rd[1], rd[2]);
  float g_ro[3], g_rd[3], q[3];
  if (type == kSphere) {
    const float vdd = ro[0] * rd[0] + ro[1] * rd[1] + ro[2] * rd[2];
    const float rad2 = vdd * vdd - (ro[0] * ro[0] + ro[1] * ro[1] + ro[2] * ro[2] - 0.25f);
    const float sq = sqrtf(rad2);  // a winner has a root
    const float t1 = -vdd + sq;
    const float t2 = -vdd - sq;
    const bool both_pos = t1 > 0.f && t2 > 0.f;
    // the nearer root in front (t2) from outside, else the far one (t1)
    const float t_use = both_pos ? fminf(t1, t2) : fmaxf(t1, t2);
    const float s_root = both_pos ? -1.f : 1.f;
    const float tofs = t_use - kRayOffset;
    for (int k = 0; k < 3; ++k) q[k] = ro[k] + tofs * rd[k];
    float nr[3];
    for (int i = 0; i < 3; ++i)
      nr[i] = m[24 + 3 * i] * q[0] + m[25 + 3 * i] * q[1] + m[26 + 3 * i] * q[2];
    const float flip = both_pos ? 1.f : -1.f;
    float g_q[3];
    point_adj(m, q, gp, gq, time, tg, g_q);
    // n = flip * normalize(N q), N the inverse-transpose rows
    float g_nr[3] = {gn[0] * flip, gn[1] * flip, gn[2] * flip};
    normalize3_adj(nr[0], nr[1], nr[2], g_nr);
    for (int i = 0; i < 3; ++i)
      for (int j = 0; j < 3; ++j) {
        gadd(tg + 24 + 3 * i + j, g_nr[i] * q[j]);
        g_q[j] += m[24 + 3 * i + j] * g_nr[i];
      }
    // q = ro + (t - offset) rd
    const float g_t = g_q[0] * rd[0] + g_q[1] * rd[1] + g_q[2] * rd[2];
    for (int k = 0; k < 3; ++k) {
      g_ro[k] = g_q[k];
      g_rd[k] = tofs * g_q[k];
    }
    // t = -vdd + s_root sqrt(rad2)
    const float g_rad2 = s_root * g_t * 0.5f / sq;
    const float g_vdd = -g_t + 2.f * vdd * g_rad2;
    for (int k = 0; k < 3; ++k) {
      g_ro[k] += -2.f * ro[k] * g_rad2 + g_vdd * rd[k];
      g_rd[k] += g_vdd * ro[k];
    }
  } else {
    // the slab test again, keeping the axis and normal sign of the
    // entering (tmin) and leaving (tmax) slabs
    float tmin = -1e38f, tmax = 1e38f, nmin = 0.f, nmax = 0.f;
    int amin = 0, amax = 0;
    for (int ax = 0; ax < 3; ++ax) {
      const float t1 = (-0.5f - ro[ax]) / rd[ax];
      const float t2 = (0.5f - ro[ax]) / rd[ax];
      const float ta = fminf(t1, t2);
      const float tb = fmaxf(t1, t2);
      const float sign = t2 < t1 ? 1.f : -1.f;
      if (ta > 0.f && ta > tmin) {
        tmin = ta;
        amin = ax;
        nmin = sign;
      }
      if (tb < tmax) {
        tmax = tb;
        amax = ax;
        nmax = sign;
      }
    }
    const bool inside = tmin <= 0.f;
    const float t_use = inside ? tmax : tmin;
    const int a = inside ? amax : amin;
    const float sgn = inside ? nmax : nmin;
    const float tofs = t_use - kRayOffset;
    for (int k = 0; k < 3; ++k) q[k] = ro[k] + tofs * rd[k];
    float g_q[3];
    point_adj(m, q, gp, gq, time, tg, g_q);
    // n = normalize(F n_obj), n_obj = sgn on axis a (the forward quirk)
    float g_nr[3] = {gn[0], gn[1], gn[2]};
    normalize3_adj(m[a] * sgn, m[4 + a] * sgn, m[8 + a] * sgn, g_nr);
    for (int i = 0; i < 3; ++i) gadd(tg + 4 * i + a, g_nr[i] * sgn);
    // q = ro + (t - offset) rd, t = (+-0.5 - ro_a) / rd_a
    const float g_t = g_q[0] * rd[0] + g_q[1] * rd[1] + g_q[2] * rd[2];
    for (int k = 0; k < 3; ++k) {
      g_ro[k] = g_q[k];
      g_rd[k] = tofs * g_q[k];
    }
    g_ro[a] += -g_t / rd[a];
    g_rd[a] += -g_t * t_use / rd[a];
  }
  ray_adj(m, go, d, rdr, g_ro, g_rd, time, tg, c);
}

// The adjoint of tri_hit, beside hit_adj's: gp, gn, gq the cotangents of
// the world hit point, the normal and (bump builds) the object-space point;
// adds the ray's into c.o, c.d and the geom row's into tg.  The triangle's
// row and the face it shows are detached.  Moller-Trumbore's distance tt =
// (e2 . qv) / det, qv = (ro - v0) x e1, det = (rd x e2) . e1, is
// differentiated step by step, as autograd takes the plain version's.
template <typename C>
__device__ void tri_adj(const float* m, const float4* t, const float* o, const float* d,
                        float time, const float* gp, const float* gn, const float* gq,
                        const Fx& tg, C& c) {
  float go[3];
  moved_origin(m, o, time, go);
  const float ro[3] = {m[12] * go[0] + m[13] * go[1] + m[14] * go[2] + m[15],
                       m[16] * go[0] + m[17] * go[1] + m[18] * go[2] + m[19],
                       m[20] * go[0] + m[21] * go[1] + m[22] * go[2] + m[23]};
  const float rdr[3] = {m[12] * d[0] + m[13] * d[1] + m[14] * d[2],
                        m[16] * d[0] + m[17] * d[1] + m[18] * d[2],
                        m[20] * d[0] + m[21] * d[1] + m[22] * d[2]};
  float rd[3] = {rdr[0], rdr[1], rdr[2]};
  normalize3(rd[0], rd[1], rd[2]);
  const float4 a = __ldg(t), b = __ldg(t + 1), cc = __ldg(t + 2);
  const float v0[3] = {a.x, a.y, a.z}, e1[3] = {a.w, b.x, b.y}, e2[3] = {b.z, b.w, cc.x};
  const float no[3] = {cc.y, cc.z, cc.w};
  float pv[3] = {0.f, 0.f, 0.f}, qv[3] = {0.f, 0.f, 0.f};
  cross_add(rd, e2, pv);
  const float inv_det = 1.f / (pv[0] * e1[0] + pv[1] * e1[1] + pv[2] * e1[2]);
  const float tv[3] = {ro[0] - v0[0], ro[1] - v0[1], ro[2] - v0[2]};
  cross_add(tv, e1, qv);
  const float s_qv = e2[0] * qv[0] + e2[1] * qv[1] + e2[2] * qv[2];
  const float tofs = s_qv * inv_det - kRayOffset;
  float q[3], nr[3];
  for (int k = 0; k < 3; ++k) q[k] = ro[k] + tofs * rd[k];
  const float flip = rd[0] * no[0] + rd[1] * no[1] + rd[2] * no[2] < 0.f ? 1.f : -1.f;
  for (int i = 0; i < 3; ++i)
    nr[i] = (m[24 + 3 * i] * no[0] + m[25 + 3 * i] * no[1] + m[26 + 3 * i] * no[2]) * flip;
  float g_q[3];
  point_adj(m, q, gp, gq, time, tg, g_q);
  // n = normalize(flip N n_obj), N the inverse-transpose rows
  float g_nr[3] = {gn[0], gn[1], gn[2]};
  normalize3_adj(nr[0], nr[1], nr[2], g_nr);
  for (int i = 0; i < 3; ++i)
    for (int j = 0; j < 3; ++j) gadd(tg + 24 + 3 * i + j, g_nr[i] * flip * no[j]);
  // q = ro + (tt - offset) rd
  const float g_tt = g_q[0] * rd[0] + g_q[1] * rd[1] + g_q[2] * rd[2];
  float g_ro[3], g_rd[3];
  for (int k = 0; k < 3; ++k) {
    g_ro[k] = g_q[k];
    g_rd[k] = tofs * g_q[k];
  }
  // tt = s_qv inv_det: qv = tv x e1 (tv = ro - v0), 1 / det, det = pv . e1,
  // pv = rd x e2
  const float g_s = g_tt * inv_det;
  const float g_det = -(g_tt * s_qv) * inv_det * inv_det;
  const float g_qv[3] = {g_s * e2[0], g_s * e2[1], g_s * e2[2]};
  const float g_pv[3] = {g_det * e1[0], g_det * e1[1], g_det * e1[2]};
  cross_add(e1, g_qv, g_ro);
  cross_add(e2, g_pv, g_rd);
  ray_adj(m, go, d, rdr, g_ro, g_rd, time, tg, c);
}

// The adjoint of bump_perturb (BUMP: the normal n0 tilted by the gradient of
// h = sin(w qx) sin(w qy) sin(w qz), w = 2 pi bs, through the
// inverse-transpose t): from the cotangent g_n of the tilted normal, adds
// into g_n0 (the geometric normal), g_q (the object-space point), gm (the
// geom's mats gradient row: bump scale 15, strength 16) and gt (its gmat
// gradient row from column 24).
__device__ void bump_adj(const float* n0, const float* q, float bs, float bk, const float* t,
                         const float* g_n, float* g_n0, float* g_q, const Fx& gm,
                         const Fx& gt) {
  const float w = bs * kTwoPi;
  const float ph = 0.5f;
  float sn[3], cs[3];
  for (int k = 0; k < 3; ++k) {
    sn[k] = sinf(w * q[k] + ph);
    cs[k] = cosf(w * q[k] + ph);
  }
  // the object-space gradient of h, then through t
  const float go[3] = {w * cs[0] * sn[1] * sn[2], w * sn[0] * cs[1] * sn[2],
                       w * sn[0] * sn[1] * cs[2]};
  float g[3];
  for (int i = 0; i < 3; ++i) g[i] = t[3 * i] * go[0] + t[3 * i + 1] * go[1] + t[3 * i + 2] * go[2];
  const float gdn = g[0] * n0[0] + g[1] * n0[1] + g[2] * n0[2];
  float tv[3], pr[3];
  for (int k = 0; k < 3; ++k) {
    tv[k] = g[k] - gdn * n0[k];
    pr[k] = n0[k] - bk * tv[k];
  }
  // n = normalize(n0 - bk (g - (g . n0) n0))
  float g_pr[3] = {g_n[0], g_n[1], g_n[2]};
  normalize3_adj(pr[0], pr[1], pr[2], g_pr);
  const float g_bk = -(g_pr[0] * tv[0] + g_pr[1] * tv[1] + g_pr[2] * tv[2]);
  float g_g[3];
  for (int k = 0; k < 3; ++k) {
    const float g_tv = -bk * g_pr[k];
    g_n0[k] += g_pr[k] - gdn * g_tv;
    g_g[k] = g_tv;
  }
  const float g_gdn = -(g_g[0] * n0[0] + g_g[1] * n0[1] + g_g[2] * n0[2]);
  float g_go[3] = {0.f, 0.f, 0.f};
  for (int k = 0; k < 3; ++k) {
    g_g[k] += g_gdn * n0[k];
    g_n0[k] += g_gdn * g[k];
  }
  for (int i = 0; i < 3; ++i)
    for (int j = 0; j < 3; ++j) {
      gadd(gt + 3 * i + j, g_g[i] * go[j]);
      g_go[j] += t[3 * i + j] * g_g[i];
    }
  // go = w (c0 s1 s2, s0 c1 s2, s0 s1 c2)
  float g_w = g_go[0] * cs[0] * sn[1] * sn[2] + g_go[1] * sn[0] * cs[1] * sn[2] +
              g_go[2] * sn[0] * sn[1] * cs[2];
  const float g_sn[3] = {w * (g_go[1] * cs[1] * sn[2] + g_go[2] * sn[1] * cs[2]),
                         w * (g_go[0] * cs[0] * sn[2] + g_go[2] * sn[0] * cs[2]),
                         w * (g_go[0] * cs[0] * sn[1] + g_go[1] * sn[0] * cs[1])};
  const float g_cs[3] = {w * g_go[0] * sn[1] * sn[2], w * g_go[1] * sn[0] * sn[2],
                         w * g_go[2] * sn[0] * sn[1]};
  for (int k = 0; k < 3; ++k) {
    // the phase w q + ph
    const float g_a = g_sn[k] * cs[k] - g_cs[k] * sn[k];
    g_w += g_a * q[k];
    g_q[k] += g_a * w;
  }
  gadd(gm + 15, g_w * kTwoPi);
  gadd(gm + 16, g_bk);
}

// The adjoint of imperfect_specular (the power-cosine lobe about the mirror
// direction mr, exponent m_ex > 0): from the cotangent g of the lobe's
// direction, writes the cotangent of mr into g_mr and adds the exponent's
// into ge (mats 6).
__device__ void spec_lobe_adj(float m_ex, const float* mr, float u_s1, float u_s2,
                              const float* g, float* g_mr, const Fx& ge) {
  const float n1 = 1.f / (m_ex + 1.f);
  const float base = fmaxf(u_s1, 1e-12f);
  const float cos_t = powf(base, n1);
  const float one_m = 1.f - cos_t * cos_t;
  const float sin_t = sqrtf(fmaxf(one_m, 0.f));
  const float phi = u_s2 * kTwoPi;
  const bool use_x = fabsf(mr[0]) < kSqrtThird;
  const bool use_y = !use_x && fabsf(mr[1]) < kSqrtThird;
  const float nm[3] = {use_x ? 1.f : 0.f, use_y ? 1.f : 0.f, (use_x || use_y) ? 0.f : 1.f};
  float c1[3] = {0.f, 0.f, 0.f};
  cross_add(mr, nm, c1);
  float q1[3] = {c1[0], c1[1], c1[2]};
  normalize3(q1[0], q1[1], q1[2]);
  float c2[3] = {0.f, 0.f, 0.f};
  cross_add(mr, q1, c2);
  float q2[3] = {c2[0], c2[1], c2[2]};
  normalize3(q2[0], q2[1], q2[2]);
  const float cp = cosf(phi), sp = sinf(phi);
  // out = cos_t mr + cp sin_t q1 + sp sin_t q2
  float g_cos = 0.f, g_q1d = 0.f, g_q2d = 0.f, g_q1[3], g_c2[3];
  for (int k = 0; k < 3; ++k) {
    g_mr[k] = cos_t * g[k];
    g_cos += g[k] * mr[k];
    g_q1d += g[k] * q1[k];
    g_q2d += g[k] * q2[k];
    g_q1[k] = cp * sin_t * g[k];
    g_c2[k] = sp * sin_t * g[k];
  }
  const float g_sin = cp * g_q1d + sp * g_q2d;
  // q2 = normalize(mr x q1), q1 = normalize(mr x nm)
  normalize3_adj(c2[0], c2[1], c2[2], g_c2);
  cross_add(q1, g_c2, g_mr);
  cross_add(g_c2, mr, g_q1);
  normalize3_adj(c1[0], c1[1], c1[2], g_q1);
  cross_add(nm, g_q1, g_mr);
  // sin_t = sqrt(max(1 - cos_t^2, 0)), cos_t = base^n1, n1 = 1 / (m + 1)
  if (one_m >= 0.f) g_cos += -2.f * cos_t * (g_sin * 0.5f / sin_t);
  const float g_n1 = g_cos * (cos_t * logf(base));
  gadd(ge, -g_n1 * (n1 * n1));
}

// The adjoint of nee_add at hit h (shading normal n, albedo row al, the
// path's throughput tr entering the bounce, shutter time `time`): for each
// light whose sample is seen, the gradient of ct . (tr * albedo * emission
// / pi * cos cos' / r^2 * area) to the throughput (g_t), the hit point
// (gp), the normal (gn), the albedo (ga: the albedo row's gradient entries)
// and the light's row.  Which samples were seen is the forward's shadow
// test, carried in vis (bit k: light k): no shadow ray is traced again.
__device__ void nee_adj(const float* tr, const Hit& h, const float* n, const float* al,
                        float time, uint32_t it, uint32_t pix, uint32_t dep, const Tables& s,
                        unsigned long long vis, const float* ct, float* g_t, float* gp,
                        float* gn, const Fx& ga, const GradTab& G) {
  for (int k = 0; k < s.n_lights; ++k) {
    if (!((vis >> k) & 1ull)) continue;  // not seen: no term
    const float* lr = s.lights + k * kLightCols;
    const Fx gl = G.lights + k * kLightCols;
    const uint32_t base = pt::kDrawNeeBase + 3u * static_cast<uint32_t>(k);
    const float u_sel = pt::uniform(it, pix, dep, base);
    const float u1 = pt::uniform(it, pix, dep, base + 1u);
    const float u2 = pt::uniform(it, pix, dep, base + 2u);
    const bool sphere = lr[1] == static_cast<float>(kSphere);
    float lp[3], ln[3], lnr[3] = {0.f, 0.f, 0.f}, w[3] = {0.f, 0.f, 0.f}, w_area, n_len = 0.f;
    float ss = 0.f, tt = 0.f;
    int f = 0;
    if (sphere) {
      const float z = 1.f - 2.f * u1;
      const float r = sqrtf(fmaxf(1.f - z * z, 0.f));
      const float phi = u2 * kTwoPi;
      w[0] = r * cosf(phi);
      w[1] = r * sinf(phi);
      w[2] = z;
      for (int i = 0; i < 3; ++i) {
        lp[i] = lr[12 + 3 * i] * (0.5f * w[0]) + lr[13 + 3 * i] * (0.5f * w[1]) +
                lr[14 + 3 * i] * (0.5f * w[2]) + lr[21 + i];
        lnr[i] = lr[24 + 3 * i] * w[0] + lr[25 + 3 * i] * w[1] + lr[26 + 3 * i] * w[2];
      }
      n_len = sqrtf(lnr[0] * lnr[0] + lnr[1] * lnr[1] + lnr[2] * lnr[2]);
      w_area = kPi * lr[33] * n_len;
      const float inv_nl = 1.f / n_len;
      for (int i = 0; i < 3; ++i) ln[i] = lnr[i] * inv_nl;
    } else {
      while (f < 5 && !(u_sel < lr[6 + f])) ++f;
      ss = u1 - 0.5f;
      tt = u2 - 0.5f;
      for (int i = 0; i < 3; ++i) {
        lp[i] = lr[12 + 3 * f + i] + ss * lr[30 + 3 * f + i] + tt * lr[48 + 3 * f + i];
        ln[i] = lr[66 + 3 * f + i];
      }
      w_area = lr[5];
    }
    if constexpr (kMotion) {
      // a moving light: the sample point at the ray's time
      for (int i = 0; i < 3; ++i) lp[i] = lp[i] + time * lr[120 + i];
    }
    const float wl[3] = {lp[0] - h.px, lp[1] - h.py, lp[2] - h.pz};
    const float r2 = wl[0] * wl[0] + wl[1] * wl[1] + wl[2] * wl[2];
    const float r2_safe = fmaxf(r2, 1e-8f);
    const float dist_l = sqrtf(fmaxf(r2, 1e-12f));
    const float inv_dl = 1.f / dist_l;
    const float sd[3] = {wl[0] * inv_dl, wl[1] * inv_dl, wl[2] * inv_dl};
    const float cs_raw = n[0] * sd[0] + n[1] * sd[1] + n[2] * sd[2];
    const float cl_raw = -(ln[0] * sd[0] + ln[1] * sd[1] + ln[2] * sd[2]);
    const float cos_s = fmaxf(cs_raw, 0.f), cos_l = fmaxf(cl_raw, 0.f);
    const float gterm = cos_s * cos_l / r2_safe * w_area;
    // rad_c += tr_c * albedo_c * (emission_c / pi) * gterm
    float g_g = 0.f;
    for (int c = 0; c < 3; ++c) {
      const float e = kInvPi * lr[2 + c];
      g_t[c] += ct[c] * al[c] * e * gterm;
      gadd(ga + c, ct[c] * tr[c] * e * gterm);
      gadd(gl + 2 + c, ct[c] * tr[c] * al[c] * gterm * kInvPi);
      g_g += ct[c] * tr[c] * al[c] * e;
    }
    // gterm = cos_s cos_l / r2_safe * area
    const float g_cs = cs_raw >= 0.f ? g_g * cos_l / r2_safe * w_area : 0.f;
    const float g_cl = cl_raw >= 0.f ? g_g * cos_s / r2_safe * w_area : 0.f;
    const float g_r2s = -g_g * (cos_s * cos_l) / (r2_safe * r2_safe) * w_area;
    const float g_area = g_g * (cos_s * cos_l / r2_safe);
    float g_sd[3], g_ln[3];
    for (int i = 0; i < 3; ++i) {
      gn[i] += g_cs * sd[i];
      g_sd[i] = g_cs * n[i] - g_cl * ln[i];
      g_ln[i] = -g_cl * sd[i];
    }
    // sd = wl / dist_l, dist_l = sqrt(max(r2, 1e-12)), r2_safe = max(r2, 1e-8)
    const float g_inv = g_sd[0] * wl[0] + g_sd[1] * wl[1] + g_sd[2] * wl[2];
    const float g_dist = -g_inv * inv_dl * inv_dl;
    float g_r2 = 0.f;
    if (r2 >= 1e-12f) g_r2 += g_dist * 0.5f / dist_l;
    if (r2 >= 1e-8f) g_r2 += g_r2s;
    float g_lp[3];
    for (int i = 0; i < 3; ++i) {
      g_lp[i] = g_sd[i] * inv_dl + 2.f * g_r2 * wl[i];
      gp[i] -= g_lp[i];
    }
    if constexpr (kMotion) {
      for (int i = 0; i < 3; ++i) gadd(gl + 120 + i, g_lp[i] * time);
    }
    if (sphere) {
      // lp = M (w / 2) + c; ln = normalize(N w); area = pi |det| |N w|
      for (int i = 0; i < 3; ++i) {
        for (int j = 0; j < 3; ++j) gadd(gl + 12 + 3 * i + j, g_lp[i] * (0.5f * w[j]));
        gadd(gl + 21 + i, g_lp[i]);
      }
      gadd(gl + 33, g_area * kPi * n_len);
      const float g_nl = g_area * (kPi * lr[33]);
      float g_lnr[3] = {g_ln[0], g_ln[1], g_ln[2]};
      normalize3_adj(lnr[0], lnr[1], lnr[2], g_lnr);
      for (int i = 0; i < 3; ++i) {
        g_lnr[i] += g_nl * ln[i];
        for (int j = 0; j < 3; ++j) gadd(gl + 24 + 3 * i + j, g_lnr[i] * w[j]);
      }
    } else {
      // face f: lp = origin + ss e_b + tt e_c, its normal, the total area
      for (int i = 0; i < 3; ++i) {
        gadd(gl + 12 + 3 * f + i, g_lp[i]);
        gadd(gl + 30 + 3 * f + i, ss * g_lp[i]);
        gadd(gl + 48 + 3 * f + i, tt * g_lp[i]);
        gadd(gl + 66 + 3 * f + i, g_ln[i]);
      }
      gadd(gl + 5, g_area);
    }
  }
}

// The hit of the winner of the bounce that started from sv at shutter time
// `time`, as the forward found it: the carried triangle's (tri_hit, whose
// row goes to *wt), else the carried primitive's own test (the fold over
// the one geom [g, g + 1), the fold's arithmetic; no other geom is tested
// and no mesh walked); geom -1 where the forward found none.
template <typename S, typename M>
__device__ __forceinline__ Hit winner_hit(const S& sv, float time, const Tables& s,
                                          const M& mesh, const float4** wt) {
  *wt = nullptr;
  if constexpr (kMesh) {
    if (sv.row >= 0) {
      *wt = mesh.tri + static_cast<long long>(kTriF4) * sv.row;
      return tri_hit<false>(s.gmat + sv.geom * kGeomCols, sv.geom, *wt, sv.row, sv.ox, sv.oy,
                            sv.oz, sv.dx, sv.dy, sv.dz, time);
    }
  }
  const int g = sv.geom;
  if (g < 0) {
    Hit h{};
    h.geom = -1;
    return h;
  }
  Hit h = nearest<false>(sv.ox, sv.oy, sv.oz, sv.dx, sv.dy, sv.dz, time, s.gmat + g * kGeomCols,
                         s.types + g, 1, M(nullptr, nullptr, nullptr, 0));
  h.geom += g;
  return h;
}

// The adjoint of the mirror d' = d - 2 (n . d) n: from g_dn, the
// cotangent of d', adds into c_d (of d) and gn (of n).
__device__ __forceinline__ void mirror_adj(const float* n, const float* dd, const float* g_dn,
                                           float* c_d, float* gn) {
  const float ndoti = n[0] * dd[0] + n[1] * dd[1] + n[2] * dd[2];
  const float gdn = g_dn[0] * n[0] + g_dn[1] * n[1] + g_dn[2] * n[2];
  for (int k = 0; k < 3; ++k) {
    c_d[k] += g_dn[k] - 2.f * n[k] * gdn;
    gn[k] += -2.f * dd[k] * gdn - 2.f * ndoti * g_dn[k];
  }
}

// The adjoint of bounce d on the state sv it started from (shutter time
// `time`): c holds the cotangents of the ray, the throughput (and the
// medium) the bounce handed on, and on return those of the ones it was
// given; table gradients go to G.  A path that was dead, missed or ended on
// a light hands its ray and throughput on unchanged.
template <typename S, typename C>
__device__ void bounce_adj(const S& sv, int d, uint32_t it, uint32_t pix, float time,
                           const Tables& s, const Mesh mesh, const float* ct, C& c,
                           const GradTab& G) {
  if (!sv.live) return;
  const float4* wt;
  const Hit h = winner_hit(sv, time, s, mesh, &wt);
  if (h.geom < 0) return;
  const float* mt = s.mats + h.geom * kMatCols;
  const float* gmr = s.gmat + h.geom * kGeomCols;
  const Fx gm = G.mats + h.geom * kMatCols;
  const Fx gg = G.gmat + h.geom * kGeomCols;
  const float tr[3] = {sv.tr, sv.tg, sv.tb};
  // the winner's albedo row (checker: mats 12..14 on odd cells) and
  // shading normal (bump), as bounce computes them
  int alb = 0;
  if constexpr (kChecker) {
    const float cs = mt[11];
    const float ph = 0.015625f;
    const float cells = floorf(h.qx * cs - ph) + floorf(h.qy * cs - ph) +
                        floorf(h.qz * cs - ph);
    if (cs > 0.f && cells - 2.f * floorf(cells * 0.5f) >= 1.f) alb = 12;
  }
  const float* al = mt + alb;
  const Fx ga = gm + alb;
  [[maybe_unused]] const float n0[3] = {h.nx, h.ny, h.nz};
  float n[3] = {h.nx, h.ny, h.nz};
  [[maybe_unused]] const bool bumped = kBump && mt[16] > 0.f;
  if constexpr (kBump) {
    if (bumped) bump_perturb(n[0], n[1], n[2], h.qx, h.qy, h.qz, mt[15], mt[16], gmr + 24);
  }
  const float emit = mt[10];
  if (emit > 0.f) {
    if (!kNee || sv.emit_ok) {
      // rad += tr * albedo * emit
      float g_e = 0.f;
      for (int k = 0; k < 3; ++k) {
        c.t[k] += ct[k] * al[k] * emit;
        gadd(ga + k, ct[k] * tr[k] * emit);
        g_e += ct[k] * tr[k] * al[k];
      }
      gadd(gm + 10, g_e);
    }
    return;
  }
  const uint32_t dep = static_cast<uint32_t>(d) + 1u;
  const float o[3] = {sv.ox, sv.oy, sv.oz};
  const float dd[3] = {sv.dx, sv.dy, sv.dz};
  if constexpr (kSss) {
    // inside a medium, a free path shorter than the surface scatters the
    // path there: o' = o + step d, d' a constant, t' = t * the medium's
    // albedo, step = -log(max(1 - u, 1e-7)) / max(sigma, 1e-8)
    const bool in_med = sv.med_s > 0.f;
    const float u_step = pt::uniform(it, pix, dep, pt::kDrawSssStep);
    const float m_s = fmaxf(sv.med_s, 1e-8f);
    const float sss_step = -logf(fmaxf(1.f - u_step, 1e-7f)) / m_s;
    if (in_med && sss_step < h.dist) {
      const float med[3] = {sv.med_r, sv.med_g, sv.med_b};
      float g_step = 0.f;
      for (int k = 0; k < 3; ++k) {
        c.m[k] += c.t[k] * tr[k];
        c.t[k] = c.t[k] * med[k];
        g_step += c.o[k] * dd[k];
        c.d[k] = sss_step * c.o[k];
      }
      if (sv.med_s >= 1e-8f) c.ms += -g_step * (sss_step / m_s);
      return;
    }
  }
  // what the bounce handed on: o' = the hit point (past it, refracted),
  // d' = the lobe's direction, t' = t * tint (/ p_safe)
  float gp[3] = {c.o[0], c.o[1], c.o[2]};
  float g_dn[3] = {c.d[0], c.d[1], c.d[2]};
  float gn[3] = {0.f, 0.f, 0.f}, g_t[3];
  for (int k = 0; k < 3; ++k) c.o[k] = c.d[k] = 0.f;
  if (kGlass && mt[8] > 0.f) {
    // Fresnel glass: the choice (Schlick's, or total internal reflection)
    // again, detached; no division by its probability
    const float ndoti = n[0] * dd[0] + n[1] * dd[1] + n[2] * dd[2];
    const float cos_i = fminf(fmaxf(-ndoti, 0.f), 1.f);
    const float ior = mt[9];
    const float r0b = (1.f - ior) / (1.f + ior);
    const float r0 = r0b * r0b;
    const float mm = fmaxf(1.f - cos_i, 0.f);
    const float refl_p = r0 + (1.f - r0) * mm * mm * mm * mm * mm;
    const float eta = h.outside ? 1.f / fmaxf(ior, 1e-6f) : ior;
    const float kk = 1.f - eta * eta * (1.f - ndoti * ndoti);
    const float u_fr = pt::uniform(it, pix, dep, pt::kDrawFresnel);
    const bool reflect = u_fr < refl_p || !(kk >= 0.f);
    const float* tint = reflect ? mt + 3 : al;
    const Fx gtint = reflect ? gm + 3 : ga;
    for (int k = 0; k < 3; ++k) {
      g_t[k] = c.t[k] * tint[k];
      gadd(gtint + k, c.t[k] * tr[k]);
    }
    if (reflect) {
      mirror_adj(n, dd, g_dn, c.d, gn);
    } else {
      // d' = eta d - (eta (n . d) + sqrt(kk)) n, and the origin pushed past
      // the interface: o' = p + push d'
      const float sqk = sqrtf(kk);
      const float aa = eta * ndoti + sqk;
      float rf[3], g_push = 0.f;
      for (int k = 0; k < 3; ++k) {
        rf[k] = eta * dd[k] - aa * n[k];
        g_push += gp[k] * rf[k];
        g_dn[k] += gmr[36] * gp[k];
      }
      gadd(gg + 36, g_push);
      float g_eta = 0.f, g_aa = 0.f;
      for (int k = 0; k < 3; ++k) {
        c.d[k] += eta * g_dn[k];
        g_eta += g_dn[k] * dd[k];
        g_aa -= g_dn[k] * n[k];
        gn[k] += -aa * g_dn[k];
      }
      g_eta += g_aa * ndoti;
      float g_ndoti = g_aa * eta;
      // kk = 1 - eta^2 (1 - ndoti^2)
      const float g_kk = g_aa * 0.5f / sqk;
      g_eta += 2.f * eta * (-g_kk * (1.f - ndoti * ndoti));
      g_ndoti += -2.f * ndoti * (-g_kk * (eta * eta));
      for (int k = 0; k < 3; ++k) {
        gn[k] += g_ndoti * dd[k];
        c.d[k] += g_ndoti * n[k];
      }
      // eta = 1 / max(ior, 1e-6) entering, ior leaving
      if (!h.outside) {
        gadd(gm + 9, g_eta);
      } else if (ior >= 1e-6f) {
        gadd(gm + 9, -g_eta * (eta * eta));
      }
    }
    if constexpr (kSss) {
      // the medium changes only at refractions: entering a geom with
      // sigma > 0 from outside (mats 17..20), or leaving from inside
      if (!reflect) {
        if (mt[17] > 0.f && h.outside) {
          gadd(gm + 17, c.ms);
          for (int k = 0; k < 3; ++k) gadd(gm + 18 + k, c.m[k]);
          c.ms = c.m[0] = c.m[1] = c.m[2] = 0.f;
        } else if (sv.med_s > 0.f && !h.outside) {
          c.ms = c.m[0] = c.m[1] = c.m[2] = 0.f;
        }
      }
    }
  } else {
    const float u_lobe = pt::uniform(it, pix, dep, pt::kDrawLobe);
    const float p_spec = fminf(fmaxf(mt[7], 0.f), 1.f);
    const bool take_spec = u_lobe < p_spec;
    const float sel = take_spec ? p_spec : 1.f - p_spec;
    const float p_safe = fmaxf(sel, 1e-8f);
    const float* tint = take_spec ? mt + 3 : al;
    const Fx gtint = take_spec ? gm + 3 : ga;
    float g_ps = 0.f;
    for (int k = 0; k < 3; ++k) {
      const float f = tint[k] / p_safe;
      const float g_f = c.t[k] * tr[k];
      g_t[k] = c.t[k] * f;
      gadd(gtint + k, g_f / p_safe);
      g_ps += -g_f * f / p_safe;
    }
    if (sel >= 1e-8f) {
      // p = clip(REFL, 0, 1), whose gradient the reference splits in half at
      // the ends (jnp.clip: a maximum, then a minimum)
      const float x = mt[7];
      const float part = (x > 0.f && x < 1.f) ? 1.f : (x == 0.f || x == 1.f) ? 0.5f : 0.f;
      gadd(gm + 7, part * (take_spec ? g_ps : -g_ps));
    }
    if (take_spec) {
      // d' = d - 2 (n . d) n, or the power-cosine lobe about it
      if constexpr (kImperfect) {
        if (mt[6] > 0.f) {
          const float ndoti = n[0] * dd[0] + n[1] * dd[1] + n[2] * dd[2];
          const float mr[3] = {dd[0] - 2.f * ndoti * n[0], dd[1] - 2.f * ndoti * n[1],
                               dd[2] - 2.f * ndoti * n[2]};
          const float g_out[3] = {g_dn[0], g_dn[1], g_dn[2]};
          spec_lobe_adj(mt[6], mr, pt::uniform(it, pix, dep, pt::kDrawSpecU1),
                        pt::uniform(it, pix, dep, pt::kDrawSpecU2), g_out, g_dn, gm + 6);
        }
      }
      mirror_adj(n, dd, g_dn, c.d, gn);
    } else {
      // d' = up n + cos(a) over p1 + sin(a) over p2 (the Peter-Kutz frame)
      const float u_d1 = pt::uniform(it, pix, dep, pt::kDrawDiffU1);
      const float u_d2 = pt::uniform(it, pix, dep, pt::kDrawDiffU2);
      const float up = sqrtf(u_d1);
      const float over = sqrtf(fmaxf(1.f - up * up, 0.f));
      const float around = u_d2 * kTwoPi;
      const bool use_x = fabsf(n[0]) < kSqrtThird;
      const bool use_y = !use_x && fabsf(n[1]) < kSqrtThird;
      const float nn[3] = {use_x ? 1.f : 0.f, use_y ? 1.f : 0.f, (use_x || use_y) ? 0.f : 1.f};
      float c1[3] = {0.f, 0.f, 0.f};
      cross_add(n, nn, c1);
      float p1[3] = {c1[0], c1[1], c1[2]};
      normalize3(p1[0], p1[1], p1[2]);
      float c2[3] = {0.f, 0.f, 0.f};
      cross_add(n, p1, c2);
      const float ca = cosf(around), sa = sinf(around);
      float g_p1[3], g_c2[3];
      for (int k = 0; k < 3; ++k) {
        gn[k] += up * g_dn[k];
        g_p1[k] = ca * over * g_dn[k];
        g_c2[k] = sa * over * g_dn[k];
      }
      // p2 = normalize(n x p1), p1 = normalize(n x nn)
      normalize3_adj(c2[0], c2[1], c2[2], g_c2);
      cross_add(p1, g_c2, gn);
      cross_add(g_c2, n, g_p1);
      normalize3_adj(c1[0], c1[1], c1[2], g_p1);
      cross_add(nn, g_p1, gn);
    }
  }
  if constexpr (kNee) {
    if (!(mt[8] > 0.f))
      nee_adj(tr, h, n, al, time, it, pix, dep, s, sv.vis, ct, g_t, gp, gn, ga, G);
  }
  for (int k = 0; k < 3; ++k) c.t[k] = g_t[k];
  // the hit's adjoint from the cotangents of its point and normal: where
  // both are zero (every bounce without NEE, whose radiance the geometry
  // does not move), each of its terms is zero and adds nothing, so it is
  // skipped (a NaN cotangent is not zero, and is carried)
  if (gp[0] == 0.f && gp[1] == 0.f && gp[2] == 0.f && gn[0] == 0.f && gn[1] == 0.f &&
      gn[2] == 0.f)
    return;
  [[maybe_unused]] float gq[3] = {0.f, 0.f, 0.f};
  if constexpr (kBump) {
    if (bumped) {
      // the tilted normal's cotangent to the geometric normal and the point
      const float q[3] = {h.qx, h.qy, h.qz};
      float g_n0[3] = {0.f, 0.f, 0.f};
      bump_adj(n0, q, mt[15], mt[16], gmr + 24, gn, g_n0, gq, gm, gg + 24);
      for (int k = 0; k < 3; ++k) gn[k] = g_n0[k];
    }
  }
  if (wt != nullptr) {
    tri_adj(gmr, wt, o, dd, time, gp, gn, gq, gg, c);
  } else {
    hit_adj(gmr, s.types[h.geom], o, dd, time, gp, gn, gq, gg, c);
  }
}

// 7 blocks an SM: at most 72 registers a thread (the rest spill to local
// memory), a latency-bound sweep's trade (PERF.md section 5)
__global__ void __launch_bounds__(kBlock, 7)
k8_vjp(const float* __restrict__ cam_g, const float* __restrict__ mats_g,
       const float* __restrict__ gmat_g, const int* __restrict__ types_g,
       const float* __restrict__ lights_g, const float4* __restrict__ tri_g,
       const float4* __restrict__ nodes_g, const int* __restrict__ meta_g, int n_geoms,
       int n_lights, int n_meta, int width, int height, int depth, uint32_t it0, int n_spp,
       const float* __restrict__ ct, float* __restrict__ rad,
       unsigned long long* __restrict__ gtab, size_t grad_off) {
  // shared: the tables, and at byte grad_off (tables_smem) the block's
  // gradient table
  extern __shared__ unsigned long long smem[];
  const Tables s = stage_tables(smem, 0, cam_g, mats_g, gmat_g, types_g, lights_g, meta_g,
                                nullptr, n_geoms, n_lights, n_meta);
  unsigned* s_grad = reinterpret_cast<unsigned*>(reinterpret_cast<char*>(smem) + grad_off);
  const int n_tab = kCamCols + n_geoms * (kMatCols + kGeomCols) + n_lights * kLightCols;
  for (int i = threadIdx.x; i < fx_smem_words(n_tab); i += kBlock) s_grad[i] = 0u;
  const Fx tab{s_grad, n_tab, 0};
  const GradTab G{tab, tab + kCamCols, tab + (kCamCols + n_geoms * kMatCols),
                  tab + (kCamCols + n_geoms * (kMatCols + kGeomCols))};
  const Mesh mesh(tri_g, nodes_g, s.meta, n_meta);
  const Tex tex(nullptr);
  __syncthreads();

  const long long idx = static_cast<long long>(blockIdx.x) * kBlock + threadIdx.x;
  const bool valid = idx < static_cast<long long>(width) * height;
  const uint32_t pix_u = static_cast<uint32_t>(idx);
  const float fx = static_cast<float>(idx % width);
  const float fy = static_cast<float>(idx / width);
  const float sx_scale = static_cast<float>(2.0 / width);
  const float sy_scale = static_cast<float>(2.0 / height);
  const Camera cam = load_camera(s.cam);
  float ctp[3] = {0.f, 0.f, 0.f};
  if (valid) {
    for (int k = 0; k < 3; ++k) ctp[k] = ct[3 * idx + k];
  }
  // raygen's gradient, summed over the samples: pos, view, right, up, tan
  // (and the lens: aperture, focal distance)
  float g_cam[kCamGrads];
  for (int k = 0; k < kCamGrads; ++k) g_cam[k] = 0.f;

  float acc_r = 0.f, acc_g = 0.f, acc_b = 0.f;
  Saved saved[kVjpMaxDepth];
  for (int sample = 0; sample < n_spp; ++sample) {
    const uint32_t it = it0 + static_cast<uint32_t>(sample);
    // the forward sweep: K1's, keeping the state entering each bounce
    PathState p;
    init_state(p, cam, s.cam, it, pix_u, fx, fy, sx_scale, sy_scale, valid);
    for (int d = 0; d < depth; ++d) {
      keep_state(saved[d], p);
      bounce(p, d, it, pix_u, s, mesh, tex);
      keep_found(saved[d], p);
    }
    acc_r = acc_r + p.rr;
    acc_g = acc_g + p.rg;
    acc_b = acc_b + p.rb;
    if (valid) {
      // the reverse sweep: the final ray and throughput reach nothing
      const float time = kMotion ? pt::uniform(it, pix_u, 0u, pt::kDrawTime) : 0.f;
      Cot c{};
      for (int d = depth - 1; d >= 0; --d)
        bounce_adj(saved[d], d, it, pix_u, time, s, mesh, ctp, c, G);
      // raygen: o = pos, d = normalize(view - right tan_x sx - up tan_y sy)
      const float ujx = pt::uniform(it, pix_u, 0u, pt::kDrawAaX);
      const float ujy = pt::uniform(it, pix_u, 0u, pt::kDrawAaY);
      const float sx = (fx + ujx) * sx_scale - 1.f;
      const float sy = (fy + ujy) * sy_scale - 1.f;
      const float ax = cam.tan_x * sx, ay = cam.tan_y * sy;
      const float v[3] = {cam.v_x, cam.v_y, cam.v_z};
      const float r[3] = {cam.r_x, cam.r_y, cam.r_z}, u[3] = {cam.u_x, cam.u_y, cam.u_z};
      const float raw[3] = {v[0] - r[0] * ax - u[0] * ay, v[1] - r[1] * ax - u[1] * ay,
                            v[2] - r[2] * ax - u[2] * ay};
      float g_d[3] = {c.d[0], c.d[1], c.d[2]};
      if constexpr (kDof) {
        const float aperture = s.cam[14], focal = s.cam[15];
        if (aperture > 0.f) {
          // the thin lens: o = pos + off, d = normalize(pf - o), pf = pos +
          // dn ft, ft = focal / max(dn . view, 1e-6), off = right lc + up ls,
          // (lc, ls) = aperture sqrt(u1) (cos, sin)(2 pi u2)
          float dn[3] = {raw[0], raw[1], raw[2]};
          normalize3(dn[0], dn[1], dn[2]);
          const float sq1 = sqrtf(pt::uniform(it, pix_u, 0u, pt::kDrawDofU));
          const float theta = pt::uniform(it, pix_u, 0u, pt::kDrawDofV) * kTwoPi;
          const float r_lens = aperture * sq1;
          const float cth = cosf(theta), sth = sinf(theta);
          const float lc = r_lens * cth, ls = r_lens * sth;
          const float cos_v = dn[0] * v[0] + dn[1] * v[1] + dn[2] * v[2];
          const float cvc = fmaxf(cos_v, 1e-6f);
          const float ft = focal / cvc;
          const float pos[3] = {cam.pos_x, cam.pos_y, cam.pos_z};
          float wv[3];
          for (int k = 0; k < 3; ++k) {
            const float pf = pos[k] + dn[k] * ft;
            const float ok = pos[k] + (r[k] * lc + u[k] * ls);
            wv[k] = pf - ok;
          }
          float g_w[3] = {c.d[0], c.d[1], c.d[2]};
          normalize3_adj(wv[0], wv[1], wv[2], g_w);
          float g_ft = 0.f, g_lc = 0.f, g_ls = 0.f;
          for (int k = 0; k < 3; ++k) {
            const float g_off = c.o[k] - g_w[k];
            g_cam[k] += c.o[k];  // pos: through o and pf
            g_cam[6 + k] += g_off * lc;
            g_cam[9 + k] += g_off * ls;
            g_lc += g_off * r[k];
            g_ls += g_off * u[k];
            g_ft += g_w[k] * dn[k];
            g_d[k] = g_w[k] * ft;
          }
          g_cam[15] += g_ft / cvc;
          const float g_cos = cos_v >= 1e-6f ? -g_ft * (ft / cvc) : 0.f;
          for (int k = 0; k < 3; ++k) {
            g_d[k] += g_cos * v[k];
            g_cam[3 + k] += g_cos * dn[k];
          }
          g_cam[14] += (g_lc * cth + g_ls * sth) * sq1;
          for (int k = 0; k < 3; ++k) c.o[k] = 0.f;  // taken above
        }
      }
      normalize3_adj(raw[0], raw[1], raw[2], g_d);
      for (int k = 0; k < 3; ++k) {
        g_cam[k] += c.o[k];
        g_cam[3 + k] += g_d[k];
        g_cam[6 + k] += -g_d[k] * ax;
        g_cam[9 + k] += -g_d[k] * ay;
        g_cam[12] += -sx * (g_d[k] * r[k]);
        g_cam[13] += -sy * (g_d[k] * u[k]);
      }
    }
    __syncthreads();
    fx_flush(s_grad, n_tab, gtab);
    __syncthreads();
  }
  if (valid) {
    rad[3 * idx + 0] = acc_r;
    rad[3 * idx + 1] = acc_g;
    rad[3 * idx + 2] = acc_b;
    for (int k = 0; k < kCamGrads; ++k) gadd(G.cam + k, g_cam[k]);
  }
  __syncthreads();
  fx_flush(s_grad, n_tab, gtab);
}
#endif  // PT_VJP

}  // namespace

// The compile-time feature set this library was built for (PT_FEATURES).
extern "C" int pt_k1_features() { return static_cast<int>(kFeatures); }

#if !PT_GRAD && !PT_VJP
// Launches K1 on `stream` over pixels pix0 .. pix0+n_local-1: n_spp samples
// each, iterations it0 .. it0+n_spp-1.  `lights` (n_lights, 128) is read by
// a library built with NEE, which needs n_lights > 0; the others need 0.
// `tri` (T, 16; T, 24 in the texture builds), `nodes` (N, 16) (16-byte
// aligned) and `meta` (n_meta, 5) are read by a library built for meshes;
// the others need n_meta = 0.  `texels` (n_texels uint32 words) and
// `charts` (n_geoms, 6) are read by a library built for textures, which
// needs n_texels > 0; the others need 0.
// rad (n_local,3) float32 is written; counts, the live paths entering each
// bounce, (n_spp, depth) with per_sample (each sample's) or else (depth,)
// (summed over the samples), must be zeroed by the caller and is added
// into.  Returns the cudaError_t of the launch (0 = success).
extern "C" int pt_k1_trace(const float* cam, const float* mats,
                           const float* gmat, const int* geom_types,
                           const float* lights, const float* tri,
                           const float* nodes, const int* meta,
                           const unsigned int* texels, const int* charts, int n_geoms,
                           int n_lights, int n_meta, long long n_texels, int width, int height,
                           int depth, unsigned int it0, int n_spp,
                           long long pix0, long long n_local, float* rad,
                           unsigned long long* counts, int per_sample, void* stream) {
  if (kNee != (n_lights > 0) || n_lights < 0 || n_meta < 0 || (!kMesh && n_meta > 0) ||
      kTexAny != (n_texels > 0) || n_texels < 0 || depth <= 0 || n_spp < 0 || pix0 < 0 ||
      n_local <= 0 || pix0 + n_local > static_cast<long long>(width) * height)
    return static_cast<int>(cudaErrorInvalidValue);
  const auto kernel = per_sample ? k1_trace<true> : k1_trace<false>;
  const int rows = k1_count_rows(per_sample, k1_count_chunk(per_sample, n_spp, depth), depth);
  const size_t smem = tables_smem(k1_count_slots(rows), n_geoms, n_lights, n_meta);
  if (smem > 48 * 1024) {
    const cudaError_t e = cudaFuncSetAttribute(
        kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, static_cast<int>(smem));
    if (e != cudaSuccess) return static_cast<int>(e);
  }
  // the pool a block takes, from the blocks the card keeps resident
  int dev = 0, sms = 0, per_sm = 0;
  cudaError_t e = cudaGetDevice(&dev);
  if (e == cudaSuccess) e = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  if (e == cudaSuccess)
    e = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, kernel, kBlock, smem);
  if (e != cudaSuccess) return static_cast<int>(e);
  const int lane_px = k1_lane_pixels(n_local, static_cast<long long>(sms) * per_sm);
  const long long per_block = static_cast<long long>(kBlock) * lane_px;
  const long long blocks = (n_local + per_block - 1) / per_block;
  if (blocks <= 0 || blocks > 0x7fffffffLL) return static_cast<int>(cudaErrorInvalidValue);
  kernel<<<static_cast<unsigned>(blocks), kBlock, smem, static_cast<cudaStream_t>(stream)>>>(
      cam, mats, gmat, geom_types, lights, reinterpret_cast<const float4*>(tri),
      reinterpret_cast<const float4*>(nodes), meta, texels, charts, n_geoms, n_lights, n_meta,
      width, height, depth, it0, n_spp, pix0, n_local, lane_px, rad, counts);
  return static_cast<int>(cudaGetLastError());
}

// The number of state planes K5 of this build carries (state_keys).
extern "C" int pt_k5_state_keys() { return kStateKeys; }

// Launches K5 on `stream`: bounces [d0, d1) of iteration `it` on the state
// planes `state` ((n_keys, n_rays) float32; n_keys is kStateKeys, plus the
// pixel id plane at pix_key = kStateKeys for the sorted engine, else
// pix_key = -1), in place.  The tables as pt_k1_trace's; n_rays is the
// image's width * height.  One block per kBlock slots; with `tbl` (n_tiles
// int32 tile ids, and `n_live`, one int32 on the card) block b traces tile
// tbl[b] while b < *n_live; with `n_live` alone (d0 > 0: the live rays are
// the first *n_live slots) the blocks past it exit.  `live_out` (one int32
// on the card, or null) gets the paths live at the span's end added.
// depth bounds d1; counts (depth,) is added into at the absolute bounce.
// Returns the cudaError_t of the launch (0 = success).
extern "C" int pt_k5_span(const float* cam, const float* mats, const float* gmat,
                          const int* geom_types, const float* lights, const float* tri,
                          const float* nodes, const int* meta, const unsigned int* texels,
                          const int* charts, int n_geoms, int n_lights, int n_meta,
                          long long n_texels, int width, int height, float* state, int n_keys,
                          int pix_key, long long n_rays, const int* tbl, const int* n_live,
                          long long n_tiles, int* live_out, int d0, int d1, int depth,
                          unsigned int it, unsigned long long* counts, void* stream) {
  if (kNee != (n_lights > 0) || n_lights < 0 || n_meta < 0 || (!kMesh && n_meta > 0) ||
      kTexAny != (n_texels > 0) || n_texels < 0 ||
      n_keys != kStateKeys + (pix_key >= 0 ? 1 : 0) || (pix_key >= 0 && pix_key != kStateKeys) ||
      n_rays != static_cast<long long>(width) * height || n_rays <= 0 ||
      !(0 <= d0 && d0 < d1 && d1 <= depth) || (tbl != nullptr && n_live == nullptr) ||
      (tbl != nullptr && (pix_key >= 0 || n_tiles != (n_rays + kBlock - 1) / kBlock)) ||
      (tbl == nullptr && n_live != nullptr && d0 == 0))
    return static_cast<int>(cudaErrorInvalidValue);
  const size_t smem = tables_smem(d1 - d0, n_geoms, n_lights, n_meta);
  if (smem > 48 * 1024) {
    const cudaError_t e = cudaFuncSetAttribute(
        k5_span, cudaFuncAttributeMaxDynamicSharedMemorySize, static_cast<int>(smem));
    if (e != cudaSuccess) return static_cast<int>(e);
  }
  const long long blocks = (n_rays + kBlock - 1) / kBlock;
  if (blocks > 0x7fffffffLL) return static_cast<int>(cudaErrorInvalidValue);
  k5_span<<<static_cast<unsigned>(blocks), kBlock, smem, static_cast<cudaStream_t>(stream)>>>(
      cam, mats, gmat, geom_types, lights, reinterpret_cast<const float4*>(tri),
      reinterpret_cast<const float4*>(nodes), meta, texels, charts, n_geoms, n_lights, n_meta,
      width, height, state, n_rays, pix_key, tbl, n_live, blocks, live_out, d0, d1, depth, it,
      counts);
  return static_cast<int>(cudaGetLastError());
}
#endif  // !PT_GRAD && !PT_VJP

#if PT_GRAD || PT_VJP
// Rounds the exact table of n entries `table` (pt_fx_words(n) 64-bit
// words) to out (n,) float32, on `stream`.  Returns the cudaError_t of the
// launch.
extern "C" int pt_fx_round(const unsigned long long* table, int n, float* out, void* stream) {
  if (n <= 0) return static_cast<int>(cudaErrorInvalidValue);
  fx_round<<<(n + kBlock - 1) / kBlock, kBlock, 0, static_cast<cudaStream_t>(stream)>>>(table, n,
                                                                                       out);
  return static_cast<int>(cudaGetLastError());
}

// The 64-bit words of an exact gradient table of n entries (fx_words).
extern "C" int pt_fx_words(int n) { return fx_words(n); }
#endif

#if PT_GRAD
// Launches K7 on `stream` over the whole image: n_spp samples, iterations
// it0 ..; the scene tables as pt_k1_trace's (no lights, textures or RR: the
// build must have none), mtab (n_mats, 8) each material's color, spec_color,
// emittance, has_reflective, mat_of (n_geoms) each geom's material, ct
// (P, 3) the cotangent.  A block adds its gradients into the global table
// after at most flush_paths paths (flush_paths x depth < 2^19, and at
// least one sample of its pool).  Writes rad (P, 3), adds the live counts
// into counts (depth,) and the gradients into gtab, the exact (8, n_mats)
// table (pt_fx_words(8 n_mats) words, zeroed by the caller), which
// pt_fx_round rounds.  Returns the cudaError_t of the launch.
extern "C" int pt_k7_grads(const float* cam, const float* mats, const float* gmat,
                           const int* geom_types, const float* lights, const float* tri,
                           const float* nodes, const int* meta, const unsigned int* texels,
                           const int* charts, int n_geoms, int n_lights, int n_meta,
                           long long n_texels, int width, int height, int depth, unsigned int it0,
                           int n_spp, int flush_paths, const float* mtab, const int* mat_of,
                           int n_mats, const float* ct, float* rad, unsigned long long* counts,
                           unsigned long long* gtab, void* stream) {
  const long long n_pix = static_cast<long long>(width) * height;
  if (kNee || kRr || kTexAny || n_lights != 0 || n_texels != 0 || n_meta < 0 ||
      (!kMesh && n_meta > 0) || !(0 < depth && depth < 64) || !(0 < n_mats && n_mats <= 128) ||
      n_pix <= 0 || n_spp < 0 || flush_paths <= 0 ||
      static_cast<long long>(flush_paths) * depth >= kFxLimbDigits)
    return static_cast<int>(cudaErrorInvalidValue);
  const size_t grad_off =
      grad_smem_offset(tables_smem(k1_count_slots(depth), n_geoms, n_lights, n_meta));
  const size_t smem = grad_off + sizeof(unsigned) * fx_smem_words(kGradRows * n_mats);
  if (smem > 48 * 1024) {
    const cudaError_t e = cudaFuncSetAttribute(
        k7_grads, cudaFuncAttributeMaxDynamicSharedMemorySize, static_cast<int>(smem));
    if (e != cudaSuccess) return static_cast<int>(e);
  }
  // the pool a block takes, from the blocks the card keeps resident (K1's
  // rule), and the samples a flush
  int dev = 0, sms = 0, per_sm = 0;
  cudaError_t e = cudaGetDevice(&dev);
  if (e == cudaSuccess) e = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  if (e == cudaSuccess)
    e = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, k7_grads, kBlock, smem);
  if (e != cudaSuccess) return static_cast<int>(e);
  const int lane_px = k1_lane_pixels(n_pix, static_cast<long long>(sms) * per_sm);
  const int chunk = k7_chunk(flush_paths, lane_px);
  const long long per_block = static_cast<long long>(kBlock) * lane_px;
  const long long blocks = (n_pix + per_block - 1) / per_block;
  if (chunk <= 0 || blocks <= 0 || blocks > 0x7fffffffLL)
    return static_cast<int>(cudaErrorInvalidValue);
  k7_grads<<<static_cast<unsigned>(blocks), kBlock, smem, static_cast<cudaStream_t>(stream)>>>(
      cam, mats, gmat, geom_types, lights, reinterpret_cast<const float4*>(tri),
      reinterpret_cast<const float4*>(nodes), meta, texels, charts, n_geoms, n_lights, n_meta,
      width, height, depth, it0, n_spp, lane_px, chunk, mtab, mat_of, n_mats, ct, rad, counts,
      gtab, grad_off);
  return static_cast<int>(cudaGetLastError());
}
#endif

#if PT_VJP
// Launches K8 on `stream` over the whole image: n_spp samples, iterations
// it0 ..; cam, mats, gmat, geom_types as pt_k1_trace's, lights (n_lights
// <= 64, 128) with NEE (this build's), tri, nodes and meta (n_meta
// entries; the BVH's) as pt_k1_trace's in the mesh builds, ct (P, 3) the
// cotangent.
// Writes rad (P, 3) and adds the gradients into gtab, the exact table of n
// = 16 + 64 n_geoms + 128 n_lights entries (cam, mats, gmat, lights;
// pt_fx_words(n) words, zeroed by the caller), which pt_fx_round rounds.
// Returns the cudaError_t of the launch.
extern "C" int pt_k8_vjp(const float* cam, const float* mats, const float* gmat,
                         const int* geom_types, const float* lights, const float* tri,
                         const float* nodes, const int* meta, int n_geoms, int n_lights,
                         int n_meta, int width, int height, int depth, unsigned int it0,
                         int n_spp, const float* ct, float* rad, unsigned long long* gtab,
                         void* stream) {
  const long long n_pix = static_cast<long long>(width) * height;
  const long long blocks = (n_pix + kBlock - 1) / kBlock;
  if (kNee != (n_lights > 0) || n_lights < 0 || n_lights > kFxMaxLights || n_geoms <= 0 ||
      n_meta < 0 || (!kMesh && n_meta > 0) || !(0 < depth && depth <= kVjpMaxDepth) ||
      blocks <= 0 || blocks > 0x7fffffffLL)
    return static_cast<int>(cudaErrorInvalidValue);
  const int n_tab = kCamCols + n_geoms * (kMatCols + kGeomCols) + n_lights * kLightCols;
  const size_t grad_off = grad_smem_offset(tables_smem(0, n_geoms, n_lights, n_meta));
  const size_t smem = grad_off + sizeof(unsigned) * fx_smem_words(n_tab);
  if (smem > 48 * 1024) {
    const cudaError_t e = cudaFuncSetAttribute(
        k8_vjp, cudaFuncAttributeMaxDynamicSharedMemorySize, static_cast<int>(smem));
    if (e != cudaSuccess) return static_cast<int>(e);
  }
  k8_vjp<<<static_cast<unsigned>(blocks), kBlock, smem, static_cast<cudaStream_t>(stream)>>>(
      cam, mats, gmat, geom_types, lights, reinterpret_cast<const float4*>(tri),
      reinterpret_cast<const float4*>(nodes), meta, n_geoms, n_lights, n_meta, width, height,
      depth, it0, n_spp, ct, rad, gtab, grad_off);
  return static_cast<int>(cudaGetLastError());
}
#endif

extern "C" const char* pt_cuda_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}
