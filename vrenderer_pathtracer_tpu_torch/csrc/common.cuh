// Device code shared by the kernels K1 (radiance.cu), K2 (grad.cu) and K4
// (mesh.cu): the threefry-2x32 draw stream, the FMA-guarded primary ray and
// running-min sphere test, the sphere table's staging, the material scatter
// of one bounce (shade, K4's), and the Cornell bounce loop of one sample
// (trace).  K1 and K2 trace with this one loop, so K2's forward pass
// computes what K1 renders; K4 runs its own loop over the same pieces.
//
// Numerics.  Built without --use_fast_math: IEEE sqrt and division.  The
// sphere test and the primary ray use explicit round-to-nearest intrinsics
// (__fmul_rn/__fadd_rn), which nvcc never contracts into FMAs.  The walls are
// r = 1e5 spheres, and det = b^2 - |op|^2 + r^2 cancels 1e10-sized squares
// with about 1e3 of absolute float32 noise, so a contracted FMA there flips
// hit/miss on grazing rays against the plain PyTorch version.  Everywhere
// else nvcc may contract.
//
// The Cornell loop (trace) skips work that cannot change its result:
//   (a) a hit's slot-0 draw and its powf run only where the row is DIFF
//       with spec[0] != 0.  Elsewhere the Fresnel probability is 0 (or NaN),
//       u_reflect < p is false whatever the draw, and K2's score gradient,
//       which needs p in [1e-6, 1 - 1e-6], is 0.  Slot 1 is drawn as before;
//   (b) bounce 0's nearest sphere, hit point, normal, cosine frame and
//       Fresnel probability are computed once per pixel (first_surface; K2
//       keeps only the sphere loop's winner): the primary ray has a fixed
//       sub-pixel offset, so they are the same for every sample.
// Both leave every output bit-identical to the parent design's loop
// (radiance.cu's trace_parent), arithmetic for arithmetic: chip_smoke.py
// holds K1's two images to each other bit for bit in a build without FMA
// contraction (-fmad=false).  That shows the cuts exact at the source
// level, not for the shipped binary: with contraction on, nvcc fuses a few
// multiply-adds of the two loops differently (the mirror branch's
// normalisation), a few elements in a million differ in their last bits,
// and chip_smoke.py bounds how many.  The inexact cuts (the bits below)
// change roundings only.  kCornellFast holds those that made K1 or K2
// faster on the card and neither slower: cornell_cuts.py times each mix (a
// build with -DVPT_CORNELL_FAST=<bits>) in turns.  On an H100 one
// reciprocal a normalisation took 17% off both; sincospif and exp2 took
// 2.1% and 1.5% off K2 (4.1% together, each beyond the turns' spread) and
// left K1 within it (PERF.md).

#pragma once

#include <cuda_runtime.h>
#include <stdint.h>

namespace vpt {

constexpr float kInf = 1e20f;
constexpr float kSphereEps = 1e-4f;
constexpr float kOriginOffset = 0.05f;
constexpr float kTwoPi = 6.283185307179586f;
constexpr int kCols = 14;  // pos xyz, radius, color rgb, emission rgb, spec rgb, refl
constexpr int kSpec = 0;
constexpr int kDiff = 1;
constexpr int kBrdf = 2;
// Spheres staged in shared memory (render/cuda_radiance.py SMEM_SPHERES):
// 512 x 56 bytes sits inside the 48 KB a block takes without opting in.
constexpr int kSmemSpheres = 512;

__device__ __forceinline__ uint32_t rotl32(uint32_t x, int r) {
  return (x << r) | (x >> (32 - r));
}

// Threefry-2x32, 20 rounds (core/rng.py): bit-identical to the JAX stream.
__device__ __forceinline__ void threefry2x32(uint32_t k0, uint32_t k1,
                                             uint32_t& x0, uint32_t& x1) {
  const uint32_t k2 = 0x1BD11BDAu ^ k0 ^ k1;
#define TF_R(r) { x0 += x1; x1 = rotl32(x1, r) ^ x0; }
#define TF_A TF_R(13) TF_R(15) TF_R(26) TF_R(6)
#define TF_B TF_R(17) TF_R(29) TF_R(16) TF_R(24)
  x0 += k0; x1 += k1;
  TF_A x0 += k1; x1 += k2 + 1u;
  TF_B x0 += k2; x1 += k0 + 2u;
  TF_A x0 += k0; x1 += k1 + 3u;
  TF_B x0 += k1; x1 += k2 + 4u;
  TF_A x0 += k2; x1 += k0 + 5u;
#undef TF_B
#undef TF_A
#undef TF_R
}

// Top 24 bits -> float32 in [0, 1), exactly as core/rng.py does.
__device__ __forceinline__ float to_unit(uint32_t bits) {
  return static_cast<float>(bits >> 8) * 5.9604644775390625e-08f;  // 2^-24
}

// Draw stream (core/rng.py::make_stream): the counter word packs frame,
// bounce and slot; the sample id salts the key.  Returns both words of one
// threefry block for this pixel.
__device__ __forceinline__ void draw(uint32_t seed_lo, uint32_t seed_hi,
                                     uint32_t pixel, uint32_t frame,
                                     uint32_t sample, uint32_t bounce,
                                     uint32_t slot, float& a, float& b) {
  uint32_t x0 = pixel;
  uint32_t x1 = (frame << 7) ^ (bounce << 2) ^ slot;
  threefry2x32(seed_lo ^ (sample * 0x9E3779B9u), seed_hi, x0, x1);
  a = to_unit(x0);
  b = to_unit(x1);
}

__device__ __forceinline__ float dot_rn(float ax, float ay, float az,
                                        float bx, float by, float bz) {
  return __fadd_rn(__fadd_rn(__fmul_rn(ax, bx), __fmul_rn(ay, by)),
                   __fmul_rn(az, bz));
}

// Inexact cuts of the Cornell loop (template bits kFast; 0 is the exact
// code, which K4 runs).
constexpr unsigned kRcpNormalize = 1u;  // one reciprocal, not three divisions
constexpr unsigned kSinCosPi = 2u;      // sincospif(2u) for sincosf(2 pi u)
constexpr unsigned kExp2Pow = 4u;       // exp2f(p * log2f(x)) for powf(x, p)

// x / max(|x|, 1e-20), the plain version's normalisation; returns the
// divisor.
template <unsigned kFast = 0>
__device__ __forceinline__ float normalize(float& x, float& y, float& z) {
  const float len = fmaxf(sqrtf(x * x + y * y + z * z), 1e-20f);
  if constexpr ((kFast & kRcpNormalize) != 0) {
    const float inv = 1.f / len;
    x *= inv;
    y *= inv;
    z *= inv;
  } else {
    x = x / len;
    y = y / len;
    z = z / len;
  }
  return len;
}

// Primary ray of `pixel` (fixed 0.25 sub-pixel offset): d = view + u*cx +
// v*cy, normalised.  cam = origin, view dir, cx, cy, ...  Returns |d| before
// normalising; u and v are the pixel's screen coordinates.
__device__ __forceinline__ float primary_ray(const float* cam, int pixel,
                                             int width, int height,
                                             float& u, float& v, float& dx,
                                             float& dy, float& dz) {
  u = __fsub_rn(__fdiv_rn(__fadd_rn(0.25f, static_cast<float>(pixel % width)),
                          static_cast<float>(width)), 0.5f);
  v = __fsub_rn(__fdiv_rn(__fadd_rn(0.25f, static_cast<float>(pixel / width)),
                          static_cast<float>(height)), 0.5f);
  dx = __fadd_rn(__fadd_rn(cam[3], __fmul_rn(u, cam[6])), __fmul_rn(v, cam[9]));
  dy = __fadd_rn(__fadd_rn(cam[4], __fmul_rn(u, cam[7])), __fmul_rn(v, cam[10]));
  dz = __fadd_rn(__fadd_rn(cam[5], __fmul_rn(u, cam[8])), __fmul_rn(v, cam[11]));
  const float len = sqrtf(dot_rn(dx, dy, dz, dx, dy, dz));
  dx = __fdiv_rn(dx, len);
  dy = __fdiv_rn(dy, len);
  dz = __fdiv_rn(dz, len);
  return len;
}

// The sphere quadratic for the ray (o, d): bq = op.d and det = bq^2 -
// |op|^2 + r^2 with op = c - o, in round-to-nearest arithmetic.
__device__ __forceinline__ void sphere_quadratic(const float* sp, float ox,
                                                 float oy, float oz, float dx,
                                                 float dy, float dz,
                                                 float& bq, float& det) {
  const float opx = __fsub_rn(sp[0], ox);
  const float opy = __fsub_rn(sp[1], oy);
  const float opz = __fsub_rn(sp[2], oz);
  bq = dot_rn(opx, opy, opz, dx, dy, dz);
  det = __fadd_rn(
      __fsub_rn(__fmul_rn(bq, bq), dot_rn(opx, opy, opz, opx, opy, opz)),
      __fmul_rn(sp[3], sp[3]));
}

// Running-min intersection over the sphere table; strict < keeps the
// earlier sphere on a tie.  Returns the winner's row (-1 on a miss), its
// distance in `best_t`, and whether the near root was taken in `near_root`.
__device__ __forceinline__ int nearest_sphere(const float* sph, int n_spheres,
                                              float ox, float oy, float oz,
                                              float dx, float dy, float dz,
                                              float& best_t, bool& near_root) {
  best_t = kInf;
  near_root = false;
  int best = -1;
  for (int i = 0; i < n_spheres; ++i) {
    float bq, det;
    sphere_quadratic(sph + i * kCols, ox, oy, oz, dx, dy, dz, bq, det);
    if (det >= 0.f) {
      const float sq = sqrtf(det);
      const float tn = __fsub_rn(bq, sq);
      const float tf = __fadd_rn(bq, sq);
      const float t = tn > kSphereEps ? tn : (tf > kSphereEps ? tf : 0.f);
      if (t > 0.f && t < best_t) {
        best_t = t;
        best = i;
        near_root = tn > kSphereEps;
      }
    }
  }
  return best;
}

// The sphere table the block reads: staged in shared memory (`smem`, which
// holds kSmemSpheres rows) when it fits, read from global memory (through
// the caches) when it does not.  Every thread of the block must call it.
__device__ __forceinline__ const float* stage_spheres(float* smem,
                                                      const float* spheres,
                                                      int n_spheres) {
  if (n_spheres > kSmemSpheres) return spheres;
  for (int i = threadIdx.x; i < n_spheres * kCols; i += blockDim.x) {
    smem[i] = spheres[i];
  }
  __syncthreads();
  return smem;
}

// Bytes of shared memory a launch gives stage_spheres.
inline size_t sphere_smem_bytes(int n_spheres) {
  return n_spheres > kSmemSpheres
             ? 0
             : sizeof(float) * kCols * static_cast<size_t>(n_spheres);
}

// The cosine-sample frame about the unit normal n: u = normalize(cross(axis,
// n)) with the axis flipping on |n.x| > 0.1, and v = cross(n, u).  Returns
// |cross(axis, n)| before normalising.
template <unsigned kFast = 0>
__device__ __forceinline__ float cosine_frame(float nx, float ny, float nz,
                                              float& ax, float& ay, float& ux,
                                              float& uy, float& uz, float& vx,
                                              float& vy, float& vz) {
  const bool flip = fabsf(nx) > 0.1f;
  ax = flip ? 0.f : 1.f;
  ay = flip ? 1.f : 0.f;
  ux = ay * nz;
  uy = -ax * nz;
  uz = ax * ny - ay * nx;
  const float len = normalize<kFast>(ux, uy, uz);
  vx = ny * uz - nz * uy;
  vy = nz * ux - nx * uz;
  vz = nx * uy - ny * ux;
  return len;
}

// One bounce's material interaction at a hit (ops/shading.py::scatter).
struct Scatter {
  float px, py, pz;     // hit point o + d*t
  float nx, ny, nz;     // unit normal
  float ndx, ndy, ndz;  // direction of the next ray
  float tr, tg, tb;     // throughput multiplier
  float cp, spn, wz;    // cosine sample = u*cp + v*spn + n*wz, normalised
  float cdx, cdy, cdz;  // that cosine sample
  float cos2;           // 2 * dot(cosine sample, n)
  float one_m_aoi;      // max(1 - aoi, 0), aoi = -dot(d, n)  (DIFF only)
  float grazing;        // one_m_aoi ^ fresnel_pow            (DIFF only)
  float fresnel;        // unclipped Fresnel probability      (DIFF only)
  bool take_reflect;    // DIFF took its Fresnel mirror branch
};

// The material interaction at a hit whose point (r.px, ...) and unit
// normal (r.nx, ...) are set: col and spec are the surface's albedo and
// specular colour, refl its type, (dx, dy, dz) the incoming ray and
// u_reflect, u_phi, u_r the bounce's draws.  SPEC: mirror direction (not
// normalised), throughput unchanged.  DIFF: stochastic Fresnel mix; the
// mirror branch is weighted by the per-channel specular colour, the cosine
// branch by albedo * cos2.  BRDF: the cosine branch alone (a measured
// table's factor is the caller's).
__device__ __forceinline__ void shade(Scatter& r, const float* col,
                                      const float* spec, int refl, float dx,
                                      float dy, float dz, float u_reflect,
                                      float u_phi, float u_r, float fc,
                                      float fp) {
  // Mirror direction (not normalised for SPEC).
  const float two_ddn = 2.f * (dx * r.nx + dy * r.ny + dz * r.nz);
  const float rfx = dx - two_ddn * r.nx;
  const float rfy = dy - two_ddn * r.ny;
  const float rfz = dz - two_ddn * r.nz;

  // Cosine hemisphere about n.
  float ax, ay, ux, uy, uz, vx, vy, vz;
  cosine_frame(r.nx, r.ny, r.nz, ax, ay, ux, uy, uz, vx, vy, vz);
  float sphi, cphi;
  sincosf(kTwoPi * u_phi, &sphi, &cphi);
  const float rr = sqrtf(u_r);
  r.cp = cphi * rr;
  r.spn = sphi * rr;
  r.wz = sqrtf(fmaxf(1.f - u_r, 0.f));
  float cdx = ux * r.cp + vx * r.spn + r.nx * r.wz;
  float cdy = uy * r.cp + vy * r.spn + r.ny * r.wz;
  float cdz = uz * r.cp + vz * r.spn + r.nz * r.wz;
  normalize(cdx, cdy, cdz);
  r.cdx = cdx; r.cdy = cdy; r.cdz = cdz;
  r.cos2 = (cdx * r.nx + cdy * r.ny + cdz * r.nz) * 2.f;

  r.one_m_aoi = r.grazing = r.fresnel = 0.f;
  r.take_reflect = false;
  if (refl == kSpec) {
    r.ndx = rfx; r.ndy = rfy; r.ndz = rfz;
    r.tr = r.tg = r.tb = 1.f;
    return;
  }
  if (refl != kBrdf) {  // DIFF: stochastic Fresnel mix
    const float aoi = -(dx * r.nx + dy * r.ny + dz * r.nz);
    r.one_m_aoi = fmaxf(1.f - aoi, 0.f);
    r.grazing = powf(r.one_m_aoi, fp);
    r.fresnel = (r.grazing * (1.f - fc) + fc) * spec[0];
    r.take_reflect = u_reflect < r.fresnel;
  }
  if (r.take_reflect) {
    r.ndx = rfx; r.ndy = rfy; r.ndz = rfz;
    normalize(r.ndx, r.ndy, r.ndz);
    r.tr = spec[0]; r.tg = spec[1]; r.tb = spec[2];
  } else {
    r.ndx = cdx; r.ndy = cdy; r.ndz = cdz;
    r.tr = col[0] * r.cos2; r.tg = col[1] * r.cos2; r.tb = col[2] * r.cos2;
  }
}

// ---------------------------------------------------------------------------
// The Cornell loop of K1 and K2, with cuts (a) and (b) of the header.

// The inexact cuts K1 and K2 run (the bits above).
#ifndef VPT_CORNELL_FAST
#define VPT_CORNELL_FAST (kRcpNormalize | kSinCosPi | kExp2Pow)
#endif
constexpr unsigned kCornellFast = VPT_CORNELL_FAST;

template <unsigned kFast>
__device__ __forceinline__ void sincos_turn(float u, float* s, float* c) {
  if constexpr ((kFast & kSinCosPi) != 0) {
    sincospif(2.f * u, s, c);
  } else {
    sincosf(kTwoPi * u, s, c);
  }
}

// x^p for x >= 0, as powf: exp2(p log2 x) is +0 at x = 0 for p > 0, and
// p = 0 gives 1.
template <unsigned kFast>
__device__ __forceinline__ float pow_grazing(float x, float p) {
  if constexpr ((kFast & kExp2Pow) != 0) {
    return p == 0.f ? 1.f : exp2f(p * log2f(x));
  } else {
    return powf(x, p);
  }
}

// What a hit gives every sample that reaches it alike: the winner's row
// (-1 on a miss), its distance and root, the hit point, the unit normal,
// the cosine frame (u, v) about it, and on a Fresnel surface (fres: a DIFF
// row with spec[0] != 0) the unclipped Fresnel probability with its pieces
// (0 elsewhere).
struct Surface {
  int best;
  float t;
  bool near_root;
  float px, py, pz;
  float nx, ny, nz;
  float ux, uy, uz, vx, vy, vz;
  float ddn;        // dot(d, n)
  bool fres;
  float one_m_aoi;  // max(1 - aoi, 0), aoi = -dot(d, n)
  float grazing;    // one_m_aoi ^ fresnel_pow
  float fresnel;
};

// One sample's scatter at a Surface.
struct Bounce {
  float ndx, ndy, ndz;  // direction of the next ray
  float tr, tg, tb;     // throughput multiplier
  float cp, spn, wz;    // cosine sample = u*cp + v*spn + n*wz, normalised
  float cos2;           // 2 * dot(cosine sample, n)
  bool take_reflect;    // a Fresnel surface took its mirror branch
};

// Fills h from h.best and h.t for the ray (o, d).  kNoFresnel plants a
// fault (chip_smoke.py): cut (a) taken on Fresnel surfaces too.
template <unsigned kFast, bool kNoFresnel>
__device__ __forceinline__ void surface(Surface& h, const float* hs, float ox,
                                        float oy, float oz, float dx,
                                        float dy, float dz, float fc,
                                        float fp) {
  h.px = __fadd_rn(ox, __fmul_rn(dx, h.t));
  h.py = __fadd_rn(oy, __fmul_rn(dy, h.t));
  h.pz = __fadd_rn(oz, __fmul_rn(dz, h.t));
  h.nx = h.px - hs[0];
  h.ny = h.py - hs[1];
  h.nz = h.pz - hs[2];
  normalize<kFast>(h.nx, h.ny, h.nz);
  float ax, ay;
  cosine_frame<kFast>(h.nx, h.ny, h.nz, ax, ay, h.ux, h.uy, h.uz, h.vx, h.vy,
                      h.vz);
  const int refl = static_cast<int>(hs[13]);
  h.ddn = dx * h.nx + dy * h.ny + dz * h.nz;
  h.fres = !kNoFresnel && refl != kSpec && refl != kBrdf && hs[10] != 0.f;
  h.one_m_aoi = h.grazing = h.fresnel = 0.f;
  if (h.fres) {
    const float aoi = -h.ddn;
    h.one_m_aoi = fmaxf(1.f - aoi, 0.f);
    h.grazing = pow_grazing<kFast>(h.one_m_aoi, fp);
    h.fresnel = (h.grazing * (1.f - fc) + fc) * hs[10];
  }
}

// Bounce 0's Surface of a pixel (cut (b)): the primary ray (o0, d0)'s
// nearest sphere and what every sample shares there.  kFullSurface0 false
// keeps only the winner, its distance and root, and trace() recomputes the
// rest per sample (K2, whose occupancy its registers limit).
template <unsigned kFast, bool kNoFresnel, bool kFullSurface0 = true>
__device__ __forceinline__ void first_surface(Surface& h, const float* sph,
                                              int n_spheres, const float* o0,
                                              const float* d0, float fc,
                                              float fp) {
  h.best = nearest_sphere(sph, n_spheres, o0[0], o0[1], o0[2], d0[0], d0[1],
                          d0[2], h.t, h.near_root);
  if (kFullSurface0 && h.best >= 0) {
    surface<kFast, kNoFresnel>(h, sph + h.best * kCols, o0[0], o0[1], o0[2],
                               d0[0], d0[1], d0[2], fc, fp);
  }
}

// Sample s's scatter at h, bounce b (ops/shading.py::scatter, the rows of
// K1's scope: SPEC, DIFF, and BRDF without a table): the slot-0 draw only
// on a Fresnel surface (cut (a)), then the cosine sample from slot 1.
// SPEC: mirror direction (not normalised), throughput unchanged.  DIFF: the
// mirror branch weighted by the per-channel specular colour, or the cosine
// branch by albedo * cos2.  BRDF: the cosine branch.
template <unsigned kFast>
__device__ __forceinline__ void scatter(Bounce& r, const Surface& h,
                                        const float* hs, float dx, float dy,
                                        float dz, uint32_t seed_lo,
                                        uint32_t seed_hi, uint32_t pixel,
                                        uint32_t frame, uint32_t s,
                                        uint32_t b) {
  r.take_reflect = false;
  if (h.fres) {
    float u_reflect, unused;
    draw(seed_lo, seed_hi, pixel, frame, s, b, 0, u_reflect, unused);
    r.take_reflect = u_reflect < h.fresnel;
  }
  float u_phi, u_r;
  draw(seed_lo, seed_hi, pixel, frame, s, b, 1, u_phi, u_r);
  float sphi, cphi;
  sincos_turn<kFast>(u_phi, &sphi, &cphi);
  const float rr = sqrtf(u_r);
  r.cp = cphi * rr;
  r.spn = sphi * rr;
  r.wz = sqrtf(fmaxf(1.f - u_r, 0.f));
  float cdx = h.ux * r.cp + h.vx * r.spn + h.nx * r.wz;
  float cdy = h.uy * r.cp + h.vy * r.spn + h.ny * r.wz;
  float cdz = h.uz * r.cp + h.vz * r.spn + h.nz * r.wz;
  normalize<kFast>(cdx, cdy, cdz);
  r.cos2 = (cdx * h.nx + cdy * h.ny + cdz * h.nz) * 2.f;
  const bool spec = static_cast<int>(hs[13]) == kSpec;
  if (spec || r.take_reflect) {
    const float two_ddn = 2.f * h.ddn;
    r.ndx = dx - two_ddn * h.nx;
    r.ndy = dy - two_ddn * h.ny;
    r.ndz = dz - two_ddn * h.nz;
    if (spec) {
      r.tr = r.tg = r.tb = 1.f;
    } else {
      normalize<kFast>(r.ndx, r.ndy, r.ndz);
      r.tr = hs[10]; r.tg = hs[11]; r.tb = hs[12];
    }
  } else {
    r.ndx = cdx; r.ndy = cdy; r.ndz = cdz;
    r.tr = hs[4] * r.cos2; r.tg = hs[5] * r.cos2; r.tb = hs[6] * r.cos2;
  }
}

// Traces sample `s` of `pixel` from its primary ray (o0, d0), whose bounce-0
// Surface h0 the caller computed (first_surface with the same
// kFullSurface0): per bounce the nearest
// sphere, its emission weighted by the throughput, and the scatter; a miss
// is a Cornell kill.  Returns false for a killed path and leaves acc as it
// was; otherwise adds the path's radiance to acc.  Before each hit's
// emission is added, on_hit(b, h, o, d, m, r) sees the bounce: its Surface,
// the ray (o, d) and throughput m entering it, and the sample's scatter.
template <unsigned kFast, bool kNoFresnel, bool kFullSurface0 = true,
          class OnHit>
__device__ __forceinline__ bool trace(const float* sph, int n_spheres,
                                      const Surface& h0, const float* o0,
                                      const float* d0, uint32_t seed_lo,
                                      uint32_t seed_hi, uint32_t pixel,
                                      uint32_t frame, int s, int bounces,
                                      float fc, float fp, float* acc,
                                      OnHit on_hit) {
  if (bounces <= 0) return true;
  if (h0.best < 0) return false;
  float o[3] = {o0[0], o0[1], o0[2]};
  float d[3] = {d0[0], d0[1], d0[2]};
  float m[3] = {1.f, 1.f, 1.f};
  float sr = 0.f, sg = 0.f, sb = 0.f;
  auto step = [&](int b, const Surface& h) {
    const float* hs = sph + h.best * kCols;
    Bounce r;
    scatter<kFast>(r, h, hs, d[0], d[1], d[2], seed_lo, seed_hi, pixel, frame,
                   s, b);
    on_hit(b, h, o, d, m, r);
    sr += m[0] * hs[7];
    sg += m[1] * hs[8];
    sb += m[2] * hs[9];
    o[0] = h.px + kOriginOffset * h.nx;
    o[1] = h.py + kOriginOffset * h.ny;
    o[2] = h.pz + kOriginOffset * h.nz;
    d[0] = r.ndx; d[1] = r.ndy; d[2] = r.ndz;
    m[0] *= r.tr; m[1] *= r.tg; m[2] *= r.tb;
  };
  if constexpr (kFullSurface0) {
    step(0, h0);
  } else {
    Surface h = h0;
    surface<kFast, kNoFresnel>(h, sph + h.best * kCols, o0[0], o0[1], o0[2],
                               d0[0], d0[1], d0[2], fc, fp);
    step(0, h);
  }
  for (int b = 1; b < bounces; ++b) {
    Surface h;
    h.best = nearest_sphere(sph, n_spheres, o[0], o[1], o[2], d[0], d[1],
                            d[2], h.t, h.near_root);
    if (h.best < 0) return false;
    surface<kFast, kNoFresnel>(h, sph + h.best * kCols, o[0], o[1], o[2],
                               d[0], d[1], d[2], fc, fp);
    step(b, h);
  }
  acc[0] += sr;
  acc[1] += sg;
  acc[2] += sb;
  return true;
}

}  // namespace vpt
