// Device code shared by the kernels K1 (radiance.cu), K2 (grad.cu) and K4
// (mesh.cu): the threefry-2x32 draw stream, the FMA-guarded primary ray and
// running-min sphere test, the sphere table's staging, the material scatter
// of one bounce, and the Cornell bounce loop of one sample (trace).  K1 and
// K2 trace with this one loop, so K2's forward pass computes what K1
// renders; K4 runs its own loop over the same pieces.
//
// Numerics.  Built without --use_fast_math: IEEE sqrt and division.  The
// sphere test and the primary ray use explicit round-to-nearest intrinsics
// (__fmul_rn/__fadd_rn), which nvcc never contracts into FMAs.  The walls are
// r = 1e5 spheres, and det = b^2 - |op|^2 + r^2 cancels 1e10-sized squares
// with about 1e3 of absolute float32 noise, so a contracted FMA there flips
// hit/miss on grazing rays against the plain PyTorch version.  Everywhere
// else nvcc may contract.

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

// x / max(|x|, 1e-20), the plain version's normalisation; returns the
// divisor.
__device__ __forceinline__ float normalize(float& x, float& y, float& z) {
  const float len = fmaxf(sqrtf(x * x + y * y + z * z), 1e-20f);
  x = x / len;
  y = y / len;
  z = z / len;
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
  const float len = normalize(ux, uy, uz);
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

// hs is the winner's table row; (s, b) the sample and bounce of the draws.
__device__ __forceinline__ Scatter scatter(
    const float* hs, float best_t, float ox, float oy, float oz, float dx,
    float dy, float dz, uint32_t seed_lo, uint32_t seed_hi, uint32_t pixel,
    uint32_t frame, uint32_t s, uint32_t b, float fc, float fp) {
  Scatter r;
  r.px = __fadd_rn(ox, __fmul_rn(dx, best_t));
  r.py = __fadd_rn(oy, __fmul_rn(dy, best_t));
  r.pz = __fadd_rn(oz, __fmul_rn(dz, best_t));
  r.nx = r.px - hs[0];
  r.ny = r.py - hs[1];
  r.nz = r.pz - hs[2];
  normalize(r.nx, r.ny, r.nz);

  float u_reflect, unused, u_phi, u_r;
  draw(seed_lo, seed_hi, pixel, frame, s, b, 0, u_reflect, unused);
  draw(seed_lo, seed_hi, pixel, frame, s, b, 1, u_phi, u_r);
  shade(r, hs + 4, hs + 10, static_cast<int>(hs[13]), dx, dy, dz, u_reflect,
        u_phi, u_r, fc, fp);
  return r;
}

// Traces sample `s` of `pixel` from the primary ray (o0, d0): per bounce the
// nearest sphere, its emission weighted by the throughput, and the scatter;
// a miss is a Cornell kill.  Returns false for a killed path and leaves acc
// as it was; otherwise adds the path's radiance to acc.  Before each hit's
// emission is added, on_hit(b, best, best_t, near_root, o, d, m, sc) sees
// the bounce: the winner's row and distance, the ray (o, d) and throughput
// m entering it, and its scatter.
template <class OnHit>
__device__ __forceinline__ bool trace(const float* sph, int n_spheres,
                                      const float* o0, const float* d0,
                                      uint32_t seed_lo, uint32_t seed_hi,
                                      uint32_t pixel, uint32_t frame, int s,
                                      int bounces, float fc, float fp,
                                      float* acc, OnHit on_hit) {
  float o[3] = {o0[0], o0[1], o0[2]};
  float d[3] = {d0[0], d0[1], d0[2]};
  float m[3] = {1.f, 1.f, 1.f};
  float sr = 0.f, sg = 0.f, sb = 0.f;
  for (int b = 0; b < bounces; ++b) {
    float best_t;
    bool near_root;
    const int best = nearest_sphere(sph, n_spheres, o[0], o[1], o[2], d[0],
                                    d[1], d[2], best_t, near_root);
    if (best < 0) return false;
    const float* hs = sph + best * kCols;
    const Scatter sc = scatter(hs, best_t, o[0], o[1], o[2], d[0], d[1], d[2],
                               seed_lo, seed_hi, pixel, frame, s, b, fc, fp);
    on_hit(b, best, best_t, near_root, o, d, m, sc);
    sr += m[0] * hs[7];
    sg += m[1] * hs[8];
    sb += m[2] * hs[9];
    o[0] = sc.px + kOriginOffset * sc.nx;
    o[1] = sc.py + kOriginOffset * sc.ny;
    o[2] = sc.pz + kOriginOffset * sc.nz;
    d[0] = sc.ndx; d[1] = sc.ndy; d[2] = sc.ndz;
    m[0] *= sc.tr; m[1] *= sc.tg; m[2] *= sc.tb;
  }
  acc[0] += sr;
  acc[1] += sg;
  acc[2] += sb;
  return true;
}

}  // namespace vpt
