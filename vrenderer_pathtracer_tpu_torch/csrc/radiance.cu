// K1: the Cornell radiance kernel, hand-written CUDA C++ for Hopper (sm_90a).
//
// Replaces vrenderer_pathtracer_tpu/render/pallas_radiance.py::_kernel.  It
// computes one progressive pass of the analytic Cornell estimator, per pixel:
// the pinhole primary ray (fixed 0.25 sub-pixel offset), then for each of
// `spp` samples a loop of `bounces` steps: running-min intersection over the
// sphere table, emission, the threefry-2x32 draws keyed by (pixel, frame,
// sample, bounce, slot), the mirror / Fresnel-diffuse scatter, and the
// Cornell kill of a path that misses.  Outputs are the mean RGB over the
// samples, rgb [N,3], and the first-hit depth / depth_scale, depth [N].
// The plain PyTorch version is render/cuda_radiance.py::render_pass_reference
// (generate_rays + render/integrator.py::render_pass).
//
// What bounds it on the H100: arithmetic, not memory.  Per pixel and pass it
// does a few thousand operations (at 2 spp x 4 bounces: 8 x {8 sphere tests
// with a sqrt each, two 20-round threefry blocks, sincos, pow, four
// normalisations}) against 16 bytes written and nothing read but a small
// sphere table.  The ALU and SFU pipes are the limit.  The design therefore:
//   * one thread per pixel, all path state in registers, no intermediate in
//     device memory (the TPU kernel's (8,128) tiles and n%1024 padding are
//     gone; a bounds check on the pixel id replaces them);
//   * the sphere table [Ns,14] staged once per block in shared memory: every
//     thread reads the same sphere at the same step, so reads broadcast;
//   * the threefry stream salts computed in registers from (frame, sample,
//     bounce, slot), not read from a table;
//   * a path that has missed leaves its bounce loop: its later bounces add
//     nothing (a Cornell miss zeroes the sample), so the exit is exact.
//
// Numerics.  Built without --use_fast_math: IEEE sqrt and division.  The
// sphere test and the primary ray use explicit round-to-nearest intrinsics
// (__fmul_rn/__fadd_rn), which nvcc never contracts into FMAs.  The walls are
// r = 1e5 spheres, and det = b^2 - |op|^2 + r^2 cancels 1e10-sized squares
// with about 1e3 of absolute float32 noise, so a contracted FMA there flips
// hit/miss on grazing rays against the plain version.  Measured at 1024^2,
// 2 spp, 4 bounces on an H100 80GB HBM3 (700 W): rgb elements off the plain
// version by more than 1e-5 are 0.063% with the guard and 0.081% without;
// the guard costs 5% of the kernel's time (0.285 against 0.270 ms).
// Everywhere else nvcc may contract; the parity contract with the plain
// version is statistical (fewer than 1% of rgb elements off by more than
// 1e-5, depth within 1e-3).

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr float kInf = 1e20f;
constexpr float kSphereEps = 1e-4f;
constexpr float kOriginOffset = 0.05f;
constexpr float kTwoPi = 6.283185307179586f;
constexpr int kCols = 14;  // pos xyz, radius, color rgb, emission rgb, spec rgb, refl
constexpr int kThreads = 128;
constexpr int kSpec = 0;
constexpr int kBrdf = 2;

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

// x / max(|x|, 1e-20), the plain version's normalisation.
__device__ __forceinline__ void normalize(float& x, float& y, float& z) {
  const float len = fmaxf(sqrtf(x * x + y * y + z * z), 1e-20f);
  x = x / len;
  y = y / len;
  z = z / len;
}

__global__ void __launch_bounds__(kThreads)
radiance_kernel(const float* __restrict__ cam, const float* __restrict__ spheres,
                int n_spheres, uint32_t seed_lo, uint32_t seed_hi,
                uint32_t frame, int width, int height, int spp, int bounces,
                float depth_scale, float* __restrict__ rgb,
                float* __restrict__ depth_out) {
  extern __shared__ float sph[];  // [n_spheres, kCols]
  for (int i = threadIdx.x; i < n_spheres * kCols; i += blockDim.x) {
    sph[i] = spheres[i];
  }
  __syncthreads();

  const int n = width * height;
  const int pixel = blockIdx.x * blockDim.x + threadIdx.x;
  if (pixel >= n) return;

  // cam: origin, view dir, cx, cy (camera basis scaled by fov and aspect),
  // fresnel coef, fresnel pow.
  const float cox = cam[0], coy = cam[1], coz = cam[2];
  const float fc = cam[12], fp = cam[13];

  // Primary ray: d = view + u*cx + v*cy, normalised.
  const float u = __fsub_rn(__fdiv_rn(__fadd_rn(0.25f, static_cast<float>(pixel % width)),
                                      static_cast<float>(width)), 0.5f);
  const float v = __fsub_rn(__fdiv_rn(__fadd_rn(0.25f, static_cast<float>(pixel / width)),
                                      static_cast<float>(height)), 0.5f);
  float d0x = __fadd_rn(__fadd_rn(cam[3], __fmul_rn(u, cam[6])), __fmul_rn(v, cam[9]));
  float d0y = __fadd_rn(__fadd_rn(cam[4], __fmul_rn(u, cam[7])), __fmul_rn(v, cam[10]));
  float d0z = __fadd_rn(__fadd_rn(cam[5], __fmul_rn(u, cam[8])), __fmul_rn(v, cam[11]));
  {
    const float len = sqrtf(dot_rn(d0x, d0y, d0z, d0x, d0y, d0z));
    d0x = __fdiv_rn(d0x, len);
    d0y = __fdiv_rn(d0y, len);
    d0z = __fdiv_rn(d0z, len);
  }

  float acc_r = 0.f, acc_g = 0.f, acc_b = 0.f;
  float depth = 1.f;

  for (int s = 0; s < spp; ++s) {
    float ox = cox, oy = coy, oz = coz;
    float dx = d0x, dy = d0y, dz = d0z;
    float mr = 1.f, mg = 1.f, mb = 1.f;
    float sr = 0.f, sg = 0.f, sb = 0.f;
    bool killed = false;
    depth = 1.f;

    for (int b = 0; b < bounces; ++b) {
      // Running-min intersection; strict < keeps the earlier sphere on a tie.
      float best_t = kInf;
      int best = -1;
      for (int i = 0; i < n_spheres; ++i) {
        const float* sp = sph + i * kCols;
        const float opx = __fsub_rn(sp[0], ox);
        const float opy = __fsub_rn(sp[1], oy);
        const float opz = __fsub_rn(sp[2], oz);
        const float bq = dot_rn(opx, opy, opz, dx, dy, dz);
        const float det = __fadd_rn(
            __fsub_rn(__fmul_rn(bq, bq), dot_rn(opx, opy, opz, opx, opy, opz)),
            __fmul_rn(sp[3], sp[3]));
        if (det >= 0.f) {
          const float sq = sqrtf(det);
          const float tn = __fsub_rn(bq, sq);
          const float tf = __fadd_rn(bq, sq);
          const float t = tn > kSphereEps ? tn : (tf > kSphereEps ? tf : 0.f);
          if (t > 0.f && t < best_t) {
            best_t = t;
            best = i;
          }
        }
      }
      if (best < 0) {  // miss: the Cornell box kills the path
        killed = true;
        break;
      }
      const float* hs = sph + best * kCols;

      const float px = __fadd_rn(ox, __fmul_rn(dx, best_t));
      const float py = __fadd_rn(oy, __fmul_rn(dy, best_t));
      const float pz = __fadd_rn(oz, __fmul_rn(dz, best_t));
      float nx = px - hs[0], ny = py - hs[1], nz = pz - hs[2];
      normalize(nx, ny, nz);
      if (b == 0) {
        const float ex = ox - px, ey = oy - py, ez = oz - pz;
        depth = sqrtf(ex * ex + ey * ey + ez * ez) / depth_scale;
      }
      sr += mr * hs[7];
      sg += mg * hs[8];
      sb += mb * hs[9];

      float u_reflect, unused, u_phi, u_r;
      draw(seed_lo, seed_hi, pixel, frame, s, b, 0, u_reflect, unused);
      draw(seed_lo, seed_hi, pixel, frame, s, b, 1, u_phi, u_r);

      // Mirror direction (not normalised for SPEC).
      const float two_ddn = 2.f * (dx * nx + dy * ny + dz * nz);
      const float rfx = dx - two_ddn * nx;
      const float rfy = dy - two_ddn * ny;
      const float rfz = dz - two_ddn * nz;

      // Cosine hemisphere about n; the frame axis flips on |n.x| > 0.1.
      const bool flip = fabsf(nx) > 0.1f;
      const float ax = flip ? 0.f : 1.f;
      const float ay = flip ? 1.f : 0.f;
      float ux = ay * nz, uy = -ax * nz, uz = ax * ny - ay * nx;
      normalize(ux, uy, uz);
      const float vx = ny * uz - nz * uy;
      const float vy = nz * ux - nx * uz;
      const float vz = nx * uy - ny * ux;
      float sphi, cphi;
      sincosf(kTwoPi * u_phi, &sphi, &cphi);
      const float rr = sqrtf(u_r);
      const float cp = cphi * rr, spn = sphi * rr;
      const float wz = sqrtf(fmaxf(1.f - u_r, 0.f));
      float cdx = ux * cp + vx * spn + nx * wz;
      float cdy = uy * cp + vy * spn + ny * wz;
      float cdz = uz * cp + vz * spn + nz * wz;
      normalize(cdx, cdy, cdz);
      const float cosw = (cdx * nx + cdy * ny + cdz * nz) * 2.f;

      const int refl = static_cast<int>(hs[13]);
      float ndx, ndy, ndz, tr, tg, tb;
      if (refl == kSpec) {
        ndx = rfx; ndy = rfy; ndz = rfz;
        tr = tg = tb = 1.f;
      } else {
        bool take_reflect = false;
        if (refl != kBrdf) {  // DIFF: stochastic Fresnel mix
          const float aoi = -(dx * nx + dy * ny + dz * nz);
          const float grazing = powf(fmaxf(1.f - aoi, 0.f), fp);
          const float fresnel = (grazing * (1.f - fc) + fc) * hs[10];
          take_reflect = u_reflect < fresnel;
        }
        if (take_reflect) {
          ndx = rfx; ndy = rfy; ndz = rfz;
          normalize(ndx, ndy, ndz);
          tr = hs[10]; tg = hs[11]; tb = hs[12];
        } else {
          ndx = cdx; ndy = cdy; ndz = cdz;
          tr = hs[4] * cosw; tg = hs[5] * cosw; tb = hs[6] * cosw;
        }
      }
      ox = px + kOriginOffset * nx;
      oy = py + kOriginOffset * ny;
      oz = pz + kOriginOffset * nz;
      dx = ndx; dy = ndy; dz = ndz;
      mr *= tr; mg *= tg; mb *= tb;
    }
    if (killed) {
      sr = sg = sb = 0.f;
      depth = 0.f;
    }
    acc_r += sr;
    acc_g += sg;
    acc_b += sb;
  }

  const float fspp = static_cast<float>(spp);
  rgb[3 * pixel + 0] = acc_r / fspp;
  rgb[3 * pixel + 1] = acc_g / fspp;
  rgb[3 * pixel + 2] = acc_b / fspp;
  depth_out[pixel] = depth;
}

}  // namespace

// Launches K1 on `stream` and returns cudaGetLastError() (0 on success).
// All pointers are device pointers to contiguous float32: cam [14],
// spheres [n_spheres, 14], rgb [width*height, 3], depth [width*height].
extern "C" int vpt_radiance(const void* cam, const void* spheres,
                            int n_spheres, unsigned int seed_lo,
                            unsigned int seed_hi, unsigned int frame,
                            int width, int height, int spp, int bounces,
                            float depth_scale, void* rgb, void* depth,
                            void* stream) {
  const int n = width * height;
  const int blocks = (n + kThreads - 1) / kThreads;
  const size_t smem = sizeof(float) * kCols * static_cast<size_t>(n_spheres);
  radiance_kernel<<<blocks, kThreads, smem, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const float*>(cam), static_cast<const float*>(spheres),
      n_spheres, seed_lo, seed_hi, frame, width, height, spp, bounces,
      depth_scale, static_cast<float*>(rgb), static_cast<float*>(depth));
  return static_cast<int>(cudaGetLastError());
}
