// K1: the Cornell radiance kernel, hand-written CUDA C++ for Hopper (sm_90a).
//
// Replaces vrenderer_pathtracer_tpu/render/pallas_radiance.py::_kernel.  It
// computes one progressive pass of the analytic Cornell estimator, per pixel:
// the pinhole primary ray (fixed 0.25 sub-pixel offset), then for each of
// `spp` samples a loop of `bounces` steps: running-min intersection over the
// sphere table, emission, the threefry-2x32 draws keyed by (pixel, frame,
// sample, bounce, slot), the mirror / Fresnel-diffuse scatter, and the
// Cornell kill of a path that misses.  Outputs are the mean RGB over the
// samples, rgb [n,3], and the first-hit depth / depth_scale, depth [n].
// A launch renders the raster range [pixel_offset, pixel_offset + n) of the
// frame with the samples sample_offset, ..., sample_offset + spp - 1 (a
// shard of parallel/sharding.py; the whole frame and 0 otherwise): thread i
// takes pixel pixel_offset + i, whose global id drives its primary ray and
// keys every draw, so shards tile together into the single-device image.
// The plain PyTorch version is render/cuda_radiance.py::render_pass_reference
// (generate_rays + render/integrator.py::render_pass).
//
// What bounds it on the H100: instruction issue.  Per pixel and pass it
// does a few thousand operations (at 2 spp x 4 bounces: 8 x {8 sphere tests
// with a sqrt each, a 20-round threefry block, sincos, four
// normalisations}) against 16 bytes written and nothing read but a small
// sphere table.  Its INT32, FP32 and SFU work is balanced, and one
// scheduler issues one warp instruction a clock, so the sum of the three,
// not the busiest pipe, bounds it: it gets faster only by issuing fewer
// instructions a step.  The design therefore:
//   * one thread per pixel, all path state in registers, no intermediate in
//     device memory (the TPU kernel's (8,128) tiles and n%1024 padding are
//     gone; a bounds check on the pixel id replaces them);
//   * the sphere table [Ns,14] staged once per block in shared memory when
//     it holds at most 512 spheres, and read from global memory through the
//     caches when it is larger (common.cuh stage_spheres): every thread
//     reads the same sphere at the same step, so reads broadcast;
//   * the threefry stream salts computed in registers from (frame, sample,
//     bounce, slot), not read from a table;
//   * a path that has missed leaves its bounce loop: its later bounces add
//     nothing (a Cornell miss zeroes the sample), so the exit is exact;
//   * the bounce loop is common.cuh's trace(), the one K2 runs too: no
//     slot-0 draw or powf where they cannot change the result, and bounce
//     0's sphere loop, hit, normal and frame once per pixel (cuts (a) and
//     (b), exact), with kCornellFast's inexact cuts.
//
// Numerics: see common.cuh (no --use_fast_math; the sphere test and the
// primary ray are guarded against FMA contraction).  Measured at 1024^2,
// 2 spp, 4 bounces on an H100 80GB HBM3 (700 W): rgb elements off the plain
// version by more than 1e-5 are 0.063% with the guard and 0.081% without;
// the guard costs 5% of the kernel's time (0.285 against 0.270 ms).  The
// parity contract with the plain version is statistical (fewer than 1% of
// rgb elements off by more than 1e-5, depth within 1e-3).
//
// Instances: vpt_radiance launches the main path's, the exact cuts with
// kCornellFast's inexact ones.  A build with -DVPT_CHECK_INSTANCES (only
// chip_smoke.py's checks make one) adds vpt_radiance_check and three more:
// the exact cuts alone; the parent design (trace_parent below), which the
// exact cuts alone must match bit for bit without FMA contraction; and the
// exact cuts with a planted fault, cut (a) taken on Fresnel surfaces too,
// which must differ from the parent design and break the contract on a
// scene with specular walls.  Two more planted faults of the shard offsets
// (kFaultNoSampleOffset: the draws keyed by the local sample, and
// kFaultLocalRng: the draws keyed by the local pixel while the primary ray
// takes the global one) must break chip_smoke.py's reassembly checks.

#include "common.cuh"

namespace {

using namespace vpt;

constexpr int kThreads = 128;
constexpr int kParent = 8;
constexpr int kFaultNoFresnel = 9;
constexpr int kFaultNoSampleOffset = 10;
constexpr int kFaultLocalRng = 11;

// The parent design of the Cornell loop, kept for chip_smoke.py's check
// that the cuts of common.cuh's trace() leave K1's image bit-identical
// (the check build's parent instance runs it; no other code does).  hs is
// the winner's table row; (s, b) the sample and bounce of the draws.
__device__ __forceinline__ Scatter scatter_parent(
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

// The parent design's loop over the bounces of sample `s` (the same
// contract as trace() below, with every bounce's Surface recomputed and
// both draws taken at every hit); on_hit(b, best, best_t, near_root, o, d,
// m, sc).
template <class OnHit>
__device__ __forceinline__ bool trace_parent(
    const float* sph, int n_spheres, const float* o0, const float* d0,
    uint32_t seed_lo, uint32_t seed_hi, uint32_t pixel, uint32_t frame,
    int s, int bounces, float fc, float fp, float* acc, OnHit on_hit) {
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
    const Scatter sc =
        scatter_parent(hs, best_t, o[0], o[1], o[2], d[0], d[1], d[2],
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

template <int kVariant>
__global__ void __launch_bounds__(kThreads)
radiance_kernel(const float* __restrict__ cam, const float* __restrict__ spheres,
                int n_spheres, uint32_t seed_lo, uint32_t seed_hi,
                uint32_t frame, int width, int height, int spp, int bounces,
                float depth_scale, int pixel_offset, uint32_t sample_offset,
                int n_local, float* __restrict__ rgb,
                float* __restrict__ depth_out) {
  extern __shared__ float smem[];  // [n_spheres, kCols] when they fit
  const float* sph = stage_spheres(smem, spheres, n_spheres);

  const int i = blockIdx.x * blockDim.x + threadIdx.x;
  if (i >= n_local) return;
  const int pixel = pixel_offset + i;
  // The ids that key the draws (the planted faults drop an offset).
  const uint32_t key_pixel = kVariant == kFaultLocalRng ? i : pixel;
  const uint32_t s0 = kVariant == kFaultNoSampleOffset ? 0u : sample_offset;

  // cam: origin, view dir, cx, cy (camera basis scaled by fov and aspect),
  // fresnel coef, fresnel pow.
  const float fc = cam[12], fp = cam[13];
  float u, v, d0[3];
  primary_ray(cam, pixel, width, height, u, v, d0[0], d0[1], d0[2]);

  // The last sample's first-hit depth is the pixel's; a killed sample's is 0.
  float acc[3] = {0.f, 0.f, 0.f};
  float depth = 1.f;
  if constexpr (kVariant == kParent) {
    for (int s = 0; s < spp; ++s) {
      depth = 1.f;
      const bool alive = trace_parent(
          sph, n_spheres, cam, d0, seed_lo, seed_hi, key_pixel, frame, s0 + s,
          bounces, fc, fp, acc,
          [&](int b, int, float, bool, const float* o, const float*,
              const float*, const Scatter& sc) {
            if (b == 0) {
              const float ex = o[0] - sc.px, ey = o[1] - sc.py,
                          ez = o[2] - sc.pz;
              depth = sqrtf(ex * ex + ey * ey + ez * ez) / depth_scale;
            }
          });
      if (!alive) depth = 0.f;
    }
  } else {
    constexpr bool kFault = kVariant == kFaultNoFresnel;
    // The offset faults are the shipped instance but for the fault.
    constexpr unsigned kFast =
        kFault ? 0u : (kVariant >= kFaultNoSampleOffset ? kCornellFast
                                                        : kVariant);
    Surface h0;
    h0.best = -1;
    float depth0 = 1.f;
    if (bounces > 0) {
      first_surface<kFast, kFault>(h0, sph, n_spheres, cam, d0, fc, fp);
      if (h0.best >= 0) {
        const float ex = cam[0] - h0.px, ey = cam[1] - h0.py,
                    ez = cam[2] - h0.pz;
        depth0 = sqrtf(ex * ex + ey * ey + ez * ez) / depth_scale;
      }
    }
    for (int s = 0; s < spp; ++s) {
      const bool alive = trace<kFast, kFault>(
          sph, n_spheres, h0, cam, d0, seed_lo, seed_hi, key_pixel, frame,
          s0 + s, bounces, fc, fp, acc,
          [](int, const Surface&, const float*, const float*, const float*,
             const Bounce&) {});
      depth = alive ? depth0 : 0.f;
    }
  }

  const float fspp = static_cast<float>(spp);
  rgb[3 * i + 0] = acc[0] / fspp;
  rgb[3 * i + 1] = acc[1] / fspp;
  rgb[3 * i + 2] = acc[2] / fspp;
  depth_out[i] = depth;
}

template <int kVariant>
int launch(const void* cam, const void* spheres, int n_spheres,
           unsigned int seed_lo, unsigned int seed_hi, unsigned int frame,
           int width, int height, int spp, int bounces, float depth_scale,
           int pixel_offset, unsigned int sample_offset, int n_local,
           void* rgb, void* depth, cudaStream_t stream) {
  if (pixel_offset < 0 || n_local <= 0 ||
      static_cast<long long>(pixel_offset) + n_local >
          static_cast<long long>(width) * height) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  const int blocks = (n_local + kThreads - 1) / kThreads;
  radiance_kernel<kVariant><<<blocks, kThreads, sphere_smem_bytes(n_spheres),
                              stream>>>(
      static_cast<const float*>(cam), static_cast<const float*>(spheres),
      n_spheres, seed_lo, seed_hi, frame, width, height, spp, bounces,
      depth_scale, pixel_offset, sample_offset, n_local,
      static_cast<float*>(rgb), static_cast<float*>(depth));
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// Launches K1 on `stream` over the pixels [pixel_offset, pixel_offset +
// n_local) with the samples from sample_offset, and returns
// cudaGetLastError() (0 on success; cudaErrorInvalidValue for a range
// outside the frame).  All pointers are device pointers to contiguous
// float32: cam [14], spheres [n_spheres, 14], rgb [n_local, 3], depth
// [n_local].
extern "C" int vpt_radiance(const void* cam, const void* spheres,
                            int n_spheres, unsigned int seed_lo,
                            unsigned int seed_hi, unsigned int frame,
                            int width, int height, int spp, int bounces,
                            float depth_scale, int pixel_offset,
                            unsigned int sample_offset, int n_local,
                            void* rgb, void* depth, void* stream) {
  return launch<kCornellFast>(cam, spheres, n_spheres, seed_lo, seed_hi,
                              frame, width, height, spp, bounces,
                              depth_scale, pixel_offset, sample_offset,
                              n_local, rgb, depth,
                              static_cast<cudaStream_t>(stream));
}

#ifdef VPT_CHECK_INSTANCES
// Launches the check build's instance `variant` (0 the exact cuts alone, 8
// the parent design, 9 the planted Fresnel fault, 10 and 11 the planted
// offset faults); as above, and cudaErrorInvalidValue for another variant.
extern "C" int vpt_radiance_check(const void* cam, const void* spheres,
                                  int n_spheres, unsigned int seed_lo,
                                  unsigned int seed_hi, unsigned int frame,
                                  int width, int height, int spp, int bounces,
                                  float depth_scale, int pixel_offset,
                                  unsigned int sample_offset, int n_local,
                                  void* rgb, void* depth, void* stream,
                                  int variant) {
  auto* fn = launch<0>;
  switch (variant) {
    case 0: break;
    case kParent: fn = launch<kParent>; break;
    case kFaultNoFresnel: fn = launch<kFaultNoFresnel>; break;
    case kFaultNoSampleOffset: fn = launch<kFaultNoSampleOffset>; break;
    case kFaultLocalRng: fn = launch<kFaultLocalRng>; break;
    default: return static_cast<int>(cudaErrorInvalidValue);
  }
  return fn(cam, spheres, n_spheres, seed_lo, seed_hi, frame, width, height,
            spp, bounces, depth_scale, pixel_offset, sample_offset, n_local,
            rgb, depth, static_cast<cudaStream_t>(stream));
}
#endif
