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
//   * the sphere table [Ns,14] staged once per block in shared memory when
//     it holds at most 512 spheres, and read from global memory through the
//     caches when it is larger (common.cuh stage_spheres): every thread
//     reads the same sphere at the same step, so reads broadcast;
//   * the threefry stream salts computed in registers from (frame, sample,
//     bounce, slot), not read from a table;
//   * a path that has missed leaves its bounce loop: its later bounces add
//     nothing (a Cornell miss zeroes the sample), so the exit is exact;
//   * the bounce loop is common.cuh's trace(), the one K2 runs too.
//
// Numerics: see common.cuh (no --use_fast_math; the sphere test and the
// primary ray are guarded against FMA contraction).  Measured at 1024^2,
// 2 spp, 4 bounces on an H100 80GB HBM3 (700 W): rgb elements off the plain
// version by more than 1e-5 are 0.063% with the guard and 0.081% without;
// the guard costs 5% of the kernel's time (0.285 against 0.270 ms).  The
// parity contract with the plain version is statistical (fewer than 1% of
// rgb elements off by more than 1e-5, depth within 1e-3).

#include "common.cuh"

namespace {

using namespace vpt;

constexpr int kThreads = 128;

__global__ void __launch_bounds__(kThreads)
radiance_kernel(const float* __restrict__ cam, const float* __restrict__ spheres,
                int n_spheres, uint32_t seed_lo, uint32_t seed_hi,
                uint32_t frame, int width, int height, int spp, int bounces,
                float depth_scale, float* __restrict__ rgb,
                float* __restrict__ depth_out) {
  extern __shared__ float smem[];  // [n_spheres, kCols] when they fit
  const float* sph = stage_spheres(smem, spheres, n_spheres);

  const int n = width * height;
  const int pixel = blockIdx.x * blockDim.x + threadIdx.x;
  if (pixel >= n) return;

  // cam: origin, view dir, cx, cy (camera basis scaled by fov and aspect),
  // fresnel coef, fresnel pow.
  const float fc = cam[12], fp = cam[13];
  float u, v, d0[3];
  primary_ray(cam, pixel, width, height, u, v, d0[0], d0[1], d0[2]);

  // The last sample's first-hit depth is the pixel's; a killed sample's is 0.
  float acc[3] = {0.f, 0.f, 0.f};
  float depth = 1.f;
  for (int s = 0; s < spp; ++s) {
    depth = 1.f;
    const bool alive = trace(
        sph, n_spheres, cam, d0, seed_lo, seed_hi, pixel, frame, s, bounces,
        fc, fp, acc,
        [&](int b, int, float, bool, const float* o, const float*,
            const float*, const Scatter& sc) {
          if (b == 0) {
            const float ex = o[0] - sc.px, ey = o[1] - sc.py, ez = o[2] - sc.pz;
            depth = sqrtf(ex * ex + ey * ey + ez * ez) / depth_scale;
          }
        });
    if (!alive) depth = 0.f;
  }

  const float fspp = static_cast<float>(spp);
  rgb[3 * pixel + 0] = acc[0] / fspp;
  rgb[3 * pixel + 1] = acc[1] / fspp;
  rgb[3 * pixel + 2] = acc[2] / fspp;
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
  const size_t smem = sphere_smem_bytes(n_spheres);
  radiance_kernel<<<blocks, kThreads, smem, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const float*>(cam), static_cast<const float*>(spheres),
      n_spheres, seed_lo, seed_hi, frame, width, height, spp, bounces,
      depth_scale, static_cast<float*>(rgb), static_cast<float*>(depth));
  return static_cast<int>(cudaGetLastError());
}
