// K4: the fused mesh-scene kernel, hand-written CUDA C++ for Hopper (sm_90a).
//
// Replaces vrenderer_pathtracer_tpu/render/pallas_mesh.py::_kernel.  One
// thread per pixel runs the whole general-scene bounce loop for `spp`
// samples of `bounces` steps, all path state in registers: the sphere
// table's running min (common.cuh nearest_sphere), the example sphere or
// the mesh (traverse.cuh traverse_wide, K3's search, then the winner's face
// normal, barycentric uv and tangent read by slot), the threefry draws of
// slots 0 and 1 (and 2 under lobe MIS), the Fresnel/diffuse/mirror scatter
// (common.cuh shade) and, on BRDF hits, the cosine direction with kernel
// factor 1 or the one-sample lobe MIS with factor cos / (pi p_mix).  Three
// tables enter the estimator only as factors: the HDRI at a miss, the
// diffuse texture's colour, the MERL reflectance.  K4 has two modes for
// them (render/cuda_mesh.py::mode picks one a pass):
//   * direct (every forward pass): the kernel fetches them itself, with the
//     address arithmetic and float32 operations of ops/envmap.py,
//     ops/texture.py and compose's MERL factor, through the read-only path
//     (the 64x128 HDRI is 98 KB, a 256^2 texture 786 KB, the MERL table 17.5
//     MB: all stay in the 50 MB L2), and writes depth and the rgb mean,
//     [4, N] float32: 16 bytes a pixel.  The texture and MERL factors
//     multiply a running product (compose's PD_b), the HDRI term is added
//     once, at the miss;
//   * records (a pass whose tables require a gradient: deferred_opt_step):
//     per-(sample, bounce) records instead of radiance, SoA [n_slots, N]
//     float32 in render/cuda_mesh.py layout's order: depth, then per (s, b)
//     A (emission weighted by the throughput), E (the throughput at a miss)
//     and dir (its direction), uv (+inf where no texture applies), midx (the
//     MERL index, -1 where none); Cornell mode zeroes the A and E of a sample
//     killed later; where nothing is deferred, the rgb mean.
//     render/cuda_mesh.py::compose fetches the tables in torch and composes
//     the image, differentiably.
// A launch may take a shard of the frame (parallel/sharding.py): the raster
// range [pixel_offset, pixel_offset + n_local), whatever its alignment, with
// the samples from sample_offset.  The pixels' global ids drive the primary
// rays and key the draws, and the outputs are the range's, [.., n_local].
// The plain PyTorch version of both is render/cuda_mesh.py::records_reference
// followed by compose.  The TPU kernel defers the fetches only because
// Mosaic has no per-lane gathers (pallas_mesh.py:12-31); a forward pass on
// Hopper has no use for the records.
//
// What bounds it on the H100: operations, divergence and the mesh search's
// cache misses, not device memory.  A pixel writes 16 bytes (direct) or
// 4 * n_slots (356 at the mesh-megakernel scene's 89 slots, 373 MB a 1024^2
// pass, which compose reads back with ~290 small ops); every live step
// costs a BVH search (tens of box and triangle tests), two or three
// 20-round threefry blocks, a few normalisations, sincos, pow and, on BRDF
// hits, acos/atan2 for the MERL index.  The design therefore:
//   * no intermediate in device memory in direct mode; the TPU kernel's
//     32x32 tile remap, block any-hit votes, VMEM/SMEM budgets and (8,128)
//     slot blocks are gone;
//   * a warp takes an 8x4 pixel tile, a block a column of four (pixel_of),
//     so a warp's rays are coherent in two dimensions and walk the same
//     nodes; the pixel index, the output layout and the threefry keys are
//     the raster ones.  A shard's blocks tile the image rows its range
//     touches, and threads outside the range (the first and last rows'
//     other pixels) exit at once;
//   * the mesh search is K3's own device function on the tree's compressed
//     copy (accel/wide.py: 80-byte nodes, 48-byte unpadded leaf rows;
//     distance-ordered, popped nodes culled, one local stack: traverse.cuh),
//     so K4 finds the same closest hits as K3;
//   * the sphere table in shared memory (common.cuh stage_spheres) and the
//     lobe-MIS tables (the sampler's mass and CDF, the 91 bin-edge cosines,
//     the 90 bin solid angles) beside it: the CDF's searchsorted(side=right)
//     is a binary search there;
//   * a path that has ended skips its remaining bounces' work (and in
//     records mode writes their inactive records);
//   * the records mode's four planted faults are run-time checks of Params
//     (0 in use); the direct mode's three (the HDRI a texel off in u, the
//     texture at 1 - v, the MERL factor unscaled) are template arguments of
//     instances of their own, so real launches hold none of them.
//
// Numerics: as common.cuh and traverse.cuh (no --use_fast_math; the sphere
// quadratic, the hit point and the primary ray in round-to-nearest
// arithmetic; the fetches' blends round each product and sum, as torch's
// elementwise ops do).  The MERL index uses libdevice acosf and atan2f, as
// the plain version does through torch; the bin edges come from the same
// float32 tables as the plain version's, not from the closed form.

#include "common.cuh"
#include "traverse.cuh"

namespace {

using namespace vpt;

// A warp takes an 8x4 pixel tile and a block a column of four such tiles,
// 8x16 pixels (pixel_of).
constexpr int kTileW = 8, kTileH = 4, kWarps = 4;
constexpr int kThreads = 32 * kWarps;
constexpr int kBlockH = kTileH * kWarps;
// Blocks an SM must hold (__launch_bounds__): six, 768 threads, at 80
// registers with ~124 B of spills, which is also what ptxas picks with no
// minimum, and times the same.  Four blocks (106 registers, no spills) were
// 7-11% slower on the mesh scenes in both modes (PERF.md §6): the walk's
// dependent loads want the warps more than the spills cost.
constexpr int kMinBlocks = 6;
constexpr float kPi = 3.14159265358979323846f;
constexpr float kInvPi = 0.318309886183790671538f;
constexpr float kRad = 57.2957795130823208768f;      // 180 / pi = 90 / (pi/2)
constexpr float kTwoOverPi = 0.636619772367581343076f;
constexpr int kResThetaH = 90, kResThetaD = 90, kResPhiD = 180;
// mass [90], cdf [90], cos edges [91], bin solid angles [90]
constexpr int kMisFloats = 90 + 90 + 91 + 90;
constexpr float kExampleRadius = 10.f;  // scene/spheres.py, at the origin

// Flag bits (render/cuda_mesh.py).
constexpr int kFlagCornell = 1, kFlagExample = 2, kFlagMesh = 4,
              kFlagUseBrdf = 8, kFlagEnv = 16, kFlagTex = 32, kFlagMerl = 64,
              kFlagMis = 128;
// Planted faults (render/cuda_mesh.py; 0 in every real launch): the records
// mode's, read from Params at run time, and the direct mode's, template
// arguments of their own instances.
constexpr int kFaultMisFactor = 1, kFaultMerlIndex = 2, kFaultKill = 3,
              kFaultUv = 4;
constexpr int kFaultEnvU = 5, kFaultTexV = 6, kFaultMerlScale = 7;

// Work counters (`stats`): BVH node visits, box tests and triangle tests;
// traced steps (a live path's scene intersection), hits (a scatter), BRDF
// hits (a MERL index) and lobe-MIS draws; in direct mode the HDRI and
// diffuse-texture fetches (the MERL fetches are the BRDF hits).
constexpr int kStats = 9;

// ops/brdf.py: the MERL table size and CHANNEL_SCALE (float32 of the
// double quotients, as numpy rounds them); ops/envmap.py ENV_SCALE.
constexpr int kTableSize = kResThetaH * kResThetaD * kResPhiD;
constexpr float kChannelScale0 = static_cast<float>(1.0 / 1500.0);
constexpr float kChannelScale1 = static_cast<float>(1.15 / 1500.0);
constexpr float kChannelScale2 = static_cast<float>(1.66 / 1500.0);
constexpr float kEnvScale = 2.f;

// The launch's arguments; render/cuda_mesh.py::_Params, field for field.
struct Params {
  const float* cam;       // [14] pack_camera
  const float* spheres;   // [n_spheres, 14] pack_spheres
  const uint4* nodes;     // mesh: the compressed 8-wide copy [M, 20 words],
  const float4* rows;     // its leaf rows [R, 12 words]; null without a mesh
  const float* tri_e1;    // [T, 3] by slot
  const float* tri_e2;    // [T, 3]
  const float* tri_uv;    // [T, 3, 2]
  const float* tri_t;     // [T, 3, 3]
  const float* mis;       // [kMisFloats], null without lobe MIS
  float* records;         // [n_slots, n_local]; direct mode [4, n_local]
  unsigned long long* stats;  // null, or kStats counters the kernel adds to
  int n_spheres, width, height, spp, bounces, flags;
  int per_sb, off_a, off_e, off_dir, off_uv, off_midx, rgb_slot, fault;
  uint32_t seed_lo, seed_hi, frame;
  float depth_scale, fault_arg;
  // Direct mode (fetching the tables in the kernel): the HDRI [hdr_h,
  // hdr_w, 3], the diffuse texture [tex_h, tex_w, 3] and the MERL table
  // [3, kTableSize], each null where its flag is off; `bilinear` the
  // texture filter (settings.texture_filter), `direct` the mode.
  const float* hdr;
  const float* tex;
  const float* brdf;
  int hdr_w, hdr_h, tex_w, tex_h, bilinear, direct;
  // The shard: the raster range [pixel_offset, pixel_offset + n_local) and
  // the first sample id (0, width * height and 0 for the whole frame).
  int pixel_offset, n_local;
  uint32_t sample_offset;
};

__device__ __forceinline__ float clampf(float x, float lo, float hi) {
  return fminf(fmaxf(x, lo), hi);
}

__device__ __forceinline__ float dot3(float ax, float ay, float az, float bx,
                                      float by, float bz) {
  return ax * bx + ay * by + az * bz;
}

// x / max(|x|, eps) (ops/brdf.py _norm).
__device__ __forceinline__ void unit(float& x, float& y, float& z, float eps) {
  const float len = fmaxf(sqrtf(x * x + y * y + z * z), eps);
  x = x / len;
  y = y / len;
  z = z / len;
}

// ops/brdf.py::merl_index: the flat MERL table index of the scattered
// direction o for the incoming direction i, normal n and tangent t.
__device__ int merl_index(float ox, float oy, float oz, float ix, float iy,
                          float iz, float nx, float ny, float nz, float tx,
                          float ty, float tz) {
  const float bx = ny * tz - nz * ty, by = nz * tx - nx * tz,
              bz = nx * ty - ny * tx;
  float hx = ox - ix, hy = oy - iy, hz = oz - iz;
  unit(hx, hy, hz, 1e-12f);
  float theta_h = acosf(clampf(dot3(nx, ny, nz, hx, hy, hz), 0.f, 1.f));
  const float theta_d = acosf(clampf(dot3(hx, hy, hz, ox, oy, oz), 0.f, 1.f));
  const float phi_tangent =
      atan2f(clampf(-dot3(ox, oy, oz, bx, by, bz), -1.f, 1.f),
             clampf(dot3(ox, oy, oz, tx, ty, tz), -1.f, 1.f));
  const float nh = dot3(nx, ny, nz, hx, hy, hz);
  float ux = nx - nh * hx, uy = ny - nh * hy, uz = nz - nh * hz;
  unit(ux, uy, uz, 1e-12f);
  ux = -ux; uy = -uy; uz = -uz;
  const float vx = hy * uz - hz * uy, vy = hz * ux - hx * uz,
              vz = hx * uy - hy * ux;
  const float phi_gs = atan2f(clampf(dot3(ox, oy, oz, vx, vy, vz), -1.f, 1.f),
                              clampf(dot3(ox, oy, oz, ux, uy, uz), -1.f, 1.f));
  const bool small_td = theta_d < 1e-3f;
  const bool big_th = theta_h > 1e-3f;
  float phi_d = small_td ? phi_tangent : (big_th ? phi_gs : 0.f);
  theta_h = (small_td || big_th) ? theta_h : 0.f;
  if (phi_d < 0.f) phi_d = phi_d + kPi;
  const int idx_pd = min(max(static_cast<int>(phi_d * kRad), 0), kResPhiD - 1);
  const int idx_th =
      theta_h <= 0.f
          ? 0
          : min(max(static_cast<int>(sqrtf(theta_h * kTwoOverPi) * kResThetaH), 0),
                kResThetaH - 1);
  const int idx_td = min(max(static_cast<int>(theta_d * kRad), 0), kResThetaD - 1);
  return idx_pd + idx_td * kResPhiD + idx_th * kResPhiD * kResThetaD;
}

// ops/brdf_sampling.py::mis_direction: replaces the cosine direction (cd)
// by a lobe draw where u_reflect < 0.5 and returns the kernel factor
// cos / (pi p_mix) (0 where p_mix is 0) of the final direction bd.
__device__ float lobe_mis(const float* mis, float dx, float dy, float dz,
                          float nx, float ny, float nz, float cdx, float cdy,
                          float cdz, float u_reflect, float u_b1, float u_b2,
                          float u_phi, float& bdx, float& bdy, float& bdz) {
  const float* mass = mis;
  const float* cdf = mis + 90;
  const float* cos_e = mis + 180;
  const float* domega = mis + 271;
  // searchsorted(cdf, u_b1, side="right"): the count of entries <= u_b1.
  int lo = 0, hi = kResThetaH;
  while (lo < hi) {
    const int mid = (lo + hi) >> 1;
    if (cdf[mid] <= u_b1) lo = mid + 1; else hi = mid;
  }
  const int bin = min(lo, kResThetaH - 1);
  const float c_lo = cos_e[bin], c_hi = cos_e[bin + 1];
  const float cos_th = c_lo - u_b2 * (c_lo - c_hi);
  const float sin_th = sqrtf(fmaxf(1.f - cos_th * cos_th, 0.f));
  const float phi = kTwoPi * u_phi;
  float ax, ay, ux, uy, uz, vx, vy, vz;
  cosine_frame(nx, ny, nz, ax, ay, ux, uy, uz, vx, vy, vz);
  const float cpc = cosf(phi) * sin_th, spc = sinf(phi) * sin_th;
  const float hx = ux * cpc + vx * spc + nx * cos_th;
  const float hy = uy * cpc + vy * spc + ny * cos_th;
  const float hz = uz * cpc + vz * spc + nz * cos_th;
  const float wix = -dx, wiy = -dy, wiz = -dz;
  const float wih = dot3(wix, wiy, wiz, hx, hy, hz);
  float lx = 2.f * wih * hx - wix, ly = 2.f * wih * hy - wiy,
        lz = 2.f * wih * hz - wiz;
  unit(lx, ly, lz, 1e-20f);
  const bool take_lobe = u_reflect < 0.5f;
  bdx = take_lobe ? lx : cdx;
  bdy = take_lobe ? ly : cdy;
  bdz = take_lobe ? lz : cdz;
  // The mixture pdf of the final direction (pdf_lobe, pdf_cosine).
  float h2x = wix + bdx, h2y = wiy + bdy, h2z = wiz + bdz;
  unit(h2x, h2y, h2z, 1e-20f);
  float c2 = dot3(nx, ny, nz, h2x, h2y, h2z);
  if (c2 < 0.f) { h2x = -h2x; h2y = -h2y; h2z = -h2z; }
  c2 = fabsf(c2);
  const float th2 = acosf(clampf(c2, 0.f, 1.f));
  const int i2 = min(max(static_cast<int>(sqrtf(th2 * kTwoOverPi) * kResThetaH), 0),
                     kResThetaH - 1);
  const float p_h = mass[i2] / domega[i2];
  const float wih2 = fabsf(dot3(wix, wiy, wiz, h2x, h2y, h2z));
  const float p_lobe = p_h / fmaxf(4.f * wih2, 1e-6f);
  const float cos_o = fmaxf(dot3(nx, ny, nz, bdx, bdy, bdz), 0.f);
  const float p_cos = cos_o / kPi;
  const float p_mix = 0.5f * p_lobe + 0.5f * p_cos;
  return p_mix > 0.f ? kInvPi * cos_o / fmaxf(p_mix, 1e-8f) : 0.f;
}

// ops/envmap.py: direction_to_latlong, then sample_env_nearest or
// sample_env_bilinear, times ENV_SCALE, in the same float32 operations
// (each product and sum rounded on its own, as torch's elementwise ops
// round them).  kFault == kFaultEnvU reads one texel on in u.
template <int kFault>
__device__ void env_fetch(const float* __restrict__ hdr, int w, int h,
                          bool bilinear, float dx, float dy, float dz,
                          float out[3]) {
  float u = atan2f(dx, dz);
  u = u < 0.f ? __fadd_rn(u, kTwoPi) : u;
  u = __fdiv_rn(u, kTwoPi);
  const float v = __fdiv_rn(acosf(clampf(dy, -1.f, 1.f)), kPi);
  const int shift = kFault == kFaultEnvU ? 1 : 0;
  if (!bilinear) {
    const int x = static_cast<int>(__fmul_rn(u, static_cast<float>(w))) + shift;
    const int y = static_cast<int>(__fmul_rn(v, static_cast<float>(h)));
    const float* c = hdr + 3 * min(max(x + y * w, 0), w * h - 1);
#pragma unroll
    for (int k = 0; k < 3; ++k) out[k] = __fmul_rn(__ldg(c + k), kEnvScale);
    return;
  }
  const float fx = __fsub_rn(__fmul_rn(u, static_cast<float>(w)), 0.5f);
  const float fy = __fsub_rn(__fmul_rn(v, static_cast<float>(h)), 0.5f);
  const int xf = static_cast<int>(floorf(fx)), yf = static_cast<int>(floorf(fy));
  const float wx = __fsub_rn(fx, static_cast<float>(xf));
  const float wy = __fsub_rn(fy, static_cast<float>(yf));
  const int xa = xf + shift;
  const int x0 = ((xa % w) + w) % w, x1 = (((xa + 1) % w) + w) % w;  // wrap in u
  const int y0 = min(max(yf, 0), h - 1), y1 = min(max(yf + 1, 0), h - 1);
  const float *c00 = hdr + 3 * (x0 + y0 * w), *c10 = hdr + 3 * (x1 + y0 * w);
  const float *c01 = hdr + 3 * (x0 + y1 * w), *c11 = hdr + 3 * (x1 + y1 * w);
  const float ux = __fsub_rn(1.f, wx), uy = __fsub_rn(1.f, wy);
#pragma unroll
  for (int k = 0; k < 3; ++k) {
    const float top = __fadd_rn(__fmul_rn(__ldg(c00 + k), ux), __fmul_rn(__ldg(c10 + k), wx));
    const float bot = __fadd_rn(__fmul_rn(__ldg(c01 + k), ux), __fmul_rn(__ldg(c11 + k), wx));
    out[k] = __fmul_rn(__fadd_rn(__fmul_rn(top, uy), __fmul_rn(bot, wy)), kEnvScale);
  }
}

// ops/texture.py: fetch_nearest (the flat index clamped) or the clamped
// fetch_bilinear of a [h, w, 3] texture at (u, v), in the same float32
// operations.  kFault == kFaultTexV reads at 1 - v.
template <int kFault>
__device__ void tex_fetch(const float* __restrict__ tex, int w, int h,
                          bool bilinear, float u, float v, float out[3]) {
  if (kFault == kFaultTexV) v = __fsub_rn(1.f, v);
  if (!bilinear) {
    const int x = static_cast<int>(__fmul_rn(u, static_cast<float>(w)));
    const int y = static_cast<int>(__fmul_rn(v, static_cast<float>(h)));
    const float* c = tex + 3 * min(max(x + y * w, 0), w * h - 1);
#pragma unroll
    for (int k = 0; k < 3; ++k) out[k] = __ldg(c + k);
    return;
  }
  const float fx = __fsub_rn(__fmul_rn(u, static_cast<float>(w)), 0.5f);
  const float fy = __fsub_rn(__fmul_rn(v, static_cast<float>(h)), 0.5f);
  const int xf = static_cast<int>(floorf(fx)), yf = static_cast<int>(floorf(fy));
  const float wx = __fsub_rn(fx, static_cast<float>(xf));
  const float wy = __fsub_rn(fy, static_cast<float>(yf));
  const int x0 = min(max(xf, 0), w - 1), x1 = min(max(xf + 1, 0), w - 1);
  const int y0 = min(max(yf, 0), h - 1), y1 = min(max(yf + 1, 0), h - 1);
  const float *c00 = tex + 3 * (x0 + y0 * w), *c10 = tex + 3 * (x1 + y0 * w);
  const float *c01 = tex + 3 * (x0 + y1 * w), *c11 = tex + 3 * (x1 + y1 * w);
  const float ux = __fsub_rn(1.f, wx), uy = __fsub_rn(1.f, wy);
#pragma unroll
  for (int k = 0; k < 3; ++k) {
    const float top = __fadd_rn(__fmul_rn(__ldg(c00 + k), ux), __fmul_rn(__ldg(c10 + k), wx));
    const float bot = __fadd_rn(__fmul_rn(__ldg(c01 + k), ux), __fmul_rn(__ldg(c11 + k), wx));
    out[k] = __fadd_rn(__fmul_rn(top, uy), __fmul_rn(bot, wy));
  }
}

// The MERL factor of compose: 24 * max(brdf[c, k] * CHANNEL_SCALE[c], 0)
// (ops/brdf.py lookup_brdf, cuda_mesh.py compose).  kFault ==
// kFaultMerlScale drops the channel scale.
template <int kFault>
__device__ __forceinline__ void merl_factor(const float* __restrict__ brdf, int k,
                                            float out[3]) {
#pragma unroll
  for (int c = 0; c < 3; ++c) {
    const float raw = __ldg(brdf + c * kTableSize + k);
    const float scale = c == 0 ? kChannelScale0 : (c == 1 ? kChannelScale1 : kChannelScale2);
    const float val = kFault == kFaultMerlScale ? raw : __fmul_rn(raw, scale);
    out[c] = __fmul_rn(24.f, fmaxf(val, 0.f));
  }
}

// The pixel of this thread: a warp covers an 8x4 tile, a block a column of
// kWarps tiles (8x16 pixels), the blocks in raster order over the image rows
// that the range [offset, offset + n_local) touches; -1 outside the range.
// The pixel index is the raster one, so the output layout and the threefry
// keys are those of a raster-order thread mapping.
__device__ __forceinline__ int pixel_of(int width, int offset, int n_local) {
  const int cols = (width + kTileW - 1) / kTileW;
  const int bx = blockIdx.x % cols, by = blockIdx.x / cols;
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int x = bx * kTileW + (lane % kTileW);
  const int y = offset / width + by * kBlockH + warp * kTileH + lane / kTileW;
  const long long pixel = static_cast<long long>(y) * width + x;
  return x < width && pixel >= offset && pixel < offset + n_local
             ? static_cast<int>(pixel) : -1;
}

// K4.  kDirect: fetch the tables here and write depth and rgb ([4, N]),
// else the records; kDFault: a planted fault of the direct mode (0, or
// kFaultEnvU, kFaultTexV, kFaultMerlScale); kMesh: the scene has a mesh
// (kFlagMesh).  A scene without one runs an instance without the walk:
// inlined, the walk's node decode shares the path loop's 80 registers, and
// the spills it moves into the loop slowed scenes that never walk (config
// 4 by 20-38% on an H100, chip_smoke.py; PERF.md).
template <bool kDirect, int kDFault, bool kMesh>
__global__ void __launch_bounds__(kThreads, kMinBlocks) mesh_kernel(const Params p) {
  extern __shared__ float smem[];  // [kMisFloats] MIS tables, then spheres
  const bool mis = p.flags & kFlagMis;
  if (mis) {
    for (int i = threadIdx.x; i < kMisFloats; i += blockDim.x) smem[i] = p.mis[i];
    __syncthreads();
  }
  const float* mis_t = smem;
  const float* sph = stage_spheres(smem + (mis ? kMisFloats : 0), p.spheres,
                                   p.n_spheres);

  const int pixel = pixel_of(p.width, p.pixel_offset, p.n_local);
  if (pixel < 0) return;

  const bool cornell = p.flags & kFlagCornell;
  const bool use_example = p.flags & kFlagExample;
  constexpr bool has_mesh = kMesh;
  const bool use_brdf = p.flags & kFlagUseBrdf;
  const bool d_env = p.flags & kFlagEnv;
  const bool d_tex = p.flags & kFlagTex;
  const bool d_merl = p.flags & kFlagMerl;
  const bool d_emit = d_tex || d_merl;
  const bool bilinear = p.bilinear != 0;
  const float inactive_u = __int_as_float(0x7f800000);  // +inf: no texture
  const float fc = p.cam[12], fp = p.cam[13];
  float* rec = p.records + (pixel - p.pixel_offset);
  const size_t stride = static_cast<size_t>(p.n_local);
  auto put = [&](int slot, float v) { rec[slot * stride] = v; };

  float u0, v0, d0[3];
  primary_ray(p.cam, pixel, p.width, p.height, u0, v0, d0[0], d0[1], d0[2]);

  float acc[3] = {0.f, 0.f, 0.f};
  float depth = 1.f;
  Work work;
  unsigned traced = 0, hits = 0, brdf_hits = 0, mis_draws = 0, env_fetches = 0,
           tex_fetches = 0;
  for (int s = 0; s < p.spp; ++s) {
    const uint32_t sid = p.sample_offset + s;  // the sample's global id
    float o[3] = {p.cam[0], p.cam[1], p.cam[2]};
    float d[3] = {d0[0], d0[1], d0[2]};
    float m[3] = {1.f, 1.f, 1.f};
    // Direct mode: pd, the product of the fetched factors so far (compose's
    // PD_b); sr, sg, sb the sample's radiance in both modes (records mode:
    // the emission summed where nothing is deferred).
    float pd[3] = {1.f, 1.f, 1.f};
    float sr = 0.f, sg = 0.f, sb = 0.f;
    bool alive = true, killed = false;
    for (int b = 0; b < p.bounces; ++b) {
      const int base = 1 + (s * p.bounces + b) * p.per_sb;
      float best_t = kInf;
      int best = -1;
      // The winner: 0 none, 1 a sphere row, 2 the example sphere, 3 the mesh.
      int kind = 0;
      Hit mh;
      mh.slot = -1;
      if (alive) {
        ++traced;
        bool near_root;
        best = nearest_sphere(sph, p.n_spheres, o[0], o[1], o[2], d[0], d[1],
                              d[2], best_t, near_root);
        kind = best >= 0 ? 1 : 0;
        if (use_example) {
          const float row[4] = {0.f, 0.f, 0.f, kExampleRadius};
          float bq, det;
          sphere_quadratic(row, o[0], o[1], o[2], d[0], d[1], d[2], bq, det);
          if (det >= 0.f) {
            const float sq = sqrtf(det);
            const float tn = __fsub_rn(bq, sq), tf = __fadd_rn(bq, sq);
            const float t = tn > kSphereEps ? tn : (tf > kSphereEps ? tf : 0.f);
            if (t > 0.f && t < best_t) {
              best_t = t;
              kind = 2;
            }
          }
        } else if (has_mesh) {
          const Ray r = make_ray(o[0], o[1], o[2], d[0], d[1], d[2]);
          mh = traverse_wide(p.nodes, p.rows, r, best_t, work);
          if (mh.slot >= 0) {
            best_t = mh.t;
            kind = 3;
          }
        }
      }
      const bool live = alive && kind != 0;
      const bool miss = alive && kind == 0;
      if (cornell && miss) killed = true;
      if (b == 0 && live) depth = best_t / p.depth_scale;

      // Emission (spheres only), weighted by the throughput.
      float em[3] = {0.f, 0.f, 0.f};
      if (kind == 1) {
        const float* hs = sph + best * kCols;
        em[0] = hs[7]; em[1] = hs[8]; em[2] = hs[9];
      }
      const float ar = live ? m[0] * em[0] : 0.f;
      const float ag = live ? m[1] * em[1] : 0.f;
      const float ab = live ? m[2] * em[2] : 0.f;
      if (kDirect) {
        // compose: A_b * PD_b, and at the miss E_b * PD_b * env(dir_b).
        sr += ar * pd[0]; sg += ag * pd[1]; sb += ab * pd[2];
        if (d_env && miss) {
          const float er = m[0] * pd[0], eg = m[1] * pd[1], eb = m[2] * pd[2];
          if (er != 0.f || eg != 0.f || eb != 0.f) {  // compose's ever_missed
            float env[3];
            env_fetch<kDFault>(p.hdr, p.hdr_w, p.hdr_h, bilinear, d[0], d[1], d[2], env);
            sr += er * env[0]; sg += eg * env[1]; sb += eb * env[2];
            ++env_fetches;
          }
        }
      } else {
        if (d_emit) {
          put(base + p.off_a, ar);
          put(base + p.off_a + 1, ag);
          put(base + p.off_a + 2, ab);
        } else {
          sr += ar; sg += ag; sb += ab;
        }
        if (d_env) {
          put(base + p.off_e, miss ? m[0] : 0.f);
          put(base + p.off_e + 1, miss ? m[1] : 0.f);
          put(base + p.off_e + 2, miss ? m[2] : 0.f);
          put(base + p.off_dir, d[0]);
          put(base + p.off_dir + 1, d[1]);
          put(base + p.off_dir + 2, d[2]);
        }
      }
      if (!live) {
        if (!kDirect) {
          if (d_tex) {
            put(base + p.off_uv, inactive_u);
            put(base + p.off_uv + 1, 0.f);
          }
          if (d_merl) put(base + p.off_midx, -1.f);
        }
        alive = false;
        continue;
      }

      // The surface at the hit.
      ++hits;
      Scatter sc;
      sc.px = __fadd_rn(o[0], __fmul_rn(d[0], best_t));
      sc.py = __fadd_rn(o[1], __fmul_rn(d[1], best_t));
      sc.pz = __fadd_rn(o[2], __fmul_rn(d[2], best_t));
      const float one[3] = {1.f, 1.f, 1.f}, zero[3] = {0.f, 0.f, 0.f};
      const float* col = one;
      const float* spec = zero;
      int refl = kDiff;
      bool is_brdf = false;
      float uv_u = 0.f, uv_v = 0.f, tx = 1.f, ty = 0.f, tz = 0.f;
      if (kind == 1) {
        const float* hs = sph + best * kCols;
        sc.nx = sc.px - hs[0];
        sc.ny = sc.py - hs[1];
        sc.nz = sc.pz - hs[2];
        normalize(sc.nx, sc.ny, sc.nz);
        col = hs + 4;
        spec = hs + 10;
        refl = static_cast<int>(hs[13]);
      } else if (kind == 2) {
        sc.nx = sc.px;
        sc.ny = sc.py;
        sc.nz = sc.pz;
        normalize(sc.nx, sc.ny, sc.nz);
        is_brdf = use_brdf;
        if (d_tex) {
          uv_u = atan2f(sc.nx, sc.nz) / kTwoPi + 0.5f;
          uv_v = sc.ny * 0.5f + 0.5f;
        }
        if (d_merl) {  // the spherical tangent estimate
          const float pr = fmaxf(sqrtf(sc.px * sc.px + sc.py * sc.py + sc.pz * sc.pz),
                                 1e-12f);
          const float theta = acosf(clampf(sc.pz / pr, -1.f, 1.f));
          const float phi = atan2f(sc.py, sc.px);
          tx = sinf(theta) * cosf(phi);
          ty = sinf(theta) * sinf(phi);
          tz = cosf(theta);
        }
      } else {  // the mesh: face normal, barycentric uv and tangent by slot
        const size_t k = static_cast<size_t>(mh.slot);
        const float* e1 = p.tri_e1 + 3 * k;
        const float* e2 = p.tri_e2 + 3 * k;
        const float fx = e1[1] * e2[2] - e1[2] * e2[1];
        const float fy = e1[2] * e2[0] - e1[0] * e2[2];
        const float fz = e1[0] * e2[1] - e1[1] * e2[0];
        const float finv = 1.f / fmaxf(sqrtf(fx * fx + fy * fy + fz * fz), 1e-20f);
        sc.nx = fx * finv;
        sc.ny = fy * finv;
        sc.nz = fz * finv;
        is_brdf = use_brdf;
        const float bw = 1.f - mh.u - mh.v;
        if (d_tex) {
          const float* c = p.tri_uv + 6 * k;
          uv_u = bw * c[0] + mh.u * c[2] + mh.v * c[4];
          uv_v = bw * c[1] + mh.u * c[3] + mh.v * c[5];
        }
        if (d_merl) {
          const float* c = p.tri_t + 9 * k;
          tx = bw * c[0] + mh.u * c[3] + mh.v * c[6];
          ty = bw * c[1] + mh.u * c[4] + mh.v * c[7];
          tz = bw * c[2] + mh.u * c[5] + mh.v * c[8];
          const float tinv = 1.f / fmaxf(sqrtf(tx * tx + ty * ty + tz * tz), 1e-20f);
          tx *= tinv;
          ty *= tinv;
          tz *= tinv;
        }
      }

      float u_reflect, unused, u_phi, u_r;
      draw(p.seed_lo, p.seed_hi, pixel, p.frame, sid, b, 0, u_reflect, unused);
      draw(p.seed_lo, p.seed_hi, pixel, p.frame, sid, b, 1, u_phi, u_r);
      shade(sc, col, spec, is_brdf ? kBrdf : refl, d[0], d[1], d[2], u_reflect,
            u_phi, u_r, fc, fp);

      if (d_merl) {
        // BRDF hits: the cosine direction with factor 1, or the lobe MIS
        // draw with factor cos / (pi p_mix); the table's value is the
        // records' midx (records mode) or a factor of pd (direct mode).
        float midx = -1.f;
        if (is_brdf) {
          float bdx = sc.cdx, bdy = sc.cdy, bdz = sc.cdz, fac = 1.f;
          if (mis) {
            float u_b1, u_b2;
            draw(p.seed_lo, p.seed_hi, pixel, p.frame, sid, b, 2, u_b1, u_b2);
            fac = lobe_mis(mis_t, d[0], d[1], d[2], sc.nx, sc.ny, sc.nz, sc.cdx,
                           sc.cdy, sc.cdz, u_reflect, u_b1, u_b2, u_phi, bdx,
                           bdy, bdz);
            if (p.fault == kFaultMisFactor) fac = 1.f;
            ++mis_draws;
          }
          sc.ndx = bdx; sc.ndy = bdy; sc.ndz = bdz;
          sc.tr = sc.tg = sc.tb = fac;
          int k = merl_index(bdx, bdy, bdz, d[0], d[1], d[2], sc.nx, sc.ny,
                             sc.nz, tx, ty, tz);
          if (p.fault == kFaultMerlIndex) k += (k % kResPhiD == kResPhiD - 1) ? 1 - kResPhiD : 1;
          midx = static_cast<float>(k);
          ++brdf_hits;
          if (kDirect) {
            float f[3];
            merl_factor<kDFault>(p.brdf, k, f);
            pd[0] *= f[0]; pd[1] *= f[1]; pd[2] *= f[2];
          }
        }
        if (!kDirect) put(base + p.off_midx, midx);
      }
      if (d_tex) {
        // A textured hit that is neither BRDF-typed nor mirrored; its
        // colour (1 in the kernel) is the fetch at uv.
        const bool active = kind >= 2 && !sc.take_reflect && !is_brdf;
        if (kDirect) {
          if (active) {
            float f[3];
            tex_fetch<kDFault>(p.tex, p.tex_w, p.tex_h, bilinear, uv_u, uv_v, f);
            pd[0] *= f[0]; pd[1] *= f[1]; pd[2] *= f[2];
            ++tex_fetches;
          }
        } else {
          const float shift = p.fault == kFaultUv ? p.fault_arg : 0.f;
          put(base + p.off_uv, active ? uv_u + shift : inactive_u);
          put(base + p.off_uv + 1, active ? uv_v : 0.f);
        }
      }

      o[0] = sc.px + kOriginOffset * sc.nx;
      o[1] = sc.py + kOriginOffset * sc.ny;
      o[2] = sc.pz + kOriginOffset * sc.nz;
      d[0] = sc.ndx; d[1] = sc.ndy; d[2] = sc.ndz;
      m[0] *= sc.tr; m[1] *= sc.tg; m[2] *= sc.tb;
    }

    // Cornell: a sample that missed at some bounce contributes nothing.
    if (killed) {
      depth = 0.f;
      if (p.fault != kFaultKill) {
        sr = sg = sb = 0.f;
        if (!kDirect) {
          for (int b = 0; b < p.bounces; ++b) {
            const int base = 1 + (s * p.bounces + b) * p.per_sb;
            for (int c = 0; c < 3; ++c) {
              if (d_emit) put(base + p.off_a + c, 0.f);
              if (d_env) put(base + p.off_e + c, 0.f);
            }
          }
        }
      }
    }
    acc[0] += sr;
    acc[1] += sg;
    acc[2] += sb;
  }

  if (p.stats != nullptr) {
    const unsigned counts[kStats] = {work.visits, work.boxes, work.tris, traced,
                                     hits, brdf_hits, mis_draws, env_fetches,
                                     tex_fetches};
    for (int i = 0; i < kStats; ++i) {
      atomicAdd(p.stats + i, static_cast<unsigned long long>(counts[i]));
    }
  }
  put(0, depth);
  if (kDirect) {  // compose's total / spp
    const float spp = static_cast<float>(p.spp);
    put(1, acc[0] / spp);
    put(2, acc[1] / spp);
    put(3, acc[2] / spp);
  } else if (p.rgb_slot >= 0) {
    const float inv_spp = 1.f / static_cast<float>(p.spp);
    put(p.rgb_slot, acc[0] * inv_spp);
    put(p.rgb_slot + 1, acc[1] * inv_spp);
    put(p.rgb_slot + 2, acc[2] * inv_spp);
  }
}

}  // namespace

// Launches K4 on `stream` and returns cudaGetLastError() (0 on success), or
// cudaErrorInvalidValue (1) for arguments no instance takes.  `params` is a
// host pointer to the launch's arguments (device pointers and scalars,
// render/cuda_mesh.py::_Params); it is copied into the launch.  The mode
// (p.direct), the direct mode's planted fault (p.fault 5-7) and whether
// the scene has a mesh (kFlagMesh) pick the instance.
extern "C" int vpt_mesh(const void* params, void* stream) {
  const Params& p = *static_cast<const Params*>(params);
  const long long n = static_cast<long long>(p.width) * p.height;
  if (n <= 0 || p.pixel_offset < 0 || p.n_local <= 0 ||
      p.pixel_offset + static_cast<long long>(p.n_local) > n) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  const int cols = (p.width + kTileW - 1) / kTileW;
  const int rows = (p.pixel_offset + p.n_local - 1) / p.width -
                   p.pixel_offset / p.width + 1;
  const int blocks = cols * ((rows + kBlockH - 1) / kBlockH);
  const size_t smem = sizeof(float) * ((p.flags & kFlagMis) ? kMisFloats : 0) +
                      sphere_smem_bytes(p.n_spheres);
  const auto s = static_cast<cudaStream_t>(stream);
  const bool direct_fault = p.fault >= kFaultEnvU;
  if (direct_fault && (!p.direct || p.fault > kFaultMerlScale)) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  if (p.direct && p.fault != 0 && !direct_fault) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  const bool mesh = p.flags & kFlagMesh;
#define VPT_K4(DIRECT, FAULT, PARAMS)                                                  \
  do {                                                                                 \
    if (mesh) {                                                                        \
      mesh_kernel<DIRECT, FAULT, true><<<blocks, kThreads, smem, s>>>(PARAMS);         \
    } else {                                                                           \
      mesh_kernel<DIRECT, FAULT, false><<<blocks, kThreads, smem, s>>>(PARAMS);        \
    }                                                                                  \
  } while (0)
  if (!p.direct) {
    VPT_K4(false, 0, p);
    return static_cast<int>(cudaGetLastError());
  }
  Params q = p;
  q.fault = 0;  // the direct faults are the instances' own
  switch (p.fault) {
    case kFaultEnvU: VPT_K4(true, kFaultEnvU, q); break;
    case kFaultTexV: VPT_K4(true, kFaultTexV, q); break;
    case kFaultMerlScale: VPT_K4(true, kFaultMerlScale, q); break;
    default: VPT_K4(true, 0, q);
  }
#undef VPT_K4
  return static_cast<int>(cudaGetLastError());
}
