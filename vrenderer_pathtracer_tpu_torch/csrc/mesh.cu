// K4: the fused mesh-scene kernel, hand-written CUDA C++ for Hopper (sm_90a).
//
// Replaces vrenderer_pathtracer_tpu/render/pallas_mesh.py::_kernel.  One
// thread per pixel, in raster order, runs the whole general-scene bounce
// loop for `spp` samples of `bounces` steps, all path state in registers:
// the sphere table's running min (common.cuh nearest_sphere), the example
// sphere or the mesh (traverse.cuh traverse_wide, K3's search, then the
// winner's face normal, barycentric uv and tangent read by slot), the
// threefry draws of slots 0 and 1 (and 2 under lobe MIS), the
// Fresnel/diffuse/mirror scatter (common.cuh shade) and, on BRDF hits, the
// cosine direction with kernel factor 1 or the one-sample lobe MIS with
// factor cos / (pi p_mix).  Wherever a table's value enters the estimator
// only as a factor (the HDRI at a miss, the diffuse texture's colour, the
// MERL reflectance) the kernel writes per-(sample, bounce) records instead
// of radiance, SoA [n_slots, N] float32 in render/cuda_mesh.py layout's
// order: depth, then per (s, b) A (emission weighted by the throughput), E
// (the throughput at a miss) and dir (its direction), uv (+inf where no
// texture applies), midx (the MERL index, -1 where none); Cornell mode zeroes
// the A and E of a sample killed later.  Where nothing is deferred it writes
// the rgb mean (and depth) directly.  render/cuda_mesh.py::compose fetches
// the tables and composes the image; its plain PyTorch version is
// render/cuda_mesh.py::records_reference.
//
// What bounds it on the H100: operations, divergence and the mesh search's
// cache misses, not device memory.  A pixel writes 4 * n_slots bytes (356 at
// the nm-class mesh scene's 89 slots) and reads a few small tables; every
// live step costs a BVH search (tens of box and triangle tests), two or
// three 20-round threefry blocks, a few normalisations, sincos, pow and, on
// BRDF hits, acos/atan2 for the MERL index.  The design therefore:
//   * one thread per pixel, no intermediate in device memory but the
//     records; the TPU kernel's 32x32 tile remap, block any-hit votes,
//     VMEM/SMEM budgets and (8,128) slot blocks are gone;
//   * the sphere table in shared memory (common.cuh stage_spheres) and the
//     lobe-MIS tables (the sampler's mass and CDF, the 91 bin-edge cosines,
//     the 90 bin solid angles) beside it: the CDF's searchsorted(side=right)
//     is a binary search there;
//   * a path that has ended skips its remaining bounces' work and writes
//     their inactive records;
//   * the mesh search is K3's own device function, so K4 finds the same
//     closest hits as K3.
//
// Numerics: as common.cuh and traverse.cuh (no --use_fast_math; the sphere
// quadratic, the hit point and the primary ray in round-to-nearest
// arithmetic).  The MERL index uses libdevice acosf and atan2f, as the plain
// version does through torch; the bin edges come from the same float32
// tables as the plain version's, not from the closed form.

#include "common.cuh"
#include "traverse.cuh"

namespace {

using namespace vpt;

constexpr int kThreads = 128;
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
// Planted faults (render/cuda_mesh.py; 0 in every real launch).
constexpr int kFaultMisFactor = 1, kFaultMerlIndex = 2, kFaultKill = 3,
              kFaultUv = 4;

// Work counters (`stats`): BVH node visits, box tests and triangle tests;
// traced steps (a live path's scene intersection), hits (a scatter), BRDF
// hits (a MERL index) and lobe-MIS draws.
constexpr int kStats = 7;

// The launch's arguments; render/cuda_mesh.py::_Params, field for field.
struct Params {
  const float* cam;       // [14] pack_camera
  const float* spheres;   // [n_spheres, 14] pack_spheres
  const float* boxes;     // mesh (K3's 8-wide layout), null without a mesh
  const int* recs;
  const int* axes;
  const float* pack;
  const float* tri_e1;    // [T, 3] by slot
  const float* tri_e2;    // [T, 3]
  const float* tri_uv;    // [T, 3, 2]
  const float* tri_t;     // [T, 3, 3]
  const float* mis;       // [kMisFloats], null without lobe MIS
  float* records;         // [n_slots, width * height]
  unsigned long long* stats;  // null, or kStats counters the kernel adds to
  int n_spheres, width, height, spp, bounces, flags;
  int per_sb, off_a, off_e, off_dir, off_uv, off_midx, rgb_slot, fault;
  uint32_t seed_lo, seed_hi, frame;
  float depth_scale, fault_arg;
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

__global__ void __launch_bounds__(kThreads) mesh_kernel(const Params p) {
  extern __shared__ float smem[];  // [kMisFloats] MIS tables, then spheres
  const bool mis = p.flags & kFlagMis;
  if (mis) {
    for (int i = threadIdx.x; i < kMisFloats; i += blockDim.x) smem[i] = p.mis[i];
    __syncthreads();
  }
  const float* mis_t = smem;
  const float* sph = stage_spheres(smem + (mis ? kMisFloats : 0), p.spheres,
                                   p.n_spheres);

  const int n = p.width * p.height;
  const int pixel = blockIdx.x * blockDim.x + threadIdx.x;
  if (pixel >= n) return;

  const bool cornell = p.flags & kFlagCornell;
  const bool use_example = p.flags & kFlagExample;
  const bool has_mesh = p.flags & kFlagMesh;
  const bool use_brdf = p.flags & kFlagUseBrdf;
  const bool d_env = p.flags & kFlagEnv;
  const bool d_tex = p.flags & kFlagTex;
  const bool d_merl = p.flags & kFlagMerl;
  const bool d_emit = d_tex || d_merl;
  const float inactive_u = __int_as_float(0x7f800000);  // +inf: no texture
  const float fc = p.cam[12], fp = p.cam[13];
  float* rec = p.records + pixel;
  const size_t stride = static_cast<size_t>(n);
  auto put = [&](int slot, float v) { rec[slot * stride] = v; };

  float u0, v0, d0[3];
  primary_ray(p.cam, pixel, p.width, p.height, u0, v0, d0[0], d0[1], d0[2]);

  float acc[3] = {0.f, 0.f, 0.f};
  float depth = 1.f;
  Work work;
  unsigned traced = 0, hits = 0, brdf_hits = 0, mis_draws = 0;
  for (int s = 0; s < p.spp; ++s) {
    float o[3] = {p.cam[0], p.cam[1], p.cam[2]};
    float d[3] = {d0[0], d0[1], d0[2]};
    float m[3] = {1.f, 1.f, 1.f};
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
          mh = traverse_wide(p.boxes, p.recs, p.axes, p.pack, r, best_t, work);
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
      if (!live) {
        if (d_tex) {
          put(base + p.off_uv, inactive_u);
          put(base + p.off_uv + 1, 0.f);
        }
        if (d_merl) put(base + p.off_midx, -1.f);
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
      draw(p.seed_lo, p.seed_hi, pixel, p.frame, s, b, 0, u_reflect, unused);
      draw(p.seed_lo, p.seed_hi, pixel, p.frame, s, b, 1, u_phi, u_r);
      shade(sc, col, spec, is_brdf ? kBrdf : refl, d[0], d[1], d[2], u_reflect,
            u_phi, u_r, fc, fp);

      if (d_merl) {
        // BRDF hits: the cosine direction with factor 1, or the lobe MIS
        // draw with factor cos / (pi p_mix); the table's value is deferred.
        float midx = -1.f;
        if (is_brdf) {
          float bdx = sc.cdx, bdy = sc.cdy, bdz = sc.cdz, fac = 1.f;
          if (mis) {
            float u_b1, u_b2;
            draw(p.seed_lo, p.seed_hi, pixel, p.frame, s, b, 2, u_b1, u_b2);
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
        }
        put(base + p.off_midx, midx);
      }
      if (d_tex) {
        // A textured hit that is neither BRDF-typed nor mirrored; its
        // colour (1 in the kernel) is the epilogue's fetch at uv.
        const bool active = kind >= 2 && !sc.take_reflect && !is_brdf;
        const float shift = p.fault == kFaultUv ? p.fault_arg : 0.f;
        put(base + p.off_uv, active ? uv_u + shift : inactive_u);
        put(base + p.off_uv + 1, active ? uv_v : 0.f);
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
        for (int b = 0; b < p.bounces; ++b) {
          const int base = 1 + (s * p.bounces + b) * p.per_sb;
          for (int c = 0; c < 3; ++c) {
            if (d_emit) put(base + p.off_a + c, 0.f);
            if (d_env) put(base + p.off_e + c, 0.f);
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
                                     hits, brdf_hits, mis_draws};
    for (int i = 0; i < kStats; ++i) {
      atomicAdd(p.stats + i, static_cast<unsigned long long>(counts[i]));
    }
  }
  put(0, depth);
  if (p.rgb_slot >= 0) {
    const float inv_spp = 1.f / static_cast<float>(p.spp);
    put(p.rgb_slot, acc[0] * inv_spp);
    put(p.rgb_slot + 1, acc[1] * inv_spp);
    put(p.rgb_slot + 2, acc[2] * inv_spp);
  }
}

}  // namespace

// Launches K4 on `stream` and returns cudaGetLastError() (0 on success).
// `params` is a host pointer to the launch's arguments (device pointers and
// scalars, render/cuda_mesh.py::_Params); it is copied into the launch.
extern "C" int vpt_mesh(const void* params, void* stream) {
  const Params& p = *static_cast<const Params*>(params);
  const int n = p.width * p.height;
  if (n <= 0) return static_cast<int>(cudaErrorInvalidValue);
  const int blocks = (n + kThreads - 1) / kThreads;
  const size_t smem = sizeof(float) * ((p.flags & kFlagMis) ? kMisFloats : 0) +
                      sphere_smem_bytes(p.n_spheres);
  mesh_kernel<<<blocks, kThreads, smem, static_cast<cudaStream_t>(stream)>>>(p);
  return static_cast<int>(cudaGetLastError());
}
