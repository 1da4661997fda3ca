// K2: the Cornell loss + gradient kernel, hand-written CUDA C++ for Hopper
// (sm_90a).
//
// Replaces vrenderer_pathtracer_tpu/render/pallas_grad.py::_grad_kernel.  For
// the L2 train loss  L = sum((rgb - target)^2) / (N*3)  of one progressive
// pass of the analytic Cornell estimator, it computes per pixel the loss term
// and the gradients with respect to every sphere's albedo and emission, the
// two Fresnel sliders and (with_camera) the 12 camera vectors origin, view
// dir, cx, cy, and reduces them to one row of K = 3 + 6*Ns (+12) sums:
// [0] sum of squared errors, [1 + 6i + c] dcolor_i[c], [4 + 6i + c]
// demission_i[c], [1 + 6Ns] dfresnel_coef, [2 + 6Ns] dfresnel_pow,
// [3 + 6Ns ...] d origin, d view, d cx, d cy.  A launch may take a tile
// of the frame, the raster range [pixel_offset, pixel_offset + n_local)
// (parallel/sharding.py): thread i takes pixel pixel_offset + i, whose
// global id drives its primary ray and keys its draws, target is the
// tile's [n_local, 3], and the loss and every gradient keep the frame's
// normaliser 1 / (N * 3), N = width * height, so the tiles' rows add up
// to the frame's.  The wrapper
// (render/cuda_grad.py) reads that row.  The plain PyTorch version is torch
// autograd of generate_rays + render/integrator.py::render_pass
// (render/cuda_grad.py::cornell_loss_grads_reference).
//
// Gradient semantics are the plain version's: sampling is detached (hit
// selection, branch choice and the draws are constants), the Fresnel branch
// carries the ratio trick p/sg(p) (the score-function estimator, p clipped
// to [1e-6, 1-1e-6]), and a Cornell kill zeroes every cotangent of the path.
// With live = 1 on every bounce of a path that was not killed, the reverse
// sweep per sample and channel is (m_b: throughput entering bounce b,
// mult_b: its multiplier, g = dL/d(sample radiance)):
//     r_b  = g * em_b + mult_b * r_{b+1}        (r = dL/dm)
//     cm_b = m_b * r_{b+1}                     (dL/dmult_b)
//     dem += g * m_b;  dcol += cos2_b * cm_b   (cosine branch only)
//     dp   = sum_c cm_b * (reflect ? spec_c/p : -col_c*cos2/(1-p))  (DIFF)
//     dfc += dp * (1 - grazing) * spec_0;  dfp += dp * (1-fc) * spec_0 *
//            grazing * log(1 - aoi)
// and with_camera adds the geometric adjoint of each bounce (sphere root,
// hit point, normal, mirror and cosine-sample directions, and the Fresnel
// probability through the angle of incidence) and of the primary ray.
//
// Every cotangent is linear in g, channel by channel: r, cm and dem of
// channel c are g_c times their values at g = 1, and so are channel c's
// share of dp, of the Fresnel sums and of the geometric adjoint.  So the
// sweep runs at g = 1 per channel for each sample right after its forward
// pass, and its sums are scaled by the real g_c once the mean over the
// samples is known: dcolor and demission accumulate unscaled in the
// thread's column, dfc, dfp (and with_camera the ray cotangents) as three
// per-channel partials.
//
// Deliberate departures from the TPU kernel:
//   * no OUT_WIDTH=128 slot row (a TPU layout that capped the scene at 21
//     spheres): K sums, up to MAX_SPHERES_GRAD spheres, as far as the
//     block's shared memory holds K columns of kThreads floats;
//   * no n % 1024 pad: a bounds check on the pixel id, and a thread past the
//     frame contributes exactly zero;
//   * the mirror branch's multiplier is the per-channel specular colour, as
//     in the port's plain version and K1 (the Pallas kernel uses channel 0
//     for all three; the two agree wherever the specular colour is grey,
//     which holds for every scene the repo has).
//
// What bounds it on the H100: instruction issue, as for K1.  Per pixel it
// reads 12 bytes of target, against, per live (sample, bounce), one forward
// step (common.cuh's trace: Ns sphere tests with a sqrt each, a threefry
// block, sincos, normalisations) and one reverse step (a few multiply-adds
// and shared-memory adds; with_camera about 250 more flops a channel).
// chip_smoke.py prints the bound from the run's live step count.  The
// design:
//   * one thread per pixel, the sphere table in shared memory (broadcast
//     reads), the threefry salts computed in registers, as in K1, and the
//     forward pass is K1's trace with cut (a) and kCornellFast's inexact
//     cuts (common.cuh); of cut (b) it keeps bounce 0's sphere loop once per
//     pixel and recomputes the hit, normal and frame per sample, because
//     holding them costs the registers that set its occupancy;
//   * one sample at a time: its forward pass keeps one record per bounce
//     (at most kMaxRecords, in local memory: the bounce count is the
//     caller's), and its reverse sweep follows at g = 1.  A record holds
//     only what the sweep reads: its throughput, cos2, a key (row, branch,
//     a score flag) and, on Fresnel surfaces only, the score terms.  A
//     bounce count fixed at compile time keeps the records in registers
//     (no stack frame) but needs 80 registers a thread against 69, and that
//     instance ran 3% slower on an H100 (PERF.md);
//   * a path that missed leaves its loop and skips its reverse sweep: its
//     cotangents are zero by construction, so no NaN of a missed ray's
//     normal can reach a sum;
//   * the gradient of a sphere's albedo and emission lands on a row chosen
//     by the hit, which a per-thread register array cannot index, so each
//     thread owns a column of a [K, kThreads] array in shared memory (no
//     bank conflicts, no atomics); at the pixel's end the rows it touched
//     are scaled by g;
//   * the reduction is the kernel's own and runs in a fixed order: each
//     warp sums a quarter of the block's columns (four entries a lane, then
//     a butterfly of shuffles: no bank conflicts and one barrier, where the
//     parent's tree over shared memory had both, and ran slower on the
//     card) and writes the block's row; the last block of each group of
//     kGroup blocks to finish (an atomic count) sums the group's rows in
//     block order, and the last group sums the group rows in group order
//     into the output row.  Two launches on the same inputs give
//     bit-identical sums;
//   * with_camera is a template parameter, so the material-only instance
//     carries none of the adjoint's registers or record fields.

#include "common.cuh"

namespace {

using namespace vpt;

constexpr int kThreads = 128;
constexpr int kMaxRecords = 16;  // (sample, bounce) steps a launch takes
constexpr int kGroup = 64;       // block rows summed by one group's last block
constexpr float kPMin = 1e-6f;
constexpr float kPMax = 1.f - 1e-6f;

// One bounce's record: what the reverse sweep reads.
struct Rec {
  float m[3];                    // throughput entering the bounce
  float cos2;
  int key;                       // 4 * row + 2 * score + take_reflect
  // The Fresnel score terms, where `score` is set (a Fresnel surface with p
  // inside its clip range): dp of channel c is q_c = cm_c * (take_reflect
  // ? spec_c : col_c) times 1/p or -cos2/(1-p); dfc_c += q_c * dpc, dfp_c
  // += q_c * dpp, dL/daoi_c = q_c * dpa (with_camera).
  float dpc, dpp, dpa;
  float o[3], d[3], t;           // ray entering the bounce, hit distance
  float cp, spn, wz;             // cosine-sample terms      (with_camera)
  bool near_root;                // (with_camera)
};

// Reverse of one bounce's geometry, for each channel's unit-g cotangents:
// given dL/d(o', d') of the ray leaving the bounce in (go[c], gd[c]),
// dL/dmult of channel c in cm[c] and dL/daoi in daoi[c], replaces (go[c],
// gd[c]) with dL/d(o, d) of the ray entering it.  Mirrors
// ops/shading.py::scatter, ops/intersect.py and the integrator's o' = hit +
// 0.05 n; hit selection and the branch are constants.  The geometry is
// recomputed once from the record (the forward's arithmetic) for the three
// channels.
template <unsigned kFast>
__device__ __forceinline__ void bounce_adjoint(const Rec& r, const float* hs,
                                               int refl, const float* cm,
                                               const float* daoi,
                                               float (*go)[3],
                                               float (*gd)[3]) {
  const float dx = r.d[0], dy = r.d[1], dz = r.d[2];
  // n = normalize(h - c), h = o + d t.
  float nx = __fadd_rn(r.o[0], __fmul_rn(dx, r.t)) - hs[0];
  float ny = __fadd_rn(r.o[1], __fmul_rn(dy, r.t)) - hs[1];
  float nz = __fadd_rn(r.o[2], __fmul_rn(dz, r.t)) - hs[2];
  const float inv_hl = 1.f / normalize<kFast>(nx, ny, nz);
  const float ddn = dx * nx + dy * ny + dz * nz;

  // The new direction: the mirror (SPEC), its normalisation f (DIFF's
  // mirror branch), or the cosine sample cd in the frame (u, v) (cosine
  // branch; mult = col * cos2, cos2 = 2 cd.n).
  float fx = 0.f, fy = 0.f, fz = 0.f, inv_rl = 0.f;
  float ax = 0.f, ay = 0.f, ux = 0.f, uy = 0.f, uz = 0.f;
  float cdx = 0.f, cdy = 0.f, cdz = 0.f, inv_ul = 0.f, inv_cl = 0.f;
  const bool take_reflect = (r.key & 1) != 0;
  const bool cosine = refl != kSpec && !take_reflect;
  if (refl != kSpec && take_reflect) {
    fx = dx - 2.f * ddn * nx;
    fy = dy - 2.f * ddn * ny;
    fz = dz - 2.f * ddn * nz;
    inv_rl = 1.f / normalize<kFast>(fx, fy, fz);
  } else if (cosine) {
    float vx, vy, vz;
    inv_ul = 1.f / cosine_frame<kFast>(nx, ny, nz, ax, ay, ux, uy, uz, vx, vy,
                                       vz);
    cdx = ux * r.cp + vx * r.spn + nx * r.wz;
    cdy = uy * r.cp + vy * r.spn + ny * r.wz;
    cdz = uz * r.cp + vz * r.spn + nz * r.wz;
    inv_cl = 1.f / normalize<kFast>(cdx, cdy, cdz);
  }

  // t = bq + sigma * sqrt(det), bq = op.d, det = bq^2 - |op|^2 + r^2,
  // op = c - o; sigma = -1 for the near root.
  float bq, det;
  sphere_quadratic(hs, r.o[0], r.o[1], r.o[2], dx, dy, dz, bq, det);
  const float inv_sqc = 1.f / fmaxf(sqrtf(fmaxf(det, 0.f)), 1e-6f);
  const float sigma = r.near_root ? -1.f : 1.f;
  const float opx = hs[0] - r.o[0], opy = hs[1] - r.o[1], opz = hs[2] - r.o[2];

  for (int c = 0; c < 3; ++c) {
    float* g_o = go[c];
    float* g_d = gd[c];
    // o' = h + OFFSET * n;  d' = the new direction.
    const float dhx = g_o[0], dhy = g_o[1], dhz = g_o[2];
    float dnx = kOriginOffset * g_o[0];
    float dny = kOriginOffset * g_o[1];
    float dnz = kOriginOffset * g_o[2];
    float drfx = 0.f, drfy = 0.f, drfz = 0.f;  // dL/d(mirror direction)
    if (refl == kSpec) {  // d' = mirror (not normalised)
      drfx = g_d[0]; drfy = g_d[1]; drfz = g_d[2];
    } else if (!cosine) {  // d' = normalize(mirror)
      const float pr = fx * g_d[0] + fy * g_d[1] + fz * g_d[2];
      drfx = (g_d[0] - fx * pr) * inv_rl;
      drfy = (g_d[1] - fy * pr) * inv_rl;
      drfz = (g_d[2] - fz * pr) * inv_rl;
    } else {  // d' = cd
      const float vx = ny * uz - nz * uy;
      const float vy = nz * ux - nx * uz;
      const float vz = nx * uy - ny * ux;
      const float dcos2 = cm[c] * hs[4 + c];
      const float dcdx = g_d[0] + 2.f * dcos2 * nx;
      const float dcdy = g_d[1] + 2.f * dcos2 * ny;
      const float dcdz = g_d[2] + 2.f * dcos2 * nz;
      dnx += 2.f * dcos2 * cdx;
      dny += 2.f * dcos2 * cdy;
      dnz += 2.f * dcos2 * cdz;
      // cd = normalize(u*cp + v*spn + n*wz)
      const float pr2 = cdx * dcdx + cdy * dcdy + cdz * dcdz;
      const float gx = (dcdx - cdx * pr2) * inv_cl;
      const float gy = (dcdy - cdy * pr2) * inv_cl;
      const float gz = (dcdz - cdz * pr2) * inv_cl;
      float dux = r.cp * gx, duy = r.cp * gy, duz = r.cp * gz;
      const float dvx = r.spn * gx, dvy = r.spn * gy, dvz = r.spn * gz;
      dnx += r.wz * gx;
      dny += r.wz * gy;
      dnz += r.wz * gz;
      // v = cross(n, u):  dn += cross(u, dv);  du += cross(dv, n)
      dnx += uy * dvz - uz * dvy;
      dny += uz * dvx - ux * dvz;
      dnz += ux * dvy - uy * dvx;
      dux += dvy * nz - dvz * ny;
      duy += dvz * nx - dvx * nz;
      duz += dvx * ny - dvy * nx;
      // u = normalize(cross(axis, n)):  dn += cross(du_raw, axis)
      const float pr3 = ux * dux + uy * duy + uz * duz;
      const float dunx = (dux - ux * pr3) * inv_ul;
      const float duny = (duy - uy * pr3) * inv_ul;
      const float dunz = (duz - uz * pr3) * inv_ul;
      dnx -= dunz * ay;
      dny += dunz * ax;
      dnz += dunx * ay - duny * ax;
    }

    // mirror = d - 2 (d.n) n
    const float nd_drf = nx * drfx + ny * drfy + nz * drfz;
    float gdx = drfx - 2.f * nx * nd_drf;
    float gdy = drfy - 2.f * ny * nd_drf;
    float gdz = drfz - 2.f * nz * nd_drf;
    dnx -= 2.f * (nd_drf * dx + ddn * drfx);
    dny -= 2.f * (nd_drf * dy + ddn * drfy);
    dnz -= 2.f * (nd_drf * dz + ddn * drfz);

    // The Fresnel probability through aoi = -(d.n).
    if (daoi[c] != 0.f) {
      gdx -= nx * daoi[c]; gdy -= ny * daoi[c]; gdz -= nz * daoi[c];
      dnx -= dx * daoi[c]; dny -= dy * daoi[c]; dnz -= dz * daoi[c];
    }

    // n = normalize(h - c), h = o + d t.
    const float pr4 = nx * dnx + ny * dny + nz * dnz;
    const float dpx = dhx + (dnx - nx * pr4) * inv_hl;
    const float dpy = dhy + (dny - ny * pr4) * inv_hl;
    const float dpz = dhz + (dnz - nz * pr4) * inv_hl;
    gdx += r.t * dpx; gdy += r.t * dpy; gdz += r.t * dpz;
    const float dt = dx * dpx + dy * dpy + dz * dpz;

    // The sphere root.
    const float dbq = dt * (1.f + sigma * bq * inv_sqc);
    const float kk = sigma * dt * inv_sqc;
    g_d[0] = gdx + dbq * opx;
    g_d[1] = gdy + dbq * opy;
    g_d[2] = gdz + dbq * opz;
    g_o[0] = dpx - (dbq * dx - kk * opx);
    g_o[1] = dpy - (dbq * dy - kk * opy);
    g_o[2] = dpz - (dbq * dz - kk * opz);
  }
}

// kFault plants a fault (chip_smoke.py): channel 1's unit-g sums scaled by
// channel 0's g.
template <bool kCam, bool kFault>
__global__ void __launch_bounds__(kThreads)
grad_kernel(const float* __restrict__ cam, const float* __restrict__ spheres,
            int n_spheres, uint32_t seed_lo, uint32_t seed_hi, uint32_t frame,
            int width, int height, int spp, int bounces, int pixel_offset,
            int n_local, const float* __restrict__ target,
            float* __restrict__ rows,
            unsigned int* __restrict__ counts, float* __restrict__ out) {
  extern __shared__ float smem[];
  __shared__ bool last;
  float* sph = smem;                         // [n_spheres, kCols]
  float* acc = smem + n_spheres * kCols;     // [K + 6, kThreads]
  const int n_k = 3 + 6 * n_spheres + (kCam ? 12 : 0);
  const int tid = threadIdx.x;
  for (int i = tid; i < n_spheres * kCols; i += kThreads) sph[i] = spheres[i];
  for (int k = 0; k < n_k + 6; ++k) acc[k * kThreads + tid] = 0.f;
  __syncthreads();

  const int n = width * height;
  const int i = blockIdx.x * kThreads + tid;
  const int pixel = pixel_offset + i;
  float* mine = acc + tid;  // this thread's column: mine[k * kThreads]
  // Rows K..K+5 of the column: dfc and dfp of each channel at g = 1.
  float* fres_rows = mine + n_k * kThreads;
  if (i < n_local) {
    const float fc = cam[12], fp = cam[13];
    float u, v, d0[3];
    const float len0 = primary_ray(cam, pixel, width, height, u, v, d0[0],
                                   d0[1], d0[2]);
    Surface h0;
    h0.best = -1;
    if (bounces > 0) {
      first_surface<kCornellFast, false, false>(h0, sph, n_spheres, cam, d0,
                                                fc, fp);
    }

    float rgb[3] = {0.f, 0.f, 0.f};
    float dorg[3][3] = {}, dd0[3][3] = {};  // [channel][xyz]
    uint64_t touched = 0;  // rows of the column this pixel added to
    for (int s = 0; s < spp; ++s) {
      Rec recs[kMaxRecords];
      const bool alive = trace<kCornellFast, false, false>(
          sph, n_spheres, h0, cam, d0, seed_lo, seed_hi, pixel, frame, s,
          bounces, fc, fp, rgb,
          [&](int b, const Surface& h, const float* o, const float* d,
              const float* m, const Bounce& sc) {
            Rec r;
            const float* hs = sph + h.best * kCols;
            r.m[0] = m[0]; r.m[1] = m[1]; r.m[2] = m[2];
            r.cos2 = sc.cos2;
            const bool score =
                h.fres && h.fresnel >= kPMin && h.fresnel <= kPMax;
            r.key = 4 * h.best + (score ? 2 : 0) + (sc.take_reflect ? 1 : 0);
            if (score) {
              const float w = sc.take_reflect ? 1.f / h.fresnel
                                              : -sc.cos2 / (1.f - h.fresnel);
              const float wp = w * (1.f - fc) * hs[10];
              float dpp = 0.f, dpa = 0.f;
              if (h.one_m_aoi > 0.f) {
                dpp = wp * h.grazing * logf(h.one_m_aoi);
                if constexpr (kCam) {
                  dpa = wp * (-fp * h.grazing / h.one_m_aoi);
                }
              }
              r.dpc = w * (1.f - h.grazing) * hs[10];
              r.dpp = dpp;
              r.dpa = dpa;
            }
            if constexpr (kCam) {
              r.o[0] = o[0]; r.o[1] = o[1]; r.o[2] = o[2];
              r.d[0] = d[0]; r.d[1] = d[1]; r.d[2] = d[2];
              r.t = h.t;
              r.cp = sc.cp; r.spn = sc.spn; r.wz = sc.wz;
              r.near_root = h.near_root;
            }
            recs[b] = r;
          });
      if (!alive) continue;  // a killed sample's cotangents are all zero

      // The sample's reverse sweep at g = 1 per channel.
      float rn[3] = {0.f, 0.f, 0.f};  // dL/dm of the next bounce
      float go[3][3] = {}, gd[3][3] = {};  // dL/d(o, d) of the next ray
      for (int b = bounces - 1; b >= 0; --b) {
        const Rec& r = recs[b];
        const int idx = r.key >> 2;
        const bool take_reflect = (r.key & 1) != 0;
        const float* hs = sph + idx * kCols;
        const int refl = static_cast<int>(hs[13]);
        float* row = mine + (1 + 6 * idx) * kThreads;
        touched |= 1ull << idx;
        float cm[3], mult[3];
        for (int c = 0; c < 3; ++c) {
          cm[c] = r.m[c] * rn[c];
          row[(3 + c) * kThreads] += r.m[c];  // d emission
        }
        for (int c = 0; c < 3; ++c) {
          if (refl == kSpec) {
            mult[c] = 1.f;
          } else if (take_reflect) {
            mult[c] = hs[10 + c];
          } else {
            mult[c] = hs[4 + c] * r.cos2;
            row[c * kThreads] += r.cos2 * cm[c];  // d albedo
          }
        }
        float daoi[3] = {0.f, 0.f, 0.f};
        if ((r.key & 2) != 0) {
          for (int c = 0; c < 3; ++c) {
            const float q = cm[c] * hs[(take_reflect ? 10 : 4) + c];
            fres_rows[c * kThreads] += q * r.dpc;
            fres_rows[(3 + c) * kThreads] += q * r.dpp;
            daoi[c] = q * r.dpa;
          }
        }
        if constexpr (kCam) {
          bounce_adjoint<kCornellFast>(r, hs, refl, cm, daoi, go, gd);
        }
        for (int c = 0; c < 3; ++c) rn[c] = hs[7 + c] + mult[c] * rn[c];
      }
      if constexpr (kCam) {
        for (int c = 0; c < 3; ++c) {
          for (int k = 0; k < 3; ++k) {
            dorg[c][k] += go[c][k];
            dd0[c][k] += gd[c][k];
          }
        }
      }
    }

    // g = dL/d(sample radiance), now that the mean is known.
    const float fspp = static_cast<float>(spp);
    const float gscale = 2.f / (3.f * static_cast<float>(n) * fspp);
    float g[3], sse = 0.f;
    for (int c = 0; c < 3; ++c) {
      const float diff = rgb[c] / fspp - target[3 * i + c];
      sse += diff * diff;
      g[c] = diff * gscale;
    }
    const float g1 = kFault ? g[0] : g[1];
    const float gs[3] = {g[0], g1, g[2]};
    for (uint64_t left = touched; left != 0; left &= left - 1) {
      float* row = mine + (1 + 6 * (__ffsll(static_cast<long long>(left)) - 1))
                              * kThreads;
      for (int c = 0; c < 3; ++c) {
        row[c * kThreads] *= gs[c];
        row[(3 + c) * kThreads] *= gs[c];
      }
    }
    mine[0] = sse;
    float dfc = 0.f, dfp = 0.f;
    for (int c = 0; c < 3; ++c) {
      dfc += gs[c] * fres_rows[c * kThreads];
      dfp += gs[c] * fres_rows[(3 + c) * kThreads];
    }
    mine[(1 + 6 * n_spheres) * kThreads] = dfc;
    mine[(2 + 6 * n_spheres) * kThreads] = dfp;
    if constexpr (kCam) {
      // d0 = draw / |draw|, draw = view + u*cx + v*cy, o0 = origin.
      float o_sum[3], d_sum[3];
      for (int k = 0; k < 3; ++k) {
        o_sum[k] = gs[0] * dorg[0][k] + gs[1] * dorg[1][k] + gs[2] * dorg[2][k];
        d_sum[k] = gs[0] * dd0[0][k] + gs[1] * dd0[1][k] + gs[2] * dd0[2][k];
      }
      const float proj = d0[0] * d_sum[0] + d0[1] * d_sum[1] + d0[2] * d_sum[2];
      float* cam_rows = mine + (3 + 6 * n_spheres) * kThreads;
      for (int k = 0; k < 3; ++k) {
        const float ddraw = (d_sum[k] - d0[k] * proj) / len0;
        cam_rows[k * kThreads] = o_sum[k];
        cam_rows[(3 + k) * kThreads] = ddraw;
        cam_rows[(6 + k) * kThreads] = u * ddraw;
        cam_rows[(9 + k) * kThreads] = v * ddraw;
      }
    }
  }

  // Fixed-order reduction of the K columns into the block's row: each
  // warp takes every fourth row, a lane sums four of its 128 entries, and
  // a butterfly of shuffles sums the lanes.
  __syncthreads();
  const int warp = tid >> 5, lane = tid & 31;
  for (int k = warp; k < n_k; k += kThreads / 32) {
    const float* col = acc + k * kThreads;
    float v = (col[lane] + col[lane + 32]) + (col[lane + 64] + col[lane + 96]);
    for (int off = 16; off > 0; off >>= 1) {
      v += __shfl_xor_sync(0xffffffffu, v, off);
    }
    if (lane == 0) rows[static_cast<size_t>(blockIdx.x) * n_k + k] = v;
  }

  // The group's last block to finish sums the group's rows in block order;
  // the last group's, the group rows in group order.
  const int n_blocks = gridDim.x;
  const int n_groups = (n_blocks + kGroup - 1) / kGroup;
  const int group = blockIdx.x / kGroup;
  const int first = group * kGroup;
  const int size = min(kGroup, n_blocks - first);
  float* group_rows = rows + static_cast<size_t>(n_blocks) * n_k;
  __threadfence();
  __syncthreads();
  if (tid == 0) last = atomicAdd(&counts[group], 1u) == size - 1u;
  __syncthreads();
  if (!last) return;
  __threadfence();
  for (int k = tid; k < n_k; k += kThreads) {
    float sum = 0.f;
    for (int j = 0; j < size; ++j) {
      sum += __ldcg(rows + static_cast<size_t>(first + j) * n_k + k);
    }
    group_rows[group * n_k + k] = sum;
  }
  __threadfence();
  __syncthreads();
  if (tid == 0) last = atomicAdd(&counts[n_groups], 1u) == n_groups - 1u;
  __syncthreads();
  if (!last) return;
  __threadfence();
  for (int k = tid; k < n_k; k += kThreads) {
    float sum = 0.f;
    for (int j = 0; j < n_groups; ++j) sum += __ldcg(group_rows + j * n_k + k);
    out[k] = sum;
  }
}

int blocks_of(int n) { return (n + kThreads - 1) / kThreads; }
int groups_of(int blocks) { return (blocks + kGroup - 1) / kGroup; }

}  // namespace

// Floats of the workspace a launch over `n_pixels` pixels (its n_local)
// needs for a row
// of K sums: the block rows, the group rows and the group counters (one
// 32-bit word each, and one for the groups).
extern "C" long long vpt_grad_workspace_floats(int n_pixels, int n_k) {
  const long long blocks = blocks_of(n_pixels);
  const long long groups = groups_of(static_cast<int>(blocks));
  return (blocks + groups) * n_k + groups + 1;
}

// Launches K2 on `stream` over the pixels [pixel_offset, pixel_offset +
// n_local) and returns a cudaError_t (0 on success; cudaErrorInvalidValue
// when spp * bounces exceeds kMaxRecords or the range leaves the frame).
// All pointers are device pointers: cam [14], spheres [n_spheres, 14],
// target [n_local, 3] and out [K] contiguous float32, workspace
// vpt_grad_workspace_floats(n_local, K) floats.  `fault` non-zero
// launches the instance with the planted fault (material-only).
extern "C" int vpt_grad(const void* cam, const void* spheres, int n_spheres,
                        unsigned int seed_lo, unsigned int seed_hi,
                        unsigned int frame, int width, int height, int spp,
                        int bounces, int with_camera, int pixel_offset,
                        int n_local, const void* target, void* workspace,
                        void* out, int fault, void* stream) {
  if (bounces < 0 || spp < 1 || spp > kMaxRecords ||
      spp * bounces > kMaxRecords || n_spheres < 1 || n_spheres > 64 ||
      (fault && with_camera) || pixel_offset < 0 || n_local <= 0 ||
      static_cast<long long>(pixel_offset) + n_local >
          static_cast<long long>(width) * height) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  const int blocks = blocks_of(n_local);
  const int n_k = 3 + 6 * n_spheres + (with_camera ? 12 : 0);
  const size_t smem =
      sizeof(float) * (static_cast<size_t>(kCols) * n_spheres +
                       static_cast<size_t>(n_k + 6) * kThreads);
  auto kernel = fault         ? grad_kernel<false, true>
                : with_camera ? grad_kernel<true, false>
                              : grad_kernel<false, false>;
  if (smem > 48 * 1024) {
    const cudaError_t e = cudaFuncSetAttribute(
        kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
        static_cast<int>(smem));
    if (e != cudaSuccess) return static_cast<int>(e);
  }
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  float* rows = static_cast<float*>(workspace);
  const size_t groups = groups_of(blocks);
  unsigned int* counts = reinterpret_cast<unsigned int*>(
      rows + (static_cast<size_t>(blocks) + groups) * n_k);
  const cudaError_t e =
      cudaMemsetAsync(counts, 0, sizeof(unsigned int) * (groups + 1), s);
  if (e != cudaSuccess) return static_cast<int>(e);
  kernel<<<blocks, kThreads, smem, s>>>(
      static_cast<const float*>(cam), static_cast<const float*>(spheres),
      n_spheres, seed_lo, seed_hi, frame, width, height, spp, bounces,
      pixel_offset, n_local, static_cast<const float*>(target), rows, counts,
      static_cast<float*>(out));
  return static_cast<int>(cudaGetLastError());
}
