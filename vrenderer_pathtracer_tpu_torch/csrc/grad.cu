// K2: the Cornell loss + gradient kernel, hand-written CUDA C++ for Hopper
// (sm_90a).
//
// Replaces vrenderer_pathtracer_tpu/render/pallas_grad.py::_grad_kernel.  For
// the L2 train loss  L = sum((rgb - target)^2) / (N*3)  of one progressive
// pass of the analytic Cornell estimator, it computes per pixel the loss term
// and the gradients with respect to every sphere's albedo and emission, the
// two Fresnel sliders and (with_camera) the 12 camera vectors origin, view
// dir, cx, cy, and reduces them to one row of K = 3 + 6*Ns (+12) partials per
// block:  [0] sum of squared errors, [1 + 6i + c] dcolor_i[c],
// [4 + 6i + c] demission_i[c], [1 + 6Ns] dfresnel_coef, [2 + 6Ns]
// dfresnel_pow, [3 + 6Ns ...] d origin, d view, d cx, d cy.  The wrapper sums
// the rows (render/cuda_grad.py).  The plain PyTorch version is torch
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
// Deliberate departures from the TPU kernel:
//   * no OUT_WIDTH=128 slot row (a TPU layout that capped the scene at 21
//     spheres): K partials per block, up to MAX_SPHERES_GRAD spheres, as
//     far as the block's shared memory holds K columns of kThreads floats;
//   * no n % 1024 pad: a bounds check on the pixel id, and a thread past the
//     frame contributes exactly zero;
//   * the mirror branch's multiplier is the per-channel specular colour, as
//     in the port's plain version and K1 (the Pallas kernel uses channel 0
//     for all three; the two agree wherever the specular colour is grey,
//     which holds for every scene the repo has).
//
// What bounds it on the H100: arithmetic.  Per pixel it reads 12 bytes of
// target and writes nothing but the block's partials, against, per live
// (sample, bounce), one forward step (Ns sphere tests with a sqrt each, two
// 20-round threefry blocks, sincos, pow, four normalisations) and one
// reverse step (a log, a few divisions; with_camera about 250 more flops
// and three normalisation adjoints).  The integer (threefry), FP32 and SFU
// pipes are the limit, as for K1; chip_smoke.py prints the bound from the
// run's live step count.  The design:
//   * one thread per pixel, the sphere table in shared memory (broadcast
//     reads), the threefry salts computed in registers, as in K1;
//   * two phases per thread.  g depends on the mean over all samples, so
//     the reverse sweep cannot start before every sample's forward pass has
//     run.  Phase (a) traces all samples (common.cuh's trace(), K1's loop)
//     for rgb, hence g, and keeps one record per (sample, bounce) in the
//     thread's local memory; phase (b) sweeps each sample's records in
//     reverse.  A thread keeps at most kMaxRecords = 16 records (the
//     training shapes run 2 x 4); the launch refuses spp * bounces above
//     that.  Measured at 1024^2, 2 spp, 4 bounces on an H100 80GB HBM3
//     (700 W): keeping the records takes 0.416 ms a launch against 0.758 ms
//     for replaying each sample's forward pass before its sweep instead
//     (1456 against 752 bytes of stack a thread);
//   * a path that missed leaves its loop and skips its reverse sweep: its
//     cotangents are zero by construction, so no NaN of a missed ray's
//     normal can reach a sum;
//   * the gradient of a sphere's albedo and emission lands on a row chosen
//     by the hit, which a per-thread register array cannot index, so each
//     thread owns a column of a [K, kThreads] array in shared memory (no
//     bank conflicts, no atomics).  The block reduces the columns in a fixed
//     tree order and writes one row: two launches on the same inputs give
//     bit-identical partials;
//   * with_camera is a template parameter, so the material-only instance
//     carries none of the adjoint's registers or record fields.

#include "common.cuh"

namespace {

using namespace vpt;

constexpr int kThreads = 128;
constexpr int kMaxRecords = 16;  // (sample, bounce) records a thread keeps
constexpr float kPMin = 1e-6f;
constexpr float kPMax = 1.f - 1e-6f;

// One bounce's record: what the reverse sweep reads.
struct Rec {
  float ox, oy, oz, dx, dy, dz;  // ray entering the bounce   (with_camera)
  float t, nx, ny, nz;           // hit distance and normal   (with_camera)
  float cp, spn, wz;             // cosine-sample terms       (with_camera)
  float m[3];                    // throughput entering the bounce
  float cos2, one_m_aoi, grazing, fresnel;
  int idx;                       // the winner's row
  bool near_root, take_reflect;
};

// Reverse of one bounce's geometry: given dL/d(o', d') of the ray leaving
// the bounce in (go, gd), dL/dmult in cm and dL/dp in dp, replaces (go, gd)
// with dL/d(o, d) of the ray entering it.  Mirrors ops/shading.py::scatter,
// ops/intersect.py and the integrator's o' = hit + 0.05 n; hit selection and
// the branch are constants.
__device__ __forceinline__ void bounce_adjoint(const Rec& r, const float* hs,
                                               int refl, const float* cm,
                                               float dp, float fc, float fp,
                                               float* go, float* gd) {
  const float nx = r.nx, ny = r.ny, nz = r.nz;
  const float dx = r.dx, dy = r.dy, dz = r.dz;
  // o' = h + OFFSET * n;  d' = the new direction.
  const float dhx = go[0], dhy = go[1], dhz = go[2];
  float dnx = kOriginOffset * go[0];
  float dny = kOriginOffset * go[1];
  float dnz = kOriginOffset * go[2];
  float drfx = 0.f, drfy = 0.f, drfz = 0.f;  // dL/d(mirror direction)
  const float ddn = dx * nx + dy * ny + dz * nz;

  if (refl == kSpec) {  // d' = mirror (not normalised)
    drfx = gd[0]; drfy = gd[1]; drfz = gd[2];
  } else if (r.take_reflect) {  // d' = normalize(mirror)
    float fx = dx - 2.f * ddn * nx;
    float fy = dy - 2.f * ddn * ny;
    float fz = dz - 2.f * ddn * nz;
    const float rl = normalize(fx, fy, fz);
    const float pr = fx * gd[0] + fy * gd[1] + fz * gd[2];
    drfx = (gd[0] - fx * pr) / rl;
    drfy = (gd[1] - fy * pr) / rl;
    drfz = (gd[2] - fz * pr) / rl;
  } else {  // d' = cosine sample cd; mult = col * cos2, cos2 = 2 cd.n
    float ax, ay, ux, uy, uz, vx, vy, vz;
    const float ul = cosine_frame(nx, ny, nz, ax, ay, ux, uy, uz, vx, vy, vz);
    float cdx = ux * r.cp + vx * r.spn + nx * r.wz;
    float cdy = uy * r.cp + vy * r.spn + ny * r.wz;
    float cdz = uz * r.cp + vz * r.spn + nz * r.wz;
    const float cl = normalize(cdx, cdy, cdz);
    const float dcos2 = cm[0] * hs[4] + cm[1] * hs[5] + cm[2] * hs[6];
    const float dcdx = gd[0] + 2.f * dcos2 * nx;
    const float dcdy = gd[1] + 2.f * dcos2 * ny;
    const float dcdz = gd[2] + 2.f * dcos2 * nz;
    dnx += 2.f * dcos2 * cdx;
    dny += 2.f * dcos2 * cdy;
    dnz += 2.f * dcos2 * cdz;
    // cd = normalize(u*cp + v*spn + n*wz)
    const float pr2 = cdx * dcdx + cdy * dcdy + cdz * dcdz;
    const float gx = (dcdx - cdx * pr2) / cl;
    const float gy = (dcdy - cdy * pr2) / cl;
    const float gz = (dcdz - cdz * pr2) / cl;
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
    const float dunx = (dux - ux * pr3) / ul;
    const float duny = (duy - uy * pr3) / ul;
    const float dunz = (duz - uz * pr3) / ul;
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

  // The Fresnel probability through aoi = -(d.n): d grazing / d aoi =
  // -fp * grazing / (1 - aoi).
  if (dp != 0.f && r.one_m_aoi > 0.f) {
    const float daoi = dp * (1.f - fc) * hs[10] *
                       (-fp * r.grazing / r.one_m_aoi);
    gdx -= nx * daoi; gdy -= ny * daoi; gdz -= nz * daoi;
    dnx -= dx * daoi; dny -= dy * daoi; dnz -= dz * daoi;
  }

  // n = normalize(h - c), h = o + d t (the forward's arithmetic).
  const float hx = __fadd_rn(r.ox, __fmul_rn(dx, r.t)) - hs[0];
  const float hy = __fadd_rn(r.oy, __fmul_rn(dy, r.t)) - hs[1];
  const float hz = __fadd_rn(r.oz, __fmul_rn(dz, r.t)) - hs[2];
  const float hl = fmaxf(sqrtf(hx * hx + hy * hy + hz * hz), 1e-20f);
  const float pr4 = nx * dnx + ny * dny + nz * dnz;
  const float dpx = dhx + (dnx - nx * pr4) / hl;
  const float dpy = dhy + (dny - ny * pr4) / hl;
  const float dpz = dhz + (dnz - nz * pr4) / hl;
  float gox = dpx, goy = dpy, goz = dpz;
  gdx += r.t * dpx; gdy += r.t * dpy; gdz += r.t * dpz;
  const float dt = dx * dpx + dy * dpy + dz * dpz;

  // t = bq + sigma * sqrt(det), bq = op.d, det = bq^2 - |op|^2 + r^2,
  // op = c - o; sigma = -1 for the near root.
  float bq, det;
  sphere_quadratic(hs, r.ox, r.oy, r.oz, dx, dy, dz, bq, det);
  const float sqc = fmaxf(sqrtf(fmaxf(det, 0.f)), 1e-6f);
  const float sigma = r.near_root ? -1.f : 1.f;
  const float dbq = dt * (1.f + sigma * bq / sqc);
  const float kk = sigma * dt / sqc;
  const float opx = hs[0] - r.ox, opy = hs[1] - r.oy, opz = hs[2] - r.oz;
  gdx += dbq * opx; gdy += dbq * opy; gdz += dbq * opz;
  gox -= dbq * dx - kk * opx;
  goy -= dbq * dy - kk * opy;
  goz -= dbq * dz - kk * opz;

  go[0] = gox; go[1] = goy; go[2] = goz;
  gd[0] = gdx; gd[1] = gdy; gd[2] = gdz;
}

template <bool kCam>
__global__ void __launch_bounds__(kThreads)
grad_kernel(const float* __restrict__ cam, const float* __restrict__ spheres,
            int n_spheres, uint32_t seed_lo, uint32_t seed_hi, uint32_t frame,
            int width, int height, int spp, int bounces,
            const float* __restrict__ target, float* __restrict__ partials) {
  extern __shared__ float smem[];
  float* sph = smem;                         // [n_spheres, kCols]
  float* acc = smem + n_spheres * kCols;     // [K, kThreads]
  const int n_k = 3 + 6 * n_spheres + (kCam ? 12 : 0);
  const int tid = threadIdx.x;
  for (int i = tid; i < n_spheres * kCols; i += kThreads) sph[i] = spheres[i];
  for (int k = 0; k < n_k; ++k) acc[k * kThreads + tid] = 0.f;
  __syncthreads();

  const int n = width * height;
  const int pixel = blockIdx.x * kThreads + tid;
  float* mine = acc + tid;  // this thread's column: mine[k * kThreads]
  if (pixel < n) {
    const float fc = cam[12], fp = cam[13];
    float u, v, d0[3];
    const float len0 = primary_ray(cam, pixel, width, height, u, v, d0[0],
                                   d0[1], d0[2]);

    // Phase (a): every sample's forward pass, for rgb and so g, keeping one
    // record per (sample, bounce).
    Rec recs[kMaxRecords];
    uint32_t survived = 0;  // bit s: sample s was not killed
    float rgb[3] = {0.f, 0.f, 0.f};
    for (int s = 0; s < spp; ++s) {
      Rec* sample_recs = recs + s * bounces;
      const bool alive = trace(
          sph, n_spheres, cam, d0, seed_lo, seed_hi, pixel, frame, s, bounces,
          fc, fp, rgb,
          [&](int b, int best, float best_t, bool near_root, const float* o,
              const float* d, const float* m, const Scatter& sc) {
            Rec& r = sample_recs[b];
            if constexpr (kCam) {
              r.ox = o[0]; r.oy = o[1]; r.oz = o[2];
              r.dx = d[0]; r.dy = d[1]; r.dz = d[2];
              r.t = best_t;
              r.nx = sc.nx; r.ny = sc.ny; r.nz = sc.nz;
              r.cp = sc.cp; r.spn = sc.spn; r.wz = sc.wz;
              r.near_root = near_root;
            }
            r.m[0] = m[0]; r.m[1] = m[1]; r.m[2] = m[2];
            r.cos2 = sc.cos2;
            r.one_m_aoi = sc.one_m_aoi;
            r.grazing = sc.grazing;
            r.fresnel = sc.fresnel;
            r.idx = best;
            r.take_reflect = sc.take_reflect;
          });
      if (alive) survived |= 1u << s;
    }
    const float fspp = static_cast<float>(spp);
    const float gscale = 2.f / (3.f * static_cast<float>(n) * fspp);
    float g[3], sse = 0.f;
    for (int c = 0; c < 3; ++c) {
      const float diff = rgb[c] / fspp - target[3 * pixel + c];
      sse += diff * diff;
      g[c] = diff * gscale;
    }

    // Phase (b): per sample, the reverse sweep over its records.  A killed
    // sample's cotangents are all zero.
    float dfc = 0.f, dfp = 0.f;
    float dorg[3] = {0.f, 0.f, 0.f}, dd0[3] = {0.f, 0.f, 0.f};
    for (int s = 0; s < spp; ++s) {
      if (!(survived >> s & 1u)) continue;
      const Rec* sample_recs = recs + s * bounces;
      float rn[3] = {0.f, 0.f, 0.f};      // dL/dm of the next bounce
      float go[3] = {0.f, 0.f, 0.f};      // dL/d(origin) of the next ray
      float gd[3] = {0.f, 0.f, 0.f};      // dL/d(direction) of the next ray
      for (int b = bounces - 1; b >= 0; --b) {
        const Rec& r = sample_recs[b];
        const float* hs = sph + r.idx * kCols;
        const int refl = static_cast<int>(hs[13]);
        float* row = mine + (1 + 6 * r.idx) * kThreads;
        float cm[3], mult[3];
        for (int c = 0; c < 3; ++c) {
          cm[c] = r.m[c] * rn[c];
          row[(3 + c) * kThreads] += g[c] * r.m[c];  // d emission
        }
        for (int c = 0; c < 3; ++c) {
          if (refl == kSpec) {
            mult[c] = 1.f;
          } else if (r.take_reflect) {
            mult[c] = hs[10 + c];
          } else {
            mult[c] = hs[4 + c] * r.cos2;
            row[c * kThreads] += r.cos2 * cm[c];  // d albedo
          }
        }
        // Fresnel score gradient: DIFF hits with p inside its clip range.
        float dp = 0.f;
        if (refl != kSpec && refl != kBrdf && r.fresnel >= kPMin &&
            r.fresnel <= kPMax) {
          dp = r.take_reflect
                   ? (cm[0] * hs[10] + cm[1] * hs[11] + cm[2] * hs[12]) /
                         r.fresnel
                   : -(cm[0] * hs[4] + cm[1] * hs[5] + cm[2] * hs[6]) *
                         r.cos2 / (1.f - r.fresnel);
          dfc += dp * (1.f - r.grazing) * hs[10];
          if (r.one_m_aoi > 0.f) {
            dfp += dp * (1.f - fc) * hs[10] * r.grazing * logf(r.one_m_aoi);
          }
        }
        if constexpr (kCam) bounce_adjoint(r, hs, refl, cm, dp, fc, fp, go, gd);
        for (int c = 0; c < 3; ++c) rn[c] = g[c] * hs[7 + c] + mult[c] * rn[c];
      }
      if constexpr (kCam) {
        for (int k = 0; k < 3; ++k) {
          dorg[k] += go[k];
          dd0[k] += gd[k];
        }
      }
    }

    mine[0] = sse;
    mine[(1 + 6 * n_spheres) * kThreads] = dfc;
    mine[(2 + 6 * n_spheres) * kThreads] = dfp;
    if constexpr (kCam) {
      // d0 = draw / |draw|, draw = view + u*cx + v*cy, o0 = origin.
      const float proj = d0[0] * dd0[0] + d0[1] * dd0[1] + d0[2] * dd0[2];
      float* cam_rows = mine + (3 + 6 * n_spheres) * kThreads;
      for (int k = 0; k < 3; ++k) {
        const float ddraw = (dd0[k] - d0[k] * proj) / len0;
        cam_rows[k * kThreads] = dorg[k];
        cam_rows[(3 + k) * kThreads] = ddraw;
        cam_rows[(6 + k) * kThreads] = u * ddraw;
        cam_rows[(9 + k) * kThreads] = v * ddraw;
      }
    }
  }

  // Fixed-order tree reduction of the K columns: bit-reproducible.
  __syncthreads();
  for (int half = kThreads / 2; half > 0; half >>= 1) {
    for (int i = tid; i < n_k * half; i += kThreads) {
      const int k = i / half, j = i - k * half;
      acc[k * kThreads + j] += acc[k * kThreads + j + half];
    }
    __syncthreads();
  }
  for (int k = tid; k < n_k; k += kThreads) {
    partials[static_cast<size_t>(blockIdx.x) * n_k + k] = acc[k * kThreads];
  }
}

}  // namespace

// Threads per block: the wrapper sizes the partials buffer [blocks, K].
extern "C" int vpt_grad_block_size() { return kThreads; }

// Launches K2 on `stream` and returns a cudaError_t (0 on success;
// cudaErrorInvalidValue when spp * bounces exceeds kMaxRecords).  All
// pointers are device pointers to contiguous float32: cam [14], spheres
// [n_spheres, 14], target [width*height, 3], partials [blocks, K] with
// blocks = ceil(width*height / vpt_grad_block_size()).
extern "C" int vpt_grad(const void* cam, const void* spheres, int n_spheres,
                        unsigned int seed_lo, unsigned int seed_hi,
                        unsigned int frame, int width, int height, int spp,
                        int bounces, int with_camera, const void* target,
                        void* partials, void* stream) {
  if (bounces < 0 || spp < 1 || spp > kMaxRecords ||
      spp * bounces > kMaxRecords || n_spheres < 1) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  const int n = width * height;
  const int blocks = (n + kThreads - 1) / kThreads;
  const int n_k = 3 + 6 * n_spheres + (with_camera ? 12 : 0);
  const size_t smem =
      sizeof(float) * (static_cast<size_t>(kCols) * n_spheres +
                       static_cast<size_t>(n_k) * kThreads);
  auto kernel = with_camera ? grad_kernel<true> : grad_kernel<false>;
  if (smem > 48 * 1024) {
    const cudaError_t e = cudaFuncSetAttribute(
        kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
        static_cast<int>(smem));
    if (e != cudaSuccess) return static_cast<int>(e);
  }
  kernel<<<blocks, kThreads, smem, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const float*>(cam), static_cast<const float*>(spheres),
      n_spheres, seed_lo, seed_hi, frame, width, height, spp, bounces,
      static_cast<const float*>(target), static_cast<float*>(partials));
  return static_cast<int>(cudaGetLastError());
}
