// K5: closest-hit traversal of a paged mesh, hand-written CUDA C++ for
// Hopper (sm_90a).
//
// Replaces vrenderer_pathtracer_tpu/accel/pallas_paged.py::_kernel (reached
// through traverse_paged).  It computes, per ray, the closest Möller–Trumbore
// triangle hit with t < t_max over all pages of a paged mesh, as (slot int32,
// t float32): slots are global (page * page_tris + local), a miss gives slot
// -1 and t = t_max.  The layout is accel/paged.py's (scene.PagedNodes): one
// node space holding an 8-wide top-level tree over the page boxes and each
// page's 8-wide tree, read through its compressed copy (accel/wide.py::
// compress_wide, over the whole node space): the top tree is the copy's
// nodes [0, n_top), root 0, and the page roots are [n_top, n_top + pages).
// The plain PyTorch version is accel/traverse.py::traverse_paged_reference;
// the wrapper is accel/cuda_paged.py::traverse_paged_cuda.
//
// What bounds it on the H100: operations, divergence and the latency of
// dependent loads, as for K3.  BASELINE config 5's ~499k-triangle mesh
// took ~87 MB in the float layout (1.2M 64-byte leaf rows: object-split
// leaves of ~3-4 triangles, each padded to 8 rows), past the 50 MB L2; its
// compressed copy (80-byte nodes, 48-byte unpadded leaf rows) fits inside
// it; a ray reads 28 bytes and writes 8.
// The design:
//   * one thread per ray.  The TPU kernel's host-built per-block page
//     schedule (two 16-bit ids a word for SMEM), double-buffered page DMAs
//     into VMEM, block any-hit vote, 32x32 tile remap and block_rows
//     escalation exist to stream pages through VMEM and are gone: every page
//     sits in device memory and each thread walks its own pages;
//   * the ray is clamped to the global mesh box (the union of the root's
//     decoded children, which holds their float union): a ray that misses
//     it returns at once, and its search bound is the box exit (x 1.0001 +
//     1e-3, the TPU kernel's margin);
//   * then one walk, K3's (traverse.cuh traverse_wide), from the root over
//     the whole tree: top nodes and page nodes alike are visited near to
//     far, and an entry the ray enters at or past its best hit is skipped
//     (the occlusion skip) before its node is read.  Entering a page root
//     counts a page.  The top tree (depth 3 for config 5's 122 pages) costs
//     a few slab tests a ray and has no page-count cap; no second stack, no
//     restart inside a page;
//   * no early-out is shared between rays: the TPU kernel's sky-block exit
//     lets one NaN lane skip its whole block; here a NaN ray affects only
//     its own thread, and misses at once.
//
// Numerics: as traverse.cu (no --use_fast_math; the triangle test is left to
// nvcc's FMA contraction).
//
// Planted faults (chip_smoke.py, argument `fault`, 0 in use): 1 reports the
// slot one page on; 2 skips the first page the ray would search; 3 gates each
// page root on the entry distance of the next entry on the stack with `>`
// (+inf when no entry is left), in place of its own with `>=`.  Faults 2
// and 3 are the walk's (traverse.cuh WalkFault); fault 3 leaves the other
// nodes' gate as it is, so the walk goes on: it loses a ray's hit only
// where the page that holds it is the last entry left.

#include "traverse.cuh"

namespace {

using namespace vpt;

constexpr int kThreads = 128;

enum Fault { kNoFault = 0, kSlotPageOff = 1, kSkipNearestPage = 2, kNextEntryGate = 3 };

__device__ __forceinline__ void add_work(unsigned long long* stats, const Work& w) {
  if (stats == nullptr) return;
  atomicAdd(stats + 0, static_cast<unsigned long long>(w.visits));
  atomicAdd(stats + 1, static_cast<unsigned long long>(w.boxes));
  atomicAdd(stats + 2, static_cast<unsigned long long>(w.tris));
  atomicAdd(stats + 3, static_cast<unsigned long long>(w.pages));
}

template <int kFault>
__global__ void __launch_bounds__(kThreads)
paged_kernel(const uint4* __restrict__ nodes, const float4* __restrict__ rows,
             int n_top, int n_pages, int page_tris, int n_slots,
             const float* __restrict__ ray_o, const float* __restrict__ ray_d,
             const float* __restrict__ t_max, int n,
             int* __restrict__ slot_out, float* __restrict__ t_out,
             unsigned long long* __restrict__ stats) {
  const int i = blockIdx.x * blockDim.x + threadIdx.x;
  if (i >= n) return;
  const float tmax = __ldg(t_max + i);
  Work w;
  int best_slot = -1;
  float best_t = tmax;
  if (tmax > 0.f) {  // a dead lane (t_max <= 0, or NaN) returns at once
    const Ray r = load_ray(ray_o, ray_d, i);
    // The global mesh box: the union of the root's non-empty children,
    // decoded (traverse.cuh's quanta: p + q * s, q * s exact).
    const uint4 a = __ldg(nodes), b = __ldg(nodes + 1);
    const uint4 q[3] = {__ldg(nodes + 2), __ldg(nodes + 3), __ldg(nodes + 4)};
    const unsigned lo_w[3][2] = {{q[0].x, q[0].y}, {q[0].z, q[0].w}, {q[1].x, q[1].y}};
    const unsigned hi_w[3][2] = {{q[1].z, q[1].w}, {q[2].x, q[2].y}, {q[2].z, q[2].w}};
    const float p[3] = {__uint_as_float(a.x), __uint_as_float(a.y), __uint_as_float(a.z)};
    unsigned q_lo[3] = {255u, 255u, 255u}, q_hi[3] = {0u, 0u, 0u};
#pragma unroll
    for (int c = 0; c < 8; ++c) {
      if (meta_of(b, c) == 0u) continue;
#pragma unroll
      for (int k = 0; k < 3; ++k) {
        q_lo[k] = min(q_lo[k], (lo_w[k][c >> 2] >> (8 * (c & 3))) & 0xffu);
        q_hi[k] = max(q_hi[k], (hi_w[k][c >> 2] >> (8 * (c & 3))) & 0xffu);
      }
    }
    float t_near = -__int_as_float(0x7f800000), t_far = __int_as_float(0x7f800000);
    bool nan_ray = false;
#pragma unroll
    for (int k = 0; k < 3; ++k) {
      const float s = __uint_as_float(((a.w >> (8 * k)) & 0xffu) << 23);
      const float lo = fmaf(static_cast<float>(q_lo[k]), s, p[k]);
      const float hi = fmaf(static_cast<float>(q_hi[k]), s, p[k]);
      const float t0 = (lo - r.o[k]) * r.inv[k], t1 = (hi - r.o[k]) * r.inv[k];
      t_near = fmaxf(t_near, fminf(t0, t1));
      t_far = fminf(t_far, fmaxf(t0, t1));
      nan_ray |= isnan(r.o[k]) || isnan(r.d[k]);
    }
    // A ray with a NaN component hits nothing (fminf/fmaxf would drop the
    // NaN and walk it through every page): it misses at once, as in the
    // plain version, where every comparison with it fails.
    if (!nan_ray && fmaxf(t_near, 0.f) <= t_far) {
      constexpr int kWalk = kFault == kSkipNearestPage ? kWalkSkipFirstPage
                          : kFault == kNextEntryGate   ? kWalkNextEntryGate
                                                       : kWalkSound;
      const Hit h = traverse_wide<kWalk, true>(
          nodes, rows, r, fminf(tmax, t_far * 1.0001f + 1e-3f), w, n_top,
          n_top + n_pages);
      best_slot = h.slot;
      if (h.slot >= 0) best_t = h.t;
    }
  }
  if (kFault == kSlotPageOff && best_slot >= 0) {
    best_slot = (best_slot + page_tris) % n_slots;
  }
  slot_out[i] = best_slot;
  t_out[i] = best_t;
  add_work(stats, w);
}

}  // namespace

// Launch K5 on `stream`; returns cudaGetLastError() (0 on success), or
// cudaErrorInvalidValue (1) for an unknown fault.  All pointers are device
// pointers, 16-byte aligned: nodes [M,20] i32 and rows [R,12] f32 (the
// compressed copy of scene.PagedNodes, page roots [n_top, n_top +
// n_pages)), ray_o/ray_d [n,3] f32, t_max [n] f32, slot [n] i32, t [n] f32;
// `stats` is null or 4 u64 (node visits, box tests, triangle tests, pages
// searched) the kernel adds to.  `n_slots` is the length of the mesh's slot
// arrays; `fault` is 0 in use.
extern "C" int vpt_traverse_paged(const void* nodes, const void* rows,
                                  int n_top, int n_pages, int page_tris,
                                  int n_slots, const void* ray_o,
                                  const void* ray_d, const void* t_max, int n,
                                  void* slot, void* t, void* stats, int fault,
                                  void* stream) {
  if (n <= 0) return static_cast<int>(cudaGetLastError());
#define VPT_K5(FAULT)                                                               \
  paged_kernel<FAULT><<<(n + kThreads - 1) / kThreads, kThreads, 0,                 \
                        static_cast<cudaStream_t>(stream)>>>(                       \
      static_cast<const uint4*>(nodes), static_cast<const float4*>(rows), n_top,    \
      n_pages, page_tris, n_slots, static_cast<const float*>(ray_o),                \
      static_cast<const float*>(ray_d), static_cast<const float*>(t_max), n,        \
      static_cast<int*>(slot), static_cast<float*>(t),                              \
      static_cast<unsigned long long*>(stats))
  switch (fault) {
    case kNoFault: VPT_K5(kNoFault); break;
    case kSlotPageOff: VPT_K5(kSlotPageOff); break;
    case kSkipNearestPage: VPT_K5(kSkipNearestPage); break;
    case kNextEntryGate: VPT_K5(kNextEntryGate); break;
    default: return static_cast<int>(cudaErrorInvalidValue);
  }
#undef VPT_K5
  return static_cast<int>(cudaGetLastError());
}
