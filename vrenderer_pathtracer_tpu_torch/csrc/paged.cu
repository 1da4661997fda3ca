// K5: closest-hit traversal of a paged mesh, hand-written CUDA C++ for
// Hopper (sm_90a).
//
// Replaces vrenderer_pathtracer_tpu/accel/pallas_paged.py::_kernel (reached
// through traverse_paged).  It computes, per ray, the closest Möller–Trumbore
// triangle hit with t < t_max over all pages of a paged mesh, as (slot int32,
// t float32): slots are global (page * page_tris + local), a miss gives slot
// -1 and t = t_max.  The layout is accel/paged.py's (scene.PagedNodes): one
// node space holding an 8-wide top-level tree over the page boxes (nodes
// [0, n_top), root 0) and each page's 8-wide tree, all refs global; a top
// node's child of index >= n_top is a page's root.  The plain PyTorch
// version is accel/traverse.py::traverse_paged_reference; the wrapper is
// accel/cuda_paged.py::traverse_paged_cuda.
//
// What bounds it on the H100: operations, divergence and cache misses, as
// for K3.  BASELINE config 5's ~499k-triangle mesh takes ~87 MB of trees and
// leaf blocks (1.2M 64-byte leaf rows: object-split leaves of ~3-4
// triangles, each padded to 8 rows), past the 50 MB L2; a ray reads 28
// bytes and writes 8.
// The design:
//   * one thread per ray.  The TPU kernel's host-built per-block page
//     schedule (two 16-bit ids a word for SMEM), double-buffered page DMAs
//     into VMEM, block any-hit vote, 32x32 tile remap and block_rows
//     escalation exist to stream pages through VMEM and are gone: every page
//     sits in device memory and each thread walks its own pages;
//   * the ray is clamped to the global mesh box (the union of the root's
//     children): a ray that misses it returns at once, and its search bound
//     is the box exit (x 1.0001 + 1e-3, the TPU kernel's margin);
//   * the pages the ray enters are visited near to far through the top-level
//     tree: a node's children that the ray enters are pushed far to near by
//     entry distance, so the nearest pops first.  An entry is skipped when
//     the ray enters it at or past the best hit so far (the occlusion skip):
//     no triangle inside can be closer.  The top tree (depth 3 for config
//     5's 122 pages) costs a few slab tests a ray and has no page-count cap,
//     where a per-thread sorted list of page boxes would hold every box the
//     ray enters in local memory;
//   * inside a page, K3's per-ray search (traverse.cuh traverse_wide) runs
//     from the page's root with t_max set to the best t so far;
//   * no early-out is shared between rays: the TPU kernel's sky-block exit
//     lets one NaN lane skip its whole block; here a NaN ray affects only
//     its own thread, and misses at once.
//
// Numerics: as traverse.cu (no --use_fast_math; the triangle test is left to
// nvcc's FMA contraction).
//
// Planted faults (chip_smoke.py, argument `fault`, 0 in use): 1 reports the
// slot one page on; 2 skips the first page the ray would search; 3 gates each
// page entry on the entry distance of the next entry on the stack with `>`
// (+inf when no entry is left), in place of its own with `>=`.  Fault 3
// leaves the top-level nodes' gate as it is, so the walk goes on: it loses
// a ray's hit only where the page that holds it is the last entry left.

#include "traverse.cuh"

namespace {

using namespace vpt;

constexpr int kThreads = 128;
constexpr int kTopStack = 64;  // accel/paged.py TOP_STACK_DEPTH

enum Fault { kNoFault = 0, kSlotPageOff = 1, kSkipNearestPage = 2, kNextEntryGate = 3 };

struct Entry {
  int node;
  float t_near;
};

__device__ __forceinline__ void add_work(unsigned long long* stats, const Work& w,
                                         unsigned pages) {
  if (stats == nullptr) return;
  atomicAdd(stats + 0, static_cast<unsigned long long>(w.visits));
  atomicAdd(stats + 1, static_cast<unsigned long long>(w.boxes));
  atomicAdd(stats + 2, static_cast<unsigned long long>(w.tris));
  atomicAdd(stats + 3, static_cast<unsigned long long>(pages));
}

__global__ void __launch_bounds__(kThreads)
paged_kernel(const float* __restrict__ boxes, const int* __restrict__ recs,
             const float* __restrict__ pack,
             int n_top, int page_tris, int n_slots,
             const float* __restrict__ ray_o, const float* __restrict__ ray_d,
             const float* __restrict__ t_max, int n,
             int* __restrict__ slot_out, float* __restrict__ t_out,
             unsigned long long* __restrict__ stats, int fault) {
  const int i = blockIdx.x * blockDim.x + threadIdx.x;
  if (i >= n) return;
  const float tmax = __ldg(t_max + i);
  Work w;
  unsigned pages = 0;
  int best_slot = -1;
  float best_t = tmax;
  if (tmax > 0.f) {  // a dead lane (t_max <= 0, or NaN) returns at once
    const Ray r = load_ray(ray_o, ray_d, i);
    // The global mesh box: the union of the root's non-empty children.
    const float inf = __int_as_float(0x7f800000);
    float lo[3] = {inf, inf, inf}, hi[3] = {-inf, -inf, -inf};
    const int2* root = reinterpret_cast<const int2*>(recs);
#pragma unroll
    for (int c = 0; c < 8; ++c) {
      if (__ldg(&root[c].y) < 0) continue;
#pragma unroll
      for (int k = 0; k < 3; ++k) {
        lo[k] = fminf(lo[k], __ldg(boxes + 8 * c + k));
        hi[k] = fmaxf(hi[k], __ldg(boxes + 8 * c + 3 + k));
      }
    }
    float t_near = -inf, t_far = inf;
    bool nan_ray = false;
#pragma unroll
    for (int k = 0; k < 3; ++k) {
      const float t0 = (lo[k] - r.o[k]) * r.inv[k], t1 = (hi[k] - r.o[k]) * r.inv[k];
      t_near = fmaxf(t_near, fminf(t0, t1));
      t_far = fminf(t_far, fmaxf(t0, t1));
      nan_ray |= isnan(r.o[k]) || isnan(r.d[k]);
    }
    // A ray with a NaN component hits nothing (fminf/fmaxf would drop the
    // NaN and walk it through every page): it misses at once, as in the
    // plain version, where every comparison with it fails.
    if (!nan_ray && fmaxf(t_near, 0.f) <= t_far) {
      best_t = fminf(tmax, t_far * 1.0001f + 1e-3f);
      Entry stack[kTopStack];
      int sp = 1;
      stack[0] = {0, fmaxf(t_near, 0.f)};
      bool skipped = false;
      while (sp > 0) {
        const Entry e = stack[--sp];
        // The occlusion skip: nothing in an entry the ray enters at or past
        // its best hit can be closer.
        if (fault == kNextEntryGate && e.node >= n_top) {
          if ((sp > 0 ? stack[sp - 1].t_near : inf) > best_t) continue;
        } else if (e.t_near >= best_t) {
          continue;
        }
        if (e.node >= n_top) {  // a page's root: K3's search inside the page
          if (fault == kSkipNearestPage && !skipped) {
            skipped = true;
            continue;
          }
          ++pages;
          const Hit h = traverse_wide(boxes, recs, pack, r, best_t, w, e.node);
          if (h.slot >= 0) {
            best_t = h.t;
            best_slot = h.slot;
          }
          continue;
        }
        // A top-level node: the children the ray enters, far to near.
        ++w.visits;
        const float* bx = boxes + 64 * e.node;
        const int2* rec = reinterpret_cast<const int2*>(recs) + 8 * e.node;
        Entry hit[8];
        int m = 0;
#pragma unroll
        for (int c = 0; c < 8; ++c) {
          const int2 rc = __ldg(rec + c);
          if (rc.y < 0) continue;
          ++w.boxes;
          const float4 a = __ldg(reinterpret_cast<const float4*>(bx + 8 * c));
          const float2 b = __ldg(reinterpret_cast<const float2*>(bx + 8 * c + 4));
          float tn;
          if (slab(r, a.x, a.y, a.z, a.w, b.x, b.y, best_t, tn)) {
            const Entry en = {rc.x, fmaxf(tn, 0.f)};
            int k = m++;
            while (k > 0 && hit[k - 1].t_near < en.t_near) {
              hit[k] = hit[k - 1];
              --k;
            }
            hit[k] = en;
          }
        }
        for (int k = 0; k < m; ++k) {
          // accel/paged.py checks that the top tree never needs more.
          if (sp < kTopStack) stack[sp++] = hit[k];
        }
      }
    }
  }
  if (best_slot < 0) {
    best_t = tmax;
  } else if (fault == kSlotPageOff) {
    best_slot = (best_slot + page_tris) % n_slots;
  }
  slot_out[i] = best_slot;
  t_out[i] = best_t;
  add_work(stats, w, pages);
}

}  // namespace

// Launch K5 on `stream`; returns cudaGetLastError() (0 on success).  All
// pointers are device pointers: boxes [N*8,8] f32, records [N,16] i32, pack
// [T8,16] f32 (scene.PagedNodes), ray_o/ray_d [n,3] f32, t_max [n] f32,
// slot [n] i32, t [n] f32; `stats` is null or 4 u64 (node visits, box tests,
// triangle tests, pages searched) the kernel adds to.  `n_slots` is the
// length of the mesh's slot arrays; `fault` is 0 in use.
extern "C" int vpt_traverse_paged(const void* boxes, const void* recs,
                                  const void* pack, int n_top, int page_tris,
                                  int n_slots, const void* ray_o,
                                  const void* ray_d, const void* t_max, int n,
                                  void* slot, void* t, void* stats, int fault,
                                  void* stream) {
  if (n > 0) {
    paged_kernel<<<(n + kThreads - 1) / kThreads, kThreads, 0,
                   static_cast<cudaStream_t>(stream)>>>(
        static_cast<const float*>(boxes), static_cast<const int*>(recs),
        static_cast<const float*>(pack), n_top, page_tris, n_slots,
        static_cast<const float*>(ray_o), static_cast<const float*>(ray_d),
        static_cast<const float*>(t_max), n, static_cast<int*>(slot),
        static_cast<float*>(t), static_cast<unsigned long long*>(stats), fault);
  }
  return static_cast<int>(cudaGetLastError());
}
