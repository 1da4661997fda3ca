// K3 and K3b: closest-hit BVH traversal, hand-written CUDA C++ for Hopper
// (sm_90a).
//
// K3 replaces vrenderer_pathtracer_tpu/accel/pallas_traverse.py::_kernel_wide
// (the 8-wide BVH of accel/wide.py) and K3b ::_kernel (the binary SBVH).
// Both compute, per ray, the closest Möller–Trumbore triangle hit with
// t < t_max, as (slot int32, t float32): slot -1 and t = t_max on a miss.  A
// slot indexes the mesh's contiguous leaf-ordered triangle arrays (K3 reads
// it from column 9 of the leaf block, exact as a float below 2^24).  The
// plain PyTorch version of both is accel/traverse.py::traverse, the JAX
// package's lockstep binary traversal; the wrapper is
// accel/cuda_traverse.py::traverse_cuda.
//
// What bounds them on the H100: operations, divergence and cache misses, not
// device memory.  The 28.5k-triangle mesh's BVH and leaf blocks take ~4.7 MB
// (K3) or ~2 MB (K3b), inside the 50 MB L2, and a ray reads 28 bytes and
// writes 8; every node visit costs 8 (K3) or 2 (K3b) slab tests and every
// leaf up to 8 triangle tests, per ray, with neighbouring rays on different
// paths through the tree.  The design therefore:
//   * one thread per ray, its stack in local memory (K3b: 96 entries,
//     accel/mesh.py STACK_DEPTH; K3: 256 entries, >= 7 * depth + 1 for every
//     tree pack_from_bvh accepts), all other state in registers;
//   * the TPU kernel's block-shared stack and any-hit votes, root-exit clamp,
//     32x32 tile remap, packed 20-bit records and lane-dense layouts are
//     Mosaic/VMEM workarounds and are gone;
//   * the BVH and triangle arrays go through the read-only cache (__ldg),
//     a K3 child box as one float4 + one float2, a leaf-block row as three
//     float4, a K3b node as three float4 + one int4;
//   * the closest hit is updated on strict t < best, so the first triangle in
//     leaf order wins a tie, as in traverse.  K3b tests a leaf as soon as its
//     box is hit, as traverse does.  K3 slab-tests a node's eight children
//     first, then tests its hit leaves near to far through one copy of the
//     triangle test (measured on an H100 80GB HBM3 at 700 W, chip_smoke.py:
//     1.475 ms per 1024^2 nm pass against 1.593 ms for testing each leaf
//     inside the unrolled child loop);
//   * inner children are pushed far to near: K3 visits a node's children in
//     the ray's direction along the node's stored sort axis and pushes them
//     in the reverse order, K3b pushes by entry distance as traverse does;
//   * a ray with t_max <= 0 (the integrator's dead lanes) returns at once:
//     no triangle at t > TRI_EPS can be closer.
//
// K3's per-ray search is traverse.cuh's traverse_wide, the device function
// K4 (mesh.cu) calls at every bounce; the helpers of both kernels live there
// too.
//
// Numerics: built without --use_fast_math (IEEE division).  The slab test is
// a subtract and a multiply per plane, which nvcc cannot contract.  The
// triangle test's determinant, u, v and t are sums of products, which nvcc
// contracts into FMAs.  Rounding every product and sum on its own
// (__fmul_rn/__fadd_rn/__fsub_rn) bought nothing against the plain version,
// itself compiled PyTorch code, and cost 6% of K3 (measured on an H100 80GB
// HBM3 at 700 W by chip_smoke.py, PERF.md), so the test is left to nvcc.

#include "traverse.cuh"

namespace {

using namespace vpt;

constexpr int kThreads = 128;

__device__ __forceinline__ void add_work(unsigned long long* stats, const Work& w) {
  if (stats == nullptr) return;
  atomicAdd(stats + 0, static_cast<unsigned long long>(w.visits));
  atomicAdd(stats + 1, static_cast<unsigned long long>(w.boxes));
  atomicAdd(stats + 2, static_cast<unsigned long long>(w.tris));
}

// K3: the 8-wide BVH (layout: traverse.cuh traverse_wide).
__global__ void __launch_bounds__(kThreads)
traverse_wide_kernel(const float* __restrict__ boxes, const int* __restrict__ recs,
                     const int* __restrict__ axes, const float* __restrict__ pack,
                     const float* __restrict__ ray_o, const float* __restrict__ ray_d,
                     const float* __restrict__ t_max, int n,
                     int* __restrict__ slot_out, float* __restrict__ t_out,
                     unsigned long long* __restrict__ stats) {
  const int i = blockIdx.x * blockDim.x + threadIdx.x;
  if (i >= n) return;
  const float tmax = __ldg(t_max + i);
  Work w;
  Hit h;
  if (tmax > 0.f) {  // a dead lane (t_max <= 0, or NaN) returns at once
    h = traverse_wide(boxes, recs, axes, pack, load_ray(ray_o, ray_d, i), tmax, w);
  } else {
    h.slot = -1;
    h.t = tmax;
  }
  slot_out[i] = h.slot;
  t_out[i] = h.t;
  add_work(stats, w);
}

// K3b: the binary SBVH.  nodes_f [M, 12] (lo0, hi0, lo1, hi1), nodes_i
// [M, 4] (c0, n0, c1, n1), v0/e1/e2 [T, 3].
__global__ void __launch_bounds__(kThreads)
traverse_binary_kernel(const float* __restrict__ nodes_f,
                       const int* __restrict__ nodes_i,
                       const float* __restrict__ tv0, const float* __restrict__ te1,
                       const float* __restrict__ te2,
                       const float* __restrict__ ray_o, const float* __restrict__ ray_d,
                       const float* __restrict__ t_max, int n,
                       int* __restrict__ slot_out, float* __restrict__ t_out,
                       unsigned long long* __restrict__ stats) {
  const int i = blockIdx.x * blockDim.x + threadIdx.x;
  if (i >= n) return;
  const float tmax = __ldg(t_max + i);
  float best_t = tmax;
  int best_slot = -1;
  Work w;
  if (tmax > 0.f) {  // a dead lane (t_max <= 0, or NaN) returns at once
    const Ray r = load_ray(ray_o, ray_d, i);
    int stack[kStack];
    int sp = 1;
    stack[0] = 0;
    while (sp > 0) {
      const int node = stack[--sp];
      ++w.visits;
      const float4* nf = reinterpret_cast<const float4*>(nodes_f) + 3 * node;
      const float4 f0 = __ldg(nf), f1 = __ldg(nf + 1), f2 = __ldg(nf + 2);
      const int4 ni = __ldg(reinterpret_cast<const int4*>(nodes_i) + node);
      const float lo[2][3] = {{f0.x, f0.y, f0.z}, {f1.z, f1.w, f2.x}};
      const float hi[2][3] = {{f0.w, f1.x, f1.y}, {f2.y, f2.z, f2.w}};
      const int ref[2] = {ni.x, ni.z}, cnt[2] = {ni.y, ni.w};
      bool hit[2];
      float tn[2];
#pragma unroll
      for (int c = 0; c < 2; ++c) {
        hit[c] = false;
        tn[c] = 0.f;
        if (cnt[c] < 0) continue;
        ++w.boxes;
        hit[c] = slab(r, lo[c][0], lo[c][1], lo[c][2], hi[c][0], hi[c][1],
                      hi[c][2], best_t, tn[c]);
        if (!hit[c] || cnt[c] == 0) continue;
        // Leaf child: resolve inline, before the next child's slab test.
        const int m = min(cnt[c], kMaxLeaf);
        for (int j = 0; j < m; ++j) {
          const int s = ref[c] + j;
          const float v0[3] = {__ldg(tv0 + 3 * s), __ldg(tv0 + 3 * s + 1), __ldg(tv0 + 3 * s + 2)};
          const float e1[3] = {__ldg(te1 + 3 * s), __ldg(te1 + 3 * s + 1), __ldg(te1 + 3 * s + 2)};
          const float e2[3] = {__ldg(te2 + 3 * s), __ldg(te2 + 3 * s + 1), __ldg(te2 + 3 * s + 2)};
          ++w.tris;
          float t, u, v;
          if (moller_trumbore(r, v0, e1, e2, t, u, v) && t < best_t) {
            best_t = t;
            best_slot = s;
          }
        }
      }
      // Inner children: far first, so the near one pops first.
      const bool p0 = hit[0] && cnt[0] == 0, p1 = hit[1] && cnt[1] == 0;
      if (p0 && p1) {
        const bool near0 = tn[0] <= tn[1];
        push(stack, sp, kStack, near0 ? ref[1] : ref[0]);
        push(stack, sp, kStack, near0 ? ref[0] : ref[1]);
      } else if (p0 || p1) {
        push(stack, sp, kStack, p0 ? ref[0] : ref[1]);
      }
    }
  }
  slot_out[i] = best_slot;
  t_out[i] = best_t;
  add_work(stats, w);
}

inline int blocks_for(int n) { return (n + kThreads - 1) / kThreads; }

}  // namespace

// Launch K3 on `stream`; returns cudaGetLastError() (0 on success).  All
// pointers are device pointers: boxes [N*8,8] f32, records [N,16] i32, axes
// [N] i32, pack [T8,16] f32, ray_o/ray_d [n,3] f32, t_max [n] f32, slot [n]
// i32, t [n] f32; `stats` is null or 3 u64 (visits, box tests, triangle
// tests) the kernel adds to.
extern "C" int vpt_traverse_wide(const void* boxes, const void* recs,
                                 const void* axes, const void* pack,
                                 const void* ray_o, const void* ray_d,
                                 const void* t_max, int n, void* slot, void* t, void* stats,
                                 void* stream) {
  if (n > 0) {
    traverse_wide_kernel<<<blocks_for(n), kThreads, 0, static_cast<cudaStream_t>(stream)>>>(
        static_cast<const float*>(boxes), static_cast<const int*>(recs),
        static_cast<const int*>(axes), static_cast<const float*>(pack),
        static_cast<const float*>(ray_o), static_cast<const float*>(ray_d),
        static_cast<const float*>(t_max), n, static_cast<int*>(slot),
        static_cast<float*>(t), static_cast<unsigned long long*>(stats));
  }
  return static_cast<int>(cudaGetLastError());
}

// Launch K3b on `stream`; returns cudaGetLastError().  nodes_f [M,12] f32,
// nodes_i [M,4] i32, v0/e1/e2 [T,3] f32; rays, outputs and `stats` as for
// vpt_traverse_wide.
extern "C" int vpt_traverse_binary(const void* nodes_f, const void* nodes_i,
                                   const void* v0, const void* e1,
                                   const void* e2, const void* ray_o,
                                   const void* ray_d, const void* t_max, int n,
                                   void* slot, void* t, void* stats,
                                   void* stream) {
  if (n > 0) {
    traverse_binary_kernel<<<blocks_for(n), kThreads, 0, static_cast<cudaStream_t>(stream)>>>(
        static_cast<const float*>(nodes_f), static_cast<const int*>(nodes_i),
        static_cast<const float*>(v0), static_cast<const float*>(e1),
        static_cast<const float*>(e2), static_cast<const float*>(ray_o),
        static_cast<const float*>(ray_d), static_cast<const float*>(t_max), n,
        static_cast<int*>(slot), static_cast<float*>(t),
        static_cast<unsigned long long*>(stats));
  }
  return static_cast<int>(cudaGetLastError());
}
