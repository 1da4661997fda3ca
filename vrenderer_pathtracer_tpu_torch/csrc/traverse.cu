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
// Numerics: built without --use_fast_math (IEEE division).  The slab test is
// a subtract and a multiply per plane, which nvcc cannot contract.  The
// triangle test's determinant, u, v and t are sums of products, which nvcc
// contracts into FMAs.  Rounding every product and sum on its own
// (__fmul_rn/__fadd_rn/__fsub_rn) bought nothing against the plain version,
// itself compiled PyTorch code, and cost 6% of K3 (measured on an H100 80GB
// HBM3 at 700 W by chip_smoke.py, PERF.md), so the test is left to nvcc.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr float kTriEps = 1e-7f;   // accel/traverse.py TRI_EPS
constexpr int kMaxLeaf = 8;        // accel/mesh.py MAX_LEAF
constexpr int kStack = 96;         // accel/mesh.py STACK_DEPTH
constexpr int kWideStack = 256;    // accel/mesh.py WIDE_STACK_DEPTH
constexpr int kThreads = 128;

struct Ray {
  float o[3], d[3], inv[3];
};

// Work counters of one ray: node visits, box (slab) tests, triangle tests.
struct Work {
  unsigned visits = 0, boxes = 0, tris = 0;
};

__device__ __forceinline__ float guarded_inv(float d) {
  return 1.0f / (fabsf(d) > 1e-12f ? d : (d >= 0.f ? 1e-12f : -1e-12f));
}

__device__ __forceinline__ Ray load_ray(const float* __restrict__ ray_o,
                                        const float* __restrict__ ray_d,
                                        int i) {
  Ray r;
#pragma unroll
  for (int k = 0; k < 3; ++k) {
    r.o[k] = __ldg(ray_o + 3 * i + k);
    r.d[k] = __ldg(ray_d + 3 * i + k);
    r.inv[k] = guarded_inv(r.d[k]);
  }
  return r;
}

// accel/traverse.py::_slab_test: hit iff max(t_near, 0) <= min(t_far, best).
__device__ __forceinline__ bool slab(const Ray& r, float lx, float ly, float lz,
                                     float hx, float hy, float hz, float best,
                                     float& t_near) {
  const float t0x = (lx - r.o[0]) * r.inv[0], t1x = (hx - r.o[0]) * r.inv[0];
  const float t0y = (ly - r.o[1]) * r.inv[1], t1y = (hy - r.o[1]) * r.inv[1];
  const float t0z = (lz - r.o[2]) * r.inv[2], t1z = (hz - r.o[2]) * r.inv[2];
  t_near = fmaxf(fmaxf(fminf(t0x, t1x), fminf(t0y, t1y)), fminf(t0z, t1z));
  const float t_far = fminf(fminf(fmaxf(t0x, t1x), fmaxf(t0y, t1y)), fmaxf(t0z, t1z));
  return fmaxf(t_near, 0.f) <= fminf(t_far, best);
}

// accel/traverse.py::_moller_trumbore for one triangle; true and the hit
// distance in `t` iff the ray hits it at t > TRI_EPS.
__device__ __forceinline__ bool moller_trumbore(const Ray& r, const float v0[3],
                                                const float e1[3], const float e2[3],
                                                float& t) {
  const float* d = r.d;
  const float px = d[1] * e2[2] - d[2] * e2[1];
  const float py = d[2] * e2[0] - d[0] * e2[2];
  const float pz = d[0] * e2[1] - d[1] * e2[0];
  const float det = e1[0] * px + e1[1] * py + e1[2] * pz;
  if (!(fabsf(det) > kTriEps)) return false;
  const float inv_det = 1.0f / det;
  const float tx = r.o[0] - v0[0], ty = r.o[1] - v0[1], tz = r.o[2] - v0[2];
  const float u = (tx * px + ty * py + tz * pz) * inv_det;
  const float qx = ty * e1[2] - tz * e1[1];
  const float qy = tz * e1[0] - tx * e1[2];
  const float qz = tx * e1[1] - ty * e1[0];
  const float v = (d[0] * qx + d[1] * qy + d[2] * qz) * inv_det;
  t = (e2[0] * qx + e2[1] * qy + e2[2] * qz) * inv_det;
  return u >= 0.f && v >= 0.f && u + v <= 1.f && t > kTriEps;
}

__device__ __forceinline__ void push(int* stack, int& sp, int cap, int node) {
  // accel/mesh.py checks at pack time that a tree never needs more than
  // `cap` entries; the guard keeps a violated bound inside the array.
  if (sp < cap) stack[sp++] = node;
}

__device__ __forceinline__ void add_work(unsigned long long* stats, const Work& w) {
  if (stats == nullptr) return;
  atomicAdd(stats + 0, static_cast<unsigned long long>(w.visits));
  atomicAdd(stats + 1, static_cast<unsigned long long>(w.boxes));
  atomicAdd(stats + 2, static_cast<unsigned long long>(w.tris));
}

// K3: the 8-wide BVH.  boxes [N*8, 8] (child c of node w at row w*8+c: lo
// xyz, hi xyz, 0, 0), records [N, 16] (8 x (ref, count); count 0 inner, > 0
// leaf rows of `pack`, < 0 empty), axes [N], pack [T8, 16] (v0, e1, e2,
// slot, uv corners).
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
  float best_t = tmax;
  int best_slot = -1;
  Work w;
  if (tmax > 0.f) {  // a dead lane (t_max <= 0, or NaN) returns at once
    const Ray r = load_ray(ray_o, ray_d, i);
    int stack[kWideStack];
    int sp = 1;
    stack[0] = 0;
    while (sp > 0) {
      const int node = stack[--sp];
      ++w.visits;
      const int ax = __ldg(axes + node);
      const float d_ax = ax == 0 ? r.d[0] : (ax == 1 ? r.d[1] : r.d[2]);
      const int flip = d_ax >= 0.f ? 0 : 7;  // children near to far
      const float* bx = boxes + 64 * node;
      const int2* rec = reinterpret_cast<const int2*>(recs) + 8 * node;
      unsigned inner = 0, leaves = 0;
#pragma unroll
      for (int k = 0; k < 8; ++k) {
        const int c = k ^ flip;
        const int cnt = __ldg(&rec[c].y);
        if (cnt < 0) continue;
        ++w.boxes;
        const float4 a = __ldg(reinterpret_cast<const float4*>(bx + 8 * c));
        const float2 b = __ldg(reinterpret_cast<const float2*>(bx + 8 * c + 4));
        float tn;
        if (slab(r, a.x, a.y, a.z, a.w, b.x, b.y, best_t, tn)) {
          (cnt == 0 ? inner : leaves) |= 1u << c;
        }
      }
      // The hit leaves, near to far, through one copy of the triangle test.
#pragma unroll 1
      for (int k = 0; k < 8; ++k) {
        const int c = k ^ flip;
        if (!(leaves >> c & 1u)) continue;
        const int2 rc = __ldg(rec + c);  // (ref, count)
        const int cnt = min(rc.y, kMaxLeaf);
        for (int j = 0; j < cnt; ++j) {
          const float4* row = reinterpret_cast<const float4*>(pack) + 4 * (rc.x + j);
          const float4 p0 = __ldg(row), p1 = __ldg(row + 1), p2 = __ldg(row + 2);
          const float v0[3] = {p0.x, p0.y, p0.z};
          const float e1[3] = {p0.w, p1.x, p1.y};
          const float e2[3] = {p1.z, p1.w, p2.x};
          ++w.tris;
          float t;
          if (moller_trumbore(r, v0, e1, e2, t) && t < best_t) {
            best_t = t;
            best_slot = __float2int_rn(p2.y);
          }
        }
      }
      // Push the inner children far to near, so the nearest pops first.
#pragma unroll
      for (int k = 7; k >= 0; --k) {
        const int c = k ^ flip;
        if (inner >> c & 1u) push(stack, sp, kWideStack, __ldg(&rec[c].x));
      }
    }
  }
  slot_out[i] = best_slot;
  t_out[i] = best_t;
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
          float t;
          if (moller_trumbore(r, v0, e1, e2, t) && t < best_t) {
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
