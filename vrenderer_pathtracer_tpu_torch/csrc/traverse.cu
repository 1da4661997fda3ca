// K3 and K3b: closest-hit BVH traversal, hand-written CUDA C++ for Hopper
// (sm_90a).
//
// K3 replaces vrenderer_pathtracer_tpu/accel/pallas_traverse.py::_kernel_wide
// (the 8-wide BVH of accel/wide.py) and K3b ::_kernel (the binary SBVH).
// Both compute, per ray, the closest Möller–Trumbore triangle hit with
// t < t_max, as (slot int32, t float32): slot -1 and t = t_max on a miss.  A
// slot indexes the mesh's contiguous leaf-ordered triangle arrays (K3 reads
// it from its leaf row, as an int).  The
// plain PyTorch version of both is accel/traverse.py::traverse, the JAX
// package's lockstep binary traversal; the wrapper is
// accel/cuda_traverse.py::traverse_cuda.
//
// What bounds them on the H100: operations, divergence and the latency of
// dependent loads, not device memory.  The 28.5k-triangle mesh's compressed
// copy takes ~1.8 MB (K3; the JAX-parity nodes and 8-aligned leaf blocks it
// replaced took ~4.7 MB) or its binary tree ~2 MB (K3b), inside the 50 MB
// L2, and a ray reads 28 bytes and writes 8; every node visit costs 8 (K3)
// or 2 (K3b) slab tests and every leaf up to 8 triangle tests, per ray,
// with neighbouring rays on different paths through the tree.  So the work
// a ray does, and the loads each step waits for, are what to cut, and the
// design:
//   * one thread per ray, all state in registers but the stack, which is in
//     local memory (K3b: 96 entries, accel/mesh.py STACK_DEPTH; K3: 256
//     entries of 8 bytes, >= 7 * depth + 1 for every tree pack_from_bvh
//     accepts; a thread touches only the entries its walk reaches);
//   * the TPU kernel's block-shared stack and any-hit votes, root-exit clamp,
//     32x32 tile remap, packed 20-bit records and lane-dense layouts are
//     Mosaic/VMEM workarounds and are gone;
//   * the BVH and triangle arrays go through the read-only cache (__ldg).
//     K3 reads the compressed copy (accel/wide.py::compress_wide, after
//     Ylitie, Karras and Laine, HPG 2017): a node is five 16-byte loads (the
//     origin, three power-of-two quanta, the kind mask, the child and row
//     bases, a meta byte and six outward-rounded 8-bit bounds a child),
//     where the float layout took 24 loads from a 256-byte box row and a
//     64-byte record row; a leaf row is three float4 of 48 bytes, leaves
//     unpadded.  A K3b node is three float4 + one int4;
//   * both walk near to far by slab entry distance: K3 tests a node's hit
//     leaves nearest first until the nearest left starts past the best hit,
//     pushes its inner children far to near with their entry distances, and
//     skips a popped node that a closer hit has put out of reach without
//     reading its node (traverse.cuh traverse_wide); K3b pushes by entry
//     distance as traverse does;
//   * the closest hit is updated on strict t < best, so the first triangle in
//     leaf order wins a tie, as in traverse.  K3b tests a leaf as soon as its
//     box is hit, as traverse does.  K3 slab-tests a node's eight children
//     first, then its hit leaves through one copy of the triangle test;
//   * a ray with t_max <= 0 (the integrator's dead lanes) returns at once:
//     no triangle at t > TRI_EPS can be closer.
//
// K3's per-ray search is traverse.cuh's traverse_wide, the device function
// K4 (mesh.cu) calls at every bounce; the helpers of both kernels live there
// too.
//
// K3c is K3 with win-time attribute capture: ::_kernel_wide with capture=
// (pallas_traverse.py CAPTURE_WIDTHS, on_win), which writes the winning
// triangle's face normal, uv, tangent and smooth normal beside (slot, t) for
// the wavefront's forward pass (settings.captured_attrs).  The Pallas kernel
// interpolates at every win, because the leaf block is in VMEM only then.
// Here one thread owns one ray: the walk is K3's traverse_wide, which keeps
// the winner's barycentrics, and once per ray after the walk the thread
// reads the winner's corner rows by slot through the read-only cache
// (tri_e1/tri_e2 12 bytes each, tri_uv 24, tri_t and tri_n 36 each: at most
// 120 bytes a hit), interpolates w*c0 + u*c1 + v*c2, normalises the three
// directions by 1/sqrt(max(|x|^2, 1e-40)) and writes the requested fields
// (11 floats a ray at most; zeros on a miss).  The field mask is a template
// parameter, so K3 itself (mask 0) holds none of this code.  Its plain
// version is accel/traverse.py::capture_reference.
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

// K3: the 8-wide BVH's compressed copy (traverse.cuh traverse_wide).
__global__ void __launch_bounds__(kThreads)
traverse_wide_kernel(const uint4* __restrict__ nodes, const float4* __restrict__ rows,
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
    h = traverse_wide(nodes, rows, load_ray(ray_o, ray_d, i), tmax, w);
  } else {
    h.slot = -1;
    h.t = tmax;
  }
  slot_out[i] = h.slot;
  t_out[i] = h.t;
  add_work(stats, w);
}

// The winner's mesh attributes K3c reads by slot, and its outputs (each
// [n, 3], uv [n, 2]; null where not requested).
struct Attrs {
  const float *e1, *e2, *uv, *tan, *nrm;  // [T,3], [T,3], [T,3,2], [T,3,3], [T,3,3]
};
struct Captured {
  float *normal, *uv, *tangent, *smooth;
};

constexpr unsigned kCapNormal = 1, kCapUv = 2, kCapTangent = 4, kCapSmooth = 8;
// Planted faults of K3c's check (chip_smoke.py), template arguments so that
// the kernel's own instances (kFault 0) hold none of them.
constexpr int kFaultSwapUv = 1, kFaultRawTangent = 2, kFaultStaleAttrs = 3;

__device__ __forceinline__ void store_unit(float* out, float x, float y,
                                           float z, bool normalise = true) {
  const float inv = normalise ? 1.0f / sqrtf(fmaxf(x * x + y * y + z * z, 1e-40f)) : 1.f;
  out[0] = x * inv;
  out[1] = y * inv;
  out[2] = z * inv;
}

// w*c0 + u*c1 + v*c2 of the three corner rows of `rows` (3 components each).
__device__ __forceinline__ void bary3(const float* rows, float w, float u,
                                      float v, float out[3]) {
#pragma unroll
  for (int k = 0; k < 3; ++k) {
    out[k] = w * __ldg(rows + k) + u * __ldg(rows + 3 + k) + v * __ldg(rows + 6 + k);
  }
}

// K3c: K3's walk, then the winner's attributes once per ray.
template <unsigned kCap, int kFault>
__global__ void __launch_bounds__(kThreads)
traverse_capture_kernel(const uint4* __restrict__ nodes, const float4* __restrict__ rows,
                        const float* __restrict__ ray_o, const float* __restrict__ ray_d,
                        const float* __restrict__ t_max, int n,
                        int* __restrict__ slot_out, float* __restrict__ t_out,
                        unsigned long long* __restrict__ stats, Attrs a,
                        Captured c) {
  const int i = blockIdx.x * blockDim.x + threadIdx.x;
  if (i >= n) return;
  const float tmax = __ldg(t_max + i);
  Work w;
  Hit h;
  if (tmax > 0.f) {  // a dead lane (t_max <= 0, or NaN) returns at once
    h = traverse_wide<kFault == kFaultStaleAttrs ? kWalkStaleAttrs : kWalkSound>(
        nodes, rows, load_ray(ray_o, ray_d, i), tmax, w);
  } else {
    h.slot = h.attr = -1;
    h.t = tmax;
  }
  slot_out[i] = h.slot;
  t_out[i] = h.t;
  add_work(stats, w);
  const bool hit = h.slot >= 0;
  const size_t s = hit ? static_cast<size_t>(h.attr) : 0;
  float u = hit ? h.u : 0.f, v = hit ? h.v : 0.f;
  if (kFault == kFaultSwapUv) {
    const float x = u;
    u = v;
    v = x;
  }
  const float bw = 1.f - u - v;
  if (kCap & kCapNormal) {
    float* out = c.normal + 3 * static_cast<size_t>(i);
    if (hit) {  // e1 x e2, the orientation of shade_mesh_hit's face normal
      const float* p = a.e1 + 3 * s;
      const float* q = a.e2 + 3 * s;
      const float ax = __ldg(p), ay = __ldg(p + 1), az = __ldg(p + 2);
      const float bx = __ldg(q), by = __ldg(q + 1), bz = __ldg(q + 2);
      store_unit(out, ay * bz - az * by, az * bx - ax * bz, ax * by - ay * bx);
    } else {
      out[0] = out[1] = out[2] = 0.f;
    }
  }
  if (kCap & kCapUv) {
    float* out = c.uv + 2 * static_cast<size_t>(i);
    if (hit) {  // corners (u0, v0, u1, v1, u2, v2)
      const float* p = a.uv + 6 * s;
      out[0] = bw * __ldg(p) + u * __ldg(p + 2) + v * __ldg(p + 4);
      out[1] = bw * __ldg(p + 1) + u * __ldg(p + 3) + v * __ldg(p + 5);
    } else {
      out[0] = out[1] = 0.f;
    }
  }
  if (kCap & kCapTangent) {
    float* out = c.tangent + 3 * static_cast<size_t>(i);
    if (hit) {
      float x[3];
      bary3(a.tan + 9 * s, bw, u, v, x);
      store_unit(out, x[0], x[1], x[2], kFault != kFaultRawTangent);
    } else {
      out[0] = out[1] = out[2] = 0.f;
    }
  }
  if (kCap & kCapSmooth) {
    float* out = c.smooth + 3 * static_cast<size_t>(i);
    if (hit) {
      float x[3];
      bary3(a.nrm + 9 * s, bw, u, v, x);
      store_unit(out, x[0], x[1], x[2]);
    } else {
      out[0] = out[1] = out[2] = 0.f;
    }
  }
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
// pointers are device pointers, 16-byte aligned: nodes [M,20] i32 and rows
// [R,12] f32 (the compressed copy, accel/wide.py), ray_o/ray_d [n,3] f32,
// t_max [n] f32, slot [n] i32, t [n] f32; `stats` is null or 3 u64
// (visits, box tests, triangle tests) the kernel adds to.
extern "C" int vpt_traverse_wide(const void* nodes, const void* rows,
                                 const void* ray_o, const void* ray_d,
                                 const void* t_max, int n, void* slot, void* t,
                                 void* stats, void* stream) {
  if (n > 0) {
    traverse_wide_kernel<<<blocks_for(n), kThreads, 0, static_cast<cudaStream_t>(stream)>>>(
        static_cast<const uint4*>(nodes), static_cast<const float4*>(rows),
        static_cast<const float*>(ray_o),
        static_cast<const float*>(ray_d), static_cast<const float*>(t_max), n,
        static_cast<int*>(slot), static_cast<float*>(t),
        static_cast<unsigned long long*>(stats));
  }
  return static_cast<int>(cudaGetLastError());
}

// Launch K3c on `stream`; returns cudaGetLastError(), or cudaErrorInvalidValue
// (1) for a field mask without the normal.  As vpt_traverse_wide, plus the
// winner's attributes by slot: e1/e2 [T,3], uv [T,3,2], tangents and normals
// [T,3,3] f32; `mask` (1 normal, 2 uv, 4 tangent, 8 smooth normal) picks the
// outputs, normal/tangent/smooth [n,3] and uv [n,2] f32 (null where not
// picked); `fault` is 0, or a planted fault of the check, with every field
// picked: 1 u and v swapped, 2 the tangent unnormalised, 3 the first
// winner's attributes kept.
extern "C" int vpt_traverse_capture(const void* nodes, const void* rows,
                                    const void* ray_o,
                                    const void* ray_d, const void* t_max, int n,
                                    void* slot, void* t, void* stats, const void* e1,
                                    const void* e2, const void* uv, const void* tan,
                                    const void* nrm, int mask, void* normal_out,
                                    void* uv_out, void* tangent_out, void* smooth_out,
                                    int fault, void* stream) {
  const Attrs a{static_cast<const float*>(e1), static_cast<const float*>(e2),
                static_cast<const float*>(uv), static_cast<const float*>(tan),
                static_cast<const float*>(nrm)};
  const Captured c{static_cast<float*>(normal_out), static_cast<float*>(uv_out),
                   static_cast<float*>(tangent_out), static_cast<float*>(smooth_out)};
  if (n <= 0) return static_cast<int>(cudaGetLastError());
  const auto s = static_cast<cudaStream_t>(stream);
#define VPT_K3C(MASK, FAULT)                                                          \
  traverse_capture_kernel<MASK, FAULT><<<blocks_for(n), kThreads, 0, s>>>(             \
      static_cast<const uint4*>(nodes), static_cast<const float4*>(rows),             \
      static_cast<const float*>(ray_o),                                               \
      static_cast<const float*>(ray_d), static_cast<const float*>(t_max), n,          \
      static_cast<int*>(slot), static_cast<float*>(t),                                \
      static_cast<unsigned long long*>(stats), a, c)
  if (fault != 0) {  // the faults capture every field
    if (mask != 15) return static_cast<int>(cudaErrorInvalidValue);
    switch (fault) {
      case kFaultSwapUv: VPT_K3C(15, kFaultSwapUv); break;
      case kFaultRawTangent: VPT_K3C(15, kFaultRawTangent); break;
      case kFaultStaleAttrs: VPT_K3C(15, kFaultStaleAttrs); break;
      default: return static_cast<int>(cudaErrorInvalidValue);
    }
    return static_cast<int>(cudaGetLastError());
  }
  switch (mask) {  // the normal is always captured (accel/traverse.py capture_fields)
    case 1: VPT_K3C(1, 0); break;
    case 3: VPT_K3C(3, 0); break;
    case 5: VPT_K3C(5, 0); break;
    case 7: VPT_K3C(7, 0); break;
    case 9: VPT_K3C(9, 0); break;
    case 11: VPT_K3C(11, 0); break;
    case 13: VPT_K3C(13, 0); break;
    case 15: VPT_K3C(15, 0); break;
    default: return static_cast<int>(cudaErrorInvalidValue);
  }
#undef VPT_K3C
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
