// Device code of the BVH searches, shared by K3, K3c and K3b (traverse.cu),
// K4 (mesh.cu) and K5 (paged.cu): the ray with its guarded reciprocal, the
// slab test, the Möller–Trumbore triangle test, the work counters, and the
// whole per-ray closest-hit search over the 8-wide tree (traverse_wide),
// which K3 and K3c run for one ray per thread, K4 at every bounce of its
// path loop and K5 from the root of every page a ray enters.  What bounds
// that search is the work a ray does (node visits, slab and triangle
// tests) and the latency of its dependent loads, not device memory: the
// walk orders children by entry distance and culls what a closer hit has
// put out of reach, and keeps its stack in the thread's local memory
// (traverse_wide).
//
// Numerics: see traverse.cu (no --use_fast_math; the triangle test is left
// to nvcc's FMA contraction).

#pragma once

#include <cuda_runtime.h>
#include <stdint.h>

namespace vpt {

constexpr float kTriEps = 1e-7f;   // accel/traverse.py TRI_EPS
constexpr int kMaxLeaf = 8;        // accel/mesh.py MAX_LEAF
constexpr int kStack = 96;         // accel/mesh.py STACK_DEPTH
constexpr int kWideStack = 256;    // accel/mesh.py WIDE_STACK_DEPTH

struct Ray {
  float o[3], d[3], inv[3];
};

// Work counters of one ray: node visits, box (slab) tests, triangle tests.
struct Work {
  unsigned visits = 0, boxes = 0, tris = 0;
};

// The closest hit of one search: slot -1 and t = t_max on a miss; (u, v)
// are the barycentrics along e1 and e2 of triangle `attr`, the winner
// (another triangle only under K3c's planted stale-attribute fault).
struct Hit {
  int slot, attr;
  float t, u, v;
};

__device__ __forceinline__ float guarded_inv(float d) {
  return 1.0f / (fabsf(d) > 1e-12f ? d : (d >= 0.f ? 1e-12f : -1e-12f));
}

__device__ __forceinline__ Ray make_ray(float ox, float oy, float oz, float dx,
                                        float dy, float dz) {
  Ray r;
  r.o[0] = ox; r.o[1] = oy; r.o[2] = oz;
  r.d[0] = dx; r.d[1] = dy; r.d[2] = dz;
#pragma unroll
  for (int k = 0; k < 3; ++k) r.inv[k] = guarded_inv(r.d[k]);
  return r;
}

__device__ __forceinline__ Ray load_ray(const float* __restrict__ ray_o,
                                        const float* __restrict__ ray_d,
                                        int i) {
  return make_ray(__ldg(ray_o + 3 * i), __ldg(ray_o + 3 * i + 1),
                  __ldg(ray_o + 3 * i + 2), __ldg(ray_d + 3 * i),
                  __ldg(ray_d + 3 * i + 1), __ldg(ray_d + 3 * i + 2));
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

// accel/traverse.py::_moller_trumbore for one triangle; true, the hit
// distance in `t` and the barycentrics (u along e1, v along e2) iff the ray
// hits it at t > TRI_EPS.
__device__ __forceinline__ bool moller_trumbore(const Ray& r, const float v0[3],
                                                const float e1[3], const float e2[3],
                                                float& t, float& u, float& v) {
  const float* d = r.d;
  const float px = d[1] * e2[2] - d[2] * e2[1];
  const float py = d[2] * e2[0] - d[0] * e2[2];
  const float pz = d[0] * e2[1] - d[1] * e2[0];
  const float det = e1[0] * px + e1[1] * py + e1[2] * pz;
  if (!(fabsf(det) > kTriEps)) return false;
  const float inv_det = 1.0f / det;
  const float tx = r.o[0] - v0[0], ty = r.o[1] - v0[1], tz = r.o[2] - v0[2];
  u = (tx * px + ty * py + tz * pz) * inv_det;
  const float qx = ty * e1[2] - tz * e1[1];
  const float qy = tz * e1[0] - tx * e1[2];
  const float qz = tx * e1[1] - ty * e1[0];
  v = (d[0] * qx + d[1] * qy + d[2] * qz) * inv_det;
  t = (e2[0] * qx + e2[1] * qy + e2[2] * qz) * inv_det;
  return u >= 0.f && v >= 0.f && u + v <= 1.f && t > kTriEps;
}

__device__ __forceinline__ void push(int* stack, int& sp, int cap, int node) {
  // accel/mesh.py checks at pack time that a tree never needs more than
  // `cap` entries; the guard keeps a violated bound inside the array.
  if (sp < cap) stack[sp++] = node;
}

// An entry of traverse_wide's stack: a node and the distance at which the
// ray enters its box, rounded down (child_key), so a cull on it never drops
// a node the ray could still reach before its best hit.
struct Entry {
  int node;
  float t;
};

// A hit child's sort key: the bits of max(t_near, 0) with the four low
// mantissa bits replaced by 8 | c.  Non-negative floats order as their bits
// do, so the min (max) of the keys is the nearest (farthest) child, ties by
// index; bit 3 keeps every key non-zero and below ~0, the two sentinels.
__device__ __forceinline__ unsigned child_key(float t_near, int c) {
  return (__float_as_uint(fmaxf(t_near, 0.f)) & ~15u) | 8u | static_cast<unsigned>(c);
}

// The entry distance a key holds, rounded down to its 19 mantissa bits.
__device__ __forceinline__ float key_t(unsigned key) {
  return __uint_as_float(key & ~15u);
}

// The closest hit of ray `r` with t < t_max over the 8-wide BVH below node
// `root`: boxes [N*8, 8] (child c of node w at row w*8+c: lo xyz, hi xyz, 0,
// 0), records [N, 16] (8 x (ref, count); count 0 inner, > 0 leaf rows of
// `pack`, < 0 empty), pack [T8, 16] (v0, e1, e2, slot, uv corners).  The
// layout's per-node sort axes are not read.  A ray with t_max <= 0 (a dead
// lane), or NaN, returns a miss at once.  `w` counts the work.  K3 and K4
// search from root 0; K5 (paged.cu) from the root of each page it enters.
//
// A popped node whose entry distance is at or beyond the best hit so far is
// skipped before its boxes are read.  Otherwise its eight slab tests come
// first; then its hit leaves, nearest first by entry distance, through one
// copy of the triangle test, until the nearest left is entered at or past
// the best hit; then its hit inner children that the ray enters before the
// best hit, pushed far to near with their entry distances, so the nearest
// pops first.  The closest hit is updated on strict t < best, so within a
// leaf the first triangle wins a tie.  kStaleAttrs plants a fault for K3c's
// check (chip_smoke.py): (u, v, attr) keep the first winner's after a
// closer hit.
template <bool kStaleAttrs = false>
__device__ __forceinline__ Hit traverse_wide(const float* __restrict__ boxes,
                                             const int* __restrict__ recs,
                                             const float* __restrict__ pack,
                                             const Ray& r, float t_max, Work& w,
                                             int root = 0) {
  Hit h;
  h.slot = h.attr = -1;
  h.t = t_max;
  h.u = h.v = 0.f;
  if (!(t_max > 0.f)) return h;
  // The stack: kWideStack entries in local memory, the thread's own array.
  // Local memory is interleaved by thread, so a warp's accesses at one depth
  // coalesce; a thread touches only the entries its walk reaches (the nm
  // sphere's tree needs 50), so the array's size costs neither traffic nor
  // occupancy.  Stacks sized to the tree (32 and 64 entries) timed the same
  // as this one, and the same entries in shared memory, laid out
  // [entry][thread], made K3 more than 2x slower on the nm waves (PERF.md
  // §6).
  Entry stack[kWideStack];
  stack[0] = Entry{root, 0.f};
  int sp = 1;
  while (sp > 0) {
    const Entry e = stack[--sp];
    if (e.t >= h.t) continue;  // a closer hit has put the node out of reach
    ++w.visits;
    const float* bx = boxes + 64 * e.node;
    const int2* rec = reinterpret_cast<const int2*>(recs) + 8 * e.node;
    unsigned leaf[8], inner[8];  // keys of the hit children; ~0u and 0 where none
#pragma unroll
    for (int c = 0; c < 8; ++c) {
      leaf[c] = ~0u;
      inner[c] = 0u;
      const int cnt = __ldg(&rec[c].y);
      if (cnt < 0) continue;
      ++w.boxes;
      const float4 a = __ldg(reinterpret_cast<const float4*>(bx + 8 * c));
      const float2 b = __ldg(reinterpret_cast<const float2*>(bx + 8 * c + 4));
      float tn;
      if (slab(r, a.x, a.y, a.z, a.w, b.x, b.y, h.t, tn)) {
        const unsigned key = child_key(tn, c);
        if (cnt == 0) inner[c] = key; else leaf[c] = key;
      }
    }
    // The hit leaves, nearest first, through one copy of the triangle test.
#pragma unroll 1
    while (true) {
      unsigned k = leaf[0];
#pragma unroll
      for (int c = 1; c < 8; ++c) k = min(k, leaf[c]);
      if (k == ~0u || key_t(k) >= h.t) break;  // none left that can be closer
#pragma unroll
      for (int c = 0; c < 8; ++c) leaf[c] = leaf[c] == k ? ~0u : leaf[c];
      const int2 rc = __ldg(rec + (k & 7u));  // (ref, count)
      const int cnt = min(rc.y, kMaxLeaf);
      for (int j = 0; j < cnt; ++j) {
        const float4* row = reinterpret_cast<const float4*>(pack) + 4 * (rc.x + j);
        const float4 p0 = __ldg(row), p1 = __ldg(row + 1), p2 = __ldg(row + 2);
        const float v0[3] = {p0.x, p0.y, p0.z};
        const float e1[3] = {p0.w, p1.x, p1.y};
        const float e2[3] = {p1.z, p1.w, p2.x};
        ++w.tris;
        float t, u, v;
        if (moller_trumbore(r, v0, e1, e2, t, u, v) && t < h.t) {
          h.t = t;
          h.slot = __float2int_rn(p2.y);
          if (!kStaleAttrs || h.attr < 0) {
            h.u = u;
            h.v = v;
            h.attr = h.slot;
          }
        }
      }
    }
    // The inner children, farthest first, so the nearest pops first.
#pragma unroll 1
    while (true) {
      unsigned k = inner[0];
#pragma unroll
      for (int c = 1; c < 8; ++c) k = max(k, inner[c]);
      if (k == 0u) break;
#pragma unroll
      for (int c = 0; c < 8; ++c) inner[c] = inner[c] == k ? 0u : inner[c];
      // accel/mesh.py checks at pack time that the tree's need fits.
      if (key_t(k) < h.t && sp < kWideStack) stack[sp++] = Entry{__ldg(&rec[k & 7u].x), key_t(k)};
    }
  }
  return h;
}

}  // namespace vpt
