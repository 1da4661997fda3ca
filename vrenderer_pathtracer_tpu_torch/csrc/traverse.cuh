// Device code of the BVH searches, shared by K3, K3c and K3b (traverse.cu),
// K4 (mesh.cu) and K5 (paged.cu): the ray with its guarded reciprocal, the
// slab test, the Möller–Trumbore triangle test, the work counters, and the
// whole per-ray closest-hit search over the 8-wide tree (traverse_wide),
// which K3 and K3c run for one ray per thread, K4 at every bounce of its
// path loop and K5 over the whole paged tree.  What bounds that search is
// the work a ray does (node visits, slab and triangle tests) and the
// latency of its dependent loads, not device memory: the walk reads the
// tree's compressed copy (accel/wide.py::compress_wide: an 80-byte node as
// five 16-byte loads, a 48-byte leaf row as three), orders children by
// entry distance and culls what a closer hit has put out of reach, and
// keeps its stack in the thread's local memory (traverse_wide).
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

// Work counters of one ray: node visits, box (slab) tests, triangle tests,
// and (K5) the page roots the walk enters.
struct Work {
  unsigned visits = 0, boxes = 0, tris = 0, pages = 0;
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

// The compressed copy (accel/wide.py, the layout in full there): a node is
// five uint4, a leaf row three float4.
constexpr int kNodeVecs = 5;
constexpr int kRowVecs = 3;

// Byte c (0..7) of an eight-byte group held in two words, as the float
// 2^15 + q: 0x47000000 | q << 8 is that float exactly, so one byte permute
// replaces an int-to-float conversion (a quarter-rate op).  The plane test
// takes the 2^15 back in its per-node offset (traverse_wide).
template <int c>
__device__ __forceinline__ float q_biased(unsigned lo, unsigned hi) {
  const unsigned w = c < 4 ? lo : hi;
  return __uint_as_float(__byte_perm(w, 0x47000000u, 0x7504u | ((c & 3) << 4)));
}

// Byte c of the meta words, c known only at run time.
__device__ __forceinline__ unsigned meta_of(uint4 b, unsigned c) {
  return ((c < 4 ? b.z : b.w) >> (8u * (c & 3u))) & 0xffu;
}

// The walk's planted faults, template arguments, so the kernels' own
// instances (kWalkSound) hold none of them.  kWalkStaleAttrs is K3c's check
// (chip_smoke.py): (u, v, attr) keep the first winner's after a closer hit.
// K5's (csrc/paged.cu): kWalkSkipFirstPage skips the first page root the
// walk would enter; kWalkNextEntryGate gates each page root on the entry
// distance of the next entry on the stack with `>` (+inf when none is
// left), in place of its own with `>=`.
enum WalkFault { kWalkSound = 0, kWalkStaleAttrs, kWalkSkipFirstPage, kWalkNextEntryGate };

// The closest hit of ray `r` with t < t_max over the compressed 8-wide tree
// `nodes` (root 0) with leaf rows `rows`.  A ray with t_max <= 0 (a dead
// lane), or NaN, returns a miss at once.  `w` counts the work; with kPages
// (K5) a node in [page_lo, page_hi), a page root, counts as a page entered.
//
// A popped node whose entry distance is at or beyond the best hit so far is
// skipped before its node is read.  Otherwise its five 16-byte loads come
// first, then the per-node decode (the quantum times the reciprocal, the
// origin's distance less 2^15 quanta, the near and far planes picked by the
// ray's signs), then eight decoded slab tests, a byte permute and one fused
// multiply-add a plane: t = (2^15 + q) * s / d + ((p - o) / d - 2^15 s / d).
// The offset is rounded on the scale of ulp(|p - o| / |d|): for a node
// within about 2^15 quanta of the ray's origin that is at most 1/512 of a
// quantum of t, inside the copy's margin of 1/128 quantum (accel/wide.py);
// for a small node far from the origin it can pass the margin, and the
// test then errs by the float slab test's order, which rounds (p - o) / d
// too.  Then its hit leaves, nearest first
// by entry distance, through one copy of the triangle test, until the
// nearest left is entered at or past the best hit; then its hit inner
// children that the ray enters before the best hit, pushed far to near
// with their entry distances, so the nearest pops first.  The closest hit
// is updated on strict t < best, so within a leaf the first triangle wins
// a tie.
template <int kFault = kWalkSound, bool kPages = false>
__device__ __forceinline__ Hit traverse_wide(const uint4* __restrict__ nodes,
                                             const float4* __restrict__ rows,
                                             const Ray& r, float t_max, Work& w,
                                             int page_lo = 0, int page_hi = 0) {
  Hit h;
  h.slot = h.attr = -1;
  h.t = t_max;
  h.u = h.v = 0.f;
  if (!(t_max > 0.f)) return h;
  const bool neg_x = r.inv[0] < 0.f, neg_y = r.inv[1] < 0.f, neg_z = r.inv[2] < 0.f;
  // The stack: kWideStack entries in local memory, the thread's own array.
  // Local memory is interleaved by thread, so a warp's accesses at one depth
  // coalesce; a thread touches only the entries its walk reaches (the nm
  // sphere's tree needs 50), so the array's size costs neither traffic nor
  // occupancy.  Stacks sized to the tree (32 and 64 entries) timed the same
  // as this one, and the same entries in shared memory, laid out
  // [entry][thread], made K3 more than 2x slower on the nm waves (PERF.md
  // §6).
  Entry stack[kWideStack];
  stack[0] = Entry{0, 0.f};
  int sp = 1;
  bool skipped = false;
  while (sp > 0) {
    const Entry e = stack[--sp];
    if (kPages && e.node >= page_lo && e.node < page_hi) {
      if (kFault == kWalkNextEntryGate) {
        if ((sp > 0 ? stack[sp - 1].t : __int_as_float(0x7f800000)) > h.t) continue;
      } else if (e.t >= h.t) {
        continue;
      }
      if (kFault == kWalkSkipFirstPage && !skipped) {
        skipped = true;
        continue;
      }
      ++w.pages;
    } else if (e.t >= h.t) {
      continue;  // a closer hit has put the node out of reach
    }
    ++w.visits;
    const uint4* nd = nodes + kNodeVecs * e.node;
    const uint4 a = __ldg(nd), b = __ldg(nd + 1);
    const uint4 q0 = __ldg(nd + 2), q1 = __ldg(nd + 3), q2 = __ldg(nd + 4);
    // a: origin x, y, z and (E_x, E_y, E_z, imask); b: child base, row base,
    // meta[0..3], meta[4..7]; q0: lo x, lo y; q1: lo z, hi x; q2: hi y, hi z.
    const float sx = __uint_as_float((a.w & 0xffu) << 23) * r.inv[0];
    const float sy = __uint_as_float(((a.w >> 8) & 0xffu) << 23) * r.inv[1];
    const float sz = __uint_as_float(((a.w >> 16) & 0xffu) << 23) * r.inv[2];
    const float ox = fmaf(-32768.f, sx, (__uint_as_float(a.x) - r.o[0]) * r.inv[0]);
    const float oy = fmaf(-32768.f, sy, (__uint_as_float(a.y) - r.o[1]) * r.inv[1]);
    const float oz = fmaf(-32768.f, sz, (__uint_as_float(a.z) - r.o[2]) * r.inv[2]);
    // The near plane of an axis is its lo where the ray's direction is
    // positive, its hi where negative.
    const unsigned nx0 = neg_x ? q1.z : q0.x, nx1 = neg_x ? q1.w : q0.y;
    const unsigned fx0 = neg_x ? q0.x : q1.z, fx1 = neg_x ? q0.y : q1.w;
    const unsigned ny0 = neg_y ? q2.x : q0.z, ny1 = neg_y ? q2.y : q0.w;
    const unsigned fy0 = neg_y ? q0.z : q2.x, fy1 = neg_y ? q0.w : q2.y;
    const unsigned nz0 = neg_z ? q2.z : q1.x, nz1 = neg_z ? q2.w : q1.y;
    const unsigned fz0 = neg_z ? q1.x : q2.z, fz1 = neg_z ? q1.y : q2.w;
    const unsigned imask = a.w >> 24;
    unsigned leaf[8], inner[8];  // keys of the hit children; ~0u and 0 where none
#define VPT_CHILD(c)                                                            \
    {                                                                           \
      leaf[c] = ~0u;                                                            \
      inner[c] = 0u;                                                            \
      if ((c < 4 ? b.z : b.w) >> (8 * (c & 3)) & 0xffu) {                      \
        ++w.boxes;                                                              \
        const float tn = fmaxf(fmaxf(fmaf(q_biased<c>(nx0, nx1), sx, ox),        \
                                     fmaf(q_biased<c>(ny0, ny1), sy, oy)),       \
                               fmaxf(fmaf(q_biased<c>(nz0, nz1), sz, oz), 0.f)); \
        const float tf = fminf(fminf(fmaf(q_biased<c>(fx0, fx1), sx, ox),        \
                                     fmaf(q_biased<c>(fy0, fy1), sy, oy)),       \
                               fminf(fmaf(q_biased<c>(fz0, fz1), sz, oz), h.t)); \
        if (tn <= tf) {                                                         \
          const unsigned key = child_key(tn, c);                                \
          if (imask & (1u << c)) inner[c] = key; else leaf[c] = key;            \
        }                                                                       \
      }                                                                         \
    }
    VPT_CHILD(0) VPT_CHILD(1) VPT_CHILD(2) VPT_CHILD(3)
    VPT_CHILD(4) VPT_CHILD(5) VPT_CHILD(6) VPT_CHILD(7)
#undef VPT_CHILD
    // The hit leaves, nearest first, through one copy of the triangle test.
#pragma unroll 1
    while (true) {
      unsigned k = leaf[0];
#pragma unroll
      for (int c = 1; c < 8; ++c) k = min(k, leaf[c]);
      if (k == ~0u || key_t(k) >= h.t) break;  // none left that can be closer
#pragma unroll
      for (int c = 0; c < 8; ++c) leaf[c] = leaf[c] == k ? ~0u : leaf[c];
      // The leaf's rows, unpadded, until the one marked last.
      const float4* row = rows + kRowVecs * (b.y + (meta_of(b, k & 7u) & 63u));
#pragma unroll 1
      for (int j = 0; j < kMaxLeaf; ++j, row += kRowVecs) {
        const float4 p0 = __ldg(row), p1 = __ldg(row + 1), p2 = __ldg(row + 2);
        const float v0[3] = {p0.x, p0.y, p0.z};
        const float e1[3] = {p0.w, p1.x, p1.y};
        const float e2[3] = {p1.z, p1.w, p2.x};
        ++w.tris;
        float t, u, v;
        if (moller_trumbore(r, v0, e1, e2, t, u, v) && t < h.t) {
          h.t = t;
          h.slot = __float_as_int(p2.y);
          if (kFault != kWalkStaleAttrs || h.attr < 0) {
            h.u = u;
            h.v = v;
            h.attr = h.slot;
          }
        }
        if (__float_as_int(p2.z) != 0) break;
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
      if (key_t(k) < h.t && sp < kWideStack) {
        stack[sp++] = Entry{static_cast<int>(b.x + (meta_of(b, k & 7u) & 7u)), key_t(k)};
      }
    }
  }
  return h;
}

}  // namespace vpt
