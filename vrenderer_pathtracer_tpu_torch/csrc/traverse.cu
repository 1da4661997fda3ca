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
// replaced took ~4.7 MB) or its binary copy ~2 MB (K3b), inside the 50 MB
// L2, and a ray reads 28 bytes and writes 8; every node visit costs 8 (K3)
// or 2 (K3b) slab tests and every leaf up to 8 triangle tests, per ray,
// with neighbouring rays on different paths through the tree.  So the work
// a ray does, and the loads each step waits for, are what to cut, and the
// design:
//   * one thread per ray, all state in registers but the stack, which is in
//     local memory (K3b: 96 entries of 8 bytes, accel/mesh.py STACK_DEPTH;
//     K3: 256 entries of 8 bytes, >= 7 * depth + 1 for every tree
//     pack_from_bvh accepts; a thread touches only the entries its walk
//     reaches);
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
//     unpadded.  K3b reads the binary copy (accel/binary.py::compress_binary):
//     a node is one aligned 64-byte block (its float boxes, the children's
//     links and counts), a triangle a 48-byte row of three float4;
//   * both walk near to far by slab entry distance and skip a popped entry
//     that a closer hit has put out of reach without reading it.  K3 tests a
//     node's hit leaves nearest first until the nearest left starts past the
//     best hit, and pushes its inner children far to near with their entry
//     distances (traverse.cuh traverse_wide).  K3b keeps the nearer hit child
//     in a register and stacks the farther with its entry distance, and runs
//     in persistent warps that fetch rays in batches and refill idle lanes
//     (traverse_binary_kernel below);
//   * the closest hit is updated on strict t < best, so within a leaf the
//     first triangle wins a tie.  K3 slab-tests a node's eight children
//     first, then its hit leaves through one copy of the triangle test;
//   * a ray with t_max <= 0 (the integrator's dead lanes) is a miss at once:
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

// K3b's ingredients, bits of VPT_K3B_INGREDIENTS (the kernel's comment
// says what each does), and its fetch's constants: a warp refills its lanes
// when fewer than kRefillBelow of them walk a ray (kRefillShared where its
// rays share one origin) and takes kBatch rays a fetch.  The defaults are
// what ships, chosen by k3b_cuts.py's turns on the nm waves (PERF.md); that
// script builds each other choice with -D into a library of its own.
constexpr unsigned kFetch = 1, kCull = 2, kRows = 4;
#ifndef VPT_K3B_INGREDIENTS
#define VPT_K3B_INGREDIENTS 7u
#endif
#ifndef VPT_K3B_REFILL_BELOW
#define VPT_K3B_REFILL_BELOW 32
#endif
#ifndef VPT_K3B_REFILL_SHARED
#define VPT_K3B_REFILL_SHARED 1
#endif
#ifndef VPT_K3B_BATCH
#define VPT_K3B_BATCH 32
#endif

constexpr unsigned kK3b = VPT_K3B_INGREDIENTS;
constexpr int kRefillBelow = VPT_K3B_REFILL_BELOW, kRefillShared = VPT_K3B_REFILL_SHARED;
constexpr int kBatch = VPT_K3B_BATCH;
static_assert(kK3b <= (kFetch | kCull | kRows), "K3b's ingredients are 3 bits");
static_assert(kRefillBelow >= 1 && kRefillBelow <= 32 && kRefillShared >= 1 &&
              kRefillShared <= 32, "a refill threshold counts 1..32 lanes");
static_assert(kBatch >= 32, "a fetch takes a warp's worth of rays at least");
// K3b's planted faults (the check build, -DVPT_CHECK_INSTANCES): a pop
// culls at half the best hit's distance; the fetch drops the batch that
// holds ray `fault_ray` (its rays return misses, untraced).
constexpr int kBinSound = 0, kBinHalfCull = 1, kBinDropBatch = 2;

// A walk's node register: an inner node id (>= 0), a leaf link (< 0, see
// accel/binary.py), or kDone once the stack is spent.
constexpr int kDone = 0x7fffffff;
// The fetch counters: the wave is cut into kRanges equal ranges, each with
// its own counter on a 128-byte line of its own (kCounterStride words
// apart), so that the warps' atomics spread over kRanges lines of L2 and
// do not queue on one; one more line holds the count of warps done.  The
// last warp done zeroes them all, so every launch leaves the workspace as
// it found it, zeroed, with no memset on the stream (a memset and the gap
// before the kernel cost the sparsest wave more than the turns' spread).
constexpr int kRanges = 16, kCounterStride = 32;
constexpr int kCounterWords = (kRanges + 1) * kCounterStride;
constexpr int kDoneWord = kRanges * kCounterStride;
constexpr unsigned kFullWarp = 0xffffffffu;

// A K3b stack entry: a far child's link and the key of the distance at
// which the ray enters its box (child_key: rounded down, so a cull on it
// never drops a child the ray could still reach before its best hit).
struct BinEntry {
  int link;
  unsigned key;
};

struct BinaryArgs {
  const int4* nodes;      // [M, 4] int4: the copy's 64-byte nodes
  const float4* rows;     // [T, 3] float4: the copy's triangle rows
  const float *v0, *e1, *e2;  // [T, 3]: the JAX-parity arrays (a build without kRows)
  const float *ray_o, *ray_d, *t_max;
  int n;
  int* slot_out;
  float* t_out;
  unsigned long long* stats;
  int* counters;          // [kCounterWords] the fetch counters, zero at entry and exit
  int fault_ray;          // kBinDropBatch's ray
};

// Pop the next entry that a closer hit has not put out of reach (kCull),
// without reading its node; kDone once the stack is spent.
template <int kFault>
__device__ __forceinline__ int pop_live(const BinEntry* stack, int& sp, float best) {
  while (sp > 0) {
    const BinEntry e = stack[--sp];
    if (kFault == kBinHalfCull) {
      if (vpt::key_t(e.key) < 0.5f * best) return e.link;
    } else if (!(kK3b & kCull) || vpt::key_t(e.key) < best) {
      return e.link;
    }
  }
  return kDone;
}

// K3b: the binary SBVH's copy (accel/binary.py), one ray per thread in
// persistent warps (kFetch): a grid of the blocks the card holds at once,
// whose warps take batches of kBatch consecutive rays from the launch's
// counters and hand them to their idle lanes whenever fewer lanes than the
// refill threshold walk a ray (after Aila and Laine's dynamic fetch), so a
// lane whose ray ends early does not idle until its warp's longest ray is
// done.  Without kFetch each warp takes its own 32 rays once, over a grid
// of the whole wave.  A fetched ray with t_max <= 0 (or NaN) is written as
// a miss at once and never takes a lane of the walk.
//
// The walk (after Aila and Laine, HPG 2009): the inner loop visits inner
// nodes (four 16-byte loads, the slab test of each non-empty child),
// descends into the nearer hit child in the node register and stacks only
// the farther one with its entry key, until the register holds a leaf or
// the walk is over; the leaf loop then tests the leaf's triangles (kRows:
// three 16-byte loads a triangle from the 48-byte rows; else 27 scalar
// loads from the [T,3] arrays) and those of any leaf popped after it.
// Between the two loops the warp may refill its idle lanes.  A popped entry
// whose key is at or past the best hit is dropped unread (kCull).  The
// closest hit is updated on strict t < best, so within a leaf the first
// triangle wins a tie.
//
// The stack: descending keeps one child in the register and stacks at most
// the other, one level below the node just visited, and a pop takes the
// top.  So the entries, bottom to top, lie on strictly deeper levels, each
// no deeper than the register's node: a walk never holds more entries than
// the tree has levels below the root, which accel/mesh.py bounds by
// STACK_DEPTH (kStack) at pack time (the guard below keeps a violated
// bound inside the array).
template <int kFault>
__global__ void __launch_bounds__(kThreads)
traverse_binary_kernel(const BinaryArgs a) {
  const unsigned lane = threadIdx.x & 31u;
  const unsigned below = (1u << lane) - 1u;
  Work w;
  Ray r;
  float best = 0.f;
  int best_slot = -1, ray = 0, node = kDone, sp = 0;
  bool live = false;
  BinEntry stack[kStack];
  // The warp's state, the same on all its lanes.  [next, end) are its
  // rays not yet handed out; `drained` says the counters (or, without
  // kFetch, its own rays) are spent.  It starts on counter range (its
  // index mod kRanges) and moves to the next when that one runs past its
  // end; `empty` counts the ranges found spent.  `shared`: the rays it
  // last took all start at one point (a pinhole camera's primary rays),
  // which walk the tree alike and finish close together, so it refills
  // them only below kRefillShared lanes and keeps its lanes on one
  // stretch of the image; others refill below kRefillBelow.  `sparse`:
  // fewer than one in eight of the rays its last refill handed out were
  // live, so it refills only once every lane is done, and its few walks
  // are not held up by rounds of skimming, which warps with no walk do.
  const int warp_id = static_cast<int>((blockIdx.x * blockDim.x + threadIdx.x) >> 5);
  // Each warp's first 32 rays are its own, [32 w, 32 w + 32), so that its
  // first walks need no fetch; the counters hand out the rays past the
  // grid's first rays, [n0, n).
  const int n0 = (kK3b & kFetch) ? min(a.n, static_cast<int>(gridDim.x * blockDim.x)) : 0;
  int next = warp_id * 32, end = (kK3b & kFetch) ? min(next + 32, n0) : 0;
  int range = warp_id % kRanges, empty = 0;
  bool drained = false, shared = false, sparse = false;
  bool dropping = kFault == kBinDropBatch && next <= a.fault_ray && a.fault_ray < end;
  while (true) {
    unsigned idle = __ballot_sync(kFullWarp, !live);
    // Refill: hand out the warp's rays to its idle lanes (fetching batches
    // as they run out), a round of up to 32 at a time, until every lane
    // walks one, none is left, or (in a refill that has found fewer than
    // one live ray in eight) a round gives none while some lane walks.
    // Dead rays are written as misses here, so a sparse stretch of a wave
    // is skimmed in this loop, by the warps that have no walk.
    const int below_lanes = sparse ? 1 : shared ? kRefillShared : kRefillBelow;
    if (32 - __popc(idle) < below_lanes) {
      const unsigned idle_before = idle;
      int handed = 0;
      while (idle != 0) {
        if (next >= end) {
          if (drained) break;
          if (kK3b & kFetch) {
            while (true) {
              const int lo = n0 + static_cast<int>(static_cast<long long>(a.n - n0) * range / kRanges);
              const int hi = n0 + static_cast<int>(static_cast<long long>(a.n - n0) * (range + 1) / kRanges);
              int base = 0;
              if (lane == 0) base = atomicAdd(a.counters + range * kCounterStride, kBatch);
              base = lo + __shfl_sync(kFullWarp, base, 0);
              if (base < hi) {
                next = base;
                end = min(base + kBatch, hi);
                break;
              }
              if (++empty == kRanges) {
                drained = true;
                break;
              }
              range = (range + 1) % kRanges;
            }
            if (drained) break;
          } else {
            next = warp_id * 32;
            end = min(next + 32, a.n);
            drained = true;
          }
          dropping = kFault == kBinDropBatch && next <= a.fault_ray && a.fault_ray < end;
        }
        const int i = next + __popc(idle & below);
        if (!live && i < end) {
          const float tmax = __ldg(a.t_max + i);
          if (tmax > 0.f && !dropping) {
            r = load_ray(a.ray_o, a.ray_d, i);
            best = tmax;
            best_slot = -1;
            ray = i;
            node = 0;
            live = true;
          } else {  // a dead lane (t_max <= 0, or NaN) is a miss at once
            a.slot_out[i] = -1;
            a.t_out[i] = tmax;
          }
        }
        handed += min(__popc(idle), end - next);
        next = min(next + __popc(idle), end);
        const unsigned was_idle = idle;
        idle = __ballot_sync(kFullWarp, !live);
        // A round of dead rays in a sparse refill while some lane walks:
        // leave the skimming to the warps that have no walk, and walk.
        if (idle == was_idle && idle != kFullWarp &&
            8 * __popc(idle_before & ~idle) < handed) {
          break;
        }
      }
      sparse = 8 * __popc(idle_before & ~idle) < handed;
      // Whether every live lane's ray starts where the first live lane's
      // does, bit for bit.
      const int src = __ffs(~idle) - 1;
      if (src >= 0) {
        const float ox = __shfl_sync(kFullWarp, r.o[0], src);
        const float oy = __shfl_sync(kFullWarp, r.o[1], src);
        const float oz = __shfl_sync(kFullWarp, r.o[2], src);
        shared = __all_sync(kFullWarp, !live || (r.o[0] == ox && r.o[1] == oy && r.o[2] == oz));
      }
    }
    if (idle == kFullWarp) break;  // no lane walks, and no ray is left
    if (!live) continue;
    // Inner nodes, until the register holds a leaf or the walk is over.
    while (static_cast<unsigned>(node) < static_cast<unsigned>(kDone)) {
      ++w.visits;
      const int4* nd = a.nodes + 4 * node;
      const float4 f0 = __ldg(reinterpret_cast<const float4*>(nd));
      const float4 f1 = __ldg(reinterpret_cast<const float4*>(nd) + 1);
      const float4 f2 = __ldg(reinterpret_cast<const float4*>(nd) + 2);
      const int4 l = __ldg(nd + 3);  // link0, link1, count0, count1
      bool h0 = false, h1 = false;
      float t0 = 0.f, t1 = 0.f;
      if (l.z >= 0) {
        ++w.boxes;
        h0 = slab(r, f0.x, f0.y, f0.z, f0.w, f1.x, f1.y, best, t0);
      }
      if (l.w >= 0) {
        ++w.boxes;
        h1 = slab(r, f1.z, f1.w, f2.x, f2.y, f2.z, f2.w, best, t1);
      }
      if (h0 && h1) {  // the nearer in the register, the farther stacked
        const bool near0 = t0 <= t1;
        node = near0 ? l.x : l.y;
        if (sp < kStack) stack[sp++] = BinEntry{near0 ? l.y : l.x, vpt::child_key(near0 ? t1 : t0, 0)};
      } else if (h0 || h1) {
        node = h0 ? l.x : l.y;
      } else {
        node = pop_live<kFault>(stack, sp, best);
      }
    }
    // The leaf in the register, then any leaf popped after it.
    while (node < 0) {
      const int bits = ~node;
      const int first = bits >> 3, count = (bits & 7) + 1;
#pragma unroll 1
      for (int s = first; s < first + count; ++s) {
        float v0[3], e1[3], e2[3];
        if (kK3b & kRows) {
          const float4* row = a.rows + 3 * s;
          const float4 p0 = __ldg(row), p1 = __ldg(row + 1), p2 = __ldg(row + 2);
          v0[0] = p0.x; v0[1] = p0.y; v0[2] = p0.z;
          e1[0] = p1.x; e1[1] = p1.y; e1[2] = p1.z;
          e2[0] = p2.x; e2[1] = p2.y; e2[2] = p2.z;
        } else {
#pragma unroll
          for (int k = 0; k < 3; ++k) {
            v0[k] = __ldg(a.v0 + 3 * s + k);
            e1[k] = __ldg(a.e1 + 3 * s + k);
            e2[k] = __ldg(a.e2 + 3 * s + k);
          }
        }
        ++w.tris;
        float t, u, v;
        if (moller_trumbore(r, v0, e1, e2, t, u, v) && t < best) {
          best = t;
          best_slot = s;
        }
      }
      node = pop_live<kFault>(stack, sp, best);
    }
    if (node == kDone) {  // the walk is over
      a.slot_out[ray] = best_slot;
      a.t_out[ray] = best;
      live = false;
    }
  }
  add_work(a.stats, w);
  if ((kK3b & kFetch) && lane == 0) {
    // Every other warp has made its last fetch once the last one counts
    // itself done: it zeroes the counters for the next launch.
    const unsigned warps = gridDim.x * blockDim.x / 32;
    if (atomicAdd(reinterpret_cast<unsigned*>(a.counters + kDoneWord), 1u) == warps - 1) {
      for (int k = 0; k < kRanges; ++k) atomicExch(a.counters + k * kCounterStride, 0);
      atomicExch(a.counters + kDoneWord, 0);
    }
  }
}

#ifdef VPT_CHECK_INSTANCES
// The parent K3b, kept for the turns and checks of chip_smoke.py (the
// check build's vpt_traverse_binary_check runs it; no other code does): one
// thread a ray over the whole wave, both children slab-tested and a hit
// leaf resolved at once, inner children pushed far then near, no cull.
// nodes_f [M, 12] (lo0, hi0, lo1, hi1), nodes_i [M, 4] (c0, n0, c1, n1),
// v0/e1/e2 [T, 3].
__global__ void __launch_bounds__(kThreads)
traverse_binary_parent(const float* __restrict__ nodes_f,
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
#endif

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

namespace {

// Blocks of K3b instance `kernel` that the current card holds at once: the
// persistent grid, asked of the runtime once per instance and card (the
// query costs the host more than a sparse wave's launch takes).
template <typename Kernel>
int resident_blocks(Kernel kernel) {
  constexpr int kCards = 64;
  static int cached[kCards] = {};
  int dev = 0;
  cudaGetDevice(&dev);
  if (dev >= 0 && dev < kCards && cached[dev] > 0) return cached[dev];
  int sms = 0, per_sm = 0;
  cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, kernel, kThreads, 0);
  const int blocks = sms * (per_sm > 0 ? per_sm : 1);
  if (dev >= 0 && dev < kCards) cached[dev] = blocks;
  return blocks;
}

template <int kFault>
int launch_binary(const BinaryArgs& a, cudaStream_t s) {
  auto* kernel = traverse_binary_kernel<kFault>;
  int blocks = blocks_for(a.n);
  if (kK3b & kFetch) {
    const int resident = resident_blocks(kernel);
    blocks = blocks < resident ? blocks : resident;
  }
  kernel<<<blocks, kThreads, 0, s>>>(a);
  return static_cast<int>(cudaGetLastError());
}

BinaryArgs binary_args(const void* nodes, const void* rows, const void* ray_o,
                       const void* ray_d, const void* t_max, int n, void* slot,
                       void* t, void* stats, void* counters) {
  BinaryArgs a{};
  a.nodes = static_cast<const int4*>(nodes);
  a.rows = static_cast<const float4*>(rows);
  a.ray_o = static_cast<const float*>(ray_o);
  a.ray_d = static_cast<const float*>(ray_d);
  a.t_max = static_cast<const float*>(t_max);
  a.n = n;
  a.slot_out = static_cast<int*>(slot);
  a.t_out = static_cast<float*>(t);
  a.stats = static_cast<unsigned long long*>(stats);
  a.counters = static_cast<int*>(counters);
  a.fault_ray = -1;
  return a;
}

}  // namespace

// Launch K3b on `stream`; returns cudaGetLastError(), or
// cudaErrorInvalidValue (1) for a workspace other than 544 words (or in a
// build without kRows, which reads the [T,3] arrays: only the check entry
// passes them).  nodes [M,16] i32 and rows [T,12] f32 are the binary copy
// (accel/binary.py); rays, outputs and `stats` as for vpt_traverse_wide;
// `counters` is `n_counters` int32 of device memory, zero, that the launch
// counts in and leaves zero (16 counters and a count of warps done, 128
// bytes apart; a workspace is for one stream at a time).
extern "C" int vpt_traverse_binary(const void* nodes, const void* rows,
                                   const void* ray_o, const void* ray_d,
                                   const void* t_max, int n, void* slot,
                                   void* t, void* stats, void* counters,
                                   int n_counters, void* stream) {
  if (n_counters != kCounterWords || !(kK3b & kRows)) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  if (n <= 0) return static_cast<int>(cudaGetLastError());
  return launch_binary<kBinSound>(
      binary_args(nodes, rows, ray_o, ray_d, t_max, n, slot, t, stats, counters),
      static_cast<cudaStream_t>(stream));
}

// K3b's ingredient mask in this build (kK3b: 1 persistent fetch, 2 cull on
// pop, 4 48-byte rows).
extern "C" int vpt_traverse_binary_ingredients() { return static_cast<int>(kK3b); }

#ifdef VPT_CHECK_INSTANCES
// The check build's K3b (chip_smoke.py, k3b_cuts.py, the card tests):
// `variant` -1 runs the parent kernel on nodes_f [M,12], nodes_i [M,4] and
// v0/e1/e2 [T,3]; 0 this build's K3b (without kRows it reads v0/e1/e2); 1
// and 2 its planted faults (1: a pop culls at half the best distance; 2:
// the batch holding ray `fault_ray` is dropped).  Other values, or another
// workspace: cudaErrorInvalidValue.
extern "C" int vpt_traverse_binary_check(
    const void* nodes, const void* rows, const void* nodes_f,
    const void* nodes_i, const void* v0, const void* e1, const void* e2,
    const void* ray_o, const void* ray_d, const void* t_max, int n,
    void* slot, void* t, void* stats, void* counters, int n_counters,
    int variant, int fault_ray, void* stream) {
  if (n_counters != kCounterWords) return static_cast<int>(cudaErrorInvalidValue);
  if (n <= 0) return static_cast<int>(cudaGetLastError());
  const auto s = static_cast<cudaStream_t>(stream);
  if (variant == -1) {
    traverse_binary_parent<<<blocks_for(n), kThreads, 0, s>>>(
        static_cast<const float*>(nodes_f), static_cast<const int*>(nodes_i),
        static_cast<const float*>(v0), static_cast<const float*>(e1),
        static_cast<const float*>(e2), static_cast<const float*>(ray_o),
        static_cast<const float*>(ray_d), static_cast<const float*>(t_max), n,
        static_cast<int*>(slot), static_cast<float*>(t),
        static_cast<unsigned long long*>(stats));
    return static_cast<int>(cudaGetLastError());
  }
  BinaryArgs a = binary_args(nodes, rows, ray_o, ray_d, t_max, n, slot, t,
                             stats, counters);
  a.v0 = static_cast<const float*>(v0);
  a.e1 = static_cast<const float*>(e1);
  a.e2 = static_cast<const float*>(e2);
  a.fault_ray = fault_ray;
  switch (variant) {
    case kBinSound: return launch_binary<kBinSound>(a, s);
    case kBinHalfCull: return launch_binary<kBinHalfCull>(a, s);
    case kBinDropBatch: return launch_binary<kBinDropBatch>(a, s);
    default: return static_cast<int>(cudaErrorInvalidValue);
  }
}
#endif
