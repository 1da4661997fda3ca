// K7: one bounce's Threefry draws for the torch wavefront, hand-written CUDA
// C++ for Hopper (sm_90a).
//
// Replaces no TPU kernel.  The JAX package's Threefry stream
// (vrenderer_pathtracer_tpu/core/rng.py) is jnp ops that XLA fused into the
// bounce's other work.  The port's plain version, core/rng.py::uniform2 over
// make_stream, holds each uint32 word in an int64 tensor and masks it after
// every add and rotate: 186 full-width PyTorch kernels a draw, each reading
// and writing 8-byte lanes.  K7 computes the same cipher on native uint32 in
// registers (common.cuh::draw, which K1, K2 and K4 run), for every slot of
// one bounce in one launch, bit for bit the int64 path's words.  The wrapper
// is core/rng.py::bounce_uniforms.
//
// Work a lane: pix and samp read (16 B), 2 * n_slots float32 words written
// (8 * n_slots B), and a 20-round Threefry block a slot.  In its sm_90a
// SASS (cuobjdump) the slot loop is 87 instructions: 53 on the INT32 pipe
// (20 funnel-shift rotates, 21 LOP3 xors, 8 IADD3 adds and to_unit's
// shifts among them), 27 IMAD adds and moves on the FMA pipe, two
// conversions, two scales, two stores and a branch; the lane's loads and
// key words add 30 (chip_smoke.py's K7_SLOT_OPS and K7_LANE_OPS).  At
// config 5's widest (1920x1080 at 8 spp, 16.6M lanes, 2 slots) that is
// 0.53 GB, 0.16 ms at 3.35 TB/s, and 2.1G INT32-pipe operations, 0.12 ms
// at that pipe's rate: bytes bound it, at ~0.16 ms a bounce (0.20 ms at 3
// slots).
//
// The design: one thread a lane over a grid-stride loop, no shared memory.
// Each thread reads its lane's ids once and draws every slot from registers;
// out is [2 * n_slots, n], one row a word, so each store of a warp is one
// coalesced 128-byte line.  frame comes as a value or, for a CUDA 0-dim
// tensor, as its device pointer (read by every thread; no host sync).

#include "common.cuh"

namespace {

constexpr int kThreads = 256;
constexpr int kMaxBlocks = 1 << 20;

__global__ void __launch_bounds__(kThreads)
bounce_draws_kernel(const int64_t* __restrict__ pix,
                    const int64_t* __restrict__ samp, int64_t n,
                    uint32_t seed_lo, uint32_t seed_hi, uint32_t frame,
                    const int64_t* __restrict__ frame_ptr, uint32_t bounce,
                    int n_slots, float* __restrict__ out) {
  const uint32_t f = frame_ptr ? static_cast<uint32_t>(*frame_ptr) : frame;
  const int64_t stride = static_cast<int64_t>(gridDim.x) * blockDim.x;
  for (int64_t i = static_cast<int64_t>(blockIdx.x) * blockDim.x + threadIdx.x;
       i < n; i += stride) {
    // The low 32 bits, as core/rng.py::_u32 takes them.
    const uint32_t p = static_cast<uint32_t>(pix[i]);
    const uint32_t s = static_cast<uint32_t>(samp[i]);
    for (int slot = 0; slot < n_slots; ++slot) {
      float a, b;
      vpt::draw(seed_lo, seed_hi, p, f, s, bounce, slot, a, b);
      out[(2 * slot) * n + i] = a;
      out[(2 * slot + 1) * n + i] = b;
    }
  }
}

}  // namespace

// Draw `n_slots` (2 or 3) slots of bounce `bounce` for n lanes on `stream`:
// pix and samp are device int64 [n], out a device float32 [2 * n_slots, n];
// frame_ptr, when not null, is a device int64 scalar read in place of
// `frame`.  Returns cudaGetLastError(), or cudaErrorInvalidValue (1) for
// another slot count or a negative n; n = 0 launches nothing.
extern "C" int vpt_bounce_draws(const void* pix, const void* samp, long long n,
                                unsigned seed_lo, unsigned seed_hi,
                                unsigned frame, const void* frame_ptr,
                                unsigned bounce, int n_slots, void* out,
                                void* stream) {
  if (n_slots < 2 || n_slots > 3 || n < 0)
    return static_cast<int>(cudaErrorInvalidValue);
  if (n == 0) return static_cast<int>(cudaGetLastError());
  const long long need = (n + kThreads - 1) / kThreads;
  const int blocks = static_cast<int>(need < kMaxBlocks ? need : kMaxBlocks);
  bounce_draws_kernel<<<blocks, kThreads, 0, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const int64_t*>(pix), static_cast<const int64_t*>(samp), n,
      seed_lo, seed_hi, frame, static_cast<const int64_t*>(frame_ptr), bounce,
      n_slots, static_cast<float*>(out));
  return static_cast<int>(cudaGetLastError());
}
