// K6: the elementwise-rate probe, hand-written CUDA C++ for Hopper (sm_90a).
//
// Replaces .bench/bf16_vpu.py's Pallas kernel (make_kernel.<kernel>), which
// asks whether bf16 elementwise math runs at twice the float32 rate: a
// 512-step dependent chain v = v * c + a over every element.  Each step is
// one fmaf on a float32 element or one __hfma2 on a packed pair of bf16
// elements (__nv_bfloat162), rounded once.  The chain is dependent, so its
// rate is bound by instruction issue (and each instruction's latency), not
// by memory: 4 or 2 bytes read and written per element against 512 FMAs.
// The plain PyTorch version is kernels/probe.py::chain_reference.
//
// The design: each thread runs K independent chains, interleaved step by
// step, so that K FMAs with no dependence between them issue back to back:
// K float32 elements (a float, float2, float4 or two float4) or K packed
// bf16 pairs (4, 8, 16 or 32 bytes), loaded and stored as one vector.  The
// grid walks the vectors with a grid-stride loop; it is either one wave of
// the blocks the card holds at once (`grid` 0) or a block for every 256
// vectors, one vector a thread, that the block scheduler hands out as
// blocks finish (`grid` 1).  The elements past the last whole vector (the
// ragged tail) each take one thread of a scalar chain (a pair, or one
// float32 element).  K is a template argument (1, 2, 4 or 8);
// kernels/probe.py ships the fastest K and grid for each dtype, chosen by
// chip_smoke.py's sweep.
//
// Planted fault (chip_smoke.py, argument `fault`, 0 in use): 1 skips the
// chain and writes the input back, the kernel that the check must catch.

#include <cuda_bf16.h>
#include <cuda_runtime.h>

namespace {

constexpr int kThreads = 256;
constexpr int kChainSteps = 512;  // kernels/probe.py N_OPS

__device__ __forceinline__ float step(float v, float c, float a) { return fmaf(v, c, a); }

template <typename U>
__device__ __forceinline__ U to_unit(float x);
template <>
__device__ __forceinline__ float to_unit<float>(float x) { return x; }
template <>
__device__ __forceinline__ __nv_bfloat162 to_unit<__nv_bfloat162>(float x) {
  return __float2bfloat162_rn(x);
}

__device__ __forceinline__ __nv_bfloat162 step(__nv_bfloat162 v, __nv_bfloat162 c,
                                               __nv_bfloat162 a) {
  return __hfma2(v, c, a);
}

// K units (float or __nv_bfloat162) moved as one aligned vector.
template <typename U, int K>
struct alignas(sizeof(U) * K) Pack {
  U v[K];
};

// The chain on every unit of x (n units): K-unit vectors, then the tail.
template <typename U, int K, int kSteps>
__global__ void __launch_bounds__(kThreads)
chain_kernel(const U* __restrict__ x, U* __restrict__ y, int n, float cf, float af) {
  const U c = to_unit<U>(cf), a = to_unit<U>(af);
  const int n_vec = n / K;
  const int stride = gridDim.x * blockDim.x;
  const int tid = blockIdx.x * blockDim.x + threadIdx.x;
  const auto* xv = reinterpret_cast<const Pack<U, K>*>(x);
  auto* yv = reinterpret_cast<Pack<U, K>*>(y);
  for (int i = tid; i < n_vec; i += stride) {
    Pack<U, K> p = xv[i];
    // About 128 FMAs a loop body whatever K: the loop's own instructions
    // stay a few percent of the issue.
#pragma unroll (128 / K)
    for (int s = 0; s < kSteps; ++s) {
#pragma unroll
      for (int j = 0; j < K; ++j) p.v[j] = step(p.v[j], c, a);
    }
    yv[i] = p;
  }
  const int tail = n_vec * K + tid;
  if (tail < n) {
    U v = x[tail];
#pragma unroll 128
    for (int s = 0; s < kSteps; ++s) v = step(v, c, a);
    y[tail] = v;
  }
}

template <typename U, int K, int kSteps>
cudaError_t launch(const void* x, void* y, int n, float c, float a, bool wave,
                   cudaStream_t s) {
  auto* kernel = chain_kernel<U, K, kSteps>;
  // A block for every kThreads vectors, at least one (every thread of the
  // grid also takes at most one tail unit: n % K < K); with `wave`, no more
  // than one wave of the blocks the card holds at once.
  const int want = (n / K + kThreads - 1) / kThreads;
  int blocks = want > 0 ? want : 1;
  if (wave) {
    int dev = 0, sms = 0, per_sm = 0;
    cudaGetDevice(&dev);
    cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
    cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, kernel, kThreads, 0);
    const int resident = sms * (per_sm > 0 ? per_sm : 1);
    blocks = blocks < resident ? blocks : resident;
  }
  kernel<<<blocks, kThreads, 0, s>>>(static_cast<const U*>(x), static_cast<U*>(y), n, c, a);
  return cudaGetLastError();
}

template <typename U>
cudaError_t launch_k(int k, bool noop, const void* x, void* y, int n, float c,
                     float a, bool wave, cudaStream_t s) {
  if (noop) return launch<U, 1, 0>(x, y, n, c, a, wave, s);
  switch (k) {
    case 1: return launch<U, 1, kChainSteps>(x, y, n, c, a, wave, s);
    case 2: return launch<U, 2, kChainSteps>(x, y, n, c, a, wave, s);
    case 4: return launch<U, 4, kChainSteps>(x, y, n, c, a, wave, s);
    case 8: return launch<U, 8, kChainSteps>(x, y, n, c, a, wave, s);
    default: return cudaErrorInvalidValue;
  }
}

}  // namespace

// Launch the float32 chain (bf16 = 0: n float32 elements) or the packed
// bf16 chain (bf16 = 1: n bf16 elements, n even) on `stream`, `k` chains a
// thread (1, 2, 4 or 8) over the `grid` (0 one wave, 1 one vector a
// thread); returns cudaGetLastError(), or cudaErrorInvalidValue (1) for
// another k or grid or an odd bf16 count.  x and y are device pointers,
// 16-byte aligned; `fault` is 0 in use.
extern "C" int vpt_probe_chain(const void* x, void* y, int n, float c, float a,
                               int bf16, int k, int grid, int fault, void* stream) {
  if (k != 1 && k != 2 && k != 4 && k != 8) return static_cast<int>(cudaErrorInvalidValue);
  if (grid != 0 && grid != 1) return static_cast<int>(cudaErrorInvalidValue);
  if (bf16 && n % 2) return static_cast<int>(cudaErrorInvalidValue);
  const int units = bf16 ? n / 2 : n;
  if (units <= 0) return static_cast<int>(cudaGetLastError());
  const auto s = static_cast<cudaStream_t>(stream);
  const bool noop = fault == 1;
  const bool wave = grid == 0;
  const cudaError_t err =
      bf16 ? launch_k<__nv_bfloat162>(k, noop, x, y, units, c, a, wave, s)
           : launch_k<float>(k, noop, x, y, units, c, a, wave, s);
  return static_cast<int>(err);
}
