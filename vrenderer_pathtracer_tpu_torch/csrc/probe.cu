// K6: the elementwise-rate probe, hand-written CUDA C++ for Hopper (sm_90a).
//
// Replaces .bench/bf16_vpu.py's Pallas kernel (make_kernel.<kernel>), which
// asks whether bf16 elementwise math runs at twice the float32 rate: a
// 512-step dependent chain v = v * c + a over every element.  Here one
// thread runs the chain for one float32 element (fmaf) or for one packed
// pair of bf16 elements (__hfma2 on __nv_bfloat162), so the two kernels move
// the same bytes and do the same number of instructions per thread.  The
// chain is dependent, so the rate is bound by instruction issue, not by
// memory (4 or 2 bytes read and written per element against 512 FMAs).
// The plain PyTorch version is kernels/probe.py::chain_reference.
//
// Planted fault (chip_smoke.py, argument `fault`, 0 in use): 1 skips the
// chain and writes the input back, the kernel that the check must catch.

#include <cuda_bf16.h>
#include <cuda_runtime.h>

namespace {

constexpr int kThreads = 256;
constexpr int kChainSteps = 512;  // kernels/probe.py N_OPS

template <int kSteps>
__global__ void __launch_bounds__(kThreads)
chain_f32(const float* __restrict__ x, float* __restrict__ y, int n, float c, float a) {
  const int i = blockIdx.x * blockDim.x + threadIdx.x;
  if (i >= n) return;
  float v = x[i];
#pragma unroll 16
  for (int k = 0; k < kSteps; ++k) v = fmaf(v, c, a);
  y[i] = v;
}

template <int kSteps>
__global__ void __launch_bounds__(kThreads)
chain_bf16x2(const __nv_bfloat162* __restrict__ x, __nv_bfloat162* __restrict__ y,
             int n2, float c, float a) {
  const int i = blockIdx.x * blockDim.x + threadIdx.x;
  if (i >= n2) return;
  const __nv_bfloat162 c2 = __float2bfloat162_rn(c), a2 = __float2bfloat162_rn(a);
  __nv_bfloat162 v = x[i];
#pragma unroll 16
  for (int k = 0; k < kSteps; ++k) v = __hfma2(v, c2, a2);
  y[i] = v;
}

}  // namespace

// Launch the float32 chain (bf16 = 0: n float32 elements) or the packed
// bf16 chain (bf16 = 1: n bf16 elements, n even) on `stream`; returns
// cudaGetLastError().  x and y are device pointers; `fault` is 0 in use.
extern "C" int vpt_probe_chain(const void* x, void* y, int n, float c, float a,
                               int bf16, int fault, void* stream) {
  const int m = bf16 ? n / 2 : n;
  if (m > 0) {
    const int blocks = (m + kThreads - 1) / kThreads;
    cudaStream_t s = static_cast<cudaStream_t>(stream);
    const auto* x2 = static_cast<const __nv_bfloat162*>(x);
    auto* y2 = static_cast<__nv_bfloat162*>(y);
    const auto* xf = static_cast<const float*>(x);
    auto* yf = static_cast<float*>(y);
    if (bf16 && fault == 1) {
      chain_bf16x2<0><<<blocks, kThreads, 0, s>>>(x2, y2, m, c, a);
    } else if (bf16) {
      chain_bf16x2<kChainSteps><<<blocks, kThreads, 0, s>>>(x2, y2, m, c, a);
    } else if (fault == 1) {
      chain_f32<0><<<blocks, kThreads, 0, s>>>(xf, yf, m, c, a);
    } else {
      chain_f32<kChainSteps><<<blocks, kThreads, 0, s>>>(xf, yf, m, c, a);
    }
  }
  return static_cast<int>(cudaGetLastError());
}
