// Sustained FP32 FMA rate for Hopper (sm_90a): kernel K4 of the port.
//
// Replaces the TPU microbenchmark kernel benchmarks/vpu_peak.py::_make_kernel:
// K = 16 independent chains x <- a - x*x, chain k started at
// a * (0.1 + 0.05 k), run for n_iter steps and summed.  The bench divides
// the sweep's modelled FLOPs by the rate this kernel sustains
// (cbtr_tpu_torch/benchmarks/fma_peak.py, the slope between two loop
// lengths).
//
// What bounds it: the FP32 pipes, by construction.  Every step of every
// chain is one fused multiply-add, written as __fmaf_rn(-x, x, a): the port
// builds every source with -fmad=false (cuda_sweep.NVCC_FLAGS), under which
// a - x*x would compile to a multiply and an add and measure half the rate.
// Sixteen independent chains per thread hide the FMA latency; the operands
// live in registers and the kernel touches memory once per thread.  The map
// x -> a - x*x is not affine, so nothing folds, and the sum is written out,
// so nothing is dead code.
//
// Where the TPU kernel runs one [8, 128] tile (one vector register of one
// core), this kernel fills the card: one input element per thread, the
// wrapper launching a few 256-thread blocks per SM (fma_peak.BLOCKS_PER_SM)
// over all SMs.

#include <cuda_runtime.h>

namespace {

constexpr int K_CHAINS = 16;

__global__ void __launch_bounds__(256)
fma_chains_kernel(const float* __restrict__ a_in, float* __restrict__ out,
                  int n, int n_iter) {
  const int i = blockIdx.x * blockDim.x + threadIdx.x;
  if (i >= n) return;
  const float a = a_in[i];
  float x[K_CHAINS];
#pragma unroll
  for (int k = 0; k < K_CHAINS; ++k) {
    // the start factor rounds from double, as JAX rounds a Python float
    x[k] = a * static_cast<float>(0.1 + 0.05 * k);
  }
#pragma unroll 4
  for (int it = 0; it < n_iter; ++it) {
#pragma unroll
    for (int k = 0; k < K_CHAINS; ++k) x[k] = __fmaf_rn(-x[k], x[k], a);
  }
  float acc = x[0];
#pragma unroll
  for (int k = 1; k < K_CHAINS; ++k) acc = acc + x[k];
  out[i] = acc;
}

}  // namespace

extern "C" int cbtr_fma_peak(const void* a, void* out, int n, int n_iter,
                             void* stream) {
  if (n <= 0) return 0;
  const int threads = 256;
  fma_chains_kernel<<<(n + threads - 1) / threads, threads, 0,
                      static_cast<cudaStream_t>(stream)>>>(
      static_cast<const float*>(a), static_cast<float*>(out), n, n_iter);
  return static_cast<int>(cudaGetLastError());
}

extern "C" const char* cbtr_cuda_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

// the SM clock the card reports (cudaDevAttrClockRate, kHz), or -1
extern "C" int cbtr_sm_clock_khz(int device) {
  int khz = 0;
  if (cudaDeviceGetAttribute(&khz, cudaDevAttrClockRate, device) != cudaSuccess)
    return -1;
  return khz;
}
