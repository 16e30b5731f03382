// Chained-FMA ceiling of the card's FP32 cores, for Hopper (sm_90a).
//
// Replaces the TPU kernel of the JAX package's roofline tool,
// tools/bench_roofline.py::fma_kernel: 8 independent accumulator blocks,
// each element run through FMA_STEPS chained steps y = y * a + b with
// a = 1.000000119f and b = 1.1920929e-07f (the TPU kernel's constants as
// f32). The input of n = 8 * S elements is 8 blocks of S; thread j owns
// element j of every block, so each thread carries 8 independent chains,
// and neighbouring threads read and write neighbouring addresses.
//
// What bounds it: operations. Each element costs 2 * FMA_STEPS flops for 8
// bytes of traffic (one read, one write), 128 flops per byte, far above the
// H100's 20 flops per byte (67 TFLOP/s FP32 over 3.35 TB/s). Eight
// independent chains per thread and full blocks on every SM hide the FMA
// latency, so the rate approaches the FP32 issue rate. The steps are
// explicit fmaf calls (one rounding each), so that nvcc's contraction does
// not decide the rounding; the plain PyTorch version rounds twice per step.
//
// The kernel allocates nothing and does not synchronize. The extern "C"
// entry returns cudaGetLastError() after the launch, or -1 when n is not a
// multiple of 8 * FMA_THREADS.

#include <cuda_runtime.h>

#define FMA_THREADS 256
#define FMA_ACC 8
#define FMA_STEPS 256

namespace {

__global__ void __launch_bounds__(FMA_THREADS)
fma_roof_kernel(const float* __restrict__ x, float* __restrict__ y,
                long long S) {
  const long long j = (long long)blockIdx.x * FMA_THREADS + threadIdx.x;
  if (j >= S) return;
  float v[FMA_ACC];
#pragma unroll
  for (int i = 0; i < FMA_ACC; ++i) v[i] = x[i * S + j];
#pragma unroll
  for (int k = 0; k < FMA_STEPS; ++k) {
#pragma unroll
    for (int i = 0; i < FMA_ACC; ++i) v[i] = fmaf(v[i], 1.000000119f, 1.1920929e-07f);
  }
#pragma unroll
  for (int i = 0; i < FMA_ACC; ++i) y[i * S + j] = v[i];
}

}  // namespace

extern "C" {

int fma_roof_steps() { return FMA_STEPS; }

int fma_roof_f32(const void* x, void* y, long long n, void* stream) {
  if (n < 1 || n % (FMA_ACC * FMA_THREADS) != 0) return -1;
  const long long S = n / FMA_ACC;
  const long long blocks = S / FMA_THREADS;
  fma_roof_kernel<<<(unsigned)blocks, FMA_THREADS, 0, (cudaStream_t)stream>>>(
      (const float*)x, (float*)y, S);
  return (int)cudaGetLastError();
}

}  // extern "C"
