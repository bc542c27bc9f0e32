// Shared by the two gradient-contraction sources (kgrad.cu, kgrad_sym.cu):
// the cotangent's scalars and the fixed-order sum of the blocks' partials.
#pragma once

#include <cuda_runtime.h>

#include "hyper.cuh"

namespace kgrad_common {

constexpr int REDUCE_THREADS = 256;

// The cotangent's scale g (one float in device memory, or by value when g_p
// is null) and 1 / m.
struct Cotangent {
  const float* g_p;
  float g_v;
  float inv_m;
};

// out[t] = scale_t * sum over slots of partial[t][slot], rounded to fp32 once, at
// the end; the sum in a fixed order:
// block t, thread i sums slots i, i + 256, ... ascending, then a fixed tree.
// scale_0 = gh var (d log_variance), scale_t = -2 gh var (d log_lengthscale),
// gh = g / 2. static: each source that includes this header has its own copy.
static __global__ void __launch_bounds__(REDUCE_THREADS)
kgrad_reduce_kernel(const double* __restrict__ partial, size_t slots, const hyper::Hyper hyp,
                    const Cotangent cot, float* __restrict__ out) {
  __shared__ double buf[REDUCE_THREADS];
  const int t = blockIdx.x;
  double v = 0.0;
  for (size_t i = threadIdx.x; i < slots; i += REDUCE_THREADS) v += partial[(size_t)t * slots + i];
  buf[threadIdx.x] = v;
  __syncthreads();
  for (int half = REDUCE_THREADS / 2; half > 0; half >>= 1) {
    if (threadIdx.x < half) buf[threadIdx.x] += buf[threadIdx.x + half];
    __syncthreads();
  }
  if (threadIdx.x == 0) {
    const double var = hyper::variance(hyp);
    const double gh = 0.5f * (cot.g_p != nullptr ? *cot.g_p : cot.g_v);
    out[t] = (float)((t == 0 ? 1.0 : -2.0) * gh * var * buf[0]);
  }
}

}  // namespace kgrad_common
