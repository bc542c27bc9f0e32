// Fused stationary Gram kernel for Hopper (sm_90a).
//
// Replaces the Pallas Gram body of gpras_tpu/ops/pallas_gram.py:
//   gram  <- _tile_body / _tile_value  (:77 / :35-74, launcher pallas_gram :268-311)
// It writes K(a, b) from lengthscale-pre-scaled coordinates, with noise on the
// global diagonal when the matrix is square (the training Gram K + sigma2 I).
//
// What bounds it on an H100: the output. At N = 49,152 (the Hutchinson
// training forward) it stores 49,152^2 fp32 = 9.66 GB, 2.9 ms at 3.35 TB/s,
// against ~6.8e10 fp32 operations (an 8-wide dot and the covariance tail per
// entry), 1.0 ms at 67 TFLOP/s; the inputs are 1.6 MB. So the design is about
// stores: a block computes a 64 x 128 tile whose coordinates sit in shared
// memory, each thread holds 8 rows x 4 columns of it in registers, and the
// four columns of a thread are 32 apart, so each warp store instruction
// writes 32 consecutive floats (one 128-byte line) of one row. Stores are
// streaming (__stcs): the output is far larger than the 50 MB L2 and is read
// next by the Cholesky factorization, not by this kernel. Ragged edges are
// masked, not padded. The grid walks column tiles fastest, so neighbouring
// blocks fill neighbouring stretches of the same rows.
//
// Numerics follow _tile_value: r2 = max(a2 + b2 - 2 ab, 0) with the dot and
// the norms accumulated by the same fp32 FMA chain as kmv.cu's build_tile,
// so a point against itself gives r2 == 0 exactly; the five tails come from
// stationary.cuh; noise is added where global row == global column.
//
// Plain C interface (loaded with ctypes); returns cudaGetLastError().

#include <cuda_runtime.h>
#include <stdint.h>

#include "stationary.cuh"

namespace {

using namespace stationary;

constexpr int TM = 64;        // tile rows
constexpr int TN = 128;       // tile columns
constexpr int THREADS = 256;  // 8 warps; warp w owns rows w + 8 i, lane l columns l + 32 j
constexpr int RI = TM / 8;    // rows per thread
constexpr int CJ = TN / 32;   // columns per thread

template <int KERN>
__global__ void __launch_bounds__(THREADS)
gram_kernel(const float* __restrict__ a, const float* __restrict__ b,
            float* __restrict__ out, const float* __restrict__ var_p,
            const float* __restrict__ noise_p, int n1, int n2, int d, int square) {
  extern __shared__ float smem[];
  float* as = smem;          // [d][TM] row-tile coordinates, transposed
  float* bs = as + d * TM;   // [d][TN] column-tile coordinates, transposed
  float* a2 = bs + d * TN;   // [TM] squared norms
  float* b2 = a2 + TM;       // [TN]
  const int row0 = blockIdx.y * TM, col0 = blockIdx.x * TN;
  const float var = *var_p, noise = *noise_p;

  for (int idx = threadIdx.x; idx < TM * d; idx += THREADS) {
    const int r = idx / d, c = idx - r * d, g = row0 + r;
    as[c * TM + r] = g < n1 ? a[(size_t)g * d + c] : 0.0f;
  }
  for (int idx = threadIdx.x; idx < TN * d; idx += THREADS) {
    const int r = idx / d, c = idx - r * d, g = col0 + r;
    bs[c * TN + r] = g < n2 ? b[(size_t)g * d + c] : 0.0f;
  }
  __syncthreads();
  if (threadIdx.x < TM) {
    float acc = 0.0f;
    for (int c = 0; c < d; ++c) acc = fmaf(as[c * TM + threadIdx.x], as[c * TM + threadIdx.x], acc);
    a2[threadIdx.x] = acc;
  } else if (threadIdx.x < TM + TN) {
    const int r = threadIdx.x - TM;
    float acc = 0.0f;
    for (int c = 0; c < d; ++c) acc = fmaf(bs[c * TN + r], bs[c * TN + r], acc);
    b2[r] = acc;
  }
  __syncthreads();

  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  float dot[RI][CJ];
#pragma unroll
  for (int i = 0; i < RI; ++i)
#pragma unroll
    for (int j = 0; j < CJ; ++j) dot[i][j] = 0.0f;
  for (int c = 0; c < d; ++c) {
    float bv[CJ];
#pragma unroll
    for (int j = 0; j < CJ; ++j) bv[j] = bs[c * TN + lane + 32 * j];
#pragma unroll
    for (int i = 0; i < RI; ++i) {
      const float av = as[c * TM + warp + 8 * i];
#pragma unroll
      for (int j = 0; j < CJ; ++j) dot[i][j] = fmaf(av, bv[j], dot[i][j]);
    }
  }
#pragma unroll
  for (int i = 0; i < RI; ++i) {
    const int r = warp + 8 * i, gr = row0 + r;
    if (gr >= n1) continue;
    const float am = a2[r];
    float* orow = out + (size_t)gr * n2;
#pragma unroll
    for (int j = 0; j < CJ; ++j) {
      const int c = lane + 32 * j, gc = col0 + c;
      if (gc >= n2) continue;
      const float r2 = fmaxf(am + b2[c] - 2.0f * dot[i][j], 0.0f);
      float kv = covariance<KERN>(r2, var);
      if (square && gr == gc) kv += noise;
      __stcs(orow + gc, kv);
    }
  }
}

template <int KERN>
cudaError_t launch(const float* a, const float* b, float* out, const float* var,
                   const float* noise, int n1, int n2, int d, int square, cudaStream_t st) {
  const size_t bytes = ((size_t)d * (TM + TN) + TM + TN) * sizeof(float);
  cudaError_t err = cudaFuncSetAttribute(gram_kernel<KERN>,
                                         cudaFuncAttributeMaxDynamicSharedMemorySize, (int)bytes);
  if (err != cudaSuccess) return err;
  const dim3 grid((n2 + TN - 1) / TN, (n1 + TM - 1) / TM);
  gram_kernel<KERN><<<grid, THREADS, bytes, st>>>(a, b, out, var, noise, n1, n2, d, square);
  return cudaGetLastError();
}

}  // namespace

extern "C" {

// out (n1, n2) = K(a, b) [+ noise on the diagonal when square]. a (n1, d) and
// b (n2, d): contiguous fp32, lengthscale-pre-scaled (b == a when square).
// var, noise: one fp32 each, in device memory.
int gpras_gram(int kern, const void* a, const void* b, void* out, const void* var,
               const void* noise, int n1, int n2, int d, int square, void* stream) {
  const float* A = static_cast<const float*>(a);
  const float* B = static_cast<const float*>(b);
  float* O = static_cast<float*>(out);
  const float* VAR = static_cast<const float*>(var);
  const float* NZ = static_cast<const float*>(noise);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  switch (kern) {
    case RBF: return launch<RBF>(A, B, O, VAR, NZ, n1, n2, d, square, st);
    case MATERN12: return launch<MATERN12>(A, B, O, VAR, NZ, n1, n2, d, square, st);
    case MATERN32: return launch<MATERN32>(A, B, O, VAR, NZ, n1, n2, d, square, st);
    case MATERN52: return launch<MATERN52>(A, B, O, VAR, NZ, n1, n2, d, square, st);
    case EXPONENTIAL: return launch<EXPONENTIAL>(A, B, O, VAR, NZ, n1, n2, d, square, st);
    default: return (int)cudaErrorInvalidValue;
  }
}

}  // extern "C"
