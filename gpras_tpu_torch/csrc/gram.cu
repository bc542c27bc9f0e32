// Fused stationary Gram kernel for Hopper (sm_90a).
//
// Replaces the Pallas Gram body of gpras_tpu/ops/pallas_gram.py:
//   gram  <- _tile_body / _tile_value  (:77 / :35-74, launcher pallas_gram :268-311)
// It writes K(a, b) from raw coordinates, with noise on the global diagonal
// when the matrix is square (the training Gram K + sigma2 I). A prep grid
// first divides the coordinates by the lengthscales (hyper.cuh) into scratch:
// dividing where the tiles stage them cost the 49,152^2 Gram 0.9 ms of 6.0
// on an H100 80GB HBM3 at 700 W (each block would divide its 192 points
// again), the prep grid a few microseconds.
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

#include "hyper.cuh"
#include "stationary.cuh"

namespace {

using namespace stationary;
using hyper::Hyper;

constexpr int TM = 64;        // tile rows
constexpr int TN = 128;       // tile columns
constexpr int THREADS = 256;  // 8 warps; warp w owns rows w + 8 i, lane l columns l + 32 j
constexpr int RI = TM / 8;    // rows per thread
constexpr int CJ = TN / 32;   // columns per thread

// out[e] = x[e] / lengthscale(column of e), x (n, d) row-major.
__global__ void gram_scale_kernel(const float* __restrict__ x, float* __restrict__ out,
                                  const Hyper hyp, size_t count, int d) {
  for (size_t e = blockIdx.x * (size_t)blockDim.x + threadIdx.x; e < count;
       e += (size_t)gridDim.x * blockDim.x)
    out[e] = __fdiv_rn(x[e], hyper::lengthscale(hyp, (int)(e % d)));
}

// a, b: coordinates already divided by the lengthscales.
template <int KERN>
__global__ void __launch_bounds__(THREADS)
gram_kernel(const float* __restrict__ a, const float* __restrict__ b,
            float* __restrict__ out, const Hyper hyp, int n1, int n2, int d, int square) {
  extern __shared__ float smem[];
  float* as = smem;          // [d][TM] row-tile coordinates, transposed
  float* bs = as + d * TM;   // [d][TN] column-tile coordinates, transposed
  float* a2 = bs + d * TN;   // [TM] squared norms
  float* b2 = a2 + TM;       // [TN]
  const int row0 = blockIdx.y * TM, col0 = blockIdx.x * TN;
  const float var = hyper::variance(hyp), noise = hyper::noise(hyp);

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

inline int scale_blocks(size_t count) {
  const size_t blocks = (count + THREADS - 1) / THREADS;
  return (int)(blocks < 2048 ? (blocks > 0 ? blocks : 1) : 2048);
}

template <int KERN>
cudaError_t launch(const float* a, const float* b, float* out, float* scaled, const Hyper& hyp,
                   int n1, int n2, int d, int square, cudaStream_t st) {
  static size_t granted[hyper::MAX_DEVICES] = {};
  const size_t bytes = ((size_t)d * (TM + TN) + TM + TN) * sizeof(float);
  cudaError_t err = hyper::ensure_smem(gram_kernel<KERN>, bytes, granted);
  if (err != cudaSuccess) return err;
  // scaled holds a / ls, then (cross only) b / ls
  const size_t count_a = (size_t)n1 * d, count_b = square ? 0 : (size_t)n2 * d;
  float* const sa = scaled;
  float* const sb = square ? scaled : scaled + count_a;
  gram_scale_kernel<<<scale_blocks(count_a), THREADS, 0, st>>>(a, sa, hyp, count_a, d);
  if (!square) gram_scale_kernel<<<scale_blocks(count_b), THREADS, 0, st>>>(b, sb, hyp, count_b, d);
  err = cudaGetLastError();
  if (err != cudaSuccess) return err;
  const dim3 grid((n2 + TN - 1) / TN, (n1 + TM - 1) / TM);
  gram_kernel<KERN><<<grid, THREADS, bytes, st>>>(sa, sb, out, hyp, n1, n2, d, square);
  return cudaGetLastError();
}

}  // namespace

extern "C" {

// out (n1, n2) = K(a, b) [+ noise on the diagonal when square]. a (n1, d) and
// b (n2, d): contiguous fp32, raw coordinates (b == a when square).
// scaled: scratch of n1 * d floats, plus n2 * d when not square.
// log_var, log_ls (d floats ls_stride apart), noise: hyper.cuh's Hyper.
int gpras_gram(int kern, const void* a, const void* b, void* out, void* scaled, const void* log_var,
               const void* log_ls, int ls_stride, const void* noise_p, float noise_v, int n1,
               int n2, int d, int square, void* stream) {
  const float* A = static_cast<const float*>(a);
  const float* B = static_cast<const float*>(b);
  float* O = static_cast<float*>(out);
  float* S = static_cast<float*>(scaled);
  const Hyper hyp{static_cast<const float*>(log_var), static_cast<const float*>(log_ls),
                  ls_stride, static_cast<const float*>(noise_p), noise_v};
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  switch (kern) {
    case RBF: return launch<RBF>(A, B, O, S, hyp, n1, n2, d, square, st);
    case MATERN12: return launch<MATERN12>(A, B, O, S, hyp, n1, n2, d, square, st);
    case MATERN32: return launch<MATERN32>(A, B, O, S, hyp, n1, n2, d, square, st);
    case MATERN52: return launch<MATERN52>(A, B, O, S, hyp, n1, n2, d, square, st);
    case EXPONENTIAL: return launch<EXPONENTIAL>(A, B, O, S, hyp, n1, n2, d, square, st);
    default: return (int)cudaErrorInvalidValue;
  }
}

}  // extern "C"
