// Fused gradient contraction for Hopper (sm_90a): the exact-GP training
// backward's sum_ij Kbar_ij dK_ij/dtheta without any (N, N) buffer.
//
// The first port of both Pallas bodies of gpras_tpu/ops/pallas_gram.py's
// pallas_kgrad (:701-791), one block per tile:
//   dense (B4)      <- _kgrad_body      (:534-603, call :772)
//   symmetric (B5)  <- _kgrad_sym_body  (:606-698, call :749; sym = 1 here)
// csrc/kgrad_dense.cu and csrc/kgrad_sym.cu replaced them on the training
// path (persistent blocks over strips, kgrad_strips.cuh); both stay here as
// the yardsticks of examples/torch_kgrad_timing.py
// (fused_gram._kgrad_cuda(..., tiles=True)).
//
// With a the inputs divided by the lengthscales (as they are staged),
// u_ij = ||a_i - a_j||^2 and K = var f(u), the cotangent is the rank-(m+1) matrix
//   Kbar = gh [(1/m) W Z^T - alpha alpha^T]          (gh = g / 2)
// built tile by tile, and the outputs are
//   d log_variance     =      sum_ij Kbar_ij var f(u_ij)
//   d log_lengthscale_d = -2 sum_ij Kbar_ij var f'(u_ij) (a_id - a_jd)^2.
// The symmetric body visits upper-triangle tiles only: a diagonal tile takes
// Kbar_ii, a strictly-upper tile the folded Kbar_ij + Kbar_ji^T, so f and f'
// are evaluated once per mirror pair.
//
// What bounds it on an H100: operations. At N = 49,152, m = 16, D = 8 the
// symmetric body visits 1.2e9 entries at ~130 fp32 operations each (the
// folded rank-2m dot, the squared distance and its per-dimension reuse, f
// and f'), ~2.4 ms at 67 TFLOP/s; the inputs are 8 MB and the outputs nine
// numbers. The design keeps every operand of a 64 x 64 tile in shared
// memory (coordinates, W and Z rows of both tile sides, alpha), gives each
// thread 4 x 4 entries in registers, and sums.
//
// Departures from the TPU body, and why:
// - No sequential grid. Pallas carries one (8, 128) accumulator across grid
//   steps; Hopper blocks run in any order. Each block writes its tile's
//   partial sums to its own slot, and a second kernel adds the slots in a
//   fixed order, in float64. No atomics: the result is the same bit for bit
//   from run to run.
// - No sum expansion. The TPU body regroups (a_id - a_jd)^2 into row and
//   column sums plus a bilinear term, which cancels badly in fp32
//   (pallas_gram.py:502-508). Here each entry takes its D differences
//   directly (D FMAs), which needs no regrouping and makes r2 exactly 0 for
//   a point against itself.
// - No bf16_3x split of the W Z^T contraction: plain fp32 FMA.
// - Ragged N is masked (rows past N stage as zeros, so their Kbar is 0), not
//   padded in device memory.
// The noise and jitter diagonal term stays outside, in the caller.
//
// Plain C interface (loaded with ctypes); returns cudaGetLastError().

#include <cuda_runtime.h>
#include <stdint.h>

#include "hyper.cuh"
#include "kgrad_common.cuh"
#include "stationary.cuh"

namespace {

using namespace stationary;
using hyper::Hyper;
using kgrad_common::Cotangent;

constexpr int T = 64;          // tile edge
constexpr int THREADS = 256;   // 16 x 16 threads, 4 x 4 entries each
constexpr int WARPS = THREADS / 32;
constexpr int MAX_D = 128;

// Stage rows [row0, row0 + T) of x (n, k) into dst[k][T], divided by ls[k]
// unless ls is null; rows past n are 0.
__device__ inline void stage(const float* __restrict__ x, int n, int k, int row0, float* dst,
                             const float* ls = nullptr) {
  for (int idx = threadIdx.x; idx < T * k; idx += THREADS) {
    const int r = idx / k, c = idx - r * k, g = row0 + r;
    const float val = g < n ? x[(size_t)g * k + c] : 0.0f;
    dst[c * T + r] = ls != nullptr ? __fdiv_rn(val, ls[c]) : val;
  }
}

__device__ inline double warp_sum(double v) {
#pragma unroll
  for (int off = 16; off > 0; off >>= 1) v += __shfl_xor_sync(0xffffffffu, v, off);
  return v;
}

// Block b = one tile, partial is [1 + d][tiles] with tiles = gridDim.x.
// Dense: all nb x nb tiles, b = ti * nb + tj. Symmetric: the nb (nb + 1) / 2
// upper-triangle tiles only, column by column, b = tj (tj + 1) / 2 + ti.
template <int KERN, bool SYM>
__global__ void __launch_bounds__(THREADS)
kgrad_kernel(const float* __restrict__ a, const float* __restrict__ w,
             const float* __restrict__ z, const float* __restrict__ alpha,
             const Hyper hyp, const float inv_m, double* __restrict__ partial, int n, int d,
             int m) {
  const size_t tiles = gridDim.x, tile = blockIdx.x;
  int ti, tj;
  if (SYM) {
    tj = (int)((sqrt(8.0 * (double)tile + 1.0) - 1.0) * 0.5);
    while ((size_t)tj * (tj + 1) / 2 > tile) --tj;
    while ((size_t)(tj + 1) * (tj + 2) / 2 <= tile) ++tj;
    ti = (int)(tile - (size_t)tj * (tj + 1) / 2);
  } else {
    const int nb = (n + T - 1) / T;
    ti = (int)(tile / nb);
    tj = (int)(tile - (size_t)ti * nb);
  }
  const bool mirror = SYM && tj > ti;
  extern __shared__ float smem[];
  float* as = smem;           // [d][T] row-tile coordinates
  float* bs = as + d * T;     // [d][T] column-tile coordinates
  float* wi = bs + d * T;     // [m][T] W rows of the row tile
  float* zj = wi + m * T;     // [m][T] Z rows of the column tile
  float* zi = zj + m * T;     // [m][T] Z rows of the row tile (mirror only)
  float* wj = zi + m * T;     // [m][T] W rows of the column tile (mirror only)
  float* ai = SYM ? wj + m * T : zi;  // [T] alpha of the row tile
  float* aj = ai + T;         // [T] alpha of the column tile
  float* ls = aj + T;         // [d] lengthscales
  __shared__ double red[WARPS][MAX_D + 1];

  const int row0 = ti * T, col0 = tj * T;
  hyper::stage_lengthscales(hyp, d, ls);
  __syncthreads();
  stage(a, n, d, row0, as, ls);
  stage(a, n, d, col0, bs, ls);
  stage(w, n, m, row0, wi);
  stage(z, n, m, col0, zj);
  if (mirror) {
    stage(z, n, m, row0, zi);
    stage(w, n, m, col0, wj);
  }
  if (threadIdx.x < T) {
    const int g = row0 + threadIdx.x;
    ai[threadIdx.x] = g < n ? alpha[g] : 0.0f;
  } else if (threadIdx.x < 2 * T) {
    const int g = col0 + threadIdx.x - T;
    aj[threadIdx.x - T] = g < n ? alpha[g] : 0.0f;
  }
  __syncthreads();

  const int tx = threadIdx.x & 15, ty = threadIdx.x >> 4;
  // kb = (1/m) (W Z^T [+ Z W^T]) - c alpha alpha^T, the cotangent without gh
  float kb[4][4];
#pragma unroll
  for (int i = 0; i < 4; ++i)
#pragma unroll
    for (int j = 0; j < 4; ++j) kb[i][j] = 0.0f;
  for (int k = 0; k < m; ++k) {
    float ri[4], cj[4];
#pragma unroll
    for (int i = 0; i < 4; ++i) ri[i] = wi[k * T + ty * 4 + i];
#pragma unroll
    for (int j = 0; j < 4; ++j) cj[j] = zj[k * T + tx + 16 * j];
#pragma unroll
    for (int i = 0; i < 4; ++i)
#pragma unroll
      for (int j = 0; j < 4; ++j) kb[i][j] = fmaf(ri[i], cj[j], kb[i][j]);
    if (mirror) {
#pragma unroll
      for (int i = 0; i < 4; ++i) ri[i] = zi[k * T + ty * 4 + i];
#pragma unroll
      for (int j = 0; j < 4; ++j) cj[j] = wj[k * T + tx + 16 * j];
#pragma unroll
      for (int i = 0; i < 4; ++i)
#pragma unroll
        for (int j = 0; j < 4; ++j) kb[i][j] = fmaf(ri[i], cj[j], kb[i][j]);
    }
  }
  const float c = mirror ? 2.0f : 1.0f;
  float r2[4][4];
#pragma unroll
  for (int i = 0; i < 4; ++i)
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      kb[i][j] = inv_m * kb[i][j] - c * ai[ty * 4 + i] * aj[tx + 16 * j];
      r2[i][j] = 0.0f;
    }
  for (int q = 0; q < d; ++q) {
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const float av = as[q * T + ty * 4 + i];
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        const float df = av - bs[q * T + tx + 16 * j];
        r2[i][j] = fmaf(df, df, r2[i][j]);
      }
    }
  }
  // variance term; then kb becomes kb * f'(u), the lengthscale weight
  float gv = 0.0f;
#pragma unroll
  for (int i = 0; i < 4; ++i)
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      float f, fp;
      f_fp<KERN>(r2[i][j], f, fp);
      gv = fmaf(kb[i][j], f, gv);
      kb[i][j] *= fp;
    }
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  double s = warp_sum((double)gv);
  if (lane == 0) red[warp][0] = s;
  for (int q = 0; q < d; ++q) {
    float acc = 0.0f;
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const float av = as[q * T + ty * 4 + i];
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        const float df = av - bs[q * T + tx + 16 * j];
        acc = fmaf(kb[i][j], df * df, acc);
      }
    }
    s = warp_sum((double)acc);
    if (lane == 0) red[warp][1 + q] = s;
  }
  __syncthreads();
  for (int t = threadIdx.x; t <= d; t += THREADS) {
    double v = 0.0;
    for (int q = 0; q < WARPS; ++q) v += red[q][t];
    partial[(size_t)t * tiles + tile] = v;
  }
}

// Tiles a call visits: nb^2 dense, nb (nb + 1) / 2 symmetric.
inline size_t kgrad_tiles(int n, bool sym) {
  const size_t nb = (size_t)((n + T - 1) / T);
  return sym ? nb * (nb + 1) / 2 : nb * nb;
}

template <int KERN, bool SYM>
cudaError_t launch(const float* a, const float* w, const float* z, const float* alpha,
                   const Hyper& hyp, const Cotangent& cot, double* partial, float* out, int n,
                   int d, int m, cudaStream_t st) {
  static size_t granted[hyper::MAX_DEVICES] = {};
  const size_t bytes = ((size_t)(2 * d + (SYM ? 4 : 2) * m) * T + 2 * T + d) * sizeof(float);
  cudaError_t err = hyper::ensure_smem(kgrad_kernel<KERN, SYM>, bytes, granted);
  if (err != cudaSuccess) return err;
  const size_t tiles = kgrad_tiles(n, SYM);
  kgrad_kernel<KERN, SYM><<<(unsigned)tiles, THREADS, bytes, st>>>(a, w, z, alpha, hyp,
                                                                  cot.inv_m, partial, n, d, m);
  err = cudaGetLastError();
  if (err != cudaSuccess) return err;
  kgrad_common::kgrad_reduce_kernel<<<d + 1, kgrad_common::REDUCE_THREADS, 0, st>>>(
      partial, tiles, hyp, cot, out);
  return cudaGetLastError();
}

template <bool SYM>
int dispatch(int kern, const float* a, const float* w, const float* z, const float* alpha,
             const Hyper& hyp, const Cotangent& cot, double* partial, float* out, int n, int d,
             int m, cudaStream_t st) {
#define GPRAS_KGRAD_ARGS a, w, z, alpha, hyp, cot, partial, out, n, d, m, st
  switch (kern) {
    case RBF: return launch<RBF, SYM>(GPRAS_KGRAD_ARGS);
    case MATERN12: return launch<MATERN12, SYM>(GPRAS_KGRAD_ARGS);
    case MATERN32: return launch<MATERN32, SYM>(GPRAS_KGRAD_ARGS);
    case MATERN52: return launch<MATERN52, SYM>(GPRAS_KGRAD_ARGS);
    case EXPONENTIAL: return launch<EXPONENTIAL, SYM>(GPRAS_KGRAD_ARGS);
    default: return (int)cudaErrorInvalidValue;
  }
#undef GPRAS_KGRAD_ARGS
}

}  // namespace

extern "C" {

// out (1 + d) fp32 = [d log_variance, d log_lengthscales...] of
// sum_ij Kbar_ij dK_ij. a (n, d) raw coordinates, w and z (n, m), alpha (n):
// contiguous fp32. log_var, log_ls (d floats ls_stride apart): hyper.cuh's
// Hyper. g: the cotangent's scale, one fp32 in device memory (g_p) or, when
// g_p is null, g_v; inv_m = 1 / m. partial: scratch of (1 + d) * tiles
// doubles, tiles = nb^2 (dense) or nb (nb + 1) / 2 (sym), nb = ceil(n / 64).
// sym selects the tile-per-block symmetric body.
int gpras_kgrad(int kern, const void* a, const void* w, const void* z, const void* alpha,
                const void* log_var, const void* log_ls, int ls_stride, const void* g_p,
                float g_v, float inv_m, void* partial, void* out, int n, int d, int m, int sym,
                void* stream) {
  if (d < 1 || d > MAX_D) return (int)cudaErrorInvalidValue;
  const float* A = static_cast<const float*>(a);
  const float* W = static_cast<const float*>(w);
  const float* Z = static_cast<const float*>(z);
  const float* AL = static_cast<const float*>(alpha);
  const Hyper hyp{static_cast<const float*>(log_var), static_cast<const float*>(log_ls),
                  ls_stride, nullptr, 0.0f};
  const Cotangent cot{static_cast<const float*>(g_p), g_v, inv_m};
  double* P = static_cast<double*>(partial);
  float* O = static_cast<float*>(out);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  return sym ? dispatch<true>(kern, A, W, Z, AL, hyp, cot, P, O, n, d, m, st)
             : dispatch<false>(kern, A, W, Z, AL, hyp, cot, P, O, n, d, m, st);
}

}  // extern "C"
