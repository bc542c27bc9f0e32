// The strip sweep of the gradient contraction, shared by B5 (kgrad_sym.cu)
// and B4 (kgrad_dense.cu): sum_ij Kbar_ij dK_ij/dtheta over 64 x 64 tiles of
// packed operands, walked by persistent blocks (kgrad_sym.cu's header note
// says what bounds it on an H100 and how the design answers it).
//
// - kgrad_pack_kernel lays each 64-point tile's coordinates (divided by the
//   lengthscales), W, Z and alpha out field by field, zeros past N and D.
// - kgrad_strips_kernel: a block stages its row strip once and streams its
//   column tiles through a cp.async ring; each thread keeps 4 x 8 entries and
//   nine float64 running sums in registers; one partial per block. The walk
//   is the upper triangle by strip pairs, with the folded cotangent
//   Kbar_ij + Kbar_ji^T on a tile j > i.
// - kgrad_common::kgrad_reduce_kernel adds the partials in a fixed order.
// - Inputs wider than STAGED_DIM = 128 dimensions (hyper.cuh; WIDE): a staged
//   tile holds the first 128 coordinate fields, then W, Z and alpha; the
//   squared distance goes on over the packed tiles' remaining coordinates in
//   device memory (through the L1 cache), and a block's eight lengthscale
//   dimensions are read from wherever they lie.
#pragma once

#include <cuda_runtime.h>
#include <stdint.h>

#include "hyper.cuh"
#include "kgrad_common.cuh"
#include "stationary.cuh"

namespace kgrad_strips {
namespace {  // each source that includes this header has its own copy

using namespace stationary;
using hyper::Hyper;
using kgrad_common::Cotangent;

constexpr int T = 64;         // tile edge
// 16 x 8 threads: thread (ty, tx) owns rows 4 ty .. 4 ty + 3 and columns
// 4 tx .. 4 tx + 3 and 32 + 4 tx .. 32 + 4 tx + 3
constexpr int THREADS = 128;
constexpr int WARPS = THREADS / 32;
constexpr int SUMS = 9;       // the variance term and eight lengthscale terms
constexpr size_t MAX_SMEM = 227 * 1024;

__device__ __forceinline__ void cp16(float* smem, const float* gmem) {
  const uint32_t s = static_cast<uint32_t>(__cvta_generic_to_shared(smem));
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n" ::"r"(s), "l"(gmem));
}

__device__ __forceinline__ void cp_commit() { asm volatile("cp.async.commit_group;\n" ::); }

// all but the newest `pending` groups of this thread's copies have landed
__device__ __forceinline__ void cp_wait(int pending) {
  if (pending >= 2) asm volatile("cp.async.wait_group 2;\n" ::: "memory");
  else if (pending == 1) asm volatile("cp.async.wait_group 1;\n" ::: "memory");
  else asm volatile("cp.async.wait_group 0;\n" ::: "memory");
}

__device__ __forceinline__ void ld4(float (&dst)[4], const float* p) {
  const float4 q = *reinterpret_cast<const float4*>(p);
  dst[0] = q.x; dst[1] = q.y; dst[2] = q.z; dst[3] = q.w;
}

// a thread's eight columns of one field of the column tile
__device__ __forceinline__ void ld_cols(float (&dst)[8], const float* field, int tx) {
  const float4 a = *reinterpret_cast<const float4*>(field + 4 * tx);
  const float4 b = *reinterpret_cast<const float4*>(field + 32 + 4 * tx);
  dst[0] = a.x; dst[1] = a.y; dst[2] = a.z; dst[3] = a.w;
  dst[4] = b.x; dst[5] = b.y; dst[6] = b.z; dst[7] = b.w;
}

// pack[tile][field][64]: fields 0 .. dp - 1 the coordinates divided by the
// lengthscales (zeros from d on), then m of W, m of Z, then alpha; zeros for
// points past n.
__global__ void kgrad_pack_kernel(const float* __restrict__ x, const float* __restrict__ w,
                                  const float* __restrict__ z, const float* __restrict__ alpha,
                                  float* __restrict__ pack, const Hyper hyp, int n, int d, int dp,
                                  int m, size_t count) {
  const int fields = dp + 2 * m + 1;
  for (size_t e = blockIdx.x * (size_t)blockDim.x + threadIdx.x; e < count;
       e += (size_t)gridDim.x * blockDim.x) {
    const int r = (int)(e % T);
    const size_t tf = e / T;
    const int f = (int)(tf % fields);
    const size_t g = tf / fields * T + r;
    float val = 0.0f;
    if (g < (size_t)n) {
      if (f < dp) {
        if (f < d) val = __fdiv_rn(x[g * d + f], hyper::lengthscale(hyp, f));
      } else if (f < dp + m) {
        val = w[g * m + (f - dp)];
      } else if (f < dp + 2 * m) {
        val = z[g * m + (f - dp - m)];
      } else {
        val = alpha[g];
      }
    }
    pack[e] = val;
  }
}

// One 64 x 64 tile: rows from R, columns from C (staged tiles in shared
// memory: sdp coordinate fields, then W, Z and alpha), the thread's 4 x 8
// entries; adds the tile's sums to `sum` (float64): sum[0] the variance term,
// sum[1 + k] the lengthscale term of dimension q0 + k. WIDE (sdp < d): the
// coordinates sdp .. d - 1 come from GR and GC, the packed tiles in device
// memory.
template <int KERN, bool WIDE>
__device__ __forceinline__ void tile_sums(const float* R, const float* C, const float* GR,
                                          const float* GC, bool mirror, int d, int sdp, int m,
                                          int q0, float inv_m, int ty, int tx,
                                          double (&sum)[SUMS]) {
  const float* const rw = R + (size_t)sdp * T + 4 * ty;  // row side: W fields, then Z
  const float* const cw = C + (size_t)sdp * T;           // column side: Z fields first, then W
  float kb[4][8];
#pragma unroll
  for (int i = 0; i < 4; ++i)
#pragma unroll
    for (int j = 0; j < 8; ++j) kb[i][j] = 0.0f;
  // kb = [W_i | Z_i] . [Z_j | W_j] (the second halves on a mirror tile only)
  const int depth = mirror ? 2 * m : m;
#pragma unroll 4
  for (int k = 0; k < depth; ++k) {
    float ri[4], cj[8];
    ld4(ri, rw + k * T);
    ld_cols(cj, cw + (k < m ? k + m : k - m) * T, tx);
#pragma unroll
    for (int i = 0; i < 4; ++i)
#pragma unroll
      for (int j = 0; j < 8; ++j) kb[i][j] = fmaf(ri[i], cj[j], kb[i][j]);
  }
  float r2[4][8];
  {
    float ai[4], aj[8];
    ld4(ai, R + (size_t)(sdp + 2 * m) * T + 4 * ty);
    ld_cols(aj, C + (size_t)(sdp + 2 * m) * T, tx);
    const float c = mirror ? 2.0f : 1.0f;
#pragma unroll
    for (int i = 0; i < 4; ++i)
#pragma unroll
      for (int j = 0; j < 8; ++j) {
        kb[i][j] = inv_m * kb[i][j] - c * ai[i] * aj[j];
        r2[i][j] = 0.0f;
      }
  }
  for (int q = 0; q < (WIDE ? sdp : d); ++q) {
    float av[4], bv[8];
    ld4(av, R + q * T + 4 * ty);
    ld_cols(bv, C + q * T, tx);
#pragma unroll
    for (int i = 0; i < 4; ++i)
#pragma unroll
      for (int j = 0; j < 8; ++j) {
        const float df = av[i] - bv[j];
        r2[i][j] = fmaf(df, df, r2[i][j]);
      }
  }
  if constexpr (WIDE) {  // the same chain over the coordinates left in device memory
    for (int q = sdp; q < d; ++q) {
      float av[4], bv[8];
      ld4(av, GR + q * T + 4 * ty);
      ld_cols(bv, GC + q * T, tx);
#pragma unroll
      for (int i = 0; i < 4; ++i)
#pragma unroll
        for (int j = 0; j < 8; ++j) {
          const float df = av[i] - bv[j];
          r2[i][j] = fmaf(df, df, r2[i][j]);
        }
    }
  }
  // variance term; then kb becomes kb * f'(u), the lengthscale weight
  float gv = 0.0f;
#pragma unroll
  for (int i = 0; i < 4; ++i)
#pragma unroll
    for (int j = 0; j < 8; ++j) {
      float f, fp;
      f_fp<KERN>(r2[i][j], f, fp);
      gv = fmaf(kb[i][j], f, gv);
      kb[i][j] *= fp;
    }
  sum[0] += (double)gv;
#pragma unroll
  for (int k = 0; k < SUMS - 1; ++k) {
    float av[4], bv[8];
    const bool staged = !WIDE || q0 + k < sdp;
    ld4(av, (staged ? R : GR) + (q0 + k) * T + 4 * ty);
    ld_cols(bv, (staged ? C : GC) + (q0 + k) * T, tx);
    float acc = 0.0f;
#pragma unroll
    for (int i = 0; i < 4; ++i)
#pragma unroll
      for (int j = 0; j < 8; ++j) {
        const float df = av[i] - bv[j];
        acc = fmaf(kb[i][j], df * df, acc);
      }
    sum[1 + k] += (double)acc;
  }
}

// The walk: a sequence of tiles, the strip pairs (p, nb - 1 - p) one after
// the other, each strip p's tiles j = p .. nb - 1, then strip nb - 1 - p's
// (the middle strip of an odd nb is alone); a tile j > i takes the folded
// cotangent. per > 0 (B5): block (p, s, zc) takes segment s of pair p's
// tiles, `per` tiles a segment. per == 0 (B4): block (b, 0, zc) takes an
// even share, tiles [total b / B, total (b + 1) / B) of all `total`, so
// every block has the same work to within one tile and a pair boundary may
// fall inside a block. Either way, lengthscale dimensions 8 zc .. 8 zc + 7,
// and partial is [1 + dp][gridDim.x * gridDim.y]; slot = x * gridDim.y + y.
// A tile is staged with sdp coordinate fields (all dp of them, or the first
// STAGED_DIM when WIDE), then W, Z and alpha.
template <int KERN, bool WIDE>
__global__ void __launch_bounds__(THREADS, 4)
kgrad_strips_kernel(const float* __restrict__ pack, const float inv_m, double* __restrict__ partial,
                    int nb, int d, int dp, int m, int per, int nst) {
  extern __shared__ float4 smem4[];
  float* const rowbuf = reinterpret_cast<float*>(smem4);
  const int tsz = (dp + 2 * m + 1) * T;  // floats of a packed tile
  const int sdp = WIDE ? hyper::STAGED_DIM : dp;
  const int ssz = (sdp + 2 * m + 1) * T;  // floats of a staged tile
  // float offset in a packed tile of staged float e
  auto packed_at = [&](int e) { return WIDE && e >= sdp * T ? e + (dp - sdp) * T : e; };
  float* const ring = rowbuf + ssz;
  __shared__ double red[WARPS][SUMS];

  const int seq = nb + 1;  // tiles a pair opens in the sequence
  int t0, t1;
  if (per > 0) {
    const int p = blockIdx.x;
    const int len = nb - 1 - p > p ? nb + 1 : nb - p;
    t0 = p * seq + min(len, (int)blockIdx.y * per);
    t1 = p * seq + min(len, (int)blockIdx.y * per + per);
  } else {
    const long long total = (long long)nb * (nb + 1) / 2;
    t0 = (int)(total * blockIdx.x / gridDim.x);
    t1 = (int)(total * (blockIdx.x + 1) / gridDim.x);
  }
  const int tid = threadIdx.x, ty = tid >> 3, tx = tid & 7;
  const int q0 = 8 * blockIdx.z;

  auto tile_at = [&](int t, int& i, int& j) {
    const int p = t / seq, off = t - p * seq;
    if (off >= nb - p) {  // strip nb - 1 - p's part of pair p
      i = nb - 1 - p;
      j = i + off - (nb - p);
    } else {
      i = p;
      j = p + off;
    }
  };
  auto column = [&](int t) {
    int i, j;
    tile_at(t, i, j);
    return j;
  };
  auto issue = [&](int buf, int j) {
    const float* const src = pack + (size_t)j * tsz;
    float* const dst = ring + (size_t)buf * ssz;
    for (int e = 4 * tid; e < ssz; e += 4 * THREADS) cp16(dst + e, src + packed_at(e));
  };

  double sum[SUMS];
#pragma unroll
  for (int k = 0; k < SUMS; ++k) sum[k] = 0.0;

  for (int k = 0; k < nst - 1; ++k) {
    if (t0 + k < t1) issue(k, column(t0 + k));
    cp_commit();
  }
  int strip = -1;
  for (int t = t0; t < t1; ++t) {
    const int u = t - t0;
    if (t + nst - 1 < t1) issue((u + nst - 1) % nst, column(t + nst - 1));
    cp_commit();
    int i, j;
    tile_at(t, i, j);
    if (i != strip) {  // the row side, once per strip; its last readers passed the barrier below
      const float* const src = pack + (size_t)i * tsz;
      for (int e = tid; e < ssz / 4; e += THREADS)
        reinterpret_cast<float4*>(rowbuf)[e] =
            *reinterpret_cast<const float4*>(src + packed_at(4 * e));
      strip = i;
    }
    cp_wait(nst - 1);
    __syncthreads();
    tile_sums<KERN, WIDE>(rowbuf, ring + (size_t)(u % nst) * ssz, pack + (size_t)i * tsz,
                          pack + (size_t)j * tsz, j > i, d, sdp, m, q0, inv_m, ty, tx, sum);
    __syncthreads();  // this stage and rowbuf are free for the next copies
  }

  const int lane = tid & 31, warp = tid >> 5;
#pragma unroll
  for (int k = 0; k < SUMS; ++k) {
    double v = sum[k];
#pragma unroll
    for (int off = 16; off > 0; off >>= 1) v += __shfl_xor_sync(0xffffffffu, v, off);
    if (lane == 0) red[warp][k] = v;
  }
  __syncthreads();
  if (tid < SUMS) {
    double v = 0.0;
    for (int wq = 0; wq < WARPS; ++wq) v += red[wq][tid];
    const size_t slots = (size_t)gridDim.x * gridDim.y;
    const size_t slot = (size_t)blockIdx.x * gridDim.y + blockIdx.y;
    const int field = tid == 0 ? 0 : 1 + q0 + (tid - 1);
    if (tid == 0 ? blockIdx.z == 0 : field <= d) partial[(size_t)field * slots + slot] = v;
  }
}

inline int elementwise_blocks(size_t count) {
  const size_t blocks = (count + 255) / 256;
  return (int)(blocks < 4096 ? (blocks > 0 ? blocks : 1) : 4096);
}

// The pack grid, the strips, the fixed-order sum. blocks > 0 (B4): that many
// blocks, an even share of the walk each; else (B5) segs segments of each
// strip pair. nst: ring stages.
template <int KERN, bool WIDE>
cudaError_t launch_strips(const float* x, const float* w, const float* z, const float* alpha,
                          const Hyper& hyp, const Cotangent& cot, float* pack, double* partial,
                          float* out, int n, int d, int dp, int m, int segs, int blocks, int nst,
                          cudaStream_t st) {
  static size_t granted[hyper::MAX_DEVICES] = {};
  const int nb = (n + T - 1) / T, fields = dp + 2 * m + 1;
  const int staged = (WIDE ? hyper::STAGED_DIM : dp) + 2 * m + 1;  // fused_gram's KgradPlan.staged
  const size_t bytes = (size_t)(1 + nst) * staged * T * sizeof(float);
  if (bytes > MAX_SMEM) return cudaErrorInvalidValue;
  cudaError_t err = hyper::ensure_smem(kgrad_strips_kernel<KERN, WIDE>, bytes, granted);
  if (err != cudaSuccess) return err;
  const size_t count = (size_t)nb * fields * T;
  kgrad_pack_kernel<<<elementwise_blocks(count), 256, 0, st>>>(x, w, z, alpha, pack, hyp, n, d,
                                                              dp, m, count);
  err = cudaGetLastError();
  if (err != cudaSuccess) return err;
  const int pairs = (nb + 1) / 2;
  const int per = blocks > 0 ? 0 : (nb + 1 + segs - 1) / segs;
  const dim3 grid(blocks > 0 ? blocks : pairs, blocks > 0 ? 1 : segs, dp / 8);
  kgrad_strips_kernel<KERN, WIDE><<<grid, THREADS, bytes, st>>>(pack, cot.inv_m, partial, nb, d,
                                                                dp, m, per, nst);
  err = cudaGetLastError();
  if (err != cudaSuccess) return err;
  kgrad_common::kgrad_reduce_kernel<<<d + 1, kgrad_common::REDUCE_THREADS, 0, st>>>(
      partial, (size_t)grid.x * grid.y, hyp, cot, out);
  return cudaGetLastError();
}

// Checks the arguments of both entry points and dispatches on the covariance.
int run_strips(int kern, const void* x, const void* w, const void* z, const void* alpha,
               const void* log_var, const void* log_ls, int ls_stride, const void* g_p, float g_v,
               float inv_m, void* pack, void* partial, void* out, int n, int d, int dp, int m,
               int segs, int blocks, int nst, void* stream) {
  const long long nb = (n + T - 1) / T;  // tile indices are ints
  if (n < 1 || d < 1 || m < 1 || dp < d || dp % 8 != 0 || segs < 1 || blocks < 0 || nst < 1 ||
      nst > 3 || nb * (nb + 1) > 2147483647LL)
    return (int)cudaErrorInvalidValue;
  const float* X = static_cast<const float*>(x);
  const float* W = static_cast<const float*>(w);
  const float* Z = static_cast<const float*>(z);
  const float* AL = static_cast<const float*>(alpha);
  const Hyper hyp{static_cast<const float*>(log_var), static_cast<const float*>(log_ls),
                  ls_stride, nullptr, 0.0f};
  const Cotangent cot{static_cast<const float*>(g_p), g_v, inv_m};
  float* PK = static_cast<float*>(pack);
  double* P = static_cast<double*>(partial);
  float* O = static_cast<float*>(out);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
#define GPRAS_KGRAD_STRIPS(K)                                                                  \
  (dp > hyper::STAGED_DIM                                                                      \
       ? launch_strips<K, true>(X, W, Z, AL, hyp, cot, PK, P, O, n, d, dp, m, segs, blocks, nst,  \
                                st)                                                            \
       : launch_strips<K, false>(X, W, Z, AL, hyp, cot, PK, P, O, n, d, dp, m, segs, blocks, nst, \
                                 st))
  switch (kern) {
    case RBF: return GPRAS_KGRAD_STRIPS(RBF);
    case MATERN12: return GPRAS_KGRAD_STRIPS(MATERN12);
    case MATERN32: return GPRAS_KGRAD_STRIPS(MATERN32);
    case MATERN52: return GPRAS_KGRAD_STRIPS(MATERN52);
    case EXPONENTIAL: return GPRAS_KGRAD_STRIPS(EXPONENTIAL);
    default: return (int)cudaErrorInvalidValue;
  }
#undef GPRAS_KGRAD_STRIPS
}

}  // namespace
}  // namespace kgrad_strips
