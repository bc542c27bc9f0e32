// Symmetric fused gradient contraction (B5) for Hopper (sm_90a): the exact-GP
// training backward's sum_ij Kbar_ij dK_ij/dtheta over the upper triangle,
// without any (N, N) buffer.
//
// Replaces _kgrad_sym_body of gpras_tpu/ops/pallas_gram.py (:606-698,
// launcher pallas_kgrad :701, call :749). With a the inputs divided by the
// lengthscales, u_ij = ||a_i - a_j||^2, K = var f(u) and the rank-(m+1)
// cotangent Kbar = gh [(1/m) W Z^T - alpha alpha^T] (gh = g / 2), the outputs
// are
//   d log_variance      =      sum_ij Kbar_ij var f(u_ij)
//   d log_lengthscale_d = -2 sum_ij Kbar_ij var f'(u_ij) (a_id - a_jd)^2.
// dK is symmetric, so a strictly-upper 64 x 64 tile takes the folded
// cotangent Kbar_ij + Kbar_ji^T, a depth-2m dot of [W_i | Z_i] with
// [Z_j | W_j], and f, f' once per mirror pair; a diagonal tile takes Kbar_ii.
//
// What bounds it on an H100: operations, all of them fp32 on the CUDA cores.
// At N = 49,152, m = 16, D = 8 the upper triangle holds 1.2e9 entries of
// ~100 instructions each (32 FMAs of the folded dot, 16 for the squared
// distance, ~30 for f and f' with their sqrt and exp, 24 for the eight
// lengthscale sums): ~4 ms if every SM issued four warp instructions a clock.
// The inputs are 8 MB, the outputs nine numbers. So the design is about
// issue slots: nothing but those instructions in the loop.
// - Operands packed once. A prep grid divides the coordinates by the
//   lengthscales and lays each 64-point tile's coordinates, W, Z and alpha
//   out field by field (pack[tile][field][64]), zeros past N and past D: a
//   tile's operands are one contiguous block, copied by cp.async with no
//   index arithmetic, and a thread's four rows or columns of a field are one
//   16-byte shared-memory load without bank conflicts.
// - Persistent blocks over row strips. Block (p, s) walks segment s of the
//   tile sequence of strips p and nb - 1 - p (nb + 1 tiles a pair: the
//   triangle is balanced, as csrc/kmv_sym.cu's symmetric build does). The row
//   side is staged once per strip; the column tiles stream through a ring of
//   shared-memory stages (cp.async, up to three deep), so the next tiles'
//   copies overlap this tile's arithmetic. The wrapper's plan
//   (ops/fused_gram.kgrad_sym_plan) cuts the segments so that the blocks fill
//   the card many waves deep at N = 49,152 and still fill it at N = 3,585.
// - 4 x 8 entries per thread (128 threads a tile), so an inner-loop step is
//   three 16-byte loads for 32 FMAs (the first port: one load per two FMAs).
// - Sums kept in registers. Each thread adds a tile's nine fp32 sums (its 32
//   entries) into nine float64 running sums of its own; the block reduces
//   once, at its end, and writes 9 doubles. kgrad_reduce_kernel adds the
//   blocks' partials in a fixed order: the same bits from run to run, no
//   atomics. (The first port reduced nine times per tile and wrote 21 MB of
//   partials at N = 49,152.)
// - More than 8 input dimensions: the nine running sums are the variance
//   term and eight lengthscale terms; blockIdx.z selects which eight, and
//   each such chunk repeats the sweep.
// The cotangent stays on the CUDA cores: as 3xTF32 mma.sync (depth 33 padded
// to 40) it would be 2.9e11 tensor-core operations for the 8.0e10 fp32 ones
// it replaces, and on this card TF32 mma.sync ran at 3.3x the fp32 rate and
// did not overlap fp32 work on the same SM (PERF.md), so it cannot pay.
//
// Kept from the first port: per-entry (a_id - a_jd)^2 with no sum expansion
// (r2 is exactly 0 for a point against itself), f_fp's 1e-12 guard, ragged N
// masked by zeros in the packed operands (their Kbar is 0), float64
// partials, the noise and jitter diagonal left to the caller.
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

// One 64 x 64 tile: rows from R, columns from C (packed tiles in shared
// memory), the thread's 4 x 8 entries; adds the tile's sums to `sum`
// (float64): sum[0] the variance term, sum[1 + k] the lengthscale term of
// dimension q0 + k.
template <int KERN>
__device__ __forceinline__ void tile_sums(const float* R, const float* C, bool mirror, int d,
                                          int dp, int m, int q0, float inv_m, int ty, int tx,
                                          double (&sum)[SUMS]) {
  const float* const rw = R + (size_t)dp * T + 4 * ty;  // row side: W fields, then Z
  const float* const cw = C + (size_t)dp * T;           // column side: Z fields first, then W
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
    ld4(ai, R + (size_t)(dp + 2 * m) * T + 4 * ty);
    ld_cols(aj, C + (size_t)(dp + 2 * m) * T, tx);
    const float c = mirror ? 2.0f : 1.0f;
#pragma unroll
    for (int i = 0; i < 4; ++i)
#pragma unroll
      for (int j = 0; j < 8; ++j) {
        kb[i][j] = inv_m * kb[i][j] - c * ai[i] * aj[j];
        r2[i][j] = 0.0f;
      }
  }
  for (int q = 0; q < d; ++q) {
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
    ld4(av, R + (q0 + k) * T + 4 * ty);
    ld_cols(bv, C + (q0 + k) * T, tx);
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

// Block (p, s, zc): pair p of strips (p and nb - 1 - p), segment s of the
// pair's tile sequence (strip p's tiles j = p .. nb - 1, then strip
// nb - 1 - p's, `per` tiles a segment), lengthscale dimensions 8 zc .. 8 zc + 7.
// partial is [1 + dp][gridDim.x * gridDim.y]; slot = p * gridDim.y + s.
template <int KERN>
__global__ void __launch_bounds__(THREADS, 4)
kgrad_sym_kernel(const float* __restrict__ pack, const float inv_m, double* __restrict__ partial,
                 int nb, int d, int dp, int m, int per, int nst) {
  extern __shared__ float4 smem4[];
  float* const rowbuf = reinterpret_cast<float*>(smem4);
  const int tsz = (dp + 2 * m + 1) * T;  // floats of a packed tile
  float* const ring = rowbuf + tsz;
  __shared__ double red[WARPS][SUMS];

  const int p = blockIdx.x, q = nb - 1 - p;
  const int len0 = nb - p;                   // strip p's tiles
  const int len = q > p ? nb + 1 : len0;     // the pair's (the middle strip is alone)
  const int t0 = min(len, (int)blockIdx.y * per), t1 = min(len, t0 + per);
  const int tid = threadIdx.x, ty = tid >> 3, tx = tid & 7;
  const int q0 = 8 * blockIdx.z;

  auto column = [&](int t) { return t < len0 ? p + t : q + (t - len0); };
  auto issue = [&](int buf, int j) {
    const float* const src = pack + (size_t)j * tsz;
    float* const dst = ring + (size_t)buf * tsz;
    for (int e = 4 * tid; e < tsz; e += 4 * THREADS) cp16(dst + e, src + e);
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
    const int i = t < len0 ? p : q, j = column(t);
    if (i != strip) {  // the row side, once per strip; its last readers passed the barrier below
      const float4* const src = reinterpret_cast<const float4*>(pack + (size_t)i * tsz);
      for (int e = tid; e < tsz / 4; e += THREADS) reinterpret_cast<float4*>(rowbuf)[e] = src[e];
      strip = i;
    }
    cp_wait(nst - 1);
    __syncthreads();
    tile_sums<KERN>(rowbuf, ring + (size_t)(u % nst) * tsz, j > i, d, dp, m, q0, inv_m, ty, tx,
                    sum);
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
    const size_t slot = (size_t)p * gridDim.y + blockIdx.y;
    const int field = tid == 0 ? 0 : 1 + q0 + (tid - 1);
    if (tid == 0 ? blockIdx.z == 0 : field <= d) partial[(size_t)field * slots + slot] = v;
  }
}

inline int elementwise_blocks(size_t count) {
  const size_t blocks = (count + 255) / 256;
  return (int)(blocks < 4096 ? (blocks > 0 ? blocks : 1) : 4096);
}

template <int KERN>
cudaError_t launch(const float* x, const float* w, const float* z, const float* alpha,
                   const Hyper& hyp, const Cotangent& cot, float* pack, double* partial,
                   float* out, int n, int d, int dp, int m, int segs, int nst, cudaStream_t st) {
  static size_t granted[hyper::MAX_DEVICES] = {};
  const int nb = (n + T - 1) / T, fields = dp + 2 * m + 1;
  const size_t bytes = (size_t)(1 + nst) * fields * T * sizeof(float);
  if (bytes > MAX_SMEM) return cudaErrorInvalidValue;
  cudaError_t err = hyper::ensure_smem(kgrad_sym_kernel<KERN>, bytes, granted);
  if (err != cudaSuccess) return err;
  const size_t count = (size_t)nb * fields * T;
  kgrad_pack_kernel<<<elementwise_blocks(count), 256, 0, st>>>(x, w, z, alpha, pack, hyp, n, d,
                                                              dp, m, count);
  err = cudaGetLastError();
  if (err != cudaSuccess) return err;
  const int pairs = (nb + 1) / 2, per = (nb + 1 + segs - 1) / segs;
  const dim3 grid(pairs, segs, dp / 8);
  kgrad_sym_kernel<KERN><<<grid, THREADS, bytes, st>>>(pack, cot.inv_m, partial, nb, d, dp, m,
                                                       per, nst);
  err = cudaGetLastError();
  if (err != cudaSuccess) return err;
  kgrad_common::kgrad_reduce_kernel<<<d + 1, kgrad_common::REDUCE_THREADS, 0, st>>>(
      partial, (size_t)pairs * segs, hyp, cot, out);
  return cudaGetLastError();
}

}  // namespace

extern "C" {

// out (1 + d) fp32 = [d log_variance, d log_lengthscales...] of
// sum_ij Kbar_ij dK_ij over the upper-triangle tiles. x (n, d) raw
// coordinates, w and z (n, m), alpha (n): contiguous fp32. log_var, log_ls
// (d floats ls_stride apart): hyper.cuh's Hyper. g: the cotangent's scale,
// one fp32 in device memory (g_p) or, when g_p is null, g_v; inv_m = 1 / m.
// The plan comes from the wrapper (ops/fused_gram.kgrad_sym_plan): dp (d
// rounded up to a multiple of 8), segs (segments a strip pair's nb + 1 tiles
// are cut into, nb = ceil(n / 64)), nst (ring stages, 1 to 3). Scratch:
// pack, nb * (dp + 2 m + 1) * 64 floats; partial, (1 + dp) * ceil(nb / 2) *
// segs doubles.
int gpras_kgrad_sym(int kern, const void* x, const void* w, const void* z, const void* alpha,
                    const void* log_var, const void* log_ls, int ls_stride, const void* g_p,
                    float g_v, float inv_m, void* pack, void* partial, void* out, int n, int d,
                    int dp, int m, int segs, int nst, void* stream) {
  if (n < 1 || d < 1 || m < 1 || dp < d || dp % 8 != 0 || segs < 1 || nst < 1 || nst > 3)
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
#define GPRAS_KGRAD_SYM(K) \
  launch<K>(X, W, Z, AL, hyp, cot, PK, P, O, n, d, dp, m, segs, nst, st)
  switch (kern) {
    case RBF: return GPRAS_KGRAD_SYM(RBF);
    case MATERN12: return GPRAS_KGRAD_SYM(MATERN12);
    case MATERN32: return GPRAS_KGRAD_SYM(MATERN32);
    case MATERN52: return GPRAS_KGRAD_SYM(MATERN52);
    case EXPONENTIAL: return GPRAS_KGRAD_SYM(EXPONENTIAL);
    default: return (int)cudaErrorInvalidValue;
  }
#undef GPRAS_KGRAD_SYM
}

}  // extern "C"
