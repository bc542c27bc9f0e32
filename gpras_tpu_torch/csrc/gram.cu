// Fused stationary Gram kernel for Hopper (sm_90a).
//
// Replaces the Pallas Gram body of gpras_tpu/ops/pallas_gram.py:
//   gram  <- _tile_body / _tile_value  (:77 / :35-74, launcher pallas_gram :268-311)
// It writes K(a, b) from raw coordinates, with noise on the global diagonal
// when the matrix is square (the training Gram K + sigma2 I).
//
// What bounds it on an H100: the output. At N = 49,152 (the Hutchinson
// training forward) it stores 49,152^2 fp32 = 9.66 GB, 2.9 ms at 3.35 TB/s;
// the inputs are 1.6 MB. Each entry costs ~33 instructions (an 8-wide FMA
// dot, r2, sqrt_rn, expf, the Matern52 polynomial, the diagonal test), so
// evaluating all 2.4e9 entries is ~2.7 ms of issue on 132 SMs: about as long
// as the stores, and in the first design (gram_kernel below) the two did not
// overlap. The design (gram_sym_kernel) answers both:
// - Symmetric walk. For a square Gram only the tiles ti <= tj of 64 x 64 are
//   computed; an off-diagonal tile is written twice, as itself and
//   transposed as its mirror (tj, ti). 1.2e9 evaluations instead of 2.4e9.
//   fp32 addition and multiplication commute, so the mirror holds the very
//   bits the first design computes for K_ji (same FMA chains, same order).
// - Stores from shared memory. The epilogue stages the finished tile and
//   its transpose in shared memory, so that every store of the mirror is as
//   coalesced as those of the tile: a warp writes two rows' 256 bytes each
//   with 16-byte streaming stores (__stcs). The stores retire while the
//   block computes its next tile; three blocks an SM keep the SM busy.
// - Persistent blocks. Three blocks per SM walk a static sequence of tiles
//   (block b takes tiles b, b + G, ...; the wrapper's plan,
//   ops/fused_gram.gram_plan, sizes G). The upper triangle is enumerated as
//   strip pairs (p, nb - 1 - p), nb + 1 tiles a pair, so no square root is
//   needed to find a tile. The next tile's operands are copied with cp.async
//   while the current one is computed.
// - A prep grid lays the coordinates out per 64-point tile, field by field
//   (pack[tile][field][64]: d coordinates divided by the lengthscales, then
//   the squared norm by the same FMA chain), so staging a tile is one
//   contiguous copy and no thread of the tile grid computes a norm.
// How a staged tile leaves is a template parameter (STORE_*): 16-byte
// streaming stores when N2 % 4 == 0, else 4-byte streaming stores (rows not
// 16-byte aligned). On an H100 80GB HBM3 at 700 W the copy engine's
// asynchronous stores lost to the 16-byte streaming stores at N = 49,152
// (tensor stores of 64 x 32 boxes 3.78 ms, 1-D bulk copies of 256-byte rows
// 6.93 ms, streaming stores 3.29 ms; PERF.md), so neither is kept.
//
// Inputs wider than STAGED_DIM = 128 dimensions (hyper.cuh; the TPU body
// takes the whole feature axis, blocks of (tile, D)): a stage holds the first
// 128 coordinate fields and the norm, and the dot product goes on over the
// packed tiles' remaining fields in device memory (through the L1 cache), in
// the same order, before the covariance.
//
// Numerics follow _tile_value: r2 = max(a2 + b2 - 2 ab, 0) with the dot and
// the norms accumulated by the same fp32 FMA chain as kmv.cu's build_tile,
// so a point against itself gives r2 == 0 exactly; the five tails come from
// stationary.cuh; noise is added where global row == global column. Both
// designs give the same bits (tests/test_torch_cuda_kernels.py).
//
// The first design stays as the yardstick of examples/torch_gram_timing.py
// (fused_gram._gram_cuda(..., tiles=True)): a block per 64 x 128 tile of the
// whole square, coordinates scaled by its own prep grid, 32 streaming stores
// a thread straight from registers.
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
constexpr int FIRST_MAX_D = 128;  // the first design stages every coordinate of its tile

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

// ------------------------------------------------ the symmetric design

constexpr int T = 64;              // tile edge
constexpr int SYM_THREADS = 256;   // 16 x 16: thread (ty, tx) owns rows 4 ty + i, columns 4 tx + j
// how a staged tile leaves shared memory: 4-byte streaming stores (any N2)
// or 16-byte streaming stores (N2 % 4 == 0)
enum { STORE_SCALAR = 0, STORE_VECTOR = 1 };
// floats of one staged output tile: 64 rows of 64, 4 floats of skew every 4 rows
constexpr int OBUF = T * T + T;

// Float offset of row r, column c in a staged tile: row r starts at
// 64 r + 4 (r / 4), so the 8 lanes of a quarter-warp that write rows
// 4 tx + j, column 4 ty (the mirror) or read a row's 16-byte chunks hit 8
// distinct bank groups (tests/test_torch_gram_plan.py).
__device__ __forceinline__ int obuf_at(int r, int c) { return r * T + 4 * (r >> 2) + c; }

__device__ __forceinline__ uint32_t smem_addr(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

__device__ __forceinline__ void cp16(float* smem, const float* gmem) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n" ::"r"(smem_addr(smem)), "l"(gmem));
}

__device__ __forceinline__ void cp_commit() { asm volatile("cp.async.commit_group;\n" ::); }

__device__ __forceinline__ void cp_wait_all() {
  asm volatile("cp.async.wait_group 0;\n" ::: "memory");
}

__device__ __forceinline__ void ld4(float (&dst)[4], const float* p) {
  const float4 q = *reinterpret_cast<const float4*>(p);
  dst[0] = q.x; dst[1] = q.y; dst[2] = q.z; dst[3] = q.w;
}

__device__ __forceinline__ void st4(float* p, float a, float b, float c, float e) {
  *reinterpret_cast<float4*>(p) = make_float4(a, b, c, e);
}

// pack[tile][field][64]: fields 0 .. d - 1 the coordinates divided by the
// lengthscales, field d the squared norm (fmaf chain over c = 0 .. d - 1, as
// gram_kernel forms a2 and b2); zeros for points past n.
__global__ void gram_pack_kernel(const float* __restrict__ x, float* __restrict__ pack,
                                 const Hyper hyp, int n, int d, size_t count) {
  const int fields = d + 1;
  for (size_t e = blockIdx.x * (size_t)blockDim.x + threadIdx.x; e < count;
       e += (size_t)gridDim.x * blockDim.x) {
    const int r = (int)(e % T);
    const size_t tf = e / T;
    const int f = (int)(tf % fields);
    const size_t g = tf / fields * T + r;
    float val = 0.0f;
    if (g < (size_t)n) {
      if (f < d) {
        val = __fdiv_rn(x[g * d + f], hyper::lengthscale(hyp, f));
      } else {
        for (int c = 0; c < d; ++c) {
          const float s = __fdiv_rn(x[g * d + c], hyper::lengthscale(hyp, c));
          val = fmaf(s, s, val);
        }
      }
    }
    pack[e] = val;
  }
}

// Tile t of the upper triangle of nb x nb tiles: strip pair p = t / (nb + 1)
// walks strip p's tiles (p, p .. nb - 1), then strip nb - 1 - p's (the
// middle strip of an odd nb is alone).
__device__ __forceinline__ void upper_tile(long long t, int nb, int& ti, int& tj) {
  const int p = (int)(t / (nb + 1));
  const int off = (int)(t - (long long)p * (nb + 1)), len0 = nb - p;
  if (off < len0) {
    ti = p;
    tj = p + off;
  } else {
    ti = nb - 1 - p;
    tj = ti + (off - len0);
  }
}

// pa, pb: packed row and column points (pb == pa when square). Block b
// computes tiles b, b + gridDim.x, ... of the `tiles` in the sequence: the
// upper triangle when square, else all nb1 x nb2 tiles row by row. The
// streaming stores have read the staged tile when the block passes the next
// barrier, so one output stage serves them. WIDE (d > STAGED_DIM): a stage
// holds the first STAGED_DIM coordinate fields and the norm; the dot product
// goes on over the remaining fields of the packed tiles in device memory.
template <int KERN, int STORE, bool WIDE>
__global__ void __launch_bounds__(SYM_THREADS, 3)
gram_sym_kernel(const float* __restrict__ pa, const float* __restrict__ pb,
                float* __restrict__ out, const Hyper hyp, int n1, int n2, int d, int square,
                long long tiles) {
  extern __shared__ float4 smem4[];
  float* const obuf = reinterpret_cast<float*>(smem4);  // [tile, mirror][OBUF]
  float* const ibuf = obuf + 2 * OBUF;                  // [2 stages][rows, columns][ss]
  const int fs = (d + 1) * T;                           // floats of a packed tile
  const int sd = WIDE ? hyper::STAGED_DIM : d;          // coordinate fields staged
  const int ss = (sd + 1) * T;                          // floats of a staged tile
  const int nb1 = (n1 + T - 1) / T, nb2 = (n2 + T - 1) / T;
  const float var = hyper::variance(hyp), noise = hyper::noise(hyp);
  const int tid = threadIdx.x, ty = tid >> 4, tx = tid & 15, warp = tid >> 5, lane = tid & 31;

  auto coords = [&](long long t, int& ti, int& tj) {
    if (square) {
      upper_tile(t, nb1, ti, tj);
    } else {
      ti = (int)(t / nb2);
      tj = (int)(t - (long long)ti * nb2);
    }
  };
  auto stage = [&](int s, long long t) {
    int ti, tj;
    coords(t, ti, tj);
    const float* const rows = pa + (size_t)ti * fs;
    const float* const cols = pb + (size_t)tj * fs;
    float* const dst = ibuf + (size_t)2 * s * ss;
    if constexpr (WIDE) {  // fields 0 .. sd - 1, then the norm (field d)
      for (int e = 4 * tid; e < ss; e += 4 * SYM_THREADS) {
        const int src = e < sd * T ? e : d * T + (e - sd * T);
        cp16(dst + e, rows + src);
        cp16(dst + ss + e, cols + src);
      }
    } else {
      for (int e = 4 * tid; e < fs; e += 4 * SYM_THREADS) {
        cp16(dst + e, rows + e);
        cp16(dst + fs + e, cols + e);
      }
    }
  };

  long long t = blockIdx.x;
  if (t < tiles) stage(0, t);
  cp_commit();
  for (int u = 0; t < tiles; ++u, t += gridDim.x) {
    const int s = u & 1;
    int ti, tj;
    coords(t, ti, tj);
    const int row0 = ti * T, col0 = tj * T;
    const bool mirror = square && ti != tj;
    cp_wait_all();
    __syncthreads();  // tile u's operands are in; the output buffers are free
    if (t + gridDim.x < tiles) stage(s ^ 1, t + gridDim.x);
    cp_commit();

    const float* const R = ibuf + (size_t)2 * s * ss;
    const float* const C = R + ss;
    float dot[4][4];
#pragma unroll
    for (int i = 0; i < 4; ++i)
#pragma unroll
      for (int j = 0; j < 4; ++j) dot[i][j] = 0.0f;
    for (int c = 0; c < sd; ++c) {
      float av[4], bv[4];
      ld4(av, R + c * T + 4 * ty);
      ld4(bv, C + c * T + 4 * tx);
#pragma unroll
      for (int i = 0; i < 4; ++i)
#pragma unroll
        for (int j = 0; j < 4; ++j) dot[i][j] = fmaf(av[i], bv[j], dot[i][j]);
    }
    if constexpr (WIDE) {  // the same chain over the fields left in device memory
      const float* const gr = pa + (size_t)ti * fs + 4 * ty;
      const float* const gc = pb + (size_t)tj * fs + 4 * tx;
      for (int c = sd; c < d; ++c) {
        float av[4], bv[4];
        ld4(av, gr + c * T);
        ld4(bv, gc + c * T);
#pragma unroll
        for (int i = 0; i < 4; ++i)
#pragma unroll
          for (int j = 0; j < 4; ++j) dot[i][j] = fmaf(av[i], bv[j], dot[i][j]);
      }
    }
    float an[4], bn[4];
    ld4(an, R + sd * T + 4 * ty);
    ld4(bn, C + sd * T + 4 * tx);
    float kv[4][4];
#pragma unroll
    for (int i = 0; i < 4; ++i)
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        const float r2 = fmaxf(an[i] + bn[j] - 2.0f * dot[i][j], 0.0f);
        float k = covariance<KERN>(r2, var);
        if (square && row0 + 4 * ty + i == col0 + 4 * tx + j) k += noise;
        kv[i][j] = k;
      }
    float* const O = obuf;
    float* const OT = O + OBUF;
#pragma unroll
    for (int i = 0; i < 4; ++i)
      st4(O + obuf_at(4 * ty + i, 4 * tx), kv[i][0], kv[i][1], kv[i][2], kv[i][3]);
    if (mirror) {  // column j of the thread's 4 x 4 goes to row 4 tx + j of the mirror
#pragma unroll
      for (int j = 0; j < 4; ++j)
        st4(OT + obuf_at(4 * tx + j, 4 * ty), kv[0][j], kv[1][j], kv[2][j], kv[3][j]);
    }
    __syncthreads();  // the tile (and its mirror) are staged

    const int nr = min(T, n1 - row0), nc = min(T, n2 - col0);
    if constexpr (STORE == STORE_VECTOR) {  // 16-byte streaming stores, 16 lanes a row
      for (int e = tid; e < T * T / 4; e += SYM_THREADS) {
        const int r = e >> 4, c = 4 * (e & 15);
        if (r < nr && c < nc)
          __stcs(reinterpret_cast<float4*>(out + (size_t)(row0 + r) * n2 + col0 + c),
                 *reinterpret_cast<const float4*>(O + obuf_at(r, c)));
        if (mirror && r < nc && c < nr)
          __stcs(reinterpret_cast<float4*>(out + (size_t)(col0 + r) * n2 + row0 + c),
                 *reinterpret_cast<const float4*>(OT + obuf_at(r, c)));
      }
    } else {  // 4-byte streaming stores, a warp a row
      for (int r = warp; r < nr; r += SYM_THREADS / 32)
        for (int c = lane; c < nc; c += 32)
          __stcs(out + (size_t)(row0 + r) * n2 + col0 + c, O[obuf_at(r, c)]);
      if (mirror)
        for (int c = warp; c < nc; c += SYM_THREADS / 32)
          for (int r = lane; r < nr; r += 32)
            __stcs(out + (size_t)(col0 + c) * n2 + row0 + r, OT[obuf_at(c, r)]);
    }
  }
}

inline int scale_blocks(size_t count) {
  const size_t blocks = (count + THREADS - 1) / THREADS;
  return (int)(blocks < 2048 ? (blocks > 0 ? blocks : 1) : 2048);
}

// the first design: a scaling prep grid, then a block per 64 x 128 tile
template <int KERN>
cudaError_t launch_tiles(const float* a, const float* b, float* out, float* scaled,
                         const Hyper& hyp, int n1, int n2, int d, int square, cudaStream_t st) {
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

// the symmetric design: the pack grid(s), then `blocks` persistent blocks
template <int KERN, int STORE, bool WIDE>
cudaError_t launch_sym(const float* a, const float* b, float* out, float* pack, const Hyper& hyp,
                       int n1, int n2, int d, int square, int blocks, cudaStream_t st) {
  static size_t granted[hyper::MAX_DEVICES] = {};
  const size_t fs = (size_t)(d + 1) * T;
  const size_t ss = (size_t)((WIDE ? hyper::STAGED_DIM : d) + 1) * T;
  const size_t bytes = (2 * (size_t)OBUF + 4 * ss) * sizeof(float);  // fused_gram.gram_smem
  cudaError_t err = hyper::ensure_smem(gram_sym_kernel<KERN, STORE, WIDE>, bytes, granted);
  if (err != cudaSuccess) return err;
  const int nb1 = (n1 + T - 1) / T, nb2 = (n2 + T - 1) / T;
  float* const pa = pack;
  float* const pb = square ? pack : pack + (size_t)nb1 * fs;
  gram_pack_kernel<<<scale_blocks(nb1 * fs), THREADS, 0, st>>>(a, pa, hyp, n1, d, nb1 * fs);
  if (!square)
    gram_pack_kernel<<<scale_blocks(nb2 * fs), THREADS, 0, st>>>(b, pb, hyp, n2, d, nb2 * fs);
  err = cudaGetLastError();
  if (err != cudaSuccess) return err;
  const long long tiles = square ? (long long)nb1 * (nb1 + 1) / 2 : (long long)nb1 * nb2;
  gram_sym_kernel<KERN, STORE, WIDE><<<blocks, SYM_THREADS, bytes, st>>>(pa, pb, out, hyp, n1,
                                                                         n2, d, square, tiles);
  return cudaGetLastError();
}

template <int KERN>
cudaError_t launch(const float* a, const float* b, float* out, float* scratch, const Hyper& hyp,
                   int n1, int n2, int d, int square, int blocks, int store, int tiles,
                   cudaStream_t st) {
  if (tiles) return launch_tiles<KERN>(a, b, out, scratch, hyp, n1, n2, d, square, st);
#define GPRAS_GRAM_SYM(S, W) \
  launch_sym<KERN, S, W>(a, b, out, scratch, hyp, n1, n2, d, square, blocks, st)
  const bool wide = d > hyper::STAGED_DIM;
  if (store == STORE_VECTOR)
    return wide ? GPRAS_GRAM_SYM(STORE_VECTOR, true) : GPRAS_GRAM_SYM(STORE_VECTOR, false);
  return wide ? GPRAS_GRAM_SYM(STORE_SCALAR, true) : GPRAS_GRAM_SYM(STORE_SCALAR, false);
#undef GPRAS_GRAM_SYM
}

}  // namespace

extern "C" {

// out (n1, n2) = K(a, b) [+ noise on the diagonal when square]. a (n1, d) and
// b (n2, d): contiguous fp32, raw coordinates (b == a when square).
// log_var, log_ls (d floats ls_stride apart), noise: hyper.cuh's Hyper.
// The plan comes from the wrapper (ops/fused_gram.gram_plan): blocks, the
// persistent blocks of the symmetric design; store, how rows leave shared
// memory: 0 4-byte streaming stores, 1 16-byte streaming stores (needs
// n2 % 4 == 0 and out 16-byte aligned).
// scratch: the packed points, ceil(n1 / 64) * (d + 1) * 64 floats, plus
// ceil(n2 / 64) * (d + 1) * 64 when not square. tiles = 1 runs the first
// design instead (scratch: n1 * d floats, plus n2 * d when not square).
int gpras_gram(int kern, const void* a, const void* b, void* out, void* scratch,
               const void* log_var, const void* log_ls, int ls_stride, const void* noise_p,
               float noise_v, int n1, int n2, int d, int square, int blocks, int store, int tiles,
               void* stream) {
  if (n1 < 1 || n2 < 1 || d < 1 || (square && n1 != n2) || (!tiles && blocks < 1) ||
      (tiles && d > FIRST_MAX_D) ||
      store < STORE_SCALAR || store > STORE_VECTOR ||
      (store == STORE_VECTOR && (n2 % 4 != 0 || reinterpret_cast<uintptr_t>(out) % 16 != 0)))
    return (int)cudaErrorInvalidValue;
  const float* A = static_cast<const float*>(a);
  const float* B = static_cast<const float*>(b);
  float* O = static_cast<float*>(out);
  float* S = static_cast<float*>(scratch);
  const Hyper hyp{static_cast<const float*>(log_var), static_cast<const float*>(log_ls),
                  ls_stride, static_cast<const float*>(noise_p), noise_v};
  cudaStream_t st = static_cast<cudaStream_t>(stream);
#define GPRAS_GRAM(K) launch<K>(A, B, O, S, hyp, n1, n2, d, square, blocks, store, tiles, st)
  switch (kern) {
    case RBF: return GPRAS_GRAM(RBF);
    case MATERN12: return GPRAS_GRAM(MATERN12);
    case MATERN32: return GPRAS_GRAM(MATERN32);
    case MATERN52: return GPRAS_GRAM(MATERN52);
    case EXPONENTIAL: return GPRAS_GRAM(EXPONENTIAL);
    default: return (int)cudaErrorInvalidValue;
  }
#undef GPRAS_GRAM
}

}  // extern "C"
