// Fused stationary-covariance matvec kernel B2 for Hopper (sm_90a).
//
// Replaces _kmv_body of gpras_tpu/ops/pallas_gram.py (:84-149, launcher
// pallas_kmv :466-480): (K(a, b) [+ noise I when square]) @ V from raw
// coordinates, divided by the lengthscales where they are staged (hyper.cuh),
// without ever storing a covariance tile in device memory. The symmetric
// body (B3) is csrc/kmv_sym.cu.
//
// What bounds it on an H100: at the serving shape (256 queries against
// N = 49,152, D = 8, R = 1) one call evaluates ~1.3e7 covariance entries, each
// ~28 fp32 operations plus a sqrt and an exp, against 2 for the contraction
// and O(N D) bytes: it is bound by the entries' operations, ~5 us of them at
// the card's fp32 peak, so by how many of its 132 SMs issue and how little
// else they do per entry. Two designs, picked by the wrapper
// (ops/fused_gram.kmv_dense_plan) from the shape:
//
// ROWS, R <= 16 and too few 64-row tiles to fill the card (the posterior mean
//   of a 64- or 256-query bucket): the matrix-vector product it is. A thread
//   owns one query row, its scaled coordinates and squared norm in registers
//   (the coordinates past the first 8 in shared memory), and a block of 64
//   threads sweeps a chunk of the N2 points, staged 64 at a time in shared
//   memory as packed records (scaled coordinates, norm, the R values of V)
//   that every lane reads by 16-byte broadcast loads. No covariance tile in
//   shared memory, no barrier inside the sweep of a stage, no idle lanes at
//   R = 1 (the tiled design gives 15 of 16 threads a column that does not
//   exist there). The chunks are as many as fill the SMs several blocks
//   deep; each block writes its partial sums to a slot of its own and
//   kmv_rows_reduce_kernel adds the slots per output element, lane k taking
//   chunks k, k + 32, ... in order and a fixed butterfly joining the lanes.
// TILES, every other shape: each 64 x 64 covariance tile is built once in
//   shared memory and contracted with V in a register-blocked fp32 FMA loop
//   (4 x TR outputs per thread); when the row tiles alone leave SMs idle the
//   column sweep is split over blocks and kmv_reduce_kernel adds the partial
//   sums in a fixed order.
// Inputs wider than STAGED_DIM = 128 dimensions (hyper.cuh): the tiled design
// stages both tiles' coordinates 128 at a time and carries the dot products
// and norms across the chunks (build_tile_wide); the rows design, which holds
// a row's coordinates per thread, is not planned there.
// Both are deterministic bit for bit (no atomics), and the two-level sums are
// more exact than one fp32 accumulator over 49,152 terms, which left ~7e-6 of
// the result's scale against ~1e-6 (PERF.md).
//
// Numerics follow _tile_value (:35-74) verbatim: r2 = max(a2 + b2 - 2ab, 0)
// with the D-wide dot and the norms accumulated in full fp32 by the same FMA
// chain (so coincident points give r2 == 0 exactly), r = sqrt(max(r2, 1e-36)),
// the five stationary tails with the same constants, and the noise diagonal
// on "global row == global column". Plain fp32 throughout (no TF32).
//
// Plain C interface (loaded with ctypes). The entry point returns
// cudaGetLastError() after its launches; the Python wrapper raises on nonzero.

#include <cuda_runtime.h>
#include <stdint.h>

#include "hyper.cuh"
#include "stationary.cuh"

namespace {

using namespace stationary;
using hyper::Hyper;

constexpr int T = 64;            // covariance tile edge (rows and columns)
constexpr int THREADS = 256;     // 16 x 16 threads; each owns 4 rows x TR columns
constexpr int KC = 16;           // rows of V staged in shared memory per step
constexpr int KPAD = T + 4;      // padded tile row: float4-aligned, fewer bank conflicts

// Shared-memory carve-up. Ks comes first so its float4 reads stay aligned.
// sd = min(d, STAGED_DIM) coordinates are staged at a time.
struct Smem {
  float* ks;  // [T][KPAD]  ks[n * KPAD + m] = k(a_m, b_n)
  float* vs;  // [KC][16 * TR] staged rows of V
  float* as;  // [sd][T] row-tile coordinates, transposed
  float* bs;  // [sd][T] column-tile coordinates, transposed
  float* a2;  // [T] squared norms of the row tile
  float* b2;  // [T] squared norms of the column tile
  float* ls;  // [d] lengthscales
};

__host__ __device__ inline int staged(int d) {
  return d < hyper::STAGED_DIM ? d : hyper::STAGED_DIM;
}

__host__ __device__ inline size_t smem_floats(int d, int tr) {
  return (size_t)T * KPAD + (size_t)KC * 16 * tr + 2 * (size_t)staged(d) * T + 2 * T + d;
}

__device__ inline Smem carve(float* base, int d, int tr) {
  Smem s;
  s.ks = base;
  s.vs = s.ks + T * KPAD;
  s.as = s.vs + KC * 16 * tr;
  s.bs = s.as + staged(d) * T;
  s.a2 = s.bs + staged(d) * T;
  s.b2 = s.a2 + T;
  s.ls = s.b2 + T;
  return s;
}

// Stage rows [row0, row0 + T) of x (n, d), divided by the lengthscales ls,
// into dst[d][T]; rows past n are 0.
__device__ inline void load_coords(const float* __restrict__ x, int n, int d,
                                   int row0, const float* ls, float* dst) {
  for (int idx = threadIdx.x; idx < T * d; idx += THREADS) {
    const int row = idx / d, col = idx - row * d;
    const int g = row0 + row;
    dst[col * T + row] = g < n ? __fdiv_rn(x[(size_t)g * d + col], ls[col]) : 0.0f;
  }
}

// Dimensions [c0, c0 + dc) of rows [row0, row0 + T) of x (n, d), divided by
// the lengthscales ls, into dst[dc][T]; rows past n are 0.
__device__ inline void load_chunk(const float* __restrict__ x, int n, int d, int row0, int c0,
                                  int dc, const float* ls, float* dst) {
  for (int idx = threadIdx.x; idx < T * dc; idx += THREADS) {
    const int row = idx / dc, col = idx - row * dc;
    const int g = row0 + row;
    dst[col * T + row] = g < n ? __fdiv_rn(x[(size_t)g * d + c0 + col], ls[c0 + col]) : 0.0f;
  }
}

// Squared norms by the same FMA chain as the tile's dot products.
__device__ inline void norms(const float* src, int d, float* dst, int row) {
  float acc = 0.0f;
  for (int c = 0; c < d; ++c) acc = fmaf(src[c * T + row], src[c * T + row], acc);
  dst[row] = acc;
}

// One 64 x 64 covariance tile into s.ks; entries outside (n1, n2) are 0.
template <int KERN>
__device__ inline void build_tile(const Smem& s, int d, int row0, int col0,
                                  int n1, int n2, float var, float noise,
                                  bool square) {
  const int m = threadIdx.x & (T - 1);
  const int nb = threadIdx.x >> 6;  // 0..3; entry e covers column nb + 4 e
  float dot[16];
#pragma unroll
  for (int e = 0; e < 16; ++e) dot[e] = 0.0f;
  for (int c = 0; c < d; ++c) {
    const float av = s.as[c * T + m];
#pragma unroll
    for (int e = 0; e < 16; ++e) dot[e] = fmaf(av, s.bs[c * T + nb + 4 * e], dot[e]);
  }
  const int gm = row0 + m;
  const float am = s.a2[m];
#pragma unroll
  for (int e = 0; e < 16; ++e) {
    const int n = nb + 4 * e;
    const int gn = col0 + n;
    const float r2 = fmaxf(am + s.b2[n] - 2.0f * dot[e], 0.0f);
    float kv = covariance<KERN>(r2, var);
    if (square && gm == gn) kv += noise;
    if (gm >= n1 || gn >= n2) kv = 0.0f;
    s.ks[n * KPAD + m] = kv;
  }
}

// build_tile for d > STAGED_DIM: both tiles' coordinates are staged
// STAGED_DIM dimensions at a time, and the dot products and the norms are
// carried across the chunks by build_tile's FMA chains, in the order of the
// dimensions, so the entries are those a whole staging would give. Starts
// with a barrier (the previous tile's readers of ks are done).
template <int KERN>
__device__ inline void build_tile_wide(const Smem& s, const float* __restrict__ a,
                                       const float* __restrict__ b, int d, int row0, int col0,
                                       int n1, int n2, float var, float noise, bool square) {
  const int m = threadIdx.x & (T - 1);
  const int nb = threadIdx.x >> 6;
  float dot[16];
#pragma unroll
  for (int e = 0; e < 16; ++e) dot[e] = 0.0f;
  float nacc = 0.0f;  // threads 0 .. 63: row m's norm; 64 .. 127: column m's
  for (int c0 = 0; c0 < d; c0 += hyper::STAGED_DIM) {
    const int dc = min(hyper::STAGED_DIM, d - c0);
    __syncthreads();
    load_chunk(a, n1, d, row0, c0, dc, s.ls, s.as);
    load_chunk(b, n2, d, col0, c0, dc, s.ls, s.bs);
    __syncthreads();
    const float* const own = nb == 0 ? s.as : s.bs;
    if (nb < 2)
      for (int c = 0; c < dc; ++c) nacc = fmaf(own[c * T + m], own[c * T + m], nacc);
    for (int c = 0; c < dc; ++c) {
      const float av = s.as[c * T + m];
#pragma unroll
      for (int e = 0; e < 16; ++e) dot[e] = fmaf(av, s.bs[c * T + nb + 4 * e], dot[e]);
    }
  }
  if (nb < 2) (nb == 0 ? s.a2 : s.b2)[m] = nacc;
  __syncthreads();
  const int gm = row0 + m;
  const float am = s.a2[m];
#pragma unroll
  for (int e = 0; e < 16; ++e) {
    const int n = nb + 4 * e;
    const int gn = col0 + n;
    const float r2 = fmaxf(am + s.b2[n] - 2.0f * dot[e], 0.0f);
    float kv = covariance<KERN>(r2, var);
    if (square && gm == gn) kv += noise;
    if (gm >= n1 || gn >= n2) kv = 0.0f;
    s.ks[n * KPAD + m] = kv;
  }
}

// Column owned by (tx, j): float4 groups 64 columns apart keep the staged-V
// reads of a quarter warp on consecutive 16-byte words.
template <int TR>
__device__ __forceinline__ int col_of(int tx, int j) {
  if constexpr (TR == 1) return tx;
  else return (j >> 2) * 64 + tx * 4 + (j & 3);
}

// acc[i][j] += sum over n of K[m][n] * V[vrow0 + n][col], output row
// m = ty*4+i. Starts with a barrier, so the caller's tile build is complete
// before use.
template <int TR>
__device__ inline void contract(const Smem& s, const float* __restrict__ v,
                                int nv, int r, int r0, int vrow0, float (&acc)[4][TR]) {
  constexpr int RCH = 16 * TR;
  const int tx = threadIdx.x & 15, ty = threadIdx.x >> 4;
  for (int kc = 0; kc < T; kc += KC) {
    __syncthreads();
    for (int idx = threadIdx.x; idx < KC * RCH; idx += THREADS) {
      const int row = idx / RCH, col = idx - row * RCH;
      const int g = vrow0 + kc + row, c = r0 + col;
      s.vs[idx] = (g < nv && c < r) ? v[(size_t)g * r + c] : 0.0f;
    }
    __syncthreads();
#pragma unroll 4
    for (int k = 0; k < KC; ++k) {
      const float4 q = *reinterpret_cast<const float4*>(&s.ks[(kc + k) * KPAD + ty * 4]);
      const float kr[4] = {q.x, q.y, q.z, q.w};
      float vv[TR];
      if constexpr (TR == 1) {
        vv[0] = s.vs[k * RCH + tx];
      } else {
#pragma unroll
        for (int g4 = 0; g4 < TR / 4; ++g4) {
          const float4 q = *reinterpret_cast<const float4*>(&s.vs[k * RCH + g4 * 64 + tx * 4]);
          vv[g4 * 4 + 0] = q.x; vv[g4 * 4 + 1] = q.y;
          vv[g4 * 4 + 2] = q.z; vv[g4 * 4 + 3] = q.w;
        }
      }
#pragma unroll
      for (int i = 0; i < 4; ++i)
#pragma unroll
        for (int j = 0; j < TR; ++j) acc[i][j] = fmaf(kr[i], vv[j], acc[i][j]);
    }
  }
}

// Write a 64-row block of the accumulators into out (n, r).
template <int TR>
__device__ inline void store(float* __restrict__ out, const float (&acc)[4][TR],
                             int n, int r, int row0, int r0) {
  const int tx = threadIdx.x & 15, ty = threadIdx.x >> 4;
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int g = row0 + ty * 4 + i;
    if (g >= n) continue;
#pragma unroll
    for (int j = 0; j < TR; ++j) {
      const int c = r0 + col_of<TR>(tx, j);
      if (c >= r) continue;
      out[(size_t)g * r + c] = acc[i][j];
    }
  }
}

// B2. Block (x, y, z): row tile x, column chunk y of R, column-tile split z.
// Each block sweeps its column tiles with the accumulators in registers and
// writes its partial sum to out + z * n1 * r (z > 0 only when the caller
// asked for a split, which kmv_reduce then sums in a fixed order). WIDE
// (d > STAGED_DIM): each tile is built by build_tile_wide.
template <int KERN, int TR, bool WIDE>
__global__ void __launch_bounds__(THREADS)
kmv_dense_kernel(const float* __restrict__ a, const float* __restrict__ b,
                 const float* __restrict__ v, float* __restrict__ out, const Hyper hyp,
                 int n1, int n2, int d, int r, int square, int tiles_per_split) {
  extern __shared__ float4 smem4[];
  const Smem s = carve(reinterpret_cast<float*>(smem4), d, TR);
  const float var = hyper::variance(hyp), noise = hyper::noise(hyp);
  const int row0 = blockIdx.x * T;
  const int r0 = blockIdx.y * 16 * TR;
  const int ntiles = (n2 + T - 1) / T;
  const int jt0 = blockIdx.z * tiles_per_split;
  const int jt1 = min(ntiles, jt0 + tiles_per_split);

  hyper::stage_lengthscales(hyp, d, s.ls);
  __syncthreads();
  if constexpr (!WIDE) {
    load_coords(a, n1, d, row0, s.ls, s.as);
    __syncthreads();
    if (threadIdx.x < T) norms(s.as, d, s.a2, threadIdx.x);
  }

  float acc[4][TR] = {};
  for (int jt = jt0; jt < jt1; ++jt) {
    const int col0 = jt * T;
    if constexpr (WIDE) {
      build_tile_wide<KERN>(s, a, b, d, row0, col0, n1, n2, var, noise, square != 0);
      contract<TR>(s, v, n2, r, r0, col0, acc);
      continue;
    }
    __syncthreads();  // the previous tile's readers are done with bs / ks
    load_coords(b, n2, d, col0, s.ls, s.bs);
    __syncthreads();
    if (threadIdx.x < T) norms(s.bs, d, s.b2, threadIdx.x);
    __syncthreads();
    build_tile<KERN>(s, d, row0, col0, n1, n2, var, noise, square != 0);
    contract<TR>(s, v, n2, r, r0, col0, acc);
  }
  store<TR>(out + (size_t)blockIdx.z * n1 * r, acc, n1, r, row0, r0);
}

// out[e] = sum_z parts[z][e], z ascending: the split sum in a fixed order.
__global__ void kmv_reduce_kernel(const float* __restrict__ parts,
                                  float* __restrict__ out, size_t count,
                                  int splits) {
  for (size_t e = blockIdx.x * (size_t)blockDim.x + threadIdx.x; e < count;
       e += (size_t)gridDim.x * blockDim.x) {
    float acc = 0.0f;
    for (int z = 0; z < splits; ++z) acc += parts[(size_t)z * count + e];
    out[e] = acc;
  }
}

// ------------------------------------------------------------- ROWS

constexpr int RB = 64;  // rows per block, one per thread; also points per stage

__device__ __forceinline__ void ld8(float (&dst)[8], const float* p) {
  const float4 a = *reinterpret_cast<const float4*>(p);
  const float4 b = *reinterpret_cast<const float4*>(p + 4);
  dst[0] = a.x; dst[1] = a.y; dst[2] = a.z; dst[3] = a.w;
  dst[4] = b.x; dst[5] = b.y; dst[6] = b.z; dst[7] = b.w;
}

// A staged point's record: dp scaled coordinates (d padded with zeros to a
// multiple of 8), then [norm, V (RT == 1), 0, 0], then for RT > 1 the RT
// values of V (zeros past r).
__host__ __device__ constexpr int rows_tail(int rt) { return 4 + (rt == 1 ? 0 : rt); }

// floats of shared memory: the stage's records, the rows' coordinates past
// the first 8 (stride dp - 4: an odd number of 16-byte units, so a quarter
// warp's loads hit distinct banks), the lengthscales
__host__ __device__ inline size_t rows_smem_floats(int dp, int rt) {
  return (size_t)RB * (dp + rows_tail(rt)) + (dp > 8 ? (size_t)RB * (dp - 4) : 0) + dp;
}

// The thread's row against the stage's RB records, in order.
template <int KERN, int RT, bool DIAG>
__device__ __forceinline__ void rows_sweep(const float* recs, int rec, int dp,
                                           const float (&xa)[8], const float* xrest, float am,
                                           int gm, int col0, float var, float noise,
                                           float (&acc)[RT]) {
#pragma unroll 4
  for (int p = 0; p < RB; ++p) {
    const float* const rc = recs + p * rec;
    float cb[8];
    ld8(cb, rc);
    float dot = 0.0f;
#pragma unroll
    for (int c = 0; c < 8; ++c) dot = fmaf(xa[c], cb[c], dot);
    for (int c8 = 8; c8 < dp; c8 += 8) {
      float ra[8];
      ld8(ra, xrest + c8 - 8);
      ld8(cb, rc + c8);
#pragma unroll
      for (int c = 0; c < 8; ++c) dot = fmaf(ra[c], cb[c], dot);
    }
    const float4 t = *reinterpret_cast<const float4*>(rc + dp);
    const float r2 = fmaxf(am + t.x - 2.0f * dot, 0.0f);
    float kv = covariance<KERN>(r2, var);
    if (DIAG && gm == col0 + p) kv += noise;
    if constexpr (RT == 1) {
      acc[0] = fmaf(kv, t.y, acc[0]);
    } else {
#pragma unroll
      for (int g4 = 0; g4 < RT / 4; ++g4) {
        const float4 q = *reinterpret_cast<const float4*>(rc + dp + 4 + 4 * g4);
        acc[4 * g4 + 0] = fmaf(kv, q.x, acc[4 * g4 + 0]);
        acc[4 * g4 + 1] = fmaf(kv, q.y, acc[4 * g4 + 1]);
        acc[4 * g4 + 2] = fmaf(kv, q.z, acc[4 * g4 + 2]);
        acc[4 * g4 + 3] = fmaf(kv, q.w, acc[4 * g4 + 3]);
      }
    }
  }
}

// Block (x, y): chunk x of the column points (stages [x per, x per + per) of
// RB points), rows [RB y, RB y + RB), thread t row RB y + t. Writes its
// partial sums to slot x of out (n1 x r floats a slot).
template <int KERN, int RT>
__global__ void __launch_bounds__(RB)
kmv_rows_kernel(const float* __restrict__ a, const float* __restrict__ b,
                const float* __restrict__ v, float* __restrict__ out, const Hyper hyp, int n1,
                int n2, int d, int dp, int r, int square, int per) {
  extern __shared__ float4 smem4[];
  float* const recs = reinterpret_cast<float*>(smem4);
  const int rec = dp + rows_tail(RT), xs = dp - 4;
  float* const rows = recs + RB * rec;
  float* const ls = rows + (dp > 8 ? RB * xs : 0);
  const float var = hyper::variance(hyp), noise = hyper::noise(hyp);
  const int tid = threadIdx.x;
  const int row0 = blockIdx.y * RB, gm = row0 + tid;
  for (int c = tid; c < dp; c += RB) ls[c] = c < d ? hyper::lengthscale(hyp, c) : 1.0f;
  __syncthreads();

  // the thread's row: scaled coordinates and their norm, by the dot's chain
  float xa[8];
  float am = 0.0f;
  float* const xrest = rows + tid * xs;
#pragma unroll
  for (int c = 0; c < 8; ++c) {
    xa[c] = (gm < n1 && c < d) ? __fdiv_rn(a[(size_t)gm * d + c], ls[c]) : 0.0f;
    am = fmaf(xa[c], xa[c], am);
  }
  for (int c = 8; c < dp; ++c) {
    const float val = (gm < n1 && c < d) ? __fdiv_rn(a[(size_t)gm * d + c], ls[c]) : 0.0f;
    xrest[c - 8] = val;
    am = fmaf(val, val, am);
  }

  float acc[RT];
#pragma unroll
  for (int c = 0; c < RT; ++c) acc[c] = 0.0f;
  const int stages = (n2 + RB - 1) / RB;
  const int t0 = blockIdx.x * per, t1 = min(stages, t0 + per);
  for (int t = t0; t < t1; ++t) {
    const int col0 = t * RB, gn = col0 + tid;
    __syncthreads();  // the previous stage's readers are done with recs
    float* const rc = recs + tid * rec;
    float bn = 0.0f;
    for (int c = 0; c < dp; ++c) {
      const float val = (gn < n2 && c < d) ? __fdiv_rn(b[(size_t)gn * d + c], ls[c]) : 0.0f;
      rc[c] = val;
      bn = fmaf(val, val, bn);
    }
    rc[dp] = bn;
    rc[dp + 1] = (RT == 1 && gn < n2) ? v[(size_t)gn * r] : 0.0f;
    rc[dp + 2] = rc[dp + 3] = 0.0f;
    if constexpr (RT > 1) {
#pragma unroll
      for (int c = 0; c < RT; ++c)
        rc[dp + 4 + c] = (gn < n2 && c < r) ? v[(size_t)gn * r + c] : 0.0f;
    }
    __syncthreads();
    // a point past n2 carries V = 0, so it adds nothing; only a stage that
    // crosses this block's rows on the diagonal pays for the noise check
    if (square && col0 < row0 + RB && row0 < col0 + RB)
      rows_sweep<KERN, RT, true>(recs, rec, dp, xa, xrest, am, gm, col0, var, noise, acc);
    else
      rows_sweep<KERN, RT, false>(recs, rec, dp, xa, xrest, am, gm, col0, var, noise, acc);
  }
  if (gm < n1) {
    float* const dst = out + ((size_t)blockIdx.x * n1 + gm) * r;
#pragma unroll
    for (int c = 0; c < RT; ++c)
      if (c < r) dst[c] = acc[c];
  }
}

// out[e] = sum over slots k of parts[k][e]: one warp per element, lane l adds
// slots l, l + 32, ... in order, then a fixed butterfly joins the lanes.
__global__ void __launch_bounds__(THREADS)
kmv_rows_reduce_kernel(const float* __restrict__ parts, float* __restrict__ out, int count,
                       int slots) {
  const int e = (int)((blockIdx.x * (size_t)blockDim.x + threadIdx.x) >> 5);
  const int lane = threadIdx.x & 31;
  if (e >= count) return;
  float acc = 0.0f;
  for (int k = lane; k < slots; k += 32) acc += parts[(size_t)k * count + e];
#pragma unroll
  for (int off = 16; off > 0; off >>= 1) acc += __shfl_xor_sync(0xffffffffu, acc, off);
  if (lane == 0) out[e] = acc;
}

template <int KERN, int RT>
cudaError_t launch_rows(const float* a, const float* b, const float* v, float* out,
                        float* parts, const Hyper& hyp, int n1, int n2, int d, int r, int square,
                        int splits, cudaStream_t stream) {
  static size_t granted[hyper::MAX_DEVICES] = {};
  const int dp = (d + 7) / 8 * 8;
  const size_t bytes = rows_smem_floats(dp, RT) * sizeof(float);
  cudaError_t err = hyper::ensure_smem(kmv_rows_kernel<KERN, RT>, bytes, granted);
  if (err != cudaSuccess) return err;
  const int stages = (n2 + RB - 1) / RB;
  const int per = (stages + splits - 1) / splits;
  const dim3 grid(splits, (n1 + RB - 1) / RB);
  kmv_rows_kernel<KERN, RT><<<grid, RB, bytes, stream>>>(
      a, b, v, splits > 1 ? parts : out, hyp, n1, n2, d, dp, r, square, per);
  err = cudaGetLastError();
  if (err != cudaSuccess || splits == 1) return err;
  const int count = n1 * r;
  kmv_rows_reduce_kernel<<<(count + THREADS / 32 - 1) / (THREADS / 32), THREADS, 0, stream>>>(
      parts, out, count, splits);
  return cudaGetLastError();
}

// ------------------------------------------------------------ launch

inline int elementwise_blocks(size_t count) {
  const size_t blocks = (count + THREADS - 1) / THREADS;
  return (int)(blocks < 4096 ? (blocks > 0 ? blocks : 1) : 4096);
}

template <int KERN, int TR, bool WIDE>
cudaError_t launch_tiles(const float* a, const float* b, const float* v, float* out,
                         float* parts, const Hyper& hyp, int n1, int n2, int d, int r,
                         int square, int splits, cudaStream_t stream) {
  static size_t granted[hyper::MAX_DEVICES] = {};
  const size_t bytes = smem_floats(d, TR) * sizeof(float);
  cudaError_t err = hyper::ensure_smem(kmv_dense_kernel<KERN, TR, WIDE>, bytes, granted);
  if (err != cudaSuccess) return err;
  const int ntiles = (n2 + T - 1) / T;
  const int per = (ntiles + splits - 1) / splits;
  const dim3 grid((n1 + T - 1) / T, (r + 16 * TR - 1) / (16 * TR), splits);
  kmv_dense_kernel<KERN, TR, WIDE><<<grid, THREADS, bytes, stream>>>(
      a, b, v, splits > 1 ? parts : out, hyp, n1, n2, d, r, square, per);
  err = cudaGetLastError();
  if (err != cudaSuccess || splits == 1) return err;
  const size_t count = (size_t)n1 * r;
  kmv_reduce_kernel<<<elementwise_blocks(count), THREADS, 0, stream>>>(parts, out, count,
                                                                      splits);
  return cudaGetLastError();
}

template <int KERN, int TR>
cudaError_t launch_dense(const float* a, const float* b, const float* v, float* out,
                         float* parts, const Hyper& hyp, int n1, int n2, int d, int r,
                         int square, int splits, cudaStream_t stream) {
  if (d > hyper::STAGED_DIM)
    return launch_tiles<KERN, TR, true>(a, b, v, out, parts, hyp, n1, n2, d, r, square, splits,
                                        stream);
  return launch_tiles<KERN, TR, false>(a, b, v, out, parts, hyp, n1, n2, d, r, square, splits,
                                       stream);
}

// ROWS: V columns held per thread, 1, 4, 8 or 16 (R <= 16). TILES: columns
// per thread, 1 (R <= 16), 4 (R <= 64) or 16 (256 columns a block).
template <int KERN>
cudaError_t dispatch(const float* a, const float* b, const float* v, float* out, float* parts,
                     const Hyper& hyp, int n1, int n2, int d, int r, int square, int rows,
                     int splits, cudaStream_t st) {
#define GPRAS_KMV_ARGS a, b, v, out, parts, hyp, n1, n2, d, r, square, splits, st
  if (rows) {  // a thread holds its row's coordinates: up to STAGED_DIM of them
    if (d > hyper::STAGED_DIM) return cudaErrorInvalidValue;
    if (r == 1) return launch_rows<KERN, 1>(GPRAS_KMV_ARGS);
    if (r <= 4) return launch_rows<KERN, 4>(GPRAS_KMV_ARGS);
    if (r <= 8) return launch_rows<KERN, 8>(GPRAS_KMV_ARGS);
    if (r <= 16) return launch_rows<KERN, 16>(GPRAS_KMV_ARGS);
    return cudaErrorInvalidValue;
  }
  if (r <= 16) return launch_dense<KERN, 1>(GPRAS_KMV_ARGS);
  if (r <= 64) return launch_dense<KERN, 4>(GPRAS_KMV_ARGS);
  return launch_dense<KERN, 16>(GPRAS_KMV_ARGS);
#undef GPRAS_KMV_ARGS
}

}  // namespace

extern "C" {

// out (n1, r) = K(a, b) @ v [+ noise * v on the diagonal when square].
// a (n1, d), b (n2, d), v (n2, r): contiguous fp32, raw coordinates.
// log_var, log_ls (d floats ls_stride apart), noise: hyper.cuh's Hyper. rows
// selects the design (1: ROWS, r <= 16; 0: TILES); splits: blocks along the
// column sweep. parts: scratch of splits * n1 * r floats when splits > 1
// (unused otherwise).
int gpras_kmv_dense(int kern, const void* a, const void* b, const void* v, void* out,
                    void* parts, const void* log_var, const void* log_ls, int ls_stride,
                    const void* noise_p, float noise_v, int n1, int n2, int d, int r, int square,
                    int rows, int splits, void* stream) {
  if (n1 < 1 || n2 < 1 || d < 1 || r < 1 || splits < 1) return (int)cudaErrorInvalidValue;
  const float* A = static_cast<const float*>(a);
  const float* B = static_cast<const float*>(b);
  const float* V = static_cast<const float*>(v);
  float* O = static_cast<float*>(out);
  float* P = static_cast<float*>(parts);
  const Hyper hyp{static_cast<const float*>(log_var), static_cast<const float*>(log_ls),
                  ls_stride, static_cast<const float*>(noise_p), noise_v};
  cudaStream_t st = static_cast<cudaStream_t>(stream);
#define GPRAS_KMV_DISPATCH(K) \
  dispatch<K>(A, B, V, O, P, hyp, n1, n2, d, r, square, rows, splits, st)
  switch (kern) {
    case RBF: return GPRAS_KMV_DISPATCH(RBF);
    case MATERN12: return GPRAS_KMV_DISPATCH(MATERN12);
    case MATERN32: return GPRAS_KMV_DISPATCH(MATERN32);
    case MATERN52: return GPRAS_KMV_DISPATCH(MATERN52);
    case EXPONENTIAL: return GPRAS_KMV_DISPATCH(EXPONENTIAL);
    default: return (int)cudaErrorInvalidValue;
  }
#undef GPRAS_KMV_DISPATCH
}

}  // extern "C"
