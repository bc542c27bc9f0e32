// Fused stationary-covariance matvec kernel B2 for Hopper (sm_90a).
//
// Replaces _kmv_body of gpras_tpu/ops/pallas_gram.py (:84-149, launcher
// pallas_kmv :466-480): (K(a, b) [+ noise I when square]) @ V from
// lengthscale-pre-scaled coordinates without ever storing a covariance tile
// in device memory. The symmetric body (B3) is csrc/kmv_sym.cu.
//
// What bounds it on an H100: at the serving shape (256 queries against
// N = 49,152, D = 8, R = 1) one call evaluates ~1.3e7 covariance entries, each
// ~28 fp32 operations plus a sqrt and an exp, against 2 for the contraction
// and O(N D) bytes: it is bound by the entries' operations. The design keeps
// each 64 x 64 covariance tile in shared memory, builds it once, and contracts
// it with V in a register-blocked fp32 FMA loop (4 x TR outputs per thread).
// The posterior-mean call has only 1 or 4 row tiles for 132 SMs, so the
// column sweep is split over blocks and the partial sums are added in a fixed
// order by a second kernel. On an H100 80GB HBM3 at 700 W that is 24x faster
// than one block per row tile (0.16 vs 4.1 ms), and the two-level sum is more
// exact: one fp32 accumulator over 49,152 terms left ~7e-6 of the result's
// scale, the split ~1e-6 (PERF.md).
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

#include "stationary.cuh"

namespace {

using namespace stationary;

constexpr int T = 64;            // covariance tile edge (rows and columns)
constexpr int THREADS = 256;     // 16 x 16 threads; each owns 4 rows x TR columns
constexpr int KC = 16;           // rows of V staged in shared memory per step
constexpr int KPAD = T + 4;      // padded tile row: float4-aligned, fewer bank conflicts

// Shared-memory carve-up. Ks comes first so its float4 reads stay aligned.
struct Smem {
  float* ks;  // [T][KPAD]  ks[n * KPAD + m] = k(a_m, b_n)
  float* vs;  // [KC][16 * TR] staged rows of V
  float* as;  // [d][T] row-tile coordinates, transposed
  float* bs;  // [d][T] column-tile coordinates, transposed
  float* a2;  // [T] squared norms of the row tile
  float* b2;  // [T] squared norms of the column tile
};

__host__ __device__ inline size_t smem_floats(int d, int tr) {
  return (size_t)T * KPAD + (size_t)KC * 16 * tr + 2 * (size_t)d * T + 2 * T;
}

__device__ inline Smem carve(float* base, int d, int tr) {
  Smem s;
  s.ks = base;
  s.vs = s.ks + T * KPAD;
  s.as = s.vs + KC * 16 * tr;
  s.bs = s.as + d * T;
  s.a2 = s.bs + d * T;
  s.b2 = s.a2 + T;
  return s;
}

// Stage rows [row0, row0 + T) of x (n, d) into dst[d][T]; rows past n are 0.
__device__ inline void load_coords(const float* __restrict__ x, int n, int d,
                                   int row0, float* dst) {
  for (int idx = threadIdx.x; idx < T * d; idx += THREADS) {
    const int row = idx / d, col = idx - row * d;
    const int g = row0 + row;
    dst[col * T + row] = g < n ? x[(size_t)g * d + col] : 0.0f;
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
// asked for a split, which kmv_reduce then sums in a fixed order).
template <int KERN, int TR>
__global__ void __launch_bounds__(THREADS)
kmv_dense_kernel(const float* __restrict__ a, const float* __restrict__ b,
                 const float* __restrict__ v, float* __restrict__ out,
                 const float* __restrict__ var_p, const float* __restrict__ noise_p,
                 int n1, int n2, int d, int r, int square, int tiles_per_split) {
  extern __shared__ float4 smem4[];
  const Smem s = carve(reinterpret_cast<float*>(smem4), d, TR);
  const float var = *var_p, noise = *noise_p;
  const int row0 = blockIdx.x * T;
  const int r0 = blockIdx.y * 16 * TR;
  const int ntiles = (n2 + T - 1) / T;
  const int jt0 = blockIdx.z * tiles_per_split;
  const int jt1 = min(ntiles, jt0 + tiles_per_split);

  load_coords(a, n1, d, row0, s.as);
  __syncthreads();
  if (threadIdx.x < T) norms(s.as, d, s.a2, threadIdx.x);

  float acc[4][TR] = {};
  for (int jt = jt0; jt < jt1; ++jt) {
    const int col0 = jt * T;
    __syncthreads();  // the previous tile's readers are done with bs / ks
    load_coords(b, n2, d, col0, s.bs);
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

inline int elementwise_blocks(size_t count) {
  const size_t blocks = (count + THREADS - 1) / THREADS;
  return (int)(blocks < 4096 ? (blocks > 0 ? blocks : 1) : 4096);
}

template <int KERN, int TR>
cudaError_t launch_dense(const float* a, const float* b, const float* v, float* out,
                         float* parts, const float* var, const float* noise,
                         int n1, int n2, int d, int r, int square, int splits,
                         cudaStream_t stream) {
  const size_t bytes = smem_floats(d, TR) * sizeof(float);
  cudaError_t err = cudaFuncSetAttribute(kmv_dense_kernel<KERN, TR>,
                                         cudaFuncAttributeMaxDynamicSharedMemorySize,
                                         (int)bytes);
  if (err != cudaSuccess) return err;
  const int ntiles = (n2 + T - 1) / T;
  const int per = (ntiles + splits - 1) / splits;
  const dim3 grid((n1 + T - 1) / T, (r + 16 * TR - 1) / (16 * TR), splits);
  kmv_dense_kernel<KERN, TR><<<grid, THREADS, bytes, stream>>>(
      a, b, v, splits > 1 ? parts : out, var, noise, n1, n2, d, r, square, per);
  err = cudaGetLastError();
  if (err != cudaSuccess || splits == 1) return err;
  const size_t count = (size_t)n1 * r;
  kmv_reduce_kernel<<<elementwise_blocks(count), THREADS, 0, stream>>>(parts, out, count,
                                                                      splits);
  return cudaGetLastError();
}

// Columns per thread: 1 (R <= 16), 4 (R <= 64) or 16 (256 columns a block).
template <int KERN>
cudaError_t dense_tr(const float* a, const float* b, const float* v, float* out,
                     float* parts, const float* var, const float* noise, int n1,
                     int n2, int d, int r, int square, int splits, cudaStream_t st) {
  if (r <= 16)
    return launch_dense<KERN, 1>(a, b, v, out, parts, var, noise, n1, n2, d, r, square, splits, st);
  if (r <= 64)
    return launch_dense<KERN, 4>(a, b, v, out, parts, var, noise, n1, n2, d, r, square, splits, st);
  return launch_dense<KERN, 16>(a, b, v, out, parts, var, noise, n1, n2, d, r, square, splits, st);
}

}  // namespace

extern "C" {

// out (n1, r) = K(a, b) @ v [+ noise * v on the diagonal when square].
// a (n1, d), b (n2, d), v (n2, r): contiguous fp32, lengthscale-pre-scaled
// coordinates. var, noise: one fp32 each, in device memory. parts: scratch of
// splits * n1 * r floats when splits > 1 (unused otherwise).
int gpras_kmv_dense(int kern, const void* a, const void* b, const void* v, void* out,
                    void* parts, const void* var, const void* noise, int n1, int n2,
                    int d, int r, int square, int splits, void* stream) {
  const float* A = static_cast<const float*>(a);
  const float* B = static_cast<const float*>(b);
  const float* V = static_cast<const float*>(v);
  float* O = static_cast<float*>(out);
  float* P = static_cast<float*>(parts);
  const float* VAR = static_cast<const float*>(var);
  const float* NZ = static_cast<const float*>(noise);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  switch (kern) {
    case RBF: return dense_tr<RBF>(A, B, V, O, P, VAR, NZ, n1, n2, d, r, square, splits, st);
    case MATERN12: return dense_tr<MATERN12>(A, B, V, O, P, VAR, NZ, n1, n2, d, r, square, splits, st);
    case MATERN32: return dense_tr<MATERN32>(A, B, V, O, P, VAR, NZ, n1, n2, d, r, square, splits, st);
    case MATERN52: return dense_tr<MATERN52>(A, B, V, O, P, VAR, NZ, n1, n2, d, r, square, splits, st);
    case EXPONENTIAL: return dense_tr<EXPONENTIAL>(A, B, V, O, P, VAR, NZ, n1, n2, d, r, square, splits, st);
    default: return (int)cudaErrorInvalidValue;
  }
}

}  // extern "C"
