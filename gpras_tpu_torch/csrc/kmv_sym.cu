// Symmetric fused covariance matvec (B3) for Hopper (sm_90a).
//
// Replaces _kmv_sym_body of gpras_tpu/ops/pallas_gram.py (:152-257, launcher
// pallas_kmv :376-464): out (n, r) = (K(x, x) + noise I) @ V from raw
// coordinates x (n, d), which the prep grid divides by the lengthscales
// (hyper.cuh), and V (n, r), without storing a covariance tile in device
// memory. It is the matvec of every CG iteration of
// the served posterior (gp/exact_cg.kmv).
//
// What bounds it on an H100, at the serving shapes (n = 49,152, d = 8):
// - R > 16 (the variance solves of a 64- or 256-query bucket): the
//   contraction, 2 n^2 R = 1.24e12 operations at R = 256, against ~28 fp32
//   operations, a sqrt and an exp per covariance entry (6.8e10 for the whole
//   square). The CUDA cores do fp32 at 67 TFLOP/s, the tensor cores TF32 at
//   495; so the contraction runs on the tensor cores.
// - R <= 16 (the alpha solve, R = 1): the entries themselves, 2 operations of
//   contraction against ~28 of build per entry.
//
// Two designs, picked by the wrapper (ops/fused_gram.kmv_sym) from R:
//
// TC, R > 16: one grid over blocks of 128 output rows x (64 or 256) columns
//   of V. A block sweeps all n column points in stages of 32, staged in
//   shared memory by cp.async two stages deep (the next stage's copy overlaps
//   this stage's build and contraction), keeps its 128 x 64 or 128 x 256
//   accumulators in registers and writes each output element once. Each warp
//   owns 16 rows and builds its covariance entries straight into the A
//   fragments of mma.sync.m16n8k8 (row-major TF32), so a tile never passes
//   through shared memory and every entry is built once per block. The full
//   square is built: symmetry would save only builds, ~5% of the operations
//   at R = 256, and would bring back a cross-block reduction. When the row
//   blocks fill fewer than two waves of the card (the 64-column build at
//   n = 49,152: 384 blocks for 264 resident) the plan splits the column
//   sweep in two and kmv_split_reduce_kernel adds the partial sums in a
//   fixed order: 9.5 against 9.9 ms unsplit there.
//   Measured on an H100 80GB HBM3 at 700 W (PERF.md), n = 49,152, Matern52:
//   25.7 ms at R = 256, 9.5 ms at R = 64. The time adds up from the entries
//   (~4.8 ms for the square) and the mma.sync products (~5.1 ms per 64
//   columns), which the same warps issue; wgmma with warp specialization is
//   the next step.
//
//   3xTF32: this is the package's one sanctioned use of TF32 (everything else
//   keeps allow_tf32 = False). Both operands are split with cvt.rna.tf32.f32,
//   hi = tf32(a), lo = tf32(a - hi), and the product is accumulated in fp32
//   as K_lo V_hi + K_hi V_lo + K_hi V_hi: the Hopper counterpart of the TPU
//   body's bf16_3x (pallas_gram.py:240-248). Each product then misses only
//   K_lo V_lo, ~2^-22 of it (one TF32 pass: ~2^-11). V is split once per call
//   by prep_kernel into a layout in which a thread's B fragments are
//   contiguous (16-byte shared-memory loads, no bank conflicts).
//
// SYM, R <= 16: upper-triangle 64 x 64 tiles, each built once and contracted
//   twice. Block p walks row tiles p and nb - 1 - p (nb + 1 tiles either
//   way: the triangle is balanced), each as a sweep j = i .. nb - 1 with the
//   row sums K_ij V_j in registers. Each strictly-upper tile writes its
//   mirror contribution K_ij^T V_i to a slot of its own, the row sums go to
//   the diagonal slot, and kmv_sym_reduce_kernel adds row tile j's slots
//   (i = 0 .. j, in that order). Coordinates and V are staged by cp.async two
//   stages deep.
//
// Inputs wider than STAGED_DIM = 128 dimensions (hyper.cuh; WIDE): both builds
// stage the first 128 coordinates of each point and read the rest from xp in
// device memory (the L1 cache) where the dot product reaches them.
//
// Both are deterministic, bit for bit, run to run: every sum has a fixed
// order, no float atomics, no read-modify-write of device memory.
//
// Numerics follow _tile_value (:35-74) verbatim: r2 = max(a2 + b2 - 2ab, 0)
// with the D-wide dot and the norms accumulated in full fp32 by the same FMA
// chain (so coincident points give r2 == 0 exactly; prep_kernel zero-pads the
// coordinates to a multiple of 8, which adds exact zeros to that chain), the
// five stationary tails (stationary.cuh), and the noise on the global
// diagonal.
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

constexpr int THREADS = 256;  // 8 warps
constexpr int BM = 128;       // TC: output rows per block (8 warps x 16)
constexpr int BK = 32;        // TC: column points per stage (4 mma k-steps)
constexpr int ST = 64;        // SYM: tile edge

// ------------------------------------------------------------------ PTX

__device__ __forceinline__ uint32_t to_tf32(float x) {
  uint32_t r;
  asm("cvt.rna.tf32.f32 %0, %1;\n" : "=r"(r) : "f"(x));
  return r;
}

// d += a (16 x 8, row) b (8 x 8, col), TF32 in, fp32 accumulate
__device__ __forceinline__ void mma_tf32(float (&d)[4], const uint32_t (&a)[4], float b0,
                                         float b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k8.row.col.f32.tf32.tf32.f32 "
      "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(__float_as_uint(b0)),
        "r"(__float_as_uint(b1)));
}

__device__ __forceinline__ void cp16(float* smem, const float* gmem) {
  const uint32_t s = static_cast<uint32_t>(__cvta_generic_to_shared(smem));
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n" ::"r"(s), "l"(gmem));
}

__device__ __forceinline__ void cp_commit() { asm volatile("cp.async.commit_group;\n" ::); }

// all but the newest group have landed (this thread's copies)
__device__ __forceinline__ void cp_wait_prev() {
  asm volatile("cp.async.wait_group 1;\n" ::: "memory");
}

__device__ __forceinline__ void ld8(float (&dst)[8], const float* p) {
  const float4 a = *reinterpret_cast<const float4*>(p);
  const float4 b = *reinterpret_cast<const float4*>(p + 4);
  dst[0] = a.x; dst[1] = a.y; dst[2] = a.z; dst[3] = a.w;
  dst[4] = b.x; dst[5] = b.y; dst[6] = b.z; dst[7] = b.w;
}

__device__ __forceinline__ void ldg8(float (&dst)[8], const float* p) {
  const float4 a = __ldg(reinterpret_cast<const float4*>(p));
  const float4 b = __ldg(reinterpret_cast<const float4*>(p + 4));
  dst[0] = a.x; dst[1] = a.y; dst[2] = a.z; dst[3] = a.w;
  dst[4] = b.x; dst[5] = b.y; dst[6] = b.z; dst[7] = b.w;
}

// One covariance entry (global row gm, global column gn) from its norms and
// dot product; with EDGE, noise on the diagonal and 0 for a column past n
// (a caller that knows its entries are off the diagonal and inside n skips
// both).
template <int KERN, bool EDGE = true>
__device__ __forceinline__ float entry(float am, float bn, float dot, int gm, int gn, int n,
                                       float var, float noise) {
  const float r2 = fmaxf(am + bn - 2.0f * dot, 0.0f);
  float kv = covariance<KERN>(r2, var);
  if (!EDGE) return kv;
  if (gm == gn) kv += noise;
  return gn < n ? kv : 0.0f;
}

// ----------------------------------------------------------- prep (both)

// xp (npad, dp): x divided by the lengthscales, zero-padded; nrm (npad): its
// squared norms by the dot's FMA chain; vbuf: V laid out for the main kernel, zero outside (n, r):
//   split (TC, width = nt): [chunk][npad / 8][4][8][2][nt][2]; element
//     (s, t, g, h, q, p) is part h (0: tf32 hi, 1: tf32 lo) of
//     V[8 s + t + 4 p][chunk * 8 nt + 8 q + g]: the B fragment pair (b0, b1)
//     of lane (g, t) for n-tile q of k-step s, all n-tiles side by side
//   plain (SYM, width = rs): [chunk][npad][rs]; element (k, q) is
//     V[k][chunk * rs + q]
__global__ void prep_kernel(const float* __restrict__ x, const float* __restrict__ v,
                            float* __restrict__ xp, float* __restrict__ nrm,
                            float* __restrict__ vbuf, const Hyper hyp, int n, int npad, int d,
                            int dp, int r, int width, int split, size_t vcount) {
  const size_t stride = (size_t)gridDim.x * blockDim.x;
  const size_t start = blockIdx.x * (size_t)blockDim.x + threadIdx.x;
  for (size_t e = start; e < (size_t)npad * dp; e += stride) {
    const int k = (int)(e / dp), c = (int)(e - (size_t)k * dp);
    xp[e] = (k < n && c < d) ? __fdiv_rn(x[(size_t)k * d + c], hyper::lengthscale(hyp, c)) : 0.0f;
  }
  for (size_t k = start; k < (size_t)npad; k += stride) {
    float acc = 0.0f;
    if (k < (size_t)n)
      for (int c = 0; c < d; ++c) {
        const float val = __fdiv_rn(x[k * d + c], hyper::lengthscale(hyp, c));
        acc = fmaf(val, val, acc);
      }
    nrm[k] = acc;
  }
  const int row = split ? 16 * width : width;  // floats per point and chunk
  for (size_t e = start; e < vcount; e += stride) {
    const size_t kr = e / row;  // chunk * npad + k
    const int w = (int)(e - kr * row);
    const int chunk = (int)(kr / npad), k = (int)(kr - (size_t)chunk * npad);
    if (split) {
      // w runs over one point's 16 nt floats; (k, w) -> the k-step's block
      const size_t f = (size_t)k * row + w;  // float within the chunk
      const int s = (int)(f / (128 * width)), o = (int)(f % (128 * width));
      const int t = o / (32 * width), g = (o / (4 * width)) & 7, h = (o / (2 * width)) & 1;
      const int q = (o / 2) % width, p = o & 1;
      const int kk = 8 * s + t + 4 * p, c = chunk * 8 * width + 8 * q + g;
      const float val = (kk < n && c < r) ? v[(size_t)kk * r + c] : 0.0f;
      const float hi = __uint_as_float(to_tf32(val));
      vbuf[e] = h == 0 ? hi : __uint_as_float(to_tf32(val - hi));
    } else {
      const int c = chunk * width + w;
      vbuf[e] = (k < n && c < r) ? v[(size_t)k * r + c] : 0.0f;
    }
  }
}

// ------------------------------------------------------- TC (R > 16)

// A stage of V in shared memory: per k-step and lane (g, t) one run of
// 4 NT floats, the B fragment pairs of every n-tile, hi then lo. Runs of
// lanes (g, t) start GS apart within a t and TS apart across t; in 16-byte
// units GS is 1 and TS 2 modulo 8 (NT a multiple of 8), so a quarter warp's
// 16-byte loads land on 8 distinct bank groups.
template <int NT>
struct Tc {
  static constexpr int GS = 4 * NT + 4;
  static constexpr int TS = 8 * GS + 8;
  static constexpr int V_FLOATS = BK / 8 * 4 * TS;
};

// coordinates staged per point: all dp of them, or the first STAGED_DIM when
// wider (WIDE: the rest are read from xp in device memory)
__host__ __device__ inline int staged_dp(int dp) {
  return dp < hyper::STAGED_DIM ? dp : hyper::STAGED_DIM;
}

// floats of one stage: V, then the column points' sdp staged coordinates and norms
__host__ __device__ inline int tc_stage_floats(int nt, int sdp) {
  const int v_floats = nt == 8 ? Tc<8>::V_FLOATS : Tc<32>::V_FLOATS;
  return v_floats + BK * sdp + BK;
}

// One stage's A fragments of one lane (g, t): for each of the BK / 8
// k-steps, rows gm0 = g and gm0 + 8 against column points t and t + 4 of the
// stage (sdp coordinates each in sx, norms sn, in shared memory), split into
// TF32 hi, lo. WIDE: coordinates sdp .. dp - 1 of the column points come from
// xg, the stage's first point in xp (device memory).
template <int KERN, bool EDGE, bool WIDE>
__device__ __forceinline__ void build_stage(uint32_t (&hi)[BK / 8][4], uint32_t (&lo)[BK / 8][4],
                                            const float* sx, const float* sn,
                                            const float (&xa)[8], const float (&xb)[8],
                                            const float* xr0, const float* xr1,
                                            const float* xg, float am0, float am1, int gm0,
                                            int col0, int t, int dp, int sdp, int n, float var,
                                            float noise) {
#pragma unroll
  for (int ks = 0; ks < BK / 8; ++ks) {
    const int c0 = ks * 8 + t, c1 = c0 + 4;  // this lane's two column points
    float dot[4] = {0.0f, 0.0f, 0.0f, 0.0f};  // (gm0, c0) (gm1, c0) (gm0, c1) (gm1, c1)
    {
      float ca[8], cb[8];
      ld8(ca, sx + c0 * sdp);
      ld8(cb, sx + c1 * sdp);
#pragma unroll
      for (int c = 0; c < 8; ++c) {
        dot[0] = fmaf(xa[c], ca[c], dot[0]);
        dot[1] = fmaf(xb[c], ca[c], dot[1]);
        dot[2] = fmaf(xa[c], cb[c], dot[2]);
        dot[3] = fmaf(xb[c], cb[c], dot[3]);
      }
    }
    for (int c8 = 8; c8 < sdp; c8 += 8) {
      float ra[8], rb[8], ca[8], cb[8];
      ldg8(ra, xr0 + c8);
      ldg8(rb, xr1 + c8);
      ld8(ca, sx + c0 * sdp + c8);
      ld8(cb, sx + c1 * sdp + c8);
#pragma unroll
      for (int c = 0; c < 8; ++c) {
        dot[0] = fmaf(ra[c], ca[c], dot[0]);
        dot[1] = fmaf(rb[c], ca[c], dot[1]);
        dot[2] = fmaf(ra[c], cb[c], dot[2]);
        dot[3] = fmaf(rb[c], cb[c], dot[3]);
      }
    }
    if constexpr (WIDE) {
      for (int c8 = sdp; c8 < dp; c8 += 8) {
        float ra[8], rb[8], ca[8], cb[8];
        ldg8(ra, xr0 + c8);
        ldg8(rb, xr1 + c8);
        ldg8(ca, xg + (size_t)c0 * dp + c8);
        ldg8(cb, xg + (size_t)c1 * dp + c8);
#pragma unroll
        for (int c = 0; c < 8; ++c) {
          dot[0] = fmaf(ra[c], ca[c], dot[0]);
          dot[1] = fmaf(rb[c], ca[c], dot[1]);
          dot[2] = fmaf(ra[c], cb[c], dot[2]);
          dot[3] = fmaf(rb[c], cb[c], dot[3]);
        }
      }
    }
    const int gm1 = gm0 + 8, gn0 = col0 + c0, gn1 = gn0 + 4;
    const float bn0 = sn[c0], bn1 = sn[c1];
    float kv[4];
    kv[0] = entry<KERN, EDGE>(am0, bn0, dot[0], gm0, gn0, n, var, noise);
    kv[1] = entry<KERN, EDGE>(am1, bn0, dot[1], gm1, gn0, n, var, noise);
    kv[2] = entry<KERN, EDGE>(am0, bn1, dot[2], gm0, gn1, n, var, noise);
    kv[3] = entry<KERN, EDGE>(am1, bn1, dot[3], gm1, gn1, n, var, noise);
#pragma unroll
    for (int e = 0; e < 4; ++e) {
      hi[ks][e] = to_tf32(kv[e]);
      lo[ks][e] = to_tf32(kv[e] - __uint_as_float(hi[ks][e]));
    }
  }
}

// Block (x, y, z): output rows [128 x, 128 x + 128), V columns
// [8 NT y, 8 NT y + 8 NT), column points of split z (stages
// [z * per, (z + 1) * per)). Warp w owns rows 16 w .. 16 w + 15 of the
// block; lane (g = lane / 4, t = lane % 4) builds, per 8-point k-step, the
// entries of A fragment registers a0..a3: rows g and g + 8, column points t
// and t + 4. A split writes its partial sums to out + z * n * r (z > 0 only
// when the plan splits, and kmv_split_reduce_kernel then adds them).
//
// Each stage's products are summed on the tensor cores into a fresh partial
// that is then added to the accumulators on the CUDA cores (fp32, round to
// nearest): the tensor cores' fp32 accumulation truncates, and one
// accumulator carried through 18,432 MMAs (n = 49,152) drifted by ~3e-4 of
// the result's scale, against ~1e-6 this way.
template <int KERN, int NT, bool WIDE>
__global__ void __launch_bounds__(THREADS, NT >= 32 ? 1 : 2)
kmv_tc_kernel(const float* __restrict__ xp, const float* __restrict__ nrm,
              const float* __restrict__ vbuf, float* __restrict__ out, const Hyper hyp, int n,
              int npad, int dp, int r, int per) {
  using L = Tc<NT>;
  constexpr int KS = BK / 8;  // mma k-steps per stage
  extern __shared__ float4 smem4[];
  float* const smem = reinterpret_cast<float*>(smem4);
  const int sdp = WIDE ? hyper::STAGED_DIM : dp;  // coordinates staged per point
  const int stage = tc_stage_floats(NT, sdp);
  const float var = hyper::variance(hyp), noise = hyper::noise(hyp);
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int g = lane >> 2, t = lane & 3;
  const int gm0 = blockIdx.x * BM + warp * 16 + g, gm1 = gm0 + 8;
  const float* const vchunk = vbuf + (size_t)blockIdx.y * npad * 16 * NT;
  const float am0 = nrm[gm0], am1 = nrm[gm1];
  const float* const xr0 = xp + (size_t)gm0 * dp;
  const float* const xr1 = xp + (size_t)gm1 * dp;
  float xa[8], xb[8];  // the rows' first 8 coordinates, held for the sweep
  ldg8(xa, xr0);
  ldg8(xb, xr1);

  auto issue = [&](int buf, int kt) {
    float* const sv = smem + buf * stage;
    float* const sx = sv + L::V_FLOATS;
    float* const sn = sx + BK * sdp;
    const int k0 = kt * BK;
    const float* const gv = vchunk + (size_t)k0 * 16 * NT;
    for (int q = threadIdx.x; q < BK * 4 * NT; q += THREADS) {
      const int run = q / NT, w = q - run * NT;  // run = (k-step, t, g); w: its 16-byte chunk
      cp16(sv + (run >> 3) * L::TS + (run & 7) * L::GS + w * 4, gv + (size_t)q * 4);
    }
    if constexpr (WIDE) {  // each point's first sdp coordinates
      for (int q = threadIdx.x; q < BK * sdp / 4; q += THREADS) {
        const int pt = q / (sdp / 4), w = q - pt * (sdp / 4);
        cp16(sx + pt * sdp + w * 4, xp + (size_t)(k0 + pt) * dp + w * 4);
      }
    } else {
      for (int q = threadIdx.x; q < BK * dp / 4; q += THREADS)
        cp16(sx + q * 4, xp + (size_t)k0 * dp + q * 4);
    }
    for (int q = threadIdx.x; q < BK / 4; q += THREADS) cp16(sn + q * 4, nrm + k0 + q * 4);
  };

  float acc[NT][4];
#pragma unroll
  for (int j = 0; j < NT; ++j)
#pragma unroll
    for (int e = 0; e < 4; ++e) acc[j][e] = 0.0f;

  const int kt0 = blockIdx.z * per, kt1 = min(npad / BK, kt0 + per);
  issue(0, kt0);
  cp_commit();
  for (int kt = kt0; kt < kt1; ++kt) {
    const int buf = (kt - kt0) & 1;
    if (kt + 1 < kt1) issue(buf ^ 1, kt + 1);
    cp_commit();
    cp_wait_prev();
    __syncthreads();
    const float* const sv = smem + buf * stage;
    const float* const sx = sv + L::V_FLOATS;
    const float* const sn = sx + BK * sdp;

    // the stage's A fragments first: 4 k-steps x 4 entries, independent.
    // Only a stage that holds a diagonal entry of this warp's rows, or runs
    // past n, pays for those checks.
    uint32_t hi[KS][4], lo[KS][4];
    const int col0 = kt * BK, wrow0 = blockIdx.x * BM + warp * 16;
    const float* const xg = xp + (size_t)col0 * dp;
    if (col0 + BK > n || (wrow0 < col0 + BK && col0 < wrow0 + 16))
      build_stage<KERN, true, WIDE>(hi, lo, sx, sn, xa, xb, xr0, xr1, xg, am0, am1, gm0, col0, t,
                                    dp, sdp, n, var, noise);
    else
      build_stage<KERN, false, WIDE>(hi, lo, sx, sn, xa, xb, xr0, xr1, xg, am0, am1, gm0, col0,
                                     t, dp, sdp, n, var, noise);

    // contract, four n-tiles at a time, each into a fresh partial
#pragma unroll
    for (int q = 0; q < NT / 4; ++q) {
      float part[4][4];
#pragma unroll
      for (int u = 0; u < 4; ++u)
#pragma unroll
        for (int e = 0; e < 4; ++e) part[u][e] = 0.0f;
#pragma unroll
      for (int ks = 0; ks < KS; ++ks) {
        // (b0, b1) pairs of n-tiles 4q .. 4q + 3, hi and lo
        const float* const b = sv + (ks * 4 + t) * L::TS + g * L::GS + 8 * q;
        float bh[8], bl[8];
        ld8(bh, b);
        ld8(bl, b + 2 * NT);
#pragma unroll
        for (int u = 0; u < 4; ++u) mma_tf32(part[u], lo[ks], bh[2 * u], bh[2 * u + 1]);
#pragma unroll
        for (int u = 0; u < 4; ++u) mma_tf32(part[u], hi[ks], bl[2 * u], bl[2 * u + 1]);
#pragma unroll
        for (int u = 0; u < 4; ++u) mma_tf32(part[u], hi[ks], bh[2 * u], bh[2 * u + 1]);
      }
#pragma unroll
      for (int u = 0; u < 4; ++u)
#pragma unroll
        for (int e = 0; e < 4; ++e) acc[4 * q + u][e] += part[u][e];
    }
    __syncthreads();  // every warp is done with this buffer before it is refilled
  }

  // C fragment: c0, c1 row g, columns 2t, 2t + 1; c2, c3 row g + 8
  float* const dst = out + (size_t)blockIdx.z * n * r;
#pragma unroll
  for (int j = 0; j < NT; ++j) {
    const int col = blockIdx.y * 8 * NT + 8 * j + 2 * t;
    if (gm0 < n) {
      if (col < r) dst[(size_t)gm0 * r + col] = acc[j][0];
      if (col + 1 < r) dst[(size_t)gm0 * r + col + 1] = acc[j][1];
    }
    if (gm1 < n) {
      if (col < r) dst[(size_t)gm1 * r + col] = acc[j][2];
      if (col + 1 < r) dst[(size_t)gm1 * r + col + 1] = acc[j][3];
    }
  }
}

// out[e] = sum over z of parts[z][e], z ascending: the split sum in a fixed order.
__global__ void kmv_split_reduce_kernel(const float* __restrict__ parts,
                                        float* __restrict__ out, size_t count, int splits) {
  for (size_t e = blockIdx.x * (size_t)blockDim.x + threadIdx.x; e < count;
       e += (size_t)gridDim.x * blockDim.x) {
    float acc = 0.0f;
    for (int z = 0; z < splits; ++z) acc += parts[(size_t)z * count + e];
    out[e] = acc;
  }
}

// ------------------------------------------------------ SYM (R <= 16)

__host__ __device__ inline int sym_stage_floats(int rs, int dp) {
  return ST * (dp + 4) + ST + ST * rs;
}

__host__ __device__ inline int sym_smem_floats(int rs, int dp) {
  return 2 * sym_stage_floats(rs, dp) + ST * (dp + 4) + ST + 8 * ST * rs;
}

// Slot of tile (i, j), i <= j: row tile j's slots are contiguous, i ascending;
// slot (j, j) holds row tile j's row sums.
__host__ __device__ inline size_t sym_slot(int i, int j) {
  return (size_t)j * (j + 1) / 2 + i;
}

// Block (p, y): row tiles p and nb - 1 - p, V columns [RS y, RS y + RS).
// Warp w owns rows 8 w .. 8 w + 7 of a tile, lane l columns l and l + 32.
// WIDE: sdp = STAGED_DIM coordinates of each point are staged; the dot
// products go on over coordinates sdp .. dp - 1 read from xp.
template <int KERN, int RS, bool WIDE>
__global__ void __launch_bounds__(THREADS, RS == 1 ? 3 : 1)
kmv_sym_tiles_kernel(const float* __restrict__ xp, const float* __restrict__ nrm,
                     const float* __restrict__ vbuf, float* __restrict__ slots, const Hyper hyp,
                     int n, int npad, int dp, int r) {
  extern __shared__ float4 smem4[];
  float* const smem = reinterpret_cast<float*>(smem4);
  const int sdp = WIDE ? hyper::STAGED_DIM : dp;  // coordinates staged per point
  const int cs = sdp + 4;  // padded coordinate row: 16-byte aligned, no bank conflicts
  const int stage = sym_stage_floats(RS, sdp);
  float* const rows_x = smem + 2 * stage;
  float* const rows_n = rows_x + ST * cs;
  float* const red = rows_n + ST;
  const float var = hyper::variance(hyp), noise = hyper::noise(hyp);
  const int nb = (n + ST - 1) / ST;
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int col0 = blockIdx.y * RS;
  const float* const vch = vbuf + (size_t)blockIdx.y * npad * RS;
  const size_t slot_floats = (size_t)ST * r;

  auto issue = [&](int buf, int j) {
    float* const sx = smem + buf * stage;
    float* const sn = sx + ST * cs;
    float* const sv = sn + ST;
    const int k0 = j * ST, cpr = sdp / 4;
    for (int q = threadIdx.x; q < ST * cpr; q += THREADS) {
      const int row = q / cpr, w = q - row * cpr;
      cp16(sx + row * cs + w * 4, xp + (size_t)(k0 + row) * dp + w * 4);
    }
    for (int q = threadIdx.x; q < ST / 4; q += THREADS) cp16(sn + q * 4, nrm + k0 + q * 4);
    for (int q = threadIdx.x; q < ST * RS / 4; q += THREADS)
      cp16(sv + q * 4, vch + (size_t)k0 * RS + q * 4);
  };

  for (int half = 0; half < 2; ++half) {
    const int i = half == 0 ? (int)blockIdx.x : nb - 1 - (int)blockIdx.x;
    if (half == 1 && i <= (int)blockIdx.x) break;
    __syncthreads();  // the previous row tile's readers of rows_x / rows_n are done
    for (int q = threadIdx.x; q < ST * sdp; q += THREADS) {
      const int row = q / sdp, c = q - row * sdp;
      rows_x[row * cs + c] = xp[(size_t)(i * ST + row) * dp + c];
    }
    for (int q = threadIdx.x; q < ST; q += THREADS) rows_n[q] = nrm[i * ST + q];
    float vi[8][RS], racc[8][RS];
#pragma unroll
    for (int k = 0; k < 8; ++k)
#pragma unroll
      for (int c = 0; c < RS; ++c) {
        vi[k][c] = vch[(size_t)(i * ST + warp * 8 + k) * RS + c];
        racc[k][c] = 0.0f;
      }

    issue(0, i);
    cp_commit();
    for (int j = i; j < nb; ++j) {
      const int buf = (j - i) & 1;
      if (j + 1 < nb) issue(buf ^ 1, j + 1);
      cp_commit();
      cp_wait_prev();
      __syncthreads();
      const float* const sx = smem + buf * stage;
      const float* const sn = sx + ST * cs;
      const float* const sv = sn + ST;

      float dot[8][2];
#pragma unroll
      for (int k = 0; k < 8; ++k) dot[k][0] = dot[k][1] = 0.0f;
      for (int c8 = 0; c8 < sdp; c8 += 8) {
        float ca[8], cb[8];
        ld8(ca, sx + lane * cs + c8);
        ld8(cb, sx + (lane + 32) * cs + c8);
#pragma unroll
        for (int k = 0; k < 8; ++k) {
          float ra[8];
          ld8(ra, rows_x + (warp * 8 + k) * cs + c8);  // one address per warp: broadcast
#pragma unroll
          for (int c = 0; c < 8; ++c) {
            dot[k][0] = fmaf(ra[c], ca[c], dot[k][0]);
            dot[k][1] = fmaf(ra[c], cb[c], dot[k][1]);
          }
        }
      }
      if constexpr (WIDE) {
        const float* const gc = xp + (size_t)(j * ST + lane) * dp;
        const float* const gr = xp + (size_t)(i * ST + warp * 8) * dp;
        for (int c8 = sdp; c8 < dp; c8 += 8) {
          float ca[8], cb[8];
          ldg8(ca, gc + c8);
          ldg8(cb, gc + (size_t)32 * dp + c8);
#pragma unroll
          for (int k = 0; k < 8; ++k) {
            float ra[8];
            ldg8(ra, gr + (size_t)k * dp + c8);
#pragma unroll
            for (int c = 0; c < 8; ++c) {
              dot[k][0] = fmaf(ra[c], ca[c], dot[k][0]);
              dot[k][1] = fmaf(ra[c], cb[c], dot[k][1]);
            }
          }
        }
      }
      float vj[2][RS], macc[2][RS];
#pragma unroll
      for (int e = 0; e < 2; ++e)
#pragma unroll
        for (int c = 0; c < RS; ++c) {
          vj[e][c] = sv[(lane + 32 * e) * RS + c];
          macc[e][c] = 0.0f;
        }
      const float bn[2] = {sn[lane], sn[lane + 32]};
#pragma unroll
      for (int k = 0; k < 8; ++k) {
        const int gm = i * ST + warp * 8 + k;
        const float am = rows_n[warp * 8 + k];
#pragma unroll
        for (int e = 0; e < 2; ++e) {
          const int gn = j * ST + lane + 32 * e;
          const float kv = gm < n ? entry<KERN>(am, bn[e], dot[k][e], gm, gn, n, var, noise)
                                  : 0.0f;
#pragma unroll
          for (int c = 0; c < RS; ++c) {
            racc[k][c] = fmaf(kv, vj[e][c], racc[k][c]);
            macc[e][c] = fmaf(kv, vi[k][c], macc[e][c]);
          }
        }
      }
      if (j > i) {  // mirror: sum the 8 warps' column partials in warp order
#pragma unroll
        for (int e = 0; e < 2; ++e)
#pragma unroll
          for (int c = 0; c < RS; ++c) red[(warp * ST + lane + 32 * e) * RS + c] = macc[e][c];
        __syncthreads();
        float* const slot = slots + sym_slot(i, j) * slot_floats;
        for (int q = threadIdx.x; q < ST * RS; q += THREADS) {
          const int m = q / RS, c = q - m * RS;
          float s = 0.0f;
#pragma unroll
          for (int w = 0; w < 8; ++w) s += red[(w * ST + m) * RS + c];
          if (col0 + c < r) slot[(size_t)m * r + col0 + c] = s;
        }
      }
      __syncthreads();  // this buffer and red are free for the next tile
    }
    // row sums: each lane holds two columns' share; a butterfly leaves every
    // lane with the same total
#pragma unroll
    for (int k = 0; k < 8; ++k)
#pragma unroll
      for (int c = 0; c < RS; ++c)
#pragma unroll
        for (int off = 16; off > 0; off >>= 1)
          racc[k][c] += __shfl_xor_sync(0xffffffffu, racc[k][c], off);
    if (lane == 0) {
      float* const slot = slots + sym_slot(i, i) * slot_floats;
#pragma unroll
      for (int k = 0; k < 8; ++k)
#pragma unroll
        for (int c = 0; c < RS; ++c)
          if (col0 + c < r) slot[(size_t)(warp * 8 + k) * r + col0 + c] = racc[k][c];
    }
  }
}

// out[64 j + m][c] = sum over i = 0 .. j of slot (i, j)[m][c], i ascending.
__global__ void kmv_sym_reduce_kernel(const float* __restrict__ slots, float* __restrict__ out,
                                      int n, int r) {
  const size_t count = (size_t)n * r, slot_floats = (size_t)ST * r;
  for (size_t e = blockIdx.x * (size_t)blockDim.x + threadIdx.x; e < count;
       e += (size_t)gridDim.x * blockDim.x) {
    const int row = (int)(e / r), c = (int)(e - (size_t)row * r);
    const int j = row / ST, m = row - j * ST;
    const float* const p = slots + sym_slot(0, j) * slot_floats + (size_t)m * r + c;
    float acc = 0.0f;
#pragma unroll 8
    for (int i = 0; i <= j; ++i) acc += p[(size_t)i * slot_floats];
    out[e] = acc;
  }
}

// out[e] = sqrt_rn(x[e]): lets a test hold the covariance tails' square root
// to sqrtf's bits over every float32 in its domain.
__global__ void sqrt_rn_kernel(const float* __restrict__ x, float* __restrict__ out,
                               size_t count) {
  for (size_t e = blockIdx.x * (size_t)blockDim.x + threadIdx.x; e < count;
       e += (size_t)gridDim.x * blockDim.x)
    out[e] = sqrt_rn(x[e]);
}

// ------------------------------------------------------------- launch

inline int elementwise_blocks(size_t count) {
  const size_t blocks = (count + THREADS - 1) / THREADS;
  return (int)(blocks < 4096 ? (blocks > 0 ? blocks : 1) : 4096);
}

template <int KERN, int NT, bool WIDE>
cudaError_t launch_tc(const float* xp, const float* nrm, const float* vbuf, float* out,
                      float* parts, const Hyper& hyp, int n, int npad, int dp, int r, int splits,
                      int* grids, cudaStream_t st) {
  static size_t granted[hyper::MAX_DEVICES] = {};
  const size_t bytes = 2 * (size_t)tc_stage_floats(NT, staged_dp(dp)) * sizeof(float);
  cudaError_t err = hyper::ensure_smem(kmv_tc_kernel<KERN, NT, WIDE>, bytes, granted);
  if (err != cudaSuccess) return err;
  const int stages = npad / BK, per = (stages + splits - 1) / splits;
  const dim3 grid(npad / BM, (r + 8 * NT - 1) / (8 * NT), splits);
  kmv_tc_kernel<KERN, NT, WIDE><<<grid, THREADS, bytes, st>>>(
      xp, nrm, vbuf, splits > 1 ? parts : out, hyp, n, npad, dp, r, per);
  ++*grids;
  err = cudaGetLastError();
  if (err != cudaSuccess || splits == 1) return err;
  const size_t count = (size_t)n * r;
  kmv_split_reduce_kernel<<<elementwise_blocks(count), THREADS, 0, st>>>(parts, out, count,
                                                                          splits);
  ++*grids;
  return cudaGetLastError();
}

template <int KERN, int RS, bool WIDE>
cudaError_t launch_sym(const float* xp, const float* nrm, const float* vbuf, float* out,
                       float* slots, const Hyper& hyp, int n, int npad, int dp, int r,
                       int* grids, cudaStream_t st) {
  static size_t granted[hyper::MAX_DEVICES] = {};
  const size_t bytes = (size_t)sym_smem_floats(RS, staged_dp(dp)) * sizeof(float);
  cudaError_t err = hyper::ensure_smem(kmv_sym_tiles_kernel<KERN, RS, WIDE>, bytes, granted);
  if (err != cudaSuccess) return err;
  const int nb = (n + ST - 1) / ST;
  const dim3 grid((nb + 1) / 2, (r + RS - 1) / RS);
  kmv_sym_tiles_kernel<KERN, RS, WIDE><<<grid, THREADS, bytes, st>>>(xp, nrm, vbuf, slots, hyp,
                                                                     n, npad, dp, r);
  ++*grids;
  err = cudaGetLastError();
  if (err != cudaSuccess) return err;
  kmv_sym_reduce_kernel<<<elementwise_blocks((size_t)n * r), THREADS, 0, st>>>(slots, out, n,
                                                                              r);
  ++*grids;
  return cudaGetLastError();
}

template <int KERN, bool WIDE>
cudaError_t dispatch_width(const float* xp, const float* nrm, const float* vbuf, float* out,
                           float* parts, const Hyper& hyp, int n, int npad, int dp, int r,
                           int width, int tc, int splits, int* grids, cudaStream_t st) {
  if (tc && width == 8)
    return launch_tc<KERN, 8, WIDE>(xp, nrm, vbuf, out, parts, hyp, n, npad, dp, r, splits, grids,
                                    st);
  if (tc && width == 32)
    return launch_tc<KERN, 32, WIDE>(xp, nrm, vbuf, out, parts, hyp, n, npad, dp, r, splits,
                                     grids, st);
  if (!tc && width == 1)
    return launch_sym<KERN, 1, WIDE>(xp, nrm, vbuf, out, parts, hyp, n, npad, dp, r, grids, st);
  if (!tc && width == 4)
    return launch_sym<KERN, 4, WIDE>(xp, nrm, vbuf, out, parts, hyp, n, npad, dp, r, grids, st);
  return cudaErrorInvalidValue;
}

template <int KERN>
cudaError_t dispatch(const float* xp, const float* nrm, const float* vbuf, float* out,
                     float* parts, const Hyper& hyp, int n, int npad, int dp, int r, int width,
                     int tc, int splits, int* grids, cudaStream_t st) {
  if (dp > hyper::STAGED_DIM)
    return dispatch_width<KERN, true>(xp, nrm, vbuf, out, parts, hyp, n, npad, dp, r, width, tc,
                                      splits, grids, st);
  return dispatch_width<KERN, false>(xp, nrm, vbuf, out, parts, hyp, n, npad, dp, r, width, tc,
                                     splits, grids, st);
}

}  // namespace

extern "C" {

// out (n, r) = (K(x, x) + noise I) @ v. x (n, d), v (n, r): contiguous fp32,
// raw coordinates; log_var, log_ls (d floats ls_stride apart), noise:
// hyper.cuh's Hyper. The plan comes from the wrapper (ops/fused_gram.kmv_sym_plan):
// npad (a multiple of 128, >= n), dp (a multiple of 8, >= d), tc (1: the
// tensor-core build, width = n-tiles of 8 columns, 8 or 32, its column sweep
// split over `splits` blocks; 0: the symmetric build, width = columns per
// pass, 1 or 4, splits = 1). Scratch, all fp32: xp npad * dp, nrm npad, vbuf
// chunks * npad * (tc ? 16 * width : width); parts, the symmetric build's
// slots, nb (nb + 1) / 2 * 64 * r with nb = ceil(n / 64), or the split
// partial sums, splits * n * r (unused when tc and splits == 1). *grids: set
// to the number of CUDA grids this call launched (one added at each launch).
int gpras_kmv_sym(int kern, const void* x, const void* v, void* out, void* xp, void* nrm,
                  void* vbuf, void* parts, const void* log_var, const void* log_ls,
                  int ls_stride, const void* noise_p, float noise_v, int n, int d, int r,
                  int npad, int dp, int width, int tc, int splits, int* grids, void* stream) {
  *grids = 0;
  const bool plan_ok = tc ? (width == 8 || width == 32) && splits >= 1
                          : (width == 1 || width == 4) && splits == 1;
  if (n < 1 || d < 1 || r < 1 || npad < n || npad % BM != 0 || dp < d || dp % 8 != 0 ||
      !plan_ok || kern < RBF || kern > EXPONENTIAL)
    return (int)cudaErrorInvalidValue;
  const float* X = static_cast<const float*>(x);
  const float* V = static_cast<const float*>(v);
  float* O = static_cast<float*>(out);
  float* XP = static_cast<float*>(xp);
  float* NRM = static_cast<float*>(nrm);
  float* VB = static_cast<float*>(vbuf);
  float* P = static_cast<float*>(parts);
  const Hyper hyp{static_cast<const float*>(log_var), static_cast<const float*>(log_ls),
                  ls_stride, static_cast<const float*>(noise_p), noise_v};
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const int cols = tc ? 8 * width : width;
  const size_t vcount = (size_t)((r + cols - 1) / cols) * npad * (tc ? 16 * width : width);
  prep_kernel<<<elementwise_blocks(vcount > (size_t)npad * dp ? vcount : (size_t)npad * dp),
                THREADS, 0, st>>>(X, V, XP, NRM, VB, hyp, n, npad, d, dp, r, width, tc, vcount);
  ++*grids;
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return (int)err;
#define GPRAS_SYM_DISPATCH(K) \
  dispatch<K>(XP, NRM, VB, O, P, hyp, n, npad, dp, r, width, tc, splits, grids, st)
  switch (kern) {
    case RBF: return GPRAS_SYM_DISPATCH(RBF);
    case MATERN12: return GPRAS_SYM_DISPATCH(MATERN12);
    case MATERN32: return GPRAS_SYM_DISPATCH(MATERN32);
    case MATERN52: return GPRAS_SYM_DISPATCH(MATERN52);
    case EXPONENTIAL: return GPRAS_SYM_DISPATCH(EXPONENTIAL);
    default: return (int)cudaErrorInvalidValue;
  }
#undef GPRAS_SYM_DISPATCH
}

// out (count,) = sqrt_rn(x) (stationary.cuh), fp32, for the tests.
int gpras_sqrt_rn(const void* x, void* out, size_t count, void* stream) {
  sqrt_rn_kernel<<<elementwise_blocks(count), THREADS, 0, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const float*>(x), static_cast<float*>(out), count);
  return (int)cudaGetLastError();
}

}  // extern "C"
