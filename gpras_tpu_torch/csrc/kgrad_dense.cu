// Dense fused gradient contraction (B4) for Hopper (sm_90a): the exact-GP
// training backward's sum_ij Kbar_ij dK_ij/dtheta for small N, without any
// (N, N) buffer.
//
// Replaces _kgrad_body of gpras_tpu/ops/pallas_gram.py (:534-603, launcher
// pallas_kgrad :701, call :772), which the reference runs below 8 tile rows
// of 512 (N <= 3,584; ops/fused_gram.kgrad keeps that rule). With a the
// inputs divided by the lengthscales, u_ij = ||a_i - a_j||^2, K = var f(u)
// and Kbar = gh [(1/m) W Z^T - alpha alpha^T] (gh = g / 2), the outputs are
//   d log_variance      =      sum_ij Kbar_ij var f(u_ij)
//   d log_lengthscale_d = -2 sum_ij Kbar_ij var f'(u_ij) (a_id - a_jd)^2.
//
// What bounds it on an H100: operations, all fp32 on the CUDA cores, but at
// N = 3,072 (m = 16, D = 8) they are only 4.7e6 entry pairs, ~0.01 ms: the
// call is short, so what costs is what does not scale with the entries (a
// block's start, its staging, its reductions, the waves). The first port
// (csrc/kgrad.cu) launched a 256-thread block per 64 x 64 tile, 2,304 blocks
// at N = 3,072, each staging six operand arrays for 4,096 entries and
// reducing nine float64 sums through shared memory behind a barrier each.
// This design takes B5's machinery (kgrad_strips.cuh): a prep grid packs the
// operands once per 64-point tile; persistent 128-thread blocks stage their
// row strip once and stream column tiles through a cp.async ring; float64
// running sums stay in registers and a block reduces once, at its end; a
// second grid adds the blocks' partials in a fixed order (the same bits from
// run to run, no atomics). At N = 3,072 the walk is only ~9 tiles an SM, so
// the wrapper's plan (ops/fused_gram.kgrad_dense_plan) gives each of three
// blocks an SM an even share of the walk's tiles (segments of whole strips
// left a few SMs a third more tiles than the rest). The walk is B5's: strip
// pairs (p, nb - 1 - p) over the upper triangle, the folded cotangent
// Kbar_ij + Kbar_ji^T on a tile j > i, so f and f' are evaluated once per
// mirror pair. It computes the TPU dense body's sum; walking every tile with
// Kbar_ij alone, as that body does, was 1.5x slower on an H100 80GB HBM3 at
// 700 W (PERF.md).
// The noise and jitter diagonal term stays with the caller.
//
// Plain C interface (loaded with ctypes); returns cudaGetLastError().

#include "kgrad_strips.cuh"

extern "C" {

// out (1 + d) fp32 = [d log_variance, d log_lengthscales...] of
// sum_ij Kbar_ij dK_ij over all tiles. x (n, d) raw coordinates, w and z
// (n, m), alpha (n): contiguous fp32. log_var, log_ls (d floats ls_stride
// apart): hyper.cuh's Hyper. g: the cotangent's scale, one fp32 in device
// memory (g_p) or, when g_p is null, g_v; inv_m = 1 / m. The plan comes from
// the wrapper (ops/fused_gram.kgrad_dense_plan): dp (d rounded up to a
// multiple of 8), blocks (each takes an even share of the walk's tiles), nst
// (ring stages, 1 to 3). Scratch: pack, nb * (dp + 2 m + 1) * 64
// floats (nb = ceil(n / 64)); partial, (1 + dp) * blocks doubles.
int gpras_kgrad_dense(int kern, const void* x, const void* w, const void* z, const void* alpha,
                      const void* log_var, const void* log_ls, int ls_stride, const void* g_p,
                      float g_v, float inv_m, void* pack, void* partial, void* out, int n, int d,
                      int dp, int m, int blocks, int nst, void* stream) {
  if (blocks < 1) return (int)cudaErrorInvalidValue;
  return kgrad_strips::run_strips(kern, x, w, z, alpha, log_var, log_ls, ls_stride, g_p, g_v,
                                 inv_m, pack, partial, out, n, d, dp, m, 1, blocks, nst, stream);
}

}  // extern "C"
