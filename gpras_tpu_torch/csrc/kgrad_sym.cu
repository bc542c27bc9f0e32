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
// The pack grid, the strip kernel and its launch live in kgrad_strips.cuh,
// shared with B4 (kgrad_dense.cu), which walks the same strips.
//
// Plain C interface (loaded with ctypes); returns cudaGetLastError().

#include "kgrad_strips.cuh"

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
  return kgrad_strips::run_strips(kern, x, w, z, alpha, log_var, log_ls, ls_stride, g_p, g_v,
                                 inv_m, pack, partial, out, n, d, dp, m, segs, 0, nst, stream);
}

}  // extern "C"
