"""Operations and bytes from shapes, and the one rate every roofline and
``mfu`` metric of the benchmark divides by.

``gram_work``, ``kmv_work`` and ``kgrad_work`` are frozen copies of
``chip_smoke.py``'s functions of the same names, with one change: the
contraction of ``kmv_work`` is counted as the algorithm needs it,
2 n1 n2 r operations, and not as the three TF32 passes one implementation
spends on it. They are copied, not imported, so that no change to the
program can move the yardstick.

The rate differs from ``chip_smoke.bound()``. That function charges fp32
work at 67 TFLOP/s (CUDA cores) and tensor-core work at 495 TFLOP/s, so a
kernel that moves its work from CUDA cores to 3xTF32 changes its own bound
and can read over 100%. Here every operation is charged at one rate,
``COMPUTE_RATE``: the card's dense TF32 peak (494.7 TFLOP/s, NVIDIA's H100
SXM data sheet) over the three passes of 3xTF32, the cheapest contraction
that keeps float32 accuracy. No float32-accurate implementation of the same
operations can beat that bound, whatever unit it runs on.
"""

from __future__ import annotations

COMPUTE_RATE = 494.7e12 / 3  # operations per second, whatever implements them
HBM_RATE = 3.35e12           # bytes per second (H100 SXM, HBM3)

PROBES = 16  # Hutchinson probes of the exact fit (the program's fixed draw)


def entry_ops(d: int) -> int:
    """Operations per covariance entry: the d-wide difference or dot, r2,
    and the Matern52 tail (sqrt, exp and ~8 multiply-adds)."""
    return 2 * d + 12


def gram_work(n1: int, n2: int, d: int) -> tuple[float, float]:
    """(operations, bytes) of a covariance block K(x1, x2)."""
    return n1 * n2 * entry_ops(d), 4.0 * (n1 * n2 + (n1 + n2) * d)


def kmv_work(n1: int, n2: int, r: int, sym: bool, d: int) -> tuple[float, float]:
    """(operations, bytes) of (K(x1, x2) [+ noise I]) @ V with V (n2, r):
    each distinct covariance entry built once (half the square when
    symmetric) and the contraction, 2 n1 n2 r."""
    entries = n1 * n2 / 2 if sym else n1 * n2
    return (entries * entry_ops(d) + 2.0 * n1 * n2 * r,
            4.0 * ((n1 + n2) * d + n2 * r + n1 * r))


def kgrad_work(n: int, d: int, m: int = PROBES) -> tuple[float, float]:
    """(operations, bytes) of the covariance-derivative contraction (B4 and
    B5 compute the same sum): per pair i <= j, r2 (3d), the lengthscale
    weights (3d), f and f' (~12), the variance and weight products (~7) and
    the folded rank-m cotangent (4m)."""
    return n * (n + 1) / 2 * (6 * d + 4 * m + 19), 4.0 * n * (d + 2 * m + 1)


def cholesky_ops(n: int) -> float:
    return n ** 3 / 3.0


def tri_solve_ops(n: int, r: int) -> float:
    """Operations of L^-T L^-1 B for B (n, r): two triangular solves."""
    return 2.0 * n * n * r


def bound_s(ops: float, nbytes: float) -> tuple[float, str]:
    """(least seconds, what binds) for work of ``ops`` operations that must
    move ``nbytes`` bytes."""
    t_ops, t_bytes = ops / COMPUTE_RATE, nbytes / HBM_RATE
    return (t_ops, "operations") if t_ops >= t_bytes else (t_bytes, "bytes")


def hutchinson_step_ops(n: int, d: int, m: int = PROBES, grad: bool = True) -> float:
    """Operations of one Hutchinson loss evaluation at n points: B1's Gram
    (half the square: it is symmetric), the factorization, the solve for
    alpha and, with the gradient, the solve against the m probes and B5."""
    ops = n * (n + 1) / 2 * entry_ops(d) + cholesky_ops(n) + tri_solve_ops(n, 1)
    if grad:
        ops += tri_solve_ops(n, m) + kgrad_work(n, d, m)[0]
    return ops
