"""What several metric readers share: device time of named kernels and the
serving path's variance chunk."""

from __future__ import annotations

from perfbench.trace import kernel_base


def kernel_seconds(trace, names: tuple[str, ...]) -> float:
    """Device seconds of the operations whose function is one of ``names``."""
    return sum(d for n, _, d in trace.ops if kernel_base(n) in names) * 1e-9


def chunk(bucket: int, limit: int = 256) -> int:
    """The right-hand sides of each B3 call when serving a padded request of
    ``bucket`` queries: the largest divisor of it up to 256 (the predictor
    solves the variance in such chunks)."""
    return max(c for c in range(1, min(bucket, limit) + 1) if bucket % c == 0)
