"""Block-size helper of ``gpras_tpu/ops/block_cholesky.py``.

Only ``fit_block`` is ported: the matrix-free engine (``gp/exact_cg.py``)
chunks its variance solves by it (the largest divisor of the query count at or
below 256), which is why the serving layer pads requests to bucket sizes. The
blocked factorizations themselves worked around TPU compile time and 16 GB of
HBM and are not ported (ROADMAP.md).
"""

from __future__ import annotations


def fit_block(n: int, target: int = 512) -> int:
    """Largest block size <= target that divides n."""
    b = min(target, n)
    while n % b != 0:
        b -= 1
    return b
