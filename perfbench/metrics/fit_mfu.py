"""The exact fit's share of the card's peak: the operations its steps need,
from shapes (per loss evaluation B1's symmetric Gram, the N^3 / 3
factorization and the solve for alpha; with the gradient also the solve
against the 16 probes and B5's contraction), over the traced window's
seconds, over ``work.COMPUTE_RATE``. Each Adam step is one evaluation with
the gradient; each mode of a fit call adds one without (the final loss)."""

from perfbench import work


def read(ctx):
    cfg = ctx["cell"].config
    if cfg["model_type"] != "exact" or ctx["trace"].busy_s <= 0:
        return None
    n, d = cfg["n_train"], cfg["input_dim"]
    ops = 0.0
    for call in ctx["iterations"]:
        for it in call:
            ops += it * work.hutchinson_step_ops(n, d, cfg["probes"], grad=True)
            ops += work.hutchinson_step_ops(n, d, cfg["probes"], grad=False)
    return 100.0 * ops / ctx["trace"].window_s / work.COMPUTE_RATE
