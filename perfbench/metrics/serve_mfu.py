"""The exact serving path's share of the card's peak: per request the
operations its counted B3 calls (``work.kmv_work``, symmetric N x N, R the
variance chunk) and B2 calls (the padded queries against the N training
points, one right-hand side) need, plus the cross-covariance tile of each
chunk and mode, the LF projection and the decode of mean and variance;
over the traced window's seconds, over ``work.COMPUTE_RATE``."""

from perfbench import work
from perfbench.metrics._common import chunk


def read(ctx):
    cfg = ctx["cell"].config
    if cfg["model_type"] != "exact" or ctx["trace"].busy_s <= 0:
        return None
    n, d, p = cfg["n_train"], cfg["input_dim"], cfg["hf_modes"]
    cells = cfg["grid"][0] * cfg["grid"][1]
    ops = 0.0
    for r in ctx["requests"]:
        b = r["bucket"]
        ops += r["launches"]["kmv_sym"] * work.kmv_work(n, n, chunk(b), True, d)[0]
        ops += r["launches"]["kmv_dense"] * work.kmv_work(b, n, 1, False, d)[0]
        ops += p * work.gram_work(n, b, d)[0]
        ops += 2.0 * r["fields"] * cells * cfg["lf_modes"] + 2.0 * 2.0 * b * p * cells
    return 100.0 * ops / ctx["trace"].window_s / work.COMPUTE_RATE
