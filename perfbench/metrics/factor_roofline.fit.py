"""The in-place factorization's share of its roofline: N^3 / 3 operations
per ``fit.factor`` span, over the spans' device seconds (between the CUDA
events at their edges, so the idle that the panels' host reads leave inside
a span counts), over ``work.COMPUTE_RATE``, in %."""

from perfbench import work
from perfbench.metrics import _spans


def read(ctx):
    got = _spans.program()
    if got is None:
        return None
    spans = [s for s in _spans.named(got[0], "fit.factor") if s["device_s"]]
    if not spans:
        return None
    ops = len(spans) * work.cholesky_ops(ctx["cell"].config["n_train"])
    return 100.0 * ops / sum(s["device_s"] for s in spans) / work.COMPUTE_RATE
