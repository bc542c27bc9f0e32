"""Share of mbcg's column-iterations spent on columns not yet frozen
(converged or broken down): ``cg.live_column_iters`` over
``cg.column_iters``, in %."""

from perfbench.metrics import _spans


def read(ctx):
    got = _spans.program()
    if got is None or not got[1].get("cg.column_iters"):
        return None
    return 100.0 * got[1].get("cg.live_column_iters", 0) / got[1]["cg.column_iters"]
