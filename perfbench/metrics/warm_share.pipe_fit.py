"""The warm start's share of the traced window: host seconds in the
program's ``fit.warm_start`` spans (the rung's fit on the subsample) and
``fit.certify`` spans (the clamp and the full-N forwards that certify it),
over the window's seconds, in %. None where the program opens neither."""

from perfbench.metrics import _spans


def read(ctx):
    got = _spans.program()
    if got is None or ctx["trace"].window_s <= 0:
        return None
    spans = _spans.named(got[0], "fit.warm_start") + _spans.named(got[0], "fit.certify")
    if not spans:
        return None
    host_s = sum(s["end_ns"] - s["start_ns"] for s in spans) * 1e-9
    return 100.0 * host_s / ctx["trace"].window_s
