"""Blocking host reads per loss evaluation: the program's ``host_reads``
counter over its ``fit.eval`` spans. A count."""

from perfbench.metrics import _spans


def read(ctx):
    got = _spans.program()
    if got is None:
        return None
    evals = len(_spans.named(got[0], "fit.eval"))
    return got[1].get("host_reads", 0) / evals if evals else None
