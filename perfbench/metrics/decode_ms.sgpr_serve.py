"""Mean host milliseconds a request spends in ``serve.decode``:
the float64 copies of the mode means and variances up and the
field decoder's products."""

from perfbench.metrics import _spans


def read(ctx):
    return _spans.host_ms_per("serve.decode", "serve.request")
