"""Mean host milliseconds a request spends in ``serve.copy_back``:
the two float64 field copies to the host."""

from perfbench.metrics import _spans


def read(ctx):
    return _spans.host_ms_per("serve.copy_back", "serve.request")
