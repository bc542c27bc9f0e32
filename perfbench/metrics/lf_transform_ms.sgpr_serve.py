"""Mean host milliseconds a request spends in ``serve.lf_transform``:
the LF ``PreProcessor.transform``: host numpy, two copies up, one
matmul, a copy back."""

from perfbench.metrics import _spans


def read(ctx):
    return _spans.host_ms_per("serve.lf_transform", "serve.request")
