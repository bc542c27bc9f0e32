"""Mean host milliseconds a request spends in ``serve.posterior``:
``GPRAS.predict`` at the padded bucket, with its copy up and its two
copies back."""

from perfbench.metrics import _spans


def read(ctx):
    return _spans.host_ms_per("serve.posterior", "serve.request")
