"""Mean host milliseconds a request spends in ``serve.lf_transform``:
the LF ``PreProcessor.transform``, on the card: one upload of the raw
field, the wet cells gathered, centred, weighted, projected and
standardised as device operations against constants already resident, one
read back of the modes."""

from perfbench.metrics import _spans


def read(ctx):
    return _spans.host_ms_per("serve.lf_transform", "serve.request")
