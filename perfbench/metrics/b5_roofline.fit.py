"""B5 (csrc/kgrad_sym.cu) against its roofline: the least time its calls
could take (``work.kgrad_work`` at the cell's N, D and 16 probes, one per
call counted by ``fused_gram.kgrad_sym.launches``, over one compute rate
and the HBM bandwidth) over the device time of its functions in the trace.
B4 shares those functions, so a window in which B4 ran gives nothing."""

from perfbench import work
from perfbench.metrics._common import kernel_seconds

FUNCTIONS = ("kgrad_pack_kernel", "kgrad_strips_kernel", "kgrad_reduce_kernel")


def read(ctx):
    cfg = ctx["cell"].config
    calls = ctx["launches"]["kgrad_sym"]
    if calls == 0 or ctx["launches"]["kgrad_dense"]:
        return None
    t = kernel_seconds(ctx["trace"], FUNCTIONS)
    if t <= 0:
        return None
    ops, nbytes = work.kgrad_work(cfg["n_train"], cfg["input_dim"], cfg["probes"])
    return 100.0 * calls * work.bound_s(ops, nbytes)[0] / t
