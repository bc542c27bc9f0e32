"""B3 (csrc/kmv_sym.cu) against its roofline in serving: the least time
its calls could take (``work.kmv_work`` on the N x N training Gram with R
right-hand sides, R the request's variance chunk: the largest divisor of
its padded size up to 256; calls counted per request by
``fused_gram.kmv_sym.launches``) over the device time of its functions in
the trace."""

from perfbench import work
from perfbench.metrics._common import chunk, kernel_seconds

FUNCTIONS = ("prep_kernel", "kmv_tc_kernel", "kmv_sym_tiles_kernel", "kmv_split_reduce_kernel",
             "kmv_sym_reduce_kernel", "sqrt_rn_kernel")


def read(ctx):
    cfg = ctx["cell"].config
    n, d = cfg["n_train"], cfg["input_dim"]
    least = sum(r["launches"]["kmv_sym"] * work.bound_s(
        *work.kmv_work(n, n, chunk(r["bucket"]), True, d))[0] for r in ctx["requests"])
    t = kernel_seconds(ctx["trace"], FUNCTIONS)
    if least <= 0 or t <= 0:
        return None
    return 100.0 * least / t
