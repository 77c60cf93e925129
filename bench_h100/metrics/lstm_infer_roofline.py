"""K5's share of its roofline: the least time its calls in the window
could take (yardstick.py: one call a layer a batch, on the batch's
unpadded frames) over its kernels' device time in the trace."""

from bench_h100 import yardstick as ys


def read(ctx):
    if ctx["kind"] != "score" or ctx["trace"] is None:
        return None
    t = ys.kernel_time_s(ctx["trace"], ("lstmp_infer",))
    if t <= 0:
        return None
    bound = 0.0
    for _, f in ctx["batches"]:
        for I, C, R in ys.layer_dims(ctx["config"]):
            bound += ys.bound_s(ys.k5_ops(f, I, C, R),
                                ys.k5_bytes(f, I, C, R))[0]
    return 100.0 * bound / t
