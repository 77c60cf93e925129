"""K1 and K2's share of their roofline: the least time their calls in
the window could take (yardstick.py: each call's larger of operations
over the TF32 peak and bytes over the memory bandwidth, on the step's
valid frames) over their kernels' device time in the trace."""

from bench_h100 import yardstick as ys


def read(ctx):
    if ctx["kind"] != "train" or ctx["trace"] is None:
        return None
    t = ys.kernel_time_s(ctx["trace"], ("lstmp_train_fwd", "lstmp_train_bwd"))
    if t <= 0:
        return None
    S, bound = ctx["streams"], 0.0
    for f in ctx["step_frames"]:
        for n, (I, C, R) in enumerate(ys.layer_dims(ctx["config"])):
            bound += ys.bound_s(ys.k1_ops(f, I, C, R),
                                ys.k1_bytes(f, S, I, C, R))[0]
            bound += ys.bound_s(ys.k2_ops(f, I, C, R, n > 0),
                                ys.k2_bytes(f, S, I, C, R, n > 0))[0]
    return 100.0 * bound / t
