"""K3 and K4's share of their roofline: the least time their calls in
the window could take (yardstick.py, on the step's valid frames) over
their kernels' device time in the trace."""

from bench_h100 import yardstick as ys


def read(ctx):
    if ctx["kind"] != "train" or ctx["trace"] is None:
        return None
    t = ys.kernel_time_s(ctx["trace"], ("xent_affine_fwd", "xent_affine_bwd"))
    if t <= 0:
        return None
    K = ctx["config"]["num_pdfs"]
    R = ys.layer_dims(ctx["config"])[-1][2]
    bound = 0.0
    for f in ctx["step_frames"]:
        bound += ys.bound_s(ys.k3_ops(f, R, K), ys.k3_bytes(f, R, K))[0]
        bound += ys.bound_s(ys.k4_ops(f, R, K), ys.k4_bytes(f, R, K))[0]
    return 100.0 * bound / t
