"""The training step's share of the card's TF32 peak: the model's
products (yardstick.model_ops_per_frame) on the valid frames trained
in the traced window, over the window, over the peak."""

from bench_h100 import yardstick as ys


def read(ctx):
    if ctx["kind"] != "train" or ctx["trace"] is None:
        return None
    frames = sum(ctx["step_frames"])
    if frames <= 0:
        return None
    ops = ys.model_ops_per_frame(ctx["config"], train=True) * frames
    return 100.0 * ops / ctx["window_s"] / ys.PEAK_FLOPS
