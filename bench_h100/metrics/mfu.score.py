"""Scoring's share of the card's TF32 peak: the model's forward
products (yardstick.model_ops_per_frame) on the unpadded frames scored
in the traced window, over the window, over the peak."""

from bench_h100 import yardstick as ys


def read(ctx):
    if ctx["kind"] != "score" or ctx["trace"] is None or ctx["frames"] <= 0:
        return None
    ops = ys.model_ops_per_frame(ctx["config"], train=False) * ctx["frames"]
    return 100.0 * ops / ctx["window_s"] / ys.PEAK_FLOPS
