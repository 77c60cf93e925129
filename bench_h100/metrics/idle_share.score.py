"""The share of the traced window in which no kernel ran on the card:
1 - (the union of kernel intervals) / window, so kernels that overlap
on two streams count once; copies count as idle."""

from bench_h100 import yardstick as ys


def read(ctx):
    if ctx["kind"] != "score" or ctx["trace"] is None:
        return None
    return 100.0 * (1.0 - ys.union_s(ctx["trace"]) / ctx["window_s"])
