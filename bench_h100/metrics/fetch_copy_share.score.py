"""The share of the traced window in which the card copied scores to
the host: the union of the profiler's device-to-host Memcpy intervals
over the window."""

from bench_h100 import yardstick as ys


def read(ctx):
    if ctx["kind"] != "score" or ctx["trace"] is None:
        return None
    t = ys.union_s(ctx["trace"], ("memcpy_dtoh",))
    if t <= 0:
        return None
    return 100.0 * t / ctx["window_s"]
