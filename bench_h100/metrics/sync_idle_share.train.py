"""The share of the traced window that the card spent idle after a
drain of the epoch loop: the device's idle gaps (no device event of any
kind) that open inside one of the program's `epoch.sync` spans, each
gap counted whole, over the window."""

from bench_h100 import spans as sp


def read(ctx):
    tr = ctx["trace"]
    if ctx["kind"] != "train" or tr is None or not tr.device:
        return None
    syncs = sp.spans(tr, ("epoch.sync",))
    if not syncs:
        return None
    return 100.0 * sp.opened_inside_s(sp.idle_intervals(tr), syncs) \
        / ctx["window_s"]
