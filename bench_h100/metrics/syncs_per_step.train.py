"""Blocking drains of the epoch loop a training step: the program's
counters `epoch.sync.report`, `epoch.sync.block` and `epoch.sync.end`
(utils/timer.py; each a wait for every queued kernel) summed over the
window, per step the harness fed."""

KEYS = ("epoch.sync.report", "epoch.sync.block", "epoch.sync.end")


def read(ctx):
    steps = len(ctx.get("step_frames", ()))
    counts = ctx["counts"]
    if ctx["kind"] != "train" or not steps or not all(
            k in counts for k in KEYS):
        return None
    return sum(counts[k] for k in KEYS) / steps
