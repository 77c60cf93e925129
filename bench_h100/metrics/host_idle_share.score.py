"""The share of the traced window in which the card was idle (no device
event of any kind) while the host was inside the scorer's own work on
a batch: the program's spans `score.stage` (padding and pinning),
`score.dispatch` (upload, forward enqueue, queued copy) and
`score.emit` (each utterance's rows)."""

from bench_h100 import spans as sp

NAMES = ("score.stage", "score.dispatch", "score.emit")


def read(ctx):
    tr = ctx["trace"]
    if ctx["kind"] != "score" or tr is None or not tr.device:
        return None
    host = sp.spans(tr, NAMES)
    if not host:
        return None
    return 100.0 * sp.overlap_s(sp.idle_intervals(tr), host) \
        / ctx["window_s"]
