"""The program's own host spans in a traced window (the registry
`kaldi_lstm_tpu_torch.utils.timer.PROFILE` opens them as profiler
ranges while a profiler runs) against the device's idle time: the
readers of the span metrics share these. A program without the spans
gives an empty list, and its readers report nothing."""

from __future__ import annotations

import bisect

from bench_h100 import yardstick as ys


def idle_intervals(trace: ys.Trace) -> list:
    """The window's idle gaps on the device, in order: the intervals in
    which no device event of any kind ran (the gaps that
    `yardstick.idle_gaps` names)."""
    gaps, cur = [], trace.t0
    for s, e in ys.merged(ys.clipped(trace, trace.device)):
        if s > cur:
            gaps.append((cur, s))
        cur = max(cur, e)
    if trace.t1 > cur:
        gaps.append((cur, trace.t1))
    return gaps


def spans(trace: ys.Trace, names) -> list:
    """The union of the window's host events of the given names, as
    sorted disjoint [start, end) intervals."""
    return ys.merged(ys.clipped(
        trace, [h for h in trace.host if h.name in names]))


def opened_inside_s(gaps: list, inside: list) -> float:
    """Seconds of the gaps that open inside one of the sorted disjoint
    intervals `inside`, each gap counted whole."""
    starts = [s for s, _ in inside]
    total = 0.0
    for s, e in gaps:
        i = bisect.bisect_right(starts, s) - 1
        if i >= 0 and s < inside[i][1]:
            total += e - s
    return total


def overlap_s(a: list, b: list) -> float:
    """Seconds that lie in both of two lists of sorted disjoint
    intervals."""
    total, i, j = 0.0, 0, 0
    while i < len(a) and j < len(b):
        lo, hi = max(a[i][0], b[j][0]), min(a[i][1], b[j][1])
        if hi > lo:
            total += hi - lo
        if a[i][1] < b[j][1]:
            i += 1
        else:
            j += 1
    return total
