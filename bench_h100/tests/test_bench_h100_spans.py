"""The readers of the program's spans and counters: `syncs_per_step.train`,
`sync_idle_share.train`, `host_idle_share.score` and `padded_share.score`.
Tiny traced runs of each kind on the CPU report the counter metrics (the
CPU trace holds no device event, so the span metrics report nothing),
`padded_share.score` equals the harness's own count of its batches, and
the span readers are held to a hand-made trace. A program without the
spans and counters gives nothing to read, and no reader raises."""

import time

import pytest
import torch

from bench_h100 import catalog, score_cell
from bench_h100 import spans as sp
from bench_h100 import yardstick as ys
from bench_h100.run import make_window, run_cell
from bench_h100.tests import tiny

SEED = 2**31 + 29
CPU = torch.device("cpu")


@pytest.mark.parametrize("kind,metric", [("train", "syncs_per_step.train"),
                                         ("score", "padded_share.score")])
def test_tiny_traced_run_reports_the_counter_metric(kind, metric):
    result, _ = run_cell(tiny.cell(kind), SEED, 0.3, True, CPU,
                         t0=time.perf_counter())
    assert result["correct"]
    got = result["metrics"][metric]["value"]
    assert 0 < got < (1 if kind == "train" else 100)
    # no device event on the CPU: the span readers find nothing
    assert "sync_idle_share.train" not in result["metrics"]
    assert "host_idle_share.score" not in result["metrics"]


def test_padded_share_equals_the_harness_count_of_its_batches():
    cell = tiny.cell("score")
    out = score_cell.run(cell, SEED, 0.3,
                         make_window(CPU, False, time.perf_counter()), CPU)
    B = cell.traffic["batch_utts"]
    frames = sum(f for _, f in out["ctx"]["batches"])
    slots = sum(B * t for t, _ in out["ctx"]["batches"])
    ctx = dict(out["ctx"], kind="score", counts=out["span"]["counts"],
               trace=None, window_s=out["span"]["seconds"])
    got = catalog.reader("padded_share.score")(ctx)
    assert out["span"]["counts"]["score.frames"] == frames
    assert got == pytest.approx(100.0 * (1.0 - frames / slots), rel=1e-12)


def _trace(device, host, t0=0.0, t1=10.0):
    return ys.Trace([ys.DeviceEvent("k", "kernel", s, e) for s, e in device],
                    [ys.HostEvent(n, s, e) for n, s, e in host], t0, t1)


# kernels at [0, 2), [3, 5), [5.5, 9): idle [2, 3), [5, 5.5), [9, 10)
TRACE = _trace([(0, 2), (3, 5), (5.5, 9)],
               [("epoch.sync", 1.5, 2.5), ("epoch.sync", 8.0, 9.5),
                ("score.stage", 2.5, 3.5), ("score.emit", 4.8, 5.2),
                ("score.dispatch", 5.1, 5.3), ("aten::copy_", 2.0, 2.8)])


def test_span_helpers_on_a_hand_made_trace():
    assert sp.idle_intervals(TRACE) == [(2, 3), (5, 5.5), (9, 10)]
    syncs = sp.spans(TRACE, ("epoch.sync",))
    assert syncs == [[1.5, 2.5], [8.0, 9.5]]
    # [2, 3) opens inside the first, [9, 10) inside the second
    assert sp.opened_inside_s(sp.idle_intervals(TRACE), syncs) == 2.0
    host = sp.spans(TRACE, ("score.stage", "score.emit", "score.dispatch"))
    assert host == [[2.5, 3.5], [4.8, 5.3]]
    # [2.5, 3) and [5, 5.3)
    assert sp.overlap_s(sp.idle_intervals(TRACE), host) == pytest.approx(0.8)


def test_span_readers_on_a_hand_made_trace():
    ctx = {"trace": TRACE, "window_s": TRACE.window_s, "counts": {}}
    sync = catalog.reader("sync_idle_share.train")(dict(ctx, kind="train"))
    host = catalog.reader("host_idle_share.score")(dict(ctx, kind="score"))
    assert sync == pytest.approx(20.0) and host == pytest.approx(8.0)


def test_readers_find_nothing_in_a_program_without_spans_or_counters():
    bare = _trace([(0, 2), (3, 5)], [("aten::copy_", 2.0, 2.8)])
    ctx = {"trace": bare, "window_s": bare.window_s, "counts": {
        "lstmp_train_fwd": 42}, "step_frames": [10.0, 12.0],
        "batches": [(128, 300)]}
    for kind, names in (("train", ("syncs_per_step.train",
                                   "sync_idle_share.train")),
                        ("score", ("host_idle_share.score",
                                   "padded_share.score"))):
        for name in names:
            assert catalog.reader(name)(dict(ctx, kind=kind)) is None, name
    cpu = _trace([], TRACE.host)
    ctx = {"trace": cpu, "window_s": cpu.window_s, "counts": {}}
    assert catalog.reader("sync_idle_share.train")(
        dict(ctx, kind="train")) is None
    assert catalog.reader("host_idle_share.score")(
        dict(ctx, kind="score")) is None
