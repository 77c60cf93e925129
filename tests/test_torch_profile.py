"""The port's span and counter registry (`utils.timer.PROFILE`) on the
CPU: its spans in a torch.profiler trace by name, nothing entered in the
profiler while none runs, every declared counter in
`ops.counts.snapshot_counts()`, and the counts that `run_epoch` and
`AmScorer` feed it against a count by hand."""

import json
import subprocess
import sys

import numpy as np
import pytest
import torch
from torch.profiler import ProfilerActivity, profile

from __graft_entry__ import TINY_PROTO
from kaldi_lstm_tpu_torch.decode.scoring import AmScorer
from kaldi_lstm_tpu_torch.models import Nnet
from kaldi_lstm_tpu_torch.ops import counts
from kaldi_lstm_tpu_torch.train import trainer
from kaldi_lstm_tpu_torch.train.streams import StreamScheduler
from kaldi_lstm_tpu_torch.train.trainer import (
    EpochResult,
    TrainOptions,
    run_epoch,
)
from kaldi_lstm_tpu_torch.utils.timer import COUNTERS, PROFILE, AccuProfiler

D, K, S, T = 8, 32, 4, 5


class _Targets:
    """Alignment targets from a dict, as a posterior reader gives them."""

    def __init__(self, post):
        self.post = post

    def has_key(self, key):
        return key in self.post

    def value(self, key):
        return self.post[key]


def _corpus(n, seed, lo=3, hi=9):
    rng = np.random.RandomState(seed)
    utts = [(f"u{i:03d}", rng.randn(int(rng.randint(lo, hi)), D)
             .astype(np.float32)) for i in range(n)]
    post = {k: [[(int(rng.randint(K)), 1.0)] for _ in range(len(f))]
            for k, f in utts}
    return utts, post


def _scheduler(utts, post):
    return StreamScheduler(iter(utts), _Targets(post), D, S, T, 1)


def _net():
    return Nnet.init_from_proto(TINY_PROTO, torch.Generator().manual_seed(5),
                                "cpu")


def _names(prof) -> list:
    return [e.name() for e in prof.profiler.kineto_results.events()]


def test_span_lands_in_a_cpu_profiler_trace_by_name():
    reg = AccuProfiler()
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        with reg.section("epoch.sync"):
            torch.ones(4).sum()
        with reg.section("score.emit", 7):
            pass
    names = _names(prof)
    assert names.count("epoch.sync") == 1 and names.count("score.emit") == 1
    assert reg.count["epoch.sync"] == 1 and reg.acc["epoch.sync"] > 0


def test_span_enters_no_profiler_range_and_no_sync_when_none_runs(
        monkeypatch):
    def refuse(*a, **k):
        raise AssertionError("entered while no profiler runs")
    monkeypatch.setattr(torch.autograd, "_record_function_with_args_enter",
                        refuse)
    monkeypatch.setattr(torch.profiler, "record_function", refuse)
    monkeypatch.setattr(torch.cuda, "synchronize", refuse)
    reg = AccuProfiler()
    for n in range(3):
        with reg.section("score.stage", n):
            pass
    assert reg.count["score.stage"] == 3


def test_every_declared_counter_is_in_the_snapshot_at_zero():
    counts.reset_counts()
    snap = counts.snapshot_counts()
    assert {k: snap[k] for k in COUNTERS} == dict.fromkeys(COUNTERS, 0)
    assert not set(COUNTERS) & set(counts.launch_counts())
    assert all("." in k and k.split(".")[0] in ("epoch", "step", "score")
               for k in COUNTERS)


def test_snapshot_has_its_keys_before_the_trainer_is_imported():
    """The benchmark windows two snapshots key by key: one taken before
    the trainer and the scorer are imported has every key of one taken
    after."""
    code = ("from kaldi_lstm_tpu_torch.ops.counts import snapshot_counts\n"
            "a = sorted(snapshot_counts())\n"
            "import kaldi_lstm_tpu_torch.train.trainer\n"
            "import kaldi_lstm_tpu_torch.decode.scoring\n"
            "print(a == sorted(snapshot_counts()))\n")
    out = subprocess.run([sys.executable, "-c", code], capture_output=True,
                         text=True, timeout=300)
    assert out.returncode == 0, out.stderr[-2000:]
    assert out.stdout.split()[-1] == "True"


def test_epoch_result_takes_no_profile_by_default():
    res = EpochResult(params=(), opt_state=None, stats=None, num_done=0,
                      total_frames=0.0, elapsed=0.0)
    assert res.profile is None


def _expected_drains(groups, group_size, flush, report_every) -> dict:
    """The drains that `run_epoch`'s rules give for these groups: a
    whole group adds one pending stats block, a tail group one a batch;
    a block drain at `flush` pending, a report drain each time another
    `report_every` utterances are consumed with blocks still pending,
    and the one at the end."""
    want = {"block": 0, "report": 0, "end": 1}
    pending = done = last = 0
    for g in groups:
        pending += 1 if len(g) == group_size else len(g)
        done += sum(b.num_new_utts for b in g)
        if pending >= flush:
            want["block"] += 1
            pending = 0
        if done - last >= report_every:
            want["report"] += 1 if pending else 0
            pending = 0
            last = done - done % report_every
    return want


@pytest.mark.parametrize("flush,report_every", [(3, 7), (2, 1000), (50, 5)])
def test_run_epoch_profile_counts_steps_and_drains(monkeypatch, flush,
                                                   report_every):
    utts, post = _corpus(57, seed=1)
    batches = list(_scheduler(utts, post))
    groups = [batches[i:i + 2] for i in range(0, len(batches), 2)]
    assert len(batches) % 2 == 1   # whole groups and a tail of one batch
    want = _expected_drains(groups, 2, flush, report_every)
    monkeypatch.setattr(trainer, "STATS_FLUSH", flush)
    monkeypatch.setattr(trainer, "REPORT_EVERY", report_every)
    nnet, params = _net()
    res = run_epoch(nnet, params, _scheduler(utts, post),
                    TrainOptions(learn_rate=1e-3), step_group=2)
    prof = res.profile
    assert prof["epoch.steps"] == len(batches)
    assert {t: prof["epoch.sync." + t] for t in want} == want
    assert prof["step.replays"] == 0 and prof["score.batches"] == 0
    assert sum(want.values()) > 1
    for span in ("epoch.wait", "epoch.dispatch", "epoch.sync", "stage.stack"):
        assert prof[span] > 0, span
    assert "stage.pin" not in prof or prof["stage.pin"] == 0


def test_run_epoch_spans_land_in_its_profiler_trace():
    utts, post = _corpus(12, seed=2)
    nnet, params = _net()
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        res = run_epoch(nnet, params, _scheduler(utts, post),
                        TrainOptions(learn_rate=1e-3), step_group=2)
    names = _names(prof)
    assert names.count("epoch.dispatch") == -(-res.profile["epoch.steps"]
                                              // 2)
    assert names.count("epoch.sync") == res.profile["epoch.sync.end"] == 1
    assert "epoch.wait" in names


def _hand_count(lengths, B, bucket):
    slots = 0
    for i in range(0, len(lengths), B):
        slots += B * (-(-max(lengths[i:i + B]) // bucket) * bucket)
    return {"score.batches": -(-len(lengths) // B),
            "score.frames": sum(lengths), "score.frame_slots": slots,
            "score.pinned_bytes": 0}


@pytest.mark.parametrize("n_utts,pipeline", [(7, True), (7, False),
                                             (6, True), (1, False)])
def test_am_scorer_counts_batches_frames_and_slots(n_utts, pipeline):
    utts, _ = _corpus(n_utts, seed=3, lo=1, hi=40)
    nnet, params = _net()
    scorer = AmScorer(nnet, params, apply_log=True, batch_utts=3,
                      length_bucket=8, pipeline=pipeline)
    before = counts.snapshot_counts()
    keys = [k for k, _ in scorer.score_stream(iter(utts))]
    got = {k: v - before[k] for k, v in counts.snapshot_counts().items()
           if k.startswith("score.")}
    assert keys == [k for k, _ in utts]
    assert got == _hand_count([len(f) for _, f in utts], 3, 8)


def test_am_scorer_spans_carry_the_batch_number(tmp_path):
    """In a trace recorded with shapes, each score.* span's input is its
    batch's number: the spans of one batch can be tied together."""
    utts, _ = _corpus(7, seed=4, lo=1, hi=20)
    nnet, params = _net()
    scorer = AmScorer(nnet, params, apply_log=True, batch_utts=3,
                      length_bucket=8, pipeline=True)
    with profile(activities=[ProfilerActivity.CPU],
                 record_shapes=True) as prof:
        list(scorer.score_stream(iter(utts)))
    path = str(tmp_path / "trace.json")
    prof.export_chrome_trace(path)
    with open(path) as f:
        events = json.load(f)["traceEvents"]
    by_name: dict = {}
    for e in events:
        if e.get("name", "").startswith("score."):
            by_name.setdefault(e["name"], []).append(
                e["args"]["Concrete Inputs"][0])
    assert by_name["score.stage"] == by_name["score.dispatch"] == \
        ["0", "1", "2"]
    assert by_name["score.emit"] == ["0"] * 3 + ["1"] * 3 + ["2"]
    assert PROFILE.counters["score.batches"] >= 3


def test_am_scorer_hooks_keep_their_contract():
    """Callers wrap `_dispatch` (one group in, the device result out) and
    `_fetch` (one device result in): counting the spans' batch numbers
    changes neither, and the wrapped scorer still scores every utterance."""
    utts, _ = _corpus(5, seed=6, lo=1, hi=20)
    nnet, params = _net()
    scorer = AmScorer(nnet, params, apply_log=True, batch_utts=2,
                      length_bucket=8, pipeline=True)
    pend, fetched = [], []
    dispatch, fetch = scorer._dispatch, scorer._fetch
    scorer._dispatch = lambda g: pend.append(dispatch(g)) or pend[-1]
    scorer._fetch = lambda y: fetched.append(y) or fetch(y)
    out = dict(scorer.score_stream(iter(utts)))
    assert list(out) == [k for k, _ in utts]
    assert all(isinstance(y, torch.Tensor) for y in pend)
    assert [id(y) for y in fetched] == [id(y) for y in pend]
    assert (scorer.dispatched, scorer.emitted) == (3, 3)


def test_threads_sharing_the_registry_lose_no_update():
    """Sections and counters from more threads than cores, with the
    interpreter switching threads as often as it can: every one counts."""
    import os
    import threading
    reg = AccuProfiler(("epoch.steps",))
    n_threads, n = 2 * (os.cpu_count() or 2) + 2, 400

    def work():
        for _ in range(n):
            with reg.section("stage.pin"):
                pass
            reg.add("epoch.steps")
            reg.snapshot()

    old = sys.getswitchinterval()
    sys.setswitchinterval(1e-6)
    try:
        threads = [threading.Thread(target=work) for _ in range(n_threads)]
        for t in threads:
            t.start()
        for t in threads:
            t.join(timeout=60)
    finally:
        sys.setswitchinterval(old)
    assert not any(t.is_alive() for t in threads)
    assert reg.count["stage.pin"] == reg.counters["epoch.steps"] \
        == n_threads * n
