"""Training cells: `run_epoch` over a `StreamScheduler`, S streams of
Tbptt-frame chunks, `step_group` steps a CUDA-graph replay.

Set-up builds one net with its momentum state and drives it through
the check's epochs (`check["epochs"]` steps each: the first one step,
so the optimizer's state holds the first gradient, the second ending
at step 3, the third a whole number of groups, so the grouped step
runs a group eagerly, captures one and replays it), each through
`run_epoch` on the window's feed. The window is one more `run_epoch`
over the same feed, which stops at the first whole group that ends
`seconds` after the window starts; the epoch then trains what it has
queued and synchronizes. It does not drain its streams: a real epoch
drains once in hours of audio, and in a window of seconds its partial
batches and eager tail would weigh a hundred times more (and spread
the runs). After the window the reference follows every set-up step
from the same weights and batches.
"""

from __future__ import annotations

import contextlib
import time

import numpy as np
import torch

from bench_h100 import checks, model, traffic
from bench_h100.reference import lstmp as ref


class Feed:
    """What `run_epoch` gets as its scheduler: the batches of one stream
    scheduler, at most `limit` an epoch or, with `stop_at` (perf_counter
    seconds), up to the first whole group of `group` batches that ends
    after it; each one's valid frames counted and, while `record` is a
    list, the batch kept for the reference."""

    def __init__(self, scheduler, group: int):
        self.S = scheduler.S
        self.group = group
        self._scheduler = scheduler
        self._it = iter(scheduler)
        self.limit = None
        self.stop_at = None
        self.record = None
        self.frames: list = []

    @property
    def num_done(self) -> int:
        return self._scheduler.num_done

    def __iter__(self):
        n = 0
        while self.limit is None or n < self.limit:
            if (self.stop_at is not None and n % self.group == 0
                    and time.perf_counter() >= self.stop_at):
                return
            b = next(self._it, None)
            if b is None:
                return
            n += 1
            self.frames.append(float(b.mask.sum(dtype=np.float64)))
            if self.record is not None:
                self.record.append(for_reference(b))
            yield b


def for_reference(b) -> dict:
    """A scheduler batch as `reference.lstmp.train_steps` reads it."""
    return {"feats": b.feats, "ids": b.tgt_ids[..., 0], "mask": b.mask,
            "reset": b.reset_flags}


def epoch_starts(epochs) -> set:
    """The step numbers at which the check's epochs start."""
    return {sum(epochs[:i]) for i in range(len(epochs))}


@contextlib.contextmanager
def losses_per_step():
    """Let the epoch's statistics keep every step's loss: the progress
    report (`LossStats.loss_vec`, the reference's ProgressLoss) after
    every step instead of every 6 minutes of audio."""
    from kaldi_lstm_tpu_torch.train.loss import LossStats
    old = LossStats.PROGRESS_STEP
    LossStats.PROGRESS_STEP = 0
    try:
        yield
    finally:
        LossStats.PROGRESS_STEP = old


def _norms(ts) -> list:
    return [float(t.float().norm()) for t in ts]


def run(cell, seed: int, seconds: float, window, device, control=None):
    """One run of a training cell; `window(fn)` times and, in a traced
    run, profiles `fn()`. Returns the run's record (see run.py)."""
    from kaldi_lstm_tpu_torch.train.streams import StreamScheduler
    from kaldi_lstm_tpu_torch.train.trainer import TrainOptions, run_epoch

    cfg, tr, chk = cell.config, cell.traffic, cell.check
    parts, t = {}, time.perf_counter()
    pool = traffic.make_pool(tr, cfg["input_dim"], cfg["num_pdfs"], seed)
    parts["pool"], t = time.perf_counter() - t, time.perf_counter()
    weights = model.make_weights(cfg, seed, device)
    nnet, params = model.program_net(cfg, weights, tr["streams"])
    if control == "bf16":
        nnet.set_matmul_dtype(torch.bfloat16)
    opts = TrainOptions(learn_rate=tr["learn_rate"], momentum=tr["momentum"])
    feed = Feed(StreamScheduler(
        traffic.TrainSource(pool, seed), traffic.Targets(pool),
        cfg["input_dim"], num_stream=tr["streams"], batch_size=tr["tbptt"],
        targets_delay=tr["targets_delay"]), tr["step_group"])
    w0 = [leaf for _, leaf in ref.leaves(weights)]

    def epoch(limit, opt_state):
        feed.limit = limit
        return run_epoch(nnet, params, feed, opts, opt_state=opt_state,
                         step_group=tr["step_group"])

    feed.record, losses, grad0, change = [], [], None, {}
    opt_state, done = None, 0
    with losses_per_step():
        for k in chk["epochs"]:
            res = epoch(k, opt_state)
            opt_state, done = res.opt_state, done + k
            losses += res.stats.loss_vec
            if grad0 is None:
                grad0 = _norms(model.program_leaves(opt_state.corr))
            change[done] = _norms(a - b for a, b in zip(
                model.program_leaves(params), w0))
    batches, feed.record = feed.record, None
    parts["net and check steps"] = time.perf_counter() - t

    feed.limit = None
    first = len(feed.frames)
    frames_trained = []

    def timed():
        feed.stop_at = time.perf_counter() + seconds
        frames_trained.append(epoch(None, opt_state).total_frames)

    span = window(timed)
    step_frames = feed.frames[first:]
    frames = float(sum(step_frames))
    del nnet, params, opt_state, res
    out = {"span": span, "attempted": len(step_frames), "failed": 0,
           "e2e": {"train_frames_per_s": frames / span["seconds"]},
           "ctx": {"step_frames": step_frames, "streams": tr["streams"]},
           "setup_parts": parts}

    def reference():
        r = ref.train_steps(weights, batches, epoch_starts(chk["epochs"]),
                            tr["learn_rate"],
                            tr["momentum"], device, snap_at=set(change))
        prog = {"loss": losses, "grad0": grad0, "change": change}
        nums = checks.train_numbers(prog, r, chk["change_at"])
        nums["change_gap.setup"] = checks.train_numbers(
            prog, r, done)["change_gap"]
        nums["frames_gap"] = abs(frames - float(frames_trained[0]))
        return nums

    out["reference"] = reference
    return out
