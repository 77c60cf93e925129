"""Wall-clock timer + the program's span and counter registry, PyTorch
edition of ``kaldi_lstm_tpu.utils.timer``.

The accumulator stands in for Kaldi's CuDevice::AccuProfile /
PrintProfile (reference cu-matrix.cc:1028-1040,
bd-nnet-train-lstm-streams.cc:314-316): named sections accumulate elapsed
host seconds and can be dumped at exit. `PROFILE` is the process-wide
instance that the epoch loop, the grouped step and the scorer feed. While
a torch.profiler run is active on the calling thread, a section also
opens the profiler's user-scope range under its name, so the span lands
in the same trace as the device's kernels, on the same clock; device
kernel time itself comes from that trace or from CUDA events.

Span names start with the role of the thread they run on: ``epoch.*``
and ``step.*`` the training loop's thread, ``stage.*`` its staging
thread, ``score.*`` the scorer's caller. A profiler records the thread
that started it (and the autograd threads), so a trace holds the
``stage.*`` spans only when it records every thread; the registry
counts them always. Integer counters are declared below at 0, so every
snapshot has every key whatever the caller has imported.
"""

from __future__ import annotations

import threading
import time
from collections import defaultdict

import torch

# name -> what it counts (ops/counts.py includes them in snapshot_counts)
COUNTERS = {
    "epoch.steps": "training steps run by run_epoch",
    "epoch.sync.report": "stats drains for the 1000-utterance speed report",
    "epoch.sync.block": "stats drains after STATS_FLUSH pending blocks",
    "epoch.sync.end": "the drain at an epoch's end",
    "step.replays": "CUDA-graph replays of grouped steps",
    "score.batches": "batches AmScorer dispatched",
    "score.frames": "unpadded frames AmScorer dispatched",
    "score.frame_slots": "B x T_b frame slots of those batches",
    "score.pinned_bytes": "pinned host bytes AmScorer requested (not fresh"
                          " allocations: the host cache reuses blocks)",
}


class Timer:
    def __init__(self):
        self.reset()

    def reset(self) -> None:
        self._t0 = time.perf_counter()

    def elapsed(self) -> float:
        return time.perf_counter() - self._t0


class _Section:
    """One timed section; see `AccuProfiler.section`."""
    __slots__ = ("prof", "name", "args", "t0", "handle")

    def __init__(self, prof: "AccuProfiler", name: str, args: tuple):
        self.prof, self.name, self.args = prof, name, args

    def __enter__(self):
        # the profiler's range only while one records this thread:
        # entering it costs ~14 us even when none does
        self.handle = (torch.autograd._record_function_with_args_enter(
            self.name, *self.args)
            if torch._C._autograd._profiler_enabled() else None)
        self.t0 = time.perf_counter()
        return self

    def __exit__(self, *exc):
        dt = time.perf_counter() - self.t0
        if self.handle is not None:
            torch.autograd._record_function_with_args_exit(self.handle)
        with self.prof.lock:
            self.prof.acc[self.name] += dt
            self.prof.count[self.name] += 1
        return False


class AccuProfiler:
    """Accumulate wall time per named section and integer counters;
    print a profile at exit. Threads may share one: updates and
    snapshots take its lock."""

    def __init__(self, counters=()):
        self.acc: dict[str, float] = defaultdict(float)
        self.count: dict[str, int] = defaultdict(int)
        self.counters: dict[str, int] = dict.fromkeys(counters, 0)
        self.lock = threading.Lock()

    def section(self, name: str, *args: int) -> _Section:
        """A context manager that adds its host seconds to `name`. Under
        an active torch.profiler it is also a range of that name in the
        trace, with `args` (e.g. a batch number) as the range's inputs,
        which a trace recorded with shapes shows. It never synchronizes
        the device."""
        return _Section(self, name, args)

    def add(self, name: str, n: int = 1) -> None:
        with self.lock:
            self.counters[name] += n

    def snapshot(self) -> dict:
        """Every section's seconds and every counter, by name."""
        with self.lock:
            return {**self.acc, **self.counters}

    def since(self, before: dict) -> dict:
        """What changed from `snapshot()` `before` to now, by name."""
        return {k: v - before.get(k, 0) for k, v in self.snapshot().items()}

    def report(self) -> str:
        lines = ["-----[ profile ]-----"]
        for name, total in sorted(self.acc.items(), key=lambda kv: -kv[1]):
            lines.append(f"{name}\t{total:.3f}s\t({self.count[name]} calls)")
        return "\n".join(lines)


PROFILE = AccuProfiler(COUNTERS)
