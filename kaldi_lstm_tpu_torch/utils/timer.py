"""Wall-clock timer + per-section accumulating profiler, PyTorch edition
of ``kaldi_lstm_tpu.utils.timer``.

The accumulator stands in for Kaldi's CuDevice::AccuProfile /
PrintProfile (reference cu-matrix.cc:1028-1040,
bd-nnet-train-lstm-streams.cc:314-316): named sections accumulate elapsed
host seconds and can be dumped at exit. Device kernel time is captured
separately, with torch.profiler or CUDA events.
"""

from __future__ import annotations

import time
from collections import defaultdict
from contextlib import contextmanager


class Timer:
    def __init__(self):
        self.reset()

    def reset(self) -> None:
        self._t0 = time.perf_counter()

    def elapsed(self) -> float:
        return time.perf_counter() - self._t0


class AccuProfiler:
    """Accumulate wall time per named section; print a profile at exit."""

    def __init__(self):
        self.acc: dict[str, float] = defaultdict(float)
        self.count: dict[str, int] = defaultdict(int)

    @contextmanager
    def section(self, name: str):
        t0 = time.perf_counter()
        try:
            yield
        finally:
            dt = time.perf_counter() - t0
            self.acc[name] += dt
            self.count[name] += 1

    def report(self) -> str:
        lines = ["-----[ profile ]-----"]
        for name, total in sorted(self.acc.items(), key=lambda kv: -kv[1]):
            lines.append(f"{name}\t{total:.3f}s\t({self.count[name]} calls)")
        return "\n".join(lines)
