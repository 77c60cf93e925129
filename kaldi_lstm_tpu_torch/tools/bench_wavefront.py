"""A/B of the serial two-layer LSTMP schedule against the wavefront
kernels (K6/K7, ``ops/lstm_stack.py``) at the deep config's shape
(2 x LSTMP 800 cells / 512 projection over 40-dim features, T = 20);
the port of ``tools_dev/bench_wavefront.py`` and
``tools_dev/profile_wavefront.py``.

    python -m kaldi_lstm_tpu_torch.tools.bench_wavefront [S] [G] [reps]
        [mode] [--device cuda]

S streams (default 512), G calls per timed run (16), reps runs (3);
the time of a schedule is the median over the runs of one run's time
divided by G. Every schedule makes one warm-up call first, so it is
called ``calls_per_bench(G, reps)`` times. Modes:

* ``ab`` (default): the serial training forward (K1 per layer, layer 2
  fed layer 1's r) against the wavefront forward (K6) at tb 5, 4, 2;
  then the serial inference forward (K5 per layer) against the
  wavefront inference (K7) at tb 5, 4. float32 (the bf16 rows wait for
  ROADMAP B.3).
* ``ablate``: K6 with only layer 1's work, only layer 2's, both, and the
  single-layer kernel K1: whether the two layers' work overlaps.
* ``profile``: device time per kernel and call of the serial and the
  wavefront forward (torch.profiler).

On the card the times are CUDA-event times. ``--device cpu`` runs the
plain versions as a rehearsal; its times are host times of PyTorch's CPU
kernels and say nothing about the card.
"""

from __future__ import annotations

import argparse
import statistics
import sys
import time

import numpy as np
import torch

from kaldi_lstm_tpu_torch.ops import lstm_infer as li
from kaldi_lstm_tpu_torch.ops import lstm_stack as ls
from kaldi_lstm_tpu_torch.ops import lstm_train as lt
from kaldi_lstm_tpu_torch.ops.lstm_cell import init_lstm_params, zero_state
from kaldi_lstm_tpu_torch.utils import device_from_arg

T, I, C, R = 20, 40, 800, 512
CLIP = 50.0
FWD_TBS = (5, 4, 2)
INFER_TBS = (5, 4)


def calls_per_bench(G: int, reps: int) -> int:
    """Calls of one schedule by ``Bench.time``: a warm-up, then reps
    runs of G."""
    return 1 + G * reps


class Bench:
    """The deep config's two layers (weights from seed 0, scale 0.05),
    x [T, S, I] from numpy seed 3, zero initial states."""

    def __init__(self, S: int, G: int, reps: int, device: torch.device):
        self.G, self.reps, self.device = G, reps, device
        g = torch.Generator().manual_seed(0)
        self.p1 = init_lstm_params(g, I, C, R, 0.05, device=device)
        self.p2 = init_lstm_params(g, R, C, R, 0.05, device=device)
        rng = np.random.RandomState(3)
        self.x = torch.tensor(rng.randn(T, S, I).astype(np.float32),
                              device=device)
        self.s1 = zero_state(S, C, R, device=device)
        self.s2 = zero_state(S, C, R, device=device)

    # --- the schedules ------------------------------------------------
    def serial_fwd(self):
        """Production schedule: K1 over layer 1, r1 through device
        memory, K1 over layer 2."""
        r1 = lt.lstm_fwd_residuals(self.p1, self.x, self.s1.c, self.s1.r,
                                   cell_clip=CLIP)[2]
        return lt.lstm_fwd_residuals(self.p2, r1, self.s2.c, self.s2.r,
                                     cell_clip=CLIP)[2]

    def serial_one_layer(self):
        return lt.lstm_fwd_residuals(self.p1, self.x, self.s1.c, self.s1.r,
                                     cell_clip=CLIP)[2]

    def wave_fwd(self, tb: int, phases: str = "both"):
        out = ls.lstm_stack_fwd2(self.p1, self.p2, self.x, self.s1, self.s2,
                                 CLIP, tb=tb, phases=phases)
        return out[2] if phases == "l1" else out[5]

    def serial_infer(self):
        with torch.no_grad():
            r1, _ = li.lstm_infer(self.p1, self.x, self.s1, CLIP,
                                  time_major=True)
            return li.lstm_infer(self.p2, r1, self.s2, CLIP,
                                 time_major=True)[0]

    def wave_infer(self, tb: int):
        return ls.lstm_stack_infer2(self.p1, self.p2, self.x, self.s1,
                                    self.s2, CLIP, tb=tb)[0]

    # --- timing -------------------------------------------------------
    def time(self, name: str, fn) -> float:
        """ms per call: median over reps runs of G calls, after one
        warm-up call."""
        cuda = self.device.type == "cuda"
        fn()
        runs = []
        for _ in range(self.reps):
            if cuda:
                a = torch.cuda.Event(enable_timing=True)
                b = torch.cuda.Event(enable_timing=True)
                a.record()
                for _ in range(self.G):
                    fn()
                b.record()
                torch.cuda.synchronize()
                runs.append(a.elapsed_time(b) / self.G)
            else:
                t0 = time.perf_counter()
                for _ in range(self.G):
                    fn()
                runs.append(1e3 * (time.perf_counter() - t0) / self.G)
        med = statistics.median(runs)
        print(f"{name}: {med:.3f} ms/call (runs "
              f"{[round(v, 3) for v in runs]})", flush=True)
        return med


def run_ab(b: Bench) -> dict:
    res = {"serial fwd": b.time("serial fwd f32 (K1 x 2)", b.serial_fwd)}
    for tb in FWD_TBS:
        m = b.time(f"wave   fwd f32 tb{tb}", lambda: b.wave_fwd(tb))
        res[f"wave fwd tb{tb}"] = m
        print(f"  -> wavefront speedup {res['serial fwd'] / m:.3f}x",
              flush=True)
    res["serial infer"] = b.time("serial infer f32 (K5 x 2)", b.serial_infer)
    for tb in INFER_TBS:
        m = b.time(f"wave   infer f32 tb{tb}", lambda: b.wave_infer(tb))
        res[f"wave infer tb{tb}"] = m
        print(f"  -> wavefront speedup {res['serial infer'] / m:.3f}x",
              flush=True)
    print("bf16 rows: not run (bf16 K6/K7 are ROADMAP B.3)",
          flush=True)
    return res


def run_ablate(b: Bench) -> dict:
    tl1 = b.time("wave fwd PHASE l1-only tb5", lambda: b.wave_fwd(5, "l1"))
    tl2 = b.time("wave fwd PHASE l2-only tb5", lambda: b.wave_fwd(5, "l2"))
    both = b.time("wave fwd both tb5", lambda: b.wave_fwd(5))
    one = b.time("serial ONE layer (K1)", b.serial_one_layer)
    print(f"sum(l1, l2) = {tl1 + tl2:.3f} ms vs both {both:.3f} ms "
          f"(overlap fraction {(tl1 + tl2 - both) / min(tl1, tl2):.2f}); "
          f"single-layer kernel {one:.3f} ms", flush=True)
    return {"l1": tl1, "l2": tl2, "both": both, "one layer": one}


def run_profile(b: Bench) -> dict:
    """Time per kernel and call over G calls of each forward schedule;
    device time on the card, host time of the CPU ops otherwise."""
    from torch.profiler import ProfilerActivity, profile
    cuda = b.device.type == "cuda"
    acts = [ProfilerActivity.CPU] + ([ProfilerActivity.CUDA] if cuda else [])
    res = {}
    for name, fn in (("serial fwd", b.serial_fwd),
                     ("wave fwd tb5", lambda: b.wave_fwd(5))):
        fn()
        with profile(activities=acts) as prof:
            for _ in range(b.G):
                fn()
            if cuda:
                torch.cuda.synchronize()
        rows = []
        for e in prof.key_averages():
            if cuda and e.device_type != torch.autograd.DeviceType.CUDA:
                continue
            us = (getattr(e, "self_device_time_total", None)
                  if cuda else e.self_cpu_time_total)
            if us is None:
                us = getattr(e, "self_cuda_time_total", 0.0)
            rows.append((us / b.G, e.count / b.G, e.key))
        total = sum(r[0] for r in rows)
        where = "device" if cuda else "host (CPU ops, not a device time)"
        print(f"=== {name}: {where} {total / 1e3:.3f} ms per call ===",
              flush=True)
        for us, count, key in sorted(rows, reverse=True)[:8]:
            print(f"  {us / 1e3:9.3f} ms x{count:<5g} {key[:80]}",
                  flush=True)
        res[name] = total / 1e3
    return res


MODES = {"ab": run_ab, "ablate": run_ablate, "profile": run_profile}


def main(argv=None) -> int:
    p = argparse.ArgumentParser(description="Serial vs wavefront two-layer "
                                "LSTMP at the deep config's shape")
    p.add_argument("S", nargs="?", type=int, default=512)
    p.add_argument("G", nargs="?", type=int, default=16)
    p.add_argument("reps", nargs="?", type=int, default=3)
    p.add_argument("mode", nargs="?", default="ab", choices=sorted(MODES))
    p.add_argument("--device", default="cuda",
                   help="cuda (default; exits 1 without CUDA) or cpu "
                        "(plain versions, a rehearsal)")
    args = p.parse_args(argv)
    device = device_from_arg(args.device, "bench-wavefront")
    if device is None:
        return 1
    where = torch.cuda.get_device_name(device) if device.type == "cuda" \
        else "cpu"
    print(f"device={where} S={args.S} T={T} I={I} C={C} R={R} G={args.G} "
          f"reps={args.reps} mode={args.mode}", flush=True)
    MODES[args.mode](Bench(args.S, args.G, args.reps, device))
    return 0


if __name__ == "__main__":
    sys.exit(main())
