"""How often K1 and K2 in bf16 miss chip_smoke.py's bf16 rule on a lone
stream, over seeds, on the card.

    python -m kaldi_lstm_tpu_torch.tools.bf16_seed_sweep \\
        [--shape S,T,I] [--seeds FIRST,LAST] [--other DIR]

chip_smoke.py's phase 3d holds a bf16 kernel to its bf16 plain version
by err <= max(0.1 x distance, 2 x noise) (RMS: err the kernel against
the plain version, distance the plain version in bf16 against it in
f32, noise the plain version summing in f64 against it summing in f32).
A bf16 rounding that one valid f32 summation order takes the other way
from another is carried through every later step of a recurrence; with
one stream it moves the whole tensor. For each seed (inputs made as
chip_smoke.py's ``lstm_case`` makes them; C=800, R=512, no dropout; by
default S=1, T=64, I=40 and seeds 140-155) the script prints, as err /
distance beside noise / distance:

* K1 free-running: the kernel, and the plain version run on the CPU (an
  f32 summation order as valid as the card's), each against the plain
  version on the card;
* K1 step by step: the kernel against the plain version's step t from
  the kernel's own c_{t-1}, r_{t-1};
* K1 free-running by chip_smoke.py's S=1 rule: the kernel's err beside
  the larger of the two noise witnesses, the f64 sum's and the CPU
  order's distance from the card's plain version;
* K2 free-running, on the bf16 plain forward's residuals, its worst
  output;

and counts the seeds where each misses the rule. ``--other DIR`` runs the
same in a child process that imports DIR's package (another checkout, for
example the parent commit unpacked with ``git archive``). Needs a card;
exits 1 without one.
"""

from __future__ import annotations

import argparse
import os
import subprocess
import sys


def _rms(t) -> float:
    return float(t.double().pow(2).mean().sqrt())


def _ratios(a, b, c, d) -> tuple[float, float]:
    """(err / distance, noise / distance) of kernel a against the bf16
    plain version b, with c the plain version in f32 and d it summing in
    f64."""
    a, b, c, d = (u.double().to(b.device) for u in (a, b, c, d))
    dist = _rms(b - c)
    return _rms(a - b) / dist, _rms(d - b) / dist


def _misses(err: float, noise: float) -> bool:
    return not err <= max(0.1, 2.0 * noise)


def sweep(S: int, T: int, I: int, seeds: range) -> None:
    import numpy as np
    import torch

    from kaldi_lstm_tpu_torch.ops import lstm_train as lt
    from kaldi_lstm_tpu_torch.ops.lstm_cell import LstmState, init_lstm_params
    torch.backends.cuda.matmul.allow_tf32 = False
    C, R, bf = 800, 512, torch.bfloat16

    def f64(tree):
        return type(tree)(*(v.double() for v in tree))

    def steps(p, x_tm, c0, r0, ck, rk, dt):
        out = [lt.lstm_fwd_residuals_plain(
            p, x_tm[t:t + 1], c0 if t == 0 else ck[t - 1],
            r0 if t == 0 else rk[t - 1], None, 1.0, 50.0, compute_dtype=dt)
            for t in range(T)]
        return tuple(torch.cat([o[i] for o in out]) for i in range(3))

    counts = {"K1 kernel": 0, "K1 plain on the CPU": 0,
              "K1 step by step": 0, "K1 kernel, CPU-order noise": 0,
              "K2 kernel": 0}
    for seed in seeds:
        p = init_lstm_params(torch.Generator().manual_seed(seed), I, C, R,
                             0.04, device="cuda")
        rng = np.random.RandomState(seed)
        x = torch.tensor(rng.randn(S, T, I).astype(np.float32),
                         device="cuda")
        st = LstmState(*(torch.tensor(rng.randn(S, d).astype(np.float32)
                                      * 0.5, device="cuda") for d in (C, R)))
        x_tm = x.transpose(0, 1).contiguous()
        fa = (p, x_tm, st.c, st.r, None, 1.0, 50.0)
        fk = lt.lstm_fwd_residuals_cuda(*fa, compute_dtype=bf)
        fp = lt.lstm_fwd_residuals_plain(*fa, compute_dtype=bf)
        f32 = lt.lstm_fwd_residuals_plain(*fa)
        fd = lt.lstm_fwd_residuals_plain(f64(p), x_tm.double(),
                                         st.c.double(), st.r.double(),
                                         None, 1.0, 50.0, compute_dtype=bf)
        cpu = lt.lstm_fwd_residuals_plain(
            type(p)(*(v.cpu() for v in p)), x_tm.cpu(), st.c.cpu(),
            st.r.cpu(), None, 1.0, 50.0, compute_dtype=bf)
        sk = (steps(p, x_tm, st.c, st.r, fk[1], fk[2], bf),
              steps(p, x_tm, st.c, st.r, fk[1], fk[2], None),
              steps(f64(p), x_tm.double(), st.c.double(), st.r.double(),
                    fk[1].double(), fk[2].double(), bf))
        rows = {"K1 kernel": [_ratios(a, b, c, d)
                              for a, b, c, d in zip(fk, fp, f32, fd)],
                "K1 plain on the CPU": [_ratios(a, b, c, d) for a, b, c, d
                                        in zip(cpu, fp, f32, fd)],
                "K1 step by step": [_ratios(a, b, c, d)
                                    for a, b, c, d in zip(fk, *sk)]}
        # chip_smoke.py's free-running rule at S=1: the noise the larger
        # of the f64 sum's and the CPU order's distance from the card's
        rows["K1 kernel, CPU-order noise"] = [
            (e, max(n, w)) for (e, n), (w, _) in
            zip(rows["K1 kernel"], rows["K1 plain on the CPU"])]
        rng = np.random.RandomState(seed + 100)
        g_r = torch.tensor(rng.randn(T, S, R).astype(np.float32),
                           device="cuda")
        gcT = torch.tensor(rng.randn(S, C).astype(np.float32), device="cuda")
        ba = (p, x_tm, st.c, st.r)
        bk = lt.lstm_bwd_cuda(*ba, *fp, None, 1.0, g_r, gcT, False,
                              compute_dtype=bf)
        bp = lt.lstm_bwd_plain(*ba, *fp, None, 1.0, g_r, gcT, False,
                               compute_dtype=bf)
        b32 = lt.lstm_bwd_plain(*ba, *f32, None, 1.0, g_r, gcT, False)
        bd = lt.lstm_bwd_plain(f64(p), x_tm.double(), st.c.double(),
                               st.r.double(), *(u.double() for u in fp),
                               None, 1.0, g_r.double(), gcT.double(), False,
                               compute_dtype=bf)
        rows["K2 kernel"] = [_ratios(a, b, c, d) for a, b, c, d in zip(
            (*bk[0], bk[2], bk[3]), (*bp[0], bp[2], bp[3]),
            (*b32[0], b32[2], b32[3]), (*bd[0], bd[2], bd[3]))]
        parts = []
        for what, rs in rows.items():
            miss = any(_misses(*r) for r in rs)
            counts[what] += miss
            err, noise = max(rs, key=lambda r: r[0] - max(0.1, 2 * r[1]))
            parts.append(f"{what} {err:.4f} ({noise:.4f})"
                         + (" MISS" if miss else ""))
        print(f"  seed {seed}: " + "; ".join(parts), flush=True)
    print(f"  misses over {len(seeds)} seeds: " + ", ".join(
        f"{k} {v}" for k, v in counts.items()), flush=True)


def main(argv: list[str] | None = None) -> int:
    ap = argparse.ArgumentParser(description="bf16 rule misses over seeds")
    ap.add_argument("--shape", default="1,64,40", help="S,T,I")
    ap.add_argument("--seeds", default="140,155", help="FIRST,LAST")
    ap.add_argument("--other", help="another checkout's root")
    args = ap.parse_args(argv)
    import torch
    if not torch.cuda.is_available():
        print("bf16-seed-sweep: needs a CUDA card", file=sys.stderr)
        return 1
    if args.other:
        tree = os.path.abspath(args.other)
        env = dict(os.environ, PYTHONPATH=tree)
        return subprocess.run([sys.executable, os.path.abspath(__file__),
                               "--shape", args.shape, "--seeds", args.seeds],
                              cwd=tree, env=env).returncode
    S, T, I = (int(v) for v in args.shape.split(","))
    first, last = (int(v) for v in args.seeds.split(","))
    import kaldi_lstm_tpu_torch
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True).stdout.strip()
    print(f"{smi}; S={S} T={T} I={I} C=800 R=512, package "
          f"{os.path.dirname(kaldi_lstm_tpu_torch.__file__)}; err / distance "
          f"(noise / distance) of the worst output", flush=True)
    sweep(S, T, I, range(first, last + 1))
    return 0


if __name__ == "__main__":
    sys.exit(main())
