"""How often K1 and K2 in bf16 (with ``--stack``, K6 and K7 in bf16) miss
chip_smoke.py's bf16 rule, over seeds, on the card.

    python -m kaldi_lstm_tpu_torch.tools.bf16_seed_sweep \\
        [--shape S,T,I] [--seeds FIRST,LAST] [--scale W] [--clip L]
        [--states W0] [--stack] [--other DIR]

chip_smoke.py's phase 3d holds a bf16 kernel to its bf16 plain version
by err <= max(0.1 x distance, 2 x noise) (RMS: err the kernel against
the plain version, distance the plain version in bf16 against it in
f32, noise the plain version summing in f64 against it summing in f32).
A bf16 rounding that one valid f32 summation order takes the other way
from another is carried through every later step of a recurrence; with
one stream it moves the whole tensor. For each seed (inputs made as
chip_smoke.py's ``lstm_case`` makes them, with the weights uniform in
+-W, by default the deep configuration's 0.04, and the initial states
normal times W0, by default 0.5; C=800, R=512, no dropout, cell clip L,
by default 50; by default S=1, T=64, I=40 and seeds 140-155) the
script prints, as err / distance beside noise / distance:

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
* K5 free-running (its r and final c) against its plain version on the
  card;
* for K1, K2 and K5, the kernel's tc-exact mirror (``lstm_fwd_tc_plain``,
  ``lstm_bwd_split_plain``, ``lstm_infer_tc_plain`` with ``tc``: its
  tiles, its tensor cores' sums by ``ops/tc_sum.py``'s model and its
  fused cell math, run on the card) against the plain version, the
  kernel against that mirror (a miss where it parts by more than
  TC_SHARE of the distance), and the kernel by the rule with the
  mirror's distance as one more noise witness (K1: the larger of the
  f64 sum's, the CPU order's and the mirror's);

and counts the seeds where each misses the rule. ``--stack`` runs two
stacked layers (layer 2's input width R) and prints, for K6 in bf16 (its
six residuals) and K7 in bf16 (r2 and the final c1, r1, c2):

* the kernel against the plain version on the card;
* the plain version run on the CPU against it on the card;
* the kernel's mirror (``lstm_stack_fwd2_tc_plain``,
  ``lstm_stack_infer2_tc_plain`` on the card's SM count: the kernel's
  tiles, sum order by tile and rounding points, summed in torch) run on
  the CPU against the plain version on the card;
* the kernel by the rule with the CPU order's distance as a second noise
  witness;
* the tc-exact mirror (``tc=True``, run on the card, whose tanh and exp
  are the kernels'), against the plain version, the kernel against it
  (gate TC_SHARE), and the kernel by the rule with the three witnesses.

``--other DIR`` runs the same in a child process that imports DIR's
package (another checkout, for example the parent commit unpacked with
``git archive``). Needs a card; exits 1 without one.
"""

from __future__ import annotations

import argparse
import functools
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


# chip_smoke.py's gate on a kernel against its tc-exact mirror
TC_SHARE = 0.02
TC_ROW = "against its tc-exact mirror"


def _tc_rows(rows: dict, name: str, kernel, mirror, plain, f32, f64,
             witness: str | None = None) -> None:
    """Rows of a kernel's tc-exact mirror: the mirror against the plain
    version (beside the f64 sum's noise, as the kernel's row), the kernel
    against the mirror (err / distance; a miss above TC_SHARE), and the
    kernel by the rule with the mirror's distance as one more noise
    witness beside the f64 sum's (and beside the row ``witness``'s
    distance, the CPU order's)."""
    dist = [_rms(b.double() - c.double()) for b, c in zip(plain, f32)]
    rows[f"{name} tc-exact mirror"] = [
        _ratios(m, b, c, d) for m, b, c, d in zip(mirror, plain, f32, f64)]
    rows[f"{name} kernel {TC_ROW}"] = [
        (_rms(k.double() - m.double()) / d, 0.0)
        for k, m, d in zip(kernel, mirror, dist)]
    other = rows[witness] if witness else [(0.0, 0.0)] * len(dist)
    rows[f"{name} kernel, with the tc-exact witness"] = [
        (e, max(n, t, w)) for (e, n), (t, _), (w, _) in zip(
            rows[f"{name} kernel"], rows[f"{name} tc-exact mirror"], other)]


def sweep(S: int, T: int, I: int, seeds: range, scale: float = 0.04,
          clip: float = 50.0, states: float = 0.5) -> None:
    import numpy as np
    import torch

    from kaldi_lstm_tpu_torch.ops import lstm_infer as li
    from kaldi_lstm_tpu_torch.ops import lstm_train as lt
    from kaldi_lstm_tpu_torch.ops.lstm_cell import (
        LstmState,
        init_lstm_params,
        lstm_scan,
    )
    torch.backends.cuda.matmul.allow_tf32 = False
    C, R, bf = 800, 512, torch.bfloat16
    sms = torch.cuda.get_device_properties(0).multi_processor_count

    def f64(tree):
        return type(tree)(*(v.double() for v in tree))

    def steps(p, x_tm, c0, r0, ck, rk, dt):
        out = [lt.lstm_fwd_residuals_plain(
            p, x_tm[t:t + 1], c0 if t == 0 else ck[t - 1],
            r0 if t == 0 else rk[t - 1], None, 1.0, clip, compute_dtype=dt)
            for t in range(T)]
        return tuple(torch.cat([o[i] for o in out]) for i in range(3))

    counts: dict = {}
    for seed in seeds:
        p = init_lstm_params(torch.Generator().manual_seed(seed), I, C, R,
                             scale, device="cuda")
        rng = np.random.RandomState(seed)
        x = torch.tensor(rng.randn(S, T, I).astype(np.float32),
                         device="cuda")
        st = LstmState(*(torch.tensor(rng.randn(S, d).astype(np.float32)
                                      * states, device="cuda")
                          for d in (C, R)))
        x_tm = x.transpose(0, 1).contiguous()
        fa = (p, x_tm, st.c, st.r, None, 1.0, clip)
        fk = lt.lstm_fwd_residuals_cuda(*fa, compute_dtype=bf)
        ftc = lt.lstm_fwd_tc_plain(*fa, compute_dtype=bf, tc=True)
        fp = lt.lstm_fwd_residuals_plain(*fa, compute_dtype=bf)
        f32 = lt.lstm_fwd_residuals_plain(*fa)
        fd = lt.lstm_fwd_residuals_plain(f64(p), x_tm.double(),
                                         st.c.double(), st.r.double(),
                                         None, 1.0, clip, compute_dtype=bf)
        cpu = lt.lstm_fwd_residuals_plain(
            type(p)(*(v.cpu() for v in p)), x_tm.cpu(), st.c.cpu(),
            st.r.cpu(), None, 1.0, clip, compute_dtype=bf)
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
        _tc_rows(rows, "K1", fk, ftc, fp, f32, fd, "K1 plain on the CPU")
        # K5 in bf16 (mma.sync on zeroed accumulators, the slices summed
        # by f32 adds) on the same layer: r and the final c
        ik = li.lstm_infer(p, x_tm, st, clip, time_major=True,
                           compute_dtype=bf)
        ip, i32, i64 = (lstm_scan(q, xx, ss, clip, compute_dtype=dt,
                                  time_major=True) for q, xx, ss, dt in (
            (p, x_tm, st, bf), (p, x_tm, st, None),
            (f64(p), x_tm.double(), f64(st), bf)))
        rows["K5 kernel"] = [_ratios(*(o[0] for o in (ik, ip, i32, i64))),
                             _ratios(*(o[1].c for o in (ik, ip, i32, i64)))]
        itc = li.lstm_infer_tc_plain(p, x_tm, st.c, st.r, clip, sms=sms,
                                     tc=True)
        _tc_rows(rows, "K5", (ik[0], ik[1].c), itc, (ip[0], ip[1].c),
                 (i32[0], i32[1].c), (i64[0], i64[1].c))
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
        btc = lt.lstm_bwd_split_plain(*ba, *fp, None, 1.0, g_r, gcT, False,
                                      sms=sms, compute_dtype=bf, tc=True)
        _tc_rows(rows, "K2", (*bk[0], bk[2], bk[3]),
                 (*btc[0], btc[2], btc[3]), (*bp[0], bp[2], bp[3]),
                 (*b32[0], b32[2], b32[3]), (*bd[0], bd[2], bd[3]))
        _report(seed, rows, counts)
    _total(seeds, counts)


def _report(seed: int, rows: dict, counts: dict) -> None:
    """One seed's line: each row's worst output, err / distance (noise /
    distance), MISS where an output misses the rule."""
    parts = []
    for what, rs in rows.items():
        miss = any(r[0] > TC_SHARE if what.endswith(TC_ROW) else
                   _misses(*r) for r in rs)
        counts[what] = counts.get(what, 0) + miss
        err, noise = max(rs, key=lambda r: r[0] - max(0.1, 2 * r[1]))
        parts.append(f"{what} {err:.4f} ({noise:.4f})"
                     + (" MISS" if miss else ""))
    print(f"  seed {seed}: " + "; ".join(parts), flush=True)


def _total(seeds: range, counts: dict) -> None:
    print(f"  misses over {len(seeds)} seeds: " + ", ".join(
        f"{k} {v}" for k, v in counts.items()), flush=True)


def sweep_stack(S: int, T: int, I: int, seeds: range, scale: float,
                clip: float, states: float) -> None:
    """K6 and K7 in bf16 over two stacked layers: each kernel, the plain
    version on the CPU and the kernel's mirror on the CPU, against the
    plain version on the card."""
    import numpy as np
    import torch

    from kaldi_lstm_tpu_torch.ops import lstm_stack as ls
    from kaldi_lstm_tpu_torch.ops.lstm_cell import LstmState, init_lstm_params
    torch.backends.cuda.matmul.allow_tf32 = False
    C, R, bf = 800, 512, torch.bfloat16
    sms = torch.cuda.get_device_properties(0).multi_processor_count

    def to(tree, fn):
        if isinstance(tree, torch.Tensor):
            return fn(tree)
        items = [to(v, fn) for v in tree]
        return type(tree)(*items) if hasattr(tree, "_fields") \
            else tuple(items)

    def k7(o):      # r2 and the final c1, r1, c2 (r2T is r2's last row)
        return o[0], o[1].c, o[1].r, o[2].c

    counts: dict = {}
    for seed in seeds:
        g = torch.Generator().manual_seed(seed)
        p1 = init_lstm_params(g, I, C, R, scale, device="cuda")
        p2 = init_lstm_params(g, R, C, R, scale, device="cuda")
        rng = np.random.RandomState(seed)
        x = torch.tensor(rng.randn(T, S, I).astype(np.float32),
                         device="cuda")
        s1, s2 = (LstmState(*(torch.tensor(rng.randn(S, d).astype(
            np.float32) * states, device="cuda") for d in (C, R)))
            for _ in range(2))
        a = (p1, p2, x, s1, s2)
        cpu = to(a, lambda t: t.cpu())
        f64 = to(a, lambda t: t.double())
        rows = {}
        for name, kern, plain, mirror, pick in (
                ("K6", ls.lstm_stack_fwd2_cuda, ls.lstm_stack_fwd2_plain,
                 ls.lstm_stack_fwd2_tc_plain, tuple),
                ("K7", ls.lstm_stack_infer2_cuda, ls.lstm_stack_infer2_plain,
                 functools.partial(ls.lstm_stack_infer2_tc_plain, sms=sms),
                 k7)):
            fk = pick(kern(*a, clip, compute_dtype=bf))
            fp = pick(plain(*a, clip, compute_dtype=bf))
            f32 = pick(plain(*a, clip))
            fd = pick(plain(*f64, clip, compute_dtype=bf))
            fc = pick(plain(*cpu, clip, compute_dtype=bf))
            fm = pick(mirror(*cpu, clip))
            rows[f"{name} kernel"] = [_ratios(*u) for u in
                                      zip(fk, fp, f32, fd)]
            rows[f"{name} plain on the CPU"] = [_ratios(*u) for u in
                                                zip(fc, fp, f32, fd)]
            rows[f"{name} mirror on the CPU"] = [_ratios(*u) for u in
                                                 zip(fm, fp, f32, fd)]
            rows[f"{name} kernel, CPU-order noise"] = [
                (e, max(n, w)) for (e, n), (w, _) in
                zip(rows[f"{name} kernel"],
                    rows[f"{name} plain on the CPU"])]
            _tc_rows(rows, name, fk, pick(mirror(*a, clip, tc=True)), fp,
                     f32, fd, f"{name} plain on the CPU")
        _report(seed, rows, counts)
    _total(seeds, counts)


def main(argv: list[str] | None = None) -> int:
    ap = argparse.ArgumentParser(description="bf16 rule misses over seeds")
    ap.add_argument("--shape", default="1,64,40", help="S,T,I")
    ap.add_argument("--seeds", default="140,155", help="FIRST,LAST")
    ap.add_argument("--scale", type=float, default=0.04,
                    help="the weights' uniform range +-W")
    ap.add_argument("--clip", type=float, default=50.0, help="cell clip")
    ap.add_argument("--states", type=float, default=0.5,
                    help="the initial states' scale (normal, times W0)")
    ap.add_argument("--stack", action="store_true",
                    help="K6 and K7 in bf16 over two stacked layers")
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
                               "--shape", args.shape, "--seeds", args.seeds,
                               "--scale", str(args.scale), "--clip",
                               str(args.clip), "--states", str(args.states)]
                              + (["--stack"] if args.stack else []),
                              cwd=tree, env=env).returncode
    S, T, I = (int(v) for v in args.shape.split(","))
    first, last = (int(v) for v in args.seeds.split(","))
    import kaldi_lstm_tpu_torch
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True).stdout.strip()
    print(f"{smi}; S={S} T={T} I={I} C=800 R=512, weights +-{args.scale:g}"
          f", clip {args.clip:g}, states x{args.states:g}"
          f"{', two layers' if args.stack else ''}, "
          f"package {os.path.dirname(kaldi_lstm_tpu_torch.__file__)}; err / "
          f"distance (noise / distance) of the worst output", flush=True)
    run = sweep_stack if args.stack else sweep
    run(S, T, I, range(first, last + 1), args.scale, args.clip, args.states)
    return 0


if __name__ == "__main__":
    sys.exit(main())
