"""Time this tree's LSTMP inference kernel (K5, ``ops.lstm_infer``),
training forward and backward (K1, K2, ``ops.lstm_train``), fused senone
affine + xent forward and backward (K3, K4, ``ops.xent_affine``) and
two-layer wavefront kernels (K6, K7, ``ops.lstm_stack``), in f32 or
bf16, against another checkout's, on the card, in turns, and say
whether the two trees' outputs are equal bit for bit.

    python -m kaldi_lstm_tpu_torch.tools.bench_infer_ab OTHER_DIR \\
        [k5:S,T,I | k1:S,T,I | k2:S,T,I | k6:S,T,I | k7:S,T,I |
         k5b:S,T,I | k1b:S,T,I | k2b:S,T,I | k6b:S,T,I | k7b:S,T,I |
         k3:N,R,K | k4:N,R,K | k3b:N,R,K | k4b:N,R,K ...]

OTHER_DIR is the root of another checkout of this repository (for
example the parent commit unpacked with ``git archive``). For each case
(default: K5 at the cross-validation shape k5:256,20,40 and the serving
shape k5:8,1000,40, K1 at the flagship training shape k1:256,20,40 and
the deep net's layer 2 k1:256,20,512; C=800, R=512 throughout; a bare
S,T,I means K5; a trailing b means ``compute_dtype=torch.bfloat16``; k2
is K2 without dx on K1's residuals of the same inputs; k6 / k7 are K6 /
K7 over two stack-compatible layers (layer 2's input width R) at the
default time block; k3 / k4 are K3 / K4 at N frames, R projections and K
classes, one target a frame, every frame unmasked, K4 on K3's lse of the
same inputs) the script runs the kernel's entry point of the other tree,
this tree, this tree, the other tree, each in a process of its own that
imports that tree's package and builds its kernels, and prints each
process's median CUDA-event time over 5 calls (after one warm-up call),
its launches per call, a digest of its last call's outputs, and the
card's name and power limit; each case's JSON line says whether the
outputs are equal bit for bit (``outputs_bit_for_bit``: every process's
digest the same) and whether each tree repeats itself. K1 runs
time-major, without dropout, clip 50. The inputs are made from numpy
seed 0 in every process, so both trees see the same weights and
features. Needs a CUDA card.
"""

from __future__ import annotations

import json
import os
import subprocess
import sys

SHAPES = ("k5:256,20,40", "k5:8,1000,40", "k1:256,20,40", "k1:256,20,512")
C, R = 800, 512


def _time_here(shape: str) -> dict:
    """Runs in the child: the median time of this process's package, its
    launches per call and a digest of its last call's outputs."""
    import numpy as np
    import torch

    from kaldi_lstm_tpu_torch.ops import lstm_infer as li
    from kaldi_lstm_tpu_torch.ops import lstm_train as lt
    from kaldi_lstm_tpu_torch.ops.lstm_cell import LstmParams, LstmState
    kernel, _, dims = shape.rpartition(":")
    rng = np.random.RandomState(0)

    def u(*dims):
        return torch.tensor(rng.uniform(-0.04, 0.04, dims)
                            .astype(np.float32), device="cuda")

    if kernel in ("k3", "k4", "k3b", "k4b"):
        return _time_xent(kernel, *(int(v) for v in dims.split(",")), rng,
                          u)
    S, T, I = (int(v) for v in dims.split(","))

    p = LstmParams(u(4 * C, I), u(4 * C, R), u(4 * C), u(C), u(C), u(C),
                   u(R, C))
    x = torch.tensor(rng.randn(S, T, I).astype(np.float32), device="cuda")
    st = LstmState(u(S, C), u(S, R))
    dt = torch.bfloat16 if kernel.endswith("b") else None
    x_tm = x.transpose(0, 1).contiguous()
    if kernel in ("k6", "k7", "k6b", "k7b"):
        from kaldi_lstm_tpu_torch.ops import lstm_stack as ls
        p2 = LstmParams(u(4 * C, R), u(4 * C, R), u(4 * C), u(C), u(C),
                        u(C), u(R, C))
        st2 = LstmState(u(S, C), u(S, R))
        mod = ls
        fn = (ls.lstm_stack_fwd2_cuda if kernel.startswith("k6")
              else ls.lstm_stack_infer2_cuda)

        def call():
            return fn(p, p2, x_tm, st, st2, 50.0, compute_dtype=dt)
    elif kernel in ("k2", "k2b"):
        mod = lt
        res = lt.lstm_fwd_residuals(p, x_tm, st.c, st.r, None, 1.0, 50.0,
                                    compute_dtype=dt)
        g_r = torch.tensor(rng.randn(T, S, R).astype(np.float32),
                           device="cuda")
        gcT = torch.tensor(rng.randn(S, C).astype(np.float32),
                           device="cuda")

        def call():
            return lt.lstm_bwd(p, x_tm, st.c, st.r, *res, None, 1.0, g_r,
                               gcT, False, compute_dtype=dt)
    elif kernel in ("k1", "k1b"):
        mod = lt

        def call():
            return lt.lstm_fwd_residuals(p, x_tm, st.c, st.r, None, 1.0,
                                         50.0, compute_dtype=dt)
    else:
        mod = li

        def call():
            return li.lstm_infer(p, x, st, compute_dtype=dt)
    ms, out = _median_times(call, mod)
    launches = {"k1": lt.FWD_LAUNCHES, "k1b": lt.FWD_BF16_LAUNCHES,
                "k2": lt.BWD_LAUNCHES, "k2b": lt.BWD_BF16_LAUNCHES,
                "k5b": li.BF16_LAUNCHES}.get(kernel, li.LAUNCHES)
    if kernel in ("k6", "k7", "k6b", "k7b"):
        launches = {"k6": ls.FWD2_LAUNCHES, "k7": ls.INFER2_LAUNCHES,
                    "k6b": ls.FWD2_BF16_LAUNCHES,
                    "k7b": ls.INFER2_BF16_LAUNCHES}[kernel]
    return {"ms": ms, "launches": launches / 5, "digest": _digest(out)}


def _digest(out) -> str:
    """sha256 of the bytes of every tensor in a call's (nested) outputs."""
    import hashlib

    import torch
    h = hashlib.sha256()

    def walk(o):
        if isinstance(o, torch.Tensor):
            h.update(str((o.dtype, tuple(o.shape))).encode())
            h.update(o.detach().contiguous().view(torch.uint8).cpu()
                     .numpy().tobytes())
        elif isinstance(o, (tuple, list)):
            for v in o:
                walk(v)
    walk(out)
    return h.hexdigest()[:16]


def _time_xent(kernel: str, N: int, R: int, K: int, rng, u) -> dict:
    """K3 / K4 (in bf16 for k3b / k4b): the median time of 5 calls."""
    import numpy as np
    import torch

    from kaldi_lstm_tpu_torch.ops import xent_affine as xa
    dt = torch.bfloat16 if kernel.endswith("b") else None
    r = torch.tensor(rng.randn(N, R).astype(np.float32), device="cuda")
    w, b = u(K, R), u(K)
    ids = torch.tensor(rng.randint(0, K, (N, 1)).astype(np.int32),
                       device="cuda")
    tw = torch.ones((N, 1), device="cuda")
    scale = torch.ones((N,), device="cuda")
    with torch.inference_mode():
        lse = xa.xent_fwd_cuda(r, w, b, ids, tw, compute_dtype=dt)[0]

    def call():
        if kernel.startswith("k3"):
            return xa.xent_fwd_cuda(r, w, b, ids, tw, compute_dtype=dt)
        return xa.xent_bwd_cuda(r, w, b, ids, tw, lse, scale, tw[:, 0],
                                compute_dtype=dt)

    ms, out = _median_times(call, xa)
    launches = {"k3": xa.FWD_LAUNCHES, "k4": xa.BWD_LAUNCHES,
                "k3b": xa.FWD_BF16_LAUNCHES,
                "k4b": xa.BWD_BF16_LAUNCHES}[kernel]
    return {"ms": ms, "launches": launches / 5, "digest": _digest(out)}


def _median_times(call, mod) -> tuple[float, object]:
    """Warm up once, then the median CUDA-event time of 5 calls (the
    module's counters zeroed after the warm-up), and the last call's
    outputs."""
    import statistics

    import torch
    times = []
    with torch.inference_mode():
        call()
        torch.cuda.synchronize()
        mod.reset_counts()
        for _ in range(5):
            a = torch.cuda.Event(enable_timing=True)
            b = torch.cuda.Event(enable_timing=True)
            a.record()
            out = call()
            b.record()
            torch.cuda.synchronize()
            times.append(a.elapsed_time(b))
    return statistics.median(times), out


def _child(tree: str, shape: str) -> dict:
    env = dict(os.environ, PYTHONPATH=tree)
    out = subprocess.run([sys.executable, os.path.abspath(__file__),
                          "--time", shape], cwd=tree, env=env,
                         capture_output=True, text=True, timeout=900)
    if out.returncode != 0:
        raise RuntimeError(f"timing in {tree} failed:\n{out.stderr[-4000:]}")
    return json.loads(out.stdout.strip().splitlines()[-1])


def main(argv: list[str] | None = None) -> int:
    argv = sys.argv[1:] if argv is None else argv
    if argv[:1] == ["--time"]:
        print(json.dumps(_time_here(argv[1])))
        return 0
    if not argv:
        print(__doc__, file=sys.stderr)
        return 2
    import torch
    if not torch.cuda.is_available():
        print("bench_infer_ab: needs a CUDA card", file=sys.stderr)
        return 1
    other = os.path.abspath(argv[0])
    here = os.path.dirname(os.path.dirname(os.path.dirname(
        os.path.abspath(__file__))))
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, timeout=60).stdout.strip()
    print(smi)
    for shape in argv[1:] or SHAPES:
        rec, dig = {}, {}
        for name, tree in (("other", other), ("this", here),
                           ("this", here), ("other", other)):
            r = _child(tree, shape)
            rec.setdefault(name, []).append(r["ms"])
            dig.setdefault(name, set()).add(r["digest"])
            dims = "(N,R,K)" if shape.startswith(("k3", "k4")) else \
                f"(S,T,I) C={C} R={R}"
            print(f"  {shape} {dims} {name:5s} {r['ms']:.3f} ms, "
                  f"{r['launches']:g} launches per call, outputs "
                  f"{r['digest']}", flush=True)
        # each tree's two runs agree (its sums are in a fixed order) and
        # the trees agree with each other: outputs equal bit for bit
        same = len(dig["this"]) == len(dig["other"]) == 1 and \
            dig["this"] == dig["other"]
        print(json.dumps({"shape": shape, "other_ms": rec["other"],
                          "this_ms": rec["this"],
                          "outputs_bit_for_bit": same,
                          "this_repeatable": len(dig["this"]) == 1,
                          "other_repeatable": len(dig["other"]) == 1}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
