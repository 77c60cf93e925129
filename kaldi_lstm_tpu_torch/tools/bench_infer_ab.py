"""Time this tree's LSTMP inference kernel (K5, ``ops.lstm_infer``)
against another checkout's, on the card, in turns.

    python -m kaldi_lstm_tpu_torch.tools.bench_infer_ab OTHER_DIR \\
        [S,T,I ...]

OTHER_DIR is the root of another checkout of this repository (for
example the parent commit unpacked with ``git archive``). For each shape
(default: the cross-validation shape 256,20,40 and the serving shape
8,1000,40; C=800, R=512 throughout) the script runs ``lstm_infer`` of
the other tree, this tree, this tree, the other tree, each in a process
of its own that imports that tree's package and builds its kernels, and
prints each process's median CUDA-event time over 5 calls (after one
warm-up call), its launches per call, and the card's name and power
limit. The inputs are made from numpy seed 0 in every process, so both
trees see the same weights and features. Needs a CUDA card.
"""

from __future__ import annotations

import json
import os
import subprocess
import sys

SHAPES = ("256,20,40", "8,1000,40")
C, R = 800, 512


def _time_here(shape: str) -> dict:
    """Runs in the child: the median time of this process's package."""
    import statistics

    import numpy as np
    import torch

    from kaldi_lstm_tpu_torch.ops import lstm_infer as li
    from kaldi_lstm_tpu_torch.ops.lstm_cell import LstmParams, LstmState
    S, T, I = (int(v) for v in shape.split(","))
    rng = np.random.RandomState(0)

    def u(*dims):
        return torch.tensor(rng.uniform(-0.04, 0.04, dims)
                            .astype(np.float32), device="cuda")

    p = LstmParams(u(4 * C, I), u(4 * C, R), u(4 * C), u(C), u(C), u(C),
                   u(R, C))
    x = torch.tensor(rng.randn(S, T, I).astype(np.float32), device="cuda")
    st = LstmState(u(S, C), u(S, R))
    times = []
    with torch.inference_mode():
        li.lstm_infer(p, x, st)
        torch.cuda.synchronize()
        li.reset_counts()
        for _ in range(5):
            a = torch.cuda.Event(enable_timing=True)
            b = torch.cuda.Event(enable_timing=True)
            a.record()
            li.lstm_infer(p, x, st)
            b.record()
            torch.cuda.synchronize()
            times.append(a.elapsed_time(b))
    return {"ms": statistics.median(times), "launches": li.LAUNCHES / 5}


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
        rec = {}
        for name, tree in (("other", other), ("this", here),
                           ("this", here), ("other", other)):
            r = _child(tree, shape)
            rec.setdefault(name, []).append(r["ms"])
            print(f"  S,T,I={shape} C={C} R={R} {name:5s} {r['ms']:.3f} ms, "
                  f"{r['launches']:g} launches per call", flush=True)
        print(json.dumps({"shape": shape, "other_ms": rec["other"],
                          "this_ms": rec["this"]}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
