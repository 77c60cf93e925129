"""Where K1's bf16 call goes: ``lstmp_train_fwd_bf16``
(csrc/lstmp_train.cu's ``fwd16_*`` kernels) by part, and the hoisted
xw's two routes against each other, on the card.

    python -m kaldi_lstm_tpu_torch.tools.bench_k1_parts [S,T,I ...]

For each case (default 256,20,40 the flagship training shape,
256,20,512 the deep net's layer 2 and 1,64,40 a per-utterance shape;
C=800, R=512, no dropout, clip 50, inputs from numpy seed 0) and each
route of the hoisted xw ("mma": Gemm16 tiles; "wg": wgmma fed by TMA;
the rest of the plan as ``fwd_plan`` gives it), the script prints the
call's median CUDA-event time over 5 calls, the routes in turns (one
warm-up call each), and, from torch.profiler over 3 calls, each kernel's
device time per launch and launches per call: the prologue
(``fwd16_prep_kernel``), the hoisted xw (``fwd16_xw_kernel`` or
``fwd16_xw_wg_kernel``), and the gates and the projection of a step
(``fwd16_gates_kernel``, ``fwd16_proj_kernel``). The plan's own route is
marked. One JSON line a case closes its block. Needs a CUDA card; exits
1 without one.
"""

from __future__ import annotations

import argparse
import json
import subprocess
import sys

import numpy as np
import torch

from kaldi_lstm_tpu_torch.ops import lstm_train as lt
from kaldi_lstm_tpu_torch.ops.lstm_cell import LstmParams, LstmState
from kaldi_lstm_tpu_torch.tools.bench_stack_parts import turns

C, R = 800, 512
PARTS = ("fwd16_prep_kernel", "fwd16_xw_kernel", "fwd16_xw_wg_kernel",
         "fwd16_gates_kernel", "fwd16_proj_kernel")


def inputs(S: int, T: int, I: int, device):
    rng = np.random.RandomState(0)

    def u(*dims):
        return torch.tensor(rng.uniform(-0.04, 0.04, dims)
                            .astype(np.float32), device=device)

    p = LstmParams(u(4 * C, I), u(4 * C, R), u(4 * C), u(C), u(C), u(C),
                   u(R, C))
    x = torch.tensor(rng.randn(T, S, I).astype(np.float32), device=device)
    return p, x, LstmState(u(S, C), u(S, R))


def by_kernel(call, calls: int = 3) -> dict:
    """{part: (us per launch, launches per call)} from torch.profiler."""
    from torch.profiler import ProfilerActivity, profile
    call()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        for _ in range(calls):
            call()
        torch.cuda.synchronize()
    out = {}
    for e in prof.key_averages():
        if e.device_type != torch.autograd.DeviceType.CUDA:
            continue
        part = next((k for k in PARTS if k + "<" in e.key or
                     k + "(" in e.key), None)
        if part is None:
            continue
        t = getattr(e, "self_device_time_total", None)
        t = e.self_cuda_time_total if t is None else t
        us, n = out.get(part, (0.0, 0))
        out[part] = (us + t, n + e.count)
    return {k: (us / n, n / calls) for k, (us, n) in out.items()}


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description="K1 bf16 by part and xw route")
    ap.add_argument("cases", nargs="*",
                    default=["256,20,40", "256,20,512", "1,64,40"],
                    help="S,T,I triples")
    args = ap.parse_args(argv)
    if not torch.cuda.is_available():
        print("bench-k1-parts: needs a CUDA card (the kernels have no CPU "
              "mode)", file=sys.stderr)
        return 1
    device = torch.device("cuda")
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True).stdout.strip()
    print(smi, flush=True)
    sms = torch.cuda.get_device_properties(device).multi_processor_count
    for case in args.cases:
        S, T, I = (int(v) for v in case.split(","))
        p, x, st = inputs(S, T, I, device)
        own = lt.fwd_plan(T, S, I, C, R, sms, bf16=True)
        calls = {}
        for route in ("mma", "wg"):
            plan = dict(own, xw_route=route)

            def call(plan=plan):
                lt.lstm_fwd_residuals_cuda(p, x, st.c, st.r, None, 1.0, 50.0,
                                           torch.bfloat16, plan=plan)
            calls[route] = call
        with torch.inference_mode():
            ms = turns(calls)
            parts = {k: by_kernel(f) for k, f in calls.items()}
        print(f"S={S} T={T} I={I} C={C} R={R} bf16 ({smi}):", flush=True)
        for route, v in ms.items():
            mark = " (plan)" if route == own["xw_route"] else ""
            split = ", ".join(f"{k[6:-7]} {us:.2f} us x{n:g}"
                              for k, (us, n) in parts[route].items())
            print(f"  xw {route}: {v:.4f} ms{mark}; {split}", flush=True)
        print(json.dumps({
            "case": [S, T, I, C, R], "card": smi, "plan": own["xw_route"],
            "ms": ms,
            "us_per_launch": {r: {k: v[0] for k, v in d.items()}
                              for r, d in parts.items()}}),
            flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
