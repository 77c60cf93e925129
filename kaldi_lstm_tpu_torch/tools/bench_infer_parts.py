"""Where K5's bf16 step goes: ``lstmp_infer_bf16`` (csrc/lstmp_infer.cu's
``lstmp_infer_tc_kernel``) against copies of itself with one part cut
out, at the flagship widths (I=40, C=800, R=512), on the card.

    python -m kaldi_lstm_tpu_torch.tools.bench_infer_parts [S,T ...]

Each variant is the committed source with one textual edit, built by
nvcc (the flags of ``ops/_build.py``) into ``_build/infer_parts/``
(``tools/bench_stack_parts.build``) and loaded with ctypes. A cut
variant computes wrong results: it is a timing probe only. Variants:

* ``base``: the source as it is;
* ``nobar``: the two grid barriers of a step replaced by CTA barriers;
* ``nomma``: no warp runs its mma loop (``pk::mma_product``'s units;
  the staging, the partial sums' barrier and the epilogues kept);
* ``nostage``: no staging copy issued (the waits and barriers kept);
* ``noepi``: both epilogues left out (no cell math, no m, r or c
  written).

Cases are ``S,T`` pairs (default 8,1000 and 256,20, the serving and the
cross-validation shapes); the variants of a case run in turns (CUDA
events, median of 5, one warm-up call each) and print ms a call and us
a step. Needs a card and nvcc; exits 1 without CUDA.
"""

from __future__ import annotations

import argparse
import ctypes
import subprocess
import sys

import numpy as np
import torch

from kaldi_lstm_tpu_torch.ops import lstm_infer as li
from kaldi_lstm_tpu_torch.ops.lstm_cell import LstmState, init_lstm_params
from kaldi_lstm_tpu_torch.tools.bench_stack_parts import build, turns

I, C, R = 40, 800, 512
_EPI = "for (int e = tid; e < sn * n"
# variant -> [(file, old text, new text)]
VARIANTS = {
    "base": [],
    "nobar": [("lstmp_infer.cu", "    grid.sync();\n  }\n  if (pl.c_smem)",
               "    __syncthreads();\n  }\n  if (pl.c_smem)"),
              ("lstmp_infer.cu", "    grid.sync();\n    if (nqc > 0)",
               "    __syncthreads();\n    if (nqc > 0)")],
    "nomma": [("persistent.cuh",
               "for (int u = ks == 1 ? warp : warp / ks; u < units;",
               "for (int u = ks == 1 ? warp : warp / ks; u < 0;")],
    "nostage": [("lstmp_infer.cu", "pk::cp_async16z(",
                 "if (false) pk::cp_async16z(")],
    "noepi": [("lstmp_infer.cu", _EPI, "for (int e = tid; e < 0 * n")],
}


def launcher(lib, S: int, T: int, device):
    """A no-argument call of the variant's bf16 K5 on fixed buffers: the
    flagship layer (weights from seed 1, scale 0.04), x and the state
    from numpy seed 1."""
    g = torch.Generator().manual_seed(1)
    p = init_lstm_params(g, I, C, R, 0.04, device=device)
    rng = np.random.RandomState(1)
    x = torch.tensor(rng.randn(T, S, I).astype(np.float32), device=device)
    st = LstmState(*(torch.tensor(rng.randn(S, d).astype(np.float32) * 0.5,
                                  device=device) for d in (C, R)))
    pl = li.device_plan(S, I, C, R, device, bf16=True)

    def b16(*shape):
        return torch.empty(shape, dtype=torch.bfloat16, device=device)

    ws = [] if pl["resident"] else [b16(pl["grid"], pl["mg"], pl["kg"]),
                                     b16(pl["grid"], pl["mq"], pl["kq"])]
    # the closure holds the tensors, so their memory outlives the pointers
    tensors = [x, p.w_gifo_x, p.w_gifo_r, p.bias,
               torch.stack([p.peephole_i_c, p.peephole_f_c, p.peephole_o_c]),
               p.w_r_m, st.r, st.c.clone(), torch.empty(T, S, R,
                                                        device=device),
               b16(T, S, pl["ip"]), b16(S, pl["rp"]), b16(S, pl["cp"]), *ws]
    ptrs = [t.data_ptr() for t in tensors] + [None] * (2 - len(ws))
    fn = lib.lstmp_infer_bf16
    fn.argtypes = [ctypes.c_void_p] * 15 + [ctypes.c_int] * 5 \
        + [ctypes.c_float, ctypes.c_void_p]
    bar = torch.empty(1, dtype=torch.int32, device=device)
    stream = torch.cuda.current_stream(device).cuda_stream

    def call():
        err = fn(*ptrs, bar.data_ptr(), T, S, I, C, R, 50.0, stream)
        if err != 0:
            raise RuntimeError(f"K5 variant launch failed: CUDA error {err}")
    return call


def main(argv=None) -> int:
    p = argparse.ArgumentParser(description="K5's bf16 step time by part")
    p.add_argument("cases", nargs="*", default=["8,1000", "256,20"],
                   help="S,T pairs")
    args = p.parse_args(argv)
    if not torch.cuda.is_available():
        print("bench-infer-parts: needs a CUDA card (the kernel has no CPU "
              "mode)", file=sys.stderr)
        return 1
    device = torch.device("cuda")
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True).stdout.strip()
    print(smi, flush=True)
    libs = build(VARIANTS, VARIANTS, "lstmp_infer.cu", "infer_parts")
    for case in args.cases:
        S, T = (int(v) for v in case.split(","))
        t = turns({n: launcher(lib, S, T, device) for n, lib in libs.items()})
        print(f"S={S} T={T} bf16: " + ", ".join(
            f"{k} {v:.3f} ms ({1e3 * v / T:.2f} us/step)"
            for k, v in t.items()), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
