"""Where the bf16 K3 and K4 go: ``xent_affine_fwd_bf16`` /
``xent_affine_bwd_bf16`` (csrc/xent_affine.cu's ``xent16_*`` kernels on
csrc/wg_gemm.cuh) by kernel, against copies of the source with one part
cut out, on the card.

    python -m kaldi_lstm_tpu_torch.tools.bench_xent_parts [N,R,K ...]

Each source variant is the committed source with one textual edit,
built by nvcc (the flags of ``ops/_build.py``) into
``_build/xent_parts/`` (``tools/bench_stack_parts.build``) and loaded
with ctypes. A cut variant computes wrong results: it is a timing probe
only. Variants:

* ``base``: the source as it is;
* ``noepi_fwd``: K3's chunk walk without its epilogue on full tiles (the
  products, a chunk's last tile and the partials kept);
* ``noepi_dz``: K4's dz walk without its dz math on full tiles (the
  products, the staging, the TMA stores and the db sums kept).

Cases are ``N,R,K`` (default the flagship shape 5120,512,8000 and the
DNN's minibatch 256,1024,8000; one target a frame, every frame
unmasked, K4 on K3's lse). For each case every variant runs 5 calls of
K3 then K4 under the profiler, after a warm-up call, in turns, and the
script prints each kernel's device ms a call by variant, and the plan.
Needs a card and nvcc; exits 1 without CUDA.
"""

from __future__ import annotations

import argparse
import re
import subprocess
import sys

import numpy as np
import torch

from kaldi_lstm_tpu_torch.ops import xent_affine as xa
from kaldi_lstm_tpu_torch.tools.bench_stack_parts import build

# variant -> [(file, old text, new text)]
VARIANTS = {
    "base": [],
    "noepi_fwd": [(
        "xent_affine.cu",
        "        fwd_tile<true>(acc, b, ids, tw, c0, ci.c_end, ci.m0, N, Km, "
        "bv, bi,\n                       bs, bp);",
        "        bs[0] += acc[0] + acc[63];")],
    "noepi_dz": [(
        "xent_affine.cu",
        "        dz_tile<true>(acc, b, ids, tw, rb, c0, ci.c_end, n, live, l, "
        "sc, wt,\n                      Km);",
        "        rb[threadIdx.x] = acc[0] + acc[63];")],
}


def launchers(lib, N: int, R: int, K: int, device):
    """No-argument calls (K3, K4) of a variant's bf16 entry points on
    fixed buffers; inputs from numpy seed 0."""
    sms = torch.cuda.get_device_properties(device).multi_processor_count
    pl = xa.xent_bf16_plan(N, R, K, sms)
    fwd, bwd = xa._bind(lib, True)
    rng = np.random.RandomState(0)

    def t(a, dtype=torch.float32):
        return torch.tensor(a, dtype=dtype, device=device)

    r = t(rng.randn(N, R).astype(np.float32))
    w = t(rng.uniform(-0.04, 0.04, (K, R)).astype(np.float32))
    b = t(rng.uniform(-0.04, 0.04, K).astype(np.float32))
    ids = t(rng.randint(0, K, (N, 1)), torch.int32)
    tw = torch.ones((N, 1), device=device)
    scale = torch.ones((N,), device=device)

    def f32(*shape):
        return torch.empty(shape, device=device)

    def b16(*shape):
        return torch.empty(shape, dtype=torch.bfloat16, device=device)

    # the closures hold the tensors, so their memory outlives the pointers
    lse, picked, amax, aidx = f32(N), f32(N), f32(N), f32(N).int()
    part = f32(4, pl["nch"], N)
    r16, w16 = b16(N, pl["r_ld"]), b16(K, pl["r_ld"])
    dz, dbp = b16(N, pl["dz_ld"]), f32(pl["nrt"], K)
    dr, dw, db = f32(N, R), f32(K, R), f32(K)
    stream = torch.cuda.current_stream(device).cuda_stream

    def check(err, what):
        if err != 0:
            raise RuntimeError(f"{what} variant launch failed: CUDA error "
                               f"{err}")

    def k3():
        check(fwd(r.data_ptr(), w.data_ptr(), b.data_ptr(), ids.data_ptr(),
                  tw.data_ptr(), lse.data_ptr(), picked.data_ptr(),
                  amax.data_ptr(), aidx.data_ptr(), part.data_ptr(),
                  r16.data_ptr(), w16.data_ptr(), N, R, K, 1, pl["chunk"],
                  sms, stream), "K3")

    def k4():
        check(bwd(r.data_ptr(), w.data_ptr(), b.data_ptr(), ids.data_ptr(),
                  tw.data_ptr(), lse.data_ptr(), scale.data_ptr(),
                  tw.data_ptr(), dr.data_ptr(), dw.data_ptr(),
                  db.data_ptr(), r16.data_ptr(), w16.data_ptr(),
                  dz.data_ptr(), pl["dz_ld"], dbp.data_ptr(), N, R, K, 1,
                  pl["chunk"], sms, stream), "K4")
    return k3, k4, pl


def kernel_ms(k3, k4, reps: int = 5) -> dict:
    """Device ms a call of each kernel of K3 and K4 (the profiler's sums
    over `reps` calls of each, after a warm-up call)."""
    k3()
    k4()
    torch.cuda.synchronize()
    prof = torch.profiler.profile(
        activities=[torch.profiler.ProfilerActivity.CUDA])
    with prof:
        for _ in range(reps):
            k3()
            k4()
        torch.cuda.synchronize()
    out = {}
    for ev in prof.key_averages():
        m = re.search(r"xent\w*_kernel", ev.key)
        if ev.device_time_total > 0 and m:
            out[m.group(0)] = out.get(m.group(0), 0.0) + \
                ev.device_time_total / reps
    return {k: v / 1000.0 for k, v in sorted(out.items())}


def main(argv=None) -> int:
    p = argparse.ArgumentParser(description="bf16 K3/K4 by kernel")
    p.add_argument("cases", nargs="*",
                   default=["5120,512,8000", "256,1024,8000"],
                   help="N,R,K triples")
    args = p.parse_args(argv)
    if not torch.cuda.is_available():
        print("bench-xent-parts: needs a CUDA card (the kernels have no CPU "
              "mode)", file=sys.stderr)
        return 1
    device = torch.device("cuda")
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True).stdout.strip()
    print(smi, flush=True)
    libs = build(VARIANTS, VARIANTS, "xent_affine.cu", "xent_parts")
    for case in args.cases:
        N, R, K = (int(v) for v in case.split(","))
        calls = {n: launchers(lib, N, R, K, device)
                 for n, lib in libs.items()}
        pl = calls["base"][2]
        print(f"N={N} R={R} K={K}: plan chunk {pl['chunk']}, items "
              f"{pl['logits_items']} / {pl['dr_items']} / "
              f"{pl['dw_items']}", flush=True)
        for name, (k3, k4, _) in calls.items():
            ms = kernel_ms(k3, k4)
            print(f"  {name:10s} " + ", ".join(
                f"{k.replace('_kernel', '')} {v:.4f}"
                for k, v in ms.items()) + " ms", flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
