"""Where K7's wavefront step goes: K7 (``csrc/lstmp_stack.cu``'s
``lstmp_stack_infer2_*``) against copies of itself with one part cut
out, at the deep config's widths (I=40, C=800, R=512), on the card.

    python -m kaldi_lstm_tpu_torch.tools.bench_stack_parts [S,T ...]

Each variant is the committed source with one textual edit, built by
nvcc (the flags of ``ops/_build.py``) into ``_build/stack_parts/`` and
loaded with ctypes. A cut variant computes wrong results: it is a
timing probe only. Variants of the f32 kernel (``stack_infer2_kernel``,
on ``pk::block_product``):

* ``base``: the source as it is;
* ``nobar``: the grid barriers replaced by CTA barriers (what the two
  grid barriers of a step cost);
* ``nogates`` / ``noproj``: the gates pass / the projection pass left
  out (what each pass costs, its staging, sums and epilogue);
* ``nofma``: every block product's k loop left out, the staging, the
  lane sums and the epilogues kept (what the FMA loops cost);
* ``l1only``: layer 1's columns only in both passes (about one K5 step
  of work);
* ``buf32k``: the staging buffers capped at 32 KB each, K5's cap (what
  K7's larger buffers give where shared memory is left);
* ``unroll4``: the block product's k loop unrolled by 4;

and of the bf16 kernel (``stack_infer2_tc_kernel``, on
``pk::mma_product_sets``):

* ``nobar16``: its two grid barriers a step replaced by CTA barriers;
* ``nogates16`` / ``noproj16``: its gates pass (both layers' rows on the
  one staged row) / its projection pass left out;
* ``cfirst16``: the plan keeps the c state in shared memory wherever it
  fits beside two 8-stream tiles, the staging tiles taking what is left
  (at S=512 tiles of 8 streams where the committed rule takes 16 and
  leaves c in device memory);
* ``g2dev16``: layer 2's gate slice always in device memory (rounded by
  the prologue, read through L2 at every stream tile), the staging tiles
  taking the 66 KB it leaves (at S=512 tiles of 32 streams where the
  committed plan takes 16);
* ``nomma16``: the tensor-core loop (``pk::mma_unit``) left out, the
  staging, partial sums and epilogues kept;
* ``rolled16``: that loop strided by the runtime split count (the
  compiler then does not unroll it; the committed loop runs over a
  unit-stride index).

An f32 variant leaves the bf16 kernel as it is and the reverse, so the
f32 rows time the f32 variants and the bf16 rows the bf16 ones. Cases
are ``S,T`` pairs (default 8,1000 64,200 512,20), each timed in f32 and
in bf16; the variants of a case run in turns (CUDA events, median of 5,
one warm-up call each) and print ms a call and us a wavefront step.
Needs a card and nvcc; exits 1 without CUDA.
"""

from __future__ import annotations

import argparse
import ctypes
import os
import shutil
import statistics
import subprocess
import sys

import numpy as np
import torch

from kaldi_lstm_tpu_torch.ops import _build
from kaldi_lstm_tpu_torch.ops import lstm_stack as ls
from kaldi_lstm_tpu_torch.ops.lstm_cell import LstmState, init_lstm_params

I, C, R = 40, 800, 512
_LOOP = "for (int k = lo + ks; k < hi; k += ksn)"
_BUF = "kMaxBufFloats, pk::kMinBufFloats + extra"
_CFIRST = "  q.c_smem = c_fits && tiles(with_c) == tiles(q);"
_G2 = "  q.res_g2 = q.res_q && used + wg2 + least <= optin;"
_MMA_LOOP = "  for (int jj = 0; jj < nj; ++jj) {"
_MMA_J = "\n    const int j = kidx + jj * ks;"
# variant -> [(file, old text, new text)]
VARIANTS = {
    "base": [],
    "nobar": [("lstmp_stack.cu", "    grid.sync();", "    __syncthreads();")],
    "nogates": [("lstmp_stack.cu", "    if (nc > 0) {\n      gates(",
                 "    if (false) {\n      gates(")],
    "noproj": [("lstmp_stack.cu", "    if (nquad > 0) {\n      proj(",
                "    if (false) {\n      proj(")],
    "nofma": [("persistent.cuh", _LOOP,
               "for (int k = hi; k < hi; k += ksn)")],
    "l1only": [("lstmp_stack.cu", "l2 ? nc : 0);", "0);"),
               ("lstmp_stack.cu", "l2 ? nquad : 0);", "0);")],
    "buf32k": [("lstmp_stack.cu", _BUF,
                "pk::kBufFloats, pk::kMinBufFloats + extra")],
    "unroll4": [("persistent.cuh", _LOOP, "#pragma unroll 4\n" + _LOOP)],
    "nobar16": [("lstmp_stack.cu", "    gbar.sync();",
                 "    __syncthreads();")],
    "nogates16": [("lstmp_stack.cu",
                   "    if (nc > 0) {\n      const bf16* x_k",
                   "    if (false) {\n      const bf16* x_k")],
    "noproj16": [("lstmp_stack.cu",
                  "    if (nqc > 0 && (lq == 0 ? l1 : l2)) {",
                  "    if (false) {")],
    "cfirst16": [("lstmp_stack.cu", _CFIRST, "  q.c_smem = c_fits;")],
    "g2dev16": [("lstmp_stack.cu", _G2, "  q.res_g2 = 0;")],
    "nomma16": [("persistent.cuh", _MMA_LOOP,
                 "  for (int jj = nj; jj < nj; ++jj) {")],
    "rolled16": [("persistent.cuh", _MMA_LOOP + _MMA_J,
                  "  for (int j = kidx; j < nslices; j += ks) {")],
}
# which precision a variant edits (the other precision's rows skip it)
BF16_ONLY = ("nobar16", "nogates16", "noproj16", "cfirst16", "g2dev16",
             "nomma16", "rolled16")


def variant_sources(name: str, variants: dict = VARIANTS) -> dict[str, str]:
    """The edited files of a variant: {file name: source}. Raises if an
    edit's text is not in the committed source."""
    out = {}
    for fname, old, new in variants[name]:
        if fname not in out:
            with open(os.path.join(_build.CSRC_DIR, fname)) as fh:
                out[fname] = fh.read()
        if old not in out[fname]:
            raise RuntimeError(f"variant {name}: {old!r} is not in "
                               f"csrc/{fname}")
        out[fname] = out[fname].replace(old, new)
    return out


def build(names, variants: dict = VARIANTS, source: str = "lstmp_stack.cu",
          sub: str = "stack_parts") -> dict[str, ctypes.CDLL]:
    """One library per variant of csrc/`source` (in _build/`sub`/), all
    nvcc processes started together."""
    root = os.path.join(_build.BUILD_DIR, sub)
    procs = {}
    for name in names:
        d = os.path.join(root, name)
        os.makedirs(d, exist_ok=True)
        for f in os.listdir(_build.CSRC_DIR):
            if f.endswith((".cuh", ".h")) or f == source:
                shutil.copy(os.path.join(_build.CSRC_DIR, f), d)
        for fname, src in variant_sources(name, variants).items():
            with open(os.path.join(d, fname), "w") as fh:
                fh.write(src)
        cmd = [_build._nvcc(), *_build.NVCC_FLAGS, "-o",
               os.path.join(d, "lib.so"), os.path.join(d, source)]
        procs[name] = subprocess.Popen(cmd, stdout=subprocess.PIPE,
                                       stderr=subprocess.STDOUT, text=True)
    libs = {}
    for name, p in procs.items():
        out, _ = p.communicate()
        if p.returncode != 0:
            raise RuntimeError(f"nvcc failed for variant {name}:\n{out}")
        libs[name] = ctypes.CDLL(os.path.join(root, name, "lib.so"))
    return libs


def operands(S: int, T: int, device) -> tuple:
    """The deep config's two layers (weights from seed 1, scale 0.04),
    x [T, S, I] and both states from numpy seed 1."""
    g = torch.Generator().manual_seed(1)
    p1 = init_lstm_params(g, I, C, R, 0.04, device=device)
    p2 = init_lstm_params(g, R, C, R, 0.04, device=device)
    rng = np.random.RandomState(1)
    x = torch.tensor(rng.randn(T, S, I).astype(np.float32), device=device)
    st = [torch.tensor(rng.randn(S, d).astype(np.float32) * 0.5,
                       device=device) for d in (C, R, C, R)]
    return p1, p2, x, LstmState(st[0], st[1]), LstmState(st[2], st[3])


def launcher(lib, args, bf16: bool):
    """A no-argument call of the variant's K7 on fixed buffers (the
    operands of ``ops/lstm_stack.infer2_operands``)."""
    p1, p2, x, s1, s2 = args
    T, S, _ = x.shape
    fn = getattr(lib, "lstmp_stack_infer2_bf16" if bf16
                 else "lstmp_stack_infer2_f32")
    fn.argtypes = [ctypes.c_void_p] * (24 if bf16 else 17) \
        + [ctypes.c_int] * 6 + [ctypes.c_float, ctypes.c_void_p]
    plan = None
    if bf16:    # the variant's own plan (its scratch may differ)
        out = (ctypes.c_int * len(ls.K7_BF16_PLAN_KEYS))()
        lib.lstmp_stack_infer2_plan.argtypes = [ctypes.c_int] * 5 + [
            ctypes.POINTER(ctypes.c_int)]
        if lib.lstmp_stack_infer2_plan(S, I, C, R, 1, out) != 0:
            raise RuntimeError("K7 variant planning failed")
        plan = dict(zip(ls.K7_BF16_PLAN_KEYS, list(out)))
    # the closure holds the tensors, so their memory outlives the pointers
    tensors, _ = ls.infer2_operands(p1, p2, x, s1, s2, bf16, plan)
    stream = torch.cuda.current_stream(x.device).cuda_stream

    def call():
        err = fn(*(None if t is None else t.data_ptr() for t in tensors), T,
                 S, I, C, R, 1, 50.0, stream)
        if err != 0:
            raise RuntimeError(f"K7 variant launch failed: CUDA error {err}")
    return call


def turns(calls: dict, reps: int = 5) -> dict:
    for call in calls.values():
        call()
    torch.cuda.synchronize()
    times = {k: [] for k in calls}
    for _ in range(reps):
        for k, call in calls.items():
            a = torch.cuda.Event(enable_timing=True)
            b = torch.cuda.Event(enable_timing=True)
            a.record()
            call()
            b.record()
            torch.cuda.synchronize()
            times[k].append(a.elapsed_time(b))
    return {k: statistics.median(v) for k, v in times.items()}


def main(argv=None) -> int:
    p = argparse.ArgumentParser(description="K7's step time by part")
    p.add_argument("cases", nargs="*", default=["8,1000", "64,200",
                                                "512,20"],
                   help="S,T pairs")
    args = p.parse_args(argv)
    if not torch.cuda.is_available():
        print("bench-stack-parts: needs a CUDA card (K7 has no CPU mode)",
              file=sys.stderr)
        return 1
    device = torch.device("cuda")
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True).stdout.strip()
    print(smi, flush=True)
    libs = build(VARIANTS)
    for case in args.cases:
        S, T = (int(v) for v in case.split(","))
        ops = operands(S, T, device)
        for bf16 in (False, True):
            t = turns({n: launcher(lib, ops, bf16) for n, lib in libs.items()
                       if (n in BF16_ONLY) == bf16 or n == "base"})
            print(f"S={S} T={T} {'bf16' if bf16 else 'f32'}: " + ", ".join(
                f"{k} {v:.3f} ms ({1e3 * v / (T + 1):.2f} us/step)"
                for k, v in t.items()), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
