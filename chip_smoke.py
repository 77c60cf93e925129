#!/usr/bin/env python3
"""On-card smoke test of the PyTorch/CUDA port (kaldi_lstm_tpu_torch).

    python3 chip_smoke.py

Needs one CUDA card and nvcc; imports nothing of JAX. Phases, in order
(any failure exits nonzero before the result lines are printed):

1. environment: torch and CUDA versions, the card's name and power limit;
2. build every kernel from kaldi_lstm_tpu_torch/csrc/ (one nvcc each,
   started together) and print nvcc's register/shared-memory report;
3. hold the inference kernel (K5) against its plain PyTorch version on
   the card at the serving path's widths, and time both with CUDA events;
3b. hold the training kernels K1-K4 (LSTMP forward with residuals, BPTT,
   fused senone affine + xent forward and backward) against their plain
   versions at the flagship training width (S=256, T=20, I=40, C=800,
   R=512, K=8000) and on ragged, clipped, dropout, no-dx, final-state-
   cotangent and argmax-tie cases; time kernel and plain; print bounds;
4. drive the serving path: `nnet_forward` scoring of the full-width
   standard decode net (TimeShift(5) -> LstmProjected 40->800c/512r ->
   AffineTransform 512->8000 -> Softmax, random weights from a seed) over
   a synthetic feature ark, with the K5 launch count zeroed just before
   and read just after, then check the output and compare three
   utterances with the port's own CPU path;
5. drive the training path: `train_lstm_streams --device cuda` trains
   the flagship net (Transmit -> LstmProjectedStreams 40->800c/512r ->
   AffineTransform 512->8000 -> Softmax) for one epoch of a synthetic
   corpus (256 utterances, 256 streams, Tbptt 20), with the K1-K4 counts
   zeroed just before and read just after; check the counts against the
   design's prediction, no plain call, the model file, a lower
   cross-validation AvgLoss after the epoch than before, and two steps
   on the card against the same two steps on the port's CPU path; print
   train throughput and a profile of one step;
6. print one JSON line with every kernel, then the device line last.
"""

from __future__ import annotations

import json
import os
import statistics
import subprocess
import sys
import tempfile
import time

import numpy as np

PROTO = """<NnetProto>
<TimeShift> <InputDim> 40 <OutputDim> 40 <Shift> 5
<LstmProjected> <InputDim> 40 <OutputDim> 512 <CellDim> 800 <ParamScale> 0.01
<AffineTransform> <InputDim> 512 <OutputDim> 8000 <ParamStddev> 0.04
<Softmax> <InputDim> 8000 <OutputDim> 8000
</NnetProto>
"""
FRAMES_PER_AUDIO_SECOND = 100.0
# Published H100 SXM peaks (NVIDIA data sheet): f32 outside the tensor
# cores, and HBM3 bandwidth.
PEAK_F32_FLOPS = 67e12
PEAK_BYTES_PER_S = 3.35e12

# Kernel vs plain, float32 on both sides (TF32 off). The two sum the
# 552-term gate dots and the 800-term projection in different orders
# (sequential fma vs cuBLAS's blocked sums): ~1e-7 relative per step. The
# forget gate keeps the recurrence contractive, so the difference stays
# near that level over T=1000 instead of compounding; 1e-4 abs + 1e-4 rel
# leaves two orders of magnitude of margin.
KERNEL_ATOL = 1e-4
KERNEL_RTOL = 1e-4
# Training kernels vs plain, float32 on both sides (TF32 off): every
# output within 1e-4 * (1 + the largest |entry| of the plain result).
# K2's weight gradients sum N = T*S = 5120 frame rows, K3/K4 sum R = 512
# products and K = 8000 classes, in other orders than cuBLAS; on an H100
# this script measured at most 3.4e-6 of that scale, so 1e-4 leaves a
# 30x margin while a wrong index or a missed term (errors of the order of
# the entries themselves) still fails. Argmax indices must agree
# except on near-ties, where the kernel's pick must be within the same
# tolerance of the row's max.
TRAIN_TOL = 1e-4
# Two training steps at full width, card (K1-K4, fused loss) vs the
# port's CPU path (plain scan, unfused log-softmax loss): both float32,
# gradients summed over 5120 frames in other orders; after two updates
# at lr 2e-5 every parameter agrees within 1e-5 + 1e-4 * |value|, the
# loss sums within 1e-5 relative, the frame counts exactly, and the
# correct-frame counts within 2 frames (argmax near-ties).
STEP_ATOL = 1e-5
STEP_RTOL = 1e-4
TRAIN_PROTO = """<NnetProto>
<Transmit> <InputDim> 40 <OutputDim> 40
<LstmProjectedStreams> <InputDim> 40 <OutputDim> 512 <CellDim> 800 <ParamScale> 0.01 <NumStream> 4
<AffineTransform> <InputDim> 512 <OutputDim> 8000 <BiasMean> 0.0 <BiasRange> 0.0 <ParamStddev> 0.04
<Softmax> <InputDim> 8000 <OutputDim> 8000
</NnetProto>
"""
TRAIN_S, TRAIN_T = 256, 20
TRAIN_LR = 2e-5
# Scores (log-posterior minus log-prior, magnitude ~10) on the card vs the
# port's CPU path: the LSTM difference above passes through a 512-deep
# affine and an 8000-wide log-softmax, and the CPU and cuBLAS GEMMs sum
# in different orders; 1e-3 abs is ~1e-4 relative at that magnitude.
SCORE_ATOL = 1e-3


def log(msg: str) -> None:
    print(msg, flush=True)


def fail(msg: str) -> None:
    print(f"chip_smoke: FAIL: {msg}", file=sys.stderr, flush=True)
    sys.exit(1)


def nvidia_smi_line() -> str:
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"],
        capture_output=True, text=True, timeout=60, check=True).stdout
    return out.strip().splitlines()[0]


def cuda_ms(fn, warmup: int = 1, reps: int = 5) -> float:
    """Median of `reps` CUDA-event timings of fn(), after warm-up."""
    import torch
    for _ in range(warmup):
        fn()
    times = []
    for _ in range(reps):
        a = torch.cuda.Event(enable_timing=True)
        b = torch.cuda.Event(enable_timing=True)
        a.record()
        fn()
        b.record()
        torch.cuda.synchronize()
        times.append(a.elapsed_time(b))
    return statistics.median(times)


def lstm_case(S, T, I, C, R, seed, param_scale=0.04, x_scale=1.0,
              state_scale=0.5, device="cuda"):
    import torch
    from kaldi_lstm_tpu_torch.ops.lstm_cell import (
        LstmState,
        init_lstm_params,
    )
    g = torch.Generator().manual_seed(seed)
    params = init_lstm_params(g, I, C, R, param_scale, device=device)
    rng = np.random.RandomState(seed)
    x = torch.tensor(rng.randn(S, T, I).astype(np.float32) * x_scale,
                     device=device)
    state = LstmState(
        c=torch.tensor(rng.randn(S, C).astype(np.float32) * state_scale,
                       device=device),
        r=torch.tensor(rng.randn(S, R).astype(np.float32) * state_scale,
                       device=device))
    return params, x, state


def errors(got, ref):
    d = (got - ref).abs()
    rel = d / ref.abs().clamp_min(1e-6)
    ok = bool((d <= KERNEL_ATOL + KERNEL_RTOL * ref.abs()).all())
    return float(d.max()), float(rel.max()), ok


def lstm_bound_ms(S, T, I, C, R) -> tuple[float, str]:
    """Least time for the inference forward on this card: each input
    read once and each output written once over HBM bandwidth, against
    the three weight products' f32 operations over the f32 peak."""
    inputs = T * S * I + (I + R) * 4 * C + 4 * C + 3 * C + C * R \
        + S * C + S * R
    outputs = T * S * R + S * C
    t_bytes = 4.0 * (inputs + outputs) / PEAK_BYTES_PER_S
    t_ops = 2.0 * T * S * (4 * C * (I + R) + C * R) / PEAK_F32_FLOPS
    return (1e3 * max(t_bytes, t_ops),
            "bytes" if t_bytes > t_ops else "operations")


def phase_kernels():
    """Kernel vs plain on the card. Returns the timing record of the
    main-path shape (S=8, T=1000)."""
    import torch
    from kaldi_lstm_tpu_torch.ops.lstm_cell import lstm_scan
    from kaldi_lstm_tpu_torch.ops.lstm_infer import lstm_infer

    cases = [
        # name, (S, T, I, C, R), cell_clip, extra
        ("full T=128 nonzero state", (8, 128, 40, 800, 512), 50.0, {}),
        ("full T=1000 nonzero state", (8, 1000, 40, 800, 512), 50.0, {}),
        ("full T=128 clip active", (8, 128, 40, 800, 512), 1.0,
         {"x_scale": 20.0, "param_scale": 0.2}),
        ("ragged S=3 I=37 C=200 R=130", (3, 128, 37, 200, 130), 50.0, {}),
    ]
    worst = 0.0
    record = None
    for i, (name, dims, clip, extra) in enumerate(cases):
        params, x, state = lstm_case(*dims, seed=10 + i, **extra)
        with torch.inference_mode():
            out_k, fin_k = lstm_infer(params, x, state, clip)
            out_p, fin_p = lstm_scan(params, x, state, clip)
            torch.cuda.synchronize()
        if clip == 1.0 and not bool((fin_p.c.abs() == 1.0).any()):
            fail(f"{name}: the clip never engaged")
        for what, a, b in (("r", out_k, out_p), ("final c", fin_k.c, fin_p.c),
                           ("final r", fin_k.r, fin_p.r)):
            mx, rel, ok = errors(a, b)
            worst = max(worst, mx)
            log(f"  [{name}] {what}: max_abs_err {mx:.3e} "
                f"max_rel_err {rel:.3e} (tol {KERNEL_ATOL:g} abs + "
                f"{KERNEL_RTOL:g} rel)")
            if not ok or not bool(torch.isfinite(a).all()):
                fail(f"{name}: {what} disagrees with the plain version")
        if dims[:2] == (8, 1000):
            with torch.inference_mode():
                k_ms = cuda_ms(lambda: lstm_infer(params, x, state, clip))
                p_ms = cuda_ms(lambda: lstm_scan(params, x, state, clip),
                               reps=3)
            bound, by = lstm_bound_ms(*dims)
            log(f"  [{name}] kernel {k_ms:.3f} ms, plain {p_ms:.3f} ms, "
                f"bound {bound:.4f} ms ({by}); library: n/a (no single "
                f"PyTorch call computes LSTMP with peepholes and the clip)")
            record = {"ms": k_ms, "plain_ms": p_ms, "bound_ms": bound,
                      "bound_by": by}
    record["max_abs_err"] = worst
    return record


def bound_ms(ops: float, nbytes: float) -> tuple[float, str]:
    """Least time on this card: the larger of the f32 operations over the
    f32 peak and the compulsory bytes over the HBM rate."""
    t_ops = ops / PEAK_F32_FLOPS
    t_bytes = nbytes / PEAK_BYTES_PER_S
    return (1e3 * max(t_ops, t_bytes),
            "operations" if t_ops >= t_bytes else "bytes")


def k1_bound(T, S, I, C, R, mask):
    ops = 2.0 * T * S * (4 * C * (I + R) + C * R)
    n_in = T * S * I + (I + R) * 4 * C + 7 * C + C * R + S * (C + R)
    n_out = T * S * (4 * C + C + R)
    return bound_ms(ops, 4.0 * (n_in + n_out) + (T * S * 4 * C if mask
                                                 else 0))


def k2_bound(T, S, I, C, R, mask, need_dx):
    N = T * S
    ops = 2.0 * N * (2 * R * C + 8 * C * R + (8 if need_dx else 4) * C * I)
    n_in = (N * (I + 4 * C + C + 2 * R) + 4 * C * (I + R) + R * C + 3 * C
            + S * (2 * C + R))
    n_out = 4 * C * (I + R + 1) + R * C + 3 * C + S * (C + R) \
        + (N * I if need_dx else 0)
    return bound_ms(ops, 4.0 * (n_in + n_out) + (N * 4 * C if mask else 0))


def k3_bound(N, R, K, Km):
    return bound_ms(2.0 * N * K * R,
                    4.0 * (N * R + K * R + K + 2 * N * Km + 4 * N))


def k4_bound(N, R, K, Km):
    # the function needs the logits once, dr and dW: 3 x 2NKR (the
    # kernel recomputes the logits in both of its passes: 4 x)
    return bound_ms(3 * 2.0 * N * K * R,
                    4.0 * (2 * N * R + 2 * K * R + 2 * K + 2 * N * Km
                           + 3 * N))


def compare(what, got, ref, worst):
    """Fail unless |got - ref| <= TRAIN_TOL * (1 + max|ref|); returns the
    new worst absolute error."""
    d = float((got - ref).abs().max()) if got.numel() else 0.0
    scale = 1.0 + (float(ref.abs().max()) if ref.numel() else 0.0)
    log(f"    {what}: max_abs_err {d:.3e}, scaled {d / scale:.3e} "
        f"(tol {TRAIN_TOL:g} x (1 + max|ref| = {scale:.4g}))")
    if not d <= TRAIN_TOL * scale:
        fail(f"{what} disagrees with the plain version")
    if not bool(got.isfinite().all()):
        fail(f"{what} has non-finite entries")
    return max(worst, d)


def lstm_train_case(name, S, T, I, C, R, clip, keep, need_dx, seed,
                    param_scale=0.04, x_scale=1.0, timed=False):
    """K1 and K2 against their plain versions on one input; returns
    (worst abs error, timing record or None)."""
    import torch
    from kaldi_lstm_tpu_torch.ops import lstm_train as lt
    params, x, state = lstm_case(S, T, I, C, R, seed, param_scale, x_scale)
    x_tm = x.transpose(0, 1).contiguous()
    rng = np.random.RandomState(seed + 100)
    mask = None
    if keep is not None:
        mask = torch.tensor(rng.rand(T, S, 4 * C) < keep,
                            device="cuda").to(torch.int8)
    ik = 1.0 if keep is None else 1.0 / keep
    g_r = torch.tensor(rng.randn(T, S, R).astype(np.float32), device="cuda")
    gcT = torch.tensor(rng.randn(S, C).astype(np.float32), device="cuda")
    fwd_args = (params, x_tm, state.c, state.r, mask, ik, clip)
    log(f"  [{name}] S={S} T={T} I={I} C={C} R={R} clip {clip:g} "
        f"keep {keep} dx {need_dx}")
    fk = lt.lstm_fwd_residuals_cuda(*fwd_args)
    fp = lt.lstm_fwd_residuals_plain(*fwd_args)
    torch.cuda.synchronize()
    worst = 0.0
    for what, a, b in zip(("K1 gifo", "K1 c", "K1 r"), fk, fp):
        worst = compare(what, a, b, worst)
    if clip < 10 and not bool((fp[1].abs() == clip).any()):
        fail(f"{name}: the clip never engaged")
    bwd_args = (params, x_tm, state.c, state.r, *fp, mask, ik, g_r, gcT,
                need_dx)
    bk = lt.lstm_bwd_cuda(*bwd_args)
    bp = lt.lstm_bwd_plain(*bwd_args)
    torch.cuda.synchronize()
    for f, a, b in zip(type(params)._fields, bk[0], bp[0]):
        worst = compare(f"K2 d{f}", a, b, worst)
    worst = compare("K2 dc0", bk[2], bp[2], worst)
    worst = compare("K2 dr0", bk[3], bp[3], worst)
    if need_dx:
        worst = compare("K2 dx", bk[1], bp[1], worst)
    elif bk[1] is not None:
        fail("K2 computed dx although need_input_grad is false")
    if not timed:
        return worst, None
    rec = {}
    for key, kfn, pfn, bnd in (
            ("K1", lambda: lt.lstm_fwd_residuals_cuda(*fwd_args),
             lambda: lt.lstm_fwd_residuals_plain(*fwd_args),
             k1_bound(T, S, I, C, R, mask is not None)),
            ("K2", lambda: lt.lstm_bwd_cuda(*bwd_args),
             lambda: lt.lstm_bwd_plain(*bwd_args),
             k2_bound(T, S, I, C, R, mask is not None, need_dx))):
        k_ms = cuda_ms(kfn)
        p_ms = cuda_ms(pfn, reps=3)
        log(f"  [{name}] {key}: kernel {k_ms:.3f} ms, plain {p_ms:.3f} ms, "
            f"bound {bnd[0]:.4f} ms ({bnd[1]}); library: n/a (no single "
            f"PyTorch call computes the LSTMP recurrence with peepholes, "
            f"clip and its residuals)")
        rec[key] = {"ms": k_ms, "plain_ms": p_ms, "bound_ms": bnd[0],
                    "bound_by": bnd[1]}
    return worst, rec


def lstm_function_case():
    """The autograd Function on the card (K1 + K2) against the same
    Function on the CPU (plain versions), with nonzero cotangents of the
    output and of the final c and r."""
    import torch
    from kaldi_lstm_tpu_torch.ops.lstm_cell import LstmParams, LstmState
    from kaldi_lstm_tpu_torch.ops.lstm_train import lstm_train
    S, T, I, C, R = 5, 9, 37, 200, 130
    params, x, state = lstm_case(S, T, I, C, R, 31, 0.05, 2.0, device="cpu")
    rng = np.random.RandomState(32)
    cots = [torch.tensor(rng.randn(*shape).astype(np.float32))
            for shape in ((S, T, R), (S, C), (S, R))]
    grads = {}
    for dev in ("cuda", "cpu"):
        leaves = [t.to(dev).requires_grad_() for t in (x, state.c, state.r,
                                                       *params)]
        out, fin = lstm_train(LstmParams(*leaves[3:]), leaves[0],
                              LstmState(leaves[1], leaves[2]), 50.0)
        torch.autograd.backward([out, fin.c, fin.r],
                                [c.to(dev) for c in cots])
        grads[dev] = [out.detach(), fin.c.detach(), fin.r.detach()] + \
            [t.grad for t in leaves]
    log(f"  [Function, S={S} T={T} I={I} C={C} R={R}, nonzero final-state "
        f"cotangent] card vs CPU")
    worst = 0.0
    names = ["out", "c_T", "r_T", "dx", "dc0", "dr0"] + \
        [f"d{f}" for f in LstmParams._fields]
    for n, a, b in zip(names, grads["cuda"], grads["cpu"]):
        worst = compare(n, a.cpu(), b, worst)
    return worst


def xent_case(name, N, R, K, Km, seed, bias_scale=0.1, mask_p=0.8,
              tie_at=None, timed=False):
    """K3 and K4 against their plain versions on one input; returns
    (worst abs error, timing record or None)."""
    import torch
    from kaldi_lstm_tpu_torch.ops import xent_affine as xa
    g = torch.Generator().manual_seed(seed)
    r = torch.randn(N, R, generator=g)
    w = torch.randn(K, R, generator=g) * 0.04
    b = torch.randn(K, generator=g) * bias_scale
    if tie_at is not None:
        # exact tie straddling a 64-class tile edge: small integers and
        # powers of two make every sum exact in any order
        r = torch.randint(-2, 3, (N, R), generator=g).float()
        w = torch.randint(-4, 5, (K, R), generator=g).float() / 8.0
        b = torch.zeros(K)
        w[tie_at] = w[tie_at + 1] = 8.0 * r.abs().amax(0) * torch.sign(r[0])
    ids = torch.randint(0, K, (N, Km), generator=g).to(torch.int32)
    tw = torch.rand(N, Km, generator=g)
    mask = (torch.rand(N, generator=g) < mask_p).float()
    r, w, b, ids, tw, mask = (t.cuda() for t in (r, w, b, ids, tw, mask))
    log(f"  [{name}] N={N} R={R} K={K} Km={Km}")
    fk = xa.xent_fwd_cuda(r, w, b, ids, tw)
    fp = xa.xent_fwd_plain(r, w, b, ids, tw)
    torch.cuda.synchronize()
    worst = 0.0
    for what, a, c in zip(("K3 lse", "K3 picked", "K3 max"), fk[:3], fp[:3]):
        worst = compare(what, a, c, worst)
    diff = (fk[3] != fp[3]).nonzero().flatten()
    if diff.numel():
        z = r[diff] @ w.T + b
        picked_z = z.gather(1, fk[3][diff].long()[:, None])[:, 0]
        tol = TRAIN_TOL * (1.0 + fp[2][diff].abs())
        if not bool((picked_z >= fp[2][diff] - tol).all()):
            fail(f"{name}: K3 argmax differs beyond near-ties")
    log(f"    K3 argmax: {diff.numel()} of {N} rows differ (near-ties only)")
    if tie_at is not None and int(fk[3][0]) != tie_at:
        fail(f"{name}: K3 did not keep the first of tied maxima "
             f"({int(fk[3][0])} != {tie_at})")
    scale, wtot = mask, tw.sum(-1)
    bargs = (r, w, b, ids, tw, fp[0], scale, wtot)
    bk = xa.xent_bwd_cuda(*bargs)
    bp = xa.xent_bwd_plain(*bargs)
    torch.cuda.synchronize()
    for what, a, c in zip(("K4 dr", "K4 dW", "K4 db"), bk, bp):
        worst = compare(what, a, c, worst)
    if bool(bk[0][mask == 0].any()):
        fail(f"{name}: masked rows contributed to dr")
    if not timed:
        return worst, None
    rec = {}
    for key, kfn, pfn, bnd in (
            ("K3", lambda: xa.xent_fwd_cuda(r, w, b, ids, tw),
             lambda: xa.xent_fwd_plain(r, w, b, ids, tw),
             k3_bound(N, R, K, Km)),
            ("K4", lambda: xa.xent_bwd_cuda(*bargs),
             lambda: xa.xent_bwd_plain(*bargs), k4_bound(N, R, K, Km))):
        k_ms = cuda_ms(kfn)
        p_ms = cuda_ms(pfn)
        log(f"  [{name}] {key}: kernel {k_ms:.3f} ms, plain {p_ms:.3f} ms, "
            f"bound {bnd[0]:.4f} ms ({bnd[1]}); library: n/a (no single "
            f"PyTorch call computes the affine + softmax + sparse-target "
            f"xent or its fused gradient)")
        rec[key] = {"ms": k_ms, "plain_ms": p_ms, "bound_ms": bnd[0],
                    "bound_by": bnd[1]}
    gemm_ms = cuda_ms(lambda: r @ w.T)
    log(f"  [{name}] context: cuBLAS f32 r @ W.T alone {gemm_ms:.3f} ms "
        f"(not used by the port)")
    return worst, rec


def phase_train_kernels():
    """K1-K4 vs plain on the card. Returns {kernel: record} with the
    timings at the main path's shape and the worst abs error."""
    S, T, I, C, R, K = TRAIN_S, TRAIN_T, 40, 800, 512, 8000
    worst = {"K1": 0.0, "K2": 0.0, "K3": 0.0, "K4": 0.0}
    recs = {}
    lstm_cases = [
        # name, dims, clip, keep, need_dx, extra, timed
        ("flagship, main path (no dropout, no dx)", (S, T, I, C, R), 50.0,
         None, False, {}, True),
        ("flagship, keep 0.8, dx", (S, T, I, C, R), 50.0, 0.8, True, {},
         False),
        ("ragged S=3 I=37 C=200 R=130, clip active", (3, T, 37, 200, 130),
         1.0, 0.8, True, {"x_scale": 20.0, "param_scale": 0.2}, False),
    ]
    for i, (name, dims, clip, keep, dx, extra, timed) in \
            enumerate(lstm_cases):
        w, rec = lstm_train_case(name, *dims, clip, keep, dx, 40 + i,
                                 timed=timed, **extra)
        worst["K1"] = worst["K2"] = max(worst["K1"], w)
        if rec:
            recs.update(rec)
    w = lstm_function_case()
    worst["K1"] = worst["K2"] = max(worst["K1"], w)
    xent_cases = [
        ("flagship, main path", (S * T, R, K, 1), {}, True),
        ("ragged N=1001 R=130 K=1000 Km=3", (1001, 130, 1000, 3), {}, False),
        ("large bias 200, half the rows masked", (70, 64, 300, 2),
         {"bias_scale": 200.0, "mask_p": 0.5}, False),
        ("argmax tie at classes 63/64", (40, 16, 200, 1), {"tie_at": 63},
         False),
    ]
    for i, (name, dims, extra, timed) in enumerate(xent_cases):
        w, rec = xent_case(name, *dims, 60 + i, timed=timed, **extra)
        worst["K3"] = worst["K4"] = max(worst["K3"], w)
        if rec:
            recs.update(rec)
    for k in recs:
        recs[k]["max_abs_err"] = worst[k]
    return recs


def write_train_corpus(work: str):
    """256 utterances of 100-300 frames x 40 dims (numpy seed 7) and
    1-best posteriors over 8000 classes that depend on the frame (the
    index of its largest feature, times 200), so one epoch can learn."""
    from kaldi_lstm_tpu_torch.io import kaldi_io as kio
    rng = np.random.RandomState(7)
    feats = f"ark:{work}/train_feats.ark"
    post = f"ark:{work}/train_post.ark"
    with kio.MatrixWriter(feats) as fw, kio.PosteriorWriter(post) as pw:
        for i in range(256):
            x = rng.randn(int(rng.randint(100, 301)), 40).astype(np.float32)
            fw.write(f"utt{i:03d}", x)
            pw.write(f"utt{i:03d}",
                     [[(int(k) * 200, 1.0)] for k in x.argmax(1)])
    return feats, post


def phase_train(work: str):
    """The training main path; returns the K1-K4 launch counts."""
    import torch
    import kaldi_lstm_tpu_torch.ops.lstm_infer as li
    import kaldi_lstm_tpu_torch.ops.lstm_train as lt
    import kaldi_lstm_tpu_torch.ops.xent_affine as xa
    from kaldi_lstm_tpu_torch.io import kaldi_io as kio
    from kaldi_lstm_tpu_torch.models import Nnet
    from kaldi_lstm_tpu_torch.tools import train_lstm_streams
    from kaldi_lstm_tpu_torch.train.streams import StreamScheduler
    from kaldi_lstm_tpu_torch.train.trainer import (
        TrainOptions,
        make_train_step,
        place_batch,
    )
    from kaldi_lstm_tpu_torch.train.optim import init_momentum
    from kaldi_lstm_tpu_torch.utils.tree import tree_leaves

    feats, post = write_train_corpus(work)
    model_in = os.path.join(work, "flagship.init")
    model_out = os.path.join(work, "flagship.iter1")
    nnet, params = Nnet.init_from_proto(
        TRAIN_PROTO, torch.Generator().manual_seed(0), "cuda")
    nnet.write(model_in, params, binary=True)
    common = [f"--num-stream={TRAIN_S}", f"--batch-size={TRAIN_T}",
              "--targets-delay=0", "--device", "cuda"]

    rc, cv0 = train_lstm_streams.run_main(
        [feats, post, model_in, "--cross-validate=true"] + common)
    if rc != 0:
        fail(f"cross-validation before training exited {rc}")

    sched = StreamScheduler(kio.SequentialMatrixReader(feats),
                            kio.RandomAccessPosteriorReader(post), 40,
                            TRAIN_S, TRAIN_T, 0)
    batches = list(sched)
    steps = len(batches)
    T = TRAIN_T
    predicted = {"lstmp_train_fwd": 2 * T * steps,
                 "lstmp_train_bwd": (2 * T + 4) * steps,
                 "xent_affine_fwd": steps, "xent_affine_bwd": 2 * steps}

    for m in (li, lt, xa):
        m.reset_counts()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    rc, stats = train_lstm_streams.run_main(
        [feats, post, model_in, model_out, f"--learn-rate={TRAIN_LR}",
         "--momentum=0.9"] + common)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    launches = {"lstmp_train_fwd": lt.FWD_LAUNCHES,
                "lstmp_train_bwd": lt.BWD_LAUNCHES,
                "xent_affine_fwd": xa.FWD_LAUNCHES,
                "xent_affine_bwd": xa.BWD_LAUNCHES}
    plain = (lt.PLAIN_CALLS, xa.PLAIN_CALLS, li.PLAIN_CALLS)
    if rc != 0:
        fail(f"train_lstm_streams exited {rc}")
    log(f"  train_lstm_streams: rc 0 in {wall:.3f} s (incl. model read, "
        f"ark I/O, CUDA warm-up); {steps} steps of {TRAIN_S}x{T}")
    for k in predicted:
        log(f"    {k}: launches {launches[k]} (predicted {predicted[k]})")
    log(f"    plain-version calls (lstm_train, xent_affine, lstm_infer): "
        f"{plain}")
    if launches != predicted:
        fail("the training path did not launch K1-K4 as predicted")
    if plain != (0, 0, 0):
        fail("the training path took a plain version on the card")
    if not os.path.getsize(model_out) > 0:
        fail("no trained model was written")
    frames = stats.frames
    log(f"  epoch: {frames:.0f} frames in {wall:.3f} s -> "
        f"{frames / wall:.1f} frames/s, "
        f"{frames / FRAMES_PER_AUDIO_SECOND / wall:.2f} audio-s/s "
        f"(whole CLI run); {stats.report().splitlines()[0]}")

    rc, cv1 = train_lstm_streams.run_main(
        [feats, post, model_out, "--cross-validate=true"] + common)
    if rc != 0:
        fail(f"cross-validation after training exited {rc}")
    log(f"  cross-validation AvgLoss: before {cv0.avg_loss():.6f}, after "
        f"{cv1.avg_loss():.6f}")
    if not cv1.avg_loss() < cv0.avg_loss():
        fail("cross-validation AvgLoss did not fall after the epoch")

    # two steps on the card against the same two steps on the CPU path
    opts = TrainOptions(learn_rate=TRAIN_LR, momentum=0.9)
    res = {}
    for dev in ("cuda", "cpu"):
        nnet_d, params_d = Nnet.read(model_in, dev)
        step = make_train_step(nnet_d, opts, device=dev)
        opt, states = init_momentum(params_d), nnet_d.init_states(TRAIN_S,
                                                                  dev)
        lr = torch.tensor(TRAIN_LR, device=dev)
        auxs = []
        for b in batches[:2]:
            params_d, opt, states, aux = step(
                params_d, opt, states, (), *place_batch(b, dev), lr)
            auxs.append([float(a) for a in aux])
        res[dev] = (tree_leaves(params_d), auxs)
    worst = 0.0
    for a, b in zip(res["cuda"][0], res["cpu"][0]):
        d = (a.cpu() - b).abs()
        worst = max(worst, float(d.max()))
        if not bool((d <= STEP_ATOL + STEP_RTOL * b.abs()).all()):
            fail("two steps on the card disagree with the CPU path")
    for (xk, ek, ck, fk), (xc, ec, cc, fc) in zip(res["cuda"][1],
                                                  res["cpu"][1]):
        if not (abs(xk - xc) <= 1e-5 * abs(xc)
                and abs(ek - ec) <= 1e-5 * abs(ec)
                and fk == fc and abs(ck - cc) <= 2):
            fail(f"LossAux on the card {(xk, ek, ck, fk)} vs CPU "
                 f"{(xc, ec, cc, fc)}")
    log(f"  two steps card vs CPU path: params max_abs_err {worst:.3e} "
        f"(tol {STEP_ATOL:g} + {STEP_RTOL:g} x |p|); LossAux card "
        f"{res['cuda'][1]} vs CPU {res['cpu'][1]}")

    # steady state: warm steps on placed batches
    nnet_g, params_g = Nnet.read(model_in, "cuda")
    step = make_train_step(nnet_g, opts, device="cuda")
    opt, states = init_momentum(params_g), nnet_g.init_states(TRAIN_S,
                                                              "cuda")
    lr = torch.tensor(TRAIN_LR, device="cuda")
    placed = [place_batch(b, "cuda") for b in batches[:6]]

    def run_steps(group):
        nonlocal params_g, opt, states
        for p in group:
            params_g, opt, states, _ = step(params_g, opt, states, (), *p,
                                            lr)

    run_steps(placed[:1])
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    run_steps(placed[1:])
    torch.cuda.synchronize()
    dt = (time.perf_counter() - t0) / (len(placed) - 1)
    valid = sum(float(b.mask.sum()) for b in batches[1:6]) / 5
    log(f"  steady training step: {1e3 * dt:.3f} ms per step of "
        f"{TRAIN_S}x{T} -> {TRAIN_S * T / dt:.1f} frames/s "
        f"({TRAIN_S * T / FRAMES_PER_AUDIO_SECOND / dt:.2f} audio-s/s) "
        f"with every slot counted, {valid / dt:.1f} valid frames/s")
    profile(lambda: run_steps(placed[:1]), "one training step")
    return launches


def phase_main_path(work: str):
    import torch
    import kaldi_lstm_tpu_torch.ops.lstm_infer as li
    from kaldi_lstm_tpu_torch.decode.scoring import (
        AmScorer,
        log_priors_from_counts,
    )
    from kaldi_lstm_tpu_torch.io import kaldi_io as kio
    from kaldi_lstm_tpu_torch.models import Nnet
    from kaldi_lstm_tpu_torch.tools import nnet_forward

    model = os.path.join(work, "final.nnet")
    feats_ark = os.path.join(work, "feats.ark")
    counts_path = os.path.join(work, "counts.vec")
    out_ark = os.path.join(work, "loglik.ark")

    nnet, params = Nnet.init_from_proto(
        PROTO, torch.Generator().manual_seed(0), "cuda")
    nnet.write(model, params, binary=True)
    rng = np.random.RandomState(1)
    utts = {f"utt{i:03d}": rng.randn(int(rng.randint(200, 1001)), 40)
            .astype(np.float32) for i in range(24)}
    with kio.MatrixWriter(f"ark:{feats_ark}") as w:
        for k, m in utts.items():
            w.write(k, m)
    counts = rng.randint(1, 1000, size=8000).astype(np.float32)
    with open(counts_path, "wb") as f:
        kio.write_vector(kio.KaldiOutput(f), counts)

    argv = [model, f"ark:{feats_ark}", f"ark:{out_ark}", "--apply-log=true",
            "--class-frame-counts", counts_path, "--device", "cuda"]
    li.reset_counts()
    t0 = time.perf_counter()
    rc = nnet_forward.main(argv)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    launches, plain_calls = li.LAUNCHES, li.PLAIN_CALLS
    if rc != 0:
        fail(f"nnet_forward exited {rc}")
    keys = list(utts)
    expected = sum(
        2 * -(-max(utts[k].shape[0] for k in keys[b:b + 8]) // 128) * 128
        for b in range(0, len(keys), 8))
    log(f"  nnet_forward: rc 0 in {wall:.3f} s (incl. model read, CUDA "
        f"warm-up and ark I/O); lstmp_infer launches {launches} "
        f"(expected {expected}), plain-version calls {plain_calls}")
    if launches <= 0 or launches != expected:
        fail("the main path did not go through lstmp_infer as expected")
    if plain_calls != 0:
        fail("the main path took the plain version on the card")

    got = dict(kio.SequentialMatrixReader(f"ark:{out_ark}"))
    if list(got) != keys:
        fail(f"output keys differ: {len(got)} written of {len(keys)}")
    for k in keys:
        y = got[k]
        if y.shape != (utts[k].shape[0], 8000) or not np.isfinite(y).all():
            fail(f"{k}: bad output shape {y.shape} or non-finite values")

    lp = log_priors_from_counts(counts)
    nnet_c, params_c = Nnet.read(model, "cpu")
    cpu = AmScorer(nnet_c, params_c, log_prior=lp, apply_log=True,
                   device="cpu")
    worst = 0.0
    for k, y in cpu.score_stream((k, utts[k]) for k in keys[:3]):
        worst = max(worst, float(np.abs(got[k] - y).max()))
    log(f"  card vs CPU path on 3 utterances: max_abs_err {worst:.3e} "
        f"(tol {SCORE_ATOL:g})")
    if worst > SCORE_ATOL:
        fail("card scores disagree with the CPU path")

    # steady-state throughput: the same scorer, warm, features in memory
    nnet_g, params_g = Nnet.read(model, "cuda")
    scorer = AmScorer(nnet_g, params_g, log_prior=lp, apply_log=True,
                      device="cuda")
    frames = sum(m.shape[0] for m in utts.values())
    for _ in scorer.score_stream(list(utts.items())[:8]):
        pass
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    n = sum(1 for _ in scorer.score_stream(utts.items()))
    torch.cuda.synchronize()
    dt = time.perf_counter() - t0
    log(f"  steady scoring: {n} utterances, {frames} frames in {dt:.3f} s "
        f"-> {frames / dt:.1f} frames/s, "
        f"{frames / FRAMES_PER_AUDIO_SECOND / dt:.2f} audio-s/s")
    group = list(utts.items())[:8]
    profile(lambda: [None for _ in scorer.score_stream(group)],
            f"one batch ({len(group)} utterances)")
    return launches


def profile(fn, what: str) -> None:
    """Device time by kernel over one call of fn(), and the share of its
    wall time in which no kernel ran (torch.profiler)."""
    import torch
    from torch.profiler import ProfilerActivity, profile as tprofile
    acts = [ProfilerActivity.CPU, ProfilerActivity.CUDA]
    with tprofile(activities=acts) as prof:
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        fn()
        torch.cuda.synchronize()
        wall_us = 1e6 * (time.perf_counter() - t0)
    rows = []
    for e in prof.key_averages():
        if e.device_type != torch.autograd.DeviceType.CUDA:
            continue
        us = getattr(e, "self_device_time_total", None)
        if us is None:
            us = getattr(e, "self_cuda_time_total", 0.0)
        rows.append((us, e.count, e.key))
    busy = sum(r[0] for r in rows)
    if busy <= 0:
        log(f"  profile of {what}: the profiler recorded no device time "
            f"(not measured)")
        return
    log(f"  profile of {what}: wall {wall_us / 1e3:.3f} ms, device busy "
        f"{busy / 1e3:.3f} ms, idle share {max(0.0, 1 - busy / wall_us):.3f}")
    for us, count, key in sorted(rows, reverse=True)[:10]:
        log(f"    {us / 1e3:10.3f} ms {100 * us / busy:5.1f}% x{count:<6d} "
            f"{key[:90]}")


def main() -> int:
    import torch
    if not torch.cuda.is_available():
        fail("torch.cuda.is_available() is false; this test needs a card")
    import kaldi_lstm_tpu_torch.ops._build as build

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False

    smi = nvidia_smi_line()
    log(f"phase 1: torch {torch.__version__}, CUDA {torch.version.cuda}, "
        f"device {torch.cuda.get_device_name(0)} "
        f"(count {torch.cuda.device_count()})")
    log(smi)

    t0 = time.perf_counter()
    build.build_all()
    log(f"phase 2: built {build.kernel_names()} in "
        f"{time.perf_counter() - t0:.2f} s")
    for name, (sec, out) in build.BUILD_LOG.items():
        log(f"  nvcc {name} ({sec:.2f} s):")
        for line in out.strip().splitlines():
            log(f"    {line}")

    log("phase 3: K5 vs its plain version on the card")
    rec = phase_kernels()

    log("phase 3b: K1-K4 vs their plain versions on the card")
    train_recs = phase_train_kernels()

    log("phase 4: serving path (nnet_forward, full-width standard net)")
    with tempfile.TemporaryDirectory(prefix="klt_chip_smoke_") as work:
        launches = phase_main_path(work)

    log("phase 5: training path (train_lstm_streams, full-width flagship)")
    with tempfile.TemporaryDirectory(prefix="klt_chip_smoke_") as work:
        train_launches = phase_train(work)

    kernels = [{
        "name": "lstmp_infer", "route": "cuda",
        "source": "kaldi_lstm_tpu_torch/csrc/lstmp_infer.cu",
        "replaces": "kaldi_lstm_tpu/ops/lstm_pallas.py:243 (_infer_kernel)",
        "launches": launches, "max_abs_err": rec["max_abs_err"],
        "ms": rec["ms"], "kernel_ms": rec["ms"],
        "plain_ms": rec["plain_ms"], "bound_ms": rec["bound_ms"],
        "bound_by": rec["bound_by"], "library_ms": None,
    }]
    for key, name, source, replaces in (
            ("K1", "lstmp_train_fwd", "lstmp_train.cu",
             "kaldi_lstm_tpu/ops/lstm_pallas.py:120 (_fwd_kernel)"),
            ("K2", "lstmp_train_bwd", "lstmp_train.cu",
             "kaldi_lstm_tpu/ops/lstm_pallas.py:337 (_bwd_kernel)"),
            ("K3", "xent_affine_fwd", "xent_affine.cu",
             "kaldi_lstm_tpu/ops/xent_pallas.py:51 (_fwd_kernel)"),
            ("K4", "xent_affine_bwd", "xent_affine.cu",
             "kaldi_lstm_tpu/ops/xent_pallas.py:148 (_bwd_kernel)")):
        r = train_recs[key]
        kernels.append({
            "name": name, "route": "cuda",
            "source": f"kaldi_lstm_tpu_torch/csrc/{source}",
            "replaces": replaces, "launches": train_launches[name],
            "max_abs_err": r["max_abs_err"], "ms": r["ms"],
            "plain_ms": r["plain_ms"], "bound_ms": r["bound_ms"],
            "bound_by": r["bound_by"], "library_ms": None})
    log(smi)
    log(json.dumps({"kernels": kernels}))
    log(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
