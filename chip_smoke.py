#!/usr/bin/env python3
"""On-card smoke test of the PyTorch/CUDA port (kaldi_lstm_tpu_torch).

    python3 chip_smoke.py

Needs one CUDA card and nvcc; imports nothing of JAX. Phases, in order
(any failure exits nonzero before the result lines are printed):

1. environment: torch and CUDA versions, the card's name and power limit;
2. build every kernel from kaldi_lstm_tpu_torch/csrc/ (one nvcc each,
   started together) and print nvcc's register/shared-memory report;
3. hold the inference kernel (K5, one persistent cooperative launch per
   call) against its plain PyTorch version on the card at the serving
   path's widths (S=8, T=128 and 1000, clipped, ragged), at the
   cross-validation shape (S=256, T=20), at the deep config's layer-2
   width (I=512) and at inputs too wide for the weights to stay in
   shared memory (I=1024, 1501); time the entry point `lstm_infer` and
   the plain version, both on batch-major x, with CUDA events at S=8
   (T=128, 1000), S=256 (T=20) and I=512 (T=1000), and print the time
   per step at S=8;
3b. hold the training kernels K1-K4 (LSTMP forward with residuals, BPTT,
   fused senone affine + xent forward and backward, the latter two
   3xTF32 tensor-core kernels) against their plain versions at the
   flagship training width (S=256, T=20, I=40, C=800, R=512, K=8000), at
   the deep config's new shapes (K1/K2 with dx at I=512, K3/K4 at
   K=16624, K2 also with dropout at I=512) and on ragged, clipped,
   dropout, no-dx, final-state-cotangent and argmax-tie cases (K3/K4:
   ties across a 64-class tile edge and across K3's class-chunk edge);
   time kernel and plain (K1/K2 at the flagship shape and at I=512 with
   dx); print bounds (for K2, K3 and K4 both the f32 CUDA-core and the
   3xTF32 tensor-core bound) and, as context, cuBLAS f32 times of K2's four
   products and K3/K4's three;
3c. hold the wavefront two-layer kernels K6/K7 against their plain
   versions at the deep config's width (S=512, T=20, tb 5/4/2/1, nonzero
   states), on a ragged clipped case and K7 at the serving shape (S=8,
   T=1000); K6's residuals through K2 against K1's; time kernel, plain
   and the serial two-kernel schedule (K1 x 2, K5 x 2) and print their
   ratio; then drive the port's
   `tools/bench_wavefront` (A/B, ablation, profile) with the K6/K7
   counts zeroed before its A/B and read after;
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
   zeroed just before and read just after; check two cross-validation
   runs of one model give the same AvgLoss to the last digit, the counts
   against the design's prediction, no plain call, the model file, a lower
   cross-validation AvgLoss after the epoch than before, and two steps
   on the card against the same two steps on the port's CPU path; print
   train throughput and a profile of one step;
6. drive the deep path (2 x LSTMP 800c/512r -> 16624 senones) through
   the layer-stacking recipe at full width: `run_recipe` trains the
   one-layer net, `nnet_edit` stacks a fresh LSTMP-2 and senone affine
   on the frozen trunk, `run_recipe` trains that (the trunk stays
   bit-identical), `nnet_edit` unfreezes, `run_recipe` fine-tunes
   (cross-validation AvgLoss falls), `nnet_info` prints the net,
   `nnet_copy --to-standard` converts it and `nnet_forward` scores with
   class counts; K1-K5 counts against the prediction for every step and
   batch, no plain call; one deep step and three utterances' scores on
   the card against the port's CPU path; print the warm deep step, the
   deep scoring rate and a profile of one deep step;
7. print one JSON line with every kernel, then the device line last.
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
# cores, TF32 in the tensor cores (dense), and HBM3 bandwidth.
PEAK_F32_FLOPS = 67e12
PEAK_TF32_FLOPS = 495e12
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
# the entries themselves) still fails. K2's products and K3/K4 compute on
# the tensor cores in the 3xTF32 split, float32-accurate; the same
# tolerance holds them. Argmax indices must agree
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
# The deep config (bench.py:91-100, BASELINE config 4: the reference's
# own decode-example model), trained through the layer-stacking recipe
# of examples/flagship_experiment.sh:127-200: the one-layer net, then a
# fresh LSTMP-2 + senone affine on the frozen trunk, then the whole
# stack.
DEEP_K = 16624
DEEP_PRE_PROTO = """<NnetProto>
<Transmit> <InputDim> 40 <OutputDim> 40
<LstmProjectedStreams> <InputDim> 40 <OutputDim> 512 <CellDim> 800 <ParamScale> 0.01 <NumStream> 4
<AffineTransform> <InputDim> 512 <OutputDim> 16624 <ParamStddev> 0.04
<Softmax> <InputDim> 16624 <OutputDim> 16624
</NnetProto>
"""
DEEP_STACK_LINES = (
    "<LstmProjectedStreams> <InputDim> 512 <OutputDim> 512 <CellDim> 800 "
    "<ParamScale> 0.01 <NumStream> 4\n"
    "<AffineTransform> <InputDim> 512 <OutputDim> 16624 <ParamStddev> 0.04")
# one deep step, card vs the port's CPU path, on 64 streams (bounds the
# CPU's time); tolerances as phase 5's
DEEP_CHECK_S = 64


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
    main-path shape (S=8, T=1000), with the cross-validation shape's
    (S=256, T=20) times and the time per step beside it."""
    import torch
    from kaldi_lstm_tpu_torch.ops import lstm_infer as li
    from kaldi_lstm_tpu_torch.ops.lstm_cell import lstm_scan

    cases = [
        # name, (S, T, I, C, R), cell_clip, extra, timed
        ("full T=128 nonzero state", (8, 128, 40, 800, 512), 50.0, {},
         True),
        ("full T=1000 nonzero state", (8, 1000, 40, 800, 512), 50.0, {},
         True),
        ("full T=128 clip active", (8, 128, 40, 800, 512), 1.0,
         {"x_scale": 20.0, "param_scale": 0.2}, False),
        ("ragged S=3 I=37 C=200 R=130", (3, 128, 37, 200, 130), 50.0, {},
         False),
        ("cross-validation S=256 T=20", (256, 20, 40, 800, 512), 50.0, {},
         True),
        ("deep layer 2, I=512 T=1000", (8, 1000, 512, 800, 512), 50.0, {},
         True),
        ("deep layer 2 cross-validation, I=512 S=256 T=20",
         (256, 20, 512, 800, 512), 50.0, {}, False),
        # weight slices too wide for a CTA's shared memory: the same
        # kernel reads them from device memory
        ("weights in device memory, S=8 T=16 I=1024",
         (8, 16, 1024, 800, 512), 50.0, {"resident": False}, False),
        ("weights in device memory, ragged S=3 T=9 I=1501 R=130",
         (3, 9, 1501, 800, 130), 50.0, {"resident": False}, False),
    ]
    worst = 0.0
    times = {}
    for i, (name, dims, clip, extra, timed) in enumerate(cases):
        resident = extra.pop("resident", True)   # what the plan must say
        params, x, state = lstm_case(*dims, seed=10 + i, **extra)

        def kernel():
            return li.lstm_infer(params, x, state, clip)

        li.reset_counts()
        with torch.inference_mode():
            out_k, fin_k = kernel()
            out_p, fin_p = lstm_scan(params, x, state, clip)
            torch.cuda.synchronize()
        if (li.LAUNCHES, li.PLAIN_CALLS) != (1, 0):
            fail(f"{name}: {li.LAUNCHES} launches and {li.PLAIN_CALLS} "
                 f"plain calls for one call (expected 1 and 0)")
        plan = li.device_plan(*dims[:1], *dims[2:])
        if plan["resident"] != int(resident):
            fail(f"{name}: the plan {plan} does not keep the weights "
                 f"{'resident' if resident else 'in device memory'}")
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
        if not timed:
            continue
        with torch.inference_mode():
            k_ms = cuda_ms(kernel)
            p_ms = cuda_ms(lambda: lstm_scan(params, x, state, clip),
                           reps=3)
        bound, by = lstm_bound_ms(*dims)
        log(f"  [{name}] kernel {k_ms:.3f} ms, plain {p_ms:.3f} ms, "
            f"bound {bound:.4f} ms ({by}); plan {plan}; library: n/a (no "
            f"single PyTorch call computes LSTMP with peepholes and the "
            f"clip)")
        times[dims] = {"ms": k_ms, "plain_ms": p_ms, "bound_ms": bound,
                       "bound_by": by}
    record = dict(times[(8, 1000, 40, 800, 512)])
    us_step = 1e3 * (record["ms"] - times[(8, 128, 40, 800, 512)]["ms"]) \
        / (1000 - 128)
    log(f"  K5 per step at S=8: {us_step:.3f} us "
        f"((t(T=1000) - t(T=128)) / 872)")
    cv = times[(256, 20, 40, 800, 512)]
    record.update(max_abs_err=worst, us_per_step_s8=us_step,
                  cv_ms=cv["ms"], cv_plain_ms=cv["plain_ms"],
                  cv_bound_ms=cv["bound_ms"])
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


def k2_tc_bound(simt, T, S, I, C, R, need_dx):
    """K2's float32-accurate tensor-core bound: the products it runs on
    the tensor cores (the per-step dr = dgifo Wr, dWr, dWrm, dWx and,
    with dx, dx = dxw Wx) three times over at the TF32 peak, plus the
    one it keeps on the CUDA cores (bwd_cell's dm = dr_total Wrm) at the
    f32 peak; the compulsory bytes are those of the f32 bound `simt`
    (ms, by). Returns (ms, by)."""
    N = T * S
    tc_ops = 2.0 * N * (8 * C * R + R * C + (8 if need_dx else 4) * C * I)
    t_ops = 1e3 * (3 * tc_ops / PEAK_TF32_FLOPS
                   + 2.0 * N * R * C / PEAK_F32_FLOPS)
    t_bytes = simt[0] if simt[1] == "bytes" else 0.0
    return (max(t_ops, t_bytes), "operations" if t_ops >= t_bytes
            else "bytes")


def k3_bound(N, R, K, Km):
    return bound_ms(2.0 * N * K * R,
                    4.0 * (N * R + K * R + K + 2 * N * Km + 4 * N))


def k4_bound(N, R, K, Km):
    # the function needs the logits once, dr and dW: 3 x 2NKR
    return bound_ms(3 * 2.0 * N * K * R,
                    4.0 * (2 * N * R + 2 * K * R + 2 * K + 2 * N * Km
                           + 3 * N))


def tc_bound(simt, products, N, R, K):
    """The float32-accurate tensor-core bound of K3 (1 product) or K4 (3
    products): 3xTF32 does each product's 2NKR operations three times at
    the TF32 peak; the compulsory bytes are those of the f32 bound
    `simt` (ms, by). Returns (ms, by)."""
    t_ops = 1e3 * 3 * products * 2.0 * N * K * R / PEAK_TF32_FLOPS
    t_bytes = simt[0] if simt[1] == "bytes" else 0.0
    return (max(t_ops, t_bytes), "operations" if t_ops >= t_bytes
            else "bytes")


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
        rec[key] = {"ms": k_ms, "plain_ms": p_ms}
        if key == "K2":
            simt = bnd
            tc = k2_tc_bound(simt, T, S, I, C, R, need_dx)
            bnd = min(simt, tc)
            what = (f"bounds: f32 CUDA cores {simt[0]:.4f} ms ({simt[1]}), "
                    f"3xTF32 tensor cores {tc[0]:.4f} ms ({tc[1]}; 3 x "
                    f"the products' operations at "
                    f"{PEAK_TF32_FLOPS / 1e12:g} TFLOP/s, dm at "
                    f"{PEAK_F32_FLOPS / 1e12:g})")
            rec[key].update(bound_f32_simt_ms=simt[0],
                            bound_3xtf32_ms=tc[0])
        else:
            what = f"bound {bnd[0]:.4f} ms ({bnd[1]})"
        log(f"  [{name}] {key}: kernel {k_ms:.3f} ms, plain {p_ms:.3f} ms, "
            f"{what}; library: n/a (no single PyTorch call computes the "
            f"LSTMP recurrence with peepholes, clip and its residuals)")
        rec[key].update(bound_ms=bnd[0], bound_by=bnd[1])
    # context: cuBLAS f32 on K2's four products at these shapes (random
    # operands; the port never calls these)
    N = T * S
    dg, ho, rp, xs = (torch.randn(N, n, device="cuda")
                      for n in (4 * C, C, R, I))
    drt = torch.randn(N, R, device="cuda")
    ctx = {what: cuda_ms(fn) for what, fn in (
        ("dWr", lambda: dg.T @ rp), ("dWrm", lambda: drt.T @ ho),
        ("dWx", lambda: dg.T @ xs), ("dx", lambda: dg @ params.w_gifo_x))}
    log(f"  [{name}] context (cuBLAS f32, not used by the port): " +
        ", ".join(f"{k} {v:.3f} ms" for k, v in ctx.items()) +
        f"; sum {sum(ctx.values()):.3f} ms")
    rec["K2"]["cublas_products_ms"] = ctx
    del dg, ho, rp, xs, drt
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
    (worst abs error, timing record or None). Timed cases also print
    cuBLAS f32 times of the three products (context, not used by the
    port)."""
    import torch
    from kaldi_lstm_tpu_torch.ops import xent_affine as xa
    g = torch.Generator().manual_seed(seed)
    r = torch.randn(N, R, generator=g)
    w = torch.randn(K, R, generator=g) * 0.04
    b = torch.randn(K, generator=g) * bias_scale
    if tie_at is not None:
        # exact tie straddling a tile or chunk edge: small integers and
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
    for key, kfn, pfn, simt, products in (
            ("K3", lambda: xa.xent_fwd_cuda(r, w, b, ids, tw),
             lambda: xa.xent_fwd_plain(r, w, b, ids, tw),
             k3_bound(N, R, K, Km), 1),
            ("K4", lambda: xa.xent_bwd_cuda(*bargs),
             lambda: xa.xent_bwd_plain(*bargs), k4_bound(N, R, K, Km), 3)):
        k_ms = cuda_ms(kfn)
        p_ms = cuda_ms(pfn)
        tc = tc_bound(simt, products, N, R, K)
        bnd = min(simt, tc)
        log(f"  [{name}] {key}: kernel {k_ms:.3f} ms, plain {p_ms:.3f} ms; "
            f"bounds: f32 CUDA cores {simt[0]:.4f} ms ({simt[1]}), 3xTF32 "
            f"tensor cores {tc[0]:.4f} ms ({tc[1]}; 3 x the product's "
            f"operations at {PEAK_TF32_FLOPS / 1e12:g} TFLOP/s); library: "
            f"n/a (no single PyTorch call computes the affine + softmax + "
            f"sparse-target xent or its fused gradient)")
        rec[key] = {"ms": k_ms, "plain_ms": p_ms, "bound_ms": bnd[0],
                    "bound_by": bnd[1], "bound_f32_simt_ms": simt[0],
                    "bound_3xtf32_ms": tc[0]}
    dz = torch.exp(r @ w.T + b - fp[0][:, None]) * (scale * wtot)[:, None]
    times = [cuda_ms(fn) for fn in (lambda: r @ w.T, lambda: dz @ w,
                                    lambda: dz.T @ r)]
    log(f"  [{name}] context (cuBLAS f32, not used by the port): r @ W.T "
        f"{times[0]:.3f} ms, dz @ W {times[1]:.3f} ms, dz.T @ r "
        f"{times[2]:.3f} ms")
    del dz
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
        ("deep layer 2, I=512, dx", (S, T, 512, C, R), 50.0, None, True, {},
         "deep"),
        ("deep layer 2, I=512, keep 0.8, dx", (S, T, 512, C, R), 50.0, 0.8,
         True, {}, False),
    ]
    # timed: True = the main path's record; "deep" = printed only
    for i, (name, dims, clip, keep, dx, extra, timed) in \
            enumerate(lstm_cases):
        w, rec = lstm_train_case(name, *dims, clip, keep, dx, 40 + i,
                                 timed=bool(timed), **extra)
        worst["K1"] = worst["K2"] = max(worst["K1"], w)
        if rec and timed is True:
            recs.update(rec)
    w = lstm_function_case()
    worst["K1"] = worst["K2"] = max(worst["K1"], w)
    from kaldi_lstm_tpu_torch.ops.xent_affine import FWD_CHUNK
    log(f"  K3/K4 design: every product (r W^T, dz W, dz^T r) on the tensor "
        f"cores as mma.sync m16n8k8 TF32 in the 3xTF32 split (x = hi + lo, "
        f"a_lo b_hi + a_hi b_lo + a_hi b_hi in f32, one zeroed fragment "
        f"per 32-deep stage), cp.async-fed shared-memory tiles; K3 = "
        f"(128-frame tile x {FWD_CHUNK}-class chunk) partials + a merge "
        f"launch, K4 = dz stored once + dr + dW/db; held to TRAIN_TOL as "
        f"the f32 kernels were")
    xent_cases = [
        ("flagship, main path", (S * T, R, K, 1), {}, True),
        ("ragged N=1001 R=130 K=1000 Km=3", (1001, 130, 1000, 3), {}, False),
        ("large bias 200, half the rows masked", (70, 64, 300, 2),
         {"bias_scale": 200.0, "mask_p": 0.5}, False),
        ("argmax tie at classes 63/64", (40, 16, 200, 1), {"tie_at": 63},
         False),
        (f"argmax tie at classes {FWD_CHUNK - 1}/{FWD_CHUNK} (K3 chunk "
         f"edge)", (40, 16, 2 * FWD_CHUNK + 100, 1),
         {"tie_at": FWD_CHUNK - 1}, False),
        ("ragged N=1001 R=136 K=1003 Km=2 (off every tile, K % 4 != 0)",
         (1001, 136, 1003, 2), {}, False),
        ("deep config K=16624", (S * T, R, DEEP_K, 1), {}, "deep"),
    ]
    for i, (name, dims, extra, timed) in enumerate(xent_cases):
        w, rec = xent_case(name, *dims, 60 + i, timed=bool(timed), **extra)
        worst["K3"] = worst["K4"] = max(worst["K3"], w)
        if rec and timed is True:
            recs.update(rec)
    for k in recs:
        recs[k]["max_abs_err"] = worst[k]
    return recs


def stack_case(S, T, I, C, R, seed, param_scale=0.04, x_scale=1.0,
               device="cuda"):
    """Two stack-compatible layers, x [T, S, I] and nonzero initial
    states of both, from one seed."""
    import torch
    from kaldi_lstm_tpu_torch.ops.lstm_cell import (
        LstmState,
        init_lstm_params,
    )
    g = torch.Generator().manual_seed(seed)
    p1 = init_lstm_params(g, I, C, R, param_scale, device=device)
    p2 = init_lstm_params(g, R, C, R, param_scale, device=device)
    rng = np.random.RandomState(seed)
    x = torch.tensor(rng.randn(T, S, I).astype(np.float32) * x_scale,
                     device=device)
    st = [torch.tensor(rng.randn(S, d).astype(np.float32) * 0.5,
                       device=device) for d in (C, R, C, R)]
    return p1, p2, x, LstmState(st[0], st[1]), LstmState(st[2], st[3])


def stack_bound(T, S, I, C, R, train: bool):
    """Least time of K6 (train) or K7: both layers' f32 operations, and
    each input read once and each output written once (K6: both layers'
    residuals; K7: r2 and the final c1, r1, c2)."""
    ops = 2.0 * T * S * ((4 * C * (I + R) + C * R) + (4 * C * 2 * R + C * R))
    n_in = (T * S * I + (I + R) * 4 * C + 2 * R * 4 * C
            + 2 * (7 * C + C * R) + 2 * S * (C + R))
    n_out = 2 * T * S * (4 * C + C + R) if train \
        else T * S * R + S * (2 * C + R)
    return bound_ms(ops, 4.0 * (n_in + n_out))


def phase_stack_kernels():
    """K6/K7 vs plain on the card, K6's residuals through K2, timings,
    then the bench with the K6/K7 counts. Returns {"K6": record,
    "K7": record, "launches": {...}}."""
    import torch
    from kaldi_lstm_tpu_torch.ops import lstm_infer as li
    from kaldi_lstm_tpu_torch.ops import lstm_stack as ls
    from kaldi_lstm_tpu_torch.ops import lstm_train as lt
    from kaldi_lstm_tpu_torch.tools import bench_wavefront as bw

    worst = {"K6": 0.0, "K7": 0.0}
    recs = {}
    cases = [
        # name, (S, T, I, C, R), time blocks, clip, extra, kernels
        ("deep, full width", (512, 20, 40, 800, 512), (5, 4, 2, 1), 50.0,
         {}, "K6 K7"),
        ("ragged S=3 I=37 C=200 R=130 T=23, clip active",
         (3, 23, 37, 200, 130), (1,), 1.0,
         {"x_scale": 20.0, "param_scale": 0.2}, "K6 K7"),
        ("serving S=8 T=1000", (8, 1000, 40, 800, 512), (5,), 50.0, {},
         "K7"),
    ]
    for i, (name, dims, tbs, clip, extra, which) in enumerate(cases):
        args = stack_case(*dims, seed=70 + i, **extra)
        log(f"  [{name}] S={dims[0]} T={dims[1]} I={dims[2]} C={dims[3]} "
            f"R={dims[4]} clip {clip:g} tb {tbs}")
        want_f = ls.lstm_stack_fwd2_plain(*args, clip) if "K6" in which \
            else None
        want_i = ls.lstm_stack_infer2_plain(*args, clip)
        if clip < 10 and not bool((want_f[1].abs() == clip).any()):
            fail(f"{name}: the clip never engaged")
        for tb in tbs:
            if want_f is not None:
                got = ls.lstm_stack_fwd2_cuda(*args, clip, tb=tb)
                torch.cuda.synchronize()
                for what, a, b in zip(("gifo1", "c1", "r1", "gifo2", "c2",
                                       "r2"), got, want_f):
                    worst["K6"] = compare(f"K6 tb{tb} {what}", a, b,
                                          worst["K6"])
            r2, f1, f2 = ls.lstm_stack_infer2_cuda(*args, clip, tb=tb)
            torch.cuda.synchronize()
            for what, a, b in (("r2", r2, want_i[0]),
                               ("c1T", f1.c, want_i[1].c),
                               ("r1T", f1.r, want_i[1].r),
                               ("c2T", f2.c, want_i[2].c),
                               ("r2T", f2.r, want_i[2].r)):
                worst["K7"] = compare(f"K7 tb{tb} {what}", a, b,
                                      worst["K7"])
        if i == 0:
            worst["K6"] = stack_residuals_through_k2(args, clip,
                                                     worst["K6"])
        T, S = dims[1], dims[0]
        p1, p2, x, s1, s2 = args
        tb = ls.time_block(T)
        timings = []
        if "K6" in which:
            timings.append((
                "K6", lambda: ls.lstm_stack_fwd2_cuda(*args, clip, tb=tb),
                lambda: ls.lstm_stack_fwd2_plain(*args, clip),
                lambda: lt.lstm_fwd_residuals_cuda(
                    p2, lt.lstm_fwd_residuals_cuda(
                        p1, x, s1.c, s1.r, cell_clip=clip)[2],
                    s2.c, s2.r, cell_clip=clip),
                "K1 x 2", stack_bound(T, S, *dims[2:], True)))
        timings.append((
            "K7", lambda: ls.lstm_stack_infer2_cuda(*args, clip, tb=tb),
            lambda: ls.lstm_stack_infer2_plain(*args, clip),
            lambda: li.lstm_infer(p2, li.lstm_infer(
                p1, x, s1, clip, time_major=True)[0], s2, clip,
                time_major=True),
            "K5 x 2", stack_bound(T, S, *dims[2:], False)))
        if i == 1:
            continue
        for key, kfn, pfn, sfn, serial, bnd in timings:
            with torch.inference_mode():
                k_ms = cuda_ms(kfn)
                p_ms = cuda_ms(pfn, reps=3)
                s_ms = cuda_ms(sfn)
            log(f"  [{name}] {key} tb{tb}: kernel {k_ms:.3f} ms, plain "
                f"{p_ms:.3f} ms, serial two-kernel schedule ({serial}) "
                f"{s_ms:.3f} ms, bound {bnd[0]:.4f} ms ({bnd[1]}); "
                f"library: n/a (no single PyTorch call computes a stacked "
                f"LSTMP with peepholes and the clip)")
            log(f"  [{name}] {key} vs {serial}: the serial schedule takes "
                f"{s_ms / k_ms:.3f}x the wavefront kernel's time")
            if i == 0:
                recs[key] = {"ms": k_ms, "plain_ms": p_ms,
                             "bound_ms": bnd[0], "bound_by": bnd[1],
                             "serial_ms": s_ms}
    for k in recs:
        recs[k]["max_abs_err"] = worst[k]

    G, reps = 8, 3
    calls = bw.calls_per_bench(G, reps)
    predicted = {
        "lstmp_stack_fwd2": calls * sum(ls.wavefront_launches(bw.T, tb)
                                        for tb in bw.FWD_TBS),
        "lstmp_stack_infer2": calls * sum(ls.wavefront_launches(bw.T, tb)
                                          for tb in bw.INFER_TBS),
        "lstmp_train_fwd": calls * 2 * 2 * bw.T,
        "lstmp_infer": calls * 2}
    for m in (ls, lt, li):
        m.reset_counts()
    torch.cuda.synchronize()
    rc = bw.main(["512", str(G), str(reps), "ab"])
    torch.cuda.synchronize()
    launches = {"lstmp_stack_fwd2": ls.FWD2_LAUNCHES,
                "lstmp_stack_infer2": ls.INFER2_LAUNCHES,
                "lstmp_train_fwd": lt.FWD_LAUNCHES,
                "lstmp_infer": li.LAUNCHES}
    plain = (ls.PLAIN_CALLS, lt.PLAIN_CALLS, li.PLAIN_CALLS)
    if rc != 0:
        fail(f"bench_wavefront exited {rc}")
    for k in predicted:
        log(f"    bench {k}: launches {launches[k]} (predicted "
            f"{predicted[k]})")
    log(f"    plain-version calls (lstm_stack, lstm_train, lstm_infer): "
        f"{plain}")
    if launches != predicted:
        fail("the bench did not launch K6/K7 (and K1/K5) as predicted")
    if plain != (0, 0, 0):
        fail("the bench took a plain version on the card")
    recs["launches"] = launches
    for mode in ("ablate", "profile"):
        if bw.main(["512", str(G), str(reps), mode]) != 0:
            fail(f"bench_wavefront {mode} failed")
    return recs


def stack_residuals_through_k2(args, clip, worst):
    """K6's residuals of each layer through K2 against K1's residuals of
    the same layer through K2 (layer 2 with dx, its x being r1)."""
    import torch
    from kaldi_lstm_tpu_torch.ops import lstm_stack as ls
    from kaldi_lstm_tpu_torch.ops import lstm_train as lt
    p1, p2, x, s1, s2 = args
    T, S = x.shape[:2]
    rng = np.random.RandomState(80)
    g_r = torch.tensor(rng.randn(T, S, p1.recur_dim).astype(np.float32),
                       device="cuda")
    gcT = torch.tensor(rng.randn(S, p1.cell_dim).astype(np.float32),
                       device="cuda")
    wave = ls.lstm_stack_fwd2_cuda(*args, clip, tb=5)
    k1a = lt.lstm_fwd_residuals_cuda(p1, x, s1.c, s1.r, cell_clip=clip)
    k1b = lt.lstm_fwd_residuals_cuda(p2, k1a[2], s2.c, s2.r, cell_clip=clip)
    log("    K6 residuals through K2 vs K1 residuals through K2:")
    for n, p, xw, xk, s, res_w, res_k, dx in (
            (1, p1, x, x, s1, wave[:3], k1a, False),
            (2, p2, wave[2], k1a[2], s2, wave[3:], k1b, True)):
        a = lt.lstm_bwd_cuda(p, xw, s.c, s.r, *res_w, None, 1.0, g_r, gcT,
                             dx)
        b = lt.lstm_bwd_cuda(p, xk, s.c, s.r, *res_k, None, 1.0, g_r, gcT,
                             dx)
        torch.cuda.synchronize()
        for f, u, v in zip(type(p)._fields, a[0], b[0]):
            worst = compare(f"layer {n} d{f}", u, v, worst)
        for f, u, v in zip(("dx", "dc0", "dr0"), a[1:], b[1:]):
            if v is not None:
                worst = compare(f"layer {n} {f}", u, v, worst)
    return worst


def write_train_corpus(work: str, label_stride: int = 200):
    """256 utterances of 100-300 frames x 40 dims (numpy seed 7) and
    1-best posteriors that depend on the frame (the index of its largest
    feature, times `label_stride`: classes below 8000 at 200, below 16624
    at 415), so one epoch can learn."""
    from kaldi_lstm_tpu_torch.io import kaldi_io as kio
    rng = np.random.RandomState(7)
    feats = f"ark:{work}/train_feats.ark"
    post = f"ark:{work}/train_post.ark"
    with kio.MatrixWriter(feats) as fw, kio.PosteriorWriter(post) as pw:
        for i in range(256):
            x = rng.randn(int(rng.randint(100, 301)), 40).astype(np.float32)
            fw.write(f"utt{i:03d}", x)
            pw.write(f"utt{i:03d}",
                     [[(int(k) * label_stride, 1.0)] for k in x.argmax(1)])
    return feats, post


def phase_train(work: str):
    """The training main path; returns the K1-K4 launch counts."""
    import torch
    from kaldi_lstm_tpu_torch.io import kaldi_io as kio
    from kaldi_lstm_tpu_torch.models import Nnet
    from kaldi_lstm_tpu_torch.ops.lstm_train import bwd_launches
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

    cvs = []
    for _ in range(2):
        rc, cv = train_lstm_streams.run_main(
            [feats, post, model_in, "--cross-validate=true"] + common)
        if rc != 0:
            fail(f"cross-validation before training exited {rc}")
        cvs.append(cv)
    cv0 = cvs[0]
    log(f"  cross-validation twice on one model: AvgLoss "
        f"{cvs[0].avg_loss()!r} and {cvs[1].avg_loss()!r}")
    if cvs[0].avg_loss() != cvs[1].avg_loss():
        fail("two cross-validation runs of one model disagree (the kernels "
             "must sum in a fixed order)")

    sched = StreamScheduler(kio.SequentialMatrixReader(feats),
                            kio.RandomAccessPosteriorReader(post), 40,
                            TRAIN_S, TRAIN_T, 0)
    batches = list(sched)
    steps = len(batches)
    T = TRAIN_T
    predicted = {"lstmp_train_fwd": 2 * T * steps,
                 "lstmp_train_bwd": bwd_launches(T, False) * steps,
                 "xent_affine_fwd": 2 * steps,
                 "xent_affine_bwd": 3 * steps}

    res = {}

    def train():
        rc, res["stats"] = train_lstm_streams.run_main(
            [feats, post, model_in, model_out, f"--learn-rate={TRAIN_LR}",
             "--momentum=0.9"] + common)
        return rc

    launches, wall = counted(
        f"train_lstm_streams, {steps} steps of {TRAIN_S}x{T} (incl. model "
        f"read, ark I/O, CUDA warm-up)", predicted, train)
    stats = res["stats"]
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


def counts_now() -> dict:
    import kaldi_lstm_tpu_torch.ops.lstm_infer as li
    import kaldi_lstm_tpu_torch.ops.lstm_train as lt
    import kaldi_lstm_tpu_torch.ops.xent_affine as xa
    return {"lstmp_train_fwd": lt.FWD_LAUNCHES,
            "lstmp_train_bwd": lt.BWD_LAUNCHES,
            "xent_affine_fwd": xa.FWD_LAUNCHES,
            "xent_affine_bwd": xa.BWD_LAUNCHES,
            "lstmp_infer": li.LAUNCHES}


def reset_all_counts() -> tuple:
    """Zero every kernel count; returns the plain-call counters' reader."""
    import kaldi_lstm_tpu_torch.ops.lstm_infer as li
    import kaldi_lstm_tpu_torch.ops.lstm_stack as ls
    import kaldi_lstm_tpu_torch.ops.lstm_train as lt
    import kaldi_lstm_tpu_torch.ops.xent_affine as xa
    for m in (li, ls, lt, xa):
        m.reset_counts()
    return lambda: (lt.PLAIN_CALLS, xa.PLAIN_CALLS, li.PLAIN_CALLS,
                    ls.PLAIN_CALLS)


def recipe_prediction(layers: int, steps: int) -> dict:
    """Launches of one newbob iteration from a fresh directory: a CV
    epoch, a training epoch and a CV epoch of `steps` steps each.
    Training step: K1 2T per layer, K2 `bwd_launches` per layer (with dx
    on every layer above the first), K3 2, K4 3; CV step: K5 1 per
    layer, K3 2."""
    from kaldi_lstm_tpu_torch.ops.lstm_train import bwd_launches
    T = TRAIN_T
    return {"lstmp_train_fwd": 2 * T * layers * steps,
            "lstmp_train_bwd": sum(bwd_launches(T, layer > 0)
                                   for layer in range(layers)) * steps,
            "xent_affine_fwd": 3 * 2 * steps,
            "xent_affine_bwd": 3 * steps,
            "lstmp_infer": 2 * layers * steps}


def counted(what: str, predicted: dict, fn) -> tuple[dict, float]:
    """Run fn() (it returns an exit code) with every kernel count zeroed
    just before and read just after; fail unless each predicted count
    is positive and met and no plain version ran. Returns (the counts,
    the wall seconds)."""
    import torch
    plain = reset_all_counts()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    rc = fn()
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    got = counts_now()
    if rc != 0:
        fail(f"{what} exited {rc}")
    log(f"  {what}: rc 0 in {wall:.3f} s")
    for k in predicted:
        log(f"    {k}: launches {got[k]} (predicted {predicted[k]})")
    log(f"    plain-version calls (lstm_train, xent_affine, lstm_infer, "
        f"lstm_stack): {plain()}")
    if any(got[k] != predicted[k] or got[k] <= 0 for k in predicted):
        fail(f"{what} did not launch the kernels as predicted")
    if plain() != (0, 0, 0, 0):
        fail(f"{what} took a plain version on the card")
    return got, wall


def phase_deep(work: str):
    """The deep path through the layer-stacking recipe, at full width."""
    import contextlib
    import io
    import json as _json
    import torch
    from kaldi_lstm_tpu_torch.decode.scoring import (
        AmScorer,
        log_priors_from_counts,
    )
    from kaldi_lstm_tpu_torch.io import kaldi_io as kio
    from kaldi_lstm_tpu_torch.models import Nnet
    from kaldi_lstm_tpu_torch.tools import (
        nnet_copy,
        nnet_edit,
        nnet_forward,
        nnet_info,
        run_recipe,
        train_lstm_streams,
    )
    from kaldi_lstm_tpu_torch.train.optim import init_momentum
    from kaldi_lstm_tpu_torch.train.streams import StreamScheduler
    from kaldi_lstm_tpu_torch.train.trainer import (
        TrainOptions,
        make_train_step,
        place_batch,
    )
    from kaldi_lstm_tpu_torch.utils.tree import tree_leaves

    feats, post = write_train_corpus(work, label_stride=415)
    proto = os.path.join(work, "pre.proto")
    with open(proto, "w") as f:
        f.write(DEEP_PRE_PROTO)
    pre, stack, exp = (os.path.join(work, d) for d in ("pre", "stack", "exp"))
    common = ["--tr-feats", feats, "--tr-targets", post, "--cv-feats", feats,
              "--cv-targets", post, "--scheduler", "newbob",
              f"--learn-rate={TRAIN_LR}", "--momentum=0.9", "--max-iters=1",
              f"--num-stream={TRAIN_S}", f"--batch-size={TRAIN_T}",
              "--targets-delay=0", "--verbose=0", "--device=cuda"]

    def batches(S):
        return list(StreamScheduler(kio.SequentialMatrixReader(feats),
                                    kio.RandomAccessPosteriorReader(post),
                                    40, S, TRAIN_T, 0))
    steps = len(batches(TRAIN_S))
    log(f"  corpus: 256 utterances, {steps} steps of {TRAIN_S}x{TRAIN_T} "
        f"per epoch, targets in [0, {DEEP_K})")

    # 1. the one-layer net
    counted("run_recipe (one-layer net, 1 newbob iteration)",
            recipe_prediction(1, steps),
            lambda: run_recipe.main(common + ["--dir", pre, "--proto", proto,
                                              "--min-iters=1"]))
    # 2. stack a fresh LSTMP-2 and senone affine on the frozen trunk
    os.makedirs(stack)
    if nnet_edit.main([f"{pre}/final.nnet", f"{stack}/nnet.init",
                       "--remove-at", "2", "--insert-at", "2",
                       "--proto-line", DEEP_STACK_LINES,
                       "--set-learn-rate-coef", "1=0"]) != 0:
        fail("nnet_edit (stack) failed")
    counted("run_recipe (stacked net, frozen trunk)",
            recipe_prediction(2, steps),
            lambda: run_recipe.main(common + ["--dir", stack,
                                              "--min-iters=1"]))
    _, p0 = Nnet.read(f"{stack}/nnet.init")
    _, p1 = Nnet.read(f"{stack}/nnet/nnet.iter1")
    frozen = all(torch.equal(a, b) for a, b in zip(p0[1], p1[1]))
    moved = sum(not torch.equal(a, b) for a, b in zip(p0[2], p1[2]))
    log(f"  frozen trunk (LearnRateCoef 0) bit-identical after the "
        f"iteration: {frozen}; new LSTMP-2 tensors changed: {moved} of 7")
    if not frozen or moved == 0:
        fail("the frozen trunk changed, or the new layer did not train")
    # 3. unfreeze and fine-tune the whole stack
    os.makedirs(exp)
    if nnet_edit.main([f"{stack}/final.nnet", f"{exp}/nnet.init",
                       "--set-learn-rate-coef", "1=1"]) != 0:
        fail("nnet_edit (unfreeze) failed")
    rc, cv0 = train_lstm_streams.run_main(
        [feats, post, f"{exp}/nnet.init", "--cross-validate=true",
         f"--num-stream={TRAIN_S}", f"--batch-size={TRAIN_T}",
         "--targets-delay=0", "--device=cuda"])
    if rc != 0:
        fail("cross-validation before the fine-tune failed")
    counted("run_recipe (fine-tune of the whole stack)",
            recipe_prediction(2, steps),
            lambda: run_recipe.main(common + ["--dir", exp]))
    with open(f"{exp}/nnet/newbob.state") as f:
        st = _json.load(f)
    log(f"  fine-tune CV AvgLoss: before {cv0.avg_loss():.6f}, after "
        f"{st['loss']:.6f} ({os.path.basename(st['final'])} accepted)")
    if not (st["final"].endswith("nnet.iter1")
            and st["loss"] < cv0.avg_loss()):
        fail("cross-validation AvgLoss did not fall in the fine-tune")
    # 4. nnet_info
    buf = io.StringIO()
    with contextlib.redirect_stdout(buf):
        rc = nnet_info.main([f"{exp}/final.nnet"])
    info = buf.getvalue()
    if rc != 0 or info.count("LstmProjectedStreams") != 2:
        fail("nnet_info did not print the deep net")
    for line in info.splitlines():
        if not line.startswith("  "):
            log(f"    {line}")
    # 5. convert and score with class counts
    std = os.path.join(work, "deep_std.nnet")
    if nnet_copy.main([f"{exp}/final.nnet", std, "--to-standard",
                       "--time-shift=5", "--device", "cuda"]) != 0:
        fail("nnet_copy --to-standard failed")
    rng = np.random.RandomState(9)
    utts = {f"utt{i:03d}": rng.randn(int(rng.randint(200, 1001)), 40)
            .astype(np.float32) for i in range(8)}
    feats_ark = os.path.join(work, "deep_feats.ark")
    with kio.MatrixWriter(f"ark:{feats_ark}") as w:
        for k, m in utts.items():
            w.write(k, m)
    counts = rng.randint(1, 1000, size=DEEP_K).astype(np.float32)
    counts_path = os.path.join(work, "deep_counts.vec")
    with open(counts_path, "wb") as f:
        kio.write_vector(kio.KaldiOutput(f), counts)
    out_ark = os.path.join(work, "deep_loglik.ark")
    counted("nnet_forward (deep standard net, 1 batch of 8: one K5 launch "
            "per layer)", {"lstmp_infer": 2},
            lambda: nnet_forward.main(
                [std, f"ark:{feats_ark}", f"ark:{out_ark}",
                 "--apply-log=true", "--class-frame-counts", counts_path,
                 "--device", "cuda"]))
    got = dict(kio.SequentialMatrixReader(f"ark:{out_ark}"))
    if list(got) != list(utts):
        fail("deep scoring: output keys differ")
    for k, y in got.items():
        if y.shape != (utts[k].shape[0], DEEP_K) or not np.isfinite(y).all():
            fail(f"deep scoring: {k} has shape {y.shape} or non-finite "
                 f"values")
    lp = log_priors_from_counts(counts)
    nnet_c, params_c = Nnet.read(std, "cpu")
    cpu = AmScorer(nnet_c, params_c, log_prior=lp, apply_log=True,
                   device="cpu")
    keys = list(utts)[:3]
    worst = max(float(np.abs(got[k] - y).max())
                for k, y in cpu.score_stream((k, utts[k]) for k in keys))
    log(f"  deep scores, card vs CPU path on 3 utterances: max_abs_err "
        f"{worst:.3e} (tol {SCORE_ATOL:g})")
    if worst > SCORE_ATOL:
        fail("deep card scores disagree with the CPU path")
    nnet_g, params_g = Nnet.read(std, "cuda")
    scorer = AmScorer(nnet_g, params_g, log_prior=lp, apply_log=True,
                      device="cuda")
    frames = sum(m.shape[0] for m in utts.values())
    for _ in scorer.score_stream(utts.items()):
        pass
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    n = sum(1 for _ in scorer.score_stream(utts.items()))
    torch.cuda.synchronize()
    dt = time.perf_counter() - t0
    log(f"  steady deep scoring: {n} utterances, {frames} frames in "
        f"{dt:.3f} s -> {frames / dt:.1f} frames/s, "
        f"{frames / FRAMES_PER_AUDIO_SECOND / dt:.2f} audio-s/s")

    # 6. one deep step on the card against the same step on the CPU path
    opts = TrainOptions(learn_rate=TRAIN_LR, momentum=0.9)
    b0 = batches(DEEP_CHECK_S)[0]
    res = {}
    for dev in ("cuda", "cpu"):
        nnet_d, params_d = Nnet.read(f"{exp}/nnet.init", dev)
        step = make_train_step(nnet_d, opts, device=dev)
        params_d, _, _, aux = step(
            params_d, init_momentum(params_d),
            nnet_d.init_states(DEEP_CHECK_S, dev), (),
            *place_batch(b0, dev), torch.tensor(TRAIN_LR, device=dev))
        res[dev] = (tree_leaves(params_d), [float(a) for a in aux])
    worst = 0.0
    for a, b in zip(res["cuda"][0], res["cpu"][0]):
        d = (a.cpu() - b).abs()
        worst = max(worst, float(d.max()))
        if not bool((d <= STEP_ATOL + STEP_RTOL * b.abs()).all()):
            fail("the deep step on the card disagrees with the CPU path")
    (xk, ek, ck, fk), (xc, ec, cc, fc) = res["cuda"][1], res["cpu"][1]
    if not (abs(xk - xc) <= 1e-5 * abs(xc) and abs(ek - ec) <= 1e-5 * abs(ec)
            and fk == fc and abs(ck - cc) <= 2):
        fail(f"deep LossAux on the card {res['cuda'][1]} vs CPU "
             f"{res['cpu'][1]}")
    log(f"  one deep step ({DEEP_CHECK_S} streams) card vs CPU path: "
        f"params max_abs_err {worst:.3e} (tol {STEP_ATOL:g} + "
        f"{STEP_RTOL:g} x |p|); LossAux card {res['cuda'][1]} vs CPU "
        f"{res['cpu'][1]}")

    # 7. the warm deep step at S=256, and its profile
    nnet_g, params_g = Nnet.read(f"{exp}/nnet.init", "cuda")
    step = make_train_step(nnet_g, opts, device="cuda")
    opt, states = init_momentum(params_g), nnet_g.init_states(TRAIN_S, "cuda")
    lr = torch.tensor(TRAIN_LR, device="cuda")
    placed = [place_batch(b, "cuda") for b in batches(TRAIN_S)[:6]]

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
    log(f"  steady deep training step: {1e3 * dt:.3f} ms per step of "
        f"{TRAIN_S}x{TRAIN_T} -> {TRAIN_S * TRAIN_T / dt:.1f} frames/s "
        f"({TRAIN_S * TRAIN_T / FRAMES_PER_AUDIO_SECOND / dt:.2f} "
        f"audio-s/s) with every slot counted")
    profile(lambda: run_steps(placed[:1]), "one deep training step")


def phase_main_path(work: str):
    import torch
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
    keys = list(utts)
    # one K5 launch per batch of 8 utterances
    expected = -(-len(keys) // 8)
    got, _ = counted("nnet_forward (incl. model read, CUDA warm-up and ark "
                     "I/O)", {"lstmp_infer": expected},
                     lambda: nnet_forward.main(argv))
    launches = got["lstmp_infer"]

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

    log("phase 3c: K6/K7 (wavefront two-layer stack) vs their plain "
        "versions, and the wavefront bench")
    stack_recs = phase_stack_kernels()

    log("phase 4: serving path (nnet_forward, full-width standard net)")
    with tempfile.TemporaryDirectory(prefix="klt_chip_smoke_") as work:
        launches = phase_main_path(work)

    log("phase 5: training path (train_lstm_streams, full-width flagship)")
    with tempfile.TemporaryDirectory(prefix="klt_chip_smoke_") as work:
        train_launches = phase_train(work)

    log("phase 6: deep path (2 x LSTMP -> 16624) through the layer-stacking "
        "recipe, full width")
    with tempfile.TemporaryDirectory(prefix="klt_chip_smoke_") as work:
        phase_deep(work)

    kernels = [{
        "name": "lstmp_infer", "route": "cuda",
        "source": "kaldi_lstm_tpu_torch/csrc/lstmp_infer.cu",
        "replaces": "kaldi_lstm_tpu/ops/lstm_pallas.py:243 (_infer_kernel)",
        "launches": launches, "max_abs_err": rec["max_abs_err"],
        "ms": rec["ms"], "kernel_ms": rec["ms"],
        "plain_ms": rec["plain_ms"], "bound_ms": rec["bound_ms"],
        "bound_by": rec["bound_by"], "library_ms": None,
        **{k: rec[k] for k in ("us_per_step_s8", "cv_ms", "cv_plain_ms",
                               "cv_bound_ms")},
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
            "bound_by": r["bound_by"], "library_ms": None,
            **{k: r[k] for k in ("bound_f32_simt_ms", "bound_3xtf32_ms",
                                 "cublas_products_ms") if k in r}})
    for key, name, replaces in (
            ("K6", "lstmp_stack_fwd2",
             "kaldi_lstm_tpu/ops/lstm_stack_pallas.py:70 (_fwd2_kernel)"),
            ("K7", "lstmp_stack_infer2",
             "kaldi_lstm_tpu/ops/lstm_stack_pallas.py:247 (_infer2_kernel)")):
        r = stack_recs[key]
        kernels.append({
            "name": name, "route": "cuda",
            "source": "kaldi_lstm_tpu_torch/csrc/lstmp_stack.cu",
            "replaces": replaces,
            "launches": stack_recs["launches"][name],
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
