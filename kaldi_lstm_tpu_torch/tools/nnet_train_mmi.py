"""Lattice-free MMI sequence trainer, PyTorch edition of
``kaldi_lstm_tpu.tools.nnet_train_mmi`` (the nnet1 sequence-training
stage the reference's standard variant advertises compatibility with,
standard/README.md). The denominator is the exact phone-loop forward
over the transition model (train/sequence.py), the numerator the forced
alignment (transition-ids), so no lattice dumps are needed.

    python -m kaldi_lstm_tpu_torch.tools.nnet_train_mmi [options] \\
        <feature-rspecifier> <ali-rspecifier> <final.mdl> \\
        <model-in> [<model-out>]

Same arguments and log lines as the JAX tool, plus ``--device``
(default cuda; exits 1 when CUDA is missing; ``--device cpu`` runs the
plain PyTorch path). Each utterance is one [1, T] batch, T its length
rounded up to a multiple of --length-bucket by repeating the last frame
(mask 0 there). On the card a training step runs K1/K2 for the LSTM
layer (no dx: the features need no gradient) and plain torch ops for
the affine, the log-softmax and the den-graph recursion;
``--cross-validate=true`` runs the forward only (K5).
"""

from __future__ import annotations

import argparse
import io
import sys

import numpy as np
import torch

from kaldi_lstm_tpu_torch.decode.scoring import read_class_frame_counts
from kaldi_lstm_tpu_torch.io.kaldi_io import (
    SequentialMatrixReader,
    _open_rspecifier,
    _read_key,
    _read_value_header,
    read_int_vector,
)
from kaldi_lstm_tpu_torch.io.transition_model import TransitionModel
from kaldi_lstm_tpu_torch.models import Nnet
from kaldi_lstm_tpu_torch.train.optim import init_momentum, momentum_update
from kaldi_lstm_tpu_torch.train.sequence import (
    alignment_to_states,
    den_graph_for,
    mmi_objective,
)
from kaldi_lstm_tpu_torch.train.trainer import place_arrays
from kaldi_lstm_tpu_torch.utils import (
    LOG,
    WARN,
    Timer,
    device_from_arg,
    set_verbose_level,
)
from kaldi_lstm_tpu_torch.utils.tree import (
    tree_leaves,
    tree_map,
    tree_unflatten,
)

TOOL = "nnet-train-mmi"


def _bool(s):
    return str(s).lower() in ("true", "1", "yes")


def _read_alignments(rspecifier) -> dict[str, np.ndarray]:
    kind, stream = _open_rspecifier(rspecifier)
    if kind != "ark":
        raise ValueError("nnet_train_mmi: only ark: alignments supported")
    buffered = stream if isinstance(stream, io.BufferedReader) \
        else io.BufferedReader(stream)
    out = {}
    while True:
        key = _read_key(buffered)
        if key is None:
            break
        out[key] = read_int_vector(_read_value_header(buffered))
    return out


def read_log_prior(path: str, device) -> torch.Tensor | None:
    """log(counts / sum) floored at 1e-10, the JAX tools' prior, on
    `device`; None without --class-frame-counts."""
    if not path:
        return None
    counts = read_class_frame_counts(path)
    priors = counts / max(counts.sum(), 1.0)
    return torch.tensor(np.log(np.maximum(priors, 1e-10)),
                        dtype=torch.float32, device=device)


def add_device_arg(p: argparse.ArgumentParser) -> None:
    p.add_argument("--device", default="cuda",
                   help="cuda (default; exit 1 without CUDA) or cpu (the "
                        "plain PyTorch path)")


def pad_frames(feats: np.ndarray, bucket: int) -> np.ndarray:
    """[L, D] features as [1, T, D], T = L rounded up to a multiple of
    `bucket`, the last frame repeated as padding."""
    L = feats.shape[0]
    T = -(-L // bucket) * bucket
    f = np.zeros((1, T, feats.shape[1]), np.float32)
    f[0, :L] = feats
    if L:
        f[0, L:] = feats[-1]
    return f


def pad_utterance(feats: np.ndarray, path: np.ndarray,
                  bucket: int) -> tuple[np.ndarray, ...]:
    """One utterance as a [1, T] batch (`pad_frames`), the per-frame
    targets 0 and the mask 0 on the padding."""
    L = feats.shape[0]
    f = pad_frames(feats, bucket)
    T = f.shape[1]
    tgt = np.zeros((1, T), np.int32)
    tgt[0, :L] = path
    mask = np.zeros((1, T), np.float32)
    mask[0, :L] = 1.0
    return f, tgt, mask


def make_sequence_step(nnet: Nnet, transf: Nnet | None, transf_params,
                       log_prior: torch.Tensor | None, objective,
                       crossvalidate: bool):
    """step(params, feats, targets, mask) -> (obj, stat, grads): the
    network's log-likelihoods (log-softmax of the logits, minus the
    log-prior when one is given; the feature transform outside the
    gradient), `objective(loglik, targets, mask)` and the parameter
    gradients of its first output (None when cross-validating, where the
    forward runs without autograd)."""

    def loglik_of(params, x):
        logits, _ = nnet.propagate(
            params, x, nnet.init_states(x.shape[0], x.device), logits=True)
        ll = torch.log_softmax(logits, dim=-1)
        return ll if log_prior is None else ll - log_prior

    def step(params, feats, targets, mask):
        x = feats
        if transf is not None:
            with torch.no_grad():
                x = transf.feedforward(transf_params, x)
        if crossvalidate:
            with torch.no_grad():
                obj, stat = objective(loglik_of(params, x), targets, mask)
            return obj, stat, None
        live = tree_map(lambda t: t.detach().requires_grad_(True), params)
        with torch.enable_grad():
            obj, stat = objective(loglik_of(live, x), targets, mask)
            flat = tree_leaves(live)
            flat_g = torch.autograd.grad(obj, flat, allow_unused=True)
        grads = tree_unflatten(params, [
            torch.zeros_like(p) if g is None else g
            for p, g in zip(flat, flat_g)])
        return obj.detach(), stat, grads

    return step


def build_parser() -> argparse.ArgumentParser:
    p = argparse.ArgumentParser(
        description="One iteration of lattice-free MMI sequence training")
    p.add_argument("feature_rspecifier")
    p.add_argument("ali_rspecifier",
                   help="numerator alignments (transition-ids)")
    p.add_argument("transition_model")
    p.add_argument("model_in")
    p.add_argument("model_out", nargs="?", default=None)
    p.add_argument("--binary", default="true")
    p.add_argument("--cross-validate", default="false")
    p.add_argument("--feature-transform", default="")
    p.add_argument("--learn-rate", type=float, default=1e-5)
    p.add_argument("--momentum", type=float, default=0.0)
    p.add_argument("--acoustic-scale", type=float, default=0.1)
    p.add_argument("--class-frame-counts", default="",
                   help="When set, train on log-likelihoods (log-posterior"
                        " minus log-prior) instead of log-posteriors")
    p.add_argument("--length-bucket", type=int, default=128)
    p.add_argument("--verbose", type=int, default=0)
    add_device_arg(p)
    return p


def main(argv=None) -> int:
    args = build_parser().parse_args(argv)
    set_verbose_level(args.verbose)
    crossvalidate = _bool(args.cross_validate)
    if not crossvalidate and args.model_out is None:
        print("error: <model-out> required unless --cross-validate=true",
              file=sys.stderr)
        return 1
    device = device_from_arg(args.device, TOOL)
    if device is None:
        return 1

    tm = TransitionModel.load(args.transition_model)
    # structured O(Ns) phone loop / dense DenGraph / per-arc
    # SplitDenGraph, picked by den_graph_for (train/sequence.py)
    graph = den_graph_for(tm, device=device)

    transf = transf_params = None
    if args.feature_transform:
        transf, transf_params = Nnet.read(args.feature_transform, device)
    nnet, params = Nnet.read(args.model_in, device)
    log_prior = read_log_prior(args.class_frame_counts, device)
    ac_scale = float(args.acoustic_scale)
    step = make_sequence_step(
        nnet, transf, transf_params, log_prior,
        lambda ll, states, mask: mmi_objective(graph, ll, states, mask,
                                               ac_scale), crossvalidate)

    alis = _read_alignments(args.ali_rspecifier)
    opt_state = init_momentum(params)
    lr = torch.tensor(args.learn_rate, dtype=torch.float32, device=device)
    timer = Timer()
    num_done = num_no_ali = num_err = 0
    total_frames = 0
    total_obj = 0.0
    bucket = max(args.length_bucket, 1)

    for key, feats in SequentialMatrixReader(args.feature_rspecifier):
        if key not in alis:
            WARN(f"{key}, missing alignment")
            num_no_ali += 1
            continue
        tids = alis[key]
        L = feats.shape[0]
        if L != len(tids):
            WARN(f"{key}, length miss-match between feats and alignment")
            num_err += 1
            continue
        if L == 0:
            WARN(f"{key}, zero-length utterance, skip")
            num_err += 1
            continue
        batch = place_arrays(
            pad_utterance(feats, alignment_to_states(tm, tids), bucket),
            device)
        obj, _, grads = step(params, *batch)
        if grads is not None:
            momentum_update(params, grads, opt_state, lr, args.momentum, 0.0)
        obj = float(obj)
        if not np.isfinite(obj):
            raise FloatingPointError(
                f"non-finite MMI objective at {key} — bad numerator "
                f"alignment or learning rate too high")
        total_obj += obj
        total_frames += L
        num_done += 1

    if not crossvalidate:
        nnet.write(args.model_out, params, binary=_bool(args.binary))

    t = timer.elapsed()
    LOG(f"Done {num_done} files, {num_no_ali} with no alignment, "
        f"{num_err} with other errors. "
        f"[{'CROSS-VALIDATION' if crossvalidate else 'MMI TRAINING'}, "
        f"{t / 60:.2f} min, fps{total_frames / max(t, 1e-9):.0f}]")
    LOG(f"AvgMMI(den-num)/frame: {total_obj / max(total_frames, 1):.6f} "
        f"over {total_frames} frames")
    return 0


if __name__ == "__main__":
    sys.exit(main())
