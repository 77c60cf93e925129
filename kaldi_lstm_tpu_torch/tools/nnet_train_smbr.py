"""Lattice-free sMBR / MPE sequence trainer, PyTorch edition of
``kaldi_lstm_tpu.tools.nnet_train_smbr`` (the nnet1
nnet-train-mpe-sequential stage, with the expected accuracy computed
exactly over the phone-loop denominator graph instead of decode
lattices: train/sequence.py expected_accuracy). Upstream needs lattice
dumps and a reference alignment, this tool only the alignment
(nnet_align's output).

    python -m kaldi_lstm_tpu_torch.tools.nnet_train_smbr [options] \\
        <feature-rspecifier> <ali-rspecifier> <final.mdl> \\
        <model-in> [<model-out>]

Start from a frame-xent-trained model; --criterion mpe scores phone
accuracy, --silence-phones excludes silence from the accuracy. Same
arguments and log lines as the JAX tool, plus ``--device`` (default
cuda; exits 1 when CUDA is missing; ``--device cpu`` runs the plain
PyTorch path). A training step runs K1/K2 for the LSTM layer on the
card, ``--cross-validate=true`` the forward only (K5).

``--skip-nonfinite`` leaves params and momentum as they were after an
utterance whose E[A] is not finite: E[A] is read back (one host sync,
as the JAX tool's ``float(ea[0])``) before the in-place update is
applied. One deliberate difference from the JAX tool: a training pass
in which no utterance was trained (all of them skipped, say) logs an
ERROR, writes no model and exits 1, where the JAX tool writes the
unchanged model and exits 0.
"""

from __future__ import annotations

import argparse
import sys

import numpy as np
import torch

from kaldi_lstm_tpu_torch.io.kaldi_io import SequentialMatrixReader
from kaldi_lstm_tpu_torch.io.transition_model import TransitionModel
from kaldi_lstm_tpu_torch.models import Nnet
from kaldi_lstm_tpu_torch.train.optim import init_momentum, momentum_update
from kaldi_lstm_tpu_torch.train.sequence import den_graph_for, smbr_objective
from kaldi_lstm_tpu_torch.train.trainer import place_arrays
from kaldi_lstm_tpu_torch.tools.nnet_train_mmi import (
    _bool,
    _read_alignments,
    add_device_arg,
    make_sequence_step,
    pad_utterance,
    read_log_prior,
)
from kaldi_lstm_tpu_torch.utils import (
    ERROR,
    LOG,
    WARN,
    Timer,
    device_from_arg,
    set_verbose_level,
)

TOOL = "nnet-train-smbr"


def build_parser() -> argparse.ArgumentParser:
    p = argparse.ArgumentParser(
        description="One iteration of lattice-free sMBR/MPE sequence "
                    "training")
    p.add_argument("feature_rspecifier")
    p.add_argument("ali_rspecifier",
                   help="reference alignments (transition-ids)")
    p.add_argument("transition_model")
    p.add_argument("model_in")
    p.add_argument("model_out", nargs="?", default=None)
    p.add_argument("--binary", default="true")
    p.add_argument("--cross-validate", default="false")
    p.add_argument("--feature-transform", default="")
    p.add_argument("--learn-rate", type=float, default=1e-5)
    p.add_argument("--momentum", type=float, default=0.0)
    p.add_argument("--acoustic-scale", type=float, default=0.1)
    p.add_argument("--criterion", choices=("smbr", "mpe"),
                   default="smbr")
    p.add_argument("--silence-phones", default="",
                   help="colon-separated phone ids excluded from the "
                        "accuracy (upstream convention)")
    p.add_argument("--class-frame-counts", default="",
                   help="train on log-likelihoods (log-posterior minus "
                        "log-prior) instead of log-posteriors")
    p.add_argument("--length-bucket", type=int, default=128)
    p.add_argument("--skip-nonfinite", default="false",
                   help="on a non-finite per-utt expected accuracy, skip "
                        "that utterance's update and continue (counted "
                        "under 'other errors') instead of aborting")
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
    sil = None
    if args.silence_phones:
        sil = torch.tensor([int(x) for x in args.silence_phones.split(":")],
                           dtype=torch.int64, device=device)

    transf = transf_params = None
    if args.feature_transform:
        transf, transf_params = Nnet.read(args.feature_transform, device)
    nnet, params = Nnet.read(args.model_in, device)
    log_prior = read_log_prior(args.class_frame_counts, device)
    ac_scale = float(args.acoustic_scale)
    criterion = args.criterion
    step = make_sequence_step(
        nnet, transf, transf_params, log_prior,
        lambda ll, refs, mask: smbr_objective(graph, ll, refs, mask,
                                              ac_scale, criterion, sil),
        crossvalidate)

    alis = _read_alignments(args.ali_rspecifier)
    opt_state = init_momentum(params)
    lr = torch.tensor(args.learn_rate, dtype=torch.float32, device=device)
    skip_nonfinite = _bool(args.skip_nonfinite)
    timer = Timer()
    num_done = num_no_ali = num_err = 0
    total_frames = 0
    total_acc = 0.0
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
        refs = (tm.transition_ids_to_pdfs(tids) if criterion == "smbr"
                else tm.transition_ids_to_phones(tids))
        batch = place_arrays(pad_utterance(feats, refs, bucket), device)
        _, ea, grads = step(params, *batch)
        ea = float(ea[0])
        if not np.isfinite(ea):
            if skip_nonfinite:
                WARN(f"{key}, non-finite expected accuracy — "
                     "reverting this update and skipping the utterance")
                num_err += 1
                continue
            raise FloatingPointError(
                f"non-finite expected accuracy at {key} — bad "
                "alignment or learning rate too high")
        if grads is not None:
            momentum_update(params, grads, opt_state, lr, args.momentum, 0.0)
        total_acc += ea
        total_frames += L
        num_done += 1

    trained_none = not crossvalidate and num_done == 0
    if not crossvalidate and not trained_none:
        nnet.write(args.model_out, params, binary=_bool(args.binary))

    t = timer.elapsed()
    tag = criterion.upper()
    LOG(f"Done {num_done} files, {num_no_ali} with no alignment, "
        f"{num_err} with other errors. "
        f"[{'CROSS-VALIDATION' if crossvalidate else tag + ' TRAINING'}"
        f", {t / 60:.2f} min, fps{total_frames / max(t, 1e-9):.0f}]")
    LOG(f"Expected{tag}Accuracy/frame: "
        f"{total_acc / max(total_frames, 1):.6f} "
        f"over {total_frames} frames")
    if trained_none:
        ERROR(f"no utterance was trained ({num_no_ali} with no alignment, "
              f"{num_err} with other errors); {args.model_out} not "
              f"written")
        return 1
    return 0


if __name__ == "__main__":
    sys.exit(main())
