"""Per-utterance trainer, PyTorch edition of
``kaldi_lstm_tpu.tools.nnet_train_perutt`` (the `nnet-train-perutt`
counterpart used by the standard variant: standard/README.md's
epoch-wise BPTT, one utterance per update, the TimeShift in the net
provides the target delay, element-wise +-50 gradient clipping in
Update). It is the training path of the bidirectional LSTMP, whose
backward direction needs the whole utterance.

    python -m kaldi_lstm_tpu_torch.tools.nnet_train_perutt [options]
        <feature-rspecifier> <targets-rspecifier> <model-in> [<model-out>]

Each utterance is one [1, T] batch with whole-sequence BPTT and zero
initial LSTM state (standard/nnet/nnet-lstm-projected.h:228-231).
Utterance lengths are padded up to multiples of --length-bucket by
repeating the last frame; padding frames carry zero mask (a
bidirectional layer's backward direction still reads them first, as in
the JAX package). Same arguments and log lines as the JAX tool, plus
``--device`` (default cuda; exits 1 when CUDA is missing; ``--device
cpu`` runs the plain PyTorch path). On the card a training step runs
K1/K2 per LSTM direction and, for an [AffineTransform, Softmax] tail,
the fused senone loss (K3/K4); ``--cross-validate=true`` runs the
forward only (K5, K3).
"""

from __future__ import annotations

import argparse
import sys

import numpy as np
import torch

from kaldi_lstm_tpu_torch.io.kaldi_io import (
    RandomAccessPosteriorReader,
    SequentialMatrixReader,
)
from kaldi_lstm_tpu_torch.models import Nnet
from kaldi_lstm_tpu_torch.train.loss import LossStats
from kaldi_lstm_tpu_torch.train.optim import init_momentum
from kaldi_lstm_tpu_torch.train.trainer import (
    STATS_FLUSH,
    TrainOptions,
    flush_aux,
    make_train_step,
    pack_aux,
    place_arrays,
)
from kaldi_lstm_tpu_torch.utils import (
    LOG,
    WARN,
    Timer,
    device_from_arg,
    set_verbose_level,
)

TOOL = "nnet-train-perutt"


def _bool(s):
    return str(s).lower() in ("true", "1", "yes")


def build_parser() -> argparse.ArgumentParser:
    p = argparse.ArgumentParser(description="Perform one iteration of "
                                "per-utterance LSTM training (epoch-wise "
                                "BPTT)")
    p.add_argument("feature_rspecifier")
    p.add_argument("targets_rspecifier")
    p.add_argument("model_in")
    p.add_argument("model_out", nargs="?", default=None)
    p.add_argument("--binary", default="true")
    p.add_argument("--cross-validate", default="false")
    p.add_argument("--feature-transform", default="")
    p.add_argument("--learn-rate", type=float, default=8e-5)
    p.add_argument("--momentum", type=float, default=0.9)
    p.add_argument("--max-post-entries", type=int, default=1,
                   help="Sparse-target width Kmax per frame (raise for "
                        "soft posteriors)")
    p.add_argument("--l1-penalty", type=float, default=0.0,
                   help="L1 penalty (lassoo) scaled by num-frames")
    p.add_argument("--l2-penalty", type=float, default=0.0,
                   help="L2 penalty (weight decay) scaled by num-frames")
    p.add_argument("--grad-clip", type=float, default=50.0,
                   help="Element-wise gradient clip "
                        "(nnet-lstm-projected.h:480-493)")
    p.add_argument("--length-bucket", type=int, default=128,
                   help="Pad utterance length to multiples of this")
    p.add_argument("--verbose", type=int, default=0)
    p.add_argument("--device", default="cuda",
                   help="cuda (default; exit 1 without CUDA) or cpu (the "
                        "plain PyTorch path)")
    return p


def pad_utterance(feats: np.ndarray, ids: np.ndarray, w: np.ndarray,
                  bucket: int) -> tuple[np.ndarray, ...]:
    """One utterance as a [1, T] batch, T = its length rounded up to a
    multiple of `bucket`: the last frame repeated as padding, targets
    and mask zero there (reference :116-121)."""
    L = feats.shape[0]
    T = -(-L // bucket) * bucket
    f = np.zeros((1, T, feats.shape[1]), np.float32)
    f[0, :L] = feats
    f[0, L:] = feats[-1]
    bi = np.zeros((1, T, ids.shape[1]), np.int32)
    bi[0, :L] = ids
    bw = np.zeros((1, T, ids.shape[1]), np.float32)
    bw[0, :L] = w
    mask = np.zeros((1, T), np.float32)
    mask[0, :L] = 1.0
    return f, bi, bw, mask


def run_main(argv=None) -> tuple[int, LossStats | None]:
    """main() that also returns the pass's LossStats (None when it stops
    before training)."""
    args = build_parser().parse_args(argv)
    set_verbose_level(args.verbose)
    crossvalidate = _bool(args.cross_validate)
    if not crossvalidate and args.model_out is None:
        print("error: <model-out> required unless --cross-validate=true",
              file=sys.stderr)
        return 1, None
    device = device_from_arg(args.device, TOOL)
    if device is None:
        return 1, None

    transf = transf_params = None
    if args.feature_transform:
        transf, transf_params = Nnet.read(args.feature_transform, device)

    nnet, params = Nnet.read(args.model_in, device)
    opts = TrainOptions(learn_rate=args.learn_rate, momentum=args.momentum,
                        l1_penalty=args.l1_penalty,
                        l2_penalty=args.l2_penalty,
                        grad_clip=args.grad_clip)
    step = make_train_step(nnet, opts, transf, crossvalidate, device=device)
    opt_state = init_momentum(params)
    lr = torch.tensor(args.learn_rate, dtype=torch.float32, device=device)
    states = nnet.init_states(1, device)
    reset = torch.ones((1,), dtype=torch.int32, device=device)

    targets = RandomAccessPosteriorReader(args.targets_rspecifier,
                                          max_entries=args.max_post_entries)
    stats = LossStats("Xent")
    pending: list = []
    timer = Timer()
    num_done = num_no_tgt = num_err = 0
    bucket = max(args.length_bucket, 1)

    for key, feats in SequentialMatrixReader(args.feature_rspecifier):
        if not targets.has_key(key):
            WARN(f"{key}, missing targets")
            num_no_tgt += 1
            continue
        ids, w = targets.value_dense(key, args.max_post_entries)
        L = feats.shape[0]
        if L != ids.shape[0]:
            WARN(f"{key}, length miss-match between feats and targets")
            num_err += 1
            continue
        if L == 0:
            WARN(f"{key}, zero-length utterance, skip")
            num_err += 1
            continue
        batch = place_arrays(pad_utterance(feats, ids, w, bucket), device)
        params, opt_state, _, aux = step(
            params, opt_state, states, transf_params, *batch, reset, lr)
        pending.append(pack_aux(aux))
        if len(pending) >= STATS_FLUSH:
            flush_aux(pending, stats)
        num_done += 1
    flush_aux(pending, stats)

    if not crossvalidate:
        nnet.write(args.model_out, params, binary=_bool(args.binary))

    t = timer.elapsed()
    LOG(f"Done {num_done} files, {num_no_tgt} with no tgt_mats, "
        f"{num_err} with other errors. "
        f"[{'CROSS-VALIDATION' if crossvalidate else 'TRAINING'}, "
        f"{t / 60:.2f} min, fps{stats.frames / max(t, 1e-9):.0f}]")
    LOG(stats.report())
    return 0, stats


def main(argv=None) -> int:
    return run_main(argv)[0]


if __name__ == "__main__":
    sys.exit(main())
