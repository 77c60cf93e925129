"""Frame-shuffled xent/mse trainer, PyTorch edition of
``kaldi_lstm_tpu.tools.nnet_train_frmshuff`` (upstream nnet1's default
DNN training tool nnet-train-frmshuff, which the reference names as the
stock nnet1 trainer its standard variant stays compatible with).

    python -m kaldi_lstm_tpu_torch.tools.nnet_train_frmshuff [options] \\
        <feature-rspecifier> <targets-rspecifier> <model-in> [<model-out>]

Frames from all utterances are buffered in a host-side randomizer
window (--randomizer-size), shuffled with a seeded permutation and
drained as fixed-shape minibatches (train/randomizer.py, byte-equal to
the JAX package's); the step treats each minibatch as [B, 1] streams so
per-frame components see independent frames. The feature transform is
applied per UTTERANCE before buffering (so Splice context windows stay
intact, as upstream does). Designed for per-frame (DNN) nets; a warning
is issued if the net contains LSTM components (their state is reset
every minibatch, as frame shuffling destroys sequence structure).

Per-frame weights (--frame-weights, a float-vector table) scale each
frame's loss and gradient; zero weight excludes the frame. A net with
dropout draws each minibatch's masks from a generator of its own,
seeded from --randomizer-seed and the minibatch's index (the JAX tool's
fold_in). Same arguments and log lines as the JAX tool, plus
``--device`` (default cuda; exits 1 when CUDA is missing; ``--device
cpu`` runs the plain PyTorch path). On the card an [AffineTransform,
Softmax] tail trains through the fused senone loss (K3/K4).
"""

from __future__ import annotations

import argparse
import sys

import numpy as np
import torch

from kaldi_lstm_tpu_torch.io.kaldi_io import (
    RandomAccessPosteriorReader,
    SequentialMatrixReader,
    read_float_vectors,
)
from kaldi_lstm_tpu_torch.models import Nnet
from kaldi_lstm_tpu_torch.models.components import _LstmBase
from kaldi_lstm_tpu_torch.train.loss import LossStats
from kaldi_lstm_tpu_torch.train.optim import init_momentum
from kaldi_lstm_tpu_torch.train.randomizer import FrameRandomizer
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

TOOL = "nnet-train-frmshuff"


def _bool(s):
    return str(s).lower() in ("true", "1", "yes")


def build_parser() -> argparse.ArgumentParser:
    p = argparse.ArgumentParser(
        description="Frame-shuffled neural net training by SGD "
                    "(nnet-train-frmshuff)")
    p.add_argument("feature_rspecifier")
    p.add_argument("targets_rspecifier")
    p.add_argument("model_in")
    p.add_argument("model_out", nargs="?", default=None)
    p.add_argument("--binary", default="true")
    p.add_argument("--cross-validate", default="false")
    p.add_argument("--randomize", default="true",
                   help="shuffle frames (false for CV passes)")
    p.add_argument("--feature-transform", default="")
    p.add_argument("--learn-rate", type=float, default=0.008,
                   help="upstream nnet-train-frmshuff default")
    p.add_argument("--momentum", type=float, default=0.0)
    p.add_argument("--l1-penalty", type=float, default=0.0,
                   help="L1 penalty (lassoo) scaled by num-frames")
    p.add_argument("--l2-penalty", type=float, default=0.0,
                   help="L2 penalty (weight decay) scaled by num-frames")
    p.add_argument("--minibatch-size", type=int, default=256)
    p.add_argument("--randomizer-size", type=int, default=32768)
    p.add_argument("--randomizer-seed", type=int, default=777)
    p.add_argument("--objective-function", choices=("xent", "mse"),
                   default="xent")
    p.add_argument("--frame-weights", default="",
                   help="per-frame weight vectors (float ark)")
    p.add_argument("--max-post-entries", type=int, default=4,
                   help="sparse target entries kept per frame")
    p.add_argument("--length-bucket", type=int, default=128)
    p.add_argument("--verbose", type=int, default=0)
    # dummy upstream flag accepted for script compatibility
    p.add_argument("--use-gpu", default="yes", help="(ignored)")
    p.add_argument("--device", default="cuda",
                   help="cuda (default; exit 1 without CUDA) or cpu (the "
                        "plain PyTorch path)")
    return p


def make_transform(transf, transf_params, bucket: int, device):
    """feats [L, D] numpy -> the feature transform's [L, D'] numpy, run
    on `device` over the utterance padded to a `bucket` multiple by
    repeating its last frame (reference :113-132); the identity (as
    float32) without a transform."""
    if transf is None:
        return lambda feats: feats.astype(np.float32)

    @torch.inference_mode()
    def transform(feats: np.ndarray) -> np.ndarray:
        L = feats.shape[0]
        T = -(-L // bucket) * bucket
        f = np.zeros((1, T, feats.shape[1]), np.float32)
        f[0, :L] = feats
        if L:
            f[0, L:] = feats[-1]
        y = transf.feedforward(transf_params,
                               torch.from_numpy(f).to(device))
        return y[0, :L].cpu().numpy()
    return transform


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
    if any(isinstance(c, _LstmBase) for c in nnet.components):
        WARN("net contains LSTM components: frame shuffling destroys "
             "sequence structure; use train_lstm_streams or "
             "nnet_train_perutt instead")

    opts = TrainOptions(learn_rate=args.learn_rate,
                        momentum=args.momentum,
                        l1_penalty=args.l1_penalty,
                        l2_penalty=args.l2_penalty,
                        objective=args.objective_function)
    step = make_train_step(nnet, opts, transf=None,
                           crossvalidate=crossvalidate, device=device)
    transform = make_transform(transf, transf_params,
                               max(args.length_bucket, 1), device)

    targets = RandomAccessPosteriorReader(args.targets_rspecifier)
    frame_weights = (read_float_vectors(args.frame_weights)
                     if args.frame_weights else None)

    rand = None  # created after the first utterance fixes the dim

    opt_state = init_momentum(params)
    stats = LossStats("Xent" if args.objective_function == "xent"
                      else "Mse")
    pending: list = []
    lr = torch.tensor(args.learn_rate, dtype=torch.float32, device=device)
    B = args.minibatch_size
    ones = torch.ones((B,), dtype=torch.float32, device=device)
    states = nnet.init_states(B, device)
    timer = Timer()
    num_done = num_no_tgt = num_other = 0
    minibatches = 0

    use_dropout = (not crossvalidate and any(
        getattr(c, "dropout_rate", 0.0) > 0 for c in nnet.components))
    drop_seed = args.randomizer_seed or 777

    def run_batches(final=False):
        nonlocal params, opt_state, states, minibatches
        if rand is None or (not rand.full and not final):
            return
        for arrays in rand.drain():
            batch = place_arrays(arrays, device)
            extra = {"rng": torch.Generator(device=device).manual_seed(
                drop_seed + minibatches)} if use_dropout else {}
            params, opt_state, states, aux = step(
                params, opt_state, states, None, *batch, ones, lr, **extra)
            pending.append(pack_aux(aux))
            if len(pending) >= STATS_FLUSH:
                flush_aux(pending, stats, log_fn=LOG)
            minibatches += 1

    for key, feats in SequentialMatrixReader(args.feature_rspecifier):
        if not targets.has_key(key):
            WARN(f"{key}, missing targets")
            num_no_tgt += 1
            continue
        post = targets.value(key)
        if len(post) != feats.shape[0]:
            WARN(f"{key}, length miss-match of targets {len(post)} and "
                 f"features {feats.shape[0]}")
            num_other += 1
            continue
        fw = None
        if frame_weights is not None:
            if key not in frame_weights:
                WARN(f"{key}, missing frame weights")
                num_other += 1
                continue
            fw = frame_weights[key]
            if len(fw) != feats.shape[0]:
                WARN(f"{key}, frame-weights length miss-match")
                num_other += 1
                continue
        x = transform(np.ascontiguousarray(feats))
        if rand is None:
            rand = FrameRandomizer(
                x.shape[1], args.randomizer_size, B,
                args.max_post_entries, args.randomizer_seed,
                randomize=_bool(args.randomize) and not crossvalidate)
        off = 0
        while off < len(post):
            off += rand.add(x[off:], post[off:],
                            fw[off:] if fw is not None else None)
            run_batches()
        num_done += 1
    run_batches(final=True)
    flush_aux(pending, stats, log_fn=LOG)

    if not crossvalidate:
        nnet.write(args.model_out, params, binary=_bool(args.binary))

    t = timer.elapsed()
    LOG(f"Done {num_done} files, {num_no_tgt} with no tgt_mats, "
        f"{num_other} with other errors. "
        f"[{'CROSS-VALIDATION' if crossvalidate else 'TRAINING'}, "
        f"{'NOT-' if not _bool(args.randomize) else ''}RANDOMIZED, "
        f"{t / 60:.2f} min, fps{stats.frames / max(t, 1e-9):.0f}; "
        f"{minibatches} minibatches, {stats.frames:g} frames]")
    print(stats.report(), file=sys.stderr)
    return 0, stats


def main(argv=None) -> int:
    return run_main(argv)[0]


if __name__ == "__main__":
    sys.exit(main())
