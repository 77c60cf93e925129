"""Lattice-based MMI sequence trainer, PyTorch edition of
``kaldi_lstm_tpu.tools.nnet_train_mmi_sequential`` (upstream nnet1's
nnet-train-mmi-sequential). Consumes denominator lattices from a
first-pass decode (latgen_faster) plus numerator alignments, rescores
the lattice acoustics with the current model every utterance, and
descends the (gamma_den - delta_num) derivative
(train/sequence_lattice.py).

    python -m kaldi_lstm_tpu_torch.tools.nnet_train_mmi_sequential \\
        [options] <feature-rspecifier> <den-lat-rspecifier> \\
        <ali-rspecifier> <transition-model> <model-in> [<model-out>]

Same arguments and log lines as the JAX tool, plus ``--device`` (default
cuda; exits 1 when CUDA is missing; ``--device cpu`` runs the plain
PyTorch path). Per utterance the card runs the loglik forward without
autograd (K5), the host the lattice forward-backward, and the card the
update: the gradient of sum(logits * diff) (K1/K2).
"""

from __future__ import annotations

import argparse
import sys

import numpy as np
import torch

from kaldi_lstm_tpu_torch.io.kaldi_io import SequentialMatrixReader
from kaldi_lstm_tpu_torch.io.lattice import RandomAccessLatticeReader
from kaldi_lstm_tpu_torch.io.transition_model import TransitionModel
from kaldi_lstm_tpu_torch.models import Nnet
from kaldi_lstm_tpu_torch.train.optim import init_momentum, momentum_update
from kaldi_lstm_tpu_torch.train.sequence_lattice import mmi_errors
from kaldi_lstm_tpu_torch.train.trainer import place_arrays
from kaldi_lstm_tpu_torch.tools.nnet_train_mmi import (
    _bool,
    _read_alignments,
    add_device_arg,
    pad_frames,
    read_log_prior,
)
from kaldi_lstm_tpu_torch.utils import (
    LOG,
    VLOG,
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

TOOL = "nnet-train-mmi-sequential"


def add_common_args(p: argparse.ArgumentParser) -> None:
    p.add_argument("feature_rspecifier")
    p.add_argument("den_lat_rspecifier",
                   help="denominator lattices (latgen_faster output)")
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
    p.add_argument("--lm-scale", type=float, default=1.0)
    p.add_argument("--old-acoustic-scale", type=float, default=0.0,
                   help="add the lattice's original acoustic costs "
                        "with this scale (upstream flag)")
    p.add_argument("--max-frames", type=int, default=6000,
                   help="skip utterances longer than this (upstream "
                        "default)")
    p.add_argument("--class-frame-counts", default="",
                   help="train on log-likelihoods (log-posterior minus "
                        "log-prior) instead of log-posteriors")
    p.add_argument("--length-bucket", type=int, default=128)
    p.add_argument("--verbose", type=int, default=0)
    add_device_arg(p)


class SequentialRunner:
    """Shared per-utterance machinery of the MMI/MPE sequential tools:
    the loglik forward, the diff-injection update (the gradient of the
    logits at the host-computed error, applied in place), lattice table
    access, padding to the bucket."""

    def __init__(self, args, device):
        set_verbose_level(args.verbose)
        self.args = args
        self.device = device
        self.crossvalidate = _bool(args.cross_validate)
        self.tm = TransitionModel.load(args.transition_model)

        self.transf = self.transf_params = None
        if args.feature_transform:
            self.transf, self.transf_params = Nnet.read(
                args.feature_transform, device)
        self.nnet, self.params = Nnet.read(args.model_in, device)
        self.log_prior = read_log_prior(args.class_frame_counts, device)
        self.opt_state = init_momentum(self.params)
        self.lr = torch.tensor(args.learn_rate, dtype=torch.float32,
                               device=device)
        self.alis = _read_alignments(args.ali_rspecifier)
        # offset-indexed lazy reads: only the current utterance's
        # lattice is resident
        self.lats = RandomAccessLatticeReader(args.den_lat_rspecifier)
        self.bucket = max(args.length_bucket, 1)

    def _logits(self, params, feats: torch.Tensor) -> torch.Tensor:
        x = feats
        if self.transf is not None:
            with torch.no_grad():
                x = self.transf.feedforward(self.transf_params, x)
        logits, _ = self.nnet.propagate(
            params, x, self.nnet.init_states(x.shape[0], x.device),
            logits=True)
        return logits

    def pad(self, feats: np.ndarray) -> torch.Tensor:
        return place_arrays([pad_frames(feats, self.bucket)],
                            self.device)[0]

    @torch.no_grad()
    def loglik(self, padded: torch.Tensor, L: int) -> np.ndarray:
        ll = torch.log_softmax(self._logits(self.params, padded), dim=-1)
        if self.log_prior is not None:
            ll = ll - self.log_prior
        return ll[0, :L].cpu().numpy()

    def update(self, padded: torch.Tensor, diff: np.ndarray) -> None:
        # grad of sum(logits * diff): the vjp of the logits at cotangent
        # diff; exact for the log-softmax output because every diff row
        # sums to zero (see sequence_lattice.py)
        d = np.zeros((1, padded.shape[1], diff.shape[1]), np.float32)
        d[0, :diff.shape[0]] = diff
        d = place_arrays([d], self.device)[0]
        live = tree_map(lambda t: t.detach().requires_grad_(True),
                        self.params)
        flat = tree_leaves(live)
        with torch.enable_grad():
            flat_g = torch.autograd.grad(self._logits(live, padded), flat,
                                         grad_outputs=d, allow_unused=True)
        grads = tree_unflatten(self.params, [
            torch.zeros_like(p) if g is None else g
            for p, g in zip(flat, flat_g)])
        momentum_update(self.params, grads, self.opt_state, self.lr,
                        self.args.momentum, 0.0)

    def utterances(self):
        """Yields (key, feats, tids, lat) for trainable utterances;
        counts skips like the upstream binaries."""
        self.num_done = self.num_no_ali = self.num_no_lat = 0
        self.num_other_error = 0
        for key, feats in SequentialMatrixReader(
                self.args.feature_rspecifier):
            if key not in self.alis:
                WARN(f"{key}, missing alignment")
                self.num_no_ali += 1
                continue
            if key not in self.lats:
                WARN(f"{key}, missing denominator lattice")
                self.num_no_lat += 1
                continue
            tids = self.alis[key]
            if feats.shape[0] != len(tids) or feats.shape[0] == 0:
                WARN(f"{key}, zero-length or length miss-match between "
                     f"feats and alignment")
                self.num_other_error += 1
                continue
            if feats.shape[0] > self.args.max_frames:
                WARN(f"{key}, too long ({feats.shape[0]} > "
                     f"{self.args.max_frames} frames), skipping")
                self.num_other_error += 1
                continue
            yield key, feats, tids, self.lats[key]
            self.num_done += 1

    def finish(self, mode: str) -> None:
        if not self.crossvalidate:
            self.nnet.write(self.args.model_out, self.params,
                            binary=_bool(self.args.binary))
        LOG(f"Done {self.num_done} files, {self.num_no_ali} with no "
            f"alignment, {self.num_no_lat} with no lattice, "
            f"{self.num_other_error} with other errors.")


def main(argv=None) -> int:
    p = argparse.ArgumentParser(
        description="One iteration of lattice-based MMI sequence "
                    "training (nnet-train-mmi-sequential)")
    add_common_args(p)
    p.add_argument("--drop-frames", default="true",
                   help="drop frames whose numerator pdf has zero "
                        "denominator occupancy (upstream default)")
    args = p.parse_args(argv)
    if not _bool(args.cross_validate) and args.model_out is None:
        print("error: <model-out> required unless --cross-validate=true",
              file=sys.stderr)
        return 1
    device = device_from_arg(args.device, TOOL)
    if device is None:
        return 1
    drop = _bool(args.drop_frames)

    r = SequentialRunner(args, device)
    timer = Timer()
    total_obj = total_frames = total_dropped = total_correct = 0

    for key, feats, tids, lat in r.utterances():
        padded = r.pad(feats)
        L = feats.shape[0]
        ll = r.loglik(padded, L)
        obj, diff, dropped, correct = mmi_errors(
            lat, r.tm, tids, ll, args.acoustic_scale, args.lm_scale,
            args.old_acoustic_scale, drop)
        if not np.isfinite(obj):
            raise FloatingPointError(
                f"non-finite MMI objective at {key}")
        VLOG(1, f"{key}: MMI obj/frame {obj / L:.5f}, "
                f"frame-acc {100.0 * correct / L:.2f}%, "
                f"dropped {dropped}")
        if not r.crossvalidate:
            r.update(padded, diff)
        total_obj += obj
        total_frames += L
        total_dropped += dropped
        total_correct += correct

    r.finish("MMI")
    t = timer.elapsed()
    cv = r.crossvalidate
    LOG(f"[{'CROSS-VALIDATION' if cv else 'MMI TRAINING'}, "
        f"{t / 60:.2f} min, "
        f"fps{total_frames / max(t, 1e-9):.0f}]")
    LOG(f"Overall MMI-objective/frame: "
        f"{total_obj / max(total_frames, 1):.6f} over {total_frames} "
        f"frames; lattice frame-accuracy "
        f"{100.0 * total_correct / max(total_frames, 1):.2f}%; "
        f"dropped {total_dropped} frames "
        f"({100.0 * total_dropped / max(total_frames, 1):.2f}%)")
    return 0


if __name__ == "__main__":
    sys.exit(main())
