"""Lattice-based MPE / sMBR sequence trainer, PyTorch edition of
``kaldi_lstm_tpu.tools.nnet_train_mpe_sequential`` (upstream nnet1's
nnet-train-mpe-sequential). Consumes denominator lattices plus
numerator alignments and ascends the expected frame accuracy E[A] via
the expectation-semiring lattice forward-backward
(train/sequence_lattice.py mpe_errors), through the MMI tool's
SequentialRunner (K5 for the loglik, K1/K2 for the update on the card).

    python -m kaldi_lstm_tpu_torch.tools.nnet_train_mpe_sequential \\
        [options] <feature-rspecifier> <den-lat-rspecifier> \\
        <ali-rspecifier> <transition-model> <model-in> [<model-out>]

--do-smbr=true (upstream flag) scores state-level (pdf) accuracy
(sMBR); false scores phone-level accuracy (MPE). Same arguments and log
lines as the JAX tool, plus ``--device`` (default cuda; exits 1 when
CUDA is missing; ``--device cpu`` runs the plain PyTorch path).
"""

from __future__ import annotations

import argparse
import sys

import numpy as np

from kaldi_lstm_tpu_torch.train.sequence_lattice import mpe_errors
from kaldi_lstm_tpu_torch.tools.nnet_train_mmi import _bool
from kaldi_lstm_tpu_torch.tools.nnet_train_mmi_sequential import (
    SequentialRunner,
    add_common_args,
)
from kaldi_lstm_tpu_torch.utils import LOG, VLOG, Timer, device_from_arg

TOOL = "nnet-train-mpe-sequential"


def main(argv=None) -> int:
    p = argparse.ArgumentParser(
        description="One iteration of lattice-based MPE/sMBR sequence "
                    "training (nnet-train-mpe-sequential)")
    add_common_args(p)
    p.add_argument("--do-smbr", default="false",
                   help="true: state-level accuracy (sMBR); false: "
                        "phone-level (MPE) — upstream flag")
    p.add_argument("--silence-phones", default="",
                   help="colon-separated phone ids excluded from the "
                        "accuracy (upstream convention)")
    p.add_argument("--one-silence-class", default="false",
                   help="treat all silence phones as one class "
                        "(silence-vs-silence counts as correct)")
    args = p.parse_args(argv)
    if not _bool(args.cross_validate) and args.model_out is None:
        print("error: <model-out> required unless --cross-validate=true",
              file=sys.stderr)
        return 1
    device = device_from_arg(args.device, TOOL)
    if device is None:
        return 1
    criterion = "smbr" if _bool(args.do_smbr) else "mpe"
    sil = frozenset(int(x) for x in args.silence_phones.split(":")
                    if x)
    one_sil = _bool(args.one_silence_class)

    r = SequentialRunner(args, device)
    timer = Timer()
    total_acc = 0.0
    total_frames = 0

    for key, feats, tids, lat in r.utterances():
        padded = r.pad(feats)
        L = feats.shape[0]
        ll = r.loglik(padded, L)
        ea, diff = mpe_errors(
            lat, r.tm, tids, ll, args.acoustic_scale, args.lm_scale,
            args.old_acoustic_scale, criterion, sil, one_sil)
        if not np.isfinite(ea):
            raise FloatingPointError(
                f"non-finite expected accuracy at {key}")
        VLOG(1, f"{key}: expected {criterion} accuracy/frame "
                f"{ea / L:.5f}")
        if not r.crossvalidate:
            r.update(padded, diff)
        total_acc += ea
        total_frames += L

    r.finish(criterion.upper())
    t = timer.elapsed()
    cv = r.crossvalidate
    tag = criterion.upper()
    LOG(f"[{'CROSS-VALIDATION' if cv else tag + ' TRAINING'}, "
        f"{t / 60:.2f} min, fps{total_frames / max(t, 1e-9):.0f}]")
    LOG(f"Overall expected-{tag}-accuracy/frame: "
        f"{total_acc / max(total_frames, 1):.6f} over {total_frames} "
        f"frames")
    return 0


if __name__ == "__main__":
    sys.exit(main())
