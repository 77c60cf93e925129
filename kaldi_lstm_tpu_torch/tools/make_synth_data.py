"""Generate a synthetic learnable corpus in Kaldi table format (features
ark/scp + pdf alignments + posteriors) — for demos, smoke tests, and
benchmarking the full pipeline without real speech data.

Labels depend linearly on the current and previous frame, so the task
rewards the LSTM's recurrence.

    python -m kaldi_lstm_tpu_torch.tools.make_synth_data --dir data/synth \\
        --num-utts 50 --feat-dim 40 --num-classes 100

This package's copy of ``kaldi_lstm_tpu.tools.make_synth_data``: host
numpy on the port's io/kaldi_io.py, the same arguments, log lines and
output bytes.
"""

from __future__ import annotations

import argparse
import os
import sys

import numpy as np

from kaldi_lstm_tpu_torch.io.kaldi_io import (
    MatrixWriter,
    PosteriorWriter,
    TableWriter,
    write_int_vector,
)
from kaldi_lstm_tpu_torch.utils import LOG


def main(argv=None) -> int:
    p = argparse.ArgumentParser(description="Generate a synthetic corpus "
                                "in Kaldi table format")
    p.add_argument("--dir", required=True)
    p.add_argument("--num-utts", type=int, default=50)
    p.add_argument("--feat-dim", type=int, default=40)
    p.add_argument("--num-classes", type=int, default=100)
    p.add_argument("--min-len", type=int, default=50)
    p.add_argument("--max-len", type=int, default=300)
    p.add_argument("--seed", type=int, default=0)
    p.add_argument("--label-seed", type=int, default=42,
                   help="Seed of the label map W1/W2 — keep it the SAME "
                        "across train/cv splits so cv measures "
                        "generalization, and vary --seed for the data")
    args = p.parse_args(argv)

    os.makedirs(args.dir, exist_ok=True)
    label_rng = np.random.RandomState(args.label_seed)
    W1 = label_rng.randn(args.feat_dim, args.num_classes)
    W2 = label_rng.randn(args.feat_dim, args.num_classes)
    rng = np.random.RandomState(args.seed)

    d = args.dir
    frames = 0
    with MatrixWriter(f"ark,scp:{d}/feats.ark,{d}/feats.scp") as fw, \
            PosteriorWriter(f"ark:{d}/post.ark") as pw, \
            TableWriter(f"ark:{d}/ali.ark", write_int_vector) as aw:
        for i in range(args.num_utts):
            L = rng.randint(args.min_len, args.max_len + 1)
            f = rng.randn(L, args.feat_dim).astype(np.float32)
            prev = np.concatenate([f[:1], f[:-1]], axis=0)
            labels = (f @ W1 + 0.5 * (prev @ W2)).argmax(-1)
            key = f"utt{i:05d}"
            fw.write(key, f)
            pw.write(key, [[(int(l), 1.0)] for l in labels])
            aw.write(key, labels.astype(np.int32))
            frames += L
    LOG(f"Wrote {args.num_utts} utterances ({frames} frames, "
        f"{frames / 100:.1f} audio-seconds) to {d}")
    return 0


if __name__ == "__main__":
    sys.exit(main())
