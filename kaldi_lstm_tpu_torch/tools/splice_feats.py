"""Frame splicing at the table level — upstream splice-feats
(featbin/splice-feats.cc, feat/feature-functions.cc SpliceFrames):
out[t] = concat(in[clamp(t-L)], ..., in[clamp(t+R)]); edge frames are
clamped copies. Same math as the in-net <Splice> component
(models/components.py Splice), exposed as a data-prep tool so DNN
recipes can materialize spliced features ahead of training.

    python -m kaldi_lstm_tpu_torch.tools.splice_feats scp:feats.scp \\
        ark:spliced.ark --left-context 4 --right-context 4

This package's copy of ``kaldi_lstm_tpu.tools.splice_feats``: host numpy
on the port's io/kaldi_io.py, the same arguments, log lines and output
bytes.
"""

from __future__ import annotations

import argparse
import sys

import numpy as np

from kaldi_lstm_tpu_torch.io.kaldi_io import (
    CompressedMatrixWriter,
    MatrixWriter,
    SequentialMatrixReader,
)
from kaldi_lstm_tpu_torch.utils import LOG


def splice_frames(feats: np.ndarray, left: int, right: int) -> np.ndarray:
    """[T, D] -> [T, D*(left+1+right)] with clamped edges."""
    T = feats.shape[0]
    cols = []
    for off in range(-left, right + 1):
        idx = np.clip(np.arange(T) + off, 0, T - 1)
        cols.append(feats[idx])
    return np.concatenate(cols, axis=1)


def main(argv=None) -> int:
    p = argparse.ArgumentParser(
        description="Splice features with left/right temporal context")
    p.add_argument("rspecifier")
    p.add_argument("wspecifier")
    p.add_argument("--left-context", type=int, default=4)
    p.add_argument("--right-context", type=int, default=4)
    p.add_argument("--compress", default="false")
    args = p.parse_args(argv)
    if args.left_context < 0 or args.right_context < 0:
        print("splice-feats: contexts must be >= 0", file=sys.stderr)
        return 1

    compress = str(args.compress).lower() in ("true", "1", "yes")
    writer = CompressedMatrixWriter(args.wspecifier) if compress \
        else MatrixWriter(args.wspecifier)
    n = 0
    with writer as w:
        for key, mat in SequentialMatrixReader(args.rspecifier):
            w.write(key, splice_frames(np.asarray(mat),
                                       args.left_context,
                                       args.right_context))
            n += 1
    LOG(f"Spliced {n} utterances (left={args.left_context}, "
        f"right={args.right_context})")
    return 0 if n > 0 else 1


if __name__ == "__main__":
    sys.exit(main())
