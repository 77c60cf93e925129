"""Subset a feature table — upstream subset-feats
(featbin/subset-feats.cc): keep the first --n records, or filter by an
--include / --exclude key-list file. Recipes use it to carve out the
held-out cross-validation split and quick-test subsets.

    python -m kaldi_lstm_tpu_torch.tools.subset_feats scp:feats.scp \\
        ark:cv.ark --n 300

This package's copy of ``kaldi_lstm_tpu.tools.subset_feats``: host numpy
on the port's io/kaldi_io.py, the same arguments, log lines and output
bytes.
"""

from __future__ import annotations

import argparse
import sys

from kaldi_lstm_tpu_torch.io.kaldi_io import (
    CompressedMatrixWriter,
    MatrixWriter,
    SequentialMatrixReader,
)
from kaldi_lstm_tpu_torch.utils import LOG


def main(argv=None) -> int:
    p = argparse.ArgumentParser(
        description="Copy a subset of a feature table")
    p.add_argument("rspecifier")
    p.add_argument("wspecifier")
    p.add_argument("--n", type=int, default=-1,
                   help="keep only the first n records")
    p.add_argument("--include", default="",
                   help="file with keys to include (one per line)")
    p.add_argument("--exclude", default="",
                   help="file with keys to exclude")
    p.add_argument("--compress", default="false")
    args = p.parse_args(argv)
    if args.include and args.exclude:
        print("subset-feats: --include and --exclude are exclusive",
              file=sys.stderr)
        return 1

    keep = drop = None
    if args.include:
        with open(args.include) as f:
            keep = {line.split()[0] for line in f if line.strip()}
    if args.exclude:
        with open(args.exclude) as f:
            drop = {line.split()[0] for line in f if line.strip()}

    compress = str(args.compress).lower() in ("true", "1", "yes")
    writer = CompressedMatrixWriter(args.wspecifier) if compress \
        else MatrixWriter(args.wspecifier)
    n = 0
    with writer as w:
        for key, mat in SequentialMatrixReader(args.rspecifier):
            if 0 <= args.n <= n:
                break
            if keep is not None and key not in keep:
                continue
            if drop is not None and key in drop:
                continue
            w.write(key, mat)
            n += 1
    LOG(f"Kept {n} records")
    return 0 if n > 0 else 1


if __name__ == "__main__":
    sys.exit(main())
