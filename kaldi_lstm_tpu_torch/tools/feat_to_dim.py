"""Feature dimension — upstream feat-to-dim (featbin/feat-to-dim.cc):
prints the column count of the first matrix of a table (the common
`feat-to-dim scp:feats.scp -` probe in every recipe), or writes a
per-utterance int32 dim table when given a wspecifier.

    python -m kaldi_lstm_tpu_torch.tools.feat_to_dim scp:feats.scp -

This package's copy of ``kaldi_lstm_tpu.tools.feat_to_dim``: host numpy
on the port's io/kaldi_io.py, the same arguments, log lines and output
bytes.
"""

from __future__ import annotations

import argparse
import sys

from kaldi_lstm_tpu_torch.io.kaldi_io import (
    Int32Writer,
    SequentialMatrixReader,
    read_matrix_from_rxfilename,
)


def main(argv=None) -> int:
    p = argparse.ArgumentParser(
        description="Print the dimension of a feature table")
    p.add_argument("rspecifier_or_rxfilename")
    p.add_argument("wspecifier", nargs="?", default="-")
    args = p.parse_args(argv)

    src = args.rspecifier_or_rxfilename
    is_table = src.split(",")[0].split(":")[0] in ("ark", "scp")
    if args.wspecifier.split(",")[0].split(":")[0] in ("ark", "scp"):
        if not is_table:
            print("feat-to-dim: table output needs a table input",
                  file=sys.stderr)
            return 1
        with Int32Writer(args.wspecifier) as w:
            for key, mat in SequentialMatrixReader(src):
                w.write(key, mat.shape[1])
        return 0

    if is_table:
        dim = None
        for _, mat in SequentialMatrixReader(src):
            dim = mat.shape[1]
            break
        if dim is None:
            print("feat-to-dim: empty table", file=sys.stderr)
            return 1
    else:
        dim = read_matrix_from_rxfilename(src).shape[1]
    if args.wspecifier == "-":
        print(dim)
    else:  # upstream <dim-wxfilename>: write the dim to a file
        with open(args.wspecifier, "w") as f:
            f.write(f"{dim}\n")
    return 0


if __name__ == "__main__":
    sys.exit(main())
