"""Frame counts of a feature table — upstream feat-to-len
(featbin/feat-to-len.cc): with two args writes a per-utterance int32
table; with one arg reads a single matrix rxfilename and prints its
number of rows. Recipes use the table form to pre-size stream
schedulers and filter length mismatches before training.

    python -m kaldi_lstm_tpu_torch.tools.feat_to_len scp:feats.scp \\
        ark,t:len.txt

This package's copy of ``kaldi_lstm_tpu.tools.feat_to_len``: host numpy
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
from kaldi_lstm_tpu_torch.utils import LOG


def main(argv=None) -> int:
    p = argparse.ArgumentParser(
        description="Write per-utterance frame counts of a feature table")
    p.add_argument("rspecifier_or_rxfilename")
    p.add_argument("wspecifier", nargs="?", default=None)
    args = p.parse_args(argv)

    src = args.rspecifier_or_rxfilename
    if args.wspecifier is None:
        if src.split(",")[0].split(":")[0] in ("ark", "scp"):
            for _, mat in SequentialMatrixReader(src):
                print(mat.shape[0])
            return 0
        print(read_matrix_from_rxfilename(src).shape[0])
        return 0

    n = 0
    with Int32Writer(args.wspecifier) as w:
        for key, mat in SequentialMatrixReader(src):
            w.write(key, mat.shape[0])
            n += 1
    LOG(f"Printed lengths for {n} feature matrices")
    return 0 if n > 0 else 1


if __name__ == "__main__":
    sys.exit(main())
