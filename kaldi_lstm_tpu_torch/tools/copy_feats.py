"""Copy feature tables — upstream copy-feats: ark/scp in, ark (and
optional scp index) out, binary or text, optionally Kaldi-compressed
(CM wire format). The glue tool every upstream data-prep script leans
on (e.g. re-materializing piped features, compressing corpora).

    python -m kaldi_lstm_tpu_torch.tools.copy_feats scp:feats.scp \\
        ark,scp:out.ark,out.scp --compress=true

This package's copy of ``kaldi_lstm_tpu.tools.copy_feats``: host numpy
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
        description="Copy feature matrix tables (ark/scp -> ark[,scp])")
    p.add_argument("rspecifier")
    p.add_argument("wspecifier")
    p.add_argument("--compress", default="false",
                   help="write CompressedMatrix records (lossy, ~4x "
                        "smaller)")
    p.add_argument("--binary", default="true",
                   help="false = text matrices (ark,t: also works)")
    args = p.parse_args(argv)

    compress = str(args.compress).lower() in ("true", "1", "yes")
    binary = str(args.binary).lower() in ("true", "1", "yes")
    writer = (CompressedMatrixWriter(args.wspecifier) if compress
              else MatrixWriter(args.wspecifier))
    writer.binary = writer.binary and binary
    if compress and not writer.binary:
        print("copy_feats: --compress=true requires binary output",
              file=sys.stderr)
        return 1
    n = 0
    with writer as w:
        for key, mat in SequentialMatrixReader(args.rspecifier):
            w.write(key, mat)
            n += 1
    LOG(f"Copied {n} feature matrices")
    return 0 if n > 0 else 1


if __name__ == "__main__":
    sys.exit(main())
