"""Select / reorder feature columns — upstream select-feats
(featbin/select-feats.cc): the selection string is a comma list of
0-based column indices and (possibly reversed) ranges, e.g.
"1,3-5,24-22,0"; output columns appear in the order written.

    python -m kaldi_lstm_tpu_torch.tools.select_feats 0-39 \\
        scp:feats_pitch.scp ark:fbank_only.ark

This package's copy of ``kaldi_lstm_tpu.tools.select_feats``: host numpy
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


def parse_selection(spec: str) -> list:
    """"1,3-5,24-22" -> [1, 3, 4, 5, 24, 23, 22]."""
    out = []
    for part in spec.split(","):
        part = part.strip()
        if not part:
            continue
        if "-" in part:
            a, b = part.split("-", 1)
            a, b = int(a), int(b)
            step = 1 if b >= a else -1
            out.extend(range(a, b + step, step))
        else:
            out.append(int(part))
    if not out or min(out) < 0:
        raise ValueError(f"bad selection {spec!r}")
    return out


def main(argv=None) -> int:
    p = argparse.ArgumentParser(
        description="Select a subset/reordering of feature columns")
    p.add_argument("selection", help='e.g. "0,2-5,10-8"')
    p.add_argument("rspecifier")
    p.add_argument("wspecifier")
    p.add_argument("--compress", default="false")
    args = p.parse_args(argv)

    try:
        sel = parse_selection(args.selection)
    except ValueError as e:
        print(f"select-feats: {e}", file=sys.stderr)
        return 1
    idx = np.asarray(sel, np.int64)

    compress = str(args.compress).lower() in ("true", "1", "yes")
    writer = CompressedMatrixWriter(args.wspecifier) if compress \
        else MatrixWriter(args.wspecifier)
    n = 0
    with writer as w:
        for key, mat in SequentialMatrixReader(args.rspecifier):
            if int(idx.max()) >= mat.shape[1]:
                print(f"select-feats: column {int(idx.max())} out of "
                      f"range for {key} (dim {mat.shape[1]})",
                      file=sys.stderr)
                return 1
            w.write(key, np.ascontiguousarray(np.asarray(mat)[:, idx]))
            n += 1
    LOG(f"Selected {len(sel)} columns for {n} utterances")
    return 0 if n > 0 else 1


if __name__ == "__main__":
    sys.exit(main())
