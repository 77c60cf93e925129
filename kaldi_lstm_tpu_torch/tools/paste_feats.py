"""Append feature streams frame-by-frame — upstream paste-feats
(featbin/paste-feats.cc): the first table is read sequentially, the
rest by random access; rows are truncated to the shortest stream when
the length spread is within --length-tolerance, else the utterance is
skipped. The standard way recipes combine e.g. fbank + pitch, or
online-CMVN streams.

    python -m kaldi_lstm_tpu_torch.tools.paste_feats scp:fbank.scp \\
        scp:pitch.scp ark:paired.ark --length-tolerance 2

This package's copy of ``kaldi_lstm_tpu.tools.paste_feats``: host numpy
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
    RandomAccessMatrixReader,
    SequentialMatrixReader,
)
from kaldi_lstm_tpu_torch.utils import LOG, WARN


def main(argv=None) -> int:
    p = argparse.ArgumentParser(
        description="Paste feature tables together dimension-wise")
    p.add_argument("rspecifiers", nargs="+",
                   help="2+ input tables followed by the output wspecifier")
    p.add_argument("--length-tolerance", type=int, default=0,
                   help="max allowed frame-count spread between streams; "
                        "rows past the shortest are dropped")
    p.add_argument("--compress", default="false")
    args = p.parse_args(argv)
    if len(args.rspecifiers) < 3:
        print("paste-feats: need >= 2 inputs and 1 output", file=sys.stderr)
        return 1
    *rspecs, wspec = args.rspecifiers

    first = SequentialMatrixReader(rspecs[0])
    rest = [RandomAccessMatrixReader(r) for r in rspecs[1:]]
    compress = str(args.compress).lower() in ("true", "1", "yes")
    writer = CompressedMatrixWriter(wspec) if compress \
        else MatrixWriter(wspec)

    n_done = n_err = 0
    with writer as w:
        for key, mat in first:
            mats = [np.asarray(mat)]
            missing = False
            for i, r in enumerate(rest):
                if not r.has_key(key):
                    WARN(f"paste-feats: no record for {key} in input "
                         f"{i + 2}")
                    missing = True
                    break
                mats.append(np.asarray(r.value(key)))
            if missing:
                n_err += 1
                continue
            lens = [m.shape[0] for m in mats]
            if max(lens) - min(lens) > args.length_tolerance:
                WARN(f"paste-feats: length mismatch {lens} for {key} "
                     f"exceeds tolerance {args.length_tolerance}")
                n_err += 1
                continue
            t = min(lens)
            w.write(key, np.concatenate([m[:t] for m in mats], axis=1))
            n_done += 1
    LOG(f"Pasted {len(rspecs)} tables for {n_done} utterances; "
        f"{n_err} had errors")
    return 0 if n_done > 0 else 1


if __name__ == "__main__":
    sys.exit(main())
