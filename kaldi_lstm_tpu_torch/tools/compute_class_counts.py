"""Accumulate per-class frame counts from posteriors/alignments — the
`analyze-counts` stage that produces the --class-frame-counts vector
nnet-forward divides priors by (decode call stack, SURVEY.md §3.2).

    python -m kaldi_lstm_tpu_torch.tools.compute_class_counts \\
        --num-classes 8000 ark:post.ark counts.vec

This package's copy of ``kaldi_lstm_tpu.tools.compute_class_counts``:
host code on the port's io/kaldi_io.py, the same arguments, log lines
and output bytes.
"""

from __future__ import annotations

import argparse
import io
import sys

import numpy as np

from kaldi_lstm_tpu_torch.io.kaldi_io import (
    KaldiInput,
    KaldiOutput,
    SequentialPosteriorReader,
    _split_offset,
    read_posterior,
    write_vector,
)
from kaldi_lstm_tpu_torch.utils import LOG


def _iter_posteriors(rspecifier: str):
    """Full-fidelity sequential iteration over ark:/scp: posterior
    tables (no top-K truncation — priors must sum every entry)."""
    kind = rspecifier.split(",")[0].split(":")[0]
    if kind == "ark":
        yield from SequentialPosteriorReader(rspecifier)
        return
    _, _, scp = rspecifier.partition(":")
    with open(scp, encoding="utf-8") as f:
        for line in f:
            line = line.strip()
            if not line:
                continue
            key, rxf = line.split(None, 1)
            path, offset = _split_offset(rxf)
            with open(path, "rb") as g:
                if offset is not None:
                    g.seek(offset)
                yield key, read_posterior(
                    KaldiInput(io.BufferedReader(
                        io.FileIO(g.fileno(), closefd=False))))


def main(argv=None) -> int:
    p = argparse.ArgumentParser(description="Compute per-pdf frame counts "
                                "from posteriors")
    p.add_argument("post_rspecifier")
    p.add_argument("counts_out")
    p.add_argument("--num-classes", type=int, required=True)
    p.add_argument("--binary", default="false")
    p.add_argument("--counts-offset", type=float, default=0.0,
                   help="Additive smoothing added to every class count")
    args = p.parse_args(argv)

    counts = np.zeros(args.num_classes, np.float64)
    n_utt = 0
    for key, post in _iter_posteriors(args.post_rspecifier):
        # vectorized full-fidelity accumulation (every entry counted)
        flat = [e for frame in post for e in frame]
        if flat:
            ids = np.fromiter((e[0] for e in flat), np.int64, len(flat))
            ws = np.fromiter((e[1] for e in flat), np.float64, len(flat))
            np.add.at(counts, ids, ws)
        n_utt += 1

    counts += args.counts_offset
    with open(args.counts_out, "wb") as f:
        out = KaldiOutput(f, binary=str(args.binary).lower()
                          in ("true", "1", "yes"))
        write_vector(out, counts.astype(np.float32))
    LOG(f"Accumulated counts over {n_utt} utterances, "
        f"{counts.sum():.0f} frames -> {args.counts_out}")
    return 0


if __name__ == "__main__":
    sys.exit(main())
