"""Per-class frame counts from int-vector alignments — upstream
analyze-counts (nnetbin/analyze-counts.cc): the standard prior flow is
`ali-to-pdf final.mdl ark:ali.ark ark:- | analyze-counts ark:- counts`,
producing the --class-frame-counts vector nnet-forward divides by
(compute_class_counts is the posterior-table variant of the same).

    python -m kaldi_lstm_tpu_torch.tools.analyze_counts \\
        ark:pdf_ali.ark counts.vec --num-classes 8000

This package's copy of ``kaldi_lstm_tpu.tools.analyze_counts``: host
code on the port's io/kaldi_io.py, the same arguments, log lines and
output bytes.
"""

from __future__ import annotations

import argparse
import io
import sys

import numpy as np

from kaldi_lstm_tpu_torch.io.kaldi_io import (
    KaldiOutput,
    _open_rspecifier,
    _read_key,
    _read_value_header,
    read_int_vector,
    write_vector,
)
from kaldi_lstm_tpu_torch.utils import LOG


def main(argv=None) -> int:
    p = argparse.ArgumentParser(
        description="Compute per-class frame counts from alignments")
    p.add_argument("ali_rspecifier")
    p.add_argument("counts_out")
    p.add_argument("--num-classes", type=int, default=0,
                   help="size of the count vector (0 = grow to max id)")
    p.add_argument("--binary", default="false")
    p.add_argument("--counts-padding", type=float, default=0.0,
                   help="additive smoothing added to every class count "
                        "(upstream flag; avoids log(0) priors)")
    args = p.parse_args(argv)

    kind, stream = _open_rspecifier(args.ali_rspecifier)
    if kind != "ark":
        print("analyze-counts: only ark: input supported", file=sys.stderr)
        return 1
    buffered = stream if isinstance(stream, io.BufferedReader) \
        else io.BufferedReader(stream)

    counts = np.zeros(max(args.num_classes, 0), np.float64)
    n_utt = 0
    n_frames = 0
    while True:
        key = _read_key(buffered)
        if key is None:
            break
        ali = np.asarray(read_int_vector(_read_value_header(buffered)))
        if ali.size and int(ali.min()) < 0:
            print(f"analyze-counts: {key} contains negative id "
                  f"{int(ali.min())}", file=sys.stderr)
            return 1
        if ali.size and int(ali.max()) >= counts.shape[0]:
            if args.num_classes:
                print(f"analyze-counts: {key} has id {int(ali.max())} >= "
                      f"--num-classes {args.num_classes}", file=sys.stderr)
                return 1
            grown = np.zeros(int(ali.max()) + 1, np.float64)
            grown[:counts.shape[0]] = counts
            counts = grown
        np.add.at(counts, ali, 1.0)
        n_utt += 1
        n_frames += int(ali.size)

    counts += args.counts_padding
    with open(args.counts_out, "wb") as f:
        out = KaldiOutput(f, binary=str(args.binary).lower()
                          in ("true", "1", "yes"))
        write_vector(out, counts.astype(np.float32))
    LOG(f"Accumulated counts for {counts.shape[0]} classes over {n_utt} "
        f"alignments ({n_frames} frames) -> {args.counts_out}")
    return 0 if n_utt > 0 else 1


if __name__ == "__main__":
    sys.exit(main())
