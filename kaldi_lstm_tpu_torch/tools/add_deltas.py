"""Append delta (and delta-delta) features — upstream add-deltas
(feat/feature-functions.cc DeltaFeatures): order-o coefficients are
built by repeated regression of the previous order over a +/-window
frame span, delta[t] = sum_k k*x[t+k] / sum_k k^2 with edge frames
clamped (index clipping, same as upstream's boundary handling).

    python -m kaldi_lstm_tpu_torch.tools.add_deltas scp:feats.scp \\
        ark:feats_dd.ark --delta-order 2 --delta-window 2

This package's copy of ``kaldi_lstm_tpu.tools.add_deltas``: host numpy
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


def delta_coeffs(order: int, window: int) -> list:
    """coeffs[o] = 1-D regression filter for delta order o (coeffs[0]
    is the identity [1.0]); upstream DeltaFeaturesOptions semantics."""
    coeffs = [np.array([1.0])]
    k = np.arange(-window, window + 1, dtype=np.float64)
    base = k / np.sum(k * k)
    for _ in range(order):
        coeffs.append(np.convolve(coeffs[-1], base))
    return coeffs


def add_deltas(feats: np.ndarray, order: int = 2,
               window: int = 2) -> np.ndarray:
    """[T, D] -> [T, D*(order+1)]; edges use clamped frame indices."""
    T = feats.shape[0]
    x = np.asarray(feats, np.float64)
    out = [x]
    for coef in delta_coeffs(order, window)[1:]:
        half = (len(coef) - 1) // 2
        d = np.zeros_like(x)
        for j, c in enumerate(coef):
            if c == 0.0:
                continue
            off = j - half
            idx = np.clip(np.arange(T) + off, 0, T - 1)
            d += c * x[idx]
        out.append(d)
    return np.concatenate(out, axis=1).astype(np.float32)


def main(argv=None) -> int:
    p = argparse.ArgumentParser(
        description="Append delta features to a feature table")
    p.add_argument("rspecifier")
    p.add_argument("wspecifier")
    p.add_argument("--delta-order", type=int, default=2)
    p.add_argument("--delta-window", type=int, default=2)
    p.add_argument("--compress", default="false")
    args = p.parse_args(argv)

    compress = str(args.compress).lower() in ("true", "1", "yes")
    writer = (CompressedMatrixWriter(args.wspecifier) if compress
              else MatrixWriter(args.wspecifier))
    n = 0
    with writer as w:
        for key, mat in SequentialMatrixReader(args.rspecifier):
            w.write(key, add_deltas(mat, args.delta_order,
                                    args.delta_window))
            n += 1
    LOG(f"Added deltas (order {args.delta_order}) to {n} utterances")
    return 0 if n > 0 else 1


if __name__ == "__main__":
    sys.exit(main())
