"""Per-utterance / per-speaker CMVN statistics — upstream
featbin/compute-cmvn-stats. The reference recipe normalizes features
with a CMVN feature-transform net (google/feature_transform.nnet.txt);
upstream pipelines instead carry [2, D+1] double stats per utterance
or speaker (row 0 = sum(x) with the frame count in the last column,
row 1 = sum(x^2)) consumed by apply-cmvn. This tool writes that wire
format so existing Kaldi data directories keep working.

    python -m kaldi_lstm_tpu_torch.tools.compute_cmvn_stats \\
        [--spk2utt=ark:spk2utt] scp:feats.scp ark,scp:cmvn.ark,cmvn.scp

This package's copy of ``kaldi_lstm_tpu.tools.compute_cmvn_stats``: host
numpy on the port's io/kaldi_io.py, the same arguments, log lines and
output bytes.
"""

from __future__ import annotations

import argparse
import sys

import numpy as np

from kaldi_lstm_tpu_torch.io.kaldi_io import (
    MatrixWriter,
    SequentialMatrixReader,
)
from kaldi_lstm_tpu_torch.utils import LOG, WARN


def read_spk2utt(path: str) -> dict[str, list[str]]:
    out = {}
    with open(path) as f:
        for line in f:
            parts = line.split()
            if parts:
                out[parts[0]] = parts[1:]
    return out


def read_utt2spk(path: str) -> dict[str, str]:
    out = {}
    with open(path) as f:
        for line in f:
            parts = line.split()
            if len(parts) == 2:
                out[parts[0]] = parts[1]
    return out


def _strip_rspec(arg: str) -> str:
    """Accept both 'ark:file' and plain 'file' for the text maps."""
    return arg.split(":", 1)[1] if ":" in arg else arg


def stats_of(feats: np.ndarray) -> np.ndarray:
    f = np.asarray(feats, np.float64)
    T, D = f.shape
    st = np.zeros((2, D + 1), np.float64)
    st[0, :D] = f.sum(0)
    st[0, D] = T
    st[1, :D] = (f * f).sum(0)
    return st


def main(argv=None) -> int:
    p = argparse.ArgumentParser(
        description="Compute cepstral mean and variance normalization "
                    "statistics")
    p.add_argument("feature_rspecifier")
    p.add_argument("stats_wspecifier")
    p.add_argument("--spk2utt", default="",
                   help="speaker to utterance-list map; stats are then "
                        "per speaker")
    args = p.parse_args(argv)

    num_done = num_err = 0
    if args.spk2utt:
        spk2utt = read_spk2utt(_strip_rspec(args.spk2utt))
        utt2spk = {u: s for s, us in spk2utt.items() for u in us}
        acc: dict[str, np.ndarray] = {}
        for key, feats in SequentialMatrixReader(args.feature_rspecifier):
            spk = utt2spk.get(key)
            if spk is None:
                WARN(f"{key} not present in spk2utt map")
                num_err += 1
                continue
            st = stats_of(feats)
            if spk in acc:
                acc[spk] += st
            else:
                acc[spk] = st
            num_done += 1
        with MatrixWriter(args.stats_wspecifier) as w:
            # preserve spk2utt order, like upstream's TokenVectorReader
            for spk in spk2utt:
                if spk in acc:
                    w.write(spk, acc[spk])
    else:
        with MatrixWriter(args.stats_wspecifier) as w:
            for key, feats in SequentialMatrixReader(
                    args.feature_rspecifier):
                w.write(key, stats_of(feats))
                num_done += 1
    LOG(f"Done accumulating CMVN stats for {num_done} utterances; "
        f"{num_err} had errors.")
    return 0 if num_done > 0 else 1


if __name__ == "__main__":
    sys.exit(main())
