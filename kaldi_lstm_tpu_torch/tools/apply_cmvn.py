"""Apply cepstral mean (and optionally variance) normalization —
upstream featbin/apply-cmvn, consuming compute_cmvn_stats output
(per-utterance, or per-speaker through an utt2spk map). The table-level
counterpart of the reference recipe's CMVN feature-transform net
(google/feature_transform.nnet.txt: AddShift(-mean) + Rescale(1/std)).

    python -m kaldi_lstm_tpu_torch.tools.apply_cmvn --utt2spk=ark:utt2spk \\
        scp:cmvn.scp scp:feats.scp ark:feats_norm.ark

This package's copy of ``kaldi_lstm_tpu.tools.apply_cmvn``: host numpy
on the port's io/kaldi_io.py, the same arguments, log lines and output
bytes.
"""

from __future__ import annotations

import argparse
import sys

import numpy as np

from kaldi_lstm_tpu_torch.io.kaldi_io import (
    MatrixWriter,
    SequentialMatrixReader,
)
from kaldi_lstm_tpu_torch.tools.compute_cmvn_stats import (
    _strip_rspec,
    read_utt2spk,
)
from kaldi_lstm_tpu_torch.utils import LOG, WARN


def _bool(s):
    # the JAX tool takes this from nnet_train_mmi; a copy here keeps the
    # host tool from loading the sequence trainer
    return str(s).lower() in ("true", "1", "yes")


def apply_cmvn(feats: np.ndarray, stats: np.ndarray,
               norm_vars: bool = False,
               var_floor: float = 1e-10) -> np.ndarray:
    """Normalize [T, D] features with [2, D+1] stats (double)."""
    D = feats.shape[1]
    if stats.shape != (2, D + 1):
        raise ValueError(f"CMVN stats shape {stats.shape} does not match "
                         f"feature dim {D}")
    count = stats[0, D]
    if count < 1.0:
        raise ValueError("CMVN stats have zero frame count")
    mean = stats[0, :D] / count
    out = np.asarray(feats, np.float64) - mean
    if norm_vars:
        var = np.maximum(stats[1, :D] / count - mean * mean, var_floor)
        out /= np.sqrt(var)
    return out.astype(np.float32)


def main(argv=None) -> int:
    p = argparse.ArgumentParser(
        description="Apply cepstral mean and variance normalization")
    p.add_argument("cmvn_rspecifier")
    p.add_argument("feature_rspecifier")
    p.add_argument("feature_wspecifier")
    p.add_argument("--utt2spk", default="",
                   help="utterance to speaker map (stats keyed by "
                        "speaker)")
    p.add_argument("--norm-vars", default="false",
                   help="normalize variances too")
    p.add_argument("--reverse", default="false",
                   help="un-normalize instead (upstream flag)")
    args = p.parse_args(argv)
    norm_vars = _bool(args.norm_vars)
    reverse = _bool(args.reverse)

    stats = dict(SequentialMatrixReader(args.cmvn_rspecifier))
    utt2spk = (read_utt2spk(_strip_rspec(args.utt2spk))
               if args.utt2spk else None)

    num_done = num_err = 0
    with MatrixWriter(args.feature_wspecifier) as w:
        for key, feats in SequentialMatrixReader(args.feature_rspecifier):
            skey = utt2spk.get(key, key) if utt2spk is not None else key
            if skey not in stats:
                WARN(f"no CMVN stats for {'speaker' if utt2spk else 'utt'}"
                     f" {skey}")
                num_err += 1
                continue
            st = np.asarray(stats[skey], np.float64)
            if reverse:
                D = feats.shape[1]
                count = st[0, D]
                mean = st[0, :D] / count
                x = np.asarray(feats, np.float64)
                if norm_vars:
                    var = np.maximum(st[1, :D] / count - mean * mean,
                                     1e-10)
                    x = x * np.sqrt(var)
                out = (x + mean).astype(np.float32)
            else:
                out = apply_cmvn(feats, st, norm_vars)
            w.write(key, out)
            num_done += 1
    LOG(f"Applied cepstral mean {'and variance ' if norm_vars else ''}"
        f"normalization to {num_done} utterances, errors on {num_err}")
    return 0 if num_done > 0 else 1


if __name__ == "__main__":
    sys.exit(main())
