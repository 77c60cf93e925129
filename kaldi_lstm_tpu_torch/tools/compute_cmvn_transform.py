"""Estimate a CMVN feature transform from data: a 2-component
AddShift(-mean) + Rescale(1/std) net in Kaldi text format — the
feature_transform.nnet.txt of the reference recipe
(google/feature_transform.nnet.txt, train_lstm_streams.sh:45).

    python -m kaldi_lstm_tpu_torch.tools.compute_cmvn_transform \\
        scp:feats.scp feature_transform.nnet.txt

This package's copy of ``kaldi_lstm_tpu.tools.compute_cmvn_transform``:
the statistics in host numpy (float64), the two vectors cast to float32
tensors on the host and written by the port's own ``Nnet.write``, so the
file is byte-equal to the JAX tool's in binary and in text.
"""

from __future__ import annotations

import argparse
import sys

import numpy as np
import torch

from kaldi_lstm_tpu_torch.io.kaldi_io import SequentialMatrixReader
from kaldi_lstm_tpu_torch.models import Nnet
from kaldi_lstm_tpu_torch.models.components import AddShift, Rescale
from kaldi_lstm_tpu_torch.utils import LOG


def main(argv=None) -> int:
    p = argparse.ArgumentParser(description="Compute per-dim CMVN and "
                                "write it as an AddShift+Rescale nnet")
    p.add_argument("feature_rspecifier")
    p.add_argument("transform_out")
    p.add_argument("--binary", default="false")
    p.add_argument("--var-floor", type=float, default=1e-10)
    args = p.parse_args(argv)

    n = 0
    s = s2 = None
    dim = None
    for key, feats in SequentialMatrixReader(args.feature_rspecifier):
        f = np.asarray(feats, np.float64)
        if s is None:
            dim = f.shape[1]
            s = np.zeros(dim)
            s2 = np.zeros(dim)
        s += f.sum(0)
        s2 += (f * f).sum(0)
        n += f.shape[0]
    if n == 0:
        print("error: no features read", file=sys.stderr)
        return 1

    mean = s / n
    var = np.maximum(s2 / n - mean * mean, args.var_floor)
    nnet = Nnet([AddShift(dim, dim), Rescale(dim, dim)])
    params = ({"shift": torch.tensor(-mean, dtype=torch.float32)},
              {"scale": torch.tensor(1.0 / np.sqrt(var),
                                     dtype=torch.float32)})
    nnet.write(args.transform_out, params,
               binary=str(args.binary).lower() in ("true", "1", "yes"))
    LOG(f"Computed CMVN over {n} frames, dim {dim} -> "
        f"{args.transform_out}")
    return 0


if __name__ == "__main__":
    sys.exit(main())
