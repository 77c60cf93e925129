"""Convert CMVN statistics into a feature-transform net, PyTorch edition
of ``kaldi_lstm_tpu.tools.cmvn_to_nnet`` (upstream nnetbin/cmvn-to-nnet):
[2, D+1] double stats (compute-cmvn-stats wire format) become the
AddShift(-mean) + Rescale(std_dev/std) net the recipe feeds to
--feature-transform. A stats TABLE is summed into global stats first; a
plain rxfilename is read as the already-global matrix. The model file is
byte-equal to the JAX tool's.

    python -m kaldi_lstm_tpu_torch.tools.cmvn_to_nnet ark:cmvn.ark \\
        feature_transform.nnet.txt

Host numpy only: the net's two vectors are written from the host.
"""

from __future__ import annotations

import argparse
import sys

import numpy as np
import torch

from kaldi_lstm_tpu_torch.io.kaldi_io import (
    SequentialMatrixReader,
    read_matrix_from_rxfilename,
)
from kaldi_lstm_tpu_torch.models import Nnet
from kaldi_lstm_tpu_torch.models.components import AddShift, Rescale
from kaldi_lstm_tpu_torch.utils import LOG


def main(argv=None) -> int:
    p = argparse.ArgumentParser(
        description="Convert CMVN stats to an AddShift+Rescale nnet")
    p.add_argument("stats_in", help="ark:/scp: stats table (summed) or "
                                    "a global-stats rxfilename")
    p.add_argument("nnet_out")
    p.add_argument("--binary", default="false")
    p.add_argument("--std-dev", type=float, default=1.0,
                   help="target standard deviation (upstream flag)")
    p.add_argument("--var-floor", type=float, default=1e-10)
    args = p.parse_args(argv)

    if args.stats_in.split(",")[0].split(":")[0] in ("ark", "scp"):
        acc = None
        for _, m in SequentialMatrixReader(args.stats_in):
            acc = np.asarray(m, np.float64) if acc is None \
                else acc + np.asarray(m, np.float64)
    else:
        acc = np.asarray(read_matrix_from_rxfilename(args.stats_in),
                         np.float64)
    if acc is None or acc.shape[0] != 2:
        print("cmvn-to-nnet: expected [2, D+1] CMVN stats",
              file=sys.stderr)
        return 1

    count = acc[0, -1]
    if count <= 0:
        print("cmvn-to-nnet: zero frame count in stats", file=sys.stderr)
        return 1
    mean = acc[0, :-1] / count
    var = np.maximum(acc[1, :-1] / count - mean * mean, args.var_floor)
    dim = mean.shape[0]

    nnet = Nnet([AddShift(dim, dim), Rescale(dim, dim)])
    params = ({"shift": torch.tensor(-mean, dtype=torch.float32)},
              {"scale": torch.tensor(args.std_dev / np.sqrt(var),
                                     dtype=torch.float32)})
    nnet.write(args.nnet_out, params,
               binary=str(args.binary).lower() in ("true", "1", "yes"))
    LOG(f"Converted CMVN stats ({count:.0f} frames, dim {dim}) -> "
        f"{args.nnet_out}")
    return 0


if __name__ == "__main__":
    sys.exit(main())
