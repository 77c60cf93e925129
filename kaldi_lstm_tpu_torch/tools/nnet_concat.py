"""Concatenate Nnets front-to-back — the `nnet-concat` equivalent (used
upstream to join a feature transform with a trained net), PyTorch edition
of ``kaldi_lstm_tpu.tools.nnet_concat``: the same output bytes.

    python -m kaldi_lstm_tpu_torch.tools.nnet_concat nnet1 nnet2 [...] nnet_out

A host tool: the models are read into CPU memory.
"""

from __future__ import annotations

import argparse
import sys

from kaldi_lstm_tpu_torch.models import Nnet
from kaldi_lstm_tpu_torch.utils import LOG


def main(argv=None) -> int:
    p = argparse.ArgumentParser(description="Concatenate Neural Networks")
    p.add_argument("models", nargs="+",
                   help="two or more input models, then the output model")
    p.add_argument("--binary", default="true")
    args = p.parse_args(argv)
    if len(args.models) < 3:
        print("error: need at least 2 inputs and 1 output",
              file=sys.stderr)
        return 1

    *inputs, out_path = args.models
    combined = Nnet()
    params = []
    for path in inputs:
        nnet, pp = Nnet.read(path)
        if combined.components and \
                combined.output_dim != nnet.input_dim:
            print(f"error: dim mismatch joining {path}: "
                  f"{combined.output_dim} -> {nnet.input_dim}",
                  file=sys.stderr)
            return 1
        combined.components.extend(nnet.components)
        params.extend(pp)

    combined.write(out_path, tuple(params),
                   binary=str(args.binary).lower() in ("true", "1", "yes"))
    LOG(f"Written concatenated model ({len(combined)} components) to "
        f"{out_path}")
    return 0


if __name__ == "__main__":
    sys.exit(main())
