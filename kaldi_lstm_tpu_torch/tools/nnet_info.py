"""Print a model summary — the `nnet-info` equivalent (component list,
dims, parameter counts, tensor moment statistics), PyTorch edition of
``kaldi_lstm_tpu.tools.nnet_info`` with the same output.

    python -m kaldi_lstm_tpu_torch.tools.nnet_info nnet.final

A host tool: the model is read into CPU memory.
"""

from __future__ import annotations

import argparse
import sys

from kaldi_lstm_tpu_torch.models import Nnet


def main(argv=None) -> int:
    p = argparse.ArgumentParser(description="Print human-readable "
                                "information about a model")
    p.add_argument("model_in")
    args = p.parse_args(argv)
    nnet, params = Nnet.read(args.model_in)
    print(nnet.info(params))
    return 0


if __name__ == "__main__":
    sys.exit(main())
