"""Turn posteriors into per-frame weights — upstream
bin/post-to-weights: each frame's weight is the sum of its posterior
entries. Combined with weight_silence_post this produces the
--frame-weights input of the frame-shuffled trainer
(tools/nnet_train_frmshuff.py), the upstream recipe for excluding or
down-weighting silence frames.

    python -m kaldi_lstm_tpu_torch.tools.post_to_weights \\
        ark:post.ark ark:weights.ark

This package's copy of ``kaldi_lstm_tpu.tools.post_to_weights``: host
code on the port's io/kaldi_io.py, the same arguments, log lines and
output bytes.
"""

from __future__ import annotations

import argparse
import io
import sys

import numpy as np

from kaldi_lstm_tpu_torch.io.kaldi_io import (
    TableWriter,
    _open_rspecifier,
    _read_key,
    _read_value_header,
    read_posterior,
    write_vector,
)
from kaldi_lstm_tpu_torch.utils import LOG


def main(argv=None) -> int:
    p = argparse.ArgumentParser(
        description="Turn posteriors into per-frame weights")
    p.add_argument("post_rspecifier")
    p.add_argument("weights_wspecifier")
    args = p.parse_args(argv)

    kind, stream = _open_rspecifier(args.post_rspecifier)
    if kind != "ark":
        print("post_to_weights: only ark: input supported",
              file=sys.stderr)
        return 1
    buffered = stream if isinstance(stream, io.BufferedReader) \
        else io.BufferedReader(stream)

    n = 0
    with TableWriter(args.weights_wspecifier, write_vector) as w:
        while True:
            key = _read_key(buffered)
            if key is None:
                break
            post = read_posterior(_read_value_header(buffered))
            w.write(key, np.asarray(
                [sum(wt for _i, wt in frame) for frame in post],
                np.float32))
            n += 1
    LOG(f"Done {n} posteriors")
    return 0


if __name__ == "__main__":
    sys.exit(main())
