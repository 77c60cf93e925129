"""Scale posterior weights — upstream scale-post (bin/scale-post.cc):
the scale is a global float or a per-utterance scalar BaseFloat table
(upstream's form); additionally a float-VECTOR table gives per-frame
scales. Posterior-weighted gradient shaping for sequence-training
recipes.

    python -m kaldi_lstm_tpu_torch.tools.scale_post ark:post.ark 0.5 \\
        ark:scaled.ark
    python -m kaldi_lstm_tpu_torch.tools.scale_post ark:post.ark \\
        ark:utt_scales.ark ark:scaled.ark

This package's copy of ``kaldi_lstm_tpu.tools.scale_post``: host code on
the port's io/kaldi_io.py, the same arguments, log lines and output
bytes.
"""

from __future__ import annotations

import argparse
import io
import sys

import numpy as np

from kaldi_lstm_tpu_torch.io.kaldi_io import (
    PosteriorWriter,
    SequentialPosteriorReader,
    _open_rspecifier,
    _read_key,
    _read_value_header,
    peek_token,
    read_float,
    read_vector,
)
from kaldi_lstm_tpu_torch.utils import LOG, WARN


def read_scale_table(rspecifier: str) -> dict:
    """key -> float (upstream scalar BaseFloat table) or [T] np array
    (per-frame vector table); the two record kinds may even be mixed."""
    kind, stream = _open_rspecifier(rspecifier)
    if kind != "ark":
        raise ValueError("scale table: only ark: supported")
    buffered = stream if isinstance(stream, io.BufferedReader) \
        else io.BufferedReader(stream)
    out: dict = {}
    while True:
        key = _read_key(buffered)
        if key is None:
            return out
        inp = _read_value_header(buffered)
        # binary: FV/DV marker = vector, else scalar; text: '[' = vector
        tok = peek_token(buffered)
        if tok in ("FV", "DV", "["):
            out[key] = read_vector(inp)
        else:
            out[key] = read_float(inp)


def main(argv=None) -> int:
    p = argparse.ArgumentParser(description="Scale posteriors")
    p.add_argument("post_rspecifier")
    p.add_argument("scale", help="float, or ark: table of per-utterance "
                                 "scalars / per-frame float vectors")
    p.add_argument("post_wspecifier")
    args = p.parse_args(argv)

    table = None
    try:
        global_scale = float(args.scale)
    except ValueError:
        global_scale = None
        table = read_scale_table(args.scale)

    n_done = n_err = 0
    with PosteriorWriter(args.post_wspecifier) as w:
        for key, post in SequentialPosteriorReader(args.post_rspecifier):
            if table is None:
                scales = [global_scale] * len(post)
            else:
                if key not in table:
                    WARN(f"scale-post: no scale for {key}")
                    n_err += 1
                    continue
                s = table[key]
                if isinstance(s, float):
                    scales = [s] * len(post)
                else:
                    scales = np.asarray(s)
                    if len(scales) != len(post):
                        WARN(f"scale-post: scale length mismatch for "
                             f"{key}")
                        n_err += 1
                        continue
            w.write(key, [[(i, wt * float(s)) for i, wt in frame]
                          for frame, s in zip(post, scales)])
            n_done += 1
    LOG(f"Scaled {n_done} posteriors; {n_err} errors")
    return 0 if n_done > 0 else 1


if __name__ == "__main__":
    sys.exit(main())
