"""Convert integer alignments to 1-best posteriors — the `ali-to-post`
stage of the target pipeline (train_lstm_streams.sh:36:
`ali-to-pdf ... | ali-to-post ark:- ark:-`). Pdf-level alignments map
directly; weight 1.0 per frame.

    python -m kaldi_lstm_tpu_torch.tools.ali_to_post ark:ali.ark ark:post.ark

This package's copy of ``kaldi_lstm_tpu.tools.ali_to_post``: host code
on the port's io/kaldi_io.py, the same arguments, log lines and output
bytes.
"""

from __future__ import annotations

import argparse
import io
import sys

from kaldi_lstm_tpu_torch.io.kaldi_io import (
    TableWriter,
    _open_rspecifier,
    _read_key,
    _read_value_header,
    read_int_vector,
    write_posterior,
)
from kaldi_lstm_tpu_torch.utils import LOG


def main(argv=None) -> int:
    p = argparse.ArgumentParser(description="Convert alignments to "
                                "per-frame 1-best posteriors")
    p.add_argument("ali_rspecifier")
    p.add_argument("post_wspecifier")
    args = p.parse_args(argv)

    kind, stream = _open_rspecifier(args.ali_rspecifier)
    if kind != "ark":
        print("ali_to_post: only ark: input supported", file=sys.stderr)
        return 1
    buffered = stream if isinstance(stream, io.BufferedReader) \
        else io.BufferedReader(stream)

    n = 0
    with TableWriter(args.post_wspecifier, write_posterior) as w:
        while True:
            key = _read_key(buffered)
            if key is None:
                break
            inp = _read_value_header(buffered)
            ali = read_int_vector(inp)
            w.write(key, [[(int(a), 1.0)] for a in ali])
            n += 1
    LOG(f"Converted {n} alignments to posteriors")
    return 0


if __name__ == "__main__":
    sys.exit(main())
