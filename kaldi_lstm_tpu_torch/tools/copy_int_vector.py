"""Copy integer-vector tables (alignments) — upstream copy-int-vector:
binary<->text conversion and inspection of ali.ark files.

    python -m kaldi_lstm_tpu_torch.tools.copy_int_vector ark:ali.ark ark,t:-

This package's copy of ``kaldi_lstm_tpu.tools.copy_int_vector``: host
code on the port's io/kaldi_io.py, the same arguments, log lines and
output bytes.
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
    write_int_vector,
)
from kaldi_lstm_tpu_torch.utils import LOG


def main(argv=None) -> int:
    p = argparse.ArgumentParser(
        description="Copy integer-vector tables (e.g. alignments)")
    p.add_argument("rspecifier")
    p.add_argument("wspecifier")
    p.add_argument("--binary", default="true",
                   help="false = text output (ark,t: also works)")
    args = p.parse_args(argv)

    kind, stream = _open_rspecifier(args.rspecifier)
    if kind != "ark":
        print("copy-int-vector: only ark: input supported",
              file=sys.stderr)
        return 1
    buffered = stream if isinstance(stream, io.BufferedReader) \
        else io.BufferedReader(stream)

    binary = str(args.binary).lower() in ("true", "1", "yes")
    n = 0
    with TableWriter(args.wspecifier, write_int_vector,
                     binary=binary) as w:
        while True:
            key = _read_key(buffered)
            if key is None:
                break
            w.write(key, read_int_vector(_read_value_header(buffered)))
            n += 1
    LOG(f"Copied {n} integer vectors")
    return 0 if n > 0 else 1


if __name__ == "__main__":
    sys.exit(main())
