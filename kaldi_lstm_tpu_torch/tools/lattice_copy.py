"""lattice-copy: copy/convert lattice arks (binary <-> text, raw
Lattice <-> CompactLattice) — upstream latbin/lattice-copy.cc:

    python -m kaldi_lstm_tpu_torch.tools.lattice_copy ark:lat.ark ark,t:-
    python -m kaldi_lstm_tpu_torch.tools.lattice_copy --raw ark:in.ark ark:out.ark
"""

from __future__ import annotations

import argparse
import sys

from kaldi_lstm_tpu_torch.io.lattice import (
    LatticeWriter,
    SequentialLatticeReader,
)
from kaldi_lstm_tpu_torch.utils import LOG


def main(argv=None) -> int:
    p = argparse.ArgumentParser(
        description="Copy lattice tables, converting format as needed")
    p.add_argument("lattice_rspecifier")
    p.add_argument("lattice_wspecifier")
    p.add_argument("--raw", action="store_true",
                   help="write state-level Lattices instead of "
                        "CompactLattices")
    args = p.parse_args(argv)

    n = 0
    with LatticeWriter(args.lattice_wspecifier,
                       compact=not args.raw) as w:
        try:
            for key, lat in SequentialLatticeReader(
                    args.lattice_rspecifier):
                w.write(key, lat)
                n += 1
        except (EOFError, ValueError) as e:
            print(f"lattice-copy: error reading "
                  f"{args.lattice_rspecifier!r} after {n} lattices: {e}",
                  file=sys.stderr)
            return 1
    LOG(f"lattice-copy: copied {n} lattices")
    return 0


if __name__ == "__main__":
    sys.exit(main())
