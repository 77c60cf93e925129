"""Determinize lattices — upstream lattice-determinize-pruned: keep,
for every word sequence, only the best-scoring path with its
transition-id alignment; output is a deterministic, epsilon-free
CompactLattice ark.

    python -m kaldi_lstm_tpu_torch.tools.lattice_determinize \\
        ark:raw.ark ark:det.ark [--max-states N]
"""

from __future__ import annotations

import argparse
import sys

from kaldi_lstm_tpu_torch.decode.determinize import (
    DeterminizeError,
    determinize_lattice,
)
from kaldi_lstm_tpu_torch.io.lattice import (
    CompactLattice,
    LatticeWriter,
    SequentialLatticeReader,
    compact_to_lattice,
)
from kaldi_lstm_tpu_torch.utils import LOG


def main(argv=None) -> int:
    p = argparse.ArgumentParser(
        description="Determinize lattices (one best path per word "
                    "sequence; epsilon-free CompactLattice output)")
    p.add_argument("lattice_rspecifier")
    p.add_argument("lattice_wspecifier")
    p.add_argument("--max-states", type=int, default=200000,
                   help="abort one lattice if the subset construction "
                        "exceeds this many output states")
    args = p.parse_args(argv)

    n = failed = 0
    with LatticeWriter(args.lattice_wspecifier) as w:
        for key, lat in SequentialLatticeReader(args.lattice_rspecifier):
            if isinstance(lat, CompactLattice):
                lat = compact_to_lattice(lat)
            try:
                w.write(key, determinize_lattice(
                    lat, max_states=args.max_states))
                n += 1
            except DeterminizeError as e:
                LOG(f"WARNING: {key}: {e}; skipping")
                failed += 1
    LOG(f"Determinized {n} lattices"
        + (f", {failed} failed" if failed else ""))
    return 0 if n > 0 or failed == 0 else 1


if __name__ == "__main__":
    sys.exit(main())
