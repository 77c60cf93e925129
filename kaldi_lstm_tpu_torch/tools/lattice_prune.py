"""Prune lattices by beam — upstream lattice-prune: drop every arc and
state not on some complete path within `--beam` of the best path
(forward/backward cost margins).

    python -m kaldi_lstm_tpu_torch.tools.lattice_prune ark:in.ark \\
        ark:out.ark --beam 4
"""

from __future__ import annotations

import argparse
import sys

from kaldi_lstm_tpu_torch.io.lattice import (
    LatticeWriter,
    SequentialLatticeReader,
    lattice_prune,
)
from kaldi_lstm_tpu_torch.utils import LOG


def main(argv=None) -> int:
    p = argparse.ArgumentParser(description="Beam-prune lattices")
    p.add_argument("lattice_rspecifier")
    p.add_argument("lattice_wspecifier")
    p.add_argument("--beam", type=float, default=4.0)
    args = p.parse_args(argv)

    n = 0
    arcs_in = arcs_out = 0
    with LatticeWriter(args.lattice_wspecifier) as w:
        for key, lat in SequentialLatticeReader(args.lattice_rspecifier):
            pruned = lattice_prune(lat, args.beam)
            arcs_in += lat.num_arcs()
            arcs_out += pruned.num_arcs()
            w.write(key, pruned)
            n += 1
    LOG(f"Pruned {n} lattices at beam {args.beam}: "
        f"{arcs_in} -> {arcs_out} arcs")
    return 0 if n > 0 else 1


if __name__ == "__main__":
    sys.exit(main())
