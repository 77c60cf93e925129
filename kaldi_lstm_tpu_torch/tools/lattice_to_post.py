"""Lattice posteriors — upstream lattice-to-post: per-frame
transition-id posteriors from the lattice forward-backward, written as
a Posterior ark (the input format of upstream's posterior pipeline and
of this framework's trainers after ali-to-post-style conversion).

    python -m kaldi_lstm_tpu_torch.tools.lattice_to_post ark:lat.ark \\
        ark:post.ark --acoustic-scale 0.1
"""

from __future__ import annotations

import argparse
import sys

from kaldi_lstm_tpu_torch.io.kaldi_io import PosteriorWriter
from kaldi_lstm_tpu_torch.io.lattice import (
    SequentialLatticeReader,
    lattice_to_post,
)
from kaldi_lstm_tpu_torch.utils import LOG


def main(argv=None) -> int:
    p = argparse.ArgumentParser(
        description="Per-frame transition-id posteriors from lattices")
    p.add_argument("lattice_rspecifier")
    p.add_argument("post_wspecifier")
    p.add_argument("--acoustic-scale", type=float, default=1.0)
    p.add_argument("--lm-scale", type=float, default=1.0)
    args = p.parse_args(argv)

    n = frames = 0
    with PosteriorWriter(args.post_wspecifier) as w:
        for key, lat in SequentialLatticeReader(args.lattice_rspecifier):
            post = lattice_to_post(lat, args.acoustic_scale,
                                   args.lm_scale)
            w.write(key, post)
            n += 1
            frames += len(post)
    LOG(f"Wrote posteriors for {n} lattices ({frames} frames)")
    return 0 if n > 0 else 1


if __name__ == "__main__":
    sys.exit(main())
