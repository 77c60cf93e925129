"""Sum two posterior tables frame-by-frame — upstream sum-post
(bin/sum-post.cc): per frame the (id, weight) lists are concatenated
with optional per-table scales; --merge sums duplicate ids into one
entry (the default, like upstream MergePosteriors). Used e.g. to
interpolate numerator/denominator statistics in sequence-training
recipes.

    python -m kaldi_lstm_tpu_torch.tools.sum_post --scale1 0.5 \\
        --scale2 0.5 ark:a.ark ark:b.ark ark:avg.ark

This package's copy of ``kaldi_lstm_tpu.tools.sum_post``: host code on
the port's io/kaldi_io.py, the same arguments, log lines and output
bytes.
"""

from __future__ import annotations

import argparse
import sys

from kaldi_lstm_tpu_torch.io.kaldi_io import (
    PosteriorWriter,
    RandomAccessPosteriorReader,
    SequentialPosteriorReader,
)
from kaldi_lstm_tpu_torch.utils import LOG, WARN


def merge_frame(entries, merge: bool):
    if not merge:
        return entries
    acc: dict[int, float] = {}
    for i, w in entries:
        acc[i] = acc.get(i, 0.0) + w
    return list(acc.items())


def main(argv=None) -> int:
    p = argparse.ArgumentParser(description="Sum two posterior tables")
    p.add_argument("post1_rspecifier")
    p.add_argument("post2_rspecifier")
    p.add_argument("post_wspecifier")
    p.add_argument("--scale1", type=float, default=1.0)
    p.add_argument("--scale2", type=float, default=1.0)
    p.add_argument("--merge", default="true",
                   help="sum weights of duplicated pdf-ids per frame")
    p.add_argument("--zero-if-disjoint", default="false",
                   help="zero the frame if the two posteriors have no "
                        "pdf in common (upstream flag)")
    args = p.parse_args(argv)
    merge = str(args.merge).lower() in ("true", "1", "yes")
    zero_disjoint = str(args.zero_if_disjoint).lower() in \
        ("true", "1", "yes")

    # full fidelity: every entry of every frame, ark: read whole,
    # scp: lazily by offset
    post2 = RandomAccessPosteriorReader(args.post2_rspecifier)
    n_done = n_err = 0
    with PosteriorWriter(args.post_wspecifier) as w:
        for key, p1 in SequentialPosteriorReader(args.post1_rspecifier):
            if not post2.has_key(key):
                WARN(f"sum-post: no record for {key} in second table")
                n_err += 1
                continue
            p2 = post2.value(key)
            if len(p1) != len(p2):
                WARN(f"sum-post: length mismatch for {key}: "
                     f"{len(p1)} vs {len(p2)}")
                n_err += 1
                continue
            out = []
            for f1, f2 in zip(p1, p2):
                ent = ([(i, args.scale1 * wt) for i, wt in f1]
                       + [(i, args.scale2 * wt) for i, wt in f2])
                if zero_disjoint and not (
                        {i for i, _ in f1} & {i for i, _ in f2}):
                    ent = []
                out.append(merge_frame(ent, merge))
            w.write(key, out)
            n_done += 1
    LOG(f"Summed posteriors for {n_done} utterances; {n_err} errors")
    return 0 if n_done > 0 else 1


if __name__ == "__main__":
    sys.exit(main())
