"""Best path -> CTM (time-marked conversation) output — the
`lattice-1best | nbest-to-ctm` production flow (latbin/nbest-to-ctm.cc):
one line `<utt> <channel> <start-s> <duration-s> <word>` per hypothesis
word. Word times come from the per-arc transition-id alignments, exact
for determinized lattices (latgen's default — each CompactLattice arc
carries one word plus that word's own alignment).

    python -m kaldi_lstm_tpu_torch.tools.lattice_to_ctm ark:lat.ark out.ctm \\
        --word-symbol-table words.txt --frame-shift 0.01
"""

from __future__ import annotations

import argparse
import sys

from kaldi_lstm_tpu_torch.io.lang import SymbolTable
from kaldi_lstm_tpu_torch.io.lattice import (
    SequentialLatticeReader,
    best_path_word_segments,
    lattice_scale,
)
from kaldi_lstm_tpu_torch.utils import LOG, WARN


def main(argv=None) -> int:
    p = argparse.ArgumentParser(
        description="Write best-path word timings as CTM")
    p.add_argument("lattice_rspecifier")
    p.add_argument("ctm_wxfilename", help="output CTM file ('-' = stdout)")
    p.add_argument("--word-symbol-table", default="",
                   help="words.txt (omit to print integer word ids)")
    p.add_argument("--channel", default="1",
                   help="channel field written to every line")
    p.add_argument("--frame-shift", type=float, default=0.01,
                   help="seconds per frame (upstream --frame-shift)")
    p.add_argument("--lm-scale", type=float, default=1.0)
    p.add_argument("--acoustic-scale", type=float, default=1.0)
    p.add_argument("--precision", type=int, default=2,
                   help="decimal places for times (upstream default 2)")
    args = p.parse_args(argv)

    syms = (SymbolTable.load(args.word_symbol_table)
            if args.word_symbol_table else None)
    out = sys.stdout if args.ctm_wxfilename == "-" \
        else open(args.ctm_wxfilename, "w")
    fs, prec = args.frame_shift, args.precision
    n = failed = words = 0
    try:
        for key, lat in SequentialLatticeReader(args.lattice_rspecifier):
            if args.lm_scale != 1.0 or args.acoustic_scale != 1.0:
                lattice_scale(lat, args.lm_scale, args.acoustic_scale)
            try:
                segs, _ = best_path_word_segments(lat)
            except ValueError as e:
                WARN(f"lattice-to-ctm: {key}: {e}")
                failed += 1
                continue
            for wid, start, dur in segs:
                w = syms.id2sym.get(wid, str(wid)) if syms else str(wid)
                out.write(f"{key} {args.channel} "
                          f"{start * fs:.{prec}f} {dur * fs:.{prec}f} "
                          f"{w}\n")
                words += 1
            n += 1
    finally:
        if out is not sys.stdout:
            out.close()
    LOG(f"Wrote CTM for {n} lattices ({words} words); {failed} failed")
    return 0 if n > 0 else 1


if __name__ == "__main__":
    sys.exit(main())
