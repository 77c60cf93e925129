"""lattice-best-path: read a lattice ark, write best-path transcripts
(and optionally alignments), with LM/acoustic rescaling — upstream
latbin/lattice-best-path.cc semantics:

    python -m kaldi_lstm_tpu_torch.tools.lattice_best_path ark:lat.ark \\
        ark,t:hyp.txt --alignment-wspecifier=ark,t:ali.txt \\
        --lm-scale=1.0 --acoustic-scale=1.0
"""

from __future__ import annotations

import argparse
import sys

from kaldi_lstm_tpu_torch.io.kaldi_io import TableWriter
from kaldi_lstm_tpu_torch.io.lang import write_text_line, SymbolTable
from kaldi_lstm_tpu_torch.io.lattice import (
    SequentialLatticeReader,
    lattice_best_path,
    lattice_nbest,
    lattice_scale,
)
from kaldi_lstm_tpu_torch.utils import LOG


def main(argv=None) -> int:
    p = argparse.ArgumentParser(
        description="Best path through lattices -> transcriptions "
                    "(+ optional transition-id alignments)")
    p.add_argument("lattice_rspecifier")
    p.add_argument("transcript_wspecifier")
    p.add_argument("--alignment-wspecifier", default="")
    p.add_argument("--word-symbol-table", default="")
    p.add_argument("--lm-scale", type=float, default=1.0)
    p.add_argument("--acoustic-scale", type=float, default=1.0)
    p.add_argument("--nbest", type=int, default=1,
                   help="N>1 writes the N best paths per utterance under "
                        "keys <utt>-1 .. <utt>-N (lattice-to-nbest style)")
    args = p.parse_args(argv)

    syms = (SymbolTable.load(args.word_symbol_table)
            if args.word_symbol_table else None)
    aw = None
    if args.alignment_wspecifier:
        aw = TableWriter(args.alignment_wspecifier, write_text_line,
                         binary=False)
    n, failed, total_cost = 0, 0, 0.0
    with TableWriter(args.transcript_wspecifier, write_text_line,
                     binary=False) as tw:
        try:
            for key, lat in SequentialLatticeReader(
                    args.lattice_rspecifier):
                if args.lm_scale != 1.0 or args.acoustic_scale != 1.0:
                    lattice_scale(lat, args.lm_scale,
                                  args.acoustic_scale)
                try:
                    if args.nbest > 1:
                        paths = lattice_nbest(lat, args.nbest)
                    else:
                        paths = [lattice_best_path(lat)]
                except ValueError as e:
                    print(f"lattice_best_path: {key}: {e}",
                          file=sys.stderr)
                    failed += 1
                    continue
                for k, (words, tids, cost) in enumerate(paths):
                    okey = key if args.nbest == 1 else f"{key}-{k + 1}"
                    tw.write(okey, [syms.id2sym[i] for i in words]
                             if syms else words)
                    if aw is not None:
                        aw.write(okey, tids)
                n += 1
                total_cost += paths[0][2]
        except (EOFError, ValueError) as e:
            print(f"lattice_best_path: error reading "
                  f"{args.lattice_rspecifier!r} after {n} lattices: {e}",
                  file=sys.stderr)
            return 1
    if aw is not None:
        aw.close()
    LOG(f"lattice-best-path: {n} done, {failed} failed; "
        f"total cost {total_cost:.2f}")
    return 0 if n > 0 or failed == 0 else 1


if __name__ == "__main__":
    sys.exit(main())
