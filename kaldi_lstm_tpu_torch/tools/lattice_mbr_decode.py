"""MBR (consensus) decoding CLI — upstream lattice-mbr-decode: output
the hypothesis minimizing expected word errors under the lattice
posterior, with per-word confidences.

    python -m kaldi_lstm_tpu_torch.tools.lattice_mbr_decode ark:lat.ark \\
        ark,t:hyp.txt --word-symbol-table words.txt \\
        [--confidence-wspecifier ark,t:conf.txt] [--nbest 50]
"""

from __future__ import annotations

import argparse
import sys

from kaldi_lstm_tpu_torch.decode.mbr import mbr_decode
from kaldi_lstm_tpu_torch.io.kaldi_io import TableWriter
from kaldi_lstm_tpu_torch.io.lang import SymbolTable, write_text_line
from kaldi_lstm_tpu_torch.io.lattice import SequentialLatticeReader
from kaldi_lstm_tpu_torch.utils import LOG


def main(argv=None) -> int:
    p = argparse.ArgumentParser(
        description="Minimum-Bayes-risk decoding with word confidences")
    p.add_argument("lattice_rspecifier")
    p.add_argument("trans_wspecifier")
    p.add_argument("--word-symbol-table", default="")
    p.add_argument("--confidence-wspecifier", default="",
                   help="also write per-word confidences")
    p.add_argument("--nbest", type=int, default=50,
                   help="hypothesis-space head size")
    args = p.parse_args(argv)

    words = (SymbolTable.load(args.word_symbol_table)
             if args.word_symbol_table else None)
    cw = (TableWriter(args.confidence_wspecifier, write_text_line,
                      binary=False) if args.confidence_wspecifier
          else None)
    n = 0
    tot_exp = tot_map = tot_words = 0.0
    with TableWriter(args.trans_wspecifier, write_text_line,
                     binary=False) as tw:
        for key, lat in SequentialLatticeReader(args.lattice_rspecifier):
            res = mbr_decode(lat, nbest=args.nbest)
            tw.write(key, [words.id2sym[i] for i in res.words]
                     if words is not None else res.words)
            if cw is not None:
                cw.write(key, [f"{c:.4f}" for c in res.confidences])
            n += 1
            tot_exp += res.expected_errors
            tot_map += res.map_expected_errors
            tot_words += max(len(res.words), 1)
    if cw is not None:
        cw.close()
    LOG(f"MBR-decoded {n} lattices; expected WER "
        f"{100 * tot_exp / max(tot_words, 1):.2f}% "
        f"(MAP baseline {100 * tot_map / max(tot_words, 1):.2f}%)")
    return 0 if n > 0 else 1


if __name__ == "__main__":
    sys.exit(main())
