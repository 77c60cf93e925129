"""LM-rescore lattices — upstream lattice-lmrescore: swap the language
model baked into decoding lattices for a different ARPA LM without
re-decoding (the main production use of lattices: decode once with a
small LM, rescore with a big one).

    python -m kaldi_lstm_tpu_torch.tools.lattice_lmrescore ark:lat.ark \\
        old_lm.arpa new_lm.arpa ark:rescored.ark \\
        --word-symbol-table words.txt

Pass "none" for old_lm when the lattice was decoded with the uniform
unigram grammar (latgen's arpa="none"), or --no-subtract to only ADD
the new LM.
"""

from __future__ import annotations

import argparse
import sys

from kaldi_lstm_tpu_torch.io.arpa import ArpaLM, uniform_unigram
from kaldi_lstm_tpu_torch.io.lang import SymbolTable
from kaldi_lstm_tpu_torch.io.lattice import (
    LatticeWriter,
    SequentialLatticeReader,
    lattice_lmrescore,
)
from kaldi_lstm_tpu_torch.utils import LOG


def main(argv=None) -> int:
    p = argparse.ArgumentParser(
        description="Replace lattice LM scores with a different ARPA LM")
    p.add_argument("lattice_rspecifier")
    p.add_argument("old_arpa", help='the LM the lattices were decoded '
                                    'with, or "none" (uniform unigram)')
    p.add_argument("new_arpa")
    p.add_argument("lattice_wspecifier")
    p.add_argument("--word-symbol-table", required=True)
    p.add_argument("--no-subtract", action="store_true",
                   help="only add the new LM (old scores kept)")
    p.add_argument("--lexicon", default="",
                   help='with old_arpa="none": the lexicon latgen was '
                        "run with, so the uniform grammar is rebuilt "
                        "over exactly the same vocabulary")
    args = p.parse_args(argv)

    words = SymbolTable.load(args.word_symbol_table)
    old_lm = None
    if not args.no_subtract:
        if args.old_arpa == "none":
            if args.lexicon:
                from kaldi_lstm_tpu_torch.io.lang import read_lexicon
                vocab = sorted(read_lexicon(args.lexicon))
            else:
                # filter symbol-table specials; exact only when
                # words.txt covers precisely the lexicon words
                vocab = sorted(
                    w for w, i in words.sym2id.items()
                    if i != 0 and w not in ("<s>", "</s>")
                    and not w.startswith("#"))
                LOG("WARNING: reconstructing the uniform grammar from "
                    "words.txt; pass --lexicon for an exact match "
                    "with latgen's vocabulary")
            old_lm = uniform_unigram(vocab)
        else:
            old_lm = ArpaLM.load(args.old_arpa, log_fn=LOG)
    new_lm = ArpaLM.load(args.new_arpa, log_fn=LOG)  # any order

    n = 0
    with LatticeWriter(args.lattice_wspecifier) as w:
        for key, lat in SequentialLatticeReader(args.lattice_rspecifier):
            w.write(key, lattice_lmrescore(lat, old_lm, new_lm, words))
            n += 1
    LOG(f"LM-rescored {n} lattices")
    return 0 if n > 0 else 1


if __name__ == "__main__":
    sys.exit(main())
