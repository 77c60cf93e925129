"""Forced alignment CLI — upstream align-mapped: produce per-frame
transition-id alignments (ali.ark) from scaled log-likelihoods and
known transcripts. With it, `nnet_forward -> align_mapped -> ali_to_pdf
-> ali-to-post` regenerates training targets (realignment between
training iterations); tools/nnet_align.py fuses the first two stages.
The alignment is host numpy.

    python -m kaldi_lstm_tpu_torch.tools.align_mapped final.mdl \\
        lexicon.txt ark:loglik.ark text ark:ali.ark \\
        --acoustic-scale 0.1 --beam 200 [--sil-phone 1 --sil-prob 0.5]

Transcripts are `key word word ...` text lines (words as lexicon
strings, or integer ids with --transcripts-are-ids).
"""

from __future__ import annotations

import argparse
import sys

from kaldi_lstm_tpu_torch.decode.align import (
    AlignmentError,
    align_mapped,
    build_alignment_graph,
)
from kaldi_lstm_tpu_torch.io.kaldi_io import (
    SequentialMatrixReader,
    TableWriter,
    write_int_vector,
)
from kaldi_lstm_tpu_torch.io.lang import (
    SymbolTable,
    read_lexicon,
    read_text_table,
)
from kaldi_lstm_tpu_torch.io.transition_model import TransitionModel
from kaldi_lstm_tpu_torch.utils import LOG


def align_stream(pairs, texts, tm, lexicon, words, args, writer
                 ) -> tuple[int, int, int]:
    """Shared per-utterance alignment loop of this CLI and the fused
    tools/nnet_align.py: (key, loglik) pairs in, transition-id
    alignments out via `writer`. Returns (aligned, no_text, failed)."""
    n = no_text = failed = 0
    for key, mat in pairs:
        sent = texts.get(key)
        if sent is None:
            LOG(f"WARNING: {key}: no transcript, skipping")
            no_text += 1
            continue
        if args.transcripts_are_ids:
            sent = [words.id2sym[int(t)] for t in sent]
        try:
            graph = build_alignment_graph(
                tm, lexicon, sent, words=words,
                sil_phone=args.sil_phone, sil_prob=args.sil_prob)
            tids, _w, _score = align_mapped(
                graph, mat, args.acoustic_scale, args.beam,
                args.max_active)
        except (AlignmentError, ValueError) as e:
            LOG(f"WARNING: {key}: {e}")
            failed += 1
            continue
        writer.write(key, tids)
        n += 1
    return n, no_text, failed


def main(argv=None) -> int:
    p = argparse.ArgumentParser(
        description="Viterbi forced alignment of log-likelihoods "
                    "against known transcripts")
    p.add_argument("model")
    p.add_argument("lexicon")
    p.add_argument("loglik_rspecifier")
    p.add_argument("transcripts", help="text file: key word word ...")
    p.add_argument("ali_wspecifier")
    p.add_argument("--acoustic-scale", type=float, default=1.0)
    p.add_argument("--beam", type=float, default=200.0)
    p.add_argument("--max-active", type=int, default=0)
    p.add_argument("--sil-phone", type=int, default=0)
    p.add_argument("--sil-prob", type=float, default=0.0)
    p.add_argument("--word-symbol-table", default="")
    p.add_argument("--transcripts-are-ids", action="store_true",
                   help="transcript tokens are word ids from "
                        "--word-symbol-table")
    args = p.parse_args(argv)

    tm = TransitionModel.load(args.model)
    lexicon = read_lexicon(args.lexicon)
    words = (SymbolTable.load(args.word_symbol_table)
             if args.word_symbol_table else None)
    texts = read_text_table(args.transcripts)

    with TableWriter(args.ali_wspecifier, write_int_vector) as w:
        n, no_text, failed = align_stream(
            SequentialMatrixReader(args.loglik_rspecifier), texts, tm,
            lexicon, words, args, w)
    LOG(f"Aligned {n} utterances"
        + (f"; {no_text} without transcript" if no_text else "")
        + (f"; {failed} failed" if failed else ""))
    return 0 if n > 0 else 1


if __name__ == "__main__":
    sys.exit(main())
