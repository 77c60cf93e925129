"""Fused score-and-align: nnet-forward + align-mapped in ONE pass; this
package's copy of ``kaldi_lstm_tpu.tools.nnet_align``.

The realignment flow of a recipe pipes the AM scorer into the aligner
(upstream steps/nnet/align.sh: `nnet-forward | align-compiled-mapped`),
which at flagship widths writes a large loglik ark between them (5.5 GB
for 400 utterances at 7998 senones). This tool scores on the card in
batches of `--batch-utts` (decode/scoring.py AmScorer, the scorer
nnet_forward uses) and aligns each utterance on the host as its scores
arrive (tools/align_mapped.py `align_stream`): the same alignments,
with no intermediate ark.

    python -m kaldi_lstm_tpu_torch.tools.nnet_align [forward options] \\
        <nnet> <transition-model> <lexicon> <feature-rspecifier> \\
        <transcripts> <ali-wspecifier> \\
        --class-frame-counts counts.vec --acoustic-scale 1.0

Runs on ``--device cuda`` (the default) and exits 1 when CUDA is
missing; ``--device cpu`` runs the plain PyTorch path.
"""

from __future__ import annotations

import argparse
import sys

from kaldi_lstm_tpu_torch.decode.scoring import AmScorer
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
from kaldi_lstm_tpu_torch.tools.align_mapped import align_stream
from kaldi_lstm_tpu_torch.tools.nnet_forward import (
    _flag,
    add_forward_args,
    scorer_from_args,
)
from kaldi_lstm_tpu_torch.utils import LOG


def build_parser() -> argparse.ArgumentParser:
    p = argparse.ArgumentParser(
        description="Score features with the net and Viterbi-align "
                    "against known transcripts in one pass")
    p.add_argument("nnet")
    p.add_argument("model", help="transition model (final.mdl)")
    p.add_argument("lexicon")
    p.add_argument("feature_rspecifier")
    p.add_argument("transcripts", help="text file: key word word ...")
    p.add_argument("ali_wspecifier")
    add_forward_args(p)
    p.add_argument("--acoustic-scale", type=float, default=1.0)
    p.add_argument("--beam", type=float, default=200.0)
    p.add_argument("--max-active", type=int, default=0)
    p.add_argument("--sil-phone", type=int, default=0)
    p.add_argument("--sil-prob", type=float, default=0.0)
    p.add_argument("--word-symbol-table", default="")
    p.add_argument("--transcripts-are-ids", action="store_true",
                   help="transcript tokens are word ids from "
                        "--word-symbol-table")
    return p


def make_scorer(args) -> AmScorer | None:
    """The AmScorer of parsed flags (None after a stderr message on a
    flag conflict or a missing device). Alignment needs log-domain
    scores: without --apply-log or --no-softmax it takes the standard
    prior-divided log-posterior (--apply-log=true)."""
    if not _flag(args.apply_log) and not _flag(args.no_softmax):
        args.apply_log = "true"
    return scorer_from_args(args, args.nnet)


def align_features(args, scorer: AmScorer) -> int:
    """Score the features of `args` that have a transcript and align
    them: the tool's body, for callers that build the scorer once."""
    tm = TransitionModel.load(args.model)
    lexicon = read_lexicon(args.lexicon)
    words = (SymbolTable.load(args.word_symbol_table)
             if args.word_symbol_table else None)
    texts = read_text_table(args.transcripts)

    # skip transcript-less utterances BEFORE scoring: a discarded
    # forward at flagship widths is the expensive part
    no_text = 0

    def with_transcripts(reader):
        nonlocal no_text
        for key, feats in reader:
            if key not in texts:
                LOG(f"WARNING: {key}: no transcript, skipping")
                no_text += 1
                continue
            yield key, feats

    with TableWriter(args.ali_wspecifier, write_int_vector) as w:
        n, _, failed = align_stream(
            scorer.score_stream(with_transcripts(
                SequentialMatrixReader(args.feature_rspecifier))),
            texts, tm, lexicon, words, args, w)
    LOG(f"Scored+aligned {n} utterances"
        + (f"; {no_text} without transcript" if no_text else "")
        + (f"; {failed} failed" if failed else ""))
    return 0 if n > 0 else 1


def main(argv=None) -> int:
    args = build_parser().parse_args(argv)
    if args.transcripts_are_ids and not args.word_symbol_table:
        print("nnet_align: --transcripts-are-ids requires "
              "--word-symbol-table", file=sys.stderr)
        return 1
    scorer = make_scorer(args)
    if scorer is None:
        return 1
    return align_features(args, scorer)


if __name__ == "__main__":
    sys.exit(main())
