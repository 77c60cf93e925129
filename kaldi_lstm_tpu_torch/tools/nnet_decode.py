"""Fused AM scoring + word decoding — upstream's
`nnet-forward | decode-faster-mapped` / `nnet-forward | latgen-faster`
pipe as ONE process, with no multi-GB loglik ark (or pipe
serialization) between the stages; this package's copy of
``kaldi_lstm_tpu.tools.nnet_decode``:

    python -m kaldi_lstm_tpu_torch.tools.nnet_decode \\
        final.nnet final.mdl lexicon.txt lm.arpa scp:cv.scp \\
        ark,t:hyp.txt --feature-transform ft.nnet \\
        --class-frame-counts counts.vec --apply-log=true \\
        --acoustic-scale 0.1 --beam 13 --max-active 7000 --num-threads 2

With --lattice-wspecifier the decoder is the lattice-generating one
(latgen_faster core); hyp output then comes from the lattice best path.

The device half is decode/scoring.py AmScorer — the same scorer
nnet_forward uses, so transcripts/lattices are IDENTICAL to the
two-stage flow by construction — batched `--batch-utts` at a time and
double-buffered (`--pipeline`, default on): batch k+1 computes on the
card while batch k's scores come to the host on a side stream and are
decoded there. The search runs on the host in the native core
(csrc/kltdecode.cc, built with g++ at first use; it never falls back to
numpy on its own), in `--num-threads` threads: ctypes releases the GIL,
so the threads search while the main thread queues the next batch. Two
fetch reducers (both OFF by default because they perturb the scores):

* `--fetch-dtype bf16` halves the device-to-host payload;
* `--top-p P` fetches only the top-P log-likelihoods per frame
  (values + indices); dense rows are rebuilt host-side with the floor
  min(fetched values) - `--floor-margin`.

Runs on ``--device cuda`` (the default) and exits 1 when CUDA is
missing; ``--device cpu`` runs the plain PyTorch path.
"""

from __future__ import annotations

import argparse
import sys

import torch

from kaldi_lstm_tpu_torch.decode.scoring import AmScorer
from kaldi_lstm_tpu_torch.io.kaldi_io import SequentialMatrixReader
from kaldi_lstm_tpu_torch.tools.decode_faster import (
    add_graph_args,
    decode_source,
    graph_from_args,
)
from kaldi_lstm_tpu_torch.tools.latgen_faster import (
    add_latgen_args,
    latgen_source,
)
from kaldi_lstm_tpu_torch.tools.nnet_forward import (
    _flag,
    add_forward_args,
    scorer_from_args,
)
from kaldi_lstm_tpu_torch.utils import LOG


def build_parser() -> argparse.ArgumentParser:
    p = argparse.ArgumentParser(
        description="Fused acoustic-model scoring + word decoding "
                    "(no intermediate loglik ark)")
    p.add_argument("nnet", help="acoustic model (Nnet format)")
    add_graph_args(p)
    p.add_argument("feature_rspecifier")
    p.add_argument("trans_wspecifier")
    p.add_argument("--lattice-wspecifier", default="",
                   help="generate lattices (latgen core) instead of "
                        "plain Viterbi; transcripts become lattice "
                        "best paths")
    add_latgen_args(p)
    add_forward_args(p)
    p.add_argument("--pipeline", default="true",
                   help="double-buffer device dispatch against host "
                        "fetch+decode")
    p.add_argument("--top-p", type=int, default=0,
                   help="fetch only the top-P log-likelihoods per frame "
                        "(device-side pruning; 0 = dense)")
    p.add_argument("--floor-margin", type=float, default=10.0,
                   help="floor for unfetched pdfs with --top-p: "
                        "min(fetched values) - margin")
    p.add_argument("--fetch-dtype", default="f32",
                   choices=("f32", "bf16"),
                   help="dtype of the fetched log-likelihood values")
    return p


def make_scorer(args) -> AmScorer | None:
    """The AmScorer of parsed flags (None after a stderr message on a
    flag conflict or a missing device)."""
    return scorer_from_args(
        args, args.nnet, pipeline=_flag(args.pipeline),
        top_p=int(args.top_p), floor_margin=args.floor_margin,
        fetch_dtype=torch.bfloat16 if args.fetch_dtype == "bf16" else None)


def decode_stream(args, scorer: AmScorer, tm, graph) -> int:
    """Score the features of `args` with `scorer` and decode them over
    `graph` (Viterbi, or lattices with --lattice-wspecifier): the tool's
    body, for callers that build the graph once and decode many times."""
    source = scorer.score_stream(
        SequentialMatrixReader(args.feature_rspecifier))
    if args.lattice_wspecifier:
        # in lattice mode the positional trans_wspecifier IS the
        # transcript output; a conflicting --transcript-wspecifier
        # would be silently dead — reject it instead
        if args.transcript_wspecifier and \
                args.transcript_wspecifier != args.trans_wspecifier:
            print("nnet-decode: with --lattice-wspecifier, transcripts "
                  "go to the positional <trans-wspecifier>; do not also "
                  "pass --transcript-wspecifier", file=sys.stderr)
            return 1
        lat_args = argparse.Namespace(**vars(args))
        lat_args.transcript_wspecifier = args.trans_wspecifier
        rc = latgen_source(tm, graph, source, lat_args)
    else:
        rc = decode_source(
            tm, graph, source, acoustic_scale=args.acoustic_scale,
            beam=args.beam, max_active=args.max_active,
            trans_wspecifier=args.trans_wspecifier,
            word_strings=bool(args.word_symbol_table),
            num_threads=args.num_threads)
    if rc == 0:
        LOG("fused score->decode done (no intermediate loglik ark)")
    return rc


def main(argv=None) -> int:
    args = build_parser().parse_args(argv)
    scorer = make_scorer(args)   # before the graph: a missing card exits 1
    if scorer is None:
        return 1
    tm, graph = graph_from_args(args)
    return decode_stream(args, scorer, tm, graph)


if __name__ == "__main__":
    sys.exit(main())
