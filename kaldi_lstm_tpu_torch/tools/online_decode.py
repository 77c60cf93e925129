"""Online (streaming) word decoding: features are fed chunk by chunk
through the stateful net (carried LSTM state, target-delay lookahead)
and an incremental Viterbi decoder; this package's copy of
``kaldi_lstm_tpu.tools.online_decode``:

    python -m kaldi_lstm_tpu_torch.tools.online_decode final.nnet \\
        final.mdl lexicon.txt lm.arpa scp:feats.scp ark,t:hyp.txt \\
        --class-frame-counts counts.vec --word-symbol-table words.txt \\
        --chunk-frames 20 --targets-delay 5 --print-partials

Each chunk of --chunk-frames frames is one K5 launch at S=1 on the card
and one advance of the native stream session on the host; the final
hypothesis of an utterance equals scoring it whole and decoding offline
(up to the summation order of the scoring's batch shape).

Runs on ``--device cuda`` (the default) and exits 1 when CUDA is
missing; ``--device cpu`` runs the plain PyTorch path.
"""

from __future__ import annotations

import argparse
import sys

from kaldi_lstm_tpu_torch.decode.online import OnlineRecognizer
from kaldi_lstm_tpu_torch.decode.scoring import (
    log_priors_from_counts,
    read_class_frame_counts,
)
from kaldi_lstm_tpu_torch.io.kaldi_io import SequentialMatrixReader, TableWriter
from kaldi_lstm_tpu_torch.io.lang import write_text_line
from kaldi_lstm_tpu_torch.models import Nnet
from kaldi_lstm_tpu_torch.tools.decode_faster import (
    add_graph_args,
    graph_from_args,
)
from kaldi_lstm_tpu_torch.utils import LOG, device_from_arg


def add_am_args(p: argparse.ArgumentParser) -> None:
    """The acoustic-model flags shared by the three streaming tools."""
    p.add_argument("--feature-transform", default="")
    p.add_argument("--class-frame-counts", default="")
    p.add_argument("--prior-scale", type=float, default=1.0)
    p.add_argument("--prior-floor", type=float, default=1e-10)
    p.add_argument("--acoustic-scale", type=float, default=0.1)
    p.add_argument("--beam", type=float, default=16.0)
    p.add_argument("--max-active", type=int, default=0)
    p.add_argument("--chunk-frames", type=int, default=20,
                   help="frames fed per streaming step")
    p.add_argument("--targets-delay", type=int, default=-1,
                   help="lookahead frames; -1 = take from a leading "
                        "TimeShift component (0 if absent)")
    p.add_argument("--device", default="cuda",
                   help="device to score on: cuda (default, exits 1 when "
                        "CUDA is missing) or cpu")


def read_am(args, device):
    """(nnet, params, transf, transf_params, log_prior) of the flags."""
    nnet, params = Nnet.read(args.nnet, device)
    transf, transf_params = (Nnet.read(args.feature_transform, device)
                             if args.feature_transform else (None, None))
    log_prior = None
    if args.class_frame_counts:
        log_prior = log_priors_from_counts(
            read_class_frame_counts(args.class_frame_counts),
            args.prior_scale, args.prior_floor)
    return nnet, params, transf, transf_params, log_prior


def build_parser() -> argparse.ArgumentParser:
    p = argparse.ArgumentParser(
        description="Streaming decoding with carried LSTM state over an "
                    "HCLG graph built from model + lexicon + ARPA LM")
    p.add_argument("nnet", help="acoustic net (google or standard format)")
    add_graph_args(p)
    p.add_argument("feature_rspecifier")
    p.add_argument("trans_wspecifier")
    add_am_args(p)
    p.add_argument("--print-partials", action="store_true",
                   help="log the partial hypothesis after every chunk")
    return p


def decode_utterances(args, device, graph) -> int:
    """The tool's body over a prebuilt `graph`."""
    nnet, params, transf, transf_params, log_prior = read_am(args, device)
    delay = None if args.targets_delay < 0 else args.targets_delay
    id2sym = graph.words.id2sym
    n, total_frames, no_final = 0, 0, 0
    with TableWriter(args.trans_wspecifier, write_text_line,
                     binary=False) as w:
        for key, feats in SequentialMatrixReader(args.feature_rspecifier):
            rec = OnlineRecognizer(
                nnet, params, graph, transf=transf,
                transf_params=transf_params, log_prior=log_prior,
                acoustic_scale=args.acoustic_scale, beam=args.beam,
                max_active=args.max_active, targets_delay=delay,
                device=device)
            for t0 in range(0, feats.shape[0], args.chunk_frames):
                rec.accept(feats[t0:t0 + args.chunk_frames])
                if args.print_partials:
                    part = rec.partial()
                    LOG(f"{key} @{min(t0 + args.chunk_frames, len(feats))}"
                        f": " + " ".join(id2sym[i] for i in part.words))
            res = rec.finalize()
            w.write(key, [id2sym[i] for i in res.words]
                    if args.word_symbol_table else res.words)
            n += 1
            total_frames += feats.shape[0]
            no_final += 0 if res.reached_final else 1
    LOG(f"Decoded {n} utterances ({total_frames} frames) online"
        + (f"; {no_final} did not reach a final state" if no_final else ""))
    return 0


def main(argv=None) -> int:
    args = build_parser().parse_args(argv)
    device = device_from_arg(args.device, "online-decode")
    if device is None:
        return 1
    _, graph = graph_from_args(args)
    return decode_utterances(args, device, graph)


if __name__ == "__main__":
    sys.exit(main())
