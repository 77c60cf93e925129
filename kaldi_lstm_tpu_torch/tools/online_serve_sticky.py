"""Sticky-session streaming serving: sessions bind and release slots
with ragged chunk arrival (not lock-step ticks), trailing-silence
endpointing and partial-result finalization — the serving layer of
decode/serve.py driven over a feature table as a reproducible arrival
trace; this package's copy of ``kaldi_lstm_tpu.tools.online_serve_sticky``:

    python -m kaldi_lstm_tpu_torch.tools.online_serve_sticky final.nnet \\
        final.mdl lexicon.txt lm.arpa scp:feats.scp ark,t:hyp.txt \\
        --num-slots 16 --chunk-frames 20 --arrival-hazard 0.6 \\
        --class-frame-counts counts.vec --word-symbol-table words.txt

Each utterance becomes a session. Sessions are admitted over time (a
per-tick arrival hazard makes the trace ragged, reproducible through
--trace-seed) and stream Poisson-sized chunks (--mean-chunk), so slots
see different rates; excess sessions queue for slots. Every tick with
any frame is one K5 launch (its advance-mask entry point) on the card.
With --endpoint-silence-pdfs, trailing silence finalizes a session
early (the hypothesis then covers the consumed prefix). Without
endpointing each hypothesis equals offline decoding of the same audio,
up to the summation order of the batch shape.

Runs on ``--device cuda`` (the default) and exits 1 when CUDA is
missing; ``--device cpu`` runs the plain PyTorch path.
"""

from __future__ import annotations

import argparse
import sys

import numpy as np
import torch

from kaldi_lstm_tpu_torch.decode.online import strip_leading_timeshift
from kaldi_lstm_tpu_torch.decode.serve import EndpointConfig, StickySessionServer
from kaldi_lstm_tpu_torch.io.kaldi_io import SequentialMatrixReader, TableWriter
from kaldi_lstm_tpu_torch.io.lang import write_text_line
from kaldi_lstm_tpu_torch.tools.decode_faster import (
    add_graph_args,
    graph_from_args,
)
from kaldi_lstm_tpu_torch.tools.nnet_forward import _flag
from kaldi_lstm_tpu_torch.tools.online_decode import add_am_args, read_am
from kaldi_lstm_tpu_torch.utils import LOG, device_from_arg


def build_parser() -> argparse.ArgumentParser:
    p = argparse.ArgumentParser(
        description="Sticky-session streaming decoding: slot-bound "
                    "sessions with heterogeneous chunk arrival")
    p.add_argument("nnet")
    add_graph_args(p)
    p.add_argument("feature_rspecifier")
    p.add_argument("trans_wspecifier")
    add_am_args(p)
    p.add_argument("--num-slots", type=int, default=16)
    p.add_argument("--arrival-hazard", type=float, default=1.0,
                   help="per-tick admission probability of the next "
                        "session (1.0 = all arrive immediately)")
    p.add_argument("--mean-chunk", type=float, default=0.0,
                   help="Poisson mean of the frames each session "
                        "delivers per tick (0 = a full --chunk-frames "
                        "every tick)")
    p.add_argument("--trace-seed", type=int, default=0)
    p.add_argument("--top-p", type=int, default=0)
    p.add_argument("--fetch-bf16", default="false")
    p.add_argument("--endpoint-silence-pdfs", default="",
                   help="comma-separated pdf ids; enables trailing-"
                        "silence endpointing")
    p.add_argument("--endpoint-trailing-silence", type=int, default=30)
    p.add_argument("--endpoint-min-speech", type=int, default=3)
    p.add_argument("--endpoint-max-frames", type=int, default=0)
    return p


def make_server(args, device, graph) -> StickySessionServer:
    """The StickySessionServer of the flags over a prebuilt `graph`."""
    nnet, params, transf, transf_params, log_prior = read_am(args, device)
    nnet, params, delay = strip_leading_timeshift(nnet, params,
                                                  args.targets_delay)
    endpoint = None
    if args.endpoint_silence_pdfs:
        endpoint = EndpointConfig(
            silence_pdfs=frozenset(
                int(x) for x in args.endpoint_silence_pdfs.split(",")),
            trailing_silence_frames=args.endpoint_trailing_silence,
            min_speech_frames=args.endpoint_min_speech,
            max_utterance_frames=args.endpoint_max_frames)
    return StickySessionServer(
        nnet, params, graph, args.num_slots,
        chunk_frames=args.chunk_frames, transf=transf,
        transf_params=transf_params, log_prior=log_prior,
        acoustic_scale=args.acoustic_scale, beam=args.beam,
        max_active=args.max_active, targets_delay=delay,
        endpoint=endpoint, top_p=args.top_p,
        fetch_dtype=torch.bfloat16 if _flag(args.fetch_bf16) else None,
        device=device)


def drive_trace(args, srv: StickySessionServer) -> int | None:
    """Replay the feature table as the arrival trace of the flags (the
    arrival hazard, Poisson chunks, --trace-seed) through `srv` until
    every session is finalized. Returns the frames scored (None when the
    loop runs away)."""
    rng = np.random.RandomState(args.trace_seed)
    reader = iter(SequentialMatrixReader(args.feature_rspecifier))
    cursors: dict = {}
    exhausted = False
    total_frames = 0
    ticks = 0
    while True:
        # admit the next session(s) by the arrival hazard
        while not exhausted and rng.rand() < args.arrival_hazard:
            nxt = next(reader, None)
            if nxt is None:
                exhausted = True
                break
            key, mat = nxt
            srv.submit(key, np.zeros((0, mat.shape[1]), np.float32))
            if len(mat) == 0:
                # a zero-length utterance never enters the delivery
                # loop: close it now or its cursor wedges the exit
                srv.end_stream(key)
                continue
            cursors[key] = [np.asarray(mat, np.float32), 0]
        # live sessions deliver ragged chunks
        for key in list(cursors):
            m, pos = cursors[key]
            if pos >= len(m):
                continue
            n = (len(m) - pos if args.mean_chunk <= 0
                 else min(int(rng.poisson(args.mean_chunk)),
                          len(m) - pos))
            if args.mean_chunk <= 0:
                n = min(args.chunk_frames, n)
            if n > 0:
                srv.submit(key, m[pos:pos + n])
                cursors[key][1] = pos + n
            if cursors[key][1] >= len(m):
                srv.end_stream(key)
                del cursors[key]
        total_frames += srv.tick()
        ticks += 1
        if exhausted and not cursors and \
                all(s is None for s in srv.slots) and not srv.waiting:
            return total_frames
        if ticks > 10_000_000:
            return None


def write_results(args, srv: StickySessionServer, graph) -> int:
    """Write the finalized sessions' transcripts in key order; returns
    how many endpointed."""
    sym = graph.words.id2sym if graph.words else {}
    n_endpointed = 0
    with TableWriter(args.trans_wspecifier, write_text_line,
                     binary=False) as w:
        for r in sorted(srv.results, key=lambda r: r.sid):
            w.write(r.sid, [sym.get(i, str(i)) for i in r.result.words]
                    if args.word_symbol_table else r.result.words)
            n_endpointed += 1 if r.endpointed else 0
    return n_endpointed


def serve(args, device, graph) -> int:
    """The tool's body over a prebuilt `graph`."""
    srv = make_server(args, device, graph)
    total_frames = drive_trace(args, srv)
    if total_frames is None:
        print("online_serve_sticky: runaway tick loop", file=sys.stderr)
        return 1
    n_endpointed = write_results(args, srv, graph)
    LOG(f"Decoded {len(srv.results)} sessions over {args.num_slots} sticky "
        f"slots in {srv.ticks} ticks (occupancy {srv.occupancy:.2f}, "
        f"{n_endpointed} endpointed, {total_frames} frames)")
    return 0


def main(argv=None) -> int:
    args = build_parser().parse_args(argv)
    device = device_from_arg(args.device, "online-serve-sticky")
    if device is None:
        return 1
    _, graph = graph_from_args(args)
    return serve(args, device, graph)


if __name__ == "__main__":
    sys.exit(main())
