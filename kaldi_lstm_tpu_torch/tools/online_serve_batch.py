"""Batched streaming serving: N concurrent sessions advance in lock-step
chunks through one device dispatch per tick (decode/online.py
OnlineBatchScorer: one K5 launch, the affine, the log-softmax, the prior
and the copy of the tick's scores to the host), with a native Viterbi
session per slot on the host; this package's copy of
``kaldi_lstm_tpu.tools.online_serve_batch``:

    python -m kaldi_lstm_tpu_torch.tools.online_serve_batch final.nnet \\
        final.mdl lexicon.txt lm.arpa scp:feats.scp ark,t:hyp.txt \\
        --num-sessions 64 --chunk-frames 20 --top-p 512 \\
        --class-frame-counts counts.vec --word-symbol-table words.txt

Each hypothesis equals whole-utterance scoring + offline decode_faster
(state carry is exact across chunks, each slot is reset between
utterances), up to the summation order of the batch shape. The
decode-time target delay is applied per utterance with the TimeShift
end clamp (nnet-time-shift.h:42-51), so delayed nets match their offline
decode too. --top-p prunes the score fetch on the card (values and
indices only); --fetch-bf16 halves the fetched values; --pipeline keeps
one tick in flight (+1 chunk of latency).

Runs on ``--device cuda`` (the default) and exits 1 when CUDA is
missing; ``--device cpu`` runs the plain PyTorch path.
"""

from __future__ import annotations

import argparse
import sys

import numpy as np
import torch

from kaldi_lstm_tpu_torch.decode.online import (
    OnlineBatchScorer,
    OnlineDecoder,
    strip_leading_timeshift,
)
from kaldi_lstm_tpu_torch.io.kaldi_io import SequentialMatrixReader, TableWriter
from kaldi_lstm_tpu_torch.io.lang import write_text_line
from kaldi_lstm_tpu_torch.tools.decode_faster import graph_from_args
from kaldi_lstm_tpu_torch.tools.nnet_forward import _flag
from kaldi_lstm_tpu_torch.tools.online_decode import add_am_args, read_am
from kaldi_lstm_tpu_torch.utils import LOG, device_from_arg


def _shift_feats(feats: np.ndarray, delay: int) -> np.ndarray:
    """Decode-time target delay with the TimeShift end clamp:
    out[t] = in[min(t + delay, T-1)] (nnet-time-shift.h:42-51)."""
    if delay <= 0:
        return feats
    idx = np.minimum(np.arange(len(feats)) + delay, len(feats) - 1)
    return feats[idx]


def build_parser() -> argparse.ArgumentParser:
    p = argparse.ArgumentParser(
        description="Batched streaming decoding: N lock-step sessions, "
                    "one device dispatch per chunk tick")
    p.add_argument("nnet")
    p.add_argument("model")
    p.add_argument("lexicon")
    p.add_argument("arpa", help='ARPA LM file, or "none"')
    p.add_argument("feature_rspecifier")
    p.add_argument("trans_wspecifier")
    p.add_argument("--word-symbol-table", default="")
    add_am_args(p)
    p.add_argument("--num-sessions", type=int, default=64)
    p.add_argument("--top-p", type=int, default=0,
                   help="fetch only the top-P log-likelihoods per frame "
                        "from the device (0 = dense)")
    p.add_argument("--fetch-bf16", default="false",
                   help="fetch the log-likelihood values as bfloat16")
    p.add_argument("--pipeline", default="false",
                   help="double-buffer device dispatch against the score "
                        "fetch (+1 chunk of latency)")
    # the graph has no silence loop: the tool takes no --sil-phone
    p.set_defaults(sil_phone=0, sil_prob=0.0)
    return p


def serve(args, device, graph) -> int:
    """The tool's body over a prebuilt `graph`."""
    nnet, params, transf, transf_params, log_prior = read_am(args, device)
    nnet, params, delay = strip_leading_timeshift(nnet, params,
                                                  args.targets_delay)
    N = args.num_sessions
    scorer = OnlineBatchScorer(
        nnet, params, N, transf=transf, transf_params=transf_params,
        log_prior=log_prior, top_p=args.top_p,
        fetch_dtype=torch.bfloat16 if _flag(args.fetch_bf16) else None,
        pipeline=_flag(args.pipeline), device=device)
    feat_dim = nnet.input_dim if transf is None else transf.input_dim
    tc = args.chunk_frames

    reader = iter(SequentialMatrixReader(args.feature_rspecifier))
    writer = TableWriter(args.trans_wspecifier, write_text_line,
                         binary=False)
    # per slot: [key, shifted feats, position, decoder] or None
    slots: list = [None] * N
    exhausted = False

    def assign(s):
        nonlocal exhausted
        if exhausted:
            return
        nxt = next(reader, None)
        if nxt is None:
            exhausted = True
            return
        key, mat = nxt
        slots[s] = [key, _shift_feats(np.asarray(mat, np.float32), delay),
                    0, OnlineDecoder(graph, args.acoustic_scale, args.beam,
                                     args.max_active)]

    for s in range(N):
        assign(s)

    sym = graph.words.id2sym if graph.words else {}
    chunk = np.zeros((N, tc, feat_dim), np.float32)
    num_done = 0

    def process(meta, ll):
        nonlocal num_done
        done_slots = []
        for s, key, real, dec, finished in meta:
            if real:
                dec.advance(np.asarray(ll[s, :real], np.float64))
            if finished:
                res = dec.finalize()
                writer.write(key, [sym.get(w, str(w)) for w in res.words])
                num_done += 1
                if not res.reached_final:
                    LOG(f"WARNING: {key}: no final state reached")
                done_slots.append(s)
        if done_slots:
            # zero the freed slots' LSTM state before rebinding them
            scorer.reset(done_slots)
            for s in done_slots:
                assign(s)

    # with the pipeline, score(k) returns tick k-1's block, so a tick's
    # processing (decoder advance, finalize, slot rebind) lags its
    # dispatch by one; `pending` holds the ticks awaiting their block
    pending: list = []
    while any(slots) or pending:
        if any(slots):
            chunk[:] = 0.0
            meta = []
            for s, slot in enumerate(slots):
                if slot is None:
                    continue
                key, feats, pos, dec = slot
                n = min(tc, len(feats) - pos)
                chunk[s, :n] = feats[pos:pos + n]
                slot[2] = pos + n
                finished = slot[2] >= len(feats)
                meta.append((s, key, n, dec, finished))
                if finished:
                    slots[s] = None  # no more dispatches; rebound when
                    #                  its block is processed
            ll = scorer.score(chunk)
            pending.append(meta)
            if ll is None:
                continue  # the pipeline's first tick
        else:
            ll = scorer.flush()
        process(pending.pop(0), ll)
    writer.close()
    LOG(f"Decoded {num_done} utterances over {N} lock-step sessions "
        f"(chunk {tc} frames, delay {delay}, top_p {args.top_p})")
    return 0


def main(argv=None) -> int:
    args = build_parser().parse_args(argv)
    device = device_from_arg(args.device, "online-serve-batch")
    if device is None:
        return 1
    _, graph = graph_from_args(args)
    return serve(args, device, graph)


if __name__ == "__main__":
    sys.exit(main())
