"""Scoring cells: `AmScorer.score_stream` as `nnet-forward --no-softmax
--class-frame-counts` runs it for a decoder: whole utterances from a
zero state, `batch_utts` a dispatch padded to `length_bucket`, one
batch in flight (`pipeline`), the log priors subtracted on the device
and every score fetched to the host as dense float32 rows.

The reader hands out the pool's utterances, cycled in the seed's
order, as fast as the scorer takes them (an archive read by
`nnet-forward`: a closed loop) until `seconds` have passed; the
scorer then flushes what it holds. An utterance's latency runs from
the reader handing it over to its rows being yielded. Set-up scores
one batch of each padded length the window meets. The rows of a sample of
the utterances, drawn from the seed, and of the pool's longest one
are kept and held to the reference after the window.
"""

from __future__ import annotations

import time

import numpy as np
import torch

from bench_h100 import checks, model, traffic
from bench_h100.reference import lstmp as ref


def bucketed(L: int, bucket: int) -> int:
    return -(-int(L) // bucket) * bucket


def sampled(pool, check: dict, seed: int) -> set:
    """The hand-out numbers whose rows are kept and compared: `sample`
    drawn from the seed below `sample_span`, and the pool's longest."""
    rng = traffic.rng_for(seed, "sample")
    return {int(i) for i in rng.choice(check["sample_span"],
                                       size=check["sample"], replace=False)
            } | {int(np.argmax(pool.lengths))}


def run(cell, seed: int, seconds: float, window, device, control=None):
    from kaldi_lstm_tpu_torch.decode.scoring import (
        AmScorer,
        log_priors_from_counts,
    )

    cfg, tr, chk = cell.config, cell.traffic, cell.check
    K = cfg["num_pdfs"]
    parts, t = {}, time.perf_counter()
    pool = traffic.make_pool(tr, cfg["input_dim"], K, seed,
                             group=tr["batch_utts"])
    parts["pool"], t = time.perf_counter() - t, time.perf_counter()
    weights = model.make_weights(cfg, seed, device, trained=True)
    nnet, params = model.program_net(cfg, weights, tr["batch_utts"])
    if control == "bf16":
        nnet.set_matmul_dtype(torch.bfloat16)
    counts = traffic.class_counts(K, seed)
    scorer = AmScorer(nnet, params, log_prior=log_priors_from_counts(counts),
                      no_softmax=True, batch_utts=tr["batch_utts"],
                      length_bucket=tr["length_bucket"],
                      pipeline=tr["pipeline"], device=device)
    B, bucket, P = tr["batch_utts"], tr["length_bucket"], len(pool.lengths)
    parts["net"], t = time.perf_counter() - t, time.perf_counter()

    # one batch of each padded length the window meets, the first of the
    # window's order that has it (the window cycles the pool from 0)
    firsts: dict = {}
    for i in range(0, P, B):
        firsts.setdefault(bucketed(max(pool.lengths[i:i + B]), bucket), i)
    for _ in scorer.score_stream(
            (f"warm{u}", pool.feats[u % P]) for i in sorted(firsts.values())
            for u in range(i, i + B)):
        pass
    parts["warm-up"] = time.perf_counter() - t

    sample = sampled(pool, chk, seed)
    handed: list = []   # hand-over time of utterance n
    kept: dict = {}
    lat: list = []
    state = {"next": 0, "wrong": 0, "frames": 0}

    def reader(deadline):
        n = 0
        while time.perf_counter() < deadline:
            handed.append(time.perf_counter())
            yield f"utt{n}", pool.feats[n % P]
            n += 1

    def timed():
        deadline = time.perf_counter() + seconds
        for key, rows in scorer.score_stream(reader(deadline)):
            t = time.perf_counter()
            n = int(key[3:])
            L = int(pool.lengths[n % P])
            if n != state["next"] or rows.shape != (L, K):
                state["wrong"] += 1
            state["next"] = n + 1
            lat.append(t - handed[n])
            state["frames"] += L
            if n in sample:
                kept[n] = np.array(rows, copy=True)

    span = window(timed)
    n = len(handed)
    failed = state["wrong"] + (n - len(lat))
    del scorer, nnet, params
    lengths = [int(pool.lengths[i % P]) for i in range(n)]
    batches = [(bucketed(max(lengths[i:i + B]), bucket),
                sum(lengths[i:i + B])) for i in range(0, n, B)]
    out = {"span": span, "attempted": n, "failed": failed,
           "e2e": {"score_audio_s_per_s": state["frames"] / 100.0
                   / span["seconds"],
                   "score_p95_ms": 1e3 * float(np.percentile(lat, 95))},
           "ctx": {"batches": batches, "frames": state["frames"]},
           "setup_parts": parts}

    def reference():
        idx = sorted(kept)
        want = ref.score(weights, [pool.feats[i % P] for i in idx], counts,
                         device)
        return {"score_gap": checks.score_gap(
                    [kept[i] for i in idx], want, ref.log_priors(counts)),
                "missing": float(failed)}

    out["reference"] = reference
    return out
