"""Viterbi beam search over a DecodingGraph — the self-contained
equivalent of upstream Kaldi's `decode-faster-mapped`; this package's
copy of ``kaldi_lstm_tpu.decode.faster``.

`decode_faster_tokens` is the reference-style token-passing loop
(ProcessEmitting / ProcessNonemitting over a hash of active tokens), kept
as the independent cross-check that `decode_faster` is tested against.

The graph is compiled once to CSR arc arrays (`CompiledGraph`). The frame
loop runs in the native core (csrc/kltdecode.cc through io/native.py):
dense backpointers for small graphs, sparse ones with an in-C++
traceback for large graphs. A core that cannot be built or loaded
raises; it never falls back.

`KLT_DECODE_IMPL=python` asks for the vectorized numpy implementation
instead, with the same semantics (the core replicates it, backpointer
tie order included): each frame batches one scatter-max relaxation
(`np.maximum.at`) over the arcs leaving the surviving beam-pruned
states, then a frontier epsilon closure (word entry arcs, chain exits,
LM backoff — passes bounded by the epsilon-graph depth). Backpointers
are per-frame arc ids, so the traceback recovers word labels exactly.

Decoding is host-side: a sparse irregular dynamic program is search,
not tensor-core work — the card scores, the host decodes.
"""

from __future__ import annotations

import heapq
import os
from dataclasses import dataclass
from typing import Optional

import numpy as np

from kaldi_lstm_tpu_torch.decode.graph import DecodingGraph
from kaldi_lstm_tpu_torch.io.native import (
    decode_faster_native,
    decode_faster_sparse_native,
)

NEG = -1e30


@dataclass
class Trace:
    __slots__ = ("prev", "word")
    prev: Optional["Trace"]
    word: int


@dataclass
class DecodeResult:
    words: list[int]      # word ids (symbol-table resolvable)
    score: float          # total path ln prob (graph + scaled acoustic)
    reached_final: bool


def _process_nonemitting(graph: DecodingGraph, tokens: dict,
                         cutoff: float) -> None:
    """Epsilon closure of the current token set, in place. Epsilon arcs
    have weight <= 0 and the epsilon subgraph's only cycles go through
    emitting states, so a work-queue relaxation terminates; the score
    check also guards pathological zero-weight loops."""
    queue = list(tokens.keys())
    while queue:
        s = queue.pop()
        sc, tr = tokens[s]
        for arc in graph.arcs[s]:
            if arc.pdf != -1:
                continue
            ns = sc + arc.weight
            if ns <= cutoff:
                continue
            old = tokens.get(arc.dst)
            if old is None or ns > old[0]:
                tokens[arc.dst] = (
                    ns, Trace(tr, arc.word) if arc.word else tr)
                queue.append(arc.dst)


class CompiledGraph:
    """DecodingGraph flattened to CSR arc arrays (sorted by source state)
    for vectorized frontier relaxation. Build once per graph (cached on
    the graph object by decode_faster)."""

    def __init__(self, graph: DecodingGraph):
        em, eps = [], []
        for src, arcs in enumerate(graph.arcs):
            for a in arcs:
                (em if a.pdf >= 0 else eps).append(
                    (src, a.dst, a.pdf, a.word, a.weight, a.tid))
        ns = graph.num_states

        def csr(rows):
            if not rows:
                z = np.zeros(0, np.int32)
                return (z, z, z, z, np.zeros(0), z,
                        np.zeros(ns + 1, np.int64))
            arr = np.asarray(rows, np.float64)
            order = np.argsort(arr[:, 0], kind="stable")
            arr = arr[order]
            src = arr[:, 0].astype(np.int32)
            row_ptr = np.zeros(ns + 1, np.int64)
            np.add.at(row_ptr, src + 1, 1)
            np.cumsum(row_ptr, out=row_ptr)
            return (src, arr[:, 1].astype(np.int32),
                    arr[:, 2].astype(np.int32),
                    arr[:, 3].astype(np.int32),
                    np.ascontiguousarray(arr[:, 4]),
                    arr[:, 5].astype(np.int32), row_ptr)

        (self.em_src, self.em_dst, self.em_pdf, self.em_word, self.em_w,
         self.em_tid, self.em_ptr) = csr(em)
        (self.eps_src, self.eps_dst, _, self.eps_word, self.eps_w,
         _, self.eps_ptr) = csr(eps)
        self.num_em = len(em)
        self.ns = ns
        self.start = graph.start
        self.final = np.asarray(graph.final, np.float64)
        self.words = graph.words


def _out_arcs(row_ptr, states):
    """Arc ids of all arcs leaving `states` (CSR range gather)."""
    starts = row_ptr[states]
    counts = (row_ptr[states + 1] - starts).astype(np.int64)
    total = int(counts.sum())
    if total == 0:
        return np.zeros(0, np.int64)
    # standard vectorized multi-range arange
    rep_starts = np.repeat(starts, counts)
    offs = np.arange(total) - np.repeat(
        np.cumsum(counts) - counts, counts)
    return rep_starts + offs


def _eps_closure(cg: CompiledGraph, alpha: np.ndarray, bp: np.ndarray,
                 frontier: np.ndarray, cutoff: float = -np.inf,
                 max_passes: int = 32):
    """Frontier epsilon relaxation to a fixed point, in place; expansions
    below `cutoff` are dropped (upstream ProcessNonemitting applies the
    frame cutoff to epsilon successors too — without it the word-entry
    epsilon fan-out re-activates every pronunciation chain each frame).
    The grammar epsilon subgraph is a shallow DAG (entry/exit/backoff
    arcs), so this converges in <= its depth (~3) passes;
    strict-improvement updates terminate even on zero-weight cycles."""
    if cg.eps_src.size == 0:
        return np.zeros(0, np.int64)
    improved_all = []
    for _ in range(max_passes):
        ids = _out_arcs(cg.eps_ptr, frontier)
        if ids.size == 0:
            break
        cand = alpha[cg.eps_src[ids]] + cg.eps_w[ids]
        keep = cand > cutoff
        ids, cand = ids[keep], cand[keep]
        if ids.size == 0:
            break
        dst = cg.eps_dst[ids]
        old = alpha[dst].copy()
        np.maximum.at(alpha, dst, cand)
        win = (cand >= alpha[dst]) & (alpha[dst] > old)
        if not win.any():
            break
        # eps arc ids are offset past the emitting arcs in bp
        bp[dst[win]] = cg.num_em + ids[win]
        frontier = np.unique(dst[win])
        improved_all.append(frontier)
    if improved_all:
        return np.unique(np.concatenate(improved_all))
    return np.zeros(0, np.int64)


def compile_graph(graph: DecodingGraph) -> CompiledGraph:
    """CSR-compile (cached on the graph object)."""
    cg = getattr(graph, "_compiled", None)
    if cg is None:
        cg = CompiledGraph(graph)
        graph._compiled = cg
    return cg


def _frame_step(cg: CompiledGraph, alpha, active, em_t, beam: float,
                max_active: int, bp, frame_idx: int):
    """One Viterbi frame: batched emitting relaxation from `active`,
    beam/max_active pruning, epsilon closure. Fills `bp` (per-frame
    backpointer row) and returns (new_alpha, new_active)."""
    ids = _out_arcs(cg.em_ptr, active)
    dst = cg.em_dst[ids]
    cand = alpha[cg.em_src[ids]] + cg.em_w[ids] + em_t[cg.em_pdf[ids]]
    alpha = np.full(cg.ns, NEG)
    np.maximum.at(alpha, dst, cand)
    win = cand >= alpha[dst]
    bp[dst[win]] = ids[win]
    touched = np.unique(dst)
    if touched.size == 0:
        raise RuntimeError(
            f"decode_faster: no tokens survived at frame {frame_idx} — "
            "beam too tight or loglik/graph mismatch")
    scores = alpha[touched]
    best = scores.max()
    cutoff = best - beam
    if max_active and (scores > cutoff).sum() > max_active:
        cutoff = max(cutoff,
                     np.partition(scores, -max_active)[-max_active])
    dead = touched[alpha[touched] < cutoff]
    alpha[dead] = NEG
    bp[dead] = -1
    active = touched[alpha[touched] > NEG / 2]
    grown = _eps_closure(cg, alpha, bp, active, cutoff)
    if grown.size:
        active = np.unique(np.concatenate([active, grown]))
    return alpha, active


def _traceback_full(cg: CompiledGraph, bps, state: int,
                    level: int) -> tuple:
    """Walk backpointer rows from (level, state) to (0, start); returns
    (words, tids): the word ids on the path and one transition-id per
    frame (emitting arc). `bps` is indexable per level."""
    words, tids = [], []
    while not (level == 0 and state == cg.start
               and bps[0][state] == -1):
        arc = int(bps[level][state])
        if arc < 0:
            raise RuntimeError("decode_faster: broken backpointer chain")
        if arc >= cg.num_em:
            e = arc - cg.num_em
            if cg.eps_word[e]:
                words.append(int(cg.eps_word[e]))
            state = int(cg.eps_src[e])
        else:
            if cg.em_word[arc]:
                words.append(int(cg.em_word[arc]))
            tids.append(int(cg.em_tid[arc]))
            state = int(cg.em_src[arc])
            level -= 1
    words.reverse()
    tids.reverse()
    return words, tids


def _traceback(cg: CompiledGraph, bps, state: int, level: int) -> list:
    return _traceback_full(cg, bps, state, level)[0]


def decode_faster(graph: DecodingGraph, loglik: np.ndarray,
                  acoustic_scale: float = 1.0, beam: float = 16.0,
                  max_active: int = 0) -> DecodeResult:
    """Viterbi beam search over [T, num_pdfs] scaled log-likelihoods.

    Runs in the native core; `KLT_DECODE_IMPL=python` runs the numpy
    implementation instead. Large graphs take the sparse core: the dense
    [(T+1), ns] int32 backpointer table would take 3.6 GB an utterance
    at 1.5M states x 600 frames, so above 64M entries the core stores
    O(T * active) backpointers and tracebacks in C++, with the same
    search semantics (words and scores identical).
    `KLT_DECODE_SPARSE=1/0` forces either core."""
    cg = compile_graph(graph)
    T = np.asarray(loglik).shape[0]
    ns = cg.ns

    if os.environ.get("KLT_DECODE_IMPL", "auto") != "python":
        sparse_env = os.environ.get("KLT_DECODE_SPARSE", "")
        use_sparse = (sparse_env == "1"
                      or (sparse_env != "0"
                          and (T + 1) * ns > 64_000_000))
        em = np.ascontiguousarray(loglik, np.float64)
        if use_sparse:
            words, _tids, score, reached = decode_faster_sparse_native(
                ns, cg.em_ptr, cg.em_dst, cg.em_pdf, cg.em_w,
                cg.em_src, cg.em_word, cg.em_tid,
                cg.eps_ptr, cg.eps_dst, cg.eps_w,
                cg.eps_src, cg.eps_word,
                em, cg.final, acoustic_scale, beam, max_active, cg.start)
            return DecodeResult(words=[int(w) for w in words],
                                score=score, reached_final=reached)
        alpha, bps = decode_faster_native(
            ns, cg.em_ptr, cg.em_dst, cg.em_pdf, cg.em_w,
            cg.eps_ptr, cg.eps_dst, cg.eps_w, em,
            acoustic_scale, beam, max_active, cg.start)
    else:
        em = acoustic_scale * np.asarray(loglik, np.float64)
        alpha = np.full(ns, NEG)
        alpha[cg.start] = 0.0
        bps = np.full((T + 1, ns), -1, np.int32)
        _eps_closure(cg, alpha, bps[0], np.asarray([cg.start]))
        active = np.nonzero(alpha > NEG / 2)[0]
        for t in range(T):
            alpha, active = _frame_step(cg, alpha, active, em[t], beam,
                                        max_active, bps[t + 1], t)

    total = alpha + cg.final
    reached = bool(total.max() > NEG / 2)
    state = int(np.argmax(total if reached else alpha))
    score = float(total[state] if reached else alpha[state])
    words = _traceback(cg, bps, state, T)
    return DecodeResult(words=words, score=score, reached_final=reached)


def decode_faster_tokens(graph: DecodingGraph, loglik: np.ndarray,
                         acoustic_scale: float = 1.0, beam: float = 16.0,
                         max_active: int = 0) -> DecodeResult:
    """Token-passing reference implementation (hash of active tokens,
    linked-trace backpointers) — the independent cross-check for
    decode_faster."""
    em = acoustic_scale * np.asarray(loglik, np.float64)
    tokens: dict = {graph.start: (0.0, None)}
    _process_nonemitting(graph, tokens, -np.inf)

    for t in range(em.shape[0]):
        frame = em[t]
        nxt: dict = {}
        best = NEG
        for s, (sc, tr) in tokens.items():
            for arc in graph.arcs[s]:
                if arc.pdf < 0:
                    continue
                ns = sc + arc.weight + frame[arc.pdf]
                old = nxt.get(arc.dst)
                if old is None or ns > old[0]:
                    nxt[arc.dst] = (
                        ns, Trace(tr, arc.word) if arc.word else tr)
                    if ns > best:
                        best = ns
        cutoff = best - beam
        if max_active and len(nxt) > max_active:
            cutoff = max(cutoff, heapq.nlargest(
                max_active, (sc for sc, _ in nxt.values()))[-1])
        tokens = {s: v for s, v in nxt.items() if v[0] >= cutoff}
        _process_nonemitting(graph, tokens, cutoff)
        if not tokens:
            raise RuntimeError(
                f"decode_faster: no tokens survived at frame {t} — "
                "beam too tight or loglik/graph mismatch")

    # terminate: prefer tokens at final states (+ final weight)
    best_s, best_sc, reached = None, NEG, False
    for s, (sc, _tr) in tokens.items():
        f = graph.final[s]
        if f > NEG / 2 and sc + f > best_sc:
            best_s, best_sc, reached = s, sc + f, True
    if best_s is None:  # upstream fallback when no final state is active
        for s, (sc, _tr) in tokens.items():
            if sc > best_sc:
                best_s, best_sc = s, sc
    words = []
    tr = tokens[best_s][1]
    while tr is not None:
        words.append(tr.word)
        tr = tr.prev
    words.reverse()
    return DecodeResult(words=words, score=best_sc, reached_final=reached)
