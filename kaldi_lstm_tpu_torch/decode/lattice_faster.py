"""Lattice-generating Viterbi beam search — the equivalent of upstream
Kaldi's `latgen-faster-mapped` (the decoder that Kaldi recipes pipe
nnet-forward scores into), emitting raw state-level lattices with
separated graph/acoustic costs. This package's copy of
``kaldi_lstm_tpu.decode.lattice_faster``.

Algorithm (decoder/lattice-faster-decoder.cc semantics, vectorized):

* Forward = the same CSR frontier relaxation as `decode_faster`
  (scatter-max per frame + epsilon closure, beam/max_active pruning),
  but per level it RECORDS every arc that lands within `lattice_beam`
  of its destination's best score — a provably sufficient superset of
  the final lattice (an arc with cand < alpha[dst] - lat_beam satisfies
  cand + beta[dst] < alpha[dst] + beta[dst] - lat_beam <= best - lat_beam,
  so it cannot survive global pruning).
* Backward = exact cost-to-go (beta) over the recorded arcs, level
  T..0 (emitting step then reverse epsilon closure, mirroring the
  forward's relax-then-close order); arcs are kept iff
  alpha[src] + arc + beta[dst] >= best_total - lattice_beam — the same
  criterion LatticeFasterDecoder's PruneActiveTokens converges to.
* Lattice states are the surviving (level, graph-state) pairs; emitting
  arcs carry (ilabel = transition-id, acoustic_cost = -scaled loglik),
  epsilon arcs carry word labels and graph cost only. Costs are negated
  natural-log probs (Kaldi lattice convention); the acoustic scale is
  folded in, as with upstream latgen's decodable.

The forward runs in the native core (csrc/kltdecode.cc through
io/native.py); `KLT_DECODE_IMPL=python` asks for the numpy forward
below, with the same semantics. The backward and the lattice build are
numpy and Python.

The result is the "raw" (non-determinized) lattice — what latgen
produces with --determinize-lattice=false; `lattice_to_compact` converts
arc-by-arc for CompactLattice arks.
"""

from __future__ import annotations

import os

import numpy as np

from kaldi_lstm_tpu_torch.decode.faster import (
    NEG,
    CompiledGraph,
    _eps_closure,
    _out_arcs,
    compile_graph,
)
from kaldi_lstm_tpu_torch.decode.graph import DecodingGraph
from kaldi_lstm_tpu_torch.io.lattice import Lattice, LatticeArc
from kaldi_lstm_tpu_torch.io.native import (
    SparseAlphas,
    decode_lattice2_native,
    decode_lattice_native,
)


def _record_em(cg: CompiledGraph, alpha_prev, alpha_new, active_prev,
               em_t, lattice_beam: float):
    """Emitting arcs from the previous level's active states landing
    within lattice_beam of their destination's post-pruning score."""
    ids = _out_arcs(cg.em_ptr, active_prev)
    if ids.size == 0:
        return ids
    cand = alpha_prev[cg.em_src[ids]] + cg.em_w[ids] \
        + em_t[cg.em_pdf[ids]]
    dst_score = alpha_new[cg.em_dst[ids]]
    keep = (dst_score > NEG / 2) & (cand >= dst_score - lattice_beam)
    return ids[keep]


def _record_eps(cg: CompiledGraph, alpha, active, lattice_beam: float):
    """Epsilon arcs within a level whose relaxation is within
    lattice_beam of the destination's (post-closure) score."""
    if cg.eps_src.size == 0 or active.size == 0:
        return np.zeros(0, np.int64)
    ids = _out_arcs(cg.eps_ptr, active)
    if ids.size == 0:
        return ids
    cand = alpha[cg.eps_src[ids]] + cg.eps_w[ids]
    dst_score = alpha[cg.eps_dst[ids]]
    keep = (alpha[cg.eps_src[ids]] > NEG / 2) & (dst_score > NEG / 2) \
        & (cand >= dst_score - lattice_beam)
    return ids[keep]


def _reverse_eps(cg: CompiledGraph, beta, eps_ids, max_passes: int = 32):
    """beta[src] = max(beta[src], w + beta[dst]) over the recorded
    epsilon arcs of one level, to a fixed point (the epsilon subgraph is
    a shallow DAG; strict improvement also terminates on zero cycles)."""
    if eps_ids.size == 0:
        return
    src = cg.eps_src[eps_ids]
    dst = cg.eps_dst[eps_ids]
    w = cg.eps_w[eps_ids]
    for _ in range(max_passes):
        cand = w + beta[dst]
        old = beta[src].copy()
        np.maximum.at(beta, src, cand)
        if not (beta[src] > old).any():
            break


def decode_lattice_faster(graph: DecodingGraph, loglik: np.ndarray,
                          acoustic_scale: float = 1.0,
                          beam: float = 16.0,
                          lattice_beam: float = 8.0,
                          max_active: int = 0) -> Lattice:
    """Decode [T, num_pdfs] log-likelihoods into a pruned raw Lattice.

    Memory is O(T * num_states) for the per-level score snapshots plus
    the recorded arc lists — the same order as decode_faster's
    backpointer table."""
    cg = compile_graph(graph)
    em = acoustic_scale * np.asarray(loglik, np.float64)
    T = em.shape[0]
    ns = cg.ns

    if os.environ.get("KLT_DECODE_IMPL", "auto") != "python":
        # sparse-alpha forward by default: the dense [(T+1), ns]
        # snapshot table costs seconds of page-fault fill an utterance
        # at ~1M states against milliseconds of search;
        # KLT_LATGEN_DENSE=1 forces the dense forward for A/B
        native = (decode_lattice_native
                  if os.environ.get("KLT_LATGEN_DENSE", "") == "1"
                  else decode_lattice2_native)
        alphas, em_kept, eps_kept = native(
            ns, cg.em_ptr, cg.em_dst, cg.em_pdf, cg.em_w,
            cg.eps_ptr, cg.eps_dst, cg.eps_w,
            np.ascontiguousarray(em), beam, lattice_beam,
            max_active, cg.start)
    else:
        alphas = np.full((T + 1, ns), NEG)
        alpha = alphas[0]
        alpha[cg.start] = 0.0
        bp_dummy = np.full(ns, -1, np.int32)
        _eps_closure(cg, alpha, bp_dummy, np.asarray([cg.start]))
        active = np.nonzero(alpha > NEG / 2)[0]

        em_kept = []      # per frame: recorded emitting arc ids
        eps_kept = [_record_eps(cg, alpha, active, lattice_beam)]

        for t in range(T):
            prev_alpha, prev_active = alphas[t], active
            ids = _out_arcs(cg.em_ptr, prev_active)
            dst = cg.em_dst[ids]
            cand = prev_alpha[cg.em_src[ids]] + cg.em_w[ids] \
                + em[t][cg.em_pdf[ids]]
            alpha = alphas[t + 1]
            np.maximum.at(alpha, dst, cand)
            touched = np.unique(dst)
            if touched.size == 0:
                raise RuntimeError(
                    f"decode_lattice_faster: no tokens survived at frame "
                    f"{t} — beam too tight or loglik/graph mismatch")
            scores = alpha[touched]
            best = scores.max()
            cutoff = best - beam
            if max_active and (scores > cutoff).sum() > max_active:
                cutoff = max(cutoff,
                             np.partition(scores,
                                          -max_active)[-max_active])
            alpha[touched[alpha[touched] < cutoff]] = NEG
            active = touched[alpha[touched] > NEG / 2]
            grown = _eps_closure(cg, alpha, bp_dummy, active, cutoff)
            if grown.size:
                active = np.unique(np.concatenate([active, grown]))
            em_kept.append(_record_em(cg, prev_alpha, alpha, prev_active,
                                      em[t], lattice_beam))
            eps_kept.append(_record_eps(cg, alpha, active, lattice_beam))

    # ---- backward: exact beta over the recorded arcs --------------------
    # only two beta rows live at a time (levels t and t+1): a full
    # [(T+1), ns] table costs more to ALLOCATE than the native forward
    # pass takes
    alpha_T = (alphas[T].to_dense(ns)
               if isinstance(alphas, SparseAlphas) else alphas[T])
    beta = np.full(ns, NEG)
    fin_active = (alpha_T > NEG / 2) & (cg.final > NEG / 2)
    reached_final = bool(fin_active.any())
    if reached_final:
        beta[fin_active] = cg.final[fin_active]
        best_total = float((alpha_T + beta)[fin_active].max())
        final_cost = {int(s): -float(cg.final[s])
                      for s in np.nonzero(fin_active)[0]}
    else:
        # upstream fallback: no final state active — all sufficiently
        # good last-level states become final with Weight::One
        act = alpha_T > NEG / 2
        best_alpha = float(alpha_T[act].max())
        good = act & (alpha_T >= best_alpha - lattice_beam)
        beta[good] = 0.0
        best_total = best_alpha
        final_cost = {int(s): 0.0 for s in np.nonzero(good)[0]}
    _reverse_eps(cg, beta, eps_kept[T])
    beta_T = beta.copy()    # needed for the final-weight pruning below
    thresh = best_total - lattice_beam

    kept_em_final: list = [None] * T
    kept_eps_final: list = [None] * (T + 1)

    def prune_eps(level, beta_l):
        ids = eps_kept[level]
        if ids.size == 0:
            kept_eps_final[level] = ids
            return
        tot = alphas[level][cg.eps_src[ids]] + cg.eps_w[ids] \
            + beta_l[cg.eps_dst[ids]]
        kept_eps_final[level] = ids[tot >= thresh - 1e-9]

    prune_eps(T, beta)
    for t in range(T - 1, -1, -1):
        ids = em_kept[t]
        beta_next = beta
        beta_t = np.full(ns, NEG)
        if ids.size:
            arc_cost = cg.em_w[ids] + em[t][cg.em_pdf[ids]]
            contrib = arc_cost + beta_next[cg.em_dst[ids]]
            np.maximum.at(beta_t, cg.em_src[ids], contrib)
            tot = alphas[t][cg.em_src[ids]] + contrib
            kept_em_final[t] = ids[tot >= thresh - 1e-9]
        else:
            kept_em_final[t] = ids
        _reverse_eps(cg, beta_t, eps_kept[t])
        prune_eps(t, beta_t)
        beta = beta_t

    # ---- build the lattice ----------------------------------------------
    lat = Lattice()
    state_id: dict = {}

    def sid(level: int, s: int) -> int:
        key = (level, s)
        idx = state_id.get(key)
        if idx is None:
            idx = lat.add_state()
            state_id[key] = idx
        return idx

    lat.start = sid(0, cg.start)
    for level in range(T + 1):
        for e in kept_eps_final[level]:
            lat.arcs[sid(level, int(cg.eps_src[e]))].append(LatticeArc(
                0, int(cg.eps_word[e]), -float(cg.eps_w[e]), 0.0,
                sid(level, int(cg.eps_dst[e]))))
        if level < T:
            for e in kept_em_final[level]:
                a = int(e)
                lat.arcs[sid(level, int(cg.em_src[a]))].append(LatticeArc(
                    int(cg.em_tid[a]), int(cg.em_word[a]),
                    -float(cg.em_w[a]),
                    -float(em[level][cg.em_pdf[a]]),
                    sid(level + 1, int(cg.em_dst[a]))))
    for s, cost in final_cost.items():
        # only finals that survive global pruning get a final weight
        if alphas[T][s] + beta_T[s] >= thresh - 1e-9:
            lat.final[sid(T, s)] = (cost, 0.0)
    lat.reached_final = reached_final
    return lat
