"""WFST-free Viterbi decoder over a phone-loop built from a
TransitionModel; this package's copy of ``kaldi_lstm_tpu.decode.viterbi``
(sequence training's denominator graph is built from its
`PhoneLoopGraph`).

A self-contained decoder for phone-level scoring: a phone-loop graph
(every phone HMM in parallel, uniform loop-back) and exact max-product
Viterbi over the scaled log-likelihoods that tools/nnet_forward.py emits
(log-posterior minus log-prior). No lexicon/LM — hypotheses are phone
sequences, which is what a synthetic-task PER needs.

Emission convention (matches decode/graph.py and the upstream decodable
semantics): each *arc* out of an emitting HMM state consumes one frame
scored by that arc's transition-id pdf — self-loop arcs score the
state's self_loop_pdf, every other arc (forward, loop-back, final) its
forward_pdf. For <Triples>-era models the two coincide and this reduces
to per-state emission; for chain-style <Tuples> models with split pdfs
the decode is exact.

Decoding is host-side numpy (like Kaldi's decoder): the per-utterance
[T, Ns] dynamic program is tiny next to the AM scoring.
"""

from __future__ import annotations

from dataclasses import dataclass

import numpy as np

from kaldi_lstm_tpu_torch.io.transition_model import TransitionModel

NEG = -1e30


@dataclass
class PhoneLoopGraph:
    """Dense phone-loop decoding graph.

    One graph state per (phone, emitting hmm-state) tuple of the
    transition model. Arcs are split by emission role: `self_logp[i]` is
    state i's topology self-loop (scored with `self_pdf[i]`);
    `logA_enter[i, j]` holds every other arc i -> j (scored with
    `state_pdf[i]`, the forward pdf) — within-phone forward arcs from the
    topology, plus loop-backs: reaching a phone's final (non-emitting)
    state loops back to every phone's entry state with
    log(1/num_phones) + `phone_insertion_penalty`. The diagonal of
    `logA_enter` can hold a 1-state phone's re-entry loop-back, which
    stays distinct from its self-loop (a new phone token with a
    forward-pdf frame vs a continuation with a self-loop-pdf frame).

    `logA` is the merged max of both (triples-era consumers like
    sequence training's DenGraph use one matrix with per-state
    emissions; that view is only exact when self_pdf == state_pdf,
    which DenGraph.from_phone_loop enforces).
    """

    logA: np.ndarray        # [Ns, Ns] merged arc log-probs (NEG = none)
    start_logp: np.ndarray  # [Ns]
    final_logp: np.ndarray  # [Ns]
    state_pdf: np.ndarray   # [Ns] forward pdf (non-self-loop frames)
    state_phone: np.ndarray  # [Ns]
    is_entry: np.ndarray    # [Ns] bool: phone entry state
    self_pdf: np.ndarray    # [Ns] self-loop pdf (== state_pdf for triples)
    self_logp: np.ndarray   # [Ns] topology self-loop log-prob (NEG = none)
    logA_enter: np.ndarray  # [Ns, Ns] non-self-loop arcs only

    @classmethod
    def from_transition_model(cls, tm: TransitionModel,
                              phone_insertion_penalty: float = 0.0
                              ) -> "PhoneLoopGraph":
        ns = len(tm.tuples)
        index = {(p, s): i for i, (p, s, _f, _l) in enumerate(tm.tuples)}
        logA_enter = np.full((ns, ns), NEG, np.float64)
        self_logp = np.full(ns, NEG, np.float64)
        final_logp = np.full(ns, NEG, np.float64)
        state_pdf = np.zeros(ns, np.int32)
        self_pdf = np.zeros(ns, np.int32)
        state_phone = np.zeros(ns, np.int32)
        is_entry = np.zeros(ns, bool)

        phones = sorted({p for p, *_ in tm.tuples})
        loop_logp = -np.log(len(phones)) - phone_insertion_penalty
        entries = []
        for phone in phones:
            # entry state = lowest emitting hmm-state of the phone
            s0 = min(s for p, s, _f, _l in tm.tuples if p == phone)
            entries.append(index[(phone, s0)])

        for i, (phone, hmm_state, fwd, slf) in enumerate(tm.tuples):
            state_pdf[i] = fwd
            self_pdf[i] = slf
            state_phone[i] = phone
            topo_state = tm.topo.entry_for_phone(phone)[hmm_state]
            for dst, prob in topo_state.transitions:
                logp = np.log(max(prob, 1e-20))
                if dst == hmm_state:
                    self_logp[i] = max(self_logp[i], logp)
                elif (phone, dst) in index:
                    j = index[(phone, dst)]
                    # merged parallel arcs keep the best (max-product
                    # Viterbi semantics)
                    logA_enter[i, j] = max(logA_enter[i, j], logp)
                else:
                    # arc into the non-emitting final state: utterance may
                    # end here, or loop back to any phone's entry
                    final_logp[i] = max(final_logp[i], logp)
                    for e in entries:
                        logA_enter[i, e] = max(logA_enter[i, e],
                                               logp + loop_logp)
        start_logp = np.full(ns, NEG, np.float64)
        for e in entries:
            start_logp[e] = loop_logp  # uniform + penalty, like loop-back
            is_entry[e] = True
        logA = logA_enter.copy()
        d = np.arange(ns)
        logA[d, d] = np.maximum(logA[d, d], self_logp)
        return cls(logA, start_logp, final_logp, state_pdf, state_phone,
                   is_entry, self_pdf, self_logp, logA_enter)


def viterbi_decode(graph: PhoneLoopGraph, loglik: np.ndarray,
                   acoustic_scale: float = 1.0
                   ) -> tuple[list[int], float]:
    """Exact Viterbi over [T, num_pdfs] log-likelihoods.

    Frame t is scored by the pdf of the arc consumed at t (see module
    docstring): the DP state is "graph state frame t is consumed FROM".
    Returns (phone sequence, total log-prob). A new phone token starts
    at t=0 and whenever the best path takes a non-self-loop arc into a
    phone-entry state (including a 1-state phone's re-entry loop-back,
    which the per-state formulation could not distinguish from its
    self-loop).
    """
    T = loglik.shape[0]
    ns = graph.state_pdf.shape[0]
    em_fwd = acoustic_scale * loglik[:, graph.state_pdf]    # [T, Ns]
    if np.array_equal(graph.self_pdf, graph.state_pdf):
        em_self = em_fwd
    else:
        em_self = acoustic_scale * loglik[:, graph.self_pdf]

    # alpha[j] = best score of frames 0..t-1 with frame t to be consumed
    # from state j; arcs consuming frame t add em on their SOURCE state
    alpha = graph.start_logp.copy()
    bp = np.zeros((T, ns), np.int32)
    entered = np.zeros((T, ns), bool)
    idx = np.arange(ns)
    for t in range(T - 1):
        src = alpha + em_fwd[t]                             # leave via fwd
        scores = src[:, None] + graph.logA_enter            # [Ns, Ns]
        bp_t = np.argmax(scores, axis=0)
        enter_best = scores[bp_t, idx]
        stay = alpha + graph.self_logp + em_self[t]
        take_enter = enter_best > stay
        alpha = np.where(take_enter, enter_best, stay)
        bp[t + 1] = np.where(take_enter, bp_t, idx)
        entered[t + 1] = take_enter
    # final frame consumed by the arc into the final state
    alpha_final = alpha + em_fwd[T - 1] + graph.final_logp
    best_end = int(np.argmax(alpha_final))
    total = float(alpha_final[best_end])

    states = np.zeros(T, np.int32)
    states[T - 1] = best_end
    for t in range(T - 1, 0, -1):
        states[t - 1] = bp[t, states[t]]

    phones = [int(graph.state_phone[states[0]])]
    for t in range(1, T):
        s = states[t]
        if graph.is_entry[s] and entered[t, s]:
            phones.append(int(graph.state_phone[s]))
    return phones, total
