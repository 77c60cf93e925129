"""Sequence-discriminative (MMI, sMBR, MPE) training, lattice-free over
the phone-loop graph; PyTorch edition of ``kaldi_lstm_tpu.train.sequence``.

The denominator is an exact logsumexp forward over the phone-loop graph
built from the transition model (decode/viterbi.py's PhoneLoopGraph),
so

    F = log p(X | num path) - log p(X | den graph)

is differentiable by autograd: its gradient w.r.t. the pre-softmax
activations is the (numerator - denominator) posterior difference, the
denominator occupancies coming from the backward of the recursion.

The recursions (dense, structured and split-arc) are loops over the
padded T of torch ops on the tensors' device, where the JAX package
has a ``lax.scan``: a masked frame carries alpha through unchanged and
padded emissions are 0, exactly as there. The graphs hold their
tensors on one device, given when they are built.

The expected accuracy E[A] = sum_t,s gamma_t(s) acc(t, s) is the
directional derivative of logZ along the accuracy tensor (the JAX
package takes it with ``jax.jvp``). Here gamma = d logZ / d em comes
from ``torch.autograd.grad``, with ``create_graph`` when E[A] itself
needs a gradient; that second-order pass reaches only the den-graph
ops, so the network between the parameters and the emissions (K1/K2 on
the card) is differentiated once.

Numerator: the aligned state path's acoustic score plus its transition
log-probs. Acoustic scale applies to both terms.
"""

from __future__ import annotations

from typing import NamedTuple

import numpy as np
import torch

from kaldi_lstm_tpu_torch.decode.viterbi import NEG, PhoneLoopGraph


def _f32(a, device) -> torch.Tensor:
    return torch.as_tensor(np.asarray(a, np.float32), device=device)


def _idx(a, device) -> torch.Tensor:
    return torch.as_tensor(np.asarray(a, np.int64), device=device)


class DenGraph(NamedTuple):
    """Dense denominator graph (from PhoneLoopGraph)."""
    logA: torch.Tensor        # [Ns, Ns]
    start_logp: torch.Tensor  # [Ns]
    final_logp: torch.Tensor  # [Ns]
    state_pdf: torch.Tensor   # [Ns] int64
    state_phone: torch.Tensor  # [Ns] int64 (MPE phone accuracy)

    @classmethod
    def from_phone_loop(cls, g: PhoneLoopGraph, device=None) -> "DenGraph":
        # one pdf per state: exact for <Triples>-era models only; split
        # self-loop/forward pdfs take SplitDenGraph
        if not np.array_equal(np.asarray(g.self_pdf),
                              np.asarray(g.state_pdf)):
            raise ValueError(
                "sequence training's dense denominator graph needs "
                "self_loop_pdf == forward_pdf (<Triples>-era model); "
                "this model has split pdfs")
        return cls(_f32(g.logA, device), _f32(g.start_logp, device),
                   _f32(g.final_logp, device), _idx(g.state_pdf, device),
                   _idx(g.state_phone, device))


class PhoneLoopDenGraph(NamedTuple):
    """Structured phone-loop denominator graph with an O(Ns)-per-frame
    forward: each state has a self-loop (`log_self`), an in-phone
    successor arc i -> i+1 (`log_fwd`, NEG at phone-final states) and an
    exit (`log_final`) into one shared non-emitting junction that fans
    out to every phone entry with `loop_logp`. The junction factorizes
    the dense matrix's all-pairs loop-back block into one logsumexp pool
    per frame. A 1-emitting-state phone's self-loop and re-entry stay
    separate lse terms (DenGraph merges them with max)."""

    log_self: torch.Tensor    # [Ns]
    log_fwd: torch.Tensor     # [Ns] arc i -> i+1 (NEG at phone-final)
    log_final: torch.Tensor   # [Ns] arc into the loop junction / final
    is_entry: torch.Tensor    # [Ns] bool
    loop_logp: torch.Tensor   # scalar: junction -> each entry
    state_pdf: torch.Tensor   # [Ns] int64
    state_phone: torch.Tensor  # [Ns] int64

    @property
    def start_logp(self) -> torch.Tensor:
        return torch.where(self.is_entry, self.loop_logp, NEG)

    @property
    def final_logp(self) -> torch.Tensor:
        return self.log_final

    @classmethod
    def from_transition_model(cls, tm, phone_insertion_penalty: float = 0.0,
                              device=None) -> "PhoneLoopDenGraph":
        """O(Ns)-memory construction straight from the transition model.
        Raises ValueError for split-pdf models or topologies with skip
        arcs (those take SplitDenGraph / DenGraph)."""
        tuples = tm.tuples
        ns = len(tuples)
        index = {(p, s): i for i, (p, s, _f, _l) in enumerate(tuples)}
        log_self = np.full(ns, NEG)
        log_fwd = np.full(ns, NEG)
        log_final = np.full(ns, NEG)
        state_pdf = np.zeros(ns, np.int64)
        state_phone = np.zeros(ns, np.int64)
        for i, (phone, hmm_state, fwd, slf) in enumerate(tuples):
            if slf != fwd:
                raise ValueError(
                    "phone-loop den graph needs self_loop_pdf == "
                    "forward_pdf (<Triples>-era model)")
            state_pdf[i] = fwd
            state_phone[i] = phone
            topo_state = tm.topo.entry_for_phone(phone)[hmm_state]
            for dst, prob in topo_state.transitions:
                logp = np.log(max(prob, 1e-20))
                if dst == hmm_state:
                    log_self[i] = np.logaddexp(log_self[i], logp)
                elif (phone, dst) in index:
                    if index[(phone, dst)] != i + 1:
                        raise ValueError(
                            "phone-loop den graph needs a strictly "
                            "sequential (no-skip) Bakis topology; use "
                            "the dense DenGraph")
                    log_fwd[i] = np.logaddexp(log_fwd[i], logp)
                else:
                    log_final[i] = np.logaddexp(log_final[i], logp)
        phones = sorted({p for p, *_ in tuples})
        is_entry = np.zeros(ns, bool)
        for phone in phones:
            s0 = min(s for p, s, _f, _l in tuples if p == phone)
            is_entry[index[(phone, s0)]] = True
        loop_logp = -np.log(len(phones)) - phone_insertion_penalty
        return cls(_f32(log_self, device), _f32(log_fwd, device),
                   _f32(log_final, device),
                   torch.as_tensor(is_entry, device=device),
                   _f32(loop_logp, device), _idx(state_pdf, device),
                   _idx(state_phone, device))


class SplitDenGraph(NamedTuple):
    """Denominator graph with per-arc emissions, for chain-style
    `<Tuples>` models whose self-loop pdf differs from the forward pdf.
    Frame t is scored by the pdf of the arc that consumes it:
    `self_pdf[j]` on state j's self-loop, `state_pdf[i]` (the source's
    forward pdf) on every other arc in `logA_enter`, the final exit arc
    that consumes the last real frame included. Exit terms are folded in
    at each utterance's last real frame, so trailing padding needs no
    per-utterance final gather."""

    logA_enter: torch.Tensor   # [Ns, Ns] non-self arcs (incl. loop-backs)
    self_logp: torch.Tensor    # [Ns]
    start_logp: torch.Tensor   # [Ns]
    final_logp: torch.Tensor   # [Ns]
    state_pdf: torch.Tensor    # [Ns] forward pdf
    self_pdf: torch.Tensor     # [Ns] self-loop pdf
    state_phone: torch.Tensor  # [Ns]

    @classmethod
    def from_phone_loop(cls, g: PhoneLoopGraph,
                        device=None) -> "SplitDenGraph":
        return cls(_f32(g.logA_enter, device), _f32(g.self_logp, device),
                   _f32(g.start_logp, device), _f32(g.final_logp, device),
                   _idx(g.state_pdf, device), _idx(g.self_pdf, device),
                   _idx(g.state_phone, device))


def _lse(*xs: torch.Tensor) -> torch.Tensor:
    """Elementwise log(sum(exp(x))) of same-shaped tensors. Used in place
    of ``torch.logaddexp``, whose second derivative is NaN where one
    operand is NEG and the other finite (E[A]'s gradient takes it)."""
    return torch.logsumexp(torch.stack(xs), dim=0)


def _split_logZ_from_em(graph: SplitDenGraph, em_fwd: torch.Tensor,
                        em_self: torch.Tensor,
                        mask: torch.Tensor) -> torch.Tensor:
    """log p(X | den graph) [B] from per-arc emissions em_fwd/em_self
    [B, T, Ns] (padded frames 0), in the source-consumed formulation."""
    B, T = mask.shape
    alpha = graph.start_logp[None].expand(B, -1)
    # frame t is an utterance's LAST real frame iff m_t=1 and m_{t+1}=0
    m_next = torch.cat([mask[:, 1:], torch.zeros_like(mask[:, :1])], 1)
    is_last = (mask * (1.0 - m_next)) > 0
    real = mask > 0
    logZ = torch.full((B,), NEG, dtype=em_fwd.dtype, device=em_fwd.device)
    for t in range(T):
        em_f, em_s = em_fwd[:, t], em_self[:, t]
        exit_term = torch.logsumexp(alpha + em_f + graph.final_logp[None],
                                    dim=-1)
        logZ = torch.where(is_last[:, t], _lse(logZ, exit_term), logZ)
        src = alpha + em_f                                   # leave via fwd
        enter = torch.logsumexp(src[:, :, None] + graph.logA_enter[None],
                                dim=1)
        stay = alpha + graph.self_logp[None] + em_s
        alpha = torch.where(real[:, t, None], _lse(enter, stay), alpha)
    return logZ


def _prepare_em_split(graph: SplitDenGraph, loglik: torch.Tensor,
                      mask: torch.Tensor, acoustic_scale: float
                      ) -> tuple[torch.Tensor, torch.Tensor]:
    keep = mask[:, :, None] > 0
    em_fwd = acoustic_scale * loglik[:, :, graph.state_pdf]
    em_self = acoustic_scale * loglik[:, :, graph.self_pdf]
    return (torch.where(keep, em_fwd, 0.0), torch.where(keep, em_self, 0.0))


def _struct_step(graph: PhoneLoopDenGraph, alpha: torch.Tensor,
                 em_t: torch.Tensor) -> torch.Tensor:
    """One O(Ns) lse-forward frame over the structured phone loop."""
    pool = torch.logsumexp(alpha + graph.log_final[None], dim=-1)
    stay = alpha + graph.log_self[None]
    shifted = alpha + graph.log_fwd[None]                    # arc i->i+1
    fwd = torch.cat([torch.full_like(shifted[:, :1], NEG),
                     shifted[:, :-1]], dim=1)
    enter = torch.where(graph.is_entry[None],
                        pool[:, None] + graph.loop_logp, NEG)
    return _lse(stay, fwd, enter) + em_t


def _den_logZ_from_em(graph, em: torch.Tensor,
                      mask: torch.Tensor) -> torch.Tensor:
    """Exact logsumexp forward on prepared per-state emissions em
    [B, T, Ns] (padded frames 0); log p(X | den graph) [B]. Dense
    [Ns, Ns] relaxation for DenGraph, the O(Ns) structured recurrence
    for PhoneLoopDenGraph."""
    structured = isinstance(graph, PhoneLoopDenGraph)
    alpha = graph.start_logp[None, :] + em[:, 0]             # [B, Ns]
    real = mask > 0
    for t in range(1, em.shape[1]):
        if structured:
            nxt = _struct_step(graph, alpha, em[:, t])
        else:
            nxt = torch.logsumexp(alpha[:, :, None] + graph.logA[None],
                                  dim=1) + em[:, t]
        alpha = torch.where(real[:, t, None], nxt, alpha)
    return torch.logsumexp(alpha + graph.final_logp[None], dim=-1)


def _prepare_em(graph, loglik: torch.Tensor, mask: torch.Tensor,
                acoustic_scale: float) -> torch.Tensor:
    em = acoustic_scale * loglik[:, :, graph.state_pdf]      # [B, T, Ns]
    return torch.where(mask[:, :, None] > 0, em, 0.0)


def den_logprob(graph, loglik: torch.Tensor, mask: torch.Tensor,
                acoustic_scale: float = 1.0) -> torch.Tensor:
    """log p(X | den graph) for a batch: loglik [B, T, K] acoustic
    log-likelihoods, mask [B, T] (1 = real frame). Returns [B]."""
    if isinstance(graph, SplitDenGraph):
        em_f, em_s = _prepare_em_split(graph, loglik, mask, acoustic_scale)
        return _split_logZ_from_em(graph, em_f, em_s, mask)
    return _den_logZ_from_em(
        graph, _prepare_em(graph, loglik, mask, acoustic_scale), mask)


def _pick(loglik: torch.Tensor, pdfs: torch.Tensor) -> torch.Tensor:
    return torch.gather(loglik, -1, pdfs[..., None])[..., 0]


def _last_real(mask: torch.Tensor) -> torch.Tensor:
    """[B, 1] index of each utterance's last real frame."""
    return (mask.sum(-1).to(torch.int64) - 1)[:, None]


def num_logprob(graph, loglik: torch.Tensor, states: torch.Tensor,
                mask: torch.Tensor, acoustic_scale: float = 1.0,
                with_transitions: bool = True) -> torch.Tensor:
    """log p(X, num path): the acoustic score of the aligned graph-state
    path plus (optionally) its transition/start/final log-probs.
    states: [B, T] graph-state alignment (alignment_to_states)."""
    states = states.to(torch.int64)
    if isinstance(graph, SplitDenGraph):
        return _num_logprob_split(graph, loglik, states, mask,
                                  acoustic_scale, with_transitions)
    ac = acoustic_scale * _pick(loglik, graph.state_pdf[states])
    total = torch.sum(ac * mask, dim=-1)
    if with_transitions:
        lm = graph.start_logp[states[:, 0]]
        prev, cur = states[:, :-1], states[:, 1:]
        if isinstance(graph, PhoneLoopDenGraph):
            stay = cur == prev
            step_fwd = (cur == prev + 1) & (
                graph.state_phone[cur] == graph.state_phone[prev])
            loop = (graph.log_final[prev] + graph.loop_logp
                    + torch.where(graph.is_entry[cur], 0.0, NEG))
            # a same-state pair on a 1-emitting-state phone is a self-loop
            # OR a re-entry; score it max(self, re-entry), the dense
            # graph's Viterbi-merged diagonal, so both graph types agree
            stay_score = torch.maximum(graph.log_self[prev], loop)
            trans = torch.where(stay, stay_score,
                                torch.where(step_fwd, graph.log_fwd[prev],
                                            loop))           # [B, T-1]
        else:
            trans = graph.logA[prev, cur]                    # [B, T-1]
        # transitions only between consecutive REAL frames, and the final
        # prob at the last real frame's state
        lm = lm + torch.sum(trans * mask[:, 1:], dim=-1)
        lm = lm + graph.final_logp[
            torch.gather(states, 1, _last_real(mask))[:, 0]]
        total = total + lm
    return total


def _num_logprob_split(graph: SplitDenGraph, loglik: torch.Tensor,
                       states: torch.Tensor, mask: torch.Tensor,
                       acoustic_scale: float,
                       with_transitions: bool) -> torch.Tensor:
    """Numerator path score with per-arc emissions. Frame t (t < last)
    is consumed by the arc states[t] -> states[t+1]: its self-loop pdf
    when the pair stays AND the self-loop beats the (1-state phone)
    re-entry diagonal, otherwise the source's forward pdf. The last real
    frame is consumed by the exit arc (forward pdf + final_logp)."""
    em_f = acoustic_scale * _pick(loglik, graph.state_pdf[states])
    em_s = acoustic_scale * _pick(loglik, graph.self_pdf[states])
    prev, cur = states[:, :-1], states[:, 1:]
    stay = cur == prev
    self_sc = graph.self_logp[prev] + em_s[:, :-1]
    enter_sc = graph.logA_enter[prev, cur] + em_f[:, :-1]
    last = _last_real(mask)
    em_last = torch.gather(em_f, 1, last)[:, 0]
    if not with_transitions:
        # same arc choice, emission part only
        pair_em = torch.where(stay & (self_sc >= enter_sc), em_s[:, :-1],
                              em_f[:, :-1])
        return torch.sum(pair_em * mask[:, 1:], dim=-1) + em_last
    pair_sc = torch.where(stay, torch.maximum(self_sc, enter_sc), enter_sc)
    total = graph.start_logp[states[:, 0]] \
        + torch.sum(pair_sc * mask[:, 1:], dim=-1)
    s_last = torch.gather(states, 1, last)[:, 0]
    return total + em_last + graph.final_logp[s_last]


def mmi_objective(graph, loglik: torch.Tensor, states: torch.Tensor,
                  mask: torch.Tensor, acoustic_scale: float = 1.0
                  ) -> tuple[torch.Tensor, torch.Tensor]:
    """Summed negative MMI objective and the per-batch den-minus-num
    (the reported 'mmi per frame' statistic, detached). Minimize the
    first."""
    num = num_logprob(graph, loglik, states, mask, acoustic_scale)
    den = den_logprob(graph, loglik, mask, acoustic_scale)
    return torch.sum(den - num), (den - num).detach()


def _directional(logZ_fn, ems: tuple, directions: tuple) -> torch.Tensor:
    """sum over (t, s) of (d logZ / d em) * direction, per utterance [B]:
    the jvp of logZ at `ems` along `directions`. The occupancies come
    from a backward through logZ_fn, kept in the graph (create_graph)
    when the caller needs E[A]'s own gradient."""
    train = torch.is_grad_enabled() and any(e.requires_grad for e in ems)
    with torch.enable_grad():
        xs = ems if train else tuple(e.detach().requires_grad_(True)
                                     for e in ems)
        gammas = torch.autograd.grad(logZ_fn(*xs).sum(), xs,
                                     create_graph=train)
    ea = sum((g * d).sum(dim=(1, 2)) for g, d in zip(gammas, directions))
    return ea if train else ea.detach()


def expected_accuracy(graph, loglik: torch.Tensor, ref_pdfs: torch.Tensor,
                      mask: torch.Tensor, acoustic_scale: float = 1.0,
                      criterion: str = "smbr",
                      silence_phones: torch.Tensor | None = None
                      ) -> torch.Tensor:
    """E[A] per utterance [B]: the posterior-expected frame accuracy under
    the denominator graph, the lattice-free form of nnet1's sMBR / MPE
    criteria. With logZ(em) the denominator log-partition,
    d logZ / d em(t, s) = gamma_t(s), so E[A] = sum gamma * acc, and its
    gradient (the classic gamma * (acc - E[A]) MPE backward) falls out of
    autograd.

    criterion "smbr" scores state accuracy by pdf match against
    `ref_pdfs` [B, T]; "mpe" by phone match (ref_pdfs then holds
    per-frame reference PHONES). `silence_phones` (int tensor) excludes
    those phones from the accuracy. Differentiable w.r.t. loglik.
    """
    if criterion not in ("smbr", "mpe"):
        raise ValueError(f"unknown criterion {criterion!r}")
    ref = ref_pdfs.to(torch.int64)

    def _acc(pdf_per_state):
        per_state = pdf_per_state if criterion == "smbr" \
            else graph.state_phone
        acc = (per_state[None, None, :] == ref[:, :, None]).to(
            torch.float32) * mask[:, :, None]
        if silence_phones is not None and silence_phones.numel():
            sil = torch.isin(graph.state_phone,
                             silence_phones.to(graph.state_phone))
            acc = acc * (~sil)[None, None, :].to(torch.float32)
        return acc

    if isinstance(graph, SplitDenGraph):
        # a frame taken on a self-loop arc is accurate iff its SELF pdf
        # matches
        em_f, em_s = _prepare_em_split(graph, loglik, mask, acoustic_scale)
        return _directional(
            lambda ef, es: _split_logZ_from_em(graph, ef, es, mask),
            (em_f, em_s), (_acc(graph.state_pdf), _acc(graph.self_pdf)))
    em = _prepare_em(graph, loglik, mask, acoustic_scale)
    return _directional(lambda e: _den_logZ_from_em(graph, e, mask),
                        (em,), (_acc(graph.state_pdf),))


def smbr_objective(graph, loglik: torch.Tensor, ref_pdfs: torch.Tensor,
                   mask: torch.Tensor, acoustic_scale: float = 1.0,
                   criterion: str = "smbr",
                   silence_phones: torch.Tensor | None = None
                   ) -> tuple[torch.Tensor, torch.Tensor]:
    """(negated summed E[A], per-utterance E[A] detached); minimize the
    first (gradient ascent on expected accuracy)."""
    ea = expected_accuracy(graph, loglik, ref_pdfs, mask, acoustic_scale,
                           criterion, silence_phones)
    return -torch.sum(ea), ea.detach()


def den_graph_for(tm, phone_insertion_penalty: float = 0.0, device=None):
    """The denominator graph for a transition model: the O(Ns)
    structured phone loop when the topology allows it, the dense
    DenGraph for skip-arc triples-era topologies, and the per-arc
    SplitDenGraph for chain-style `<Tuples>` models with split
    self-loop/forward pdfs."""
    try:
        return PhoneLoopDenGraph.from_transition_model(
            tm, phone_insertion_penalty, device)
    except ValueError:
        g = PhoneLoopGraph.from_transition_model(
            tm, phone_insertion_penalty=phone_insertion_penalty)
        if np.array_equal(np.asarray(g.self_pdf), np.asarray(g.state_pdf)):
            return DenGraph.from_phone_loop(g, device)
        return SplitDenGraph.from_phone_loop(g, device)


def alignment_to_states(tm, tids: np.ndarray) -> np.ndarray:
    """Transition-id alignment -> graph-state (tuple-index) path, the
    numerator path for MMI (TransitionModel.id2tstate is 1-based)."""
    tstates = np.asarray(tm.id2tstate)[np.asarray(tids, np.int64)]
    return (tstates - 1).astype(np.int32)
