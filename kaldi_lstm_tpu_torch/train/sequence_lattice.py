"""Lattice-based sequence-discriminative training math (MMI / MPE /
sMBR), this package's copy of ``kaldi_lstm_tpu.train.sequence_lattice``:
the host-side lattice machinery of upstream nnet1's
nnet-train-mmi-sequential / nnet-train-mpe-sequential (upstream
src/lat/lattice-functions.cc LatticeAcousticRescore,
LatticeForwardBackward, LatticeForwardBackwardMpeVariants), on the
port's lattice stack (io/lattice.py). Host numpy and Python, like the
JAX package's module; the card computes only the network's loglik and
the update (tools/nnet_train_mmi_sequential.py).

Conventions (upstream-compatible):

* Lattices are raw state-level `Lattice`s (one transition-id per
  emitting arc per frame); CompactLattices are converted first.
* Costs are negated log-probs; a path's log-probability under scales
  (lm_scale, acoustic_scale) is -(lm_scale*graph + acoustic_scale*ac).
* Acoustic rescoring replaces each emitting arc's acoustic cost with
  -loglik[frame, pdf(tid)] (plus old_acoustic_scale times the old
  cost, upstream's --old-acoustic-scale).
* The returned error derivatives are w.r.t. the network's pre-softmax
  activations y with the acoustic scale FOLDED OUT, exactly like the
  upstream binaries (they inject (gamma_den - delta_num) resp.
  -gamma_mpe without the kappa factor; kappa effectively rescales the
  learning rate). Injecting at the logits is exact because every diff
  row sums to zero, so the log-softmax normalizer's gradient vanishes.

The lattice-FREE implementations (exact phone-loop denominator) live
in train/sequence.py; these lattice-based ones serve the upstream recipe
flow (decode lattices once, train several iterations against them).
"""

from __future__ import annotations

import math

import numpy as np

from kaldi_lstm_tpu_torch.io.lattice import (
    CompactLattice,
    Lattice,
    LatticeArc,
    _topo_order_lat,
    compact_to_lattice,
)

NEG = -math.inf


def as_raw_lattice(lat, copy: bool = False) -> Lattice:
    """CompactLattice -> Lattice (always a fresh object); copy=True also
    duplicates an already-raw Lattice so in-place rescoring can't leak
    into the caller's table."""
    if isinstance(lat, CompactLattice):
        return compact_to_lattice(lat)
    if copy:
        out = Lattice(start=lat.start, final=dict(lat.final))
        out.arcs = [[LatticeArc(a.ilabel, a.olabel, a.graph_cost,
                                a.acoustic_cost, a.dst) for a in arcs]
                    for arcs in lat.arcs]
        return out
    return lat


def state_frames(lat: Lattice, order: list | None = None) -> list:
    """frame[s] = number of emitting arcs consumed on any path from the
    start to s (decoder lattices are time-synchronous; raises if not).
    Unreachable states get None."""
    if order is None:
        order = _topo_order_lat(lat)
    frame = [None] * lat.num_states
    frame[lat.start] = 0
    for s in order:
        if frame[s] is None:
            continue
        for a in lat.arcs[s]:
            nf = frame[s] + (1 if a.ilabel else 0)
            if frame[a.dst] is None:
                frame[a.dst] = nf
            elif frame[a.dst] != nf:
                raise ValueError(
                    "lattice is not time-synchronous "
                    f"(state {a.dst} at frames {frame[a.dst]} and {nf})")
    return frame


def lattice_acoustic_rescore(lat: Lattice, loglik: np.ndarray, tm,
                             old_acoustic_scale: float = 0.0) -> Lattice:
    """In-place acoustic rescore (upstream LatticeAcousticRescore,
    src/lat/lattice-functions.cc): every emitting arc's acoustic cost
    becomes old_acoustic_scale*old - loglik[frame, pdf(tid)]; epsilon
    arcs and final weights only keep their old cost scaled. Returns lat.

    loglik: [T, num_pdfs] acoustic log-likelihoods from the current
    model (log-posterior minus log-prior in the hybrid recipe)."""
    order = _topo_order_lat(lat)
    frame = state_frames(lat, order)
    T = loglik.shape[0]
    for s in order:
        if frame[s] is None:
            continue
        for a in lat.arcs[s]:
            if a.ilabel:
                t = frame[s]
                if t >= T:
                    raise ValueError(
                        f"lattice has more frames than loglik ({t} >= {T})")
                pdf = int(tm.id2pdf[a.ilabel])
                a.acoustic_cost = (old_acoustic_scale * a.acoustic_cost
                                   - float(loglik[t, pdf]))
            else:
                a.acoustic_cost *= old_acoustic_scale
    for s, (g, ac) in list(lat.final.items()):
        lat.final[s] = (g, ac * old_acoustic_scale)
    return lat


def _alpha_beta(lat: Lattice, order, acoustic_scale: float,
                lm_scale: float):
    """Log-semiring forward/backward scores per state; returns
    (alpha, beta, logZ)."""
    n = lat.num_states

    def w(a):
        return -(lm_scale * a.graph_cost
                 + acoustic_scale * a.acoustic_cost)

    alpha = [NEG] * n
    alpha[lat.start] = 0.0
    for s in order:
        if alpha[s] == NEG:
            continue
        for a in lat.arcs[s]:
            alpha[a.dst] = float(np.logaddexp(alpha[a.dst],
                                              alpha[s] + w(a)))
    beta = [NEG] * n
    for s, fin in lat.final.items():
        beta[s] = -(lm_scale * fin[0] + acoustic_scale * fin[1])
    for s in reversed(order):
        for a in lat.arcs[s]:
            if beta[a.dst] != NEG:
                beta[s] = float(np.logaddexp(beta[s], w(a) + beta[a.dst]))
    logZ = beta[lat.start]
    if not math.isfinite(logZ):
        raise ValueError("lattice has no complete path")
    return alpha, beta, logZ


def lattice_forward_backward(lat: Lattice, acoustic_scale: float = 1.0,
                             lm_scale: float = 1.0):
    """(logZ, post): total scaled log-likelihood of the lattice and
    per-frame transition-id occupancies gamma (upstream
    LatticeForwardBackward). post[t] is a dict tid -> gamma; gammas sum
    to 1 per frame."""
    order = _topo_order_lat(lat)
    frame = state_frames(lat, order)
    alpha, beta, logZ = _alpha_beta(lat, order, acoustic_scale, lm_scale)

    def w(a):
        return -(lm_scale * a.graph_cost
                 + acoustic_scale * a.acoustic_cost)

    T = max((frame[s] + 1 for s in range(lat.num_states)
             if frame[s] is not None and any(a.ilabel
                                             for a in lat.arcs[s])),
            default=0)
    post = [dict() for _ in range(T)]
    for s in order:
        if alpha[s] == NEG or frame[s] is None:
            continue
        for a in lat.arcs[s]:
            if not a.ilabel or beta[a.dst] == NEG:
                continue
            g = math.exp(alpha[s] + w(a) + beta[a.dst] - logZ)
            t = frame[s]
            post[t][a.ilabel] = post[t].get(a.ilabel, 0.0) + g
    return logZ, post


def mmi_errors(lat: Lattice, tm, num_tids: np.ndarray,
               loglik: np.ndarray, acoustic_scale: float = 0.1,
               lm_scale: float = 1.0, old_acoustic_scale: float = 0.0,
               drop_frames: bool = True):
    """One utterance of MMI-sequential training math (upstream
    nnet-train-mmi-sequential.cc main loop, steps 5-9):

    1. rescore the denominator lattice's acoustics with the current
       model's loglik;
    2. forward-backward under (lm_scale, acoustic_scale) -> gamma_den;
    3. numerator score = acoustic_scale * sum_t loglik[t, num_pdf(t)];
    4. objective F = num - logZ_den (to be maximized);
    5. diff(t, pdf) = gamma_den(t, pdf) - delta(pdf = num_pdf(t)) —
       the DESCENT derivative w.r.t. pre-softmax activations with the
       acoustic scale folded out (upstream convention);
    6. frame dropping (upstream --drop-frames, default true): frames
       whose numerator pdf has zero denominator occupancy get a zero
       diff row (the MMI gradient there is pathological).

    Returns (obj, diff [T, num_pdfs] float32, num_frames_dropped,
    frame_acc) where frame_acc counts frames whose max-gamma pdf equals
    the numerator pdf (progress diagnostic, like upstream's per-utt
    frame accuracy logging)."""
    lat = lattice_acoustic_rescore(as_raw_lattice(lat, copy=True), loglik, tm,
                                   old_acoustic_scale)
    logZ, post = lattice_forward_backward(lat, acoustic_scale, lm_scale)
    T, K = loglik.shape
    if len(post) != T or len(num_tids) != T:
        raise ValueError(
            f"frame count mismatch: lattice {len(post)}, loglik {T}, "
            f"alignment {len(num_tids)}")
    num_pdfs = tm.transition_ids_to_pdfs(num_tids)
    diff = np.zeros((T, K), np.float32)
    dropped = 0
    correct = 0
    for t in range(T):
        row = diff[t]
        best_pdf, best_g, num_g = -1, 0.0, 0.0
        for tid, g in post[t].items():
            pdf = int(tm.id2pdf[tid])
            row[pdf] += g
            if row[pdf] > best_g:
                best_g, best_pdf = row[pdf], pdf
        num_g = row[num_pdfs[t]]
        if best_pdf == num_pdfs[t]:
            correct += 1
        if drop_frames and num_g < 1e-20:
            row[:] = 0.0
            dropped += 1
            continue
        row[num_pdfs[t]] -= 1.0
    num_like = acoustic_scale * float(
        loglik[np.arange(T), num_pdfs].sum())
    obj = num_like - logZ
    return obj, diff, dropped, correct


def frame_accuracies(lat: Lattice, tm, num_tids: np.ndarray,
                     criterion: str = "smbr",
                     silence_phones: frozenset = frozenset(),
                     one_silence_class: bool = False):
    """Per-(frame, tid) accuracy table for the MPE/sMBR criteria
    (upstream LatticeForwardBackwardMpeVariants' frame_acc):

    smbr: 1 if pdf(tid) == pdf(num_tid[t]); mpe: 1 if phone matches.
    Default silence treatment (one_silence_class=false): silence-phone
    hypotheses always score 0. one_silence_class=true: any silence
    hypothesis against a silence reference scores 1.

    Returns a callable acc(t, tid) -> float."""
    ref_pdf = tm.transition_ids_to_pdfs(num_tids)
    id2tstate = np.asarray(tm.id2tstate)
    phones = np.asarray([t[0] for t in tm.tuples], np.int32)

    def phone_of(tid):
        return int(phones[id2tstate[tid] - 1])

    ref_phone = np.asarray([phone_of(int(t)) for t in num_tids], np.int32)

    def acc(t: int, tid: int) -> float:
        phone = phone_of(tid)
        if criterion == "mpe":
            match = phone == ref_phone[t]
        else:
            match = int(tm.id2pdf[tid]) == ref_pdf[t]
        if one_silence_class:
            if phone in silence_phones and ref_phone[t] in silence_phones:
                return 1.0
            return 1.0 if match and phone not in silence_phones else 0.0
        return 1.0 if match and phone not in silence_phones else 0.0

    return acc


def mpe_forward_backward(lat: Lattice, acc, frame,
                         acoustic_scale: float = 1.0,
                         lm_scale: float = 1.0):
    """First-order (expectation-semiring) lattice forward-backward for
    MPE/sMBR (upstream LatticeForwardBackwardMpeVariants): alongside the
    occupancies gamma it propagates the posterior-weighted average
    accumulated accuracy alpha_acc/beta_acc, yielding

        E[A]             — the utterance's expected accuracy, and
        post[t][tid]     — gamma(a) * (Abar(a) - E[A]), the derivative
                           of E[A] w.r.t. the arc's scaled loglik,

    where Abar(a) = alpha_acc[src] + acc(a) + beta_acc[dst] is the
    expected total path accuracy conditioned on passing through arc a.

    `acc(t, tid)` scores one arc; `frame` is the per-state frame map.
    Returns (EA, post)."""
    order = _topo_order_lat(lat)
    n = lat.num_states
    alpha, beta, logZ = _alpha_beta(lat, order, acoustic_scale, lm_scale)

    def w(a):
        return -(lm_scale * a.graph_cost
                 + acoustic_scale * a.acoustic_cost)

    # alpha_acc[s]: expected accuracy accumulated by a random (posterior-
    # weighted) path from the start to s
    alpha_acc = [0.0] * n
    for s in order:
        if alpha[s] == NEG:
            continue
        for a in lat.arcs[s]:
            if alpha[a.dst] == NEG:
                continue
            p = math.exp(alpha[s] + w(a) - alpha[a.dst])
            a_val = acc(frame[s], a.ilabel) if a.ilabel else 0.0
            alpha_acc[a.dst] += p * (alpha_acc[s] + a_val)
    # beta_acc[s]: expected accuracy still to come from s to a final
    beta_acc = [0.0] * n
    for s in reversed(order):
        if beta[s] == NEG or frame[s] is None:
            # frame[s] is None for states co-reachable to a final but not
            # reachable from the start (untrimmed lattices); no reachable
            # predecessor consumes their beta_acc, so skipping is exact
            continue
        total = 0.0
        for a in lat.arcs[s]:
            if beta[a.dst] == NEG:
                continue
            p = math.exp(w(a) + beta[a.dst] - beta[s])
            a_val = acc(frame[s], a.ilabel) if a.ilabel else 0.0
            total += p * (a_val + beta_acc[a.dst])
        # final-state share (weight exp(final_w - beta[s])) contributes 0
        beta_acc[s] = total

    EA = beta_acc[lat.start]

    T = max((frame[s] + 1 for s in range(n)
             if frame[s] is not None and any(a.ilabel
                                             for a in lat.arcs[s])),
            default=0)
    post = [dict() for _ in range(T)]
    for s in order:
        if alpha[s] == NEG or frame[s] is None:
            continue
        for a in lat.arcs[s]:
            if not a.ilabel or beta[a.dst] == NEG:
                continue
            g = math.exp(alpha[s] + w(a) + beta[a.dst] - logZ)
            abar = (alpha_acc[s] + acc(frame[s], a.ilabel)
                    + beta_acc[a.dst])
            t = frame[s]
            post[t][a.ilabel] = (post[t].get(a.ilabel, 0.0)
                                 + g * (abar - EA))
    return EA, post


def mpe_errors(lat: Lattice, tm, num_tids: np.ndarray,
               loglik: np.ndarray, acoustic_scale: float = 0.1,
               lm_scale: float = 1.0, old_acoustic_scale: float = 0.0,
               criterion: str = "smbr",
               silence_phones: frozenset = frozenset(),
               one_silence_class: bool = False):
    """One utterance of MPE/sMBR-sequential training math (upstream
    nnet-train-mpe-sequential.cc): rescore, expectation-semiring
    forward-backward, and the descent derivative w.r.t. pre-softmax
    activations diff(t, pdf) = -sum_{arcs pdf@t} gamma*(Abar - E[A])
    (negated: we maximize E[A]; acoustic scale folded out as upstream).

    Returns (EA, diff [T, num_pdfs] float32)."""
    lat = lattice_acoustic_rescore(as_raw_lattice(lat, copy=True), loglik, tm,
                                   old_acoustic_scale)
    order = _topo_order_lat(lat)
    frame = state_frames(lat, order)
    acc = frame_accuracies(lat, tm, num_tids, criterion,
                           silence_phones, one_silence_class)
    EA, post = mpe_forward_backward(lat, acc, frame, acoustic_scale,
                                    lm_scale)
    T, K = loglik.shape
    if len(post) != T or len(num_tids) != T:
        raise ValueError(
            f"frame count mismatch: lattice {len(post)}, loglik {T}, "
            f"alignment {len(num_tids)}")
    diff = np.zeros((T, K), np.float32)
    for t in range(T):
        for tid, v in post[t].items():
            diff[t, int(tm.id2pdf[tid])] -= v
    return EA, diff
