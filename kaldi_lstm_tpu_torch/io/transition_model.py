"""Kaldi TransitionModel / HmmTopology reader-writer and the
transition-id -> pdf-id mapping.

This package's copy of ``kaldi_lstm_tpu.io.transition_model``: the part
that the decoders, the aligner, the ali-to-* tools and the word corpus
generator use. Kaldi recipes start
from a GMM transition model (``ali-to-pdf final.mdl ark:ali.ark ark:- |
ali-to-post ark:- ark:-``): the alignments on disk are *transition-ids*;
the network is trained on *pdf-ids* (senones). This module supplies
enough of upstream hmm/transition-model.{h,cc} +
hmm/hmm-topology.{h,cc} to load and write a model (text or binary,
<Triples> or <Tuples> era) and derive the id2pdf table.

Derived mapping (ComputeDerived in upstream): tuples are the sorted
(phone, hmm_state, forward_pdf[, self_loop_pdf]) list; transition-state
s (1-based) = tuples index + 1; each owns as many transition-ids as its
topology state has transitions; a transition whose destination equals
its own hmm_state is a self-loop and maps to self_loop_pdf, all others
to forward_pdf. pdf-ids returned by ali_to_pdf are 0-based; a
<Triples>-era model has forward == self-loop pdf.
"""

from __future__ import annotations

import io
from dataclasses import dataclass, field
from typing import Sequence

import numpy as np

from kaldi_lstm_tpu_torch.io.kaldi_io import (
    KaldiInput,
    KaldiOutput,
    read_float,
    read_int32,
    read_int_vector,
    read_token,
    read_vector,
    write_float,
    write_int32,
    write_int_vector,
    write_token,
    write_vector,
)

K_NO_PDF = -1


@dataclass
class HmmState:
    """One emitting/final state of a topology entry."""
    forward_pdf_class: int
    self_loop_pdf_class: int
    # (destination hmm-state, initial transition prob)
    transitions: list[tuple[int, float]] = field(default_factory=list)


@dataclass
class HmmTopology:
    phones: list[int]                 # sorted, 1-based
    phone2idx: list[int]              # phone -> entries index (-1 = none)
    entries: list[list[HmmState]]

    def entry_for_phone(self, phone: int) -> list[HmmState]:
        return self.entries[self.phone2idx[phone]]

    def is_hmm(self) -> bool:
        return all(s.forward_pdf_class == s.self_loop_pdf_class
                   for e in self.entries for s in e)

    # -- serialization ---------------------------------------------------
    def write(self, out: KaldiOutput) -> None:
        write_token(out, "<Topology>")
        if out.binary:
            write_int_vector(out, self.phones)
            write_int_vector(out, self.phone2idx)
            if not self.is_hmm():
                write_int32(out, -1)  # marker of the fwd/self split era
            write_int32(out, len(self.entries))
            for entry in self.entries:
                write_int32(out, len(entry))
                for st in entry:
                    write_int32(out, st.forward_pdf_class)
                    if not self.is_hmm():
                        write_int32(out, st.self_loop_pdf_class)
                    write_int32(out, len(st.transitions))
                    for dst, p in st.transitions:
                        write_int32(out, dst)
                        write_float(out, p)
            write_token(out, "</Topology>")
        else:
            out.stream.write(b"\n")
            # group phones by entry index for <ForPhones> blocks
            by_idx: dict[int, list[int]] = {}
            for ph in self.phones:
                by_idx.setdefault(self.phone2idx[ph], []).append(ph)
            for idx in sorted(by_idx):
                out.stream.write(b"<TopologyEntry>\n<ForPhones>\n")
                out.stream.write(" ".join(
                    str(p) for p in by_idx[idx]).encode())
                out.stream.write(b"\n</ForPhones>\n")
                for j, st in enumerate(self.entries[idx]):
                    line = [f"<State> {j}"]
                    if st.forward_pdf_class != K_NO_PDF:
                        if st.self_loop_pdf_class != st.forward_pdf_class:
                            line.append(
                                f"<ForwardPdfClass> {st.forward_pdf_class}"
                                f" <SelfLoopPdfClass> "
                                f"{st.self_loop_pdf_class}")
                        else:
                            line.append(
                                f"<PdfClass> {st.forward_pdf_class}")
                    for dst, p in st.transitions:
                        line.append(f"<Transition> {dst} {p}")
                    line.append("</State>")
                    out.stream.write((" ".join(line) + "\n").encode())
                out.stream.write(b"</TopologyEntry>\n")
            out.stream.write(b"</Topology>\n")

    @classmethod
    def read(cls, inp: KaldiInput) -> "HmmTopology":
        tok = read_token(inp)
        if tok != "<Topology>":
            raise ValueError(f"expected <Topology>, got {tok}")
        if inp.binary:
            phones = [int(x) for x in read_int_vector(inp)]
            phone2idx = [int(x) for x in read_int_vector(inp)]
            sz = read_int32(inp)
            is_hmm = True
            if sz == -1:
                is_hmm = False
                sz = read_int32(inp)
            entries = []
            for _ in range(sz):
                nstates = read_int32(inp)
                entry = []
                for _ in range(nstates):
                    fwd = read_int32(inp)
                    slf = fwd if is_hmm else read_int32(inp)
                    ntr = read_int32(inp)
                    trans = [(read_int32(inp), read_float(inp))
                             for _ in range(ntr)]
                    entry.append(HmmState(fwd, slf, trans))
                entries.append(entry)
            tok = read_token(inp)
            if tok != "</Topology>":
                raise ValueError(f"expected </Topology>, got {tok}")
            return cls(phones, phone2idx, entries)
        return cls._read_text(inp)

    @classmethod
    def _read_text(cls, inp: KaldiInput) -> "HmmTopology":
        entries: list[list[HmmState]] = []
        phone_sets: list[list[int]] = []
        while True:
            tok = read_token(inp)
            if tok == "</Topology>":
                break
            if tok != "<TopologyEntry>":
                raise ValueError(f"unexpected token {tok} in <Topology>")
            tok = read_token(inp)
            if tok != "<ForPhones>":
                raise ValueError("expected <ForPhones>")
            phones_here: list[int] = []
            while True:
                tok = read_token(inp)
                if tok == "</ForPhones>":
                    break
                phones_here.append(int(tok))
            states: list[HmmState] = []
            while True:
                tok = read_token(inp)
                if tok == "</TopologyEntry>":
                    break
                if tok != "<State>":
                    raise ValueError(f"unexpected token {tok} in entry")
                sidx = int(read_token(inp))
                if sidx != len(states):
                    raise ValueError("non-sequential <State> numbering")
                fwd = slf = K_NO_PDF
                trans: list[tuple[int, float]] = []
                while True:
                    tok = read_token(inp)
                    if tok == "</State>":
                        break
                    if tok == "<PdfClass>":
                        fwd = slf = int(read_token(inp))
                    elif tok == "<ForwardPdfClass>":
                        fwd = int(read_token(inp))
                    elif tok == "<SelfLoopPdfClass>":
                        slf = int(read_token(inp))
                    elif tok == "<Transition>":
                        dst = int(read_token(inp))
                        p = float(read_token(inp))
                        trans.append((dst, p))
                    else:
                        raise ValueError(f"unexpected token {tok} "
                                         "in <State>")
                states.append(HmmState(fwd, slf, trans))
            entries.append(states)
            phone_sets.append(phones_here)
        all_phones = sorted(p for ps in phone_sets for p in ps)
        phone2idx = [-1] * (max(all_phones) + 1 if all_phones else 1)
        for idx, ps in enumerate(phone_sets):
            for p in ps:
                phone2idx[p] = idx
        return cls(all_phones, phone2idx, entries)


@dataclass
class TransitionModel:
    topo: HmmTopology
    # (phone, hmm_state, forward_pdf, self_loop_pdf), sorted
    tuples: list[tuple[int, int, int, int]]
    log_probs: np.ndarray  # [num_transition_ids + 1], index 0 unused

    def __post_init__(self):
        self._compute_derived()

    # -- derived tables (upstream ComputeDerived) ------------------------
    def _compute_derived(self) -> None:
        # state2id[ts] = first transition-id of transition-state ts
        self.state2id = [0, 1]  # ts is 1-based; tid 0 unused
        cur = 1
        id2pdf = [-1]
        id2phone = [-1]
        id2self = [False]
        id2final = [False]
        self.id2tstate = [0]
        for ts, (phone, hmm_state, fwd, slf) in enumerate(self.tuples,
                                                          start=1):
            entry = self.topo.entry_for_phone(phone)
            st = entry[hmm_state]
            for dst, _p in st.transitions:
                id2pdf.append(slf if dst == hmm_state else fwd)
                id2phone.append(phone)
                id2self.append(dst == hmm_state)
                # "final" = transition into the entry's non-emitting
                # final state (upstream TransitionModel::IsFinal)
                id2final.append(not entry[dst].transitions)
                self.id2tstate.append(ts)
                cur += 1
            self.state2id.append(cur)
        self.id2pdf = np.asarray(id2pdf, np.int32)
        self.id2phone = np.asarray(id2phone, np.int32)
        self.id2self_loop = np.asarray(id2self, bool)
        self.id2final = np.asarray(id2final, bool)
        self.num_transition_ids = cur - 1

    @property
    def num_pdfs(self) -> int:
        return int(max((max(t[2], t[3]) for t in self.tuples),
                       default=-1)) + 1

    def transition_id_to_pdf(self, tid: int) -> int:
        return int(self.id2pdf[tid])

    def transition_ids_to_pdfs(self, tids) -> np.ndarray:
        """Vectorized tid -> pdf (the ali-to-pdf hot path)."""
        tids = np.asarray(tids, np.int64)
        if tids.size and (tids.min() < 1
                          or tids.max() > self.num_transition_ids):
            bad = tids[(tids < 1) | (tids > self.num_transition_ids)][0]
            raise ValueError(f"transition-id {bad} out of range "
                             f"[1, {self.num_transition_ids}]")
        return self.id2pdf[tids]

    def transition_ids_to_phones(self, tids) -> np.ndarray:
        """Vectorized tid -> phone (ali-to-phones --per-frame)."""
        tids = np.asarray(tids, np.int64)
        if tids.size and (tids.min() < 1
                          or tids.max() > self.num_transition_ids):
            bad = tids[(tids < 1) | (tids > self.num_transition_ids)][0]
            raise ValueError(f"transition-id {bad} out of range "
                             f"[1, {self.num_transition_ids}]")
        return self.id2phone[tids]

    def split_to_phones(self, tids) -> list[np.ndarray]:
        """Split a per-frame transition-id alignment into per-phone
        segments (upstream hmm-utils SplitToPhones): a segment ends at
        a final transition (into the entry's non-emitting state) or,
        for defective alignments, where the phone changes."""
        tids = np.asarray(tids, np.int64)
        segs = []
        start = 0
        for i in range(len(tids)):
            end_here = self.id2final[tids[i]] or (
                i + 1 < len(tids)
                and self.id2phone[tids[i + 1]] != self.id2phone[tids[i]])
            if end_here or i == len(tids) - 1:
                segs.append(tids[start:i + 1])
                start = i + 1
        return segs

    # -- serialization ---------------------------------------------------
    def write(self, out: KaldiOutput) -> None:
        write_token(out, "<TransitionModel>")
        self.topo.write(out)
        is_hmm = self.topo.is_hmm()
        write_token(out, "<Tuples>" if not is_hmm else "<Triples>")
        if not out.binary:
            out.stream.write(b"\n")
        write_int32(out, len(self.tuples))
        if not out.binary:
            out.stream.write(b"\n")
        for phone, hmm_state, fwd, slf in self.tuples:
            write_int32(out, phone)
            write_int32(out, hmm_state)
            write_int32(out, fwd)
            if not is_hmm:
                write_int32(out, slf)
            if not out.binary:
                out.stream.write(b"\n")
        write_token(out, "</Tuples>" if not is_hmm else "</Triples>")
        write_token(out, "<LogProbs>")
        if not out.binary:
            out.stream.write(b"\n")
        write_vector(out, np.asarray(self.log_probs, np.float32))
        if not out.binary:
            out.stream.write(b"\n")
        write_token(out, "</LogProbs>")
        write_token(out, "</TransitionModel>")
        if not out.binary:
            out.stream.write(b"\n")

    def dump(self, filename: str, binary: bool = True) -> None:
        with open(filename, "wb") as f:
            self.write(KaldiOutput(f, binary=binary))

    @classmethod
    def read(cls, inp: KaldiInput) -> "TransitionModel":
        tok = read_token(inp)
        if tok != "<TransitionModel>":
            raise ValueError(f"expected <TransitionModel>, got {tok}")
        topo = HmmTopology.read(inp)
        tok = read_token(inp)
        if tok not in ("<Triples>", "<Tuples>"):
            raise ValueError(f"expected <Triples>/<Tuples>, got {tok}")
        with_self = tok == "<Tuples>"
        n = read_int32(inp)
        tuples = []
        for _ in range(n):
            phone = read_int32(inp)
            hmm_state = read_int32(inp)
            fwd = read_int32(inp)
            slf = read_int32(inp) if with_self else fwd
            tuples.append((phone, hmm_state, fwd, slf))
        tok = read_token(inp)
        if tok not in ("</Triples>", "</Tuples>"):
            raise ValueError(f"expected close of tuples, got {tok}")
        tok = read_token(inp)
        if tok != "<LogProbs>":
            raise ValueError(f"expected <LogProbs>, got {tok}")
        log_probs = read_vector(inp)
        tok = read_token(inp)
        if tok != "</LogProbs>":
            raise ValueError(f"expected </LogProbs>, got {tok}")
        # optional trailing token (</TransitionModel>)
        return cls(topo, tuples, log_probs)

    @classmethod
    def load(cls, filename: str) -> "TransitionModel":
        with open(filename, "rb") as f:
            buffered = f if isinstance(f, io.BufferedReader) \
                else io.BufferedReader(f)
            return cls.read(KaldiInput(buffered))


def make_linear_topology(num_phones: int, states_per_phone: int = 3,
                         self_loop_prob: float = 0.5) -> HmmTopology:
    """Bakis left-to-right topology shared by all phones: each emitting
    state has a self-loop and a forward transition, plus one final
    non-emitting state (standard Kaldi monophone shape)."""
    states = []
    for j in range(states_per_phone):
        states.append(HmmState(j, j, [(j, self_loop_prob),
                                      (j + 1, 1.0 - self_loop_prob)]))
    states.append(HmmState(K_NO_PDF, K_NO_PDF, []))  # final state
    phones = list(range(1, num_phones + 1))
    phone2idx = [-1] + [0] * num_phones
    return HmmTopology(phones, phone2idx, [states])


def make_monophone_transition_model(num_phones: int,
                                    states_per_phone: int = 3,
                                    self_loop_prob: float = 0.5
                                    ) -> TransitionModel:
    """Monophone model with one pdf per (phone, state):
    pdf = (phone-1) * states_per_phone + state. num_pdfs =
    num_phones * states_per_phone."""
    topo = make_linear_topology(num_phones, states_per_phone,
                                self_loop_prob)
    tuples = []
    for phone in range(1, num_phones + 1):
        for j in range(states_per_phone):
            pdf = (phone - 1) * states_per_phone + j
            tuples.append((phone, j, pdf, pdf))
    # log-probs of the initial topology probabilities, index 0 unused
    ntids = sum(
        len(topo.entry_for_phone(p)[s].transitions)
        for p, s, _, _ in tuples)
    log_probs = np.zeros(ntids + 1, np.float32)
    tid = 1
    for phone, s, _, _ in tuples:
        for _dst, prob in topo.entry_for_phone(phone)[s].transitions:
            log_probs[tid] = np.log(max(prob, 1e-20))
            tid += 1
    return TransitionModel(topo, tuples, log_probs)


def make_chain_topology(num_phones: int,
                        self_loop_prob: float = 0.5) -> HmmTopology:
    """Chain-style 1-emitting-state topology with SPLIT pdf-classes:
    forward_pdf_class 0 scored on the frame the state's forward arc
    consumes, self_loop_pdf_class 1 on self-loop frames (upstream
    'chain' topology shape, <Tuples>-era serialization)."""
    states = [HmmState(0, 1, [(0, self_loop_prob),
                              (1, 1.0 - self_loop_prob)]),
              HmmState(K_NO_PDF, K_NO_PDF, [])]
    phones = list(range(1, num_phones + 1))
    phone2idx = [-1] + [0] * num_phones
    return HmmTopology(phones, phone2idx, [states])


def make_chain_transition_model(num_phones: int,
                                self_loop_prob: float = 0.5
                                ) -> TransitionModel:
    """Monophone chain-style model with TWO pdfs per phone:
    forward pdf 2*(phone-1), self-loop pdf 2*(phone-1)+1 —
    a <Tuples> model whose self-loop and forward pdfs differ."""
    topo = make_chain_topology(num_phones, self_loop_prob)
    tuples = []
    for phone in range(1, num_phones + 1):
        base = (phone - 1) * 2
        tuples.append((phone, 0, base, base + 1))
    ntids = sum(
        len(topo.entry_for_phone(p)[s].transitions)
        for p, s, _, _ in tuples)
    log_probs = np.zeros(ntids + 1, np.float32)
    tid = 1
    for phone, s, _, _ in tuples:
        for _dst, prob in topo.entry_for_phone(phone)[s].transitions:
            log_probs[tid] = np.log(max(prob, 1e-20))
            tid += 1
    return TransitionModel(topo, tuples, log_probs)


def make_monophone_transition_model(num_phones: int,
                                    states_per_phone: int = 3,
                                    self_loop_prob: float = 0.5
                                    ) -> TransitionModel:
    """Monophone model with one pdf per (phone, state):
    pdf = (phone-1) * states_per_phone + state. num_pdfs =
    num_phones * states_per_phone."""
    topo = make_linear_topology(num_phones, states_per_phone,
                                self_loop_prob)
    tuples = []
    for phone in range(1, num_phones + 1):
        for j in range(states_per_phone):
            pdf = (phone - 1) * states_per_phone + j
            tuples.append((phone, j, pdf, pdf))
    # log-probs of the initial topology probabilities, index 0 unused
    ntids = sum(
        len(topo.entry_for_phone(p)[s].transitions)
        for p, s, _, _ in tuples)
    log_probs = np.zeros(ntids + 1, np.float32)
    tid = 1
    for phone, s, _, _ in tuples:
        for _dst, prob in topo.entry_for_phone(phone)[s].transitions:
            log_probs[tid] = np.log(max(prob, 1e-20))
            tid += 1
    return TransitionModel(topo, tuples, log_probs)
