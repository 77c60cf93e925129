"""Word-level decoding graph: HCLG built directly (no FST library) —
this package's copy of ``kaldi_lstm_tpu.decode.graph``.

Upstream Kaldi decodes through a compiled HCLG and its latgen decoder;
this module builds the equivalent search graph natively from its three
ingredients:

    H  — phone HMMs from the TransitionModel (arc weights =
         tm.log_probs, arc emissions = tm.id2pdf, i.e. exactly the
         transition-ids upstream puts on H arcs),
    L  — the pronunciation lexicon (word -> phone chains),
    G  — a bigram/unigram ARPA grammar with backoff.

Composition is done by construction rather than generic FST algorithms:
a bigram LM's word destination depends only on the word itself, so one
HMM chain per pronunciation is shared by every grammar state; entry arcs
carry the LM weight + word output label, exit arcs return to the word's
history state. Backoff arcs (epsilon) connect history states to the
unigram state. This is linear in vocabulary size, already deterministic,
and needs no epsilon-removal — the properties HCLG compilation exists to
establish.

Emission convention: each *arc* out of an emitting HMM state consumes one
frame scored by that arc's transition-id pdf (upstream decodable
semantics: self-loop -> self_loop_pdf, forward -> forward_pdf). Graph
weights are natural-log probabilities.
"""

from __future__ import annotations

import math
from dataclasses import dataclass, field

import numpy as np

from kaldi_lstm_tpu_torch.io.arpa import ArpaBigram
from kaldi_lstm_tpu_torch.io.lang import SymbolTable
from kaldi_lstm_tpu_torch.io.transition_model import K_NO_PDF, TransitionModel

NEG = -1e30


@dataclass
class Arc:
    dst: int
    pdf: int       # -1 = epsilon (consumes no frame)
    word: int      # 0 = no output label
    weight: float  # ln prob
    tid: int = 0   # transition-id (lattice ilabel); 0 on epsilon arcs


@dataclass
class DecodingGraph:
    arcs: list                      # arcs[state] -> list[Arc]
    start: int
    final: np.ndarray               # [num_states] ln final weight or NEG
    words: SymbolTable

    @property
    def num_states(self) -> int:
        return len(self.arcs)

    def num_arcs(self) -> int:
        return sum(len(a) for a in self.arcs)


class _Builder:
    def __init__(self, tm: TransitionModel):
        self.tm = tm
        self.arcs: list[list[Arc]] = []
        # (phone, hmm_state) -> tuples index, for tid lookup
        self.tuple_index = {(p, s): i
                            for i, (p, s, _f, _l) in enumerate(tm.tuples)}

    def add_state(self) -> int:
        self.arcs.append([])
        return len(self.arcs) - 1

    def add_arc(self, src: int, dst: int, pdf: int, word: int,
                weight: float, tid: int = 0) -> None:
        self.arcs[src].append(Arc(dst, pdf, word, weight, tid))

    def add_phone(self, phone: int, next_state: int) -> int:
        """Expand one phone HMM; its final (non-emitting) topology state
        is identified with `next_state`. Returns the phone's entry."""
        tm = self.tm
        entry = tm.topo.entry_for_phone(phone)
        n_emit = len(entry) - 1
        if entry[-1].forward_pdf_class != K_NO_PDF or any(
                st.forward_pdf_class == K_NO_PDF for st in entry[:-1]):
            raise ValueError(
                f"phone {phone}: only final-state-non-emitting topologies "
                "are supported by the graph builder")
        states = [self.add_state() for _ in range(n_emit)]
        for j in range(n_emit):
            ts = self.tuple_index[(phone, j)] + 1
            base_tid = tm.state2id[ts]
            for k, (dst, _prob) in enumerate(entry[j].transitions):
                tid = base_tid + k
                target = next_state if dst == n_emit else states[dst]
                self.add_arc(states[j], target, int(tm.id2pdf[tid]), 0,
                             float(tm.log_probs[tid]), tid)
        return states[0]

    def add_pron_chain(self, phones: list[int]) -> tuple[int, int]:
        """HMM chain for one pronunciation. Returns (entry, exit);
        exit is a fresh non-emitting connector state."""
        exit_state = self.add_state()
        nxt = exit_state
        for phone in reversed(phones):
            nxt = self.add_phone(phone, nxt)
        return nxt, exit_state


def build_decoding_graph(tm: TransitionModel,
                         lexicon: dict[str, list[list[int]]],
                         lm: ArpaBigram,
                         words: SymbolTable | None = None,
                         sil_phone: int = 0,
                         sil_prob: float = 0.0,
                         bos: str = "<s>", eos: str = "</s>"
                         ) -> DecodingGraph:
    """Compose H (tm), L (lexicon) and G (lm) into one search graph.

    `sil_phone` > 0 inserts an optional silence HMM at every grammar
    state (self-transition with probability `sil_prob`, word arcs scaled
    by 1 - sil_prob) — upstream L.fst's optional-silence construction.
    Lexicon words missing from the LM are dropped with ValueError (a
    decoding graph must agree with its grammar)."""
    if words is None:
        words = SymbolTable()
        words.add("<eps>", 0)
        for w in sorted(lexicon):
            words.add(w)
    b = _Builder(tm)

    vocab = [w for w in lm.vocab if w not in (bos, eos)]
    missing = [w for w in vocab if w not in lexicon]
    if missing:
        raise ValueError(f"LM words missing from lexicon: {missing[:10]}")

    # shared pronunciation chains, one per (word, pron)
    chains: dict[str, list[tuple[int, int]]] = {}
    for w in vocab:
        chains[w] = [b.add_pron_chain(p) for p in lexicon[w]]

    # grammar states
    backoff_state = b.add_state()
    hist_state = {w: b.add_state() for w in vocab}

    word_scale = math.log(1.0 - sil_prob) if sil_prob > 0 else 0.0

    def connect(g: int, w: str, lm_weight: float) -> None:
        for entry, _exit in chains[w]:
            b.add_arc(g, entry, -1, words[w], lm_weight + word_scale)

    # unigram arcs from the backoff state; chain exits to history states
    for w in vocab:
        connect(backoff_state, w, lm.logp_unigram(w))
        for _entry, exit_state in chains[w]:
            b.add_arc(exit_state, hist_state[w], -1, 0, 0.0)

    # explicit bigram arcs + backoff epsilon from each history state
    for v in vocab:
        for w in vocab:
            p = lm.bigram.get((v, w))
            if p is not None:
                connect(hist_state[v], w, p)
        b.add_arc(hist_state[v], backoff_state, -1, 0, lm.backoff(v))

    # start state: <s> history if the LM has one
    if bos in lm.unigram:
        start = b.add_state()
        for w in vocab:
            p = lm.bigram.get((bos, w))
            if p is not None:
                connect(start, w, p)
        b.add_arc(start, backoff_state, -1, 0, lm.backoff(bos))
    else:
        start = backoff_state

    # optional silence at every grammar state (incl. start)
    if sil_phone > 0 and sil_prob > 0:
        # dict preserves order and dedups start == backoff_state
        for g in dict.fromkeys(
                [backoff_state, start] + list(hist_state.values())):
            entry = b.add_phone(sil_phone, g)
            b.add_arc(g, entry, -1, 0, math.log(sil_prob))

    final = np.full(len(b.arcs), NEG, np.float64)
    final[backoff_state] = lm.logp_unigram(eos) + word_scale
    for v in vocab:
        final[hist_state[v]] = lm.logp(v, eos) + word_scale
    if start != backoff_state:
        final[start] = lm.logp(bos, eos) + word_scale

    return DecodingGraph(arcs=b.arcs, start=start, final=final,
                         words=words)


def build_decoding_graph_ngram(tm: TransitionModel,
                               lexicon: dict[str, list[list[int]]],
                               lm, words: SymbolTable | None = None,
                               sil_phone: int = 0, sil_prob: float = 0.0,
                               bos: str = "<s>", eos: str = "</s>"
                               ) -> DecodingGraph:
    """Any-order HCLG from a general `ArpaLM` (io/arpa.py) — the n-gram
    history-state expansion upstream latgen gets from composed+determinized
    G.fst.

    LM states are n-gram CONTEXTS (histories with explicit
    continuations), closed under suffix so backoff epsilon arcs always
    step exactly one history word (weight = that history's backoff).
    A word arc from history h goes to the longest suffix of h+(w,) that
    is a context (the standard ARPA-as-WFSA construction). Because the
    destination now depends on (h, w) — not on w alone as in the bigram
    builder above — pronunciation HMM chains are shared per
    (word, destination-state) pair rather than globally per word; the
    copy count is bounded by the number of LM contexts, the same growth
    upstream HCLG pays for higher orders."""
    from kaldi_lstm_tpu_torch.io.arpa import ArpaLM
    assert isinstance(lm, ArpaLM), "build_decoding_graph_ngram wants ArpaLM"
    if words is None:
        words = SymbolTable()
        words.add("<eps>", 0)
        for w in sorted(lexicon):
            words.add(w)
    b = _Builder(tm)
    order = max(lm.order, 1)

    vocab = [w for w in lm.vocab if w not in (bos, eos)]
    missing = [w for w in vocab if w not in lexicon]
    if missing:
        raise ValueError(f"LM words missing from lexicon: {missing[:10]}")

    # contexts: histories with explicit continuations PLUS n-grams that
    # carry a backoff weight (their penalty must be paid through a real
    # state's backoff arc — resolving past them would silently drop it);
    # closed under suffix so backoff arcs step one word at a time
    seeds: set[tuple] = set()
    for k in range(2, order + 1):
        for key in lm.ngrams.get(k, {}):
            seeds.add(key[:-1])
    for k in range(1, order):
        for key, (_lp, bo) in lm.ngrams.get(k, {}).items():
            if bo != 0.0:
                seeds.add(key)
    contexts: set[tuple] = set()
    for h in seeds:
        if eos in h:
            continue  # </s> never precedes anything
        while h and h not in contexts:
            contexts.add(h)
            h = h[1:]
    hists = [()] + sorted(contexts)
    state_of = {h: b.add_state() for h in hists}

    def dest_hist(h: tuple, w: str) -> tuple:
        cand = (h + (w,))[-(order - 1):] if order > 1 else ()
        while cand and cand not in contexts:
            cand = cand[1:]
        return cand

    word_scale = math.log(1.0 - sil_prob) if sil_prob > 0 else 0.0

    # pronunciation chains shared per (word, destination LM state)
    chains: dict[tuple, list[tuple[int, int]]] = {}

    def connect(g: int, w: str, dest: int, lm_weight: float) -> None:
        key = (w, dest)
        if key not in chains:
            chains[key] = [b.add_pron_chain(p) for p in lexicon[w]]
            for _entry, exit_state in chains[key]:
                b.add_arc(exit_state, dest, -1, 0, 0.0)
        for entry, _exit in chains[key]:
            b.add_arc(g, entry, -1, words[w], lm_weight + word_scale)

    # continuation index: history -> [(word, ln prob)]
    conts: dict[tuple, list] = {}
    for k in range(1, order + 1):
        for key, (lp, _bo) in lm.ngrams.get(k, {}).items():
            conts.setdefault(key[:-1], []).append((key[-1], lp))

    for h in hists:
        g = state_of[h]
        for w, lp in conts.get(h, ()):
            if w in (bos, eos):
                continue
            connect(g, w, state_of[dest_hist(h, w)], lp)
        # backoff epsilon: one history word per step (suffix closure)
        if h:
            bo = lm.ngrams.get(len(h), {}).get(h, (0.0, 0.0))[1]
            b.add_arc(g, state_of[h[1:]], -1, 0, bo)

    # start: the <s> history (longest-suffix resolution), else unigram
    start = state_of[dest_hist((), bos)]

    if sil_phone > 0 and sil_prob > 0:
        for h in hists:
            g = state_of[h]
            entry = b.add_phone(sil_phone, g)
            b.add_arc(g, entry, -1, 0, math.log(sil_prob))

    final = np.full(len(b.arcs), NEG, np.float64)
    for h in hists:
        final[state_of[h]] = lm.cond_logp(h, eos) + word_scale
    return DecodingGraph(arcs=b.arcs, start=start, final=final,
                         words=words)


def build_graph_from_arpa(tm: TransitionModel,
                          lexicon: dict[str, list[list[int]]],
                          arpa_path: str, words: SymbolTable | None = None,
                          sil_phone: int = 0, sil_prob: float = 0.0,
                          log_fn=None) -> DecodingGraph:
    """Load an ARPA file and build the matching graph: order <= 2 through
    the dedicated bigram builder (globally shared pron chains), higher
    orders through the n-gram history-state expansion — the decoder CLIs'
    single entry point."""
    from kaldi_lstm_tpu_torch.io.arpa import ArpaBigram, ArpaLM
    lm = ArpaLM.load(arpa_path, log_fn=log_fn)
    if lm.order <= 2:
        bg = ArpaBigram()
        bg.unigram = {w: v for (w,), v in lm.ngrams.get(1, {}).items()}
        bg.bigram = {k: lp for k, (lp, _bo)
                     in lm.ngrams.get(2, {}).items()}
        return build_decoding_graph(tm, lexicon, bg, words=words,
                                    sil_phone=sil_phone,
                                    sil_prob=sil_prob)
    return build_decoding_graph_ngram(tm, lexicon, lm, words=words,
                                      sil_phone=sil_phone,
                                      sil_prob=sil_prob)
