"""Forced alignment — upstream align-mapped: Viterbi over the linear
graph of a KNOWN transcript, producing the per-frame transition-id
alignment (the ali.ark that `ali-to-pdf | ali-to-post` turns into
training targets); this package's copy of
``kaldi_lstm_tpu.decode.align``.

The alignment graph is the transcript's pronunciation chains laid end
to end (multiple pronunciations in parallel), with upstream
L.fst-style optional silence before each word and at the end; the
search and traceback reuse decode_faster's compiled-CSR numpy Viterbi
step (`_frame_step`, host numpy one frame at a time, as in the JAX
package), so beam semantics match decoding exactly.
"""

from __future__ import annotations

import math

import numpy as np

from kaldi_lstm_tpu_torch.decode.faster import (
    NEG as _NEG,
    _eps_closure,
    _frame_step,
    _traceback_full,
    compile_graph,
)
from kaldi_lstm_tpu_torch.decode.graph import NEG, DecodingGraph, _Builder
from kaldi_lstm_tpu_torch.io.lang import SymbolTable
from kaldi_lstm_tpu_torch.io.transition_model import TransitionModel


def build_alignment_graph(tm: TransitionModel,
                          lexicon: dict,
                          transcript: list,
                          words: SymbolTable | None = None,
                          sil_phone: int = 0,
                          sil_prob: float = 0.0) -> DecodingGraph:
    """Linear decoding graph accepting exactly `transcript` (word
    strings), with per-word parallel pronunciations and optional
    silence (sil_prob) before each word and at the end."""
    if words is None:
        words = SymbolTable()
        words.add("<eps>", 0)
        for w in sorted(lexicon):
            words.add(w)
    b = _Builder(tm)
    word_scale = math.log(1.0 - sil_prob) if sil_prob > 0 else 0.0
    sil_cost = math.log(sil_prob) if sil_prob > 0 else 0.0

    def add_optional_silence(g: int) -> None:
        if sil_phone > 0 and sil_prob > 0:
            entry = b.add_phone(sil_phone, g)
            b.add_arc(g, entry, -1, 0, sil_cost)

    cur = b.add_state()
    start = cur
    for w in transcript:
        prons = lexicon.get(w)
        if not prons:
            raise ValueError(f"align: word {w!r} not in lexicon")
        add_optional_silence(cur)
        nxt = b.add_state()
        for p in prons:
            entry, exit_state = b.add_pron_chain(p)
            b.add_arc(cur, entry, -1, words[w], word_scale)
            b.add_arc(exit_state, nxt, -1, 0, 0.0)
        cur = nxt
    add_optional_silence(cur)

    final = np.full(len(b.arcs), NEG, np.float64)
    final[cur] = 0.0
    return DecodingGraph(arcs=b.arcs, start=start, final=final,
                         words=words)


class AlignmentError(RuntimeError):
    pass


def align_mapped(graph: DecodingGraph, loglik: np.ndarray,
                 acoustic_scale: float = 1.0, beam: float = 200.0,
                 max_active: int = 0) -> tuple:
    """Viterbi-align `loglik` [T, num_pdfs] against an alignment graph.
    Returns (tids [T], word ids, score). Raises AlignmentError when no
    path survives (transcript cannot cover T frames, or beam too
    tight — upstream 'Did not successfully decode' warning)."""
    cg = compile_graph(graph)
    em = acoustic_scale * np.asarray(loglik, np.float64)
    T = em.shape[0]
    alpha = np.full(cg.ns, _NEG)
    alpha[cg.start] = 0.0
    bps = np.full((T + 1, cg.ns), -1, np.int32)
    _eps_closure(cg, alpha, bps[0], np.asarray([cg.start]))
    active = np.nonzero(alpha > _NEG / 2)[0]
    try:
        for t in range(T):
            alpha, active = _frame_step(cg, alpha, active, em[t], beam,
                                        max_active, bps[t + 1], t)
    except RuntimeError as e:
        raise AlignmentError(str(e)) from e
    total = alpha + cg.final
    state = int(np.argmax(total))
    if total[state] <= _NEG / 2:
        raise AlignmentError(
            "align: no path reached the transcript's final state "
            f"after {T} frames (transcript/audio mismatch?)")
    words, tids = _traceback_full(cg, bps, state, T)
    return tids, words, float(total[state])
