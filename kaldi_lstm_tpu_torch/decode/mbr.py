"""Minimum-Bayes-risk (consensus) decoding with word confidences; this
package's copy of ``kaldi_lstm_tpu.decode.mbr``.

Picks the hypothesis minimizing the posterior-expected word edit
distance instead of the single best path (upstream lattice-mbr-decode's
goal; lat/sausages.cc implements the Xu & Povey 2011 recursion). Here
the computation is the transparent N-best form: the lattice's top-N
word sequences with exact posteriors (a determinized lattice has one
path per word sequence, and lattice_nbest is exact A*, so the top-N
IS the head of the true sequence distribution), then

    R* = argmin_{c in top-N} sum_k p_k * edit(c, s_k)

which is exact MBR restricted to lattice hypotheses whenever the top-N
covers the posterior mass (the `coverage` it reports). Per-word
confidences come from aligning every candidate to R* and accumulating
the posterior mass that agrees at each output position — a confusion
bin around the consensus hypothesis.
"""

from __future__ import annotations

import math
from dataclasses import dataclass

import numpy as np

from kaldi_lstm_tpu_torch.io.lattice import lattice_nbest


@dataclass
class MbrResult:
    words: list          # the MBR hypothesis (word ids)
    confidences: list    # per word in `words`, posterior in (0, 1]
    expected_errors: float  # expected edits of `words` vs the posterior
    map_expected_errors: float  # same for the MAP (best-path) hypothesis
    coverage: float      # posterior mass covered by the N-best head


def _edit_align(a: list, b: list):
    """(edit distance, alignment) of b against a; alignment[i] is the
    word of b matched to a[i] (None = deletion at that a-position)."""
    m, n = len(a), len(b)
    d = np.zeros((m + 1, n + 1), np.int32)
    d[:, 0] = np.arange(m + 1)
    d[0, :] = np.arange(n + 1)
    for i in range(1, m + 1):
        for j in range(1, n + 1):
            d[i, j] = min(d[i - 1, j] + 1, d[i, j - 1] + 1,
                          d[i - 1, j - 1] + (a[i - 1] != b[j - 1]))
    # traceback for the per-a-position alignment
    align = [None] * m
    i, j = m, n
    while i > 0 or j > 0:
        if i > 0 and j > 0 and \
                d[i, j] == d[i - 1, j - 1] + (a[i - 1] != b[j - 1]):
            align[i - 1] = b[j - 1]
            i, j = i - 1, j - 1
        elif i > 0 and d[i, j] == d[i - 1, j] + 1:
            align[i - 1] = None
            i -= 1
        else:
            j -= 1
    return int(d[m, n]), align


def _edit(a: list, b: list) -> int:
    m, n = len(a), len(b)
    row = np.arange(n + 1)
    for i in range(1, m + 1):
        prev = row.copy()
        row[0] = i
        for j in range(1, n + 1):
            row[j] = min(prev[j] + 1, row[j - 1] + 1,
                         prev[j - 1] + (a[i - 1] != b[j - 1]))
    return int(row[n])


def mbr_decode(lat, nbest: int = 50) -> MbrResult:
    """Consensus decoding over a Lattice/CompactLattice (determinized
    input recommended: then every N-best entry is a distinct word
    sequence). Total path costs are negated log-probs; posteriors are
    normalized over the extracted head and `coverage` reports how much
    of the full distribution that head holds."""
    paths = lattice_nbest(lat, nbest)
    if not paths:
        raise ValueError("mbr_decode: empty lattice")
    # merge by word sequence (raw lattices can repeat sequences)
    seqs: dict = {}
    for words, _tids, cost in paths:
        key = tuple(words)
        seqs[key] = np.logaddexp(seqs.get(key, -math.inf), -cost)
    keys = list(seqs)
    logps = np.asarray([seqs[k] for k in keys])
    # total mass for coverage: log-semiring total over the WHOLE lattice
    total = _log_total(lat)
    post = np.exp(logps - _logsumexp(logps))
    coverage = float(np.exp(_logsumexp(logps) - total))

    def expected(c):
        return float(sum(p * _edit(list(c), list(k))
                         for p, k in zip(post, keys)))

    e_map = expected(keys[0])   # nbest is cost-ordered: MAP first
    best_i = min(range(len(keys)), key=lambda i: expected(keys[i]))
    R = list(keys[best_i])
    e_best = expected(keys[best_i])

    conf = np.zeros(len(R))
    for p, k in zip(post, keys):
        _, align = _edit_align(R, list(k))
        for i, w in enumerate(align):
            if w == R[i]:
                conf[i] += p
    return MbrResult(words=R, confidences=[min(float(c), 1.0)
                                           for c in conf],
                     expected_errors=e_best,
                     map_expected_errors=e_map,
                     coverage=min(coverage, 1.0))


def _logsumexp(x):
    m = np.max(x)
    return float(m + np.log(np.sum(np.exp(x - m))))


def _log_total(lat) -> float:
    """Log of the total path probability mass (log-semiring forward)."""
    from kaldi_lstm_tpu_torch.io.lattice import _topo_order_lat
    n = lat.num_states
    alpha = np.full(n, -np.inf)
    alpha[lat.start] = 0.0
    total = -np.inf
    for s in _topo_order_lat(lat):
        if alpha[s] == -np.inf:
            continue
        fin = lat.final.get(s)
        if fin is not None:
            total = np.logaddexp(total, alpha[s] - fin[0] - fin[1])
        for a in lat.arcs[s]:
            w = -(a.graph_cost + a.acoustic_cost)
            alpha[a.dst] = np.logaddexp(alpha[a.dst], alpha[s] + w)
    if not math.isfinite(total):
        raise ValueError("mbr_decode: no complete path")
    return float(total)
