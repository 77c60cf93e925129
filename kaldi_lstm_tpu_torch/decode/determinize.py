"""Lattice determinization — upstream DeterminizeLattice semantics
(lat/determinize-lattice-pruned / fstext/determinize-lattice): turn a
raw state-level lattice (transition-ids on input, words on output,
possibly many paths per word sequence) into a deterministic, epsilon-
free CompactLattice keeping, for every word sequence, exactly the
single best-scoring path with its transition-id alignment.

This is the --determinize-lattice=true half of upstream latgen that the
raw-lattice decoder (decode/lattice_faster.py) deferred; this package's
copy of ``kaldi_lstm_tpu.decode.determinize``.

Semantics matched to upstream:

* weight ordering (lattice-weight.h Compare): lower graph+acoustic
  total is better; ties broken by lower graph cost; remaining ties by
  shorter, then lexicographically smaller, transition-id string
  (CompactLatticeWeight Compare) — a total order, so determinization
  is deterministic.
* subset construction over (state, residual weight, residual tid
  string) with common-divisor normalization: each output arc carries
  the subset's common weight divisor (min by the above order) and
  common tid-string prefix; residuals stay in the subset identity
  (fstext/lattice-weight.h Divide semantics).
* word-epsilon arcs are removed via weighted epsilon-closure before
  and during construction (the output is epsilon-free).

The input must be acyclic (beam-decoder lattices always are; cycles
raise). Blow-up is bounded by `max_states`, mirroring upstream's
--max-mem retry-with-smaller-beam convention: callers catch
DeterminizeError and fall back to the raw lattice.
"""

from __future__ import annotations

from dataclasses import dataclass

from kaldi_lstm_tpu_torch.io.lattice import (
    CompactLattice,
    CompactLatticeArc,
    Lattice,
)


class DeterminizeError(RuntimeError):
    pass


def _better(a, b) -> bool:
    """True if weighted-string element a=(g, ac, tids) beats b."""
    ka = (a[0] + a[1], a[0], len(a[2]), a[2])
    kb = (b[0] + b[1], b[0], len(b[2]), b[2])
    return ka < kb


def _topo_order(lat: Lattice) -> list:
    """Topological order of all states (shared helper; raises
    DeterminizeError on cycles)."""
    from kaldi_lstm_tpu_torch.io.lattice import _topo_order_lat
    try:
        return _topo_order_lat(lat)
    except ValueError as e:
        raise DeterminizeError(f"determinize: {e}") from e


def _eps_closure(lat: Lattice, elems: dict, topo_idx) -> dict:
    """Extend {state: (g, ac, tids)} through word-epsilon arcs, keeping
    the best element per state (weighted closure; acyclic input)."""
    import heapq
    out = dict(elems)
    # relax strictly in topological order: an epsilon arc only goes
    # forward in the order (acyclic), so one pass is exact
    heap = [(topo_idx[s], s) for s in out]
    heapq.heapify(heap)
    queued = set(out)
    while heap:
        _, s = heapq.heappop(heap)
        queued.discard(s)
        g0, a0, t0 = out[s]
        for arc in lat.arcs[s]:
            if arc.olabel != 0:
                continue
            cand = (g0 + arc.graph_cost, a0 + arc.acoustic_cost,
                    t0 + ((arc.ilabel,) if arc.ilabel else ()))
            cur = out.get(arc.dst)
            if cur is None or _better(cand, cur):
                out[arc.dst] = cand
                if arc.dst not in queued:
                    heapq.heappush(heap, (topo_idx[arc.dst], arc.dst))
                    queued.add(arc.dst)
    return out


def _normalize(elems: dict):
    """Factor out the common divisor: the best residual weight and the
    longest common tid prefix. Returns (divisor (g, ac, tids),
    canonical frozen subset key, residual dict)."""
    best = None
    for e in elems.values():
        if best is None or _better(e, best):
            best = e
    prefix = None
    for (_, _, t) in elems.values():
        if prefix is None:
            prefix = t
        else:
            k = 0
            m = min(len(prefix), len(t))
            while k < m and prefix[k] == t[k]:
                k += 1
            prefix = prefix[:k]
        if not prefix:
            break
    gd, ad = best[0], best[1]
    res = {s: (g - gd, a - ad, t[len(prefix):])
           for s, (g, a, t) in elems.items()}
    key = tuple(sorted((s, round(g, 9), round(a, 9), t)
                       for s, (g, a, t) in res.items()))
    return (gd, ad, prefix), key, res


def determinize_lattice(lat: Lattice,
                        max_states: int = 200000) -> CompactLattice:
    """Weighted subset determinization; returns an epsilon-free
    deterministic CompactLattice with one path per word sequence."""
    topo_idx = {s: i for i, s in enumerate(_topo_order(lat))}
    out = CompactLattice()
    if lat.num_states == 0 or (not lat.arcs[lat.start]
                               and lat.start not in lat.final):
        out.add_state()
        return out

    start_elems = _eps_closure(lat, {lat.start: (0.0, 0.0, ())},
                               topo_idx)
    div0, key0, res0 = _normalize(start_elems)
    if div0[0] or div0[1] or div0[2]:
        # a common start divisor would need an epsilon super-initial
        # arc; fold it into the subset instead (same paths, weights
        # ride the first real arcs)
        res0 = start_elems
        key0 = tuple(sorted((s, round(g, 9), round(a, 9), t)
                            for s, (g, a, t) in res0.items()))
    subsets = {key0: out.add_state()}
    queue = [(key0, res0)]

    while queue:
        key, elems = queue.pop()
        sid = subsets[key]

        # final weight: best element landing on a final input state
        fbest = None
        for s, (g, a, t) in elems.items():
            fin = lat.final.get(s)
            if fin is not None:
                cand = (g + fin[0], a + fin[1], t)
                if fbest is None or _better(cand, fbest):
                    fbest = cand
        if fbest is not None:
            out.final[sid] = fbest

        # group non-epsilon transitions by word label
        by_word: dict = {}
        for s, (g, a, t) in elems.items():
            for arc in lat.arcs[s]:
                if arc.olabel == 0:
                    continue
                cand = (g + arc.graph_cost, a + arc.acoustic_cost,
                        t + ((arc.ilabel,) if arc.ilabel else ()))
                d = by_word.setdefault(arc.olabel, {})
                cur = d.get(arc.dst)
                if cur is None or _better(cand, cur):
                    d[arc.dst] = cand

        for word in sorted(by_word):
            nxt = _eps_closure(lat, by_word[word], topo_idx)
            (gd, ad, tids), nkey, nres = _normalize(nxt)
            dst = subsets.get(nkey)
            if dst is None:
                if len(subsets) >= max_states:
                    raise DeterminizeError(
                        f"determinize: exceeded max_states="
                        f"{max_states}")
                dst = out.add_state()
                subsets[nkey] = dst
                queue.append((nkey, nres))
            out.arcs[sid].append(
                CompactLatticeArc(word, gd, ad, tids, dst))
    return out
