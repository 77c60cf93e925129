"""Kaldi lattice writing — Lattice / CompactLattice arks in upstream wire
formats, so lattices interoperate with Kaldi's lattice-* tools; this
package's copy of the part of ``kaldi_lstm_tpu.io.lattice`` that latgen,
determinization and best path use (the readers and the lattice-* tool
operations stay with ROADMAP A.3).

Wire formats written (binary and text):

* Binary = OpenFst VectorFst serialization (openfst fst.cc
  FstHeader::Write + vector-fst.h VectorFst::WriteFst):
  magic int32 2125659606, fsttype "vector", arctype "lattice4" /
  "compactlattice44", version 2, flags, properties, start, numstates,
  numarcs; then per state: final weight, int64 narcs, arcs as
  (ilabel i32, olabel i32, weight, nextstate i32). LatticeWeight is two
  f32 costs (graph, acoustic); CompactLatticeWeight appends
  int32 length + int32 transition-ids (lat/lattice-weight.h semantics).
  Table framing: "key \\0B<fst>", as Kaldi's LatticeHolder writes it
  (lat/kaldi-lattice.cc).
* Text = OpenFst AT&T text lines after a "key\\n" line, terminated by a
  blank line: arcs "src dst ilabel olabel g,a" (Lattice) or
  "src dst word g,a,tid1_tid2_..." (CompactLattice); finals
  "state [weight]".

Weights are COSTS (negated natural-log probs), Kaldi convention:
total path cost = graph_cost + acoustic_cost; Zero = +inf (never on
final lines — absence of a final entry means non-final).
"""

from __future__ import annotations

import math
import struct
import sys
from dataclasses import dataclass, field

FST_MAGIC = 2125659606          # openfst fst.cc kFstMagicNumber
_VECTOR_VERSION = 2             # vector-fst.h kFileVersion
# fst-properties: kExpanded | kMutable — VectorFst's static properties;
# upstream readers store these without validating, so the full computed
# property bits Kaldi writes are unnecessary.
_PROPERTIES = 0x3
INF = math.inf


@dataclass
class LatticeArc:
    """Lattice arc: ilabel = transition-id, olabel = word id."""
    ilabel: int
    olabel: int
    graph_cost: float
    acoustic_cost: float
    dst: int


@dataclass
class CompactLatticeArc:
    """CompactLattice arc: label = word id (acceptor), weight carries the
    transition-id string (lat/kaldi-lattice.h CompactLatticeWeight)."""
    label: int
    graph_cost: float
    acoustic_cost: float
    tids: tuple
    dst: int


@dataclass
class Lattice:
    arcs: list = field(default_factory=list)   # arcs[state] -> [LatticeArc]
    # final[state] = (graph_cost, acoustic_cost); missing = not final
    final: dict = field(default_factory=dict)
    start: int = 0

    def add_state(self) -> int:
        self.arcs.append([])
        return len(self.arcs) - 1

    @property
    def num_states(self) -> int:
        return len(self.arcs)

    def num_arcs(self) -> int:
        return sum(len(a) for a in self.arcs)


@dataclass
class CompactLattice:
    arcs: list = field(default_factory=list)
    # final[state] = (graph_cost, acoustic_cost, tids-tuple)
    final: dict = field(default_factory=dict)
    start: int = 0

    def add_state(self) -> int:
        self.arcs.append([])
        return len(self.arcs) - 1

    @property
    def num_states(self) -> int:
        return len(self.arcs)

    def num_arcs(self) -> int:
        return sum(len(a) for a in self.arcs)


# ---------------------------------------------------------------------------
# conversions (lat/lattice-functions / fstext ConvertLattice semantics)
# ---------------------------------------------------------------------------

def lattice_to_compact(lat: Lattice) -> CompactLattice:
    """Arc-by-arc conversion (fstext/lattice-utils-inl.h ConvertLattice):
    each arc's ilabel becomes a length<=1 transition-id string, the word
    becomes the acceptor label. No determinization — state structure is
    preserved (upstream latgen with --determinize-lattice=false)."""
    out = CompactLattice(start=lat.start)
    for arcs in lat.arcs:
        out.arcs.append([
            CompactLatticeArc(a.olabel, a.graph_cost, a.acoustic_cost,
                              (a.ilabel,) if a.ilabel != 0 else (),
                              a.dst)
            for a in arcs])
    out.final = {s: (g, a, ()) for s, (g, a) in lat.final.items()}
    return out


# ---------------------------------------------------------------------------
# binary (OpenFst VectorFst wire format)
# ---------------------------------------------------------------------------

def _w_i32(b: bytearray, v: int) -> None:
    b += struct.pack("<i", v)


def _w_str(b: bytearray, s: str) -> None:
    raw = s.encode()
    _w_i32(b, len(raw))
    b += raw


def _w_f32(b: bytearray, v: float) -> None:
    b += struct.pack("<f", v)


def _fst_header(arctype: str, start: int, nstates: int,
                narcs: int) -> bytearray:
    b = bytearray()
    _w_i32(b, FST_MAGIC)
    _w_str(b, "vector")
    _w_str(b, arctype)
    _w_i32(b, _VECTOR_VERSION)
    _w_i32(b, 0)                          # flags: no symbol tables
    b += struct.pack("<Q", _PROPERTIES)
    b += struct.pack("<q", start)
    b += struct.pack("<q", nstates)
    b += struct.pack("<q", narcs)
    return b


def lattice_to_bytes(lat: Lattice) -> bytes:
    b = _fst_header("lattice4", lat.start, lat.num_states, lat.num_arcs())
    for s, arcs in enumerate(lat.arcs):
        g, ac = lat.final.get(s, (INF, INF))
        _w_f32(b, g)
        _w_f32(b, ac)
        b += struct.pack("<q", len(arcs))
        for a in arcs:
            _w_i32(b, a.ilabel)
            _w_i32(b, a.olabel)
            _w_f32(b, a.graph_cost)
            _w_f32(b, a.acoustic_cost)
            _w_i32(b, a.dst)
    return bytes(b)


def compact_lattice_to_bytes(clat: CompactLattice) -> bytes:
    b = _fst_header("compactlattice44", clat.start, clat.num_states,
                    clat.num_arcs())
    for s, arcs in enumerate(clat.arcs):
        g, ac, tids = clat.final.get(s, (INF, INF, ()))
        _w_f32(b, g)
        _w_f32(b, ac)
        _w_i32(b, len(tids))
        for t in tids:
            _w_i32(b, t)
        b += struct.pack("<q", len(arcs))
        for a in arcs:
            _w_i32(b, a.label)
            _w_i32(b, a.label)            # acceptor: ilabel == olabel
            _w_f32(b, a.graph_cost)
            _w_f32(b, a.acoustic_cost)
            _w_i32(b, len(a.tids))
            for t in a.tids:
                _w_i32(b, t)
            _w_i32(b, a.dst)
    return bytes(b)


# ---------------------------------------------------------------------------
# text (OpenFst AT&T format, Kaldi lattice flavor)
# ---------------------------------------------------------------------------

def _fmt(v: float) -> str:
    return repr(round(v, 6)) if v != int(v) else str(int(v))


def lattice_to_text(lat: Lattice) -> str:
    lines = []
    order = [lat.start] + [s for s in range(lat.num_states)
                           if s != lat.start]
    for s in order:
        for a in lat.arcs[s]:
            lines.append(f"{s} {a.dst} {a.ilabel} {a.olabel} "
                         f"{_fmt(a.graph_cost)},{_fmt(a.acoustic_cost)}")
        if s in lat.final:
            g, ac = lat.final[s]
            w = f" {_fmt(g)},{_fmt(ac)}" if (g, ac) != (0.0, 0.0) else ""
            lines.append(f"{s}{w}")
    return "\n".join(lines) + "\n"


def compact_lattice_to_text(clat: CompactLattice) -> str:
    lines = []
    order = [clat.start] + [s for s in range(clat.num_states)
                            if s != clat.start]
    for s in order:
        for a in clat.arcs[s]:
            tid_s = "_".join(str(t) for t in a.tids)
            lines.append(f"{s} {a.dst} {a.label} "
                         f"{_fmt(a.graph_cost)},{_fmt(a.acoustic_cost)},"
                         f"{tid_s}")
        if s in clat.final:
            g, ac, tids = clat.final[s]
            if (g, ac, tids) == (0.0, 0.0, ()):
                lines.append(f"{s}")
            else:
                tid_s = "_".join(str(t) for t in tids)
                lines.append(f"{s} {_fmt(g)},{_fmt(ac)},{tid_s}")
    return "\n".join(lines) + "\n"


# ---------------------------------------------------------------------------
# table (ark) layer
# ---------------------------------------------------------------------------

class LatticeWriter:
    """Writes `ark:` / `ark,t:` lattice tables (CompactLattice by default,
    like upstream latgen). With `compact` it accepts Lattice or
    CompactLattice values and converts Lattices arc-by-arc on write;
    without it, state-level Lattices only (latgen's --raw)."""

    def __init__(self, wspecifier: str, compact: bool = True):
        binary = True
        spec = wspecifier
        if ":" in spec:
            prefix, path = spec.split(":", 1)
            opts = prefix.split(",")
            if opts[0] != "ark":
                raise ValueError(
                    f"LatticeWriter: unsupported wspecifier {wspecifier!r}")
            binary = "t" not in opts[1:]
        else:
            path = spec
        self.stream = (open(path, "wb") if path != "-"
                       else sys.stdout.buffer)
        self._close = path != "-"
        self.binary = binary
        self.compact = compact

    def write(self, key: str, lat) -> None:
        if self.compact and isinstance(lat, Lattice):
            lat = lattice_to_compact(lat)
        elif not self.compact and isinstance(lat, CompactLattice):
            raise TypeError(f"LatticeWriter: {key}: a CompactLattice cannot "
                            "be written as a state-level Lattice")
        if self.binary:
            self.stream.write(key.encode() + b" \0B")
            self.stream.write(compact_lattice_to_bytes(lat)
                              if isinstance(lat, CompactLattice)
                              else lattice_to_bytes(lat))
        else:
            text = (compact_lattice_to_text(lat)
                    if isinstance(lat, CompactLattice)
                    else lattice_to_text(lat))
            self.stream.write(key.encode() + b"\n" + text.encode() + b"\n")

    def close(self) -> None:
        if self._close:
            self.stream.close()

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        self.close()


# ---------------------------------------------------------------------------
# lattice operations
# ---------------------------------------------------------------------------

def _topo_order_lat(lat) -> list:
    """Topological order over all states (raises on cycles); shared by
    pruning and rescoring, which require acyclic lattices (always true
    for decoder output)."""
    n = lat.num_states
    indeg = [0] * n
    for arcs in lat.arcs:
        for a in arcs:
            indeg[a.dst] += 1
    stack = [s for s in range(n) if indeg[s] == 0]
    order = []
    while stack:
        s = stack.pop()
        order.append(s)
        for a in lat.arcs[s]:
            indeg[a.dst] -= 1
            if indeg[a.dst] == 0:
                stack.append(a.dst)
    if len(order) != n:
        raise ValueError("lattice has cycles")
    return order


def _best_path_arcs(lat) -> tuple[list, tuple, float]:
    """Arc sequence of the lowest-cost path (start -> final), the final
    weight tuple, and the total cost. Lattices are acyclic (the shared
    topological sort enforces it), so ONE relaxation pass in topological
    order is exact — O(V+E) regardless of state numbering."""
    n = lat.num_states
    dist = [INF] * n
    back = [None] * n
    dist[lat.start] = 0.0
    for s in _topo_order_lat(lat):
        if dist[s] == INF:
            continue
        for a in lat.arcs[s]:
            nd = dist[s] + a.graph_cost + a.acoustic_cost
            if nd < dist[a.dst] - 1e-12:
                dist[a.dst] = nd
                back[a.dst] = (s, a)
    best_s, best_cost = None, INF
    for s, fin in lat.final.items():
        g, ac = fin[0], fin[1]
        if dist[s] + g + ac < best_cost:
            best_s, best_cost = s, dist[s] + g + ac
    if best_s is None:
        raise ValueError("lattice has no reachable final state")
    arcs = []
    s = best_s
    while back[s] is not None:
        prev, a = back[s]
        arcs.append(a)
        s = prev
    arcs.reverse()
    return arcs, lat.final[best_s], best_cost


def lattice_best_path(lat) -> tuple[list, list, float]:
    """Shortest (lowest-cost) path through a Lattice or CompactLattice.
    Returns (word-ids, transition-ids, total cost). Arc costs =
    graph + acoustic (lattice-best-path semantics with the scales already
    folded in)."""
    compact = isinstance(lat, CompactLattice)
    arcs, fin, best_cost = _best_path_arcs(lat)
    words, tids = [], []
    for a in arcs:
        if compact:
            if a.label:
                words.append(a.label)
            tids.extend(a.tids)
        else:
            if a.olabel:
                words.append(a.olabel)
            if a.ilabel:
                tids.append(a.ilabel)
    if compact and fin[2]:
        tids.extend(fin[2])
    return words, tids, best_cost
