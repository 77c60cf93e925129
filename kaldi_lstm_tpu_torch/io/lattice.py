"""Kaldi lattice I/O — Lattice / CompactLattice arks in upstream wire
formats, so lattices interoperate with upstream Kaldi's lattice-* tools
and with the JAX package's; this package's copy of
``kaldi_lstm_tpu.io.lattice``: the writers and readers, the conversions
and the lattice operations behind the lattice-* tools.

Wire formats implemented (both directions, binary and text):

* Binary = OpenFst VectorFst serialization (openfst fst.cc
  FstHeader::Write/Read + vector-fst.h VectorFst::WriteFst):
  magic int32 2125659606, fsttype "vector", arctype "lattice4" /
  "compactlattice44", version 2, flags, properties, start, numstates,
  numarcs; then per state: final weight, int64 narcs, arcs as
  (ilabel i32, olabel i32, weight, nextstate i32). LatticeWeight is two
  f32 costs (graph, acoustic); CompactLatticeWeight appends
  int32 length + int32 transition-ids (lat/lattice-weight.h semantics).
  Table framing: "key \\0B<fst>"; the \\0B marker is consumed by the
  holder exactly as Kaldi's LatticeHolder::Read does (lat/kaldi-lattice.cc).
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

import numpy as np

from kaldi_lstm_tpu_torch.io.kaldi_io import (
    _open_rspecifier,
    _read_key,
    _split_offset,
)

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


def compact_to_lattice(clat: CompactLattice) -> Lattice:
    """Inverse conversion: each transition-id in an arc's string becomes
    one Lattice arc (extra states inserted for strings longer than 1);
    the word label and weight ride the first arc."""
    lat = Lattice(start=clat.start)
    for _ in range(clat.num_states):
        lat.add_state()
    for src, arcs in enumerate(clat.arcs):
        for a in arcs:
            tids = a.tids if a.tids else (0,)
            cur = src
            for k, tid in enumerate(tids):
                first = k == 0
                last = k == len(tids) - 1
                nxt = a.dst if last else lat.add_state()
                lat.arcs[cur].append(LatticeArc(
                    tid, a.label if first else 0,
                    a.graph_cost if first else 0.0,
                    a.acoustic_cost if first else 0.0, nxt))
                cur = nxt
    for s, (g, ac, tids) in clat.final.items():
        if tids:
            cur = s
            for k, tid in enumerate(tids):
                nxt = lat.add_state()
                lat.arcs[cur].append(LatticeArc(
                    tid, 0, g if k == 0 else 0.0,
                    ac if k == 0 else 0.0, nxt))
                cur = nxt
            lat.final[cur] = (0.0, 0.0)
        else:
            lat.final[s] = (g, ac)
    return lat


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


class _Reader:
    def __init__(self, stream):
        self.stream = stream

    def bytes(self, n: int) -> bytes:
        raw = self.stream.read(n)
        if len(raw) != n:
            raise EOFError("truncated lattice")
        return raw

    def i32(self) -> int:
        return struct.unpack("<i", self.bytes(4))[0]

    def i64(self) -> int:
        return struct.unpack("<q", self.bytes(8))[0]

    def f32(self) -> float:
        return struct.unpack("<f", self.bytes(4))[0]

    def string(self) -> str:
        return self.bytes(self.i32()).decode()


def read_lattice_binary(stream):
    """Read one binary lattice (after any \\0B marker); returns a Lattice
    or CompactLattice according to the header's arc type — the same
    auto-detection Kaldi's ReadCompactLattice/ReadLattice perform."""
    r = _Reader(stream)
    magic = r.i32()
    if magic != FST_MAGIC:
        raise ValueError(f"bad FST magic {magic} (expected {FST_MAGIC})")
    fsttype = r.string()
    arctype = r.string()
    if fsttype != "vector":
        raise ValueError(f"unsupported fst type {fsttype!r}")
    version = r.i32()
    if version < 2:
        raise ValueError(f"unsupported vector-fst version {version}")
    r.i32()                               # flags
    struct.unpack("<Q", r.bytes(8))       # properties
    start = r.i64()
    nstates = r.i64()
    r.i64()                               # numarcs
    if arctype == "lattice4":
        lat = Lattice(start=start)
        for s in range(nstates):
            lat.add_state()
            g, ac = r.f32(), r.f32()
            if not (math.isinf(g) and math.isinf(ac)):
                lat.final[s] = (g, ac)
            for _ in range(r.i64()):
                il, ol = r.i32(), r.i32()
                gw, aw = r.f32(), r.f32()
                lat.arcs[s].append(LatticeArc(il, ol, gw, aw, r.i32()))
        return lat
    if arctype == "compactlattice44":
        clat = CompactLattice(start=start)
        for s in range(nstates):
            clat.add_state()
            g, ac = r.f32(), r.f32()
            tids = tuple(r.i32() for _ in range(r.i32()))
            if not (math.isinf(g) and math.isinf(ac)):
                clat.final[s] = (g, ac, tids)
            for _ in range(r.i64()):
                lbl = r.i32()
                r.i32()                   # olabel == ilabel (acceptor)
                gw, aw = r.f32(), r.f32()
                atids = tuple(r.i32() for _ in range(r.i32()))
                clat.arcs[s].append(
                    CompactLatticeArc(lbl, gw, aw, atids, r.i32()))
        return clat
    raise ValueError(f"unsupported arc type {arctype!r}")


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


def _parse_lat_weight(tok: str):
    parts = tok.split(",")
    if len(parts) == 2:                   # Lattice weight "g,a"
        return float(parts[0]), float(parts[1]), None
    if len(parts) == 3:                   # CompactLattice "g,a,t1_t2"
        tids = tuple(int(t) for t in parts[2].split("_") if t)
        return float(parts[0]), float(parts[1]), tids
    raise ValueError(f"bad lattice weight {tok!r}")


def lattice_from_text(lines):
    """Parse text-lattice lines (auto-detects Lattice vs CompactLattice
    from the field count / weight shape); state ids are renumbered so the
    first line's source is the start state, matching OpenFst compile
    semantics (upstream text lattices are already numbered this way)."""
    arcs, finals = [], []
    compact = None
    for ln in lines:
        f = ln.split()
        if not f:
            continue
        if len(f) == 1:
            finals.append((int(f[0]), 0.0, 0.0, ()))
        elif len(f) == 2:
            g, ac, tids = _parse_lat_weight(f[1])
            if tids is not None:
                compact = True            # "g,a,…" = CompactLatticeWeight
            finals.append((int(f[0]), g, ac, tids or ()))
        elif len(f) == 4:
            compact = True
            g, ac, tids = _parse_lat_weight(f[3])
            if tids is None:
                raise ValueError(f"bad compact-lattice arc line {ln!r}")
            arcs.append((int(f[0]), int(f[1]), int(f[2]), 0, g, ac, tids))
        elif len(f) == 5:
            compact = False
            g, ac, tids = _parse_lat_weight(f[4])
            if tids is not None:
                raise ValueError(f"bad lattice arc line {ln!r}")
            arcs.append((int(f[0]), int(f[1]), int(f[2]), int(f[3]),
                         g, ac, None))
        else:
            raise ValueError(f"bad lattice line {ln!r}")
    if compact is None:
        compact = True                    # finals-only: upstream default
    nstates = 0
    for a in arcs:
        nstates = max(nstates, a[0] + 1, a[1] + 1)
    for fl in finals:
        nstates = max(nstates, fl[0] + 1)
    start = arcs[0][0] if arcs else (finals[0][0] if finals else 0)
    if compact:
        clat = CompactLattice(start=start)
        for _ in range(nstates):
            clat.add_state()
        for src, dst, lbl, _, g, ac, tids in arcs:
            clat.arcs[src].append(CompactLatticeArc(lbl, g, ac, tids, dst))
        for s, g, ac, tids in finals:
            clat.final[s] = (g, ac, tids)
        return clat
    lat = Lattice(start=start)
    for _ in range(nstates):
        lat.add_state()
    for src, dst, il, ol, g, ac, _ in arcs:
        lat.arcs[src].append(LatticeArc(il, ol, g, ac, dst))
    for s, g, ac, _t in finals:
        lat.final[s] = (g, ac)
    return lat


# ---------------------------------------------------------------------------
# table (ark) layer
# ---------------------------------------------------------------------------

class LatticeWriter:
    """Writes `ark:` / `ark,t:` lattice tables (CompactLattice by default,
    like upstream latgen). Accepts Lattice or CompactLattice values;
    Lattices are converted arc-by-arc on write."""

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
            lat = compact_to_lattice(lat)
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


class SequentialLatticeReader:
    """Iterates (key, Lattice|CompactLattice) over an `ark:` lattice
    table, binary or text, as written by this module or upstream Kaldi
    (lat/kaldi-lattice.cc LatticeHolder framing)."""

    def __init__(self, rspecifier: str):
        kind, stream = _open_rspecifier(rspecifier)
        if kind != "ark":
            raise ValueError(
                f"SequentialLatticeReader: only ark: supported, got "
                f"{rspecifier!r}")
        self.stream = stream
        self._close = stream is not sys.stdin.buffer

    def __iter__(self):
        try:
            while True:
                key = _read_key(self.stream)
                if key is None:
                    break
                yield key, _read_lattice_value(self.stream, key)
        finally:
            if self._close:
                self.stream.close()


def _read_lattice_value(stream, key: str):
    """Parse ONE lattice record body (binary \\0B or text) at the stream
    position just past the key — the framing shared by the sequential
    and random-access readers."""
    # peek, don't read: a text record's first line may be shorter than
    # 2 bytes ('0\n'), and consuming it here would swallow the record
    # separator (framing bug). BufferedReader.peek can return ONE byte
    # at a buffer boundary — re-peek after a readahead-forcing read
    # (kaldi_io._probe_binary_header rationale)
    head = stream.peek(2)[:2]
    if len(head) == 1 and head == b"\0":
        stream.read(1)
        rest = stream.peek(1)[:1]
        if rest == b"B":
            stream.read(1)
            return read_lattice_binary(stream)
        raise ValueError(f"lattice record for {key}: stray NUL byte")
    if head == b"\0B":
        stream.read(2)
        return read_lattice_binary(stream)
    lines = []
    while True:
        ln = stream.readline()
        line = ln.decode()
        if not line.strip():
            break
        lines.append(line)
        if not ln:
            break
    return lattice_from_text(lines)


class RandomAccessLatticeReader:
    """Lazy random access over a plain-file `ark:` lattice table: one
    framing scan records each record's byte offset (lattices are parsed
    and DISCARDED during indexing), and `value(key)` seeks and re-parses
    on demand — O(1) resident memory where loading the whole denominator
    ark of a sequence-training corpus would be many GB. Pipes/stdin fall
    back to a full in-memory load (they cannot seek)."""

    def __init__(self, rspecifier: str):
        kind, _, rest = rspecifier.partition(":")
        kind = kind.split(",")[0]
        self._table = None
        self._scp: dict = {}
        self._index: dict = {}
        self._path = None
        if kind == "scp":
            # upstream lattice scp: "key path:offset" — fully lazy
            with open(rest, encoding="utf-8") as f:
                for line in f:
                    line = line.strip()
                    if line:
                        k, rxf = line.split(None, 1)
                        self._scp[k] = rxf
            return
        if kind != "ark" or rest in ("-", "") or rest.endswith("|"):
            # pipes/stdin cannot seek: full in-memory load
            self._table = dict(SequentialLatticeReader(rspecifier))
            return
        self._path = rest
        with open(rest, "rb") as stream:  # open() is already buffered
            while True:
                off = stream.tell()
                key = _read_key(stream)
                if key is None:
                    break
                self._index[key] = off
                _read_lattice_value(stream, key)  # framing only

    def __contains__(self, key: str) -> bool:
        if self._table is not None:
            return key in self._table
        return key in self._index or key in self._scp

    def has_key(self, key: str) -> bool:
        return key in self

    def __getitem__(self, key: str):
        return self.value(key)

    def value(self, key: str):
        if self._table is not None:
            return self._table[key]
        if key in self._scp:
            path, offset = _split_offset(self._scp[key])
            with open(path, "rb") as stream:
                if offset is not None:
                    stream.seek(offset)
                return _read_lattice_value(stream, key)
        with open(self._path, "rb") as stream:
            stream.seek(self._index[key])
            k = _read_key(stream)
            return _read_lattice_value(stream, k)


# ---------------------------------------------------------------------------
# lattice operations
# ---------------------------------------------------------------------------

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


def best_path_word_segments(lat) -> tuple[list, float]:
    """Word-level time segmentation of the best path:
    ([(word-id, start-frame, num-frames)], total cost) — the CTM
    quantities. Exact for determinized CompactLattices, where each arc
    carries one word plus that word's own transition-id alignment
    (decode/determinize.py; upstream DeterminizeLattice). For
    state-level lattices the frames from each word label to the next are
    grouped (graphs built by decode/graph.py put the word label on the
    word's first arc); leading label-less frames (silence) are skipped."""
    compact = isinstance(lat, CompactLattice)
    arcs, fin, best_cost = _best_path_arcs(lat)
    segs = []
    t = 0
    if compact:
        for a in arcs:
            n = len(a.tids)
            if a.label:
                segs.append([a.label, t, n])
            # epsilon-arc frames (silence) attach to no word
            t += n
    else:
        for a in arcs:
            n = 1 if a.ilabel else 0
            if a.olabel:
                segs.append([a.olabel, t, 0])
            if segs and n and segs[-1][1] + segs[-1][2] == t:
                segs[-1][2] += n
            t += n
    return [tuple(s) for s in segs], best_cost


def lattice_nbest(lat, n: int, max_pops: int = 1_000_000) -> list:
    """N best (lowest-cost) distinct paths — latbin/lattice-to-nbest
    semantics (path-level, not word-sequence-level). Exact A* on the
    lattice DAG: cost-to-go (beta) from a reverse relaxation is the
    admissible+consistent heuristic, so paths pop off the heap in true
    total-cost order. Returns [(words, tids, cost)], best first."""
    import heapq

    compact = isinstance(lat, CompactLattice)
    ns = lat.num_states
    beta = [INF] * ns
    for s, fin in lat.final.items():
        beta[s] = fin[0] + fin[1]
    # one exact pass in reverse topological order (lattices are DAGs);
    # sweeping in state-id order needs ~path-length sweeps on
    # time-ordered decoder lattices
    for s in reversed(_topo_order_lat(lat)):
        for a in lat.arcs[s]:
            nd = a.graph_cost + a.acoustic_cost + beta[a.dst]
            if nd < beta[s]:
                beta[s] = nd
    if beta[lat.start] == INF:
        raise ValueError("lattice has no reachable final state")

    # heap entry = (est_total, seq, cost_so_far, state, parent_node, arc);
    # state -1 marks a COMPLETED path (finishing is its own heap event so
    # results pop in exact total-cost order even when continuing past a
    # final state is locally cheaper than its final weight)
    results = []
    seq = 0                              # heap tie-breaker
    heap = [(beta[lat.start], 0, 0.0, lat.start, None, None)]
    pops = 0
    while heap and len(results) < n and pops < max_pops:
        _est, _sq, cost, s, parent, arc = heapq.heappop(heap)
        pops += 1
        if s == -1:
            results.append((cost, parent, lat.final[parent[1]]))
            continue
        node = (cost, s, parent, arc)
        if s in lat.final:
            fin = lat.final[s]
            seq += 1
            heapq.heappush(heap, (cost + fin[0] + fin[1], seq,
                                  cost + fin[0] + fin[1], -1, node, None))
        for a in lat.arcs[s]:
            nc = cost + a.graph_cost + a.acoustic_cost
            if nc + beta[a.dst] == INF:
                continue
            seq += 1
            heapq.heappush(heap,
                           (nc + beta[a.dst], seq, nc, a.dst, node, a))

    out = []
    for total, node, fin in results:
        words, tids = [], []
        _cost, _s, parent, arc = node
        while arc is not None:
            if compact:
                if arc.label:
                    words.append(arc.label)
                tids.extend(reversed(arc.tids))
            else:
                if arc.olabel:
                    words.append(arc.olabel)
                if arc.ilabel:
                    tids.append(arc.ilabel)
            _cost, _s, parent, arc = parent
        words.reverse()
        tids.reverse()
        if compact and len(fin) > 2 and fin[2]:
            tids.extend(fin[2])
        out.append((words, tids, total))
    return out


def lattice_scale(lat, lm_scale: float = 1.0,
                  acoustic_scale: float = 1.0):
    """lattice-scale: scale graph/acoustic costs in place (returns lat)."""
    for arcs in lat.arcs:
        for a in arcs:
            a.graph_cost *= lm_scale
            a.acoustic_cost *= acoustic_scale
    compact = isinstance(lat, CompactLattice)
    for s, fin in list(lat.final.items()):
        if compact:
            g, ac, tids = fin
            lat.final[s] = (g * lm_scale, ac * acoustic_scale, tids)
        else:
            g, ac = fin
            lat.final[s] = (g * lm_scale, ac * acoustic_scale)
    return lat


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


def lattice_prune(lat, beam: float):
    """lattice-prune: drop every arc/state not on some complete path
    within `beam` of the best path (upstream PruneLattice semantics:
    cost forward alpha + arc + backward beta vs best). Returns a NEW
    lattice of the same type with states renumbered; start state is
    preserved. Raises on cyclic input."""
    compact = isinstance(lat, CompactLattice)
    order = _topo_order_lat(lat)
    n = lat.num_states
    alpha = [INF] * n
    alpha[lat.start] = 0.0
    for s in order:
        if alpha[s] == INF:
            continue
        for a in lat.arcs[s]:
            c = alpha[s] + a.graph_cost + a.acoustic_cost
            if c < alpha[a.dst]:
                alpha[a.dst] = c
    beta = [INF] * n
    for s, fin in lat.final.items():
        beta[s] = fin[0] + fin[1]
    for s in reversed(order):
        for a in lat.arcs[s]:
            if beta[a.dst] == INF:
                continue
            c = a.graph_cost + a.acoustic_cost + beta[a.dst]
            if c < beta[s]:
                beta[s] = c
    best = alpha[lat.start] + beta[lat.start] if beta[lat.start] != INF \
        else INF
    if best == INF:
        raise ValueError("lattice_prune: no complete path")
    cutoff = best + beam

    keep = {}
    out = CompactLattice() if compact else Lattice()

    def kept(s):
        if s not in keep:
            keep[s] = out.add_state()
        return keep[s]

    # map the start first so ids stay stable
    out.start = kept(lat.start)
    for s in order:
        if alpha[s] == INF or beta[s] == INF \
                or alpha[s] + beta[s] > cutoff + 1e-9:
            continue
        ns = kept(s)
        fin = lat.final.get(s)
        if fin is not None and alpha[s] + fin[0] + fin[1] \
                <= cutoff + 1e-9:
            out.final[ns] = fin
        for a in lat.arcs[s]:
            if beta[a.dst] == INF:
                continue
            tot = alpha[s] + a.graph_cost + a.acoustic_cost \
                + beta[a.dst]
            if tot <= cutoff + 1e-9:
                na = (CompactLatticeArc(a.label, a.graph_cost,
                                        a.acoustic_cost, a.tids,
                                        kept(a.dst)) if compact
                      else LatticeArc(a.ilabel, a.olabel, a.graph_cost,
                                      a.acoustic_cost, kept(a.dst)))
                out.arcs[ns].append(na)
    return out


def lattice_lmrescore(lat, old_lm, new_lm, words, bos: str = "<s>",
                      eos: str = "</s>"):
    """lattice-lmrescore: replace the (bigram) LM scores baked into the
    lattice's graph costs with a different ARPA LM, exactly.

    Per-arc subtraction is impossible in general (backoff arcs split the
    LM score in the raw lattice, determinization redistributes weights),
    but per-PATH the old LM contribution is exactly
    sum_i logp_old(w_i | w_{i-1}) + logp_old(eos | w_last) — the ARPA
    score with backoff folded in. States are therefore expanded by the
    last-word history (bounded by |vocab| copies per state) and each
    word arc's graph cost is adjusted by old_logp - new_logp (costs are
    negated log-probs); finals adjust by the eos terms. `old_lm` None
    skips the subtraction (adds LM scores to an LM-free lattice).
    `words` is the SymbolTable mapping lattice word ids to LM strings.
    """
    compact = isinstance(lat, CompactLattice)
    out = CompactLattice() if compact else Lattice()
    nodes: dict = {}

    def order(lm):
        return getattr(lm, "order", 2)

    hist_len = max(order(new_lm),
                   order(old_lm) if old_lm is not None else 2) - 1

    def cond(lm, hist, w):
        """ln P(w | hist) for either LM class; hist is a tuple of word
        STRINGS starting with bos."""
        if hasattr(lm, "cond_logp"):          # ArpaLM, any order
            return lm.cond_logp(hist, w)
        return lm.logp(hist[-1], w)           # ArpaBigram

    def sym(w):
        return words.id2sym[w]

    def node(s, h):
        key = (s, h)
        if key not in nodes:
            nodes[key] = out.add_state()
        return nodes[key]

    h0 = (bos,)
    out.start = node(lat.start, h0)
    stack = [(lat.start, h0)]
    seen = {(lat.start, h0)}
    while stack:
        s, h = stack.pop()
        ns = node(s, h)
        fin = lat.final.get(s)
        if fin is not None:
            delta = -cond(new_lm, h, eos)
            if old_lm is not None:
                delta += cond(old_lm, h, eos)
            if compact:
                out.final[ns] = (fin[0] + delta, fin[1], fin[2])
            else:
                out.final[ns] = (fin[0] + delta, fin[1])
        for a in lat.arcs[s]:
            w = a.label if compact else a.olabel
            g = a.graph_cost
            nh = h
            if w:
                ws = sym(w)
                delta = -cond(new_lm, h, ws)
                if old_lm is not None:
                    delta += cond(old_lm, h, ws)
                g = g + delta
                nh = (h + (ws,))[-hist_len:] if hist_len else ()
            nd = node(a.dst, nh)
            if compact:
                out.arcs[ns].append(CompactLatticeArc(
                    w, g, a.acoustic_cost, a.tids, nd))
            else:
                out.arcs[ns].append(LatticeArc(
                    a.ilabel, w, g, a.acoustic_cost, nd))
            if (a.dst, nh) not in seen:
                seen.add((a.dst, nh))
                stack.append((a.dst, nh))
    return out


def lattice_to_post(lat, acoustic_scale: float = 1.0,
                    lm_scale: float = 1.0):
    """lattice-to-post: per-frame transition-id posteriors from the
    lattice forward-backward (log semiring over scaled costs:
    ln p(arc) = -(lm_scale*graph + acoustic_scale*acoustic)).

    Input must be a raw state-level Lattice (every emitting arc =
    exactly one frame; convert CompactLattice first). Returns
    [[(tid, gamma), ...] per frame]; gammas sum to 1 per frame.
    Requires time-synchronicity: every path reaching a state must have
    consumed the same number of frames (decoder lattices are)."""
    if isinstance(lat, CompactLattice):
        lat = compact_to_lattice(lat)
    order = _topo_order_lat(lat)
    n = lat.num_states

    def w(a):
        return -(lm_scale * a.graph_cost
                 + acoustic_scale * a.acoustic_cost)

    alpha = [-INF] * n
    frame = [None] * n
    alpha[lat.start] = 0.0
    frame[lat.start] = 0
    for s in order:
        if alpha[s] == -INF:
            continue
        for a in lat.arcs[s]:
            nf = frame[s] + (1 if a.ilabel else 0)
            if frame[a.dst] is None:
                frame[a.dst] = nf
            elif frame[a.dst] != nf:
                raise ValueError(
                    "lattice_to_post: lattice is not time-synchronous "
                    f"(state {a.dst} reached at frames {frame[a.dst]} "
                    f"and {nf})")
            alpha[a.dst] = float(np.logaddexp(alpha[a.dst],
                                              alpha[s] + w(a)))
    beta = [-INF] * n
    for s, fin in lat.final.items():
        beta[s] = -(lm_scale * fin[0] + acoustic_scale * fin[1])
    for s in reversed(order):
        for a in lat.arcs[s]:
            if beta[a.dst] > -INF / 2:
                beta[s] = float(np.logaddexp(beta[s],
                                             w(a) + beta[a.dst]))
    logZ = alpha[lat.start] + beta[lat.start]
    if not math.isfinite(logZ):
        raise ValueError("lattice_to_post: no complete path")

    # frame of an EMITTING ARC leaving s is frame[s]
    T = 0
    for s in order:
        for a in lat.arcs[s]:
            if a.ilabel and frame[s] is not None:
                T = max(T, frame[s] + 1)
    post = [dict() for _ in range(T)]
    for s in order:
        if alpha[s] == -INF or frame[s] is None:
            continue
        for a in lat.arcs[s]:
            if not a.ilabel or beta[a.dst] == -INF:
                continue
            g = math.exp(alpha[s] + w(a) + beta[a.dst] - logZ)
            t = frame[s]
            post[t][a.ilabel] = post[t].get(a.ilabel, 0.0) + g
    return [sorted(d.items()) for d in post]
