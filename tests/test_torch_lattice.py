"""The port's lattice stack against the JAX package's: the wire formats,
readers and writers, the conversions, the lattice operations, MBR and
the lattice-* tools.

Inputs are made with numpy from a seed: random acyclic lattices (built
once as the JAX package's objects and copied field by field into the
port's), and one decoder-lattice corpus (a seeded word corpus, a
seeded loglik ark, the JAX package's latgen_faster; determinized and
`--raw` arks). Each function and CLI runs in both packages on the same
inputs. Held exact: lattice structure (states, arcs, labels,
transition-ids, finals), word ids, transcripts, and every byte a writer
or a tool produces. Float64 host results (path costs, posteriors,
confidences, expected errors) are held to 1e-9.
"""

import dataclasses
import io
import os
import subprocess
import sys

import numpy as np
import pytest

from kaldi_lstm_tpu.io import lattice as jl
from kaldi_lstm_tpu_torch.io import lattice as pl

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
ATOL = 1e-9


# ---------------------------------------------------------------------------
# helpers
# ---------------------------------------------------------------------------

def _to_port(lat):
    """A JAX-package lattice copied into the port's classes."""
    if isinstance(lat, jl.CompactLattice):
        out = pl.CompactLattice(start=lat.start)
        for arcs in lat.arcs:
            out.arcs.append([pl.CompactLatticeArc(*dataclasses.astuple(a))
                             for a in arcs])
    else:
        out = pl.Lattice(start=lat.start)
        for arcs in lat.arcs:
            out.arcs.append([pl.LatticeArc(*dataclasses.astuple(a))
                             for a in arcs])
    out.final = dict(lat.final)
    return out


def _dump(lat):
    return (type(lat).__name__, lat.start,
            [[dataclasses.astuple(a) for a in arcs] for arcs in lat.arcs],
            sorted(lat.final.items()))


def _same(a, b):
    assert _dump(a) == _dump(b)


def _close(a, b, atol=ATOL):
    """Nested lists/tuples: ints and strings equal, floats within atol."""
    if isinstance(a, float) or isinstance(b, float):
        assert abs(a - b) <= atol or (a == b), (a, b)
    elif isinstance(a, (list, tuple)):
        assert len(a) == len(b), (a, b)
        for x, y in zip(a, b):
            _close(x, y, atol)
    else:
        assert a == b, (a, b)


def _random_lattice(rng, ns=12, nwords=4, finals=True):
    lat = jl.Lattice()
    for _ in range(ns):
        lat.add_state()
    for s in range(ns - 1):
        for _ in range(rng.randint(1, 4)):
            lat.arcs[s].append(jl.LatticeArc(
                int(rng.randint(0, 3)), int(rng.randint(0, nwords + 1)),
                round(float(rng.rand() * 2), 3),
                round(float(rng.rand() * 2), 3),
                int(rng.randint(s + 1, ns))))
        if finals and s > 0 and rng.rand() < 0.3:
            lat.final[s] = (round(float(rng.rand()), 3), 0.0)
    lat.final[ns - 1] = (0.0, 0.0)
    return lat


def _random_lattices(seed, n=8, compact=None):
    rng = np.random.RandomState(seed)
    out = []
    for i in range(n):
        lat = _random_lattice(rng)
        use_compact = (i % 2 == 1) if compact is None else compact
        out.append(jl.lattice_to_compact(lat) if use_compact else lat)
    return out


def _sync_lattice(rng, T=4, width=3):
    """Time-synchronous layered lattice with in-layer epsilons."""
    lat = jl.Lattice()
    layers = [[lat.add_state() for _ in range(width)] for _ in range(T + 1)]
    lat.start = layers[0][0]
    for t in range(T):
        for i, s in enumerate(layers[t]):
            for _ in range(rng.randint(1, 3)):
                lat.arcs[s].append(jl.LatticeArc(
                    int(rng.randint(1, 5)), int(rng.randint(0, 3)),
                    round(float(rng.rand()), 3), round(float(rng.rand()), 3),
                    layers[t + 1][rng.randint(0, width)]))
            if i + 1 < width and rng.rand() < 0.4:
                lat.arcs[s].append(jl.LatticeArc(
                    0, 0, round(float(rng.rand()), 3), 0.0, layers[t][i + 1]))
    for s in layers[T]:
        lat.final[s] = (round(float(rng.rand()), 3), 0.0)
    return lat


def _sample_lattice(mod):
    """0 -(tid 3, word 7)-> 1 -(tid 4)-> 2(final); 0 -(tid 5, word 8)-> 2."""
    lat = mod.Lattice()
    for _ in range(3):
        lat.add_state()
    lat.arcs[0].append(mod.LatticeArc(3, 7, 0.5, 1.25, 1))
    lat.arcs[0].append(mod.LatticeArc(5, 8, 2.0, 3.5, 2))
    lat.arcs[1].append(mod.LatticeArc(4, 0, 0.25, 0.75, 2))
    lat.final[2] = (0.125, 0.0)
    return lat


def _sample_compact(mod):
    clat = mod.CompactLattice()
    for _ in range(3):
        clat.add_state()
    clat.arcs[0].append(mod.CompactLatticeArc(7, 0.5, 1.25, (3, 4), 1))
    clat.arcs[0].append(mod.CompactLatticeArc(8, 2.0, 3.5, (5,), 2))
    clat.arcs[1].append(mod.CompactLatticeArc(0, 0.0, 0.0, (), 2))
    clat.final[2] = (0.125, 0.0, (9,))
    return clat


def _read(path):
    with open(path, "rb") as f:
        return f.read()


# ---------------------------------------------------------------------------
# wire formats, conversions, readers and writers
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("kind", ["lattice", "compact"])
def test_binary_bytes_and_reader_equal_jax(kind):
    make = _sample_lattice if kind == "lattice" else _sample_compact
    to_bytes = "lattice_to_bytes" if kind == "lattice" \
        else "compact_lattice_to_bytes"
    raw = getattr(pl, to_bytes)(make(pl))
    assert raw == getattr(jl, to_bytes)(make(jl))
    assert raw[:4] == pl.FST_MAGIC.to_bytes(4, "little")
    back = pl.read_lattice_binary(io.BytesIO(raw))
    _same(back, _to_port(jl.read_lattice_binary(io.BytesIO(raw))))
    _same(back, make(pl))
    with pytest.raises(EOFError):
        pl.read_lattice_binary(io.BytesIO(raw[:-3]))
    with pytest.raises(ValueError, match="magic"):
        pl.read_lattice_binary(io.BytesIO(b"\0" * 8 + raw[8:]))


@pytest.mark.parametrize("kind", ["lattice", "compact"])
def test_text_format_equal_jax(kind):
    make = _sample_lattice if kind == "lattice" else _sample_compact
    to_text = "lattice_to_text" if kind == "lattice" \
        else "compact_lattice_to_text"
    text = getattr(pl, to_text)(make(pl))
    assert text == getattr(jl, to_text)(make(jl))
    back = pl.lattice_from_text(text.splitlines())
    _same(back, _to_port(jl.lattice_from_text(text.splitlines())))
    _same(back, make(pl))
    with pytest.raises(ValueError, match="bad lattice"):
        pl.lattice_from_text(["0 1 2 3 4 5"])


def test_conversions_equal_jax():
    for jlat in [_sample_lattice(jl), _sample_compact(jl)] \
            + _random_lattices(11, 6):
        plat = _to_port(jlat)
        if isinstance(jlat, jl.Lattice):
            got, ref = pl.lattice_to_compact(plat), \
                jl.lattice_to_compact(jlat)
        else:
            got, ref = pl.compact_to_lattice(plat), \
                jl.compact_to_lattice(jlat)
        _same(got, _to_port(ref))
        # the best path survives the conversion
        w1, t1, c1 = pl.lattice_best_path(plat)
        w2, t2, c2 = pl.lattice_best_path(got)
        assert (w1, t1) == (w2, t2) and abs(c1 - c2) < 1e-6


def test_lattice_scale_equal_jax():
    for jlat in _random_lattices(12, 4):
        plat = _to_port(jlat)
        _same(pl.lattice_scale(plat, 2.0, 0.5),
              _to_port(jl.lattice_scale(jlat, 2.0, 0.5)))


@pytest.mark.parametrize("spec", ["ark", "ark,t"])
@pytest.mark.parametrize("compact", [True, False])
def test_writer_bytes_equal_jax(tmp_path, spec, compact):
    """LatticeWriter on Lattice and CompactLattice values, in compact and
    raw mode, binary and text: the JAX package's bytes."""
    for tag, mod in (("port", pl), ("jax", jl)):
        with mod.LatticeWriter(f"{spec}:{tmp_path}/{tag}.lats",
                               compact=compact) as w:
            w.write("utt1", _sample_lattice(mod))
            w.write("utt2", _sample_compact(mod))
            for k, lat in enumerate(_random_lattices(13, 4)):
                w.write(f"r{k}", _to_port(lat) if mod is pl else lat)
    assert _read(f"{tmp_path}/port.lats") == _read(f"{tmp_path}/jax.lats")


def test_raw_writer_converts_compact_lattice_like_jax(tmp_path):
    """The raw writer (compact=False) given a CompactLattice writes the
    state-level Lattice of compact_to_lattice, byte for byte as the JAX
    package does (it used to raise TypeError)."""
    for tag, mod in (("port", pl), ("jax", jl)):
        with mod.LatticeWriter(f"ark:{tmp_path}/{tag}.raw",
                               compact=False) as w:
            w.write("u", _sample_compact(mod))
    raw = _read(f"{tmp_path}/port.raw")
    assert raw == _read(f"{tmp_path}/jax.raw")
    ((key, back),) = list(pl.SequentialLatticeReader(
        f"ark:{tmp_path}/port.raw"))
    assert key == "u" and isinstance(back, pl.Lattice)
    _same(back, pl.compact_to_lattice(_sample_compact(pl)))


@pytest.mark.parametrize("spec", ["ark", "ark,t"])
def test_readers_equal_jax(tmp_path, spec):
    """Sequential and random-access readers (ark, scp, pipe) on an ark
    the JAX package wrote: the same lattices in the same order."""
    lats = {"utt1": _sample_lattice(jl), "utt2": _sample_compact(jl)}
    for k, lat in enumerate(_random_lattices(14, 4)):
        lats[f"r{k}"] = lat
    trivial = jl.CompactLattice()
    trivial.add_state()
    trivial.final[0] = (0.0, 0.0, ())
    lats = {"a_trivial": trivial, **lats}
    path = f"{tmp_path}/in.lats"
    offsets = {}
    with jl.LatticeWriter(f"{spec}:{path}") as w:
        for k, lat in lats.items():
            w.write(k, lat)
    got = list(pl.SequentialLatticeReader(f"ark:{path}"))
    ref = list(jl.SequentialLatticeReader(f"ark:{path}"))
    assert [k for k, _ in got] == list(lats) == [k for k, _ in ref]
    for (_, a), (_, b) in zip(got, ref):
        _same(a, _to_port(b))
    piped = list(pl.SequentialLatticeReader(f"ark:cat {path} |"))
    assert [_dump(v) for _, v in piped] == [_dump(v) for _, v in got]
    # random access over the ark, over an scp of offsets, and a pipe
    with open(path, "rb") as f:
        while True:
            off = f.tell()
            key = jl._read_key(f)
            if key is None:
                break
            offsets[key] = f.tell()
            jl._read_lattice_value(f, key)
    with open(f"{tmp_path}/in.scp", "w") as f:
        for k, off in offsets.items():
            f.write(f"{k} {path}:{off}\n")
    want = dict(got)
    for rspec in (f"ark:{path}", f"scp:{tmp_path}/in.scp",
                  f"ark:cat {path} |"):
        ra = pl.RandomAccessLatticeReader(rspec)
        jra = jl.RandomAccessLatticeReader(rspec)
        for k in reversed(list(lats)):
            assert k in ra and ra.has_key(k)
            _same(ra[k], want[k])
            _same(ra.value(k), _to_port(jra.value(k)))
        assert "missing" not in ra


def test_reader_rejects_scp_and_a_bad_record(tmp_path):
    (tmp_path / "x.scp").write_text("k x.lats:2\n")
    with pytest.raises(ValueError, match="only ark"):
        pl.SequentialLatticeReader(f"scp:{tmp_path}/x.scp")
    (tmp_path / "bad.lats").write_bytes(b"k \0X")
    for mod in (pl, jl):
        with pytest.raises(ValueError):
            list(mod.SequentialLatticeReader(f"ark:{tmp_path}/bad.lats"))


# ---------------------------------------------------------------------------
# lattice operations
# ---------------------------------------------------------------------------

def test_best_path_and_word_segments_equal_jax():
    cases = [_sample_lattice(jl), _sample_compact(jl)] \
        + _random_lattices(21, 10)
    for jlat in cases:
        plat = _to_port(jlat)
        _close(pl.lattice_best_path(plat), jl.lattice_best_path(jlat))
        _close(pl.best_path_word_segments(plat),
               jl.best_path_word_segments(jlat))
    lat = pl.Lattice()
    lat.add_state()
    with pytest.raises(ValueError, match="no reachable final"):
        pl.lattice_best_path(lat)


def test_word_segments_compact_exact():
    """sil(2f) -> w5(3f) -> w7(2f) plus a worse alternative w9."""
    c = pl.CompactLattice()
    for _ in range(4):
        c.add_state()
    c.arcs[0].append(pl.CompactLatticeArc(0, 0.1, 0.0, (11, 12), 1))
    c.arcs[1].append(pl.CompactLatticeArc(5, 0.5, 1.0, (21, 22, 23), 2))
    c.arcs[1].append(pl.CompactLatticeArc(9, 5.0, 5.0, (31,), 2))
    c.arcs[2].append(pl.CompactLatticeArc(7, 0.2, 0.3, (41, 42), 3))
    c.final[3] = (0.0, 0.0, ())
    segs, cost = pl.best_path_word_segments(c)
    assert segs == [(5, 2, 3), (7, 5, 2)]
    words, tids, cost2 = pl.lattice_best_path(c)
    assert words == [5, 7] and cost == pytest.approx(cost2)
    assert tids == [11, 12, 21, 22, 23, 41, 42]


@pytest.mark.parametrize("n", [1, 3, 20])
def test_nbest_equal_jax(n):
    for jlat in _random_lattices(22, 8) + [_sample_compact(jl)]:
        _close(pl.lattice_nbest(_to_port(jlat), n),
               jl.lattice_nbest(jlat, n))


def test_nbest_order_and_final_state_with_continuation():
    lat = pl.Lattice()
    for _ in range(4):
        lat.add_state()
    lat.arcs[0].append(pl.LatticeArc(1, 5, 0.5, 0.0, 1))
    lat.arcs[1].append(pl.LatticeArc(2, 0, 0.5, 0.0, 3))
    lat.arcs[0].append(pl.LatticeArc(1, 6, 1.0, 0.0, 2))
    lat.arcs[2].append(pl.LatticeArc(2, 0, 0.5, 0.0, 3))
    lat.arcs[0].append(pl.LatticeArc(3, 7, 3.0, 0.0, 3))
    lat.final[3] = (0.0, 0.0)
    paths = pl.lattice_nbest(lat, 5)
    assert [w for w, _t, _c in paths] == [[5], [6], [7]]
    assert np.allclose([c for _w, _t, c in paths], [1.0, 1.5, 3.0])
    lat = pl.Lattice()
    for _ in range(2):
        lat.add_state()
    lat.arcs[0].append(pl.LatticeArc(1, 1, 0.1, 0.0, 1))
    lat.final[0] = (2.0, 0.0)
    lat.final[1] = (0.0, 0.0)
    paths = pl.lattice_nbest(lat, 2)
    assert np.allclose([c for _w, _t, c in paths], [0.1, 2.0])
    assert paths[0][0] == [1] and paths[1][0] == []


@pytest.mark.parametrize("beam", [0.5, 1.5, 4.0])
def test_prune_equal_jax(beam):
    for jlat in _random_lattices(23, 12):
        plat = _to_port(jlat)
        pruned = pl.lattice_prune(plat, beam)
        _same(pruned, _to_port(jl.lattice_prune(jlat, beam)))
        w0, _, c0 = pl.lattice_best_path(plat)
        w1, _, c1 = pl.lattice_best_path(pruned)
        assert w1 == w0 and abs(c1 - c0) < ATOL
    lat = pl.Lattice()
    lat.add_state()
    lat.add_state()
    lat.arcs[0].append(pl.LatticeArc(1, 1, 0.1, 0.1, 1))
    with pytest.raises(ValueError, match="complete path"):
        pl.lattice_prune(lat, 5.0)
    cyc = _to_port(_sample_lattice(jl))
    cyc.arcs[2].append(pl.LatticeArc(1, 0, 0.0, 0.0, 0))
    with pytest.raises(ValueError, match="cycles"):
        pl.lattice_prune(cyc, 1.0)


def _write_trigram_arpa(path, rng, vocab):
    import itertools as it
    uni, bi, tri = {}, {}, {}
    full = list(vocab) + ["</s>"]
    for w in ["<s>"] + full:
        uni[w] = (round(-1 - rng.rand(), 4), round(-0.5 * rng.rand(), 4))
    for v, w in it.product(["<s>"] + list(vocab), full):
        if rng.rand() < 0.6:
            bi[(v, w)] = (round(-1 - rng.rand(), 4),
                          round(-0.5 * rng.rand(), 4))
    for u, v, w in it.product(["<s>"] + list(vocab), list(vocab), full):
        if (u, v) in bi and rng.rand() < 0.4:
            tri[(u, v, w)] = round(-1 - rng.rand(), 4)
    lines = ["\\data\\", f"ngram 1={len(uni)}", f"ngram 2={len(bi)}",
             f"ngram 3={len(tri)}", "", "\\1-grams:"]
    lines += [f"{lp}\t{w}\t{bo}" for w, (lp, bo) in uni.items()]
    lines += ["", "\\2-grams:"]
    lines += [f"{lp}\t{v} {w}\t{bo}" for (v, w), (lp, bo) in bi.items()]
    lines += ["", "\\3-grams:"]
    lines += [f"{lp}\t{u} {v} {w}" for (u, v, w), lp in tri.items()]
    lines += ["", "\\end\\"]
    with open(path, "w") as f:
        f.write("\n".join(lines) + "\n")


@pytest.mark.parametrize("old", ["uniform", "none", "trigram"])
def test_lmrescore_equal_jax(tmp_path, old):
    from kaldi_lstm_tpu.io import arpa as jarpa
    from kaldi_lstm_tpu.io.lang import SymbolTable as JSyms
    from kaldi_lstm_tpu_torch.io import arpa as parpa
    from kaldi_lstm_tpu_torch.io.lang import SymbolTable as PSyms
    vocab = ["a", "b", "c", "d"]
    syms = []
    for cls in (PSyms, JSyms):
        s = cls()
        s.add("<eps>", 0)
        for w in vocab:
            s.add(w)
        syms.append(s)
    _write_trigram_arpa(tmp_path / "tri.arpa", np.random.RandomState(5),
                        vocab)
    new = [m.ArpaLM.load(str(tmp_path / "tri.arpa")) for m in (parpa, jarpa)]
    if old == "uniform":
        olds = [m.uniform_unigram(vocab) for m in (parpa, jarpa)]
    elif old == "trigram":
        olds = new
    else:
        olds = [None, None]
    for jlat in _random_lattices(24, 10):
        got = pl.lattice_lmrescore(_to_port(jlat), olds[0], new[0], syms[0])
        ref = jl.lattice_lmrescore(jlat, olds[1], new[1], syms[1])
        assert _dump(got)[:2] == _dump(_to_port(ref))[:2]
        _close(_dump(got), _dump(_to_port(ref)))
        if old == "trigram":   # same LM out and in: the same best path
            w0, _, c0 = pl.lattice_best_path(_to_port(jlat))
            w1, _, c1 = pl.lattice_best_path(got)
            assert w0 == w1 and abs(c0 - c1) < 1e-6


def test_lattice_to_post_equal_jax():
    rng = np.random.RandomState(0)
    for k in range(10):
        jlat = _sync_lattice(rng)
        if k % 2:
            jlat = jl.lattice_to_compact(jlat)
        got = pl.lattice_to_post(_to_port(jlat), 0.7, 1.0)
        _close(got, jl.lattice_to_post(jlat, 0.7, 1.0))
        for frame in got:
            assert abs(sum(g for _, g in frame) - 1.0) < ATOL


def test_lattice_to_post_rejects_async_and_no_final():
    lat = pl.Lattice()
    for _ in range(3):
        lat.add_state()
    lat.arcs[0].append(pl.LatticeArc(1, 0, 0.1, 0.1, 2))
    lat.arcs[0].append(pl.LatticeArc(0, 0, 0.1, 0.1, 1))
    lat.arcs[1].append(pl.LatticeArc(2, 0, 0.1, 0.1, 2))
    lat.final[2] = (0.0, 0.0)
    assert pl.lattice_to_post(lat)
    mid = lat.add_state()
    lat.arcs[0].append(pl.LatticeArc(4, 0, 0.1, 0.1, mid))
    lat.arcs[mid].append(pl.LatticeArc(5, 0, 0.1, 0.1, 2))
    with pytest.raises(ValueError, match="time-synchronous"):
        pl.lattice_to_post(lat)
    lat = pl.Lattice()
    for _ in range(2):
        lat.add_state()
    lat.arcs[0].append(pl.LatticeArc(7, 0, 0.1, 0.1, 1))
    with pytest.raises(ValueError, match="no complete path"):
        pl.lattice_to_post(lat)


def test_oracle_equal_jax():
    from kaldi_lstm_tpu.tools.lattice_oracle import lattice_oracle as jor
    from kaldi_lstm_tpu_torch.tools.lattice_oracle import lattice_oracle
    rng = np.random.RandomState(3)
    for jlat in _random_lattices(25, 12):
        ref = [int(w) for w in rng.randint(1, 5, rng.randint(0, 6))]
        assert lattice_oracle(_to_port(jlat), ref) == jor(jlat, ref)


def test_oracle_zero_when_ref_in_lattice():
    from kaldi_lstm_tpu_torch.tools.lattice_oracle import lattice_oracle
    for jlat in _random_lattices(26, 6):
        words, _, _ = jl.lattice_best_path(jlat)
        errs, oracle = lattice_oracle(_to_port(jlat), words)
        assert errs == 0 and oracle == words


def _seq_lattice(mod, seqs):
    lat = mod.CompactLattice()
    start = lat.add_state()
    end = lat.add_state()
    lat.final[end] = (0.0, 0.0, ())
    for seq, p in seqs.items():
        cur, cost = start, -np.log(p)
        if not seq:
            lat.arcs[cur].append(mod.CompactLatticeArc(0, cost, 0.0, (), end))
            continue
        for i, w in enumerate(seq):
            nxt = end if i == len(seq) - 1 else lat.add_state()
            lat.arcs[cur].append(mod.CompactLatticeArc(
                w, cost if i == 0 else 0.0, 0.0, (), nxt))
            cur = nxt
    return lat


def test_mbr_edit_functions_equal_jax():
    from kaldi_lstm_tpu.decode import mbr as jm
    from kaldi_lstm_tpu_torch.decode import mbr as pm
    rng = np.random.RandomState(0)
    for _ in range(50):
        a = [int(x) for x in rng.randint(1, 5, rng.randint(0, 7))]
        b = [int(x) for x in rng.randint(1, 5, rng.randint(0, 7))]
        assert pm._edit(a, b) == jm._edit(a, b)
        assert pm._edit_align(a, b) == jm._edit_align(a, b)


def test_mbr_decode_equal_jax():
    from kaldi_lstm_tpu.decode import mbr as jm
    from kaldi_lstm_tpu_torch.decode import mbr as pm
    rng = np.random.RandomState(1)
    cases = [{(1, 2, 3): 0.4, (1, 5, 3): 0.3, (1, 5, 4): 0.3}]
    for _ in range(6):
        seqs = {}
        for _ in range(rng.randint(2, 6)):
            seqs[tuple(int(w) for w in rng.randint(1, 6,
                                                   rng.randint(0, 5)))] = 0
        p = rng.dirichlet(np.ones(len(seqs)))
        cases.append(dict(zip(seqs, p)))
    for seqs in cases:
        for nbest in (2, 50):
            got = pm.mbr_decode(_seq_lattice(pl, seqs), nbest=nbest)
            ref = jm.mbr_decode(_seq_lattice(jl, seqs), nbest=nbest)
            _close(dataclasses.astuple(got), dataclasses.astuple(ref))
    res = pm.mbr_decode(_seq_lattice(pl, cases[0]), nbest=20)
    assert res.words == [1, 5, 3]
    assert res.expected_errors < res.map_expected_errors
    with pytest.raises(ValueError):
        pm.mbr_decode(pl.Lattice(arcs=[[]], final={}), nbest=5)


# ---------------------------------------------------------------------------
# decoder lattices and the lattice-* tools
# ---------------------------------------------------------------------------

@pytest.fixture(scope="module")
def corpus(tmp_path_factory):
    """A seeded trigram word corpus, a loglik ark favouring each frame's
    aligned pdf by 3 nats over seeded Gaussian noise, and the JAX
    package's determinized and raw lattices of it."""
    from kaldi_lstm_tpu.io.kaldi_io import MatrixWriter, SequentialIntVectorReader
    from kaldi_lstm_tpu.io.transition_model import TransitionModel
    from kaldi_lstm_tpu.tools.latgen_faster import main as latgen
    from kaldi_lstm_tpu.tools.make_word_synth_data import main as mksynth
    d = str(tmp_path_factory.mktemp("lattice_port"))
    assert mksynth(["--dir", d, "--num-words", "30", "--num-phones", "8",
                    "--num-utts", "8", "--lm-order", "3",
                    "--lm-train-sents", "300", "--max-words", "5",
                    "--sil-prob", "0.1"]) == 0
    tm = TransitionModel.load(f"{d}/final.mdl")
    rng = np.random.RandomState(0)
    with MatrixWriter(f"ark:{d}/loglik.ark") as w:
        for key, ali in SequentialIntVectorReader(f"ark:{d}/ali.ark"):
            pdf = tm.transition_ids_to_pdfs(ali)
            m = rng.randn(len(pdf), tm.num_pdfs).astype(np.float32) - 5
            m[np.arange(len(pdf)), pdf] += 3
            w.write(key, m)
    graph = [f"{d}/final.mdl", f"{d}/lexicon.txt", f"{d}/lm.arpa",
             f"ark:{d}/loglik.ark"]
    search = ["--acoustic-scale", "0.5", "--beam", "12",
              "--lattice-beam", "5"]
    assert latgen(graph + [f"ark:{d}/det.lat", "--transcript-wspecifier",
                           f"ark,t:{d}/det.txt"] + search) == 0
    assert latgen(graph + [f"ark:{d}/raw.lat", "--raw"] + search) == 0
    return d


def _tool(name):
    import importlib
    return (importlib.import_module(f"kaldi_lstm_tpu_torch.tools.{name}").main,
            importlib.import_module(f"kaldi_lstm_tpu.tools.{name}").main)


def _cli_cases():
    W = ["--word-symbol-table", "{d}/words.txt"]
    return {
        "copy_text": ("lattice_copy", ["ark:{d}/det.lat", "ark,t:{out}"]),
        "copy_raw": ("lattice_copy", ["--raw", "ark:{d}/det.lat",
                                      "ark:{out}"]),
        "copy_raw_in": ("lattice_copy", ["ark:{d}/raw.lat", "ark:{out}"]),
        "prune": ("lattice_prune", ["ark:{d}/det.lat", "ark:{out}",
                                    "--beam", "2"]),
        "prune_raw": ("lattice_prune", ["ark:{d}/raw.lat", "ark,t:{out}",
                                        "--beam", "3"]),
        "determinize": ("lattice_determinize", ["ark:{d}/raw.lat",
                                                "ark:{out}"]),
        "best_path": ("lattice_best_path", ["ark:{d}/det.lat", "ark,t:{out}",
                                            "--alignment-wspecifier",
                                            "ark,t:{out}.ali"] + W),
        "best_path_nbest": ("lattice_best_path",
                            ["ark:{d}/raw.lat", "ark,t:{out}", "--nbest", "3",
                             "--lm-scale", "0.5", "--acoustic-scale", "2"]),
        "to_post": ("lattice_to_post", ["ark:{d}/raw.lat", "ark:{out}",
                                        "--acoustic-scale", "0.1"]),
        "to_post_det": ("lattice_to_post", ["ark:{d}/det.lat", "ark,t:{out}"]),
        "to_ctm": ("lattice_to_ctm", ["ark:{d}/det.lat", "{out}",
                                      "--frame-shift", "0.03"] + W),
        "to_ctm_ids": ("lattice_to_ctm", ["ark:{d}/det.lat", "{out}",
                                          "--precision", "3",
                                          "--acoustic-scale", "0.5"]),
        "oracle": ("lattice_oracle", ["ark:{d}/det.lat", "{d}/text",
                                      "--oracle-wspecifier",
                                      "ark,t:{out}"] + W),
        "lmrescore": ("lattice_lmrescore", ["ark:{d}/det.lat",
                                            "{d}/lm.arpa", "{d}/lm.arpa",
                                            "ark:{out}"] + W),
        "lmrescore_none": ("lattice_lmrescore",
                           ["ark:{d}/det.lat", "none", "{d}/lm.arpa",
                            "ark,t:{out}", "--lexicon", "{d}/lexicon.txt"]
                           + W),
        "lmrescore_add": ("lattice_lmrescore",
                          ["ark:{d}/raw.lat", "none", "{d}/lm.arpa",
                           "ark:{out}", "--no-subtract"] + W),
        "mbr": ("lattice_mbr_decode", ["ark:{d}/det.lat", "ark,t:{out}",
                                       "--confidence-wspecifier",
                                       "ark,t:{out}.conf"] + W),
        "mbr_ids": ("lattice_mbr_decode", ["ark:{d}/det.lat", "ark,t:{out}",
                                           "--nbest", "3"]),
    }


@pytest.mark.parametrize("case", sorted(_cli_cases()))
def test_lattice_tool_output_equals_jax(corpus, capsys, case):
    d = corpus
    name, argv = _cli_cases()[case]
    port_main, jax_main = _tool(name)
    outs, printed = {}, {}
    for tag, main in (("port", port_main), ("jax", jax_main)):
        out = f"{d}/{case}.{tag}"
        args = [a.format(d=d, out=out) for a in argv]
        assert main(args) == 0
        printed[tag] = capsys.readouterr().out
        outs[tag] = [_read(p) for p in (out, out + ".ali", out + ".conf")
                     if os.path.exists(p)]
    assert outs["port"] == outs["jax"] and outs["port"][0]
    assert printed["port"] == printed["jax"]


def test_lattice_copy_text_roundtrip_is_stable(corpus):
    """binary -> text -> binary -> text: the two texts are equal (the
    text form keeps 6 decimals, so the first binary copy is the text's
    rounding of the decoder's weights), and every structure survives."""
    from kaldi_lstm_tpu_torch.tools.lattice_copy import main
    d = corpus
    assert main([f"ark:{d}/det.lat", f"ark,t:{d}/rt1.txt"]) == 0
    assert main([f"ark:{d}/rt1.txt", f"ark:{d}/rt1.lat"]) == 0
    assert main([f"ark:{d}/rt1.lat", f"ark,t:{d}/rt2.txt"]) == 0
    assert _read(f"{d}/rt1.txt") == _read(f"{d}/rt2.txt")
    a = dict(pl.SequentialLatticeReader(f"ark:{d}/det.lat"))
    b = dict(pl.SequentialLatticeReader(f"ark:{d}/rt1.lat"))
    assert sorted(a) == sorted(b)
    for k in a:
        assert pl.lattice_best_path(a[k])[:2] == pl.lattice_best_path(b[k])[:2]


def test_best_path_of_decoder_lattices_is_latgens_transcript(corpus):
    """lattice_best_path over latgen's determinized lattices gives the
    transcripts latgen wrote; the raw lattices give the same words."""
    from kaldi_lstm_tpu_torch.tools.lattice_best_path import main
    d = corpus
    for src in ("det", "raw"):
        assert main([f"ark:{d}/{src}.lat", f"ark,t:{d}/bp_{src}.txt"]) == 0
        assert _read(f"{d}/bp_{src}.txt") == _read(f"{d}/det.txt")


def test_lattice_copy_reports_truncated_ark(corpus, capsys):
    from kaldi_lstm_tpu_torch.tools.lattice_copy import main
    d = corpus
    raw = _read(f"{d}/det.lat")
    with open(f"{d}/trunc.lat", "wb") as f:
        f.write(raw[:len(raw) // 2])
    assert main([f"ark:{d}/trunc.lat", f"ark:{d}/trunc_out.lat"]) == 1
    assert "error reading" in capsys.readouterr().err


def test_lattice_tools_run_as_scripts(corpus):
    """`python -m` on a lattice tool writes what main() writes."""
    d = corpus
    env = dict(os.environ, PYTHONPATH=REPO)
    res = subprocess.run(
        [sys.executable, "-m", "kaldi_lstm_tpu_torch.tools.lattice_best_path",
         f"ark:{d}/det.lat", f"ark,t:{d}/script.txt"],
        env=env, capture_output=True, text=True, timeout=120)
    assert res.returncode == 0, res.stderr
    assert _read(f"{d}/script.txt") == _read(f"{d}/det.txt")
