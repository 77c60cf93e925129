"""The API remnants the port adds for the JAX package's callers and tests,
each held to its JAX counterpart on the CPU:

* io/transition_model.py: make_chain_topology, make_chain_transition_model
  (model bytes equal; the JAX tests/test_decode_viterbi.py:72-114 uses);
* io/arpa.py: ArpaBigram.score_sentence and .load, ArpaLM.score_sentence,
  bigram_as_arpalm, and the LM-rescoring check of JAX
  tests/test_lattice_ops.py:258-304 on the port's lattice functions;
* decode/faster.py: decode_faster_tokens (with Trace and
  _process_nonemitting), the token-passing cross-check of the array
  decoder: both decoders give the same words and score;
* io/kaldi_io.py: RandomAccessPosteriorReader.num_frames and the
  KLT_MMAP_CACHE_LIMIT variable;
* online_serve_batch takes exactly the JAX tool's arguments, so
  both exit 2 on --sil-phone.

Tolerances: scores 1e-9 absolute (float64), exact where stated.
"""

import importlib
import io
import itertools
import math

import numpy as np
import pytest

from kaldi_lstm_tpu.decode.faster import decode_faster_tokens as j_tokens
from kaldi_lstm_tpu.decode.graph import build_decoding_graph as j_build
from kaldi_lstm_tpu.io import arpa as j_arpa
from kaldi_lstm_tpu.io import transition_model as j_tm
from kaldi_lstm_tpu.io.kaldi_io import \
    RandomAccessPosteriorReader as JPostReader
from kaldi_lstm_tpu_torch.decode.faster import (
    Trace,
    decode_faster,
    decode_faster_tokens,
)
from kaldi_lstm_tpu_torch.decode.graph import build_decoding_graph
from kaldi_lstm_tpu_torch.io import arpa
from kaldi_lstm_tpu_torch.io import kaldi_io as kio
from kaldi_lstm_tpu_torch.io import transition_model as tm_mod
from kaldi_lstm_tpu_torch.io.lang import SymbolTable
from kaldi_lstm_tpu_torch.io.lattice import (
    Lattice,
    LatticeArc,
    lattice_lmrescore,
    lattice_to_compact,
)
from kaldi_lstm_tpu_torch.tools import make_word_synth_data as t_mwsd

# ---------------------------------------------------------------------------
# transition models
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("num_phones,loop", [(3, 0.5), (5, 0.3)])
def test_chain_transition_model_matches_jax(tmp_path, num_phones, loop):
    mine = tm_mod.make_chain_transition_model(num_phones, loop)
    ref = j_tm.make_chain_transition_model(num_phones, loop)
    from kaldi_lstm_tpu.io.kaldi_io import KaldiOutput as JOut
    for binary in (True, False):
        a, b = io.BytesIO(), io.BytesIO()
        mine.write(kio.KaldiOutput(a, binary=binary))
        ref.write(JOut(b, binary=binary))
        assert a.getvalue() == b.getvalue() and a.getvalue()
    assert mine.num_pdfs == ref.num_pdfs == 2 * num_phones
    np.testing.assert_array_equal(mine.id2pdf, ref.id2pdf)
    topo = tm_mod.make_chain_topology(num_phones, loop)
    jtopo = j_tm.make_chain_topology(num_phones, loop)
    assert topo.phones == jtopo.phones
    state = topo.entry_for_phone(1)[0]
    assert (state.forward_pdf_class, state.self_loop_pdf_class) == (0, 1)


# ---------------------------------------------------------------------------
# ARPA
# ---------------------------------------------------------------------------

def _write_trigram_arpa(path, rng, vocab):
    """A hand-made trigram ARPA over `vocab` (JAX
    tests/test_lattice_ops.py's)."""
    lines = ["\\data\\", f"ngram 1={len(vocab) + 2}"]
    uni, bi, tri = {}, {}, {}
    full = list(vocab) + ["</s>"]
    for w in ["<s>"] + full:
        uni[w] = (round(-1 - rng.rand(), 4), round(-0.5 * rng.rand(), 4))
    for v, w in itertools.product(["<s>"] + list(vocab), full):
        if rng.rand() < 0.6:
            bi[(v, w)] = (round(-1 - rng.rand(), 4),
                          round(-0.5 * rng.rand(), 4))
    for u, v, w in itertools.product(["<s>"] + list(vocab), list(vocab),
                                     full):
        if (u, v) in bi and rng.rand() < 0.4:
            tri[(u, v, w)] = round(-1 - rng.rand(), 4)
    lines += [f"ngram 2={len(bi)}", f"ngram 3={len(tri)}", "",
              "\\1-grams:"]
    lines += [f"{lp}\t{w}\t{bo}" for w, (lp, bo) in uni.items()]
    lines += ["", "\\2-grams:"]
    lines += [f"{lp}\t{v} {w}\t{bo}" for (v, w), (lp, bo) in bi.items()]
    lines += ["", "\\3-grams:"]
    lines += [f"{lp}\t{u} {v} {w}" for (u, v, w), lp in tri.items()]
    lines += ["", "\\end\\"]
    with open(path, "w") as f:
        f.write("\n".join(lines) + "\n")


def _sentences(rng, vocab, n=20):
    return [list(rng.choice(vocab, rng.randint(0, 6))) for _ in range(n)]


def test_bigram_load_and_score_sentence_match_jax(tmp_path):
    lm = arpa.ArpaBigram()
    lm.unigram = {"<s>": (-99.0, math.log(0.5)),
                  "</s>": (math.log(0.2), 0.0),
                  "a": (math.log(0.5), math.log(0.3)),
                  "b": (math.log(0.3), 0.0)}
    lm.bigram = {("<s>", "a"): math.log(0.9), ("a", "b"): math.log(0.6),
                 ("b", "</s>"): math.log(0.7)}
    path = str(tmp_path / "lm.arpa")
    lm.save(path)
    mine, ref = arpa.ArpaBigram.load(path), j_arpa.ArpaBigram.load(path)
    assert mine.unigram == ref.unigram and mine.bigram == ref.bigram
    rng = np.random.RandomState(0)
    for s in _sentences(rng, ["a", "b", "zz"]):
        assert mine.score_sentence(s) == ref.score_sentence(s)
    assert abs(lm.score_sentence(["a", "b"]) - (
        math.log(0.9) + math.log(0.6) + math.log(0.7))) < 1e-12
    # a trigram file loads with its higher orders dropped, as in JAX
    _write_trigram_arpa(tmp_path / "tri.arpa", np.random.RandomState(5),
                        ["a", "b", "c"])
    logs, jlogs = [], []
    a = arpa.ArpaBigram.load(str(tmp_path / "tri.arpa"), logs.append)
    b = j_arpa.ArpaBigram.load(str(tmp_path / "tri.arpa"), jlogs.append)
    assert a.bigram == b.bigram and logs == jlogs and logs
    (tmp_path / "bad.arpa").write_text("this is not an arpa file\n")
    with pytest.raises(ValueError):
        arpa.ArpaBigram.load(str(tmp_path / "bad.arpa"))


def test_arpalm_score_sentence_and_bigram_view_match_jax(tmp_path):
    vocab = ["a", "b", "c", "d"]
    _write_trigram_arpa(tmp_path / "tri.arpa", np.random.RandomState(5),
                        vocab)
    mine = arpa.ArpaLM.load(str(tmp_path / "tri.arpa"))
    ref = j_arpa.ArpaLM.load(str(tmp_path / "tri.arpa"))
    rng = np.random.RandomState(1)
    for s in _sentences(rng, vocab + ["oov"]):
        assert mine.score_sentence(s) == ref.score_sentence(s)
    bg, jbg = arpa.uniform_unigram(vocab), j_arpa.uniform_unigram(vocab)
    view, jview = arpa.bigram_as_arpalm(bg), j_arpa.bigram_as_arpalm(jbg)
    assert view.ngrams == jview.ngrams and view.order == 2
    for s in _sentences(rng, vocab):
        assert abs(view.score_sentence(s) - bg.score_sentence(s)) < 1e-12
        assert view.score_sentence(s) == jview.score_sentence(s)


def _paths(lat, compact=False):
    """[(words, total_cost)] over all complete paths."""
    out = []

    def dfs(s, words, cost):
        fin = lat.final.get(s)
        if fin is not None:
            out.append((tuple(words), cost + fin[0] + fin[1]))
        for a in lat.arcs[s]:
            w = a.label if compact else a.olabel
            dfs(a.dst, words + ([w] if w else []),
                cost + a.graph_cost + a.acoustic_cost)

    dfs(lat.start, [], 0.0)
    return out


def _random_lattice(rng, ns=12, nwords=4):
    lat = Lattice()
    for _ in range(ns):
        lat.add_state()
    for s in range(ns - 1):
        for _ in range(rng.randint(1, 4)):
            lat.arcs[s].append(LatticeArc(
                int(rng.randint(0, 3)), int(rng.randint(0, nwords + 1)),
                round(float(rng.rand() * 2), 3),
                round(float(rng.rand() * 2), 3),
                int(rng.randint(s + 1, ns))))
        if s > 0 and rng.rand() < 0.3:
            lat.final[s] = (round(float(rng.rand()), 3), 0.0)
    lat.final[ns - 1] = (0.0, 0.0)
    return lat


def test_trigram_lmrescore_exact_with_score_sentence(tmp_path):
    """Rescore random lattices from a uniform unigram to a trigram LM:
    each path's new cost is old + old_LM(path) - new_LM(path), the LM
    scores from score_sentence (JAX tests/test_lattice_ops.py:258-304)."""
    vocab = ["a", "b", "c", "d"]
    words = SymbolTable()
    words.add("<eps>", 0)
    for w in vocab:
        words.add(w)
    _write_trigram_arpa(tmp_path / "tri.arpa", np.random.RandomState(5),
                        vocab)
    lm_b = arpa.ArpaLM.load(str(tmp_path / "tri.arpa"))
    lm_a = arpa.uniform_unigram(vocab)
    rng = np.random.RandomState(3)
    multi = 0
    for compact in (False, True):
        for _ in range(10):
            lat = _random_lattice(rng)
            clat = lattice_to_compact(lat) if compact else lat
            res = lattice_lmrescore(clat, lm_a, lm_b, words)
            old, new = {}, {}
            for p, c in _paths(clat, compact):
                old[p] = min(old.get(p, np.inf), round(c, 9))
            for p, c in _paths(res, compact):
                new[p] = min(new.get(p, np.inf), round(c, 9))
            assert set(new) == set(old)
            multi += len(old) > 1
            for p in old:
                seq = [words.id2sym[w] for w in p]
                want = old[p] + lm_a.score_sentence(seq) \
                    - lm_b.score_sentence(seq)
                np.testing.assert_allclose(new[p], want, atol=1e-8)
    assert multi >= 10, "not enough multi-hypothesis lattices"


# ---------------------------------------------------------------------------
# the token-passing decoder
# ---------------------------------------------------------------------------

def _emit(tm, lex, means, rng, sent, noise, sil_prob):
    pdfs = []

    def add_phone(ph):
        for s in range(3):
            pdf = (ph - 1) * 3 + s
            pdfs.append(pdf)
            while rng.rand() < 0.5:
                pdfs.append(pdf)
    for w in sent:
        if sil_prob > 0 and rng.rand() < sil_prob:
            add_phone(1)
        for ph in lex[w][0]:
            add_phone(ph)
    feats = means[pdfs] + rng.randn(len(pdfs), means.shape[1]) * noise
    d2 = ((feats[:, None, :] - means[None, :, :]) ** 2).sum(-1)
    return -0.5 * d2 / noise ** 2


@pytest.mark.parametrize("sil", [0.0, 0.3])
@pytest.mark.parametrize("max_active", [0, 12])
def test_token_decoder_matches_array_decoder_and_jax(sil, max_active):
    """decode_faster (the native array decoder) and decode_faster_tokens
    (hash token passing) give the same words and score on word graphs
    with and without optional silence; the JAX token decoder agrees."""
    rng = np.random.RandomState(11)
    lex, lm = t_mwsd.make_language(rng, 8, 8, 2, 3, eos_prob=0.25)
    tm = tm_mod.make_monophone_transition_model(8, 3, self_loop_prob=0.5)
    jtm = j_tm.make_monophone_transition_model(8, 3, self_loop_prob=0.5)
    means = np.random.RandomState(1).randn(tm.num_pdfs, 16) * 2.0
    kw = dict(sil_phone=1 if sil else 0, sil_prob=sil)
    graph = build_decoding_graph(tm, lex, lm, **kw)
    jlm = j_arpa.ArpaBigram()
    jlm.unigram, jlm.bigram = dict(lm.unigram), dict(lm.bigram)
    jgraph = j_build(jtm, lex, jlm, **kw)
    for _ in range(5):
        sent = t_mwsd.sample_sentence(rng, lm, sorted(lex), 7) or ["w000"]
        loglik = _emit(tm, lex, means, rng, sent, 0.6, sil)
        a = decode_faster(graph, loglik, 1.0, beam=14.0,
                          max_active=max_active)
        b = decode_faster_tokens(graph, loglik, 1.0, beam=14.0,
                                 max_active=max_active)
        c = j_tokens(jgraph, loglik, 1.0, beam=14.0, max_active=max_active)
        assert a.words == b.words == c.words
        assert abs(a.score - b.score) < 1e-6 and b.score == c.score
        assert b.reached_final == c.reached_final
    assert Trace(None, 3).word == 3


# ---------------------------------------------------------------------------
# kaldi_io
# ---------------------------------------------------------------------------

def test_posterior_num_frames_matches_jax(tmp_path):
    post = {"u1": [[(1, 0.5), (2, 0.5)], [(3, 1.0)]],
            "u22": [[(4, 1.0)]] * 5}
    with kio.PosteriorWriter(f"ark:{tmp_path}/p.ark") as w:
        for k, v in post.items():
            w.write(k, v)
    with kio.PosteriorWriter(f"ark,t:{tmp_path}/t.ark") as w:
        for k, v in post.items():
            w.write(k, v)
    for spec in (f"ark:{tmp_path}/p.ark", f"ark:{tmp_path}/t.ark"):
        mine, ref = kio.RandomAccessPosteriorReader(spec), JPostReader(spec)
        for k, v in post.items():
            assert mine.num_frames(k) == ref.num_frames(k) == len(v)


def test_mmap_cache_limit_reads_the_variable(monkeypatch):
    monkeypatch.setenv("KLT_MMAP_CACHE_LIMIT", "3")
    mod = importlib.reload(kio)
    try:
        assert mod._MMAP_CACHE_LIMIT == 3
    finally:
        monkeypatch.delenv("KLT_MMAP_CACHE_LIMIT")
        importlib.reload(kio)
    assert kio._MMAP_CACHE_LIMIT == 256


# ---------------------------------------------------------------------------
# online_serve_batch's arguments (no silence flags)
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("flag", [["--sil-phone", "1"],
                                  ["--sil-prob", "0.5"]])
def test_online_serve_batch_refuses_the_silence_flags_like_jax(flag,
                                                               capsys):
    from kaldi_lstm_tpu.tools.online_serve_batch import main as j_main
    from kaldi_lstm_tpu_torch.tools.online_serve_batch import main
    argv = ["nnet", "mdl", "lex", "none", "ark:f", "ark,t:o"] + flag
    codes = []
    for fn in (main, j_main):
        with pytest.raises(SystemExit) as e:
            fn(argv)
        codes.append(e.value.code)
        assert "unrecognized arguments" in capsys.readouterr().err
    assert codes == [2, 2]


def test_online_serve_batch_takes_the_jax_tools_arguments():
    """The same positionals and flags as the JAX tool, --device aside."""
    from kaldi_lstm_tpu_torch.tools.online_serve_batch import build_parser

    def options(parser):
        return {a.dest: (a.option_strings, a.default)
                for a in parser._actions if a.dest != "help"}

    class Capture(Exception):
        pass

    import argparse
    parsers = []
    orig = argparse.ArgumentParser.parse_args

    def grab(self, *a, **k):
        parsers.append(self)
        raise Capture
    argparse.ArgumentParser.parse_args = grab
    try:
        from kaldi_lstm_tpu.tools import online_serve_batch as j_osb
        with pytest.raises(Capture):
            j_osb.main(["x"])
    finally:
        argparse.ArgumentParser.parse_args = orig
    mine = options(build_parser())
    ref = options(parsers[0])
    del mine["device"]
    assert mine == ref
