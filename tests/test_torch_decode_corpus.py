"""The port's word corpus, language resources and decoding graph against
the JAX package's, from the same seed:

* `make_word_synth_data` writes the same bytes (lexicon, words, ARPA,
  final.mdl, feature and alignment arks, text; the scp up to its
  directory) for the dense bigram (`--lm-order 2`) and the counted
  trigram (`--lm-order 3`), with and without optional silence;
* `TransitionModel` read and written again gives the same bytes, binary
  and text;
* the decoding graph built from the same lexicon, ARPA and model is the
  same arc for arc, and its compiled CSR arrays are `array_equal`
  (bigram, trigram, uniform unigram, optional silence);
* `edit_distance` / `wer_report` agree on seeded sequences.
"""

import argparse
import io

import numpy as np
import pytest

FILES = ("final.mdl", "words.txt", "lexicon.txt", "lm.arpa", "feats.ark",
         "ali.ark", "text")


def _corpus_args(order: str, sil: str, words: str = "30") -> list:
    return ["--num-words", words, "--num-phones", "9", "--num-utts", "8",
            "--lm-order", order, "--lm-train-sents", "300",
            "--max-words", "6", "--sil-prob", sil, "--feat-dim", "5"]


@pytest.mark.parametrize("order,sil,words", [
    ("2", "0", "6"), ("2", "0.1", "30"), ("3", "0", "300"),
    ("3", "0.1", "30")])
def test_make_word_synth_data_writes_the_same_bytes(tmp_path, order, sil,
                                                    words):
    from kaldi_lstm_tpu.tools.make_word_synth_data import main as jax_main
    from kaldi_lstm_tpu_torch.tools.make_word_synth_data import main
    a, b = tmp_path / "jax", tmp_path / "port"
    assert jax_main(["--dir", str(a)] + _corpus_args(order, sil, words)) == 0
    assert main(["--dir", str(b)] + _corpus_args(order, sil, words)) == 0
    for name in FILES:
        assert (a / name).read_bytes() == (b / name).read_bytes(), name
    assert (a / "feats.scp").read_text().replace(str(a), "@") == \
        (b / "feats.scp").read_text().replace(str(b), "@")


@pytest.fixture(scope="module")
def corpora(tmp_path_factory):
    from kaldi_lstm_tpu_torch.tools.make_word_synth_data import main
    out = {}
    for order in ("2", "3"):
        d = tmp_path_factory.mktemp(f"lm{order}")
        assert main(["--dir", str(d)] + _corpus_args(order, "0.1")) == 0
        out[order] = str(d)
    return out


@pytest.mark.parametrize("binary", [True, False])
def test_transition_model_rewrites_the_same_bytes(corpora, binary):
    from kaldi_lstm_tpu.io import kaldi_io as jio
    from kaldi_lstm_tpu.io.transition_model import TransitionModel as JaxTM
    from kaldi_lstm_tpu_torch.io import kaldi_io as pio
    from kaldi_lstm_tpu_torch.io.transition_model import TransitionModel
    path = f"{corpora['3']}/final.mdl"
    tm, jtm = TransitionModel.load(path), JaxTM.load(path)
    a, b = io.BytesIO(), io.BytesIO()
    tm.write(pio.KaldiOutput(a, binary=binary))
    jtm.write(jio.KaldiOutput(b, binary=binary))
    assert a.getvalue() == b.getvalue()
    np.testing.assert_array_equal(tm.id2pdf, jtm.id2pdf)
    # what was written reads back as the JAX package reads it
    back = TransitionModel.read(pio.KaldiInput(
        io.BufferedReader(io.BytesIO(a.getvalue()))))
    jback = JaxTM.read(jio.KaldiInput(
        io.BufferedReader(io.BytesIO(a.getvalue()))))
    assert back.tuples == jback.tuples == tm.tuples
    np.testing.assert_array_equal(back.log_probs, jback.log_probs)


def _graph_args(d, arpa, sil_phone, sil_prob):
    return argparse.Namespace(
        model=f"{d}/final.mdl", lexicon=f"{d}/lexicon.txt",
        arpa=arpa if arpa == "none" else f"{d}/{arpa}",
        word_symbol_table=f"{d}/words.txt", sil_phone=sil_phone,
        sil_prob=sil_prob)


@pytest.mark.parametrize("order,arpa,sil_phone,sil_prob", [
    ("2", "lm.arpa", 0, 0.0), ("3", "lm.arpa", 0, 0.0),
    ("3", "lm.arpa", 1, 0.2), ("2", "none", 1, 0.1)])
def test_decoding_graph_and_csr_arrays_equal_jax(corpora, order, arpa,
                                                 sil_phone, sil_prob):
    from kaldi_lstm_tpu.decode.faster import compile_graph as jax_compile
    from kaldi_lstm_tpu.tools.decode_faster import graph_from_args as jax_g
    from kaldi_lstm_tpu_torch.decode.faster import compile_graph
    from kaldi_lstm_tpu_torch.tools.decode_faster import graph_from_args
    args = _graph_args(corpora[order], arpa, sil_phone, sil_prob)
    _, g = graph_from_args(args)
    _, jg = jax_g(args)
    assert (g.num_states, g.num_arcs(), g.start) == \
        (jg.num_states, jg.num_arcs(), jg.start)
    assert g.words.id2sym == jg.words.id2sym
    np.testing.assert_array_equal(g.final, jg.final)
    for arcs, jarcs in zip(g.arcs, jg.arcs):
        assert [(a.dst, a.pdf, a.word, a.weight, a.tid) for a in arcs] == \
            [(a.dst, a.pdf, a.word, a.weight, a.tid) for a in jarcs]
    cg, jcg = compile_graph(g), jax_compile(jg)
    for name in ("em_src", "em_dst", "em_pdf", "em_word", "em_w", "em_tid",
                 "em_ptr", "eps_src", "eps_dst", "eps_word", "eps_w",
                 "eps_ptr", "final"):
        a, b = getattr(cg, name), getattr(jcg, name)
        assert a.dtype == b.dtype, name
        np.testing.assert_array_equal(a, b, err_msg=name)
    assert (cg.num_em, cg.ns, cg.start) == (jcg.num_em, jcg.ns, jcg.start)


@pytest.mark.parametrize("seed", range(4))
def test_edit_distance_and_report_equal_jax(seed):
    from kaldi_lstm_tpu.decode.wer import EditStats as JaxStats
    from kaldi_lstm_tpu.decode.wer import edit_distance as jax_ed
    from kaldi_lstm_tpu.decode.wer import wer_report as jax_report
    from kaldi_lstm_tpu_torch.decode.wer import (
        EditStats,
        edit_distance,
        wer_report,
    )
    rng = np.random.RandomState(seed)
    total, jtotal = EditStats(), JaxStats()
    for _ in range(20):
        ref = list(rng.randint(0, 5, rng.randint(0, 9)))
        hyp = list(rng.randint(0, 5, rng.randint(0, 9)))
        s, js = edit_distance(ref, hyp), jax_ed(ref, hyp)
        assert vars(s) == vars(js)
        total.add(s)
        jtotal.add(js)
    assert wer_report(total) == jax_report(jtotal)
    assert wer_report(total, "PER") == jax_report(jtotal, "PER")


def test_lang_tables_round_trip(corpora, tmp_path):
    from kaldi_lstm_tpu.io.lang import read_lexicon as jax_lex
    from kaldi_lstm_tpu_torch.io.lang import (
        SymbolTable,
        read_lexicon,
        read_text_table,
        write_lexicon,
    )
    d = corpora["3"]
    words = SymbolTable.load(f"{d}/words.txt")
    words.save(str(tmp_path / "w.txt"))
    assert (tmp_path / "w.txt").read_text() == open(f"{d}/words.txt").read()
    lex = read_lexicon(f"{d}/lexicon.txt")
    assert lex == jax_lex(f"{d}/lexicon.txt")
    write_lexicon(str(tmp_path / "l.txt"), lex)
    assert (tmp_path / "l.txt").read_text() == \
        open(f"{d}/lexicon.txt").read()
    text = read_text_table(f"ark,t:{d}/text")
    assert len(text) == 8 and all(v for v in text.values())
