"""The port's forced alignment against the JAX package's: the alignment
graph, `align_mapped` (library and CLI), `ali_to_pdf`, `ali_to_phones`
and the fused score-and-align `nnet_align`.

Inputs are made with numpy from a seed: a tiny language and oracle
Gaussian emissions (made as the JAX package's tests/test_word_decode.py
makes them), a seeded word corpus with features, and a small LSTMP AM
initialised by the JAX package from a seed and written once, read by
both packages. Held:

* graphs, transition-id alignments, word ids and every ark or text
  byte exactly; float64 alignment scores within 1e-9;
* `nnet_align --device cpu` against the JAX `nnet_align`: the
  alignment ark byte for byte. The scores the two packages align on
  agree within 1e-5 (their float32 forwards differ only in summation
  order; checked on the `nnet_forward` arks), far below the gaps
  between competing alignments;
* the port's fused path against its own two-stage flow (`nnet_forward`
  -> loglik ark -> `align_mapped`) byte for byte, on the CPU here and
  on the card in the `gpu` cases;
* `nnet_align` asking for CUDA on a host without it exits 1 and writes
  nothing.
"""

import os

import numpy as np
import pytest
import torch

from kaldi_lstm_tpu.decode import align as ja
from kaldi_lstm_tpu.io import transition_model as jtm
from kaldi_lstm_tpu_torch.decode import align as pa
from kaldi_lstm_tpu_torch.io import transition_model as ptm

ATOL = 1e-9


def _oracle_setup(num_words=6, num_phones=8, seed=3):
    """Tiny language + corpus with well-separated Gaussian emissions (as
    the JAX package's tests/test_word_decode.py makes them)."""
    from kaldi_lstm_tpu.tools.make_word_synth_data import make_language
    rng = np.random.RandomState(seed)
    lex, lm = make_language(rng, num_words, num_phones, 2, 3, eos_prob=0.25)
    tm = jtm.make_monophone_transition_model(num_phones, 3,
                                             self_loop_prob=0.5)
    means = np.random.RandomState(1).randn(tm.num_pdfs, 16) * 2.0
    return lex, lm, tm, means, rng


def _emit(tm, lex, means, rng, sent, noise=0.2, sil_prob=0.0):
    """Oracle per-pdf log-likelihoods of one sentence's frames."""
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


def _read(path):
    with open(path, "rb") as f:
        return f.read()


def _graph_dump(g):
    return ([[(a.dst, a.pdf, a.tid, a.word, a.weight) for a in arcs]
             for arcs in g.arcs], g.start, g.final.tolist(),
            sorted(g.words.sym2id.items()))


def _port_tm(tm):
    return ptm.make_monophone_transition_model(
        len({p for p, *_ in tm.tuples}), 3, self_loop_prob=0.5)


def _align_both(lex, tm, sent, ll, **graph_kw):
    ptm_ = _port_tm(tm)
    pg = pa.build_alignment_graph(ptm_, lex, sent, **graph_kw)
    jg = ja.build_alignment_graph(tm, lex, sent, **graph_kw)
    assert _graph_dump(pg) == _graph_dump(jg)
    got = pa.align_mapped(pg, ll)
    ref = ja.align_mapped(jg, ll)
    assert got[0] == ref[0] and got[1] == ref[1]
    assert abs(got[2] - ref[2]) <= ATOL
    return ptm_, pg, got


@pytest.mark.parametrize("seed", [5, 6])
def test_align_oracle_exact_equals_jax(seed):
    from kaldi_lstm_tpu.tools.make_word_synth_data import sample_sentence
    lex, lm, tm, means, rng = _oracle_setup(seed=seed)
    for _ in range(6):
        sent = sample_sentence(rng, lm, sorted(lex), 6) or ["w000"]
        ll = _emit(tm, lex, means, rng, sent, noise=0.2)
        ptm_, g, (tids, words, _) = _align_both(lex, tm, sent, ll)
        assert len(tids) == ll.shape[0]
        np.testing.assert_array_equal(ptm_.transition_ids_to_pdfs(tids),
                                      ll.argmax(axis=1))
        assert [g.words.id2sym[i] for i in words] == sent


def test_align_with_optional_silence_equals_jax():
    from kaldi_lstm_tpu.tools.make_word_synth_data import sample_sentence
    lex, lm, tm, means, rng = _oracle_setup(seed=7)
    for _ in range(5):
        sent = sample_sentence(rng, lm, sorted(lex), 5) or ["w000"]
        ll = _emit(tm, lex, means, rng, sent, noise=0.2, sil_prob=0.6)
        ptm_, g, (tids, words, _) = _align_both(
            lex, tm, sent, ll, sil_phone=1, sil_prob=0.5)
        np.testing.assert_array_equal(ptm_.transition_ids_to_pdfs(tids),
                                      ll.argmax(axis=1))
        assert [g.words.id2sym[i] for i in words] == sent


def test_align_noisy_scores_equal_jax():
    """Noisy emissions (alignments not forced by the oracle) and a
    narrow beam: still the JAX package's alignment and score."""
    from kaldi_lstm_tpu.tools.make_word_synth_data import sample_sentence
    lex, lm, tm, means, rng = _oracle_setup(seed=11)
    for _ in range(5):
        sent = sample_sentence(rng, lm, sorted(lex), 6) or ["w000"]
        ll = _emit(tm, lex, means, rng, sent, noise=1.5) \
            + rng.randn(1, tm.num_pdfs)
        ptm_ = _port_tm(tm)
        pg = pa.build_alignment_graph(ptm_, lex, sent)
        jg = ja.build_alignment_graph(tm, lex, sent)
        got = pa.align_mapped(pg, ll, 0.7, 30.0, 50)
        ref = ja.align_mapped(jg, ll, 0.7, 30.0, 50)
        assert got[:2] == ref[:2] and abs(got[2] - ref[2]) <= ATOL


def test_align_picks_better_pronunciation():
    tm = ptm.make_monophone_transition_model(4, 2, self_loop_prob=0.5)
    lex = {"a": [[1, 2], [3, 4]]}
    rng = np.random.RandomState(0)
    means = rng.randn(tm.num_pdfs, 8) * 3.0
    true_pdfs = [4, 4, 5, 6, 7, 7]
    d2 = ((means[true_pdfs][:, None] - means[None]) ** 2).sum(-1)
    ll = -0.5 * d2
    tids, _, score = pa.align_mapped(pa.build_alignment_graph(tm, lex, ["a"]),
                                     ll)
    np.testing.assert_array_equal(tm.transition_ids_to_pdfs(tids), true_pdfs)
    jtm_ = jtm.make_monophone_transition_model(4, 2, self_loop_prob=0.5)
    ref = ja.align_mapped(ja.build_alignment_graph(jtm_, lex, ["a"]), ll)
    assert tids == ref[0] and abs(score - ref[2]) <= ATOL


def test_symbol_table_ids_equal_jax():
    """The port's SymbolTable (O(1) `add`, the alignment graph builds one
    of the whole vocabulary an utterance) numbers symbols as the JAX
    package's does, explicit ids and duplicates included."""
    from kaldi_lstm_tpu.io.lang import SymbolTable as JSyms
    from kaldi_lstm_tpu_torch.io.lang import SymbolTable as PSyms
    rng = np.random.RandomState(8)
    for _ in range(100):
        tables = (PSyms(), JSyms())
        for _ in range(30):
            sym = f"s{rng.randint(0, 40)}"
            idx = None if rng.rand() < 0.6 else int(rng.randint(0, 60))
            got = []
            for t in tables:
                try:
                    got.append(t.add(sym, idx))
                except ValueError as e:
                    got.append(str(e))
            assert got[0] == got[1]
        assert (tables[0].sym2id, tables[0].id2sym) == \
            (tables[1].sym2id, tables[1].id2sym)
    seeded = PSyms(sym2id={"a": 3}, id2sym={3: "a"})
    assert seeded.add("b") == 4


def test_align_impossible_transcript_raises():
    lex, lm, tm, means, rng = _oracle_setup(seed=9)
    sent = [sorted(lex)[0]] * 6
    ll = _emit(tm, lex, means, rng, [sorted(lex)[0]], noise=0.2)
    assert ll.shape[0] < sum(len(lex[w][0]) * 3 for w in sent)
    g = pa.build_alignment_graph(_port_tm(tm), lex, sent)
    with pytest.raises(pa.AlignmentError):
        pa.align_mapped(g, ll)
    with pytest.raises(ValueError, match="lexicon"):
        pa.build_alignment_graph(_port_tm(tm), lex, ["not-a-word"])


# ---------------------------------------------------------------------------
# the CLIs on an oracle corpus
# ---------------------------------------------------------------------------

@pytest.fixture(scope="module")
def oracle_corpus(tmp_path_factory):
    """final.mdl, lexicon, words.txt, text (one key without scores, one
    transcript that cannot cover its frames) and a loglik ark."""
    from kaldi_lstm_tpu.io.kaldi_io import MatrixWriter
    from kaldi_lstm_tpu.io.lang import write_lexicon
    from kaldi_lstm_tpu.tools.make_word_synth_data import sample_sentence
    d = tmp_path_factory.mktemp("align_port")
    lex, lm, tm, means, rng = _oracle_setup(seed=13)
    tm.dump(str(d / "final.mdl"))
    write_lexicon(str(d / "lexicon.txt"), lex)
    vocab = sorted(lex)
    (d / "words.txt").write_text("<eps> 0\n" + "".join(
        f"{w} {i + 1}\n" for i, w in enumerate(vocab)))
    texts = {}
    with MatrixWriter(f"ark:{d}/loglik.ark") as w:
        for u in range(6):
            sent = sample_sentence(rng, lm, vocab, 5) or ["w000"]
            ll = _emit(tm, lex, means, rng, sent, noise=0.2, sil_prob=0.3)
            w.write(f"utt{u}", ll.astype(np.float32))
            texts[f"utt{u}"] = sent
    texts["utt5"] = texts["utt5"] * 8          # too long for its frames
    del texts["utt3"]                           # no transcript
    texts["utt9"] = [vocab[0]]                  # no scores
    with open(d / "text", "w") as f:
        for k, sent in texts.items():
            f.write(k + " " + " ".join(sent) + "\n")
    with open(d / "text_ids", "w") as f:
        for k, sent in texts.items():
            f.write(k + " " + " ".join(str(vocab.index(w) + 1)
                                       for w in sent) + "\n")
    return str(d)


def _align_argv(d, out, extra):
    return [f"{d}/final.mdl", f"{d}/lexicon.txt", f"ark:{d}/loglik.ark",
            f"{d}/text", out] + extra


@pytest.mark.parametrize("name,extra", [
    ("plain", []),
    ("sil", ["--sil-phone", "1", "--sil-prob", "0.5", "--acoustic-scale",
             "0.5"]),
    ("beam", ["--beam", "15", "--max-active", "40"]),
    ("text_out", []),
    ("ids", ["--word-symbol-table", "{d}/words.txt",
             "--transcripts-are-ids"]),
])
def test_align_mapped_cli_equals_jax(oracle_corpus, name, extra):
    from kaldi_lstm_tpu.tools.align_mapped import main as jax_main
    from kaldi_lstm_tpu_torch.tools.align_mapped import main as port_main
    d = oracle_corpus
    extra = [e.format(d=d) for e in extra]
    spec = "ark,t" if name == "text_out" else "ark"
    for tag, main in (("port", port_main), ("jax", jax_main)):
        argv = _align_argv(d, f"{spec}:{d}/ali_{name}.{tag}", extra)
        if name == "ids":
            argv[3] = f"{d}/text_ids"
        assert main(argv) == 0
    got = _read(f"{d}/ali_{name}.port")
    assert got == _read(f"{d}/ali_{name}.jax")
    if name == "plain":   # utt3 has no text, utt5 cannot be aligned
        from kaldi_lstm_tpu_torch.io.kaldi_io import SequentialIntVectorReader
        keys = [k for k, _ in SequentialIntVectorReader(
            f"ark:{d}/ali_plain.port")]
        assert keys == ["utt0", "utt1", "utt2", "utt4"]


@pytest.fixture(scope="module")
def oracle_ali(oracle_corpus):
    from kaldi_lstm_tpu_torch.tools.align_mapped import main
    d = oracle_corpus
    assert main(_align_argv(d, f"ark:{d}/ali.ark",
                            ["--sil-phone", "1", "--sil-prob", "0.5"])) == 0
    return d


def test_ali_to_pdf_equals_jax_and_truth(oracle_ali):
    from kaldi_lstm_tpu.io.kaldi_io import SequentialMatrixReader
    from kaldi_lstm_tpu.tools.ali_to_pdf import main as jax_main
    from kaldi_lstm_tpu_torch.io.kaldi_io import SequentialIntVectorReader
    from kaldi_lstm_tpu_torch.tools.ali_to_pdf import main as port_main
    d = oracle_ali
    for tag, main in (("port", port_main), ("jax", jax_main)):
        assert main([f"{d}/final.mdl", f"ark:{d}/ali.ark",
                     f"ark:{d}/pdf.{tag}"]) == 0
    assert _read(f"{d}/pdf.port") == _read(f"{d}/pdf.jax")
    truth = {k: m.argmax(axis=1) for k, m in
             SequentialMatrixReader(f"ark:{d}/loglik.ark")}
    seen = 0
    for key, pdfs in SequentialIntVectorReader(f"ark:{d}/pdf.port"):
        np.testing.assert_array_equal(pdfs, truth[key])
        seen += 1
    assert seen == 4


@pytest.mark.parametrize("mode", [[], ["--per-frame", "true"],
                                  ["--write-lengths", "true"],
                                  ["--ctm-output", "true",
                                   "--frame-shift", "0.03"]])
def test_ali_to_phones_equals_jax(oracle_ali, mode):
    from kaldi_lstm_tpu.tools.ali_to_phones import main as jax_main
    from kaldi_lstm_tpu_torch.tools.ali_to_phones import main as port_main
    d = oracle_ali
    tag = (mode or ["default"])[0].strip("-")
    for pkg, main in (("port", port_main), ("jax", jax_main)):
        out = f"{d}/ph_{tag}.{pkg}"
        if "--ctm-output" not in mode:
            out = f"ark,t:{out}"
        assert main([f"{d}/final.mdl", f"ark:{d}/ali.ark", out] + mode) == 0
    assert _read(f"{d}/ph_{tag}.port") == _read(f"{d}/ph_{tag}.jax")
    assert len(_read(f"{d}/ph_{tag}.port").splitlines()) >= 4


def test_ali_to_phones_rejects_two_modes(oracle_ali, capsys):
    from kaldi_lstm_tpu_torch.tools.ali_to_phones import main
    d = oracle_ali
    assert main([f"{d}/final.mdl", f"ark:{d}/ali.ark", f"ark,t:{d}/x",
                 "--per-frame", "1", "--write-lengths", "yes"]) == 1
    assert "exclusive" in capsys.readouterr().err


# ---------------------------------------------------------------------------
# nnet_align: the fused path
# ---------------------------------------------------------------------------

NUM_PDFS = 10


@pytest.fixture(scope="module")
def am_corpus(tmp_path_factory):
    """A seeded word corpus with 8-dim features, class counts of its
    true alignments, and a small LSTMP AM initialised by the JAX
    package from a seed."""
    import jax
    from kaldi_lstm_tpu.models import Nnet
    from kaldi_lstm_tpu.tools.ali_to_pdf import main as ali_to_pdf
    from kaldi_lstm_tpu.tools.ali_to_post import main as ali_to_post
    from kaldi_lstm_tpu.tools.compute_class_counts import main as counts
    from kaldi_lstm_tpu.tools.make_word_synth_data import main as mksynth
    d = str(tmp_path_factory.mktemp("nnet_align_port"))
    assert mksynth(["--dir", d, "--num-words", "6", "--num-phones", "5",
                    "--states-per-phone", "2", "--num-utts", "11",
                    "--feat-dim", "8", "--seed", "3"]) == 0
    assert ali_to_pdf([f"{d}/final.mdl", f"ark:{d}/ali.ark",
                       f"ark:{d}/pdf.ark"]) == 0
    assert ali_to_post([f"ark:{d}/pdf.ark", f"ark:{d}/post.ark"]) == 0
    assert counts([f"ark:{d}/post.ark", f"{d}/counts.vec",
                   "--num-classes", str(NUM_PDFS)]) == 0
    proto = f"""<NnetProto>
<LstmProjectedStreams> <InputDim> 8 <OutputDim> 6 <CellDim> 8 <ParamScale> 0.08 <NumStream> 2
<AffineTransform> <InputDim> 6 <OutputDim> {NUM_PDFS} <ParamStddev> 0.2
<Softmax> <InputDim> {NUM_PDFS} <OutputDim> {NUM_PDFS}
</NnetProto>
"""
    nnet, params = Nnet.init_from_proto(proto, jax.random.PRNGKey(2))
    nnet.write(f"{d}/nnet", params)
    # one utterance without a transcript: skipped before scoring
    with open(f"{d}/text") as f:
        lines = f.read().splitlines()
    with open(f"{d}/text_part", "w") as f:
        f.write("\n".join(lines[:4] + lines[5:]) + "\n")
    return d


FWD = ["--batch-utts", "3", "--length-bucket", "16"]


def _fused_argv(d, out, text="text", extra=()):
    return [f"{d}/nnet", f"{d}/final.mdl", f"{d}/lexicon.txt",
            f"scp:{d}/feats.scp", f"{d}/{text}", out,
            "--class-frame-counts", f"{d}/counts.vec",
            "--acoustic-scale", "1.0", *FWD, *extra]


@pytest.mark.parametrize("name,text,extra", [
    ("default", "text", []),
    ("part", "text_part", ["--batch-utts", "4"]),
    ("nosoftmax", "text", ["--no-softmax", "true"]),
])
def test_nnet_align_on_cpu_equals_jax(am_corpus, name, text, extra):
    from kaldi_lstm_tpu.tools.nnet_align import main as jax_main
    from kaldi_lstm_tpu_torch.tools.nnet_align import main as port_main
    d = am_corpus
    assert jax_main(_fused_argv(d, f"ark:{d}/fa_{name}.jax", text,
                                extra)) == 0
    assert port_main(_fused_argv(d, f"ark:{d}/fa_{name}.port", text,
                                 extra + ["--device", "cpu"])) == 0
    assert _read(f"{d}/fa_{name}.port") == _read(f"{d}/fa_{name}.jax")
    from kaldi_lstm_tpu_torch.io.kaldi_io import SequentialIntVectorReader
    n = len(list(SequentialIntVectorReader(f"ark:{d}/fa_{name}.port")))
    assert n == (10 if text == "text_part" else 11)


def test_scores_the_packages_align_on_agree(am_corpus):
    """The two packages' nnet_forward arks (the scores nnet_align aligns
    on) agree within 1e-5."""
    from kaldi_lstm_tpu.tools.nnet_forward import main as jax_fwd
    from kaldi_lstm_tpu_torch.io.kaldi_io import SequentialMatrixReader
    from kaldi_lstm_tpu_torch.tools.nnet_forward import main as port_fwd
    d = am_corpus
    common = ["--apply-log", "true", "--class-frame-counts",
              f"{d}/counts.vec", *FWD]
    assert jax_fwd([f"{d}/nnet", f"scp:{d}/feats.scp", f"ark:{d}/ll.jax"]
                   + common) == 0
    assert port_fwd([f"{d}/nnet", f"scp:{d}/feats.scp", f"ark:{d}/ll.port"]
                    + common + ["--device", "cpu"]) == 0
    got = dict(SequentialMatrixReader(f"ark:{d}/ll.port"))
    ref = dict(SequentialMatrixReader(f"ark:{d}/ll.jax"))
    assert sorted(got) == sorted(ref) and len(got) == 11
    for k in ref:
        np.testing.assert_allclose(got[k], ref[k], rtol=0, atol=1e-5)


def _two_stage(d, device, tag):
    from kaldi_lstm_tpu_torch.tools.align_mapped import main as align
    from kaldi_lstm_tpu_torch.tools.nnet_forward import main as fwd
    assert fwd([f"{d}/nnet", f"scp:{d}/feats.scp", f"ark:{d}/ll_{tag}.ark",
                "--apply-log", "true", "--class-frame-counts",
                f"{d}/counts.vec", *FWD, "--device", device]) == 0
    assert align([f"{d}/final.mdl", f"{d}/lexicon.txt",
                  f"ark:{d}/ll_{tag}.ark", f"{d}/text",
                  f"ark:{d}/two_{tag}.ark", "--acoustic-scale", "1.0"]) == 0
    return _read(f"{d}/two_{tag}.ark")


def test_nnet_align_fused_equals_its_two_stage_flow(am_corpus):
    from kaldi_lstm_tpu_torch.tools.nnet_align import main
    d = am_corpus
    two = _two_stage(d, "cpu", "cpu")
    assert main(_fused_argv(d, f"ark:{d}/fused_cpu.ark",
                            extra=["--device", "cpu"])) == 0
    assert _read(f"{d}/fused_cpu.ark") == two


def test_nnet_align_skips_untranscribed_before_scoring(am_corpus,
                                                        monkeypatch):
    """The utterance without a transcript never reaches the scorer."""
    from kaldi_lstm_tpu_torch.decode.scoring import AmScorer
    from kaldi_lstm_tpu_torch.tools.nnet_align import main
    d = am_corpus
    seen = []
    dispatch = AmScorer._dispatch

    def tracked(self, group):
        seen.extend(k for k, _ in group)
        return dispatch(self, group)
    monkeypatch.setattr(AmScorer, "_dispatch", tracked)
    assert main(_fused_argv(d, f"ark:{d}/skip.ark", "text_part",
                            ["--device", "cpu"])) == 0
    with open(f"{d}/text") as f:
        missing = f.read().splitlines()[4].split()[0]
    assert len(seen) == 10 and missing not in seen


def test_nnet_align_flag_errors_exit_1(am_corpus, capsys):
    from kaldi_lstm_tpu_torch.tools.nnet_align import main
    d = am_corpus
    assert main(_fused_argv(d, f"ark:{d}/e.ark",
                            extra=["--transcripts-are-ids",
                                   "--device", "cpu"])) == 1
    assert "--word-symbol-table" in capsys.readouterr().err
    assert main(_fused_argv(d, f"ark:{d}/e.ark",
                            extra=["--apply-log", "true", "--no-softmax",
                                   "true", "--device", "cpu"])) == 1
    assert not os.path.exists(f"{d}/e.ark")


def test_nnet_align_without_cuda_exits_1(am_corpus, monkeypatch, capsys):
    """The default device is the card: without CUDA the tool exits 1,
    says so, and writes nothing (no move to the CPU)."""
    from kaldi_lstm_tpu_torch.tools.nnet_align import main
    d = am_corpus
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    assert main(_fused_argv(d, f"ark:{d}/nocuda.ark")) == 1
    assert "CUDA is not available" in capsys.readouterr().err
    assert not os.path.exists(f"{d}/nocuda.ark")


@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card (K5 has no CPU mode); run on the "
                    "card with: python -m pytest -m gpu "
                    "tests/test_torch_align.py")
    return torch.device("cuda")


@pytest.mark.gpu
def test_nnet_align_on_the_card_equals_two_stage(cuda_device, am_corpus):
    """Fused on the card (K5, one launch per batch of 3) against
    nnet_forward on the card -> align_mapped, byte for byte."""
    from kaldi_lstm_tpu_torch.ops.counts import launch_counts, reset_counts
    from kaldi_lstm_tpu_torch.tools.nnet_align import main
    d = am_corpus
    two = _two_stage(d, "cuda", "cuda")
    reset_counts()
    assert main(_fused_argv(d, f"ark:{d}/fused_cuda.ark")) == 0
    got = launch_counts()
    assert got["lstmp_infer"] == -(-11 // 3)
    assert all(v == 0 for k, v in got.items() if k != "lstmp_infer")
    assert _read(f"{d}/fused_cuda.ark") == two


@pytest.mark.gpu
def test_nnet_align_on_the_card_scores_like_the_cpu(cuda_device, am_corpus):
    """The card's nnet_forward scores within 1e-4 of the CPU path's, and
    nnet_align's card alignments are those of align_mapped on them."""
    from kaldi_lstm_tpu_torch.io.kaldi_io import SequentialMatrixReader
    d = am_corpus
    _two_stage(d, "cuda", "cuda2")
    _two_stage(d, "cpu", "cpu2")
    got = dict(SequentialMatrixReader(f"ark:{d}/ll_cuda2.ark"))
    ref = dict(SequentialMatrixReader(f"ark:{d}/ll_cpu2.ark"))
    for k in ref:
        np.testing.assert_allclose(got[k], ref[k], rtol=0, atol=1e-4)
