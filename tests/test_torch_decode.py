"""The port's host decode stack against the JAX package's, on one shared
loglik ark (made with numpy from a seed over a seeded word corpus with a
counted trigram LM):

* `decode_faster` and `latgen_faster` CLIs: transcripts and lattice arks
  (determinized and `--raw`, binary and text) byte-identical, for the
  native dense core, the native sparse core (`KLT_DECODE_SPARSE=1`) and
  the numpy decoders (`KLT_DECODE_IMPL=python`), and with
  `--num-threads 2`; `compute_wer` prints the same report;
* the native core never falls back: a compiler that fails, or a broken
  copy of the source, makes the decode raise with the compiler's error;
* `nnet_decode --device cuda` without CUDA exits 1 and writes nothing.
"""

import os

import numpy as np
import pytest

from kaldi_lstm_tpu.io.kaldi_io import MatrixWriter, SequentialIntVectorReader
from kaldi_lstm_tpu.io.transition_model import TransitionModel

CORES = {
    "native-dense": {"KLT_DECODE_SPARSE": "0"},
    "native-sparse": {"KLT_DECODE_SPARSE": "1"},
    "python": {"KLT_DECODE_IMPL": "python"},
}
SEARCH = ["--acoustic-scale", "0.5", "--beam", "12", "--max-active", "60"]


@pytest.fixture(scope="module")
def corpus(tmp_path_factory):
    """Trigram word corpus + a loglik ark that favours each frame's
    aligned pdf by 4 nats over seeded Gaussian noise."""
    from kaldi_lstm_tpu.tools.make_word_synth_data import main as mksynth
    d = str(tmp_path_factory.mktemp("decode_port"))
    assert mksynth(["--dir", d, "--num-words", "40", "--num-phones", "9",
                    "--num-utts", "10", "--lm-order", "3",
                    "--lm-train-sents", "400", "--max-words", "6",
                    "--sil-prob", "0.1"]) == 0
    tm = TransitionModel.load(f"{d}/final.mdl")
    rng = np.random.RandomState(0)
    with MatrixWriter(f"ark:{d}/loglik.ark") as w:
        for key, ali in SequentialIntVectorReader(f"ark:{d}/ali.ark"):
            pdf = tm.transition_ids_to_pdfs(ali)
            m = rng.randn(len(pdf), tm.num_pdfs).astype(np.float32) - 5
            m[np.arange(len(pdf)), pdf] += 4
            w.write(key, m)
    return d


def _graph(d):
    return [f"{d}/final.mdl", f"{d}/lexicon.txt", f"{d}/lm.arpa",
            f"ark:{d}/loglik.ark"]


def _read(path):
    with open(path, "rb") as f:
        return f.read()


def _set_core(monkeypatch, core):
    for k in ("KLT_DECODE_SPARSE", "KLT_DECODE_IMPL", "KLT_LATGEN_DENSE"):
        monkeypatch.delenv(k, raising=False)
    for k, v in CORES[core].items():
        monkeypatch.setenv(k, v)


@pytest.mark.parametrize("core", sorted(CORES))
@pytest.mark.parametrize("threads", ["1", "2"])
def test_decode_faster_matches_jax(corpus, monkeypatch, core, threads):
    from kaldi_lstm_tpu.tools.decode_faster import main as jax_main
    from kaldi_lstm_tpu_torch.tools.decode_faster import main as port_main
    d = corpus
    _set_core(monkeypatch, core)
    tail = ["--word-symbol-table", f"{d}/words.txt", "--num-threads",
            threads] + SEARCH
    assert jax_main(_graph(d) + [f"ark,t:{d}/jax.txt"] + tail) == 0
    assert port_main(_graph(d) + [f"ark,t:{d}/port.txt"] + tail) == 0
    assert _read(f"{d}/port.txt") == _read(f"{d}/jax.txt")
    assert len(_read(f"{d}/port.txt").splitlines()) == 10


@pytest.mark.parametrize("core", sorted(CORES))
@pytest.mark.parametrize("mode", ["det", "raw", "det-text"])
def test_latgen_faster_matches_jax(corpus, monkeypatch, core, mode):
    from kaldi_lstm_tpu.tools.latgen_faster import main as jax_main
    from kaldi_lstm_tpu_torch.tools.latgen_faster import main as port_main
    d = corpus
    _set_core(monkeypatch, core)
    spec = "ark,t" if mode == "det-text" else "ark"
    tail = ["--lattice-beam", "5"] + SEARCH
    if mode == "raw":
        tail.append("--raw")
    for tag, main in (("jax", jax_main), ("port", port_main)):
        assert main(_graph(d) + [f"{spec}:{d}/{tag}.lat",
                                 "--transcript-wspecifier",
                                 f"ark,t:{d}/{tag}.ltxt"] + tail) == 0
    assert _read(f"{d}/port.lat") == _read(f"{d}/jax.lat")
    assert _read(f"{d}/port.ltxt") == _read(f"{d}/jax.ltxt")


@pytest.mark.parametrize("dense", ["0", "1"])
def test_latgen_threads_and_dense_forward_match_jax(corpus, monkeypatch,
                                                    dense):
    """--num-threads 2, with the sparse-alpha (default) and the dense
    (KLT_LATGEN_DENSE=1) native lattice forward."""
    from kaldi_lstm_tpu.tools.latgen_faster import main as jax_main
    from kaldi_lstm_tpu_torch.tools.latgen_faster import main as port_main
    d = corpus
    _set_core(monkeypatch, "native-dense")
    monkeypatch.setenv("KLT_LATGEN_DENSE", dense)
    tail = ["--lattice-beam", "5", "--num-threads", "2"] + SEARCH
    assert jax_main(_graph(d) + [f"ark:{d}/jt.lat"] + tail) == 0
    assert port_main(_graph(d) + [f"ark:{d}/pt.lat"] + tail) == 0
    assert _read(f"{d}/pt.lat") == _read(f"{d}/jt.lat")


def test_compute_wer_prints_the_same_report(corpus, capsys):
    from kaldi_lstm_tpu.tools.compute_wer import main as jax_main
    from kaldi_lstm_tpu_torch.tools.compute_wer import main as port_main
    from kaldi_lstm_tpu_torch.tools.decode_faster import main as decode
    d = corpus
    assert decode(_graph(d) + [f"ark,t:{d}/hyp.txt", "--word-symbol-table",
                               f"{d}/words.txt", "--acoustic-scale", "0.2",
                               "--beam", "6"]) == 0
    capsys.readouterr()
    reports = []
    for main in (jax_main, port_main):
        for mode in ("strict", "present"):
            assert main([f"{d}/text", f"ark,t:{d}/hyp.txt", "--mode",
                         mode]) == 0
            reports.append(capsys.readouterr())
    assert reports[:2] == reports[2:]
    assert reports[0].out.startswith("%WER ")


@pytest.fixture
def fresh_native(monkeypatch, tmp_path):
    """The port's native module with no library loaded and an empty
    build directory, so the next decode builds from SOURCE."""
    import kaldi_lstm_tpu_torch.io.native as native
    monkeypatch.setattr(native, "_LIB", None)
    monkeypatch.setattr(native, "BUILD_DIR", str(tmp_path / "build"))
    return native


def _small_decode():
    from kaldi_lstm_tpu_torch.decode.faster import decode_faster
    from kaldi_lstm_tpu_torch.decode.graph import build_decoding_graph
    from kaldi_lstm_tpu_torch.io.arpa import uniform_unigram
    from kaldi_lstm_tpu_torch.io.transition_model import (
        make_monophone_transition_model,
    )
    tm = make_monophone_transition_model(4, 2)
    lex = {"a": [[2, 3]], "b": [[4]]}
    graph = build_decoding_graph(tm, lex, uniform_unigram(sorted(lex)))
    loglik = np.random.RandomState(0).randn(12, tm.num_pdfs)
    return decode_faster(graph, loglik, 1.0, 10.0)


def test_failing_compiler_raises_and_never_falls_back(fresh_native,
                                                      monkeypatch, tmp_path):
    cxx = tmp_path / "broken-cxx"
    cxx.write_text("#!/bin/sh\necho 'fatal: this compiler is broken' >&2\n"
                   "exit 3\n")
    cxx.chmod(0o755)
    monkeypatch.setenv("CXX", str(cxx))
    monkeypatch.delenv("KLT_DECODE_IMPL", raising=False)
    with pytest.raises(RuntimeError, match="this compiler is broken"):
        _small_decode()
    assert fresh_native._LIB is None
    assert not [f for f in os.listdir(fresh_native.BUILD_DIR)
                if f.endswith(".so")]
    # the numpy decoder runs only when asked for
    monkeypatch.setenv("KLT_DECODE_IMPL", "python")
    assert _small_decode().words is not None


def test_missing_compiler_raises(fresh_native, monkeypatch, tmp_path):
    monkeypatch.setenv("CXX", str(tmp_path / "no-such-compiler"))
    with pytest.raises(RuntimeError, match="could not run"):
        fresh_native.get_lib()


def test_broken_source_raises_with_the_compiler_error(fresh_native,
                                                      monkeypatch, tmp_path):
    src = tmp_path / "kltdecode.cc"
    with open(fresh_native.SOURCE) as f:
        src.write_text(f.read() + "\nthis is not C++;\n")
    monkeypatch.setattr(fresh_native, "SOURCE", str(src))
    monkeypatch.delenv("KLT_DECODE_IMPL", raising=False)
    with pytest.raises(RuntimeError, match="error"):
        _small_decode()
    with pytest.raises(RuntimeError, match="kltdecode.cc"):
        fresh_native.get_lib()


def test_build_is_named_by_source_and_reused(fresh_native, tmp_path):
    src = tmp_path / "kltdecode.cc"
    with open(fresh_native.SOURCE) as f:
        text = f.read()
    src.write_text(text)
    a = fresh_native.lib_path(str(src), fresh_native.BUILD_DIR)
    src.write_text(text + "\n// an edit\n")
    b = fresh_native.lib_path(str(src), fresh_native.BUILD_DIR)
    assert a != b and os.path.basename(a).startswith("libkltdecode.")
    path = fresh_native.build(str(src), fresh_native.BUILD_DIR)
    mtime = os.path.getmtime(path)
    assert fresh_native.build(str(src), fresh_native.BUILD_DIR) == path
    assert os.path.getmtime(path) == mtime
    assert not [f for f in os.listdir(fresh_native.BUILD_DIR)
                if f.endswith(".tmp")]


def test_nnet_decode_device_cuda_without_cuda_exits_1(tmp_path, monkeypatch,
                                                      capsys):
    import torch
    from kaldi_lstm_tpu_torch.tools import nnet_decode
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    out, lat = tmp_path / "hyp.txt", tmp_path / "lat.ark"
    assert nnet_decode.main(["m.nnet", "final.mdl", "lexicon.txt", "lm.arpa",
                             "ark:f.ark", f"ark,t:{out}",
                             "--lattice-wspecifier", f"ark:{lat}"]) == 1
    assert "CUDA is not available" in capsys.readouterr().err
    assert not out.exists() and not lat.exists()


def test_raw_lattice_writer_refuses_a_compact_lattice(tmp_path):
    """The raw writer no longer refuses a CompactLattice: it writes the
    state-level Lattice of compact_to_lattice, byte for byte as the JAX
    package's raw writer does (tests/test_torch_lattice.py holds more
    cases)."""
    from kaldi_lstm_tpu.io import lattice as jl
    from kaldi_lstm_tpu_torch.io import lattice as pl
    for tag, mod in (("port", pl), ("jax", jl)):
        clat = mod.CompactLattice()
        for _ in range(2):
            clat.add_state()
        clat.arcs[0].append(mod.CompactLatticeArc(3, 0.5, 1.5, (4, 5), 1))
        clat.final[1] = (0.25, 0.0, (6,))
        with mod.LatticeWriter(f"ark:{tmp_path / tag}.ark",
                               compact=False) as w:
            w.write("utt", clat)
    raw = (tmp_path / "port.ark").read_bytes()
    assert raw == (tmp_path / "jax.ark").read_bytes()
    assert b"lattice4" in raw and b"compactlattice44" not in raw
