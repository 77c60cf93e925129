"""The fused score->decode slice as a whole: `nnet_decode` of the port
(`--device cpu`, the plain path) against the JAX package's
`nnet_decode`, and against the port's own two-stage flow.

A tiny LstmProjectedStreams AM is trained with the JAX package on a
seeded word corpus (as tests/test_nnet_decode.py does), written once and
read by both packages. Held:

* the port against the JAX package: transcripts identical; lattices
  identical in structure (states, arcs, labels, transition-ids, finals),
  every weight within 1e-4 (the two packages' CPU scores agree to about
  1e-6 and the search sums 10^2 of them; 1e-4 leaves a wide margin
  while a wrong acoustic scale or a lost prior moves weights by whole
  units); with and without the pipeline, with a top-P fetch, at an odd
  batch boundary and in lattice mode;
* the port's fused path against its own two-stage flow (`nnet_forward`
  -> loglik ark -> `decode_faster` / `latgen_faster`): transcripts and
  lattice arks byte for byte.
"""

import os

import jax
import numpy as np
import pytest
import torch

NUM_PDFS = 10
DECODE = ["--acoustic-scale", "1.0", "--beam", "18"]


@pytest.fixture(scope="module")
def corpus(tmp_path_factory):
    from kaldi_lstm_tpu.models import Nnet
    from kaldi_lstm_tpu.tools.ali_to_pdf import main as ali_to_pdf
    from kaldi_lstm_tpu.tools.ali_to_post import main as ali_to_post
    from kaldi_lstm_tpu.tools.compute_class_counts import main as counts
    from kaldi_lstm_tpu.tools.make_word_synth_data import main as mksynth
    from kaldi_lstm_tpu.tools.train_lstm_streams import main as train

    d = str(tmp_path_factory.mktemp("fused_port"))
    assert mksynth(["--dir", d, "--num-words", "6", "--num-phones", "5",
                    "--states-per-phone", "2", "--feat-dim", "8",
                    "--num-utts", "30", "--min-pron", "2",
                    "--max-pron", "3", "--max-words", "5",
                    "--emission-noise", "0.4"]) == 0
    assert ali_to_pdf([f"{d}/final.mdl", f"ark:{d}/ali.ark",
                       f"ark:{d}/pdf_ali.ark"]) == 0
    assert ali_to_post([f"ark:{d}/pdf_ali.ark", f"ark:{d}/post.ark"]) == 0
    proto = f"""<NnetProto>
<LstmProjectedStreams> <InputDim> 8 <OutputDim> 12 <CellDim> 16 <ParamScale> 0.08 <NumStream> 8
<AffineTransform> <InputDim> 12 <OutputDim> {NUM_PDFS} <ParamStddev> 0.1
<Softmax> <InputDim> {NUM_PDFS} <OutputDim> {NUM_PDFS}
</NnetProto>"""
    nnet, params = Nnet.init_from_proto(proto, jax.random.PRNGKey(0))
    nnet.write(f"{d}/nnet.iter0", params, binary=True)
    for i in range(2):
        assert train([f"scp:{d}/feats.scp", f"ark:{d}/post.ark",
                      f"{d}/nnet.iter{i}", f"{d}/nnet.iter{i + 1}",
                      "--learn-rate=5e-3", "--num-stream=8",
                      "--targets-delay=0"]) == 0
    assert counts([f"ark:{d}/post.ark", f"{d}/counts.vec",
                   "--num-classes", str(NUM_PDFS),
                   "--counts-offset", "1"]) == 0
    return d


def _argv(d, out, extra):
    return [f"{d}/nnet.iter2", f"{d}/final.mdl", f"{d}/lexicon.txt",
            f"{d}/lm.arpa", f"scp:{d}/feats.scp", out, "--apply-log=true",
            f"--class-frame-counts={d}/counts.vec",
            "--word-symbol-table", f"{d}/words.txt", *DECODE, *extra]


def _jax_fused(d, out, extra):
    from kaldi_lstm_tpu.tools.nnet_decode import main
    assert main(_argv(d, out, extra)) == 0


def _port_fused(d, out, extra):
    from kaldi_lstm_tpu_torch.tools.nnet_decode import main
    assert main(_argv(d, out, extra) + ["--device", "cpu"]) == 0


def _read(path):
    with open(path, "rb") as f:
        return f.read()


def _assert_lattices_close(path_a, path_b, atol=1e-4):
    """Same keys, states, arcs, labels, transition-ids and finals; every
    weight within atol."""
    from kaldi_lstm_tpu.io.lattice import SequentialLatticeReader
    a = list(SequentialLatticeReader(f"ark:{path_a}"))
    b = list(SequentialLatticeReader(f"ark:{path_b}"))
    assert [k for k, _ in a] == [k for k, _ in b]
    for (key, la), (_, lb) in zip(a, b):
        assert (la.start, la.num_states) == (lb.start, lb.num_states), key
        for s in range(la.num_states):
            assert len(la.arcs[s]) == len(lb.arcs[s]), (key, s)
            for x, y in zip(la.arcs[s], lb.arcs[s]):
                assert (x.label, x.tids, x.dst) == (y.label, y.tids, y.dst)
                np.testing.assert_allclose(
                    [x.graph_cost, x.acoustic_cost],
                    [y.graph_cost, y.acoustic_cost], rtol=0, atol=atol)
        assert sorted(la.final) == sorted(lb.final), key
        for s in la.final:
            assert la.final[s][2] == lb.final[s][2]
            np.testing.assert_allclose(la.final[s][:2], lb.final[s][:2],
                                       rtol=0, atol=atol)


@pytest.mark.parametrize("name,extra", [
    ("default", []),
    ("nopipe", ["--pipeline", "false"]),
    ("topp", ["--top-p", "6"]),
    ("b7", ["--batch-utts", "7"]),
    ("threads", ["--num-threads", "2"]),
])
def test_port_matches_jax_nnet_decode(corpus, name, extra):
    d = corpus
    _jax_fused(d, f"ark,t:{d}/jax_{name}.txt", extra)
    _port_fused(d, f"ark,t:{d}/port_{name}.txt", extra)
    assert _read(f"{d}/port_{name}.txt") == _read(f"{d}/jax_{name}.txt")


def test_port_matches_jax_nnet_decode_lattices(corpus):
    d = corpus
    lat = ["--lattice-beam", "6"]
    _jax_fused(d, f"ark,t:{d}/jax_lhyp.txt",
               ["--lattice-wspecifier", f"ark:{d}/jax_lat.ark"] + lat)
    _port_fused(d, f"ark,t:{d}/port_lhyp.txt",
                ["--lattice-wspecifier", f"ark:{d}/port_lat.ark"] + lat)
    assert _read(f"{d}/port_lhyp.txt") == _read(f"{d}/jax_lhyp.txt")
    _assert_lattices_close(f"{d}/port_lat.ark", f"{d}/jax_lat.ark")


@pytest.fixture(scope="module")
def port_two_stage(corpus):
    """The port's two-stage flow on the CPU: nnet_forward -> loglik ark
    -> decode_faster and latgen_faster."""
    from kaldi_lstm_tpu_torch.tools import decode_faster, latgen_faster
    from kaldi_lstm_tpu_torch.tools.nnet_forward import main as fwd
    d = corpus
    assert fwd([f"{d}/nnet.iter2", f"scp:{d}/feats.scp",
                f"ark:{d}/port_loglik.ark", "--apply-log=true",
                f"--class-frame-counts={d}/counts.vec",
                "--device", "cpu"]) == 0
    graph = [f"{d}/final.mdl", f"{d}/lexicon.txt", f"{d}/lm.arpa",
             f"ark:{d}/port_loglik.ark"]
    words = ["--word-symbol-table", f"{d}/words.txt"]
    assert decode_faster.main(graph + [f"ark,t:{d}/two_hyp.txt"] + words
                              + DECODE) == 0
    assert latgen_faster.main(
        graph + [f"ark:{d}/two_lat.ark", "--transcript-wspecifier",
                 f"ark,t:{d}/two_lhyp.txt", "--lattice-beam", "6"]
        + words + DECODE) == 0
    return d


@pytest.mark.parametrize("extra", [[], ["--pipeline", "false"],
                                   ["--batch-utts", "7"]])
def test_port_fused_equals_its_two_stage_flow(port_two_stage, extra):
    d = port_two_stage
    _port_fused(d, f"ark,t:{d}/fused_hyp.txt", extra)
    assert _read(f"{d}/fused_hyp.txt") == _read(f"{d}/two_hyp.txt")


def test_port_fused_lattices_equal_its_two_stage_flow(port_two_stage):
    d = port_two_stage
    _port_fused(d, f"ark,t:{d}/fused_lhyp.txt",
                ["--lattice-wspecifier", f"ark:{d}/fused_lat.ark",
                 "--lattice-beam", "6"])
    assert _read(f"{d}/fused_lhyp.txt") == _read(f"{d}/two_lhyp.txt")
    assert _read(f"{d}/fused_lat.ark") == _read(f"{d}/two_lat.ark")


def test_fetch_dtype_bf16_rounds_the_fetched_scores(corpus):
    """`--fetch-dtype bf16` is parsed to torch.bfloat16 and decodes."""
    from kaldi_lstm_tpu_torch.tools.nnet_decode import build_parser, make_scorer
    d = corpus
    args = build_parser().parse_args(
        _argv(d, f"ark,t:{d}/bf16.txt", ["--fetch-dtype", "bf16"])
        + ["--device", "cpu"])
    scorer = make_scorer(args)
    assert scorer.fetch_dtype is torch.bfloat16
    _port_fused(d, f"ark,t:{d}/bf16.txt", ["--fetch-dtype", "bf16"])
    assert os.path.getsize(f"{d}/bf16.txt") > 0


def test_lattice_mode_rejects_a_second_transcript_output(corpus, capsys):
    from kaldi_lstm_tpu_torch.tools.nnet_decode import main
    d = corpus
    rc = main(_argv(d, f"ark,t:{d}/a.txt",
                    ["--lattice-wspecifier", f"ark:{d}/x.ark",
                     "--transcript-wspecifier", f"ark,t:{d}/b.txt",
                     "--device", "cpu"]))
    assert rc == 1 and "trans-wspecifier" in capsys.readouterr().err
