"""The port's phone-loop Viterbi decoder (decode/viterbi.py) and
`decode_viterbi` CLI against the JAX package's, and the port's
transition-model helpers that the alignment tools use.

The same transition models go to both packages (the monophone model
built by each; the chain-style split-pdf model built by the JAX package,
written and read by the port) and the same log-likelihoods are made
with numpy from a seed. Held: the phone-loop graph arrays exactly, the
phone sequences exactly, the float64 path scores within 1e-9, and the
CLI's transcript bytes exactly. The behaviours of the JAX package's
tests/test_decode_viterbi.py are each a case here: exact recovery on
peaked scores, same-phone repetition, noise with a scale, split-pdf
chain decoding with its exact score, wrong-order split pdfs, a
1-state phone's re-entry, and the CLI into compute_wer.
"""

import os

import numpy as np
import pytest

from kaldi_lstm_tpu.decode import viterbi as jv
from kaldi_lstm_tpu.io import transition_model as jtm
from kaldi_lstm_tpu_torch.decode import viterbi as pv
from kaldi_lstm_tpu_torch.io import transition_model as ptm

P, SPS = 4, 3
ATOL = 1e-9


def expand(phone_seq, frames_per_state=2):
    pdfs = []
    for ph in phone_seq:
        for s in range(SPS):
            pdfs += [(ph - 1) * SPS + s] * frames_per_state
    return pdfs


def peaked_loglik(pdfs, num_pdfs, peak=5.0):
    ll = np.zeros((len(pdfs), num_pdfs), np.float32)
    ll[np.arange(len(pdfs)), pdfs] = peak
    return ll


def _chain(num_phones):
    """(port, JAX) chain model: the JAX package's, read by the port."""
    import tempfile
    jm = jtm.make_chain_transition_model(num_phones)
    with tempfile.TemporaryDirectory() as d:
        jm.dump(os.path.join(d, "chain.mdl"))
        return ptm.TransitionModel.load(os.path.join(d, "chain.mdl")), jm


def _models(kind):
    if kind == "monophone":
        return (ptm.make_monophone_transition_model(P, SPS),
                jtm.make_monophone_transition_model(P, SPS))
    return _chain(3)


@pytest.mark.parametrize("kind", ["monophone", "chain"])
def test_models_and_graphs_equal_jax(tmp_path, kind):
    pm, jm = _models(kind)
    pm.dump(str(tmp_path / "p.mdl"))
    jm.dump(str(tmp_path / "j.mdl"))
    assert (tmp_path / "p.mdl").read_bytes() == \
        (tmp_path / "j.mdl").read_bytes()
    for name in ("id2pdf", "id2phone", "id2final"):
        np.testing.assert_array_equal(getattr(pm, name), getattr(jm, name))
    pg = pv.PhoneLoopGraph.from_transition_model(pm, 0.5)
    jg = jv.PhoneLoopGraph.from_transition_model(jm, 0.5)
    for f in ("logA", "start_logp", "final_logp", "state_pdf", "state_phone",
              "is_entry", "self_pdf", "self_logp", "logA_enter"):
        np.testing.assert_array_equal(getattr(pg, f), getattr(jg, f))


def _decode_both(kind, ll, scale=1.0, penalty=0.0):
    pm, jm = _models(kind)
    got = pv.viterbi_decode(
        pv.PhoneLoopGraph.from_transition_model(pm, penalty), ll, scale)
    ref = jv.viterbi_decode(
        jv.PhoneLoopGraph.from_transition_model(jm, penalty), ll, scale)
    assert got[0] == ref[0]
    assert abs(got[1] - ref[1]) <= ATOL
    return got


@pytest.mark.parametrize("seq", [[1, 3, 2, 4, 1], [2, 2, 3], [4]])
def test_peaked_recovery_equals_jax(seq):
    hyp, logp = _decode_both("monophone",
                             peaked_loglik(expand(seq), P * SPS))
    assert hyp == seq and np.isfinite(logp)


@pytest.mark.parametrize("scale,penalty", [(1.0, 0.0), (0.3, 1.5)])
def test_noisy_and_random_scores_equal_jax(scale, penalty):
    rng = np.random.RandomState(0)
    seq = [4, 1, 2]
    ll = peaked_loglik(expand(seq, 3), P * SPS, peak=4.0)
    ll += rng.randn(*ll.shape).astype(np.float32) * 0.5
    hyp, _ = _decode_both("monophone", ll, scale, penalty)
    if scale == 1.0:
        assert hyp == seq
    for _ in range(4):
        _decode_both("monophone",
                     rng.randn(30, P * SPS).astype(np.float32) * 3.0,
                     scale, penalty)
        _decode_both("chain", rng.randn(25, 6).astype(np.float32) * 3.0,
                     scale, penalty)


def test_split_pdf_chain_decode_exact_score():
    seq, dur = [1, 3, 2, 3], 3
    pdfs = []
    for ph in seq:
        fwd, slf = (ph - 1) * 2, (ph - 1) * 2 + 1
        pdfs += [slf] * (dur - 1) + [fwd]
    hyp, logp = _decode_both("chain", peaked_loglik(pdfs, 6))
    assert hyp == seq
    expect = 5.0 * len(pdfs) + len(pdfs) * np.log(0.5) - len(seq) * np.log(3)
    assert abs(logp - expect) < 1e-6


def test_split_pdf_order_and_one_state_reentry():
    pm, _ = _chain(2)
    g = pv.PhoneLoopGraph.from_transition_model(pm)
    _, lp_good = pv.viterbi_decode(g, peaked_loglik([1, 1, 0], 4))
    _, lp_bad = pv.viterbi_decode(g, peaked_loglik([0, 1, 1], 4))
    assert lp_good > lp_bad + 4.0
    hyp, _ = pv.viterbi_decode(g, peaked_loglik([1, 0, 1, 0], 4))
    assert hyp == [1, 1]


def test_transition_model_phone_helpers_equal_jax():
    rng = np.random.RandomState(2)
    for kind in ("monophone", "chain"):
        pm, jm = _models(kind)
        tids = rng.randint(1, pm.num_transition_ids + 1, 40)
        np.testing.assert_array_equal(pm.transition_ids_to_phones(tids),
                                      jm.transition_ids_to_phones(tids))
        assert [pm.transition_id_to_pdf(int(t)) for t in tids] == \
            [jm.transition_id_to_pdf(int(t)) for t in tids]
        got = pm.split_to_phones(tids)
        ref = jm.split_to_phones(tids)
        assert [s.tolist() for s in got] == [s.tolist() for s in ref]
        with pytest.raises(ValueError, match="out of range"):
            pm.transition_ids_to_phones([0])
        with pytest.raises(ValueError, match="out of range"):
            pm.transition_ids_to_phones([pm.num_transition_ids + 1])


@pytest.mark.parametrize("extra", [[], ["--acoustic-scale", "0.5",
                                        "--phone-insertion-penalty", "1"]])
def test_decode_viterbi_cli_equals_jax(tmp_path, capsys, extra):
    from kaldi_lstm_tpu.io.kaldi_io import MatrixWriter
    from kaldi_lstm_tpu.tools.decode_viterbi import main as jax_main
    from kaldi_lstm_tpu_torch.tools.compute_wer import main as wer_main
    from kaldi_lstm_tpu_torch.tools.decode_viterbi import main as port_main
    tm = ptm.make_monophone_transition_model(P, SPS)
    mdl = str(tmp_path / "final.mdl")
    tm.dump(mdl)
    rng = np.random.RandomState(4)
    seqs = {"utt1": [1, 2], "utt2": [3, 1, 4], "utt3": [2, 2]}
    with MatrixWriter(f"ark:{tmp_path}/ll.ark") as w:
        for k, seq in seqs.items():
            ll = peaked_loglik(expand(seq), tm.num_pdfs)
            w.write(k, ll + 0.3 * rng.randn(*ll.shape).astype(np.float32))
    with open(tmp_path / "ref.txt", "w") as f:
        for k, seq in seqs.items():
            f.write(k + " " + " ".join(map(str, seq)) + "\n")
    for tag, main in (("port", port_main), ("jax", jax_main)):
        assert main([mdl, f"ark:{tmp_path}/ll.ark",
                     f"ark,t:{tmp_path}/{tag}.txt"] + extra) == 0
    assert (tmp_path / "port.txt").read_bytes() == \
        (tmp_path / "jax.txt").read_bytes()
    capsys.readouterr()
    if not extra:
        assert wer_main([str(tmp_path / "ref.txt"),
                         str(tmp_path / "port.txt")]) == 0
        out = capsys.readouterr().out
        assert "%WER 0.00 [ 0 / 7" in out and "%SER 0.00" in out


def test_decode_viterbi_rejects_narrow_scores(tmp_path, capsys):
    from kaldi_lstm_tpu_torch.io.kaldi_io import MatrixWriter
    from kaldi_lstm_tpu_torch.tools.decode_viterbi import main
    tm = ptm.make_monophone_transition_model(P, SPS)
    tm.dump(str(tmp_path / "final.mdl"))
    with MatrixWriter(f"ark:{tmp_path}/ll.ark") as w:
        w.write("u", np.zeros((5, 3), np.float32))
    assert main([str(tmp_path / "final.mdl"), f"ark:{tmp_path}/ll.ark",
                 f"ark,t:{tmp_path}/h.txt"]) == 1
    assert "loglik dim" in capsys.readouterr().err
