"""The port's sequence trainers (`tools/nnet_train_{smbr,mmi,
mmi_sequential,mpe_sequential}.py`) against the JAX package's tools on
the CPU.

Held, on tiny corpora from the JAX package's `make_hmm_synth_data` and
`make_word_synth_data` (denominator lattices from its `latgen_faster`)
and one model file both packages read:
* one iteration of each tool and its JAX twin: the written params
  within 1e-5 relative (each tensor's atol 1e-5 times its largest
  entry: a weight that starts at 0 is all update), the objective
  line's number equal to its 6 printed digits, the "Done ..." line equal;
* `--cross-validate`: the forward runs without autograd (the plain K5
  path on the CPU, no training call) and reports the JAX figure;
* a 1-emitting-state phone set (the numerator's max(self, re-entry)
  pair) and a bucket that pads (the last frame repeated, mask 0);
* `--skip-nonfinite`: an utterance with a NaN frame is skipped with
  params and momentum unchanged (the model equals the run without that
  utterance, byte for byte), and a pass that trains nothing exits 1
  (a deliberate difference: the JAX tool exits 0);
* `ark:`-only alignments with the JAX tool's message, and `--device
  cuda` exiting 1 without CUDA.

Tolerance: both sides are float32; gradients sum frames in other
orders (~1e-7 relative) and one pass of a few updates keeps that far
under 1e-5.
"""

import re

import jax
import numpy as np
import pytest
import torch

from kaldi_lstm_tpu.models import Nnet as JNnet
from kaldi_lstm_tpu.tools import latgen_faster as j_latgen
from kaldi_lstm_tpu.tools import make_hmm_synth_data as j_hmm
from kaldi_lstm_tpu.tools import make_word_synth_data as j_word
from kaldi_lstm_tpu.tools import nnet_forward as j_forward
from kaldi_lstm_tpu.tools import nnet_train_mmi as j_mmi
from kaldi_lstm_tpu.tools import nnet_train_mmi_sequential as j_mmi_seq
from kaldi_lstm_tpu.tools import nnet_train_mpe_sequential as j_mpe_seq
from kaldi_lstm_tpu.tools import nnet_train_smbr as j_smbr
from kaldi_lstm_tpu_torch.io import kaldi_io as kio
from kaldi_lstm_tpu_torch.io.transition_model import TransitionModel
from kaldi_lstm_tpu_torch.models import Nnet
from kaldi_lstm_tpu_torch.ops import lstm_infer as li
from kaldi_lstm_tpu_torch.ops import lstm_train as lt
from kaldi_lstm_tpu_torch.tools import nnet_train_mmi as t_mmi
from kaldi_lstm_tpu_torch.tools import nnet_train_mmi_sequential as t_mmi_seq
from kaldi_lstm_tpu_torch.tools import nnet_train_mpe_sequential as t_mpe_seq
from kaldi_lstm_tpu_torch.tools import nnet_train_smbr as t_smbr
from kaldi_lstm_tpu_torch.utils.tree import tree_leaves

D = 6
PROTO = """<NnetProto>
<TimeShift> <InputDim> {d} <OutputDim> {d} <Shift> 1
<LstmProjected> <InputDim> {d} <OutputDim> 10 <CellDim> 14 <ParamScale> 0.1
<AffineTransform> <InputDim> 10 <OutputDim> {k} <ParamStddev> 0.3
<Softmax> <InputDim> {k} <OutputDim> {k}
</NnetProto>"""
_OBJ = re.compile(r"(Accuracy/frame|AvgMMI\(den-num\)/frame|"
                  r"MMI-objective/frame|accuracy/frame): (\S+)")


def hmm_corpus(d, states_per_phone=2, num_utts=6, seed=0):
    assert j_hmm.main(["--dir", d, "--num-phones", "3",
                       "--states-per-phone", str(states_per_phone),
                       "--feat-dim", str(D), "--num-utts", str(num_utts),
                       "--min-phones", "2", "--max-phones", "4",
                       "--seed", str(seed)]) == 0
    return f"scp:{d}/feats.scp", f"ark:{d}/ali.ark", f"{d}/final.mdl"


def init_model(d, k, seed=3, name="init.nnet"):
    nnet, params = Nnet.init_from_proto(
        PROTO.format(d=D, k=k), torch.Generator().manual_seed(seed), "cpu")
    nnet.write(f"{d}/{name}", params)
    return f"{d}/{name}"


def num_pdfs(mdl):
    return TransitionModel.load(mdl).num_pdfs


def run_both(capfd, j_main, t_main, argv_j, argv_t):
    """The JAX CLI, then the port's with --device cpu; their stderr."""
    assert j_main(argv_j) == 0
    j_err = capfd.readouterr().err
    assert t_main(argv_t + ["--device", "cpu"]) == 0
    t_err = capfd.readouterr().err
    return j_err, t_err


def objective(err):
    return _OBJ.search(err).group(2)


def done_line(err):
    return re.search(r"Done [^\[\n]*", err).group(0)


def assert_models_close(t_path, j_path):
    t_leaves = tree_leaves(Nnet.read(t_path, "cpu")[1])
    j_leaves = jax.tree_util.tree_leaves(JNnet.read(j_path)[1])
    assert len(t_leaves) == len(j_leaves) > 0
    for a, b in zip(t_leaves, j_leaves):
        b = np.asarray(b)
        np.testing.assert_allclose(a.numpy(), b, rtol=1e-5,
                                   atol=1e-5 * float(np.abs(b).max()))


def read_bytes(path):
    with open(path, "rb") as f:
        return f.read()


LATTICE_FREE = {"smbr": (j_smbr.main, t_smbr.main),
                "mmi": (j_mmi.main, t_mmi.main)}


@pytest.mark.parametrize("tool,states,extra", [
    ("smbr", 2, []),
    ("smbr", 2, ["--criterion=mpe", "--silence-phones=1",
                 "--momentum=0.5"]),
    ("smbr", 1, ["--length-bucket=7"]),
    ("mmi", 2, ["--momentum=0.5"]),
    ("mmi", 1, ["--length-bucket=7"]),
])
def test_lattice_free_iteration_matches_jax(tmp_path, capfd, tool, states,
                                            extra):
    d = str(tmp_path)
    feats, ali, mdl = hmm_corpus(d, states)
    model = init_model(d, num_pdfs(mdl))
    flags = ["--learn-rate=0.02", "--acoustic-scale=0.5",
             "--length-bucket=32"] + extra
    j_main, t_main = LATTICE_FREE[tool]
    lt.reset_counts()
    li.reset_counts()
    j_err, t_err = run_both(capfd, j_main, t_main,
                            [feats, ali, mdl, model, f"{d}/j.nnet"] + flags,
                            [feats, ali, mdl, model, f"{d}/t.nnet"] + flags)
    # one training call per utterance (forward and backward), no K5
    assert lt.PLAIN_CALLS == 2 * 6 and li.PLAIN_CALLS == 0
    assert_models_close(f"{d}/t.nnet", f"{d}/j.nnet")
    assert done_line(t_err) == done_line(j_err) == \
        "Done 6 files, 0 with no alignment, 0 with other errors. "
    assert objective(t_err) == objective(j_err)

    # cross-validation of the trained model: forward only (K5's path)
    cv = ["--cross-validate=true", "--acoustic-scale=0.5"] + extra
    lt.reset_counts()
    li.reset_counts()
    j_err, t_err = run_both(capfd, j_main, t_main,
                            [feats, ali, mdl, f"{d}/j.nnet"] + cv,
                            [feats, ali, mdl, f"{d}/t.nnet"] + cv)
    assert lt.PLAIN_CALLS == 0 and li.PLAIN_CALLS == 6
    assert "[CROSS-VALIDATION" in t_err
    np.testing.assert_allclose(float(objective(t_err)),
                               float(objective(j_err)), rtol=1e-5)


def test_smbr_feature_transform_and_priors_match_jax(tmp_path, capfd):
    """--feature-transform (outside the gradient) and
    --class-frame-counts (log-likelihoods) as the JAX tool applies them."""
    d = str(tmp_path)
    feats, ali, mdl = hmm_corpus(d, seed=1)
    k = num_pdfs(mdl)
    model = init_model(d, k, seed=4)
    tnet, tparams = Nnet.init_from_proto(
        f"<NnetProto>\n<AffineTransform> <InputDim> {D} <OutputDim> {D} "
        f"<ParamStddev> 0.3\n</NnetProto>",
        torch.Generator().manual_seed(5), "cpu")
    tnet.write(f"{d}/transf.nnet", tparams)
    with open(f"{d}/counts.vec", "wb") as f:
        kio.write_vector(kio.KaldiOutput(f, binary=False),
                         np.arange(1, k + 1, dtype=np.float32))
    flags = ["--learn-rate=0.02", "--acoustic-scale=0.5",
             f"--feature-transform={d}/transf.nnet",
             f"--class-frame-counts={d}/counts.vec"]
    j_err, t_err = run_both(capfd, j_smbr.main, t_smbr.main,
                            [feats, ali, mdl, model, f"{d}/j.nnet"] + flags,
                            [feats, ali, mdl, model, f"{d}/t.nnet"] + flags)
    assert_models_close(f"{d}/t.nnet", f"{d}/j.nnet")
    assert objective(t_err) == objective(j_err)


def nan_corpus(d, feats, nan_key):
    """The corpus as an ark, one utterance's middle frame set to NaN; and
    the same corpus without that utterance."""
    with kio.MatrixWriter(f"ark:{d}/nan.ark") as wn, \
            kio.MatrixWriter(f"ark:{d}/clean.ark") as wc:
        for k, m in kio.SequentialMatrixReader(feats):
            if k == nan_key:
                m = m.copy()
                m[m.shape[0] // 2, 0] = np.nan
                wn.write(k, m)
                continue
            wn.write(k, m)
            wc.write(k, m)
    return f"ark:{d}/nan.ark", f"ark:{d}/clean.ark"


def test_smbr_skip_nonfinite_leaves_params_and_momentum(tmp_path, capfd):
    d = str(tmp_path)
    feats, ali, mdl = hmm_corpus(d)
    model = init_model(d, num_pdfs(mdl))
    keys = [k for k, _ in kio.SequentialMatrixReader(feats)]
    nan_ark, clean_ark = nan_corpus(d, feats, keys[2])
    flags = ["--learn-rate=0.02", "--momentum=0.9", "--acoustic-scale=0.5"]
    with pytest.raises(FloatingPointError):
        t_smbr.main([nan_ark, ali, mdl, model, f"{d}/x.nnet", "--device",
                     "cpu"] + flags)
    skip = flags + ["--skip-nonfinite=true"]
    j_err, t_err = run_both(capfd, j_smbr.main, t_smbr.main,
                            [nan_ark, ali, mdl, model, f"{d}/j.nnet"] + skip,
                            [nan_ark, ali, mdl, model, f"{d}/t.nnet"] + skip)
    assert done_line(t_err) == done_line(j_err) == \
        "Done 5 files, 0 with no alignment, 1 with other errors. "
    assert_models_close(f"{d}/t.nnet", f"{d}/j.nnet")
    # the skipped utterance moved neither params nor momentum: the pass
    # equals the pass without it, byte for byte
    assert t_smbr.main([clean_ark, ali, mdl, model, f"{d}/c.nnet",
                        "--device", "cpu"] + flags) == 0
    assert read_bytes(f"{d}/t.nnet") == read_bytes(f"{d}/c.nnet")


def test_smbr_pass_that_trains_nothing_exits_1(tmp_path, capfd):
    """A NaN parameter makes every E[A] non-finite: with
    --skip-nonfinite the JAX tool writes the model and exits 0, the port
    logs an ERROR, writes nothing and exits 1."""
    d = str(tmp_path)
    feats, ali, mdl = hmm_corpus(d)
    model = init_model(d, num_pdfs(mdl))
    nnet, params = Nnet.read(model, "cpu")
    params[1].bias[0] = float("nan")
    nnet.write(f"{d}/bad.nnet", params)
    argv = [feats, ali, mdl, f"{d}/bad.nnet"]
    flags = ["--learn-rate=0.02", "--skip-nonfinite=true"]
    assert j_smbr.main(argv + [f"{d}/j.nnet"] + flags) == 0
    capfd.readouterr()
    assert t_smbr.main(argv + [f"{d}/t.nnet", "--device", "cpu"]
                       + flags) == 1
    err = capfd.readouterr().err
    assert "Done 0 files, 0 with no alignment, 6 with other errors." in err
    assert "ERROR" in err and "no utterance was trained" in err
    assert not (tmp_path / "t.nnet").exists()


@pytest.mark.parametrize("tool", ["smbr", "mmi"])
def test_alignments_are_ark_only(tmp_path, tool):
    d = str(tmp_path)
    feats, ali, mdl = hmm_corpus(d, num_utts=2)
    model = init_model(d, num_pdfs(mdl))
    with open(f"{d}/ali.scp", "w") as f:
        f.write(f"utt_00000 {d}/ali.ark:10\n")
    j_main, t_main = LATTICE_FREE[tool]
    argv = [feats, f"scp:{d}/ali.scp", mdl, model, f"{d}/o.nnet"]
    msg = "nnet_train_mmi: only ark: alignments supported"
    with pytest.raises(ValueError, match=msg):
        j_main(argv)
    with pytest.raises(ValueError, match=msg):
        t_main(argv + ["--device", "cpu"])


def test_device_cuda_without_cuda_exits_1(tmp_path, monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    out = tmp_path / "o.nnet"
    base = ["ark:f.ark", "ark:a.ark", "final.mdl", "m.nnet", str(out)]
    assert t_smbr.main(base) == 1
    assert t_mmi.main(base) == 1
    seq = ["ark:f.ark", "ark:l.ark", "ark:a.ark", "final.mdl", "m.nnet",
           str(out)]
    assert t_mmi_seq.main(seq) == 1
    assert t_mpe_seq.main(seq) == 1
    assert not out.exists()


# ---------------------------------------------------------------------------
# lattice-based tools: denominator lattices decoded once, by the JAX
# package, and read by both
# ---------------------------------------------------------------------------

@pytest.fixture(scope="module")
def lattice_corpus(tmp_path_factory):
    d = str(tmp_path_factory.mktemp("latcorpus"))
    assert j_word.main(["--dir", d, "--num-words", "5", "--num-phones", "6",
                        "--states-per-phone", "2", "--num-utts", "6",
                        "--feat-dim", str(D), "--max-words", "3",
                        "--emission-noise", "0.5"]) == 0
    model = init_model(d, num_pdfs(f"{d}/final.mdl"), seed=6)
    assert j_forward.main([model, f"scp:{d}/feats.scp",
                           f"ark:{d}/loglik.ark", "--apply-log=true"]) == 0
    assert j_latgen.main([f"{d}/final.mdl", f"{d}/lexicon.txt",
                          f"{d}/lm.arpa", f"ark:{d}/loglik.ark",
                          f"ark:{d}/lat.ark", "--acoustic-scale", "1.0",
                          "--beam", "13", "--lattice-beam", "5"]) == 0
    return d, model


SEQUENTIAL = {"mmi": (j_mmi_seq.main, t_mmi_seq.main),
              "mpe": (j_mpe_seq.main, t_mpe_seq.main)}


@pytest.mark.parametrize("tool,extra", [
    ("mmi", []),
    ("mmi", ["--drop-frames=false", "--momentum=0.5",
             "--length-bucket=16"]),
    ("mpe", ["--do-smbr=true"]),
    ("mpe", ["--silence-phones=1:2", "--one-silence-class=true"]),
])
def test_sequential_iteration_matches_jax(tmp_path, capfd, lattice_corpus,
                                          tool, extra):
    src, model = lattice_corpus
    d = str(tmp_path)
    base = [f"scp:{src}/feats.scp", f"ark:{src}/lat.ark",
            f"ark:{src}/ali.ark", f"{src}/final.mdl"]
    flags = ["--learn-rate=0.01", "--acoustic-scale=1.0"] + extra
    j_main, t_main = SEQUENTIAL[tool]
    lt.reset_counts()
    li.reset_counts()
    j_err, t_err = run_both(capfd, j_main, t_main,
                            base + [model, f"{d}/j.nnet"] + flags,
                            base + [model, f"{d}/t.nnet"] + flags)
    # per utterance one loglik forward (K5's path) and one update
    assert li.PLAIN_CALLS == 6 and lt.PLAIN_CALLS == 2 * 6
    assert_models_close(f"{d}/t.nnet", f"{d}/j.nnet")
    assert done_line(t_err) == done_line(j_err) == (
        "Done 6 files, 0 with no alignment, 0 with no lattice, 0 with "
        "other errors.")
    overall = re.compile(r"Overall .*")
    assert overall.search(t_err).group(0) == overall.search(j_err).group(0)

    cv = ["--cross-validate=true", "--acoustic-scale=1.0"] + extra
    lt.reset_counts()
    j_err, t_err = run_both(capfd, j_main, t_main,
                            base + [f"{d}/j.nnet"] + cv,
                            base + [f"{d}/t.nnet"] + cv)
    assert lt.PLAIN_CALLS == 0 and "[CROSS-VALIDATION" in t_err
    np.testing.assert_allclose(float(objective(t_err)),
                               float(objective(j_err)), rtol=1e-5)


@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card (the kernels have no CPU mode); "
                    "run on the card with: python -m pytest -m gpu "
                    "tests/test_torch_seqtrain_cli.py")
    return torch.device("cuda")


@pytest.mark.gpu
@pytest.mark.parametrize("tool", ["smbr", "mmi"])
def test_card_iteration_matches_cpu(tmp_path, capfd, cuda_device, tool):
    """The lattice-free trainers on the card (K1/K2, one call each per
    utterance, no plain call) against --device cpu: params within 1e-4
    relative (atol 1e-6), the objective within 1e-4 relative."""
    d = str(tmp_path)
    feats, ali, mdl = hmm_corpus(d)
    model = init_model(d, num_pdfs(mdl))
    argv = [feats, ali, mdl, model]
    flags = ["--learn-rate=0.02", "--acoustic-scale=0.5"]
    t_main = LATTICE_FREE[tool][1]
    assert t_main(argv + [f"{d}/c.nnet", "--device", "cpu"] + flags) == 0
    cpu_err = capfd.readouterr().err
    lt.reset_counts()
    assert t_main(argv + [f"{d}/g.nnet", "--device", "cuda"] + flags) == 0
    gpu_err = capfd.readouterr().err
    assert (lt.FWD_LAUNCHES > 0, lt.BWD_LAUNCHES > 0, lt.PLAIN_CALLS) == \
        (True, True, 0)
    for a, b in zip(tree_leaves(Nnet.read(f"{d}/g.nnet", "cpu")[1]),
                    tree_leaves(Nnet.read(f"{d}/c.nnet", "cpu")[1])):
        torch.testing.assert_close(a, b, rtol=1e-4, atol=1e-6)
    np.testing.assert_allclose(float(objective(gpu_err)),
                               float(objective(cpu_err)), rtol=1e-4)
