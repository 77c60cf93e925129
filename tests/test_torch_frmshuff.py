"""The port's frame randomizer (`train/randomizer.py`) and frame-shuffled
trainer (`tools/nnet_train_frmshuff.py`) against the JAX package's on
the CPU, and the two randomizer tests of tests/test_frmshuff.py on the
port.

Held, on tiny seeded corpora and one model file both packages read:
* `FrameRandomizer`'s minibatches byte-equal to the JAX package's,
  randomized and not, over windows that split utterances, with soft
  targets wider than kmax and frame weights;
* one iteration of both CLIs for xent, mse and `--frame-weights`, with a
  Splice feature transform applied per utterance: the written params
  within 1e-5 and the logged statistics within 1e-5 relative, the
  "Done ..." line equal;
* the dropout DNN of tests/test_dropout_component.py:91 trains through
  the port's CLI (its masks come from torch generators, so it is held to
  its own CV loss, not to the JAX run).

Tolerance: rtol = atol = 1e-5 on params, rtol 1e-5 on statistics (both
sides float32; gradients are sums over a 32-frame minibatch in other
orders).
"""

import re

import jax
import numpy as np
import pytest
import torch

from kaldi_lstm_tpu.models import Nnet as JNnet
from kaldi_lstm_tpu.tools import nnet_train_frmshuff as j_frm
from kaldi_lstm_tpu.train.randomizer import FrameRandomizer as JRandomizer
from kaldi_lstm_tpu_torch.io import kaldi_io as kio
from kaldi_lstm_tpu_torch.models import Nnet
from kaldi_lstm_tpu_torch.tools import nnet_train_frmshuff as t_frm
from kaldi_lstm_tpu_torch.train.randomizer import FrameRandomizer
from kaldi_lstm_tpu_torch.utils.tree import tree_leaves

TOL = dict(rtol=1e-5, atol=1e-5)
D, K = 6, 8
_NUM = re.compile(r"-?\d+(?:\.\d+)?(?:e[-+]\d+)?")


def _post(labels):
    return [[(int(lab), 1.0)] for lab in labels]


# -- tests/test_frmshuff.py's randomizer tests on the port --------------------

def test_randomizer_window_and_padding():
    rng = np.random.RandomState(0)
    feats = rng.randn(10, 3).astype(np.float32)
    labels = np.arange(10)
    r = FrameRandomizer(dim=3, size=8, minibatch=4, kmax=1, seed=1)
    taken = r.add(feats, _post(labels))
    assert taken == 8 and r.full
    batches = list(r.drain())
    assert len(batches) == 2 and r.filled == 0
    taken2 = r.add(feats[taken:], _post(labels[taken:]))
    assert taken2 == 2
    batches += list(r.drain())
    f, i, w, fw = batches[-1]
    assert f.shape == (4, 1, 3) and fw[2:].sum() == 0.0
    ids = [int(i_[k, 0, 0]) for f_, i_, w_, fw_ in batches
           for k in range(4) if fw_[k, 0] > 0]
    assert sorted(ids) == list(range(10))


def test_randomizer_seed_determinism_and_order():
    feats = np.arange(24, dtype=np.float32).reshape(8, 3)
    labels = np.arange(8)

    def order(seed, randomize=True):
        r = FrameRandomizer(3, size=8, minibatch=8, kmax=1, seed=seed,
                            randomize=randomize)
        r.add(feats, _post(labels))
        (f, i, w, fw), = list(r.drain())
        return [int(v) for v in i[:, 0, 0]]

    assert order(5) == order(5)
    assert order(5) != order(6)
    assert order(9, randomize=False) == list(range(8))


@pytest.mark.parametrize("randomize", [True, False])
def test_randomizer_batches_byte_equal_jax(randomize):
    """Both randomizers fed the same utterances in the same add/drain
    rhythm as the CLI: every minibatch's four arrays byte for byte."""
    rng = np.random.RandomState(3)
    kw = dict(size=50, minibatch=16, kmax=2, seed=11, randomize=randomize)
    rands = (FrameRandomizer(4, **kw), JRandomizer(4, **kw))
    out = ([], [])
    for u in range(9):
        L = int(rng.randint(5, 31))
        x = rng.randn(L, 4).astype(np.float32)
        # up to 3 soft entries a frame: the randomizers keep kmax = 2
        post = [[(int(rng.randint(20)), float(rng.rand()))
                 for _ in range(int(rng.randint(1, 4)))] for _ in range(L)]
        fw = rng.rand(L).astype(np.float32) if u % 2 else None
        for r, o in zip(rands, out):
            off = 0
            while off < L:
                off += r.add(x[off:], post[off:],
                             None if fw is None else fw[off:])
                if r.full:
                    o.extend(r.drain())
    for r, o in zip(rands, out):
        o.extend(r.drain())
    assert len(out[0]) == len(out[1]) > 5
    for bt, bj in zip(*out):
        for a, b in zip(bt, bj):
            assert a.dtype == b.dtype and a.tobytes() == b.tobytes()


# -- the CLI against the JAX CLI -----------------------------------------------

def write_corpus(d, n=8, seed=0):
    """n utterances of 10-40 frames; labels from the current and the
    previous frame, so the Splice transform helps."""
    rng = np.random.RandomState(seed)
    with kio.MatrixWriter(f"ark:{d}/feats.ark") as fw, \
            kio.PosteriorWriter(f"ark:{d}/post.ark") as pw, \
            kio.TableWriter(f"ark:{d}/fw.ark", kio.write_vector) as ww:
        for i in range(n):
            L = int(rng.randint(10, 41))
            x = rng.randn(L, D).astype(np.float32)
            lab = ((x[:, 0] > 0) * 4 + (np.roll(x[:, 1], 1) > 0) * 2
                   + (x[:, 2] > 0)).astype(int) % K
            fw.write(f"utt{i}", x)
            pw.write(f"utt{i}", _post(lab))
            ww.write(f"utt{i}", (rng.rand(L) > 0.3).astype(np.float32)
                     * rng.rand(L).astype(np.float32))
    return f"ark:{d}/feats.ark", f"ark:{d}/post.ark", f"ark:{d}/fw.ark"


def write_models(d, seed=0):
    transf = f"""<NnetProto>
<Splice> <InputDim> {D} <OutputDim> {2 * D} <BuildVector> -1:0
</NnetProto>"""
    tn, tp = Nnet.init_from_proto(transf, torch.Generator(), "cpu")
    tn.write(f"{d}/transf.nnet", tp)
    proto = f"""<NnetProto>
<AffineTransform> <InputDim> {2 * D} <OutputDim> 16 <ParamStddev> 0.3
<Sigmoid> <InputDim> 16 <OutputDim> 16
<AffineTransform> <InputDim> 16 <OutputDim> {K} <ParamStddev> 0.3
<Softmax> <InputDim> {K} <OutputDim> {K}
</NnetProto>"""
    nnet, params = Nnet.init_from_proto(
        proto, torch.Generator().manual_seed(seed), "cpu")
    nnet.write(f"{d}/dnn.init", params)
    return f"{d}/transf.nnet", f"{d}/dnn.init"


def stat_lines(err: str) -> tuple[str, str]:
    done = re.search(r"Done .*?RANDOMIZED", err).group(0)
    return done, err[err.index("AvgLoss:"):].strip()


def assert_report_close(a: str, b: str) -> None:
    assert _NUM.sub("#", a) == _NUM.sub("#", b), (a, b)
    np.testing.assert_allclose([float(v) for v in _NUM.findall(a)],
                               [float(v) for v in _NUM.findall(b)],
                               rtol=1e-5, atol=1e-6)


@pytest.mark.parametrize("case", ["xent", "mse", "frame_weights",
                                  "not_randomized"])
def test_cli_matches_jax_cli(tmp_path, capfd, case):
    d = str(tmp_path)
    feats, post, fws = write_corpus(d)
    transf, model = write_models(d)
    flags = ["--learn-rate=0.05", "--momentum=0.5", "--minibatch-size=32",
             "--randomizer-size=100", f"--feature-transform={transf}",
             "--max-post-entries=2"]
    if case == "mse":
        flags += ["--objective-function=mse", "--learn-rate=0.01"]
    if case == "frame_weights":
        flags += [f"--frame-weights={fws}", "--l1-penalty=1e-4"]
    if case == "not_randomized":
        flags += ["--randomize=false"]
    assert j_frm.main([feats, post, model, f"{d}/j.nnet"] + flags) == 0
    j_err = capfd.readouterr().err
    rc, stats = t_frm.run_main([feats, post, model, f"{d}/t.nnet"] + flags
                               + ["--device", "cpu"])
    assert rc == 0
    t_err = capfd.readouterr().err
    (j_done, j_rep), (t_done, t_rep) = stat_lines(j_err), stat_lines(t_err)
    assert t_done == j_done
    assert_report_close(t_rep, j_rep)
    t_leaves = tree_leaves(Nnet.read(f"{d}/t.nnet", "cpu")[1])
    j_leaves = jax.tree_util.tree_leaves(JNnet.read(f"{d}/j.nnet")[1])
    assert len(t_leaves) == len(j_leaves) == 4
    for a, b in zip(t_leaves, j_leaves):
        np.testing.assert_allclose(a.numpy(), np.asarray(b), **TOL)
    # the cross-validation pass (never randomized) of the trained model
    cv = [feats, post, f"{d}/j.nnet", "--cross-validate=true",
          f"--feature-transform={transf}", "--minibatch-size=32"]
    if case == "mse":
        cv += ["--objective-function=mse"]
    assert j_frm.main(cv) == 0
    j_err = capfd.readouterr().err
    rc, cv_stats = t_frm.run_main(cv + ["--device", "cpu"])
    t_err = capfd.readouterr().err
    assert rc == 0 and stat_lines(t_err)[0] == stat_lines(j_err)[0]
    assert_report_close(stat_lines(t_err)[1], stat_lines(j_err)[1])
    if case != "frame_weights":
        assert cv_stats.avg_loss() < stats.avg_loss()


def test_skips_match_jax_cli(tmp_path, capfd):
    """Utterances without targets, with a length mismatch, without frame
    weights: the same counters in both tools."""
    d = str(tmp_path)
    feats, post, _ = write_corpus(d, n=4)
    rng = np.random.RandomState(1)
    with kio.MatrixWriter(f"ark:{d}/more.ark") as w:
        for k, m in kio.SequentialMatrixReader(feats):
            w.write(k, m)
        w.write("zz_notgt", rng.randn(7, D).astype(np.float32))
    with kio.TableWriter(f"ark:{d}/fw3.ark", kio.write_vector) as w:
        for k, m in list(kio.SequentialMatrixReader(feats))[:3]:
            w.write(k, np.ones(m.shape[0] - (k == "utt0"), np.float32))
    transf, model = write_models(d)
    argv = [f"ark:{d}/more.ark", post, model, "--cross-validate=true",
            f"--frame-weights=ark:{d}/fw3.ark", "--minibatch-size=16",
            f"--feature-transform={transf}"]
    assert j_frm.main(argv) == 0
    j_done = stat_lines(capfd.readouterr().err)[0]
    assert t_frm.main(argv + ["--device", "cpu"]) == 0
    t_done = stat_lines(capfd.readouterr().err)[0]
    assert t_done == j_done and "1 with no tgt_mats, 2 with other" in t_done


def test_lstm_net_warns(tmp_path, capfd):
    d = str(tmp_path)
    feats, post, _ = write_corpus(d, n=2)
    nnet, params = Nnet.init_from_proto(f"""<NnetProto>
<LstmProjected> <InputDim> {D} <OutputDim> 4 <CellDim> 5
<AffineTransform> <InputDim> 4 <OutputDim> {K}
<Softmax> <InputDim> {K} <OutputDim> {K}
</NnetProto>""", torch.Generator(), "cpu")
    nnet.write(f"{d}/lstm.nnet", params)
    assert t_frm.main([feats, post, f"{d}/lstm.nnet", "--device", "cpu",
                       "--cross-validate=true"]) == 0
    assert "frame shuffling destroys sequence structure" in \
        capfd.readouterr().err


DROPOUT_PROTO = """<NnetProto>
<AffineTransform> <InputDim> 6 <OutputDim> 32
<Sigmoid> <InputDim> 32 <OutputDim> 32
<Dropout> <InputDim> 32 <OutputDim> 32 <DropoutRate> 0.2
<AffineTransform> <InputDim> 32 <OutputDim> 5
<Softmax> <InputDim> 5 <OutputDim> 5
</NnetProto>
"""


def test_frmshuff_trains_dropout_net(tmp_path):
    """tests/test_dropout_component.py's dropout DNN through the port's
    CLI: the CV loss of the trained model beats the initial model's, and
    the minibatch generators make the run repeatable."""
    from kaldi_lstm_tpu_torch.tools.nnet_initialize import main as init_main
    rng = np.random.RandomState(0)
    W = rng.randn(6, 5)
    with kio.MatrixWriter(f"ark,scp:{tmp_path}/f.ark,{tmp_path}/f.scp") \
            as fw, kio.PosteriorWriter(f"ark:{tmp_path}/p.ark") as pw:
        for u in range(10):
            x = rng.randn(50, 6).astype(np.float32)
            fw.write(f"u{u}", x)
            pw.write(f"u{u}", _post((x @ W).argmax(-1)))
    (tmp_path / "nnet.proto").write_text(DROPOUT_PROTO)
    assert init_main([str(tmp_path / "nnet.proto"),
                      str(tmp_path / "nnet.init"), "--device", "cpu"]) == 0
    data = [f"scp:{tmp_path}/f.scp", f"ark:{tmp_path}/p.ark"]
    for out in ("it1", "it1b"):
        assert t_frm.main(data + [str(tmp_path / "nnet.init"),
                                  str(tmp_path / f"nnet.{out}"),
                                  "--learn-rate", "0.02",
                                  "--minibatch-size", "64",
                                  "--randomizer-size", "512",
                                  "--device", "cpu"]) == 0
    assert (tmp_path / "nnet.it1").read_bytes() == \
        (tmp_path / "nnet.it1b").read_bytes()

    def cv(model):
        rc, stats = t_frm.run_main(data + [str(model),
                                           "--cross-validate=true",
                                           "--device", "cpu"])
        assert rc == 0
        return stats.avg_loss()

    assert cv(tmp_path / "nnet.it1") < cv(tmp_path / "nnet.init")


@pytest.mark.gpu
def test_cuda_frmshuff_matches_cpu(tmp_path):
    """One frmshuff iteration on the card (the fused loss, K3/K4 once a
    minibatch) against the CPU path."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card (K3/K4 have no CPU mode); run on "
                    "the card with: python -m pytest -m gpu "
                    "tests/test_torch_frmshuff.py")
    from kaldi_lstm_tpu_torch.ops import xent_affine as xa
    torch.backends.cuda.matmul.allow_tf32 = False
    d = str(tmp_path)
    feats, post, _ = write_corpus(d)
    transf, model = write_models(d)
    flags = ["--learn-rate=0.05", "--minibatch-size=32",
             "--randomizer-size=100", f"--feature-transform={transf}"]
    outs = {}
    for dev in ("cpu", "cuda"):
        xa.reset_counts()
        rc, outs[dev] = t_frm.run_main([feats, post, model, f"{d}/{dev}.nnet",
                                        "--device", dev] + flags)
        assert rc == 0
        if dev == "cuda":
            # windows of 100 frames, minibatches of 32
            total = sum(m.shape[0] for _, m in
                        kio.SequentialMatrixReader(feats))
            n = sum(-(-min(100, total - lo) // 32)
                    for lo in range(0, total, 100))
            assert (xa.FWD_LAUNCHES, xa.BWD_LAUNCHES, xa.PLAIN_CALLS) == (
                2 * n, 3 * n, 0)
    for a, b in zip(tree_leaves(Nnet.read(f"{d}/cuda.nnet", "cpu")[1]),
                    tree_leaves(Nnet.read(f"{d}/cpu.nnet", "cpu")[1])):
        np.testing.assert_allclose(a.numpy(), b.numpy(), rtol=1e-4,
                                   atol=1e-5)


def test_flag_errors_and_no_cuda(tmp_path, capsys, monkeypatch):
    d = str(tmp_path)
    feats, post, _ = write_corpus(d, n=2)
    _, model = write_models(d)
    assert t_frm.main([feats, post, model, "--device", "cpu"]) == 1
    assert "model-out" in capsys.readouterr().err
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    assert t_frm.main([feats, post, model, f"{d}/o.nnet"]) == 1
    assert "CUDA is not available" in capsys.readouterr().err
    assert not (tmp_path / "o.nnet").exists()
