"""The port's per-utterance trainer (`tools/nnet_train_perutt.py`) and
`cmvn_to_nnet` against the JAX package's tools on the CPU.

Held, on one tiny seeded corpus and one model file both packages read:
* one training iteration of both CLIs, for the standard net (TimeShift
  -> LstmProjected -> Affine -> Softmax) and for a BLSTM net: the
  written params within 1e-5 and the logged statistics (AvgLoss,
  AvgXent, AvgTargetEnt, FRAME_ACCURACY) within 1e-5 relative;
* `--cross-validate`, and the counters of utterances without targets
  and with a length mismatch (the "Done ..." line);
* `--feature-transform` from `cmvn_to_nnet`, whose model file is the JAX
  tool's byte for byte (binary and text, a stats table and a global
  matrix);
* a BLSTM utterance whose bucket padding changes its backward half (the
  padding repeats the last frame and the backward direction reads it
  first), equal to the JAX package's at each bucket;
* the tool's flag errors and its exit without CUDA.

Tolerance: rtol = atol = 1e-5 on params, rtol 1e-5 on statistics. Both
sides are float32; gradients are frame sums in other orders (~1e-7
relative), and one epoch of a handful of updates at these rates keeps
that under 1e-6.
"""

import re

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from kaldi_lstm_tpu.models import Nnet as JNnet
from kaldi_lstm_tpu.tools import cmvn_to_nnet as j_cmvn
from kaldi_lstm_tpu.tools import nnet_train_perutt as j_perutt
from kaldi_lstm_tpu_torch.io import kaldi_io as kio
from kaldi_lstm_tpu_torch.models import Nnet
from kaldi_lstm_tpu_torch.ops import lstm_infer as li
from kaldi_lstm_tpu_torch.ops import lstm_train as lt
from kaldi_lstm_tpu_torch.tools import cmvn_to_nnet as t_cmvn
from kaldi_lstm_tpu_torch.tools import nnet_train_perutt as t_perutt
from kaldi_lstm_tpu_torch.utils.tree import tree_leaves

TOL = dict(rtol=1e-5, atol=1e-5)
D, K = 8, 12
STANDARD = f"""<NnetProto>
<TimeShift> <InputDim> {D} <OutputDim> {D} <Shift> 2
<LstmProjected> <InputDim> {D} <OutputDim> 10 <CellDim> 14 <ParamScale> 0.1
<AffineTransform> <InputDim> 10 <OutputDim> {K} <ParamStddev> 0.2
<Softmax> <InputDim> {K} <OutputDim> {K}
</NnetProto>"""
BLSTM = f"""<NnetProto>
<BLstmProjectedStreams> <InputDim> {D} <OutputDim> 12 <CellDim> 10 <ParamScale> 0.1 <NumStream> 1
<AffineTransform> <InputDim> 12 <OutputDim> {K} <ParamStddev> 0.2
<Softmax> <InputDim> {K} <OutputDim> {K}
</NnetProto>"""
NETS = {"standard": STANDARD, "blstm": BLSTM}
_NUM = re.compile(r"-?\d+(?:\.\d+)?(?:e[-+]\d+)?")


def write_corpus(d, n=10, seed=0, bad=False):
    """n utterances of 9-45 frames with 1-best targets that depend on the
    frame; with `bad`, one more utterance without targets and one whose
    targets are a frame short."""
    rng = np.random.RandomState(seed)
    with kio.MatrixWriter(f"ark:{d}/feats.ark") as fw, \
            kio.PosteriorWriter(f"ark:{d}/post.ark") as pw:
        for i in range(n):
            x = (rng.randn(int(rng.randint(9, 46)), D) * 2 + 1) \
                .astype(np.float32)
            lab = (np.abs(x[:, :3]).sum(1) * 3).astype(int) % K
            fw.write(f"utt{i:02d}", x)
            pw.write(f"utt{i:02d}", [[(int(v), 1.0)] for v in lab])
        if bad:
            fw.write("zz_notgt", rng.randn(12, D).astype(np.float32))
            fw.write("zz_short", rng.randn(12, D).astype(np.float32))
            pw.write("zz_short", [[(1, 1.0)]] * 11)
    return f"ark:{d}/feats.ark", f"ark:{d}/post.ark"


def init_model(d, net, seed=3):
    nnet, params = Nnet.init_from_proto(
        NETS[net], torch.Generator().manual_seed(seed), "cpu")
    path = f"{d}/{net}.init"
    nnet.write(path, params)
    return path


def stat_lines(err: str) -> tuple[str, str]:
    """(the 'Done ...' line up to its timing, the AvgLoss report) of a
    trainer's stderr."""
    done = re.search(r"Done .*?\[(CROSS-VALIDATION|TRAINING)", err).group(0)
    report = err[err.index("AvgLoss:"):]
    report = report[:report.index("<<") + 2]
    return done, report


def assert_report_close(a: str, b: str) -> None:
    assert _NUM.sub("#", a) == _NUM.sub("#", b), (a, b)
    np.testing.assert_allclose([float(v) for v in _NUM.findall(a)],
                               [float(v) for v in _NUM.findall(b)],
                               rtol=1e-5, atol=1e-6)


def run_both(capfd, argv_j, argv_t):
    """The JAX CLI, then the port's with --device cpu; their stderr."""
    assert j_perutt.main(argv_j) == 0
    j_err = capfd.readouterr().err
    rc, stats = t_perutt.run_main(argv_t + ["--device", "cpu"])
    assert rc == 0
    t_err = capfd.readouterr().err
    return j_err, t_err, stats


def assert_models_close(t_path, j_path):
    t_leaves = tree_leaves(Nnet.read(t_path, "cpu")[1])
    j_leaves = jax.tree_util.tree_leaves(JNnet.read(j_path)[1])
    assert len(t_leaves) == len(j_leaves) > 0
    for a, b in zip(t_leaves, j_leaves):
        np.testing.assert_allclose(a.numpy(), np.asarray(b), **TOL)


@pytest.mark.parametrize("net", ["standard", "blstm"])
def test_one_iteration_matches_jax_cli(tmp_path, capfd, net):
    d = str(tmp_path)
    feats, post = write_corpus(d, bad=True)
    model = init_model(d, net)
    flags = ["--learn-rate=0.01", "--momentum=0.5", "--length-bucket=16",
             "--grad-clip=0.5", "--l2-penalty=1e-4"]
    lt.reset_counts()
    j_err, t_err, stats = run_both(
        capfd, [feats, post, model, f"{d}/j.nnet"] + flags,
        [feats, post, model, f"{d}/t.nnet"] + flags)
    # one training call per LSTM direction and utterance (10 utterances)
    ncalls = 10 * (2 if net == "blstm" else 1)
    assert lt.PLAIN_CALLS == 2 * ncalls and lt.FWD_LAUNCHES == 0
    assert_models_close(f"{d}/t.nnet", f"{d}/j.nnet")
    (j_done, j_rep), (t_done, t_rep) = stat_lines(j_err), stat_lines(t_err)
    assert t_done == j_done == ("Done 10 files, 1 with no tgt_mats, 1 with "
                                "other errors. [TRAINING")
    assert_report_close(t_rep, j_rep)
    assert t_rep == stats.report()

    # cross-validation of the trained model: forward only
    cv = ["--cross-validate=true", "--length-bucket=16"]
    li.reset_counts()
    lt.reset_counts()
    j_err, t_err, cv_stats = run_both(capfd, [feats, post, f"{d}/j.nnet"]
                                      + cv, [feats, post, f"{d}/t.nnet"]
                                      + cv)
    assert lt.PLAIN_CALLS == 0 and li.PLAIN_CALLS == ncalls
    (j_done, j_rep), (t_done, t_rep) = stat_lines(j_err), stat_lines(t_err)
    assert t_done == j_done and t_done.endswith("[CROSS-VALIDATION")
    assert_report_close(t_rep, j_rep)
    assert cv_stats.avg_loss() < stats.avg_loss()


def write_cmvn_stats(d, feats):
    """Per-utterance [2, D+1] float64-style CMVN stats (sum, sum of
    squares, count) as a table, and their sum as a global matrix."""
    tot = None
    with kio.MatrixWriter(f"ark:{d}/cmvn.ark") as w:
        for k, m in kio.SequentialMatrixReader(feats):
            s = np.zeros((2, D + 1))
            s[0, :D], s[1, :D] = m.sum(0), (m.astype(np.float64) ** 2).sum(0)
            s[0, D] = m.shape[0]
            w.write(k, s.astype(np.float32))
            tot = s if tot is None else tot + s
    with kio.MatrixWriter(f"ark:{d}/global.ark") as w:
        w.write("global", tot.astype(np.float32))
    return f"ark:{d}/cmvn.ark", f"{d}/global.ark:7"


@pytest.mark.parametrize("binary", ["true", "false"])
def test_cmvn_to_nnet_bytes_equal_jax(tmp_path, binary):
    d = str(tmp_path)
    feats, _ = write_corpus(d)
    table, global_rx = write_cmvn_stats(d, feats)
    for i, (src, extra) in enumerate(((table, []),
                                      (global_rx, ["--std-dev", "0.5"]))):
        args = ["--binary", binary] + extra
        assert j_cmvn.main([src, f"{d}/j{i}.nnet"] + args) == 0
        assert t_cmvn.main([src, f"{d}/t{i}.nnet"] + args) == 0
        with open(f"{d}/j{i}.nnet", "rb") as a, \
                open(f"{d}/t{i}.nnet", "rb") as b:
            assert a.read() == b.read()
    nnet, params = Nnet.read(f"{d}/t0.nnet", "cpu")
    x = np.concatenate([m for _, m in kio.SequentialMatrixReader(feats)])
    y = nnet.feedforward(params, torch.from_numpy(x)[None])[0].numpy()
    np.testing.assert_allclose(y.mean(0), 0.0, atol=1e-4)
    np.testing.assert_allclose(y.std(0), 1.0, atol=1e-3)


def test_cmvn_to_nnet_refuses_bad_stats(tmp_path, capsys):
    d = str(tmp_path)
    with kio.MatrixWriter(f"ark:{d}/bad.ark") as w:
        w.write("a", np.zeros((3, D + 1), np.float32))
    with kio.MatrixWriter(f"ark:{d}/zero.ark") as w:
        w.write("a", np.zeros((2, D + 1), np.float32))
    for src in (f"ark:{d}/bad.ark", f"ark:{d}/zero.ark"):
        assert t_cmvn.main([src, f"{d}/o.nnet"]) == 1
        assert j_cmvn.main([src, f"{d}/o.nnet"]) == 1


@pytest.mark.parametrize("net", ["standard", "blstm"])
def test_feature_transform_from_cmvn_to_nnet(tmp_path, capfd, net):
    d = str(tmp_path)
    feats, post = write_corpus(d, seed=1)
    table, _ = write_cmvn_stats(d, feats)
    assert t_cmvn.main([table, f"{d}/cmvn.nnet"]) == 0
    model = init_model(d, net, seed=4)
    flags = ["--learn-rate=0.02", "--momentum=0.9", "--length-bucket=32",
             f"--feature-transform={d}/cmvn.nnet"]
    j_err, t_err, _ = run_both(capfd, [feats, post, model, f"{d}/j.nnet"]
                               + flags, [feats, post, model, f"{d}/t.nnet"]
                               + flags)
    assert_models_close(f"{d}/t.nnet", f"{d}/j.nnet")
    assert_report_close(stat_lines(t_err)[1], stat_lines(j_err)[1])


def test_blstm_bucket_padding_changes_the_backward_half_like_jax(
        tmp_path, capfd):
    """The padding repeats the last frame, and the BLSTM's backward
    direction reads the padding first: its outputs on the real frames
    depend on the bucket, in both packages alike (the JAX package's
    behaviour, kept on purpose)."""
    d = str(tmp_path)
    model = init_model(d, "blstm", seed=5)
    jn, jp = JNnet.read(model)
    nnet, params = Nnet.read(model, "cpu")
    rng = np.random.RandomState(2)
    x = rng.randn(20, D).astype(np.float32) * 2
    ids = np.zeros((20, 1), np.int32)
    w = np.ones((20, 1), np.float32)
    outs = {}
    for bucket in (1, 32, 64):
        f, _, _, _ = t_perutt.pad_utterance(x, ids, w, bucket)
        assert f.shape[1] == -(-20 // bucket) * bucket
        assert (f[0, 20:] == x[-1]).all()
        t_y, _ = nnet.components[0].apply(params[0], torch.from_numpy(f))
        j_y, _ = jn.components[0].apply(jp[0], jnp.asarray(f))
        np.testing.assert_allclose(t_y.numpy(), np.asarray(j_y), **TOL)
        outs[bucket] = t_y[0, :20].numpy()
    R = 6
    for b in (32, 64):
        # the forward half never sees the padding; the backward half does
        np.testing.assert_allclose(outs[b][:, :R], outs[1][:, :R], **TOL)
        assert np.abs(outs[b][:, R:] - outs[1][:, R:]).max() > 1e-3
    # the CV loss moves with the bucket, the same way in both packages
    feats, post = write_corpus(d, n=4, seed=3)
    losses = []
    for bucket in ("1", "64"):
        cv = [feats, post, model, "--cross-validate=true",
              f"--length-bucket={bucket}"]
        j_err, t_err, stats = run_both(capfd, cv, cv)
        assert_report_close(stat_lines(t_err)[1], stat_lines(j_err)[1])
        losses.append(stats.avg_loss())
    assert losses[0] != losses[1]


def test_flag_errors_and_no_cuda(tmp_path, capsys, monkeypatch):
    d = str(tmp_path)
    feats, post = write_corpus(d, n=2)
    model = init_model(d, "standard")
    # training needs a <model-out>
    assert t_perutt.main([feats, post, model, "--device", "cpu"]) == 1
    assert "model-out" in capsys.readouterr().err
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    assert t_perutt.main([feats, post, model, f"{d}/o.nnet"]) == 1
    assert "CUDA is not available" in capsys.readouterr().err


@pytest.mark.gpu
def test_cuda_perutt_matches_cpu(tmp_path):
    """One perutt iteration of the BLSTM net on the card (K1/K2 per
    direction, K3/K4 for the fused loss) against the CPU path."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card (K1-K4 have no CPU mode); run on "
                    "the card with: python -m pytest -m gpu "
                    "tests/test_torch_perutt.py")
    from kaldi_lstm_tpu_torch.ops import xent_affine as xa
    torch.backends.cuda.matmul.allow_tf32 = False
    d = str(tmp_path)
    feats, post = write_corpus(d, n=4)
    model = init_model(d, "blstm")
    flags = ["--learn-rate=0.01", "--length-bucket=16"]
    outs = {}
    for dev in ("cpu", "cuda"):
        lt.reset_counts()
        xa.reset_counts()
        rc, stats = t_perutt.run_main([feats, post, model, f"{d}/{dev}.nnet",
                                       "--device", dev] + flags)
        assert rc == 0
        outs[dev] = stats
        if dev == "cuda":
            assert lt.PLAIN_CALLS == 0 and xa.PLAIN_CALLS == 0
            assert (xa.FWD_LAUNCHES, xa.BWD_LAUNCHES) == (2 * 4, 3 * 4)
    for a, b in zip(tree_leaves(Nnet.read(f"{d}/cuda.nnet", "cpu")[1]),
                    tree_leaves(Nnet.read(f"{d}/cpu.nnet", "cpu")[1])):
        np.testing.assert_allclose(a.numpy(), b.numpy(), rtol=1e-4,
                                   atol=1e-5)
    assert abs(outs["cuda"].avg_loss() - outs["cpu"].avg_loss()) <= \
        1e-5 * abs(outs["cpu"].avg_loss())


def test_timer_and_profiler():
    """utils/timer.py: the trainers' wall clock and the per-section
    accumulator (the JAX package's report format)."""
    import time
    from kaldi_lstm_tpu_torch.utils import Timer
    from kaldi_lstm_tpu_torch.utils.timer import AccuProfiler
    t = Timer()
    time.sleep(0.01)
    assert t.elapsed() >= 0.01
    t.reset()
    assert t.elapsed() < 0.01
    prof = AccuProfiler()
    for _ in range(2):
        with prof.section("step"):
            time.sleep(0.002)
    with prof.section("io"):
        pass
    lines = prof.report().splitlines()
    assert lines[0] == "-----[ profile ]-----"
    assert lines[1].startswith("step\t") and lines[1].endswith("(2 calls)")
    assert lines[2].startswith("io\t") and lines[2].endswith("(1 calls)")
