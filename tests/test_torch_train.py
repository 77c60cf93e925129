"""The port's training slice against the JAX package on the CPU:

* three steps of `make_train_step` (fused and unfused senone loss) on a
  two-layer TINY_PROTO-sized net, from the same params and the same
  nonzero momentum buffer, with per-stream reset flags, momentum,
  grad-clip, l1/l2 and a fully-masked filler batch: params, momentum and
  the `LossStats` report;
* `LossStats.report()` text, character for character, from the same
  statistics;
* the `train_lstm_streams --device cpu` CLI against the JAX CLI on one
  synthetic corpus (trained model, report, cross-validation);
* the checkpoint `.npz` read by the other package, both ways;
* the stream scheduler's batches against the JAX scheduler's.

Tolerance of the step and CLI comparisons: rtol = atol = 1e-5 on params
and momentum and rtol 1e-5 on the statistics. Both sides are float32;
gradients are frame sums taken in other orders (~1e-7 relative), and
three updates at these learning rates do not amplify that beyond 1e-6.
"""

import os
import re

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from __graft_entry__ import TINY_PROTO
from kaldi_lstm_tpu.io.kaldi_io import RandomAccessPosteriorReader as JPost
from kaldi_lstm_tpu.models import Nnet as JNnet
from kaldi_lstm_tpu.train.checkpoint import load_train_state as j_load
from kaldi_lstm_tpu.train.checkpoint import save_train_state as j_save
from kaldi_lstm_tpu.train.loss import LossAux as JLossAux
from kaldi_lstm_tpu.train.loss import LossStats as JLossStats
from kaldi_lstm_tpu.train.loss import posterior_to_sparse as j_to_sparse
from kaldi_lstm_tpu.train.optim import MomentumState as JMomentumState
from kaldi_lstm_tpu.train.streams import StreamScheduler as JScheduler
from kaldi_lstm_tpu.train.trainer import TrainOptions as JTrainOptions
from kaldi_lstm_tpu.train.trainer import make_train_step as j_make_step
from kaldi_lstm_tpu.tools import train_lstm_streams as j_cli
from kaldi_lstm_tpu_torch.convert import (
    momentum_from_numpy,
    momentum_to_numpy,
    params_from_numpy,
    params_to_numpy,
)
from kaldi_lstm_tpu_torch.io import kaldi_io as kio
from kaldi_lstm_tpu_torch.models import Nnet
from kaldi_lstm_tpu_torch.ops import lstm_train as lt
from kaldi_lstm_tpu_torch.ops import xent_affine as xa
from kaldi_lstm_tpu_torch.tools import train_lstm_streams as t_cli
from kaldi_lstm_tpu_torch.train.checkpoint import (
    load_train_state,
    save_train_state,
)
from kaldi_lstm_tpu_torch.train.loss import (
    LossAux,
    LossStats,
    posterior_to_sparse,
)
from kaldi_lstm_tpu_torch.train.optim import MomentumState, init_momentum
from kaldi_lstm_tpu_torch.train.streams import StreamScheduler
from kaldi_lstm_tpu_torch.train.trainer import (
    TrainOptions,
    default_use_fused,
    make_train_step,
)
from kaldi_lstm_tpu_torch.utils.tree import tree_leaves

TOL = dict(rtol=1e-5, atol=1e-5)
_NUM = re.compile(r"-?\d+(?:\.\d+)?(?:e[-+]\d+)?")


def assert_report_close(a: str, b: str) -> None:
    """Same text with the numbers blanked out, numbers within 1e-5."""
    assert _NUM.sub("#", a) == _NUM.sub("#", b), (a, b)
    np.testing.assert_allclose([float(v) for v in _NUM.findall(a)],
                               [float(v) for v in _NUM.findall(b)],
                               rtol=1e-5, atol=1e-6)


def assert_trees_close(t_tree, j_tree) -> None:
    t_leaves = tree_leaves(t_tree)
    j_leaves = jax.tree_util.tree_leaves(j_tree)
    assert len(t_leaves) == len(j_leaves)
    for a, b in zip(t_leaves, j_leaves):
        np.testing.assert_allclose(a.detach().numpy(), np.asarray(b), **TOL)


def tiny_models(tmp_path):
    nnet, params = Nnet.init_from_proto(
        TINY_PROTO, torch.Generator().manual_seed(3), "cpu")
    path = str(tmp_path / "tiny.nnet")
    nnet.write(path, params)
    return path


def batches(S=4, T=6, D=8, K=32, Km=2, seed=0):
    rng = np.random.RandomState(seed)
    out = []
    for k in range(4):
        mask = (rng.rand(S, T) < 0.8).astype(np.float32)
        if k == 2:
            mask[:] = 0.0    # a filler batch: must change nothing
        out.append((rng.randn(S, T, D).astype(np.float32),
                    rng.randint(0, K, (S, T, Km)).astype(np.int32),
                    rng.rand(S, T, Km).astype(np.float32), mask,
                    (rng.rand(S) < 0.5).astype(np.int32)))
    return out


@pytest.mark.parametrize("case", ["xent", "xent_fused", "mse_max_norm"])
def test_train_step_matches_jax(tmp_path, case):
    path = tiny_models(tmp_path)
    j_nnet, j_params = JNnet.read(path)
    nnet, params = Nnet.read(path, "cpu")
    fused = case == "xent_fused"
    objective = "mse" if case.startswith("mse") else "xent"
    if case == "mse_max_norm":
        j_nnet.components[-2].max_norm = nnet.components[-2].max_norm = 0.3
    rng = np.random.RandomState(9)
    corr_np = jax.tree_util.tree_map(
        lambda a: (rng.randn(*a.shape) * 0.01).astype(np.float32),
        j_params)
    j_opt = JMomentumState(corr=jax.tree_util.tree_map(jnp.asarray,
                                                       corr_np))
    opt = momentum_from_numpy(nnet, corr_np, "cpu")
    assert_trees_close(opt.corr, j_opt.corr)
    kw = dict(learn_rate=0.05, momentum=0.9, grad_clip=0.5,
              l1_penalty=1e-3, l2_penalty=1e-3, fused_xent=fused,
              objective=objective)
    j_step = j_make_step(j_nnet, JTrainOptions(**kw))
    step = make_train_step(nnet, TrainOptions(**kw), device="cpu")
    assert default_use_fused(nnet, TrainOptions(**kw), "cpu") == fused
    j_states, states = j_nnet.init_states(4), nnet.init_states(4, "cpu")
    name = "Mse" if objective == "mse" else "Xent"
    j_stats, stats = JLossStats(name), LossStats(name)
    lt.reset_counts()
    xa.reset_counts()
    for k, b in enumerate(batches()):
        before = [t.clone() for t in tree_leaves((params, opt.corr))]
        j_params, j_opt, j_states, j_aux = j_step(
            j_params, j_opt, j_states, (), *(jnp.asarray(a) for a in b),
            jnp.float32(0.05))
        params, opt, states, aux = step(
            params, opt, states, (), *(torch.from_numpy(a) for a in b),
            torch.tensor(0.05))
        j_stats.add(j_aux)
        stats.add(aux)
        if k == 2:
            for a, c in zip(before, tree_leaves((params, opt.corr))):
                assert torch.equal(a, c)
    # two LSTM layers, 4 steps, forward and backward each
    assert lt.PLAIN_CALLS == 16 and lt.FWD_LAUNCHES == 0
    assert xa.PLAIN_CALLS == (8 if fused else 0)
    assert_trees_close(params, j_params)
    assert_trees_close(opt.corr, j_opt.corr)
    assert_trees_close(states, j_states)
    assert_report_close(stats.report(), j_stats.report())
    back = momentum_to_numpy(opt)
    for a, b in zip(tree_leaves(back), tree_leaves(opt.corr)):
        assert np.array_equal(a, b.numpy())


def test_loss_stats_report_is_character_identical():
    """The recipe parses AvgLoss and FRAME_ACCURACY: the same statistics
    give the same text, progress lines included."""
    rng = np.random.RandomState(1)
    logs_j, logs_t = [], []
    j_stats, stats = JLossStats(), LossStats()
    for _ in range(30):
        vals = (float(rng.rand() * 5e4), float(rng.rand() * 1e3),
                float(rng.randint(0, 2000)), float(rng.randint(2000, 9000)))
        j_stats.add(JLossAux(*vals), log_fn=logs_j.append)
        stats.add(LossAux(*vals), log_fn=logs_t.append)
    assert logs_j and logs_t == logs_j
    assert stats.report() == j_stats.report()
    assert stats.avg_loss() == j_stats.avg_loss()
    mse_j, mse_t = JLossStats("Mse"), LossStats("Mse")
    for s in (mse_j, mse_t):
        s.add(JLossAux(3.0, 0.0, -1.0, 7.0))
    assert mse_t.report() == mse_j.report()


def write_corpus(d, n=12, D=8, K=32, seed=0):
    rng = np.random.RandomState(seed)
    with kio.MatrixWriter(f"ark:{d}/feats.ark") as fw, \
            kio.PosteriorWriter(f"ark:{d}/post.ark") as pw:
        for i in range(n):
            L = int(rng.randint(15, 40))
            x = rng.randn(L, D).astype(np.float32)
            lab = (np.abs(x[:, :3]).sum(1) * 6).astype(int) % K
            fw.write(f"utt{i:02d}", x)
            pw.write(f"utt{i:02d}", [[(int(v), 1.0)] for v in lab])
    return f"ark:{d}/feats.ark", f"ark:{d}/post.ark"


def write_transform_and_weights(d, feats):
    """A CMVN-style feature transform (AddShift, Rescale) and per-frame
    weights for every utterance of `feats`."""
    proto = """<NnetProto>
<AddShift> <InputDim> 8 <OutputDim> 8
<Rescale> <InputDim> 8 <OutputDim> 8
</NnetProto>"""
    nnet, params = Nnet.init_from_proto(proto, torch.Generator(), "cpu")
    rng = np.random.RandomState(4)
    params[0]["shift"].copy_(torch.tensor(rng.randn(8) * 0.3))
    params[1]["scale"].copy_(torch.tensor(rng.rand(8) + 0.5))
    nnet.write(f"{d}/transf.nnet", params)
    with kio.TableWriter(f"ark:{d}/fw.ark", kio.write_vector) as w:
        for k, m in kio.SequentialMatrixReader(feats):
            w.write(k, rng.rand(m.shape[0]).astype(np.float32))
    return [f"--feature-transform={d}/transf.nnet",
            f"--frame-weights=ark:{d}/fw.ark"]


@pytest.mark.parametrize("fused,extras", [("false", False), ("true", False),
                                          ("false", True)])
def test_cli_matches_jax_cli(tmp_path, fused, extras):
    feats, post = write_corpus(tmp_path)
    model = tiny_models(tmp_path)
    flags = ["--learn-rate=0.02", "--momentum=0.5", "--num-stream=4",
             "--batch-size=5", "--targets-delay=1", f"--fused-xent={fused}"]
    if extras:
        flags += write_transform_and_weights(tmp_path, feats)
    j_out, t_out = str(tmp_path / "j.nnet"), str(tmp_path / "t.nnet")
    rc, j_stats = j_cli.run_main([feats, post, model, j_out] + flags)
    assert rc == 0
    rc, t_stats = t_cli.run_main([feats, post, model, t_out] + flags
                                 + ["--device", "cpu"])
    assert rc == 0
    assert_report_close(t_stats.report(), j_stats.report())
    assert_trees_close(Nnet.read(t_out, "cpu")[1], JNnet.read(j_out)[1])
    cv = ["--cross-validate=true"] + flags[2:]
    rc, j_cv = j_cli.run_main([feats, post, j_out] + cv)
    assert rc == 0
    rc, t_cv = t_cli.run_main([feats, post, t_out] + cv
                              + ["--device", "cpu"])
    assert rc == 0
    assert_report_close(t_cv.report(), j_cv.report())
    assert t_cv.avg_loss() < t_stats.avg_loss()


def test_checkpoint_roundtrip_across_packages(tmp_path):
    """--state-out of either package resumes in the other: leaves p{i},
    o{i} in JAX tree order (AffineTransform: bias before linearity)."""
    model = tiny_models(tmp_path)
    j_nnet, j_params = JNnet.read(model)
    nnet, params = Nnet.read(model, "cpu")
    rng = np.random.RandomState(2)
    corr_np = jax.tree_util.tree_map(
        lambda a: rng.randn(*a.shape).astype(np.float32), j_params)
    opt = momentum_from_numpy(nnet, corr_np, "cpu")
    save_train_state(str(tmp_path / "t.npz"), params, opt, {"num_done": 3})
    jp, jo, meta = j_load(str(tmp_path / "t.npz"), j_params)
    assert meta == {"num_done": 3}
    assert_trees_close(params, jp)
    assert_trees_close(opt.corr, jo.corr)
    with np.load(str(tmp_path / "t.npz")) as z:
        aff = params[3]
        assert np.array_equal(z["p14"], aff["bias"].numpy())
        assert np.array_equal(z["p15"], aff["linearity"].numpy())
    j_corr = JMomentumState(corr=jax.tree_util.tree_map(
        lambda a: jnp.asarray(a) * 2, corr_np))
    j_save(str(tmp_path / "j.npz"), j_params, j_corr, {"lr": 0.5})
    p2, o2, meta2 = load_train_state(str(tmp_path / "j.npz"), params)
    assert meta2 == {"lr": 0.5}
    assert_trees_close(p2, j_params)
    assert_trees_close(o2.corr, j_corr.corr)
    assert isinstance(o2, MomentumState)
    assert params_to_numpy(p2)[1].w_gifo_x.shape == (64, 8)
    p3 = params_from_numpy(nnet, params_to_numpy(p2), "cpu")
    assert_trees_close(p3, j_params)


def test_cli_state_out_resumes_in_jax_cli(tmp_path):
    feats, post = write_corpus(tmp_path, n=8)
    model = tiny_models(tmp_path)
    flags = ["--learn-rate=0.02", "--num-stream=4", "--batch-size=5",
             "--targets-delay=1"]
    state = str(tmp_path / "s.npz")
    assert t_cli.main([feats, post, model, str(tmp_path / "a.nnet"),
                       "--state-out", state, "--device", "cpu"]
                      + flags) == 0
    rc, j_stats = j_cli.run_main([feats, post, model,
                                  str(tmp_path / "jb.nnet"),
                                  "--state-in", state] + flags)
    rc2, t_stats = t_cli.run_main([feats, post, model,
                                   str(tmp_path / "tb.nnet"), "--state-in",
                                   state, "--device", "cpu"] + flags)
    assert rc == rc2 == 0
    assert_report_close(t_stats.report(), j_stats.report())
    assert_trees_close(Nnet.read(str(tmp_path / "tb.nnet"), "cpu")[1],
                       JNnet.read(str(tmp_path / "jb.nnet"))[1])


@pytest.mark.parametrize("flag,why", [
    (["--mesh", "data=2"], "mesh 2x1 needs 2 devices, have 1"),
    (["--num-processes", "2"], "needs --mesh"),
    (["--coordinator-address", "localhost:1"], "needs --mesh")])
def test_cli_unported_flags_exit_1(tmp_path, monkeypatch, flag, why):
    """The mesh and multi-process flags are ported (parallel/); without
    the ranks they need they raise before reading any table (an exit 1
    from the command line), as the JAX tool does, and write nothing."""
    monkeypatch.delenv("WORLD_SIZE", raising=False)
    feats, post = write_corpus(tmp_path, n=2)
    out = tmp_path / "o.nnet"
    with pytest.raises(ValueError, match=why):
        t_cli.main([feats, post, tiny_models(tmp_path), str(out),
                    "--device", "cpu"] + flag)
    assert not out.exists()


@pytest.mark.parametrize("delay,weights", [(0, False), (3, True)])
def test_stream_scheduler_matches_jax(tmp_path, delay, weights):
    feats, post = write_corpus(tmp_path, n=11)
    utts = list(kio.SequentialMatrixReader(feats))
    fw = None
    if weights:
        rng = np.random.RandomState(5)
        fw = {k: rng.rand(m.shape[0]).astype(np.float32) for k, m in utts}
    utts.insert(3, ("no_targets", utts[0][1]))
    kw = dict(feat_dim=8, num_stream=3, batch_size=7, targets_delay=delay,
              max_entries=2, frame_weights=fw)
    mine = list(StreamScheduler(iter(utts), kio.RandomAccessPosteriorReader(
        post, 2), **kw))
    ref = JScheduler(iter(utts), JPost(post, 2), **kw)
    theirs = list(ref)
    assert len(mine) == len(theirs) > 3
    for a, b in zip(mine, theirs):
        for x, y in zip(a, b):
            np.testing.assert_array_equal(np.asarray(x), np.asarray(y))
    assert ref.num_no_tgt_mat == 1


def test_posterior_tables_cross_read(tmp_path):
    """Posterior arks written by one package read in the other."""
    posts = {"a": [[(3, 1.0)], [(1, 0.25), (7, 0.75)]], "b": [[]]}
    for opts in ("ark", "ark,t"):
        with kio.PosteriorWriter(f"{opts}:{tmp_path}/p.ark") as w:
            for k, v in posts.items():
                w.write(k, v)
        j = JPost(f"ark:{tmp_path}/p.ark", 2)
        t = kio.RandomAccessPosteriorReader(f"ark:{tmp_path}/p.ark", 2)
        for k in posts:
            assert t.value(k) == j.value(k) == posts[k]
            for x, y in zip(t.value_dense(k), j.value_dense(k, 2)):
                np.testing.assert_array_equal(x, y)
        assert list(kio.SequentialPosteriorReader(
            f"ark:{tmp_path}/p.ark")) == list(posts.items())
    assert os.path.getsize(f"{tmp_path}/p.ark") > 0


def test_posterior_to_sparse_matches_jax():
    posts = [[[(3, 1.0)], [(1, 0.25), (7, 0.75), (2, 0.5)]], [],
             [[(5, 0.5)]]]
    for k in (1, 2, 3):
        for a, b in zip(posterior_to_sparse(posts, k),
                        j_to_sparse(posts, k)):
            np.testing.assert_array_equal(a, b)


@pytest.mark.gpu
def test_cuda_train_step_with_gate_dropout(tmp_path):
    """Gate dropout on the card: the component's CUDA generator draws the
    keep-mask, K1/K2 take it as int8, and the step stays finite."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card (K1-K4 have no CPU mode); run on "
                    "the card with: python -m pytest -m gpu "
                    "tests/test_torch_train.py")
    proto = TINY_PROTO.replace("<NumStream> 8\n<LstmProjectedStreams>",
                               "<NumStream> 8 <DropoutRate> 0.2\n"
                               "<LstmProjectedStreams>")
    nnet, params = Nnet.init_from_proto(
        proto, torch.Generator().manual_seed(3), "cuda")
    assert nnet.components[1].dropout_rate == 0.2
    step = make_train_step(nnet, TrainOptions(learn_rate=0.01),
                           device="cuda")
    opt = init_momentum(params)
    states = nnet.init_states(4, "cuda")
    rng = torch.Generator(device="cuda").manual_seed(777)
    lt.reset_counts()
    xa.reset_counts()
    for b in batches():
        params, opt, states, aux = step(
            params, opt, states, (), *(torch.from_numpy(a).cuda()
                                       for a in b),
            torch.tensor(0.01, device="cuda"), rng=rng)
    torch.cuda.synchronize()
    assert lt.FWD_LAUNCHES == 2 * lt.fwd_launches(6) * 4 and \
        lt.PLAIN_CALLS == 0
    # K3 launches 2 kernels a step, K4 3
    assert (xa.FWD_LAUNCHES, xa.BWD_LAUNCHES, xa.PLAIN_CALLS) == (8, 12, 0)
    for t in tree_leaves((params, opt.corr)):
        assert bool(torch.isfinite(t).all())
