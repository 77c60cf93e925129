"""The port's grouped training step, monitor dumps, debug dump and
profile trace against the JAX package on the CPU:

* the grouped epoch (`run_epoch(..., step_group=3)`, with a tail group)
  against the JAX package's grouped epoch and against the port's own
  plain epoch, for training (fused and unfused senone loss) and for
  cross-validation; with gate dropout, grouped against plain within the
  port (the two packages draw different masks);
* `Nnet.info_propagate`, `Nnet.info_gradient` and the `--verbose 1` /
  `--verbose 2` moment dumps against the JAX trainer's, line for line,
  with the every-25k-frames repeat of `--verbose 2`;
* `nnet_debug_dump`'s printed moments and its `.npz` tensors against
  the JAX tool's, and the trainer CLI's `--debug-dump`;
* the trainer CLI with `--step-group` against the JAX CLI, and
  `--profile-dir` writing a trace;
* on a card (marked `gpu`): the CUDA-graph replay against eager steps,
  bitwise, with the launch counts credited per replay, for training,
  cross-validation and dropout.

Tolerances: params, momentum and the statistics within rtol = atol =
1e-5 across packages (float32 on both sides, frame sums in other
orders, as tests/test_torch_train.py); the port's grouped and plain
epochs on the CPU run the same ops in the same order, so they agree
exactly. Printed moments (6 significant digits) within rtol 1e-4 +
atol 1e-6: a moment computed from 1e-7-relative different tensors can
move the 6th digit; gradient moments go through autograd in other
orders, so their means near zero get atol 1e-6 as well (1e-5 for the
25k-frame repeat, after ~20 updates). Debug-dump
tensors within rtol = atol = 1e-5 (numpy on both sides, the upstream
derivative from autograd there and from jax.grad here).
"""

import importlib
import json
import os
import re
import sys

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import kaldi_lstm_tpu.utils.logging as j_log
import kaldi_lstm_tpu_torch.utils.logging as t_log
from __graft_entry__ import TINY_PROTO
from kaldi_lstm_tpu.io.kaldi_io import RandomAccessPosteriorReader as JPost
from kaldi_lstm_tpu.io.kaldi_io import SequentialMatrixReader as JFeats
from kaldi_lstm_tpu.models import Nnet as JNnet
from kaldi_lstm_tpu.tools import train_lstm_streams as j_cli
from kaldi_lstm_tpu.train.loss import masked_xent_loss as j_xent
from kaldi_lstm_tpu.train.streams import StreamScheduler as JScheduler
from kaldi_lstm_tpu.train.trainer import TrainOptions as JTrainOptions
from kaldi_lstm_tpu.train.trainer import run_epoch as j_run_epoch
from kaldi_lstm_tpu_torch.io import kaldi_io as kio
from kaldi_lstm_tpu_torch.models import Nnet
from kaldi_lstm_tpu_torch.ops import lstm_infer as li
from kaldi_lstm_tpu_torch.ops import lstm_train as lt
from kaldi_lstm_tpu_torch.ops.counts import launch_counts
from kaldi_lstm_tpu_torch.tools import nnet_debug_dump as t_dump
from kaldi_lstm_tpu_torch.tools import train_lstm_streams as t_cli
from kaldi_lstm_tpu_torch.train.loss import masked_xent_loss
from kaldi_lstm_tpu_torch.train.optim import init_momentum
from kaldi_lstm_tpu_torch.train.streams import StreamScheduler
from kaldi_lstm_tpu_torch.train.trainer import (
    TrainOptions,
    make_grouped_train_step,
    make_train_step,
    place_batch,
    run_epoch,
)
from kaldi_lstm_tpu_torch.utils.tree import tree_leaves

TOL = dict(rtol=1e-5, atol=1e-5)
_NUM = re.compile(r"-?\d+(?:\.\d+)?(?:e[-+]\d+)?")
S, T = 4, 5
DROPOUT_PROTO = TINY_PROTO.replace(
    "<NumStream> 8\n<LstmProjectedStreams>",
    "<NumStream> 8 <DropoutRate> 0.3\n<LstmProjectedStreams>")


def write_corpus(d, n=9, D=8, K=32, seed=0):
    rng = np.random.RandomState(seed)
    feats, post = f"ark:{d}/feats.ark", f"ark:{d}/post.ark"
    with kio.MatrixWriter(feats) as fw, kio.PosteriorWriter(post) as pw:
        for i in range(n):
            L = int(rng.randint(8, 30))
            x = rng.randn(L, D).astype(np.float32)
            lab = (np.abs(x[:, :3]).sum(1) * 6).astype(int) % K
            fw.write(f"utt{i:02d}", x)
            pw.write(f"utt{i:02d}", [[(int(v), 1.0)] for v in lab])
    return feats, post


def write_model(d, proto=TINY_PROTO, seed=3):
    nnet, params = Nnet.init_from_proto(
        proto, torch.Generator().manual_seed(seed), "cpu")
    path = f"{d}/model.nnet"
    nnet.write(path, params)
    return path


def t_sched(feats, post):
    return StreamScheduler(kio.SequentialMatrixReader(feats),
                           kio.RandomAccessPosteriorReader(post), 8, S, T,
                           1)


def j_sched(feats, post):
    return JScheduler(JFeats(feats), JPost(post), 8, S, T, 1)


def assert_close_text(a: str, b: str, rtol=1e-4, atol=1e-6) -> None:
    """Same lines with the numbers blanked out, numbers close."""
    assert _NUM.sub("#", a) == _NUM.sub("#", b), (a, b)
    np.testing.assert_allclose([float(v) for v in _NUM.findall(a)],
                               [float(v) for v in _NUM.findall(b)],
                               rtol=rtol, atol=atol)


def assert_trees_close(t_tree, j_tree) -> None:
    t_leaves = tree_leaves(t_tree)
    j_leaves = jax.tree_util.tree_leaves(j_tree)
    assert len(t_leaves) == len(j_leaves)
    for a, b in zip(t_leaves, j_leaves):
        np.testing.assert_allclose(a.detach().numpy(), np.asarray(b), **TOL)


# ---------------------------------------------------------------------------
# (a) the grouped epoch
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("case", ["xent", "xent_fused", "cv"])
def test_grouped_epoch_matches_jax_and_plain(tmp_path, case):
    feats, post = write_corpus(tmp_path)
    path = write_model(tmp_path)
    n_batches = len(list(t_sched(feats, post)))
    assert n_batches > 3 and n_batches % 3 != 0   # full groups and a tail
    cv = case == "cv"
    kw = dict(learn_rate=0.02, momentum=0.9,
              fused_xent=case == "xent_fused")
    j_nnet, j_params = JNnet.read(path)
    j_res = j_run_epoch(j_nnet, j_params, j_sched(feats, post),
                        JTrainOptions(**kw), crossvalidate=cv, step_group=3)
    res = {}
    for group in (3, 1):
        nnet, params = Nnet.read(path, "cpu")
        lt.reset_counts()
        li.reset_counts()
        res[group] = run_epoch(nnet, params, t_sched(feats, post),
                               TrainOptions(**kw), crossvalidate=cv,
                               step_group=group)
        # two LSTM layers a step (inference in CV); a training step also
        # runs each backward
        assert (li.PLAIN_CALLS, lt.PLAIN_CALLS) == (
            (2 * n_batches, 0) if cv else (0, 4 * n_batches))
    grp, plain = res[3], res[1]
    for a, b in zip(tree_leaves((grp.params, grp.opt_state.corr)),
                    tree_leaves((plain.params, plain.opt_state.corr))):
        assert torch.equal(a, b)
    assert grp.stats.report() == plain.stats.report()
    assert grp.num_done == plain.num_done == j_res.num_done
    assert grp.total_frames == j_res.total_frames
    assert grp.stats.correct == j_res.stats.correct
    np.testing.assert_allclose(grp.stats.loss, j_res.stats.loss, rtol=1e-5)
    assert_trees_close(grp.params, j_res.params)
    if cv:
        _, p0 = Nnet.read(path, "cpu")
        for a, b in zip(tree_leaves(grp.params), tree_leaves(p0)):
            assert torch.equal(a, b)


def test_grouped_epoch_with_dropout_matches_plain(tmp_path):
    """Gate dropout draws its masks from one generator in step order:
    grouped and plain epochs draw the same masks."""
    feats, post = write_corpus(tmp_path)
    path = write_model(tmp_path, DROPOUT_PROTO)
    res = {}
    for group in (3, 1):
        nnet, params = Nnet.read(path, "cpu")
        assert nnet.components[1].dropout_rate == pytest.approx(0.3)
        res[group] = run_epoch(nnet, params, t_sched(feats, post),
                               TrainOptions(learn_rate=0.02), step_group=group)
    for a, b in zip(tree_leaves(res[3].params), tree_leaves(res[1].params)):
        assert torch.equal(a, b)
    assert res[3].stats.report() == res[1].stats.report()
    _, p0 = Nnet.read(path, "cpu")
    assert not all(torch.equal(a, b) for a, b in
                   zip(tree_leaves(res[3].params), tree_leaves(p0)))


def test_grouped_step_checks_its_batch_axis(tmp_path):
    path = write_model(tmp_path)
    nnet, params = Nnet.read(path, "cpu")
    g = make_grouped_train_step(nnet, TrainOptions(), device="cpu", group=3)
    b = place_batch(next(iter(t_sched(*write_corpus(tmp_path)))), "cpu")
    with pytest.raises(ValueError, match="leading axis of 3"):
        g(params, init_momentum(params), nnet.init_states(S, "cpu"), (),
          *(torch.stack([t, t]) for t in b), torch.tensor(0.1))
    with pytest.raises(ValueError, match=">= 1"):
        make_grouped_train_step(nnet, TrainOptions(), device="cpu", group=0)


@pytest.mark.parametrize("group", ["2", "3"])
def test_cli_step_group_matches_jax_cli(tmp_path, group):
    feats, post = write_corpus(tmp_path)
    model = write_model(tmp_path)
    flags = ["--learn-rate=0.02", "--num-stream=4", "--batch-size=5",
             "--targets-delay=1", f"--step-group={group}"]
    j_out, t_out = str(tmp_path / "j.nnet"), str(tmp_path / "t.nnet")
    rc, j_stats = j_cli.run_main([feats, post, model, j_out] + flags)
    assert rc == 0
    rc, t_stats = t_cli.run_main([feats, post, model, t_out] + flags
                                 + ["--device", "cpu"])
    assert rc == 0
    assert_close_text(t_stats.report(), j_stats.report(), rtol=1e-5)
    assert_trees_close(Nnet.read(t_out, "cpu")[1], JNnet.read(j_out)[1])
    cv = ["--cross-validate=true"] + flags[1:]
    rc, j_cv = j_cli.run_main([feats, post, j_out] + cv)
    rc2, t_cv = t_cli.run_main([feats, post, t_out] + cv
                               + ["--device", "cpu"])
    assert rc == rc2 == 0
    assert_close_text(t_cv.report(), j_cv.report(), rtol=1e-5)


def test_cli_step_group_below_1_exits_1(tmp_path, capsys):
    out = tmp_path / "o.nnet"
    rc = t_cli.main(["ark:f.ark", "ark:p.ark", "m.nnet", str(out),
                     "--device", "cpu", "--step-group", "0"])
    assert rc == 1 and not out.exists()
    assert "--step-group must be >= 1" in capsys.readouterr().err


# ---------------------------------------------------------------------------
# (b) info_propagate, info_gradient and the monitor dumps
# ---------------------------------------------------------------------------

def _one_batch(seed=2):
    rng = np.random.RandomState(seed)
    x = rng.randn(S, T, 8).astype(np.float32)
    ids = rng.randint(0, 32, (S, T, 1)).astype(np.int32)
    w = np.ones((S, T, 1), np.float32)
    mask = (rng.rand(S, T) < 0.8).astype(np.float32)
    return x, ids, w, mask


def test_info_propagate_and_info_gradient_match_jax(tmp_path):
    path = write_model(tmp_path)
    j_nnet, j_params = JNnet.read(path)
    nnet, params = Nnet.read(path, "cpu")
    x, ids, w, mask = _one_batch()
    assert_close_text(nnet.info_propagate(params, torch.from_numpy(x)),
                      j_nnet.info_propagate(j_params, jnp.asarray(x)))

    def j_obj(p):
        logits, _ = j_nnet.propagate(p, jnp.asarray(x), None, logits=True)
        return j_xent(logits, jnp.asarray(ids), jnp.asarray(w),
                      jnp.asarray(mask))[0]

    live = [t.requires_grad_(True) for t in tree_leaves(params)]
    logits, _ = nnet.propagate(params, torch.from_numpy(x), None,
                               logits=True)
    loss = masked_xent_loss(logits, torch.from_numpy(ids),
                            torch.from_numpy(w), torch.from_numpy(mask))[0]
    grads = torch.autograd.grad(loss, live)
    from kaldi_lstm_tpu_torch.utils.tree import tree_unflatten
    g_tree = tree_unflatten(params, list(grads))
    text = nnet.info_gradient(g_tree)
    assert "w_gifo_x_corr_" in text and "linearity_grad" in text
    assert_close_text(text, j_nnet.info_gradient(jax.grad(j_obj)(j_params)))


def _vlog_lines(err: str) -> list:
    """The VLOG lines and their continuations, the tag and clock cut."""
    out = []
    for ln in err.splitlines():
        if ln.startswith("LOG ") or ln.startswith("WARNING "):
            continue
        out.append(re.sub(r"^VLOG\[\d\] \(\d\d:\d\d:\d\d\) ", "", ln))
    return out


def _monitor_blocks(err: str) -> str:
    lines = _vlog_lines(err)
    keep = [ln for ln in lines if not ln.startswith(("ProgressLoss",
                                                     "After "))]
    return "\n".join(keep)


@pytest.mark.parametrize("verbose,cv", [(1, False), (2, False), (1, True)])
def test_monitor_dumps_match_jax(tmp_path, capsys, verbose, cv):
    feats, post = write_corpus(tmp_path)
    path = write_model(tmp_path)
    opts = dict(learn_rate=0.02, momentum=0.9)
    j_nnet, j_params = JNnet.read(path)
    nnet, params = Nnet.read(path, "cpu")
    capsys.readouterr()
    j_log.set_verbose_level(verbose)
    try:
        j_run_epoch(j_nnet, j_params, j_sched(feats, post),
                    JTrainOptions(**opts), crossvalidate=cv,
                    monitor_verbose=verbose, step_group=2)
    finally:
        j_log.set_verbose_level(0)
    j_err = capsys.readouterr().err
    t_log.set_verbose_level(verbose)
    try:
        run_epoch(nnet, params, t_sched(feats, post), TrainOptions(**opts),
                  crossvalidate=cv, monitor_verbose=verbose, step_group=2)
    finally:
        t_log.set_verbose_level(0)
    t_err = capsys.readouterr().err
    blocks = _monitor_blocks(t_err)
    assert "### After 0 frames," in blocks
    assert "### Forward propagation buffer content :" in blocks
    assert ("### Backward propagation buffer content :" in blocks) != cv
    assert ("w_gifo_x_corr_" in blocks) != cv
    assert_close_text(blocks, _monitor_blocks(j_err))
    # the epoch profile at -v 2, in both packages
    assert ("epoch profile (" in t_err) == (verbose >= 2) \
        == ("epoch profile (" in j_err)


def test_monitor_repeats_every_25k_frames_as_jax(tmp_path, capsys):
    """At -v 2 the dumps repeat when the masked-frame count crosses a
    multiple of 25000 (reference :251-260), at group granularity, with
    the post-group params: the same labels and moments as the JAX
    trainer's."""
    rng = np.random.RandomState(6)
    feats, post = f"ark:{tmp_path}/feats.ark", f"ark:{tmp_path}/post.ark"
    with kio.MatrixWriter(feats) as fw, kio.PosteriorWriter(post) as pw:
        for i in range(90):
            x = rng.randn(int(rng.randint(300, 330)), 8).astype(np.float32)
            fw.write(f"u{i:02d}", x)
            pw.write(f"u{i:02d}", [[(int(k) * 4, 1.0)] for k in x.argmax(1)])
    path = write_model(tmp_path)
    kw = dict(feat_dim=8, num_stream=16, batch_size=50, targets_delay=0)
    capsys.readouterr()
    j_log.set_verbose_level(2)
    try:
        j_nnet, j_params = JNnet.read(path)
        j_run_epoch(j_nnet, j_params,
                    JScheduler(JFeats(feats), JPost(post), **kw),
                    JTrainOptions(learn_rate=1e-3), monitor_verbose=2,
                    step_group=3)
    finally:
        j_log.set_verbose_level(0)
    j_err = capsys.readouterr().err
    t_log.set_verbose_level(2)
    try:
        nnet, params = Nnet.read(path, "cpu")
        run_epoch(nnet, params, StreamScheduler(
            kio.SequentialMatrixReader(feats),
            kio.RandomAccessPosteriorReader(post), **kw),
            TrainOptions(learn_rate=1e-3), monitor_verbose=2, step_group=3)
    finally:
        t_log.set_verbose_level(0)
    t_err = capsys.readouterr().err
    labels = re.findall(r"### After (\d+) frames,", t_err)
    assert labels[0] == "0" and int(labels[1]) >= 25000
    assert labels == re.findall(r"### After (\d+) frames,", j_err)
    # after ~20 updates the params differ at ~1e-6 relative, and the
    # gradients' means (sums near cancellation over 800 frames) move by a
    # few 1e-6 absolute: atol 1e-5 here
    assert_close_text(_monitor_blocks(t_err), _monitor_blocks(j_err),
                      atol=1e-5)


# ---------------------------------------------------------------------------
# (c) the debug dump
# ---------------------------------------------------------------------------

def _dump_lines(err: str) -> str:
    return "\n".join(ln for ln in err.splitlines()
                     if not ln.startswith(("LOG ", "WARNING ")))


@pytest.fixture
def j_dump_loader():
    """Imports the JAX tool afresh inside the test body and drops it
    after the test. Its moment lines go to its `out` default, the
    sys.stderr of its import: imported in the test body, that is this
    test's capture; a copy kept past the test would print into a closed
    capture in a later test."""
    import kaldi_lstm_tpu.tools as pkg
    name = "kaldi_lstm_tpu.tools.nnet_debug_dump"
    saved = sys.modules.pop(name, None)
    had_attr = hasattr(pkg, "nnet_debug_dump")
    saved_attr = getattr(pkg, "nnet_debug_dump", None)
    yield lambda: importlib.import_module(name)
    sys.modules.pop(name, None)
    if saved is not None:
        sys.modules[name] = saved
    if had_attr:
        pkg.nnet_debug_dump = saved_attr
    elif hasattr(pkg, "nnet_debug_dump"):
        del pkg.nnet_debug_dump


@pytest.mark.parametrize("variant", ["1", "2", "3"])
def test_debug_dump_matches_jax_tool(tmp_path, capsys, j_dump_loader,
                                     variant):
    feats, post = write_corpus(tmp_path)
    model = write_model(tmp_path)
    argv = [model, feats, None, "--targets", post, "--num-stream", "3",
            "--batch-size", "7", "--variant", variant, "--print-frames",
            "-1"]
    j_dump = j_dump_loader()
    capsys.readouterr()
    assert j_dump.main([a if a else str(tmp_path / "j") for a in argv]) == 0
    j_err = capsys.readouterr().err
    assert t_dump.main([a if a else str(tmp_path / "t") for a in argv]
                       + ["--device", "cpu"]) == 0
    t_err = capsys.readouterr().err
    assert "forward-pass frame 6" in t_err and "backward-pass frame 0" in t_err
    assert_close_text(_dump_lines(t_err), _dump_lines(j_err), atol=1e-5)
    names = sorted(os.listdir(tmp_path / "t"))
    assert names == sorted(os.listdir(tmp_path / "j")) == [
        "layer1.<LstmProjectedStreams>.npz",
        "layer2.<LstmProjectedStreams>.npz"]
    for name in names:
        with np.load(tmp_path / "t" / name) as a, \
                np.load(tmp_path / "j" / name) as b:
            assert sorted(a.files) == sorted(b.files)
            for k in a.files:
                np.testing.assert_allclose(a[k], b[k], **TOL)


def test_cli_debug_dump_matches_jax_cli(tmp_path, capsys, j_dump_loader):
    feats, post = write_corpus(tmp_path)
    model = write_model(tmp_path)
    flags = ["--num-stream=4", "--batch-size=5", "--targets-delay=1",
             "--learn-rate=0.02"]
    j_dump_loader()     # the JAX CLI imports the tool; have it fresh
    capsys.readouterr()
    assert j_cli.main([feats, post, model, str(tmp_path / "j.nnet"),
                       "--debug-dump", str(tmp_path / "j")] + flags) == 0
    j_err = capsys.readouterr().err
    j_err = j_err[:j_err.index("TRAINING STARTED")]
    assert t_cli.main([feats, post, model, str(tmp_path / "t.nnet"),
                       "--debug-dump", str(tmp_path / "t"), "--device",
                       "cpu"] + flags) == 0
    t_err = capsys.readouterr().err
    t_err = t_err[:t_err.index("TRAINING STARTED")]
    assert "backward-pass frame 0 (variant 1)" in t_err
    assert_close_text(_dump_lines(t_err), _dump_lines(j_err), atol=1e-5)
    names = sorted(os.listdir(tmp_path / "t"))
    assert names == sorted(os.listdir(tmp_path / "j")) and len(names) == 2
    for name in names:
        with np.load(tmp_path / "t" / name) as a, \
                np.load(tmp_path / "j" / name) as b:
            for k in a.files:
                np.testing.assert_allclose(a[k], b[k], **TOL)


# ---------------------------------------------------------------------------
# (d) --profile-dir
# ---------------------------------------------------------------------------

def test_cli_profile_dir_writes_a_trace(tmp_path, capsys):
    feats, post = write_corpus(tmp_path)
    model = write_model(tmp_path)
    prof = tmp_path / "prof"
    assert t_cli.main([feats, post, model, str(tmp_path / "o.nnet"),
                       "--num-stream=4", "--batch-size=5", "--step-group=2",
                       "--profile-dir", str(prof), "--verbose=2",
                       "--device", "cpu"]) == 0
    (trace,) = os.listdir(prof)
    assert trace.endswith(".pt.trace.json")
    with open(prof / trace) as f:
        events = json.load(f)["traceEvents"]
    assert any("lstm" in str(e.get("name", "")).lower()
               or e.get("name") == "aten::mm" for e in events)
    err = capsys.readouterr().err
    assert "profiler trace written to" in err
    # --verbose 2: the reference's invocation and epoch profile
    for what in ("invocation profile: model read", "invocation profile: "
                 "setup", "epoch profile (10 steps,", "invocation profile: "
                 "model fetch+write"):
        assert what in err, what
    # cross-validation writes no trace (the reference's behaviour)
    prof_cv = tmp_path / "prof_cv"
    assert t_cli.main([feats, post, model, "--cross-validate=true",
                       "--num-stream=4", "--batch-size=5", "--profile-dir",
                       str(prof_cv), "--device", "cpu"]) == 0
    assert not prof_cv.exists()


# ---------------------------------------------------------------------------
# on a card: the CUDA-graph replay against eager steps
# ---------------------------------------------------------------------------

@pytest.mark.gpu
@pytest.mark.parametrize("case", ["train", "cv", "dropout"])
def test_cuda_graph_replay_matches_eager_steps(tmp_path, case):
    """Three groups of 3 (an eager warm-up group, a capture, replays)
    against nine eager steps: params, momentum, states and stats
    bitwise; each kernel's count equal to the eager run's."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card (the graph replays K1-K5, which "
                    "have no CPU mode); run on the card with: python -m "
                    "pytest -m gpu tests/test_torch_grouped.py")
    feats, post = write_corpus(tmp_path, n=30)
    proto = DROPOUT_PROTO if case == "dropout" else TINY_PROTO
    path = write_model(tmp_path, proto)
    cv = case == "cv"
    batches = list(t_sched(feats, post))[:9]
    assert len(batches) == 9
    opts = TrainOptions(learn_rate=0.02, momentum=0.9)
    out = {}
    for grouped in (False, True):
        nnet, params = Nnet.read(path, "cuda")
        opt, states = init_momentum(params), nnet.init_states(S, "cuda")
        lr = torch.tensor(0.02, device="cuda")
        rng = (torch.Generator(device="cuda").manual_seed(777)
               if case == "dropout" else None)
        before = launch_counts()
        rows = []
        if grouped:
            g = make_grouped_train_step(nnet, opts, None, cv,
                                        device="cuda", group=3)
            for k in range(3):
                host = [torch.stack(t) for t in zip(*(
                    place_batch(b, "cpu") for b in batches[3 * k:3 * k + 3]))]
                params, opt, states, aux = g(params, opt, states, (), *host,
                                             lr, rng=rng)
                rows.append(aux)
            assert g.graph is not None and g.pool_bytes > 0
        else:
            step = make_train_step(nnet, opts, None, cv, device="cuda")
            for b in batches:
                params, opt, states, aux = step(
                    params, opt, states, (), *place_batch(b, "cuda"), lr,
                    rng=rng)
                rows.append(torch.stack([a.float() for a in aux])[None])
        torch.cuda.synchronize()
        out[grouped] = ([t.clone() for t in tree_leaves((params, opt.corr,
                                                         states))],
                        torch.cat(rows),
                        {k: v - before[k]
                         for k, v in launch_counts().items()})
    (pe, ae, ce), (pg, ag, cg) = out[False], out[True]
    for a, b in zip(pe, pg):
        assert torch.equal(a, b)
    assert torch.equal(ae, ag)
    assert ce == cg
    assert not any(v for k, v in ce.items() if k.startswith("plain."))
    assert (ce["lstmp_infer"] > 0) == cv
    assert (ce["lstmp_train_fwd"] > 0) != cv
