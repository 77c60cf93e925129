"""The port's bidirectional projected LSTM (`BLstmProjectedStreams`)
against the JAX package's on the CPU, and the four tests of
tests/test_blstm.py on the port.

Held, each from one model file both packages read and from inputs made
with numpy from a seed:
* the forward output in both layouts (batch- and time-major), one and
  two layers (layer 2 at I = 2R), at 1e-5;
* the gradient of a masked loss with respect to every fw/bw parameter and
  the input, `jax.grad` (the scan, and the Pallas kernels in interpret
  mode) against autograd through the plain K1/K2 versions, at 1e-5;
* the model file's bytes, binary and text, both ways; `nnet_info`'s text;
* `convert.py`'s carry-over of the {"fw", "bw"} params and momentum;
* the streaming refusals, in the classes and through the CLIs, with the
  JAX package's messages.

Tolerance: rtol = atol = 1e-5. Both sides are float32 and sum the same
products in other orders (~1e-7 relative a step); the recurrences at
these widths stay contractive, so the difference does not grow past
1e-6 over the 7-11 steps used here.
"""

import io

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from kaldi_lstm_tpu.models import Nnet as JNnet
from kaldi_lstm_tpu_torch.convert import (
    momentum_from_numpy,
    momentum_to_numpy,
    params_from_numpy,
    params_to_numpy,
)
from kaldi_lstm_tpu_torch.models import BLstmProjectedStreams, Nnet
from kaldi_lstm_tpu_torch.ops import lstm_infer as li
from kaldi_lstm_tpu_torch.ops import lstm_train as lt
from kaldi_lstm_tpu_torch.ops.lstm_cell import lstm_scan, zero_state
from kaldi_lstm_tpu_torch.train.optim import MomentumState
from kaldi_lstm_tpu_torch.train.streams import StreamScheduler
from kaldi_lstm_tpu_torch.train.trainer import TrainOptions, run_epoch
from kaldi_lstm_tpu_torch.utils.tree import tree_leaves, tree_map

TOL = dict(rtol=1e-5, atol=1e-5)

PROTO = """<NnetProto>
<BLstmProjectedStreams> <InputDim> 5 <OutputDim> 12 <CellDim> 9 <ParamScale> 0.1 <NumStream> 2
<AffineTransform> <InputDim> 12 <OutputDim> 4 <ParamStddev> 0.1
<Softmax> <InputDim> 4 <OutputDim> 4
</NnetProto>
"""
# two BLSTM layers: layer 2 reads the 2R = 12 outputs of layer 1
PROTO2 = PROTO.replace(
    "<AffineTransform>",
    "<BLstmProjectedStreams> <InputDim> 12 <OutputDim> 10 <CellDim> 7 "
    "<ParamScale> 0.1 <NumStream> 2\n<AffineTransform>", 1).replace(
    "<AffineTransform> <InputDim> 12", "<AffineTransform> <InputDim> 10")
# the trainable variant of tests/test_blstm.py: 6 inputs, 5 classes
TRAIN_PROTO = PROTO.replace("<InputDim> 5", "<InputDim> 6", 1).replace(
    "<OutputDim> 4", "<OutputDim> 5").replace("<InputDim> 4", "<InputDim> 5")


def build(proto=PROTO, seed=0):
    return Nnet.init_from_proto(proto, torch.Generator().manual_seed(seed),
                                "cpu")


def jax_model(tmp_path, proto=PROTO, binary=True):
    """A JAX-initialised model file and both packages' readings of it."""
    jn, jp = JNnet.init_from_proto(proto, jax.random.PRNGKey(0))
    path = str(tmp_path / ("j.nnet" if binary else "j.nnet.txt"))
    jn.write(path, jp, binary=binary)
    return path, JNnet.read(path), Nnet.read(path, "cpu")


def close(t, j):
    np.testing.assert_allclose(t.detach().numpy(), np.asarray(j), **TOL)


# -- tests/test_blstm.py on the port -----------------------------------------

def test_blstm_shapes_and_direction_semantics():
    nnet, params = build()
    bl = nnet.components[0]
    assert bl.recur_dim == 6 and bl.cell_dim == 9
    x = torch.tensor(np.random.RandomState(1).randn(2, 7, 5)
                     .astype(np.float32))
    y, _ = bl.apply(params[0], x)
    assert y.shape == (2, 7, 12)
    st = zero_state(2, 9, 6)
    ref_f, _ = lstm_scan(params[0]["fw"], x, st)
    np.testing.assert_allclose(y[..., :6].numpy(), ref_f.numpy(),
                               rtol=1e-5, atol=1e-6)
    ref_b, _ = lstm_scan(params[0]["bw"], torch.flip(x, (1,)), st)
    np.testing.assert_allclose(y[..., 6:].numpy(),
                               torch.flip(ref_b, (1,)).numpy(),
                               rtol=1e-5, atol=1e-6)


def test_blstm_serialization_roundtrip():
    nnet, params = build()
    x = torch.tensor(np.random.RandomState(2).randn(1, 5, 5)
                     .astype(np.float32))
    for binary in (True, False):
        buf = io.BytesIO()
        nnet.write_stream(buf, params, binary=binary)
        buf.seek(0)
        nnet2, params2 = Nnet.read_stream(io.BufferedReader(buf))
        assert nnet2.components[0].token == "<BLstmProjectedStreams>"
        y1, _ = nnet.propagate(params, x)
        y2, _ = nnet2.propagate(params2, x)
        np.testing.assert_allclose(y1.numpy(), y2.numpy(), rtol=1e-6,
                                   atol=1e-7)


class DictTargets:
    def __init__(self, table):
        self.table = table

    def has_key(self, key):
        return key in self.table

    def value(self, key):
        return self.table[key]


def synth_sched(seed=0):
    """tests/test_trainer.py's learnable synthetic task (the class is a
    linear readout of the features) through the port's scheduler."""
    rng = np.random.RandomState(seed)
    W = rng.randn(6, 5)
    utts, targets = [], {}
    for i in range(8):
        f = rng.randn(rng.randint(8, 17), 6).astype(np.float32)
        utts.append((f"utt{i}", f))
        targets[f"utt{i}"] = [[(int(k), 1.0)] for k in (f @ W).argmax(-1)]
    return StreamScheduler(iter(utts), DictTargets(targets), feat_dim=6,
                           num_stream=2, batch_size=5, targets_delay=0)


def _avg(stats):
    return (stats.loss - stats.entropy) / stats.frames


def test_blstm_trains():
    nnet, params = build(TRAIN_PROTO)
    opts = TrainOptions(learn_rate=0.05, momentum=0.9)
    res1 = run_epoch(nnet, params, synth_sched(), opts)
    avg1 = _avg(res1.stats)
    params, opt = res1.params, res1.opt_state
    for _ in range(3):
        res = run_epoch(nnet, params, synth_sched(), opts, opt_state=opt)
        params, opt = res.params, res.opt_state
    assert _avg(res.stats) < avg1 - 0.05


def test_blstm_fused_trainer_time_major_and_input_grad():
    """The fused objective passes time_major=True and input_grad=False to
    a first-layer BLSTM; its loss and params match the unfused path's."""
    nnet, params = build(TRAIN_PROTO, seed=2)
    out = {}
    for fused in (True, False):
        p0 = tree_map(torch.clone, params)
        lt.reset_counts()
        out[fused] = run_epoch(nnet, p0, synth_sched(seed=5),
                               TrainOptions(learn_rate=1e-3, momentum=0.9,
                                            fused_xent=fused))
        assert lt.PLAIN_CALLS > 0
    rf, rp = out[True], out[False]
    assert abs(rf.stats.loss - rp.stats.loss) <= \
        1e-3 * max(1.0, abs(rp.stats.loss))
    for a, b in zip(tree_leaves(rf.params), tree_leaves(rp.params)):
        np.testing.assert_allclose(a.numpy(), b.numpy(), rtol=5e-4,
                                   atol=5e-5)


# -- against the JAX package --------------------------------------------------

@pytest.mark.parametrize("proto", [PROTO, PROTO2], ids=["one", "two"])
@pytest.mark.parametrize("time_major", [False, True])
def test_forward_matches_jax(tmp_path, proto, time_major):
    _, (jn, jp), (nnet, params) = jax_model(tmp_path, proto)
    x = np.random.RandomState(3).randn(3, 11, 5).astype(np.float32)
    if time_major:
        x = np.ascontiguousarray(x.transpose(1, 0, 2))
    jy, ty = jnp.asarray(x), torch.from_numpy(x)
    li.reset_counts()
    for jc, c, p_j, p_t in zip(jn.components, nnet.components, jp, params):
        if not isinstance(c, BLstmProjectedStreams):
            break
        jy, _ = jc.apply(p_j, jy, time_major=time_major)
        ty, _ = c.apply(p_t, ty, time_major=time_major)
        close(ty, jy)
    # each direction of each layer is one inference call (K5's plain
    # version on the CPU)
    n_bl = sum(isinstance(c, BLstmProjectedStreams) for c in nnet.components)
    assert li.PLAIN_CALLS == 2 * n_bl
    if not time_major:
        jo, _ = jn.propagate(jp, jnp.asarray(x))
        to, _ = nnet.propagate(params, torch.from_numpy(x))
        close(to, jo)


@pytest.mark.parametrize("impl", ["scan", "pallas"])
@pytest.mark.parametrize("proto", [PROTO, PROTO2], ids=["one", "two"])
def test_gradient_matches_jax(tmp_path, monkeypatch, proto, impl):
    """d(masked loss)/d(every fw/bw parameter and the input): jax.grad
    through the JAX package's scan or Pallas kernels (interpret mode)
    against autograd through the port's K1/K2 plain versions."""
    monkeypatch.setenv("KLT_LSTM_IMPL", impl)
    _, (jn, jp), (nnet, params) = jax_model(tmp_path, proto)
    rng = np.random.RandomState(4)
    x = rng.randn(2, 9, 5).astype(np.float32)
    mask = (rng.rand(2, 9) < 0.7).astype(np.float32)
    n = sum(isinstance(c, BLstmProjectedStreams) for c in nnet.components)
    w = rng.randn(2, 9, nnet.components[n - 1].output_dim).astype(np.float32)

    def j_loss(ps, xx):
        y = xx
        for c, p in zip(jn.components[:n], ps):
            y, _ = c.apply(p, y)
        return jnp.sum(jnp.tanh(y) * w * mask[..., None])

    jg, jgx = jax.grad(j_loss, argnums=(0, 1))(tuple(jp[:n]), jnp.asarray(x))
    live = [{k: type(v)(*(t.detach().requires_grad_() for t in v))
             for k, v in p.items()} for p in params[:n]]
    xt = torch.from_numpy(x).requires_grad_()
    lt.reset_counts()
    y = xt
    for c, p in zip(nnet.components[:n], live):
        y, _ = c.apply(p, y)
    loss = (torch.tanh(y) * torch.from_numpy(w)
            * torch.from_numpy(mask)[..., None]).sum()
    loss.backward()
    assert lt.PLAIN_CALLS == 4 * n   # forward and backward per direction
    close(xt.grad, jgx)
    for p, g in zip(live, jg):
        for d in ("fw", "bw"):
            for f in type(p[d])._fields:
                close(getattr(p[d], f).grad, getattr(g[d], f))


@pytest.mark.parametrize("binary", [True, False])
def test_model_bytes_equal_both_ways(tmp_path, binary):
    """The port reads the JAX package's file and writes the same bytes;
    the JAX package reads the port's file and writes the same bytes."""
    path, _, (nnet, params) = jax_model(tmp_path, PROTO2, binary=binary)
    with open(path, "rb") as f:
        j_bytes = f.read()
    nnet.write(str(tmp_path / "t.nnet"), params, binary=binary)
    with open(tmp_path / "t.nnet", "rb") as f:
        assert f.read() == j_bytes
    tn, tp = build(PROTO2, seed=7)
    tn.write(str(tmp_path / "t7.nnet"), tp, binary=binary)
    jn, jp = JNnet.read(str(tmp_path / "t7.nnet"))
    jn.write(str(tmp_path / "j7.nnet"), jp, binary=binary)
    with open(tmp_path / "t7.nnet", "rb") as a, \
            open(tmp_path / "j7.nnet", "rb") as b:
        assert a.read() == b.read()
    assert b"<DropoutRate>" not in j_bytes and \
        b"<LearnRateCoef>" not in j_bytes.split(b"<AffineTransform>")[0]


def test_nnet_info_text_equal(tmp_path, capsys):
    from kaldi_lstm_tpu.tools.nnet_info import main as j_info
    from kaldi_lstm_tpu_torch.tools.nnet_info import main as t_info
    path, _, _ = jax_model(tmp_path, PROTO2)
    assert j_info([path]) == 0
    j_out = capsys.readouterr().out
    assert t_info([path]) == 0
    t_out = capsys.readouterr().out
    assert t_out == j_out and "backward:" in t_out
    assert "number-of-parameters" in t_out


def test_info_gradient_text_equal(tmp_path):
    """info_gradient of the {"fw", "bw"} gradient tree, the text the
    trainer's --verbose moment dumps print."""
    _, (jn, jp), (nnet, params) = jax_model(tmp_path)
    assert nnet.info_gradient(params) == jn.info_gradient(jp)
    assert "backward:" in nnet.info_gradient(params)


def test_convert_round_trip(tmp_path):
    _, (jn, jp), _ = jax_model(tmp_path, PROTO2)
    nnet, _ = build(PROTO2)
    np_params = jax.tree_util.tree_map(np.asarray, jp)
    params = params_from_numpy(nnet, np_params, "cpu")
    assert isinstance(params[0], dict) and set(params[0]) == {"fw", "bw"}
    back = params_to_numpy(params)
    j_leaves = jax.tree_util.tree_leaves(np_params)
    b_leaves = tree_leaves(back)
    assert len(j_leaves) == len(b_leaves) > 0
    for a, b in zip(j_leaves, b_leaves):
        assert np.array_equal(a, b)
    x = np.random.RandomState(5).randn(2, 8, 5).astype(np.float32)
    jo, _ = jn.propagate(jp, jnp.asarray(x))
    to, _ = nnet.propagate(params, torch.from_numpy(x))
    close(to, jo)
    opt = momentum_from_numpy(nnet, np_params, "cpu")
    assert isinstance(opt, MomentumState)
    for a, b in zip(tree_leaves(momentum_to_numpy(opt)), j_leaves):
        assert np.array_equal(a, b)


def test_num_params_counts_both_directions():
    nnet, params = build()
    lstm = 4 * 9 * (5 + 6) + 4 * 9 + 3 * 9 + 6 * 9
    assert nnet.components[0].num_params(params[0]) == 2 * lstm
    assert nnet.num_params(params) == 2 * lstm + 12 * 4 + 4
    # a BLSTM carries no state and passes through the format conversions
    assert nnet.init_states(3) == (None, None, None)
    for conv in (nnet.to_standard(), nnet.to_streams()):
        assert conv.components[0] is nnet.components[0]


# -- streaming refusals --------------------------------------------------------

def test_streaming_classes_refuse_a_blstm(tmp_path):
    from kaldi_lstm_tpu.decode.online import OnlineBatchScorer as JScorer
    from kaldi_lstm_tpu.decode.online import OnlineRecognizer as JRecognizer
    from kaldi_lstm_tpu_torch.decode.online import (
        OnlineBatchScorer,
        OnlineRecognizer,
    )
    _, (jn, jp), (nnet, params) = jax_model(tmp_path)
    msgs = []
    for cls, n, p, args in ((OnlineBatchScorer, nnet, params, (2,)),
                            (JScorer, jn, jp, (2,)),
                            (OnlineRecognizer, nnet, params, (None,)),
                            (JRecognizer, jn, jp, (None,))):
        with pytest.raises(ValueError) as e:
            cls(n, p, *args)
        msgs.append(str(e.value))
    assert msgs[0] == msgs[1] == "bidirectional nets cannot stream"
    assert msgs[2] == msgs[3] and "needs the whole utterance" in msgs[2]


@pytest.mark.parametrize("tool", ["online_decode", "online_serve_batch"])
def test_streaming_clis_refuse_a_blstm(tmp_path, tool):
    import importlib
    from kaldi_lstm_tpu_torch.tools.make_word_synth_data import main as mk
    d = str(tmp_path)
    assert mk(["--dir", d, "--num-words", "6", "--num-phones", "5",
               "--states-per-phone", "2", "--feat-dim", "5",
               "--num-utts", "2", "--min-pron", "2", "--max-pron", "3",
               "--max-words", "3"]) == 0
    nnet, params = build(PROTO.replace(" 4 ", " 10 ").replace(
        "<OutputDim> 4", "<OutputDim> 10"))
    nnet.write(f"{d}/blstm.nnet", params)
    argv = [f"{d}/blstm.nnet", f"{d}/final.mdl", f"{d}/lexicon.txt",
            f"{d}/lm.arpa", f"scp:{d}/feats.scp", f"ark,t:{d}/hyp.txt"]
    msgs = []
    for pkg, extra in (("kaldi_lstm_tpu", []),
                       ("kaldi_lstm_tpu_torch", ["--device", "cpu"])):
        main = importlib.import_module(f"{pkg}.tools.{tool}").main
        with pytest.raises(ValueError) as e:
            main(argv + extra)
        msgs.append(str(e.value))
    assert msgs[0] == msgs[1] and "bidirectional" in msgs[0]


# -- on the card ----------------------------------------------------------------

@pytest.mark.gpu
def test_cuda_blstm_matches_cpu(tmp_path):
    """On the card a BLSTM's training call runs K1/K2 per direction and
    its inference call K5 per direction; outputs and gradients within
    the card-vs-CPU tolerance of tests/test_torch_lstm_train.py."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card (K1/K2/K5 have no CPU mode); run "
                    "on the card with: python -m pytest -m gpu "
                    "tests/test_torch_blstm.py")
    torch.backends.cuda.matmul.allow_tf32 = False
    _, _, (nnet, params) = jax_model(tmp_path, PROTO2)
    rng = np.random.RandomState(6)
    x = rng.randn(1, 130, 5).astype(np.float32)
    w = rng.randn(1, 130, 10).astype(np.float32)
    res = {}
    for dev in ("cpu", "cuda"):
        ps = [{k: type(v)(*(t.detach().to(dev).requires_grad_()
                            for t in v))
               for k, v in p.items()} for p in params[:2]]
        xt = torch.from_numpy(x).to(dev)
        lt.reset_counts()
        li.reset_counts()
        with torch.no_grad():
            y_inf = xt
            for c, p in zip(nnet.components[:2], ps):
                y_inf, _ = c.apply(p, y_inf)
        y = xt
        for c, p in zip(nnet.components[:2], ps):
            y, _ = c.apply(p, y)
        (torch.tanh(y) * torch.from_numpy(w).to(dev)).sum().backward()
        if dev == "cuda":
            torch.cuda.synchronize()
            assert (li.LAUNCHES, lt.FWD_LAUNCHES, lt.BWD_LAUNCHES) == (
                4, 4 * lt.fwd_launches(130),
                2 * lt.bwd_launches(130, False)
                + 2 * lt.bwd_launches(130, True))
            assert (li.PLAIN_CALLS, lt.PLAIN_CALLS) == (0, 0)
        res[dev] = [y_inf, y] + [t.grad for t in tree_leaves(ps)]
    for a, b in zip(res["cuda"], res["cpu"]):
        b = b.detach()
        np.testing.assert_allclose(a.detach().cpu().numpy(), b.numpy(),
                                   rtol=1e-4,
                                   atol=1e-4 * (1 + float(b.abs().max())))
