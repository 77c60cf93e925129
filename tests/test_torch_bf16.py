"""The port's bf16 path (`--bf16 true`, `compute_dtype=torch.bfloat16`)
against the JAX package's bf16 contract (`set_matmul_dtype(jnp.bfloat16)`)
on the CPU:

* K1/K2's plain versions (the autograd Function over
  `lstm_fwd_residuals_plain` / `lstm_bwd_plain`, and the kernels'
  decompositions `lstm_fwd_tc_plain` / `lstm_bwd_split_plain`) against
  `lstm_scan_pallas` in interpret mode: outputs, final state and the
  gradients of the seven parameters, x, c0 and r0 under random
  cotangents;
* K5's decomposition (`lstm_infer_sliced_plain`) against the Pallas
  primal, in two chunks with the state carried;
* K3/K4's plain versions against `xent_pallas.fused_affine_xent` in
  interpret mode (lse, picked, argmax, the loss statistics, dr, dW, db),
  with a masked half and a ragged class count;
* the unfused AffineTransform against the JAX component's `apply` and
  its `jax.vjp`;
* the slice: the port's `train_lstm_streams --bf16 true --device cpu`
  against the JAX CLI with `--bf16 true` (its LSTMs on the Pallas kernels
  in interpret mode, `KLT_LSTM_IMPL=pallas`), fused and unfused xent,
  with a cross-validation pass and at `--step-group 2`; and
  `run_recipe --bf16 true` reaching the trainer.

Tolerance. A bf16 x bf16 product is exact in float32, so two
implementations that round the same operands at the same points differ
only by float32 summation order (~1e-7 relative) and, rarely, by a bf16
rounding that an operand computed in float32 takes the other way (a
"flip": XLA and PyTorch sum in different orders, so a value that sits
within an f32 ulp of a bf16 rounding boundary can round up on one side
and down on the other; it moves the elements downstream of it by a few
bf16 ulps). One that rounds one operand more or fewer than the reference
differs everywhere, by a good part of the bf16 effect itself. So every
comparison measures, on the same inputs, the bf16-vs-f32 distance (the
JAX reference in bf16 against itself in float32) and holds the port's
error to at most a tenth of it, tensor by tensor (`assert_bf16_close`).
Both are root-mean-squares over the tensor: an isolated flip barely
moves the error's, a missed or added rounding point moves it to about
the distance's. The comparison also requires the distance to be real
(its RMS above 1e-5 of the tensor's RMS), so inputs that hide the bf16
effect fail instead of passing vacuously. The model files after
training are compared as the updates from the initial model, and with
the loss statistics they follow the same rule down to float32's own
resolution: where bf16 moves a trained weight or a loss sum by less than
a millionth of its size (the bias, whose gradient bf16 barely touches;
the first layer, whose updates are that small), the port must match it
to that millionth, the float32 tolerance of tests/test_torch_train.py.

The JAX dtype is a module global: an autouse fixture resets it after
every test.
"""

import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from __graft_entry__ import TINY_PROTO
from kaldi_lstm_tpu.models import Nnet as JNnet
from kaldi_lstm_tpu.models.components import (
    AffineTransform as JAffine,
    set_matmul_dtype,
)
from kaldi_lstm_tpu.ops import LstmState as JLstmState
from kaldi_lstm_tpu.ops.lstm_cell import LstmParams as JLstmParams
from kaldi_lstm_tpu.ops.lstm_pallas import lstm_scan_pallas
from kaldi_lstm_tpu.ops.xent_pallas import (
    _fwd_call as j_xent_rows,
    _pad_inputs as j_xent_pad,
    _tiles as j_xent_tiles,
    fused_affine_xent as j_fused_xent,
)
from kaldi_lstm_tpu.tools import train_lstm_streams as j_cli
from kaldi_lstm_tpu_torch.models import Nnet
from kaldi_lstm_tpu_torch.models.components import AffineTransform
from kaldi_lstm_tpu_torch.ops import counts
from kaldi_lstm_tpu_torch.ops import lstm_infer as li
from kaldi_lstm_tpu_torch.ops import lstm_train as lt
from kaldi_lstm_tpu_torch.ops import xent_affine as xa
from kaldi_lstm_tpu_torch.ops.lstm_cell import LstmParams, LstmState
from kaldi_lstm_tpu_torch.tools import run_recipe
from kaldi_lstm_tpu_torch.tools import train_lstm_streams as t_cli
from kaldi_lstm_tpu_torch.utils.tree import tree_leaves

from test_torch_train import (
    _NUM,
    tiny_models,
    write_corpus,
    write_transform_and_weights,
)

BF16 = torch.bfloat16
# the port's error may be at most this share of the bf16-vs-f32 distance
SHARE = 0.1
# ... and that distance must be at least this share of the tensor's RMS
MIN_DISTANCE = 1e-5
# float32's resolution for trained weights and loss sums (module docstring)
F32_FLOOR = 1e-6


@pytest.fixture(autouse=True)
def reset_jax_dtype():
    yield
    set_matmul_dtype(None)


def rms(a) -> float:
    return float(np.sqrt(np.mean(np.square(np.asarray(a, np.float64)))))


def assert_bf16_close(name, port, ref_bf16, ref_f32, floor=None):
    """rms(port - ref_bf16) <= SHARE * rms(ref_bf16 - ref_f32), with a
    distance that is not vanishingly small; or, with a `floor`, within
    max(SHARE * distance, floor). Returns the distance."""
    port, ref, f32 = (np.asarray(a, np.float64)
                      for a in (port, ref_bf16, ref_f32))
    assert port.shape == ref.shape == f32.shape, name
    err, dist = rms(port - ref), rms(ref - f32)
    if floor is None:
        assert dist > MIN_DISTANCE * rms(ref), \
            f"{name}: bf16-vs-f32 distance {dist:.3e} is too small to test"
        floor = 0.0
    assert err <= max(SHARE * dist, floor), \
        f"{name}: error {err:.3e} > {SHARE} x distance {dist:.3e} " \
        f"(floor {floor:.3e})"
    return dist


def t(a):
    return torch.tensor(np.asarray(a, np.float32))


# ---------------------------------------------------------------------------
# K1/K2
# ---------------------------------------------------------------------------

def lstm_inputs(S, T, I, C, R, keep, seed):
    rng = np.random.RandomState(seed)

    def u(*shape):
        return rng.uniform(-0.3, 0.3, shape).astype(np.float32)

    p = dict(w_gifo_x=u(4 * C, I), w_gifo_r=u(4 * C, R), bias=u(4 * C),
             peephole_i_c=u(C), peephole_f_c=u(C), peephole_o_c=u(C),
             w_r_m=u(R, C))
    x = rng.randn(S, T, I).astype(np.float32)
    c0 = (rng.randn(S, C) * 0.5).astype(np.float32)
    r0 = (rng.randn(S, R) * 0.5).astype(np.float32)
    mask = None if keep is None else rng.rand(S, T, 4 * C) < keep
    cot = (rng.randn(S, T, R).astype(np.float32),
           rng.randn(S, C).astype(np.float32),
           rng.randn(S, R).astype(np.float32))
    return p, x, c0, r0, mask, cot


def jax_lstm(p, x, c0, r0, mask, cot, keep, need_dx, dtype):
    """lstm_scan_pallas (interpret mode) under set_matmul_dtype(dtype):
    (out, c_T, r_T), then the gradients of the seven params, x, c0, r0."""
    set_matmul_dtype(dtype)
    jp = JLstmParams(**{k: jnp.asarray(v) for k, v in p.items()})

    def f(params, xx, c, r):
        out, fin = lstm_scan_pallas(
            params, xx, JLstmState(c=c, r=r), 50.0, interpret=True,
            gate_keep_mask=None if mask is None else jnp.asarray(mask),
            keep_prob=1.0 if keep is None else keep,
            need_input_grad=need_dx)
        return out, fin.c, fin.r

    outs, vjp = jax.vjp(f, jp, jnp.asarray(x), jnp.asarray(c0),
                        jnp.asarray(r0))
    gp, gx, gc, gr = vjp(tuple(jnp.asarray(c) for c in cot))
    set_matmul_dtype(None)
    grads = [np.asarray(getattr(gp, k)) for k in JLstmParams._fields]
    return ([np.asarray(o) for o in outs],
            grads + [np.asarray(gx), np.asarray(gc), np.asarray(gr)])


def torch_lstm(p, x, c0, r0, mask, cot, keep, need_dx):
    """lt.lstm_train in bf16 on the CPU (the Function over the plain
    versions): same results as jax_lstm."""
    tp = LstmParams(**{k: t(v).requires_grad_() for k, v in p.items()})
    tx, tc, tr = (t(a).requires_grad_() for a in (x, c0, r0))
    out, fin = lt.lstm_train(
        tp, tx, LstmState(tc, tr), 50.0,
        gate_keep_mask=None if mask is None else torch.from_numpy(mask),
        keep_prob=1.0 if keep is None else keep, need_input_grad=need_dx,
        compute_dtype=BF16)
    torch.autograd.backward([out, fin.c, fin.r], [t(c) for c in cot])
    grads = [getattr(tp, k).grad for k in LstmParams._fields]
    return ([o.detach().numpy() for o in (out, fin.c, fin.r)],
            [g.numpy() for g in grads]
            + [tx.grad.numpy() if need_dx else np.zeros_like(x),
               tc.grad.numpy(), tr.grad.numpy()])


def split_lstm(p, x, c0, r0, mask, cot, keep, need_dx):
    """The kernels' decompositions, lstm_fwd_tc_plain and
    lstm_bwd_split_plain, in bf16: same results as jax_lstm."""
    tp = LstmParams(**{k: t(v) for k, v in p.items()})
    x_tm = t(x).transpose(0, 1).contiguous()
    m8 = None if mask is None else \
        torch.from_numpy(mask).transpose(0, 1).to(torch.int8).contiguous()
    ik = 1.0 if keep is None else 1.0 / keep
    gifo, c_seq, r_seq = lt.lstm_fwd_tc_plain(tp, x_tm, t(c0), t(r0), m8,
                                              ik, 50.0, compute_dtype=BF16)
    assert gifo.dtype == BF16
    T = x_tm.shape[0]
    g_r = t(cot[0]).transpose(0, 1).contiguous()
    g_r[T - 1] += t(cot[2])
    dp, dx, dc0, dr0 = lt.lstm_bwd_split_plain(
        tp, x_tm, t(c0), t(r0), gifo, c_seq, r_seq, m8, ik, g_r, t(cot[1]),
        need_dx, compute_dtype=BF16)
    outs = [r_seq.transpose(0, 1).numpy(), c_seq[T - 1].numpy(),
            r_seq[T - 1].numpy()]
    dxn = dx.transpose(0, 1).numpy() if need_dx else np.zeros_like(x)
    return outs, [g.numpy() for g in dp] + [dxn, dc0.numpy(), dr0.numpy()]


LSTM_NAMES = (["out", "c_T", "r_T"], list(JLstmParams._fields)
              + ["dx", "dc0", "dr0"])
LSTM_CASES = {
    # name: (S, T, I, C, R, keep, need_dx)
    "small": (3, 6, 5, 9, 6, None, True),
    "small_keep_0.75": (3, 6, 5, 9, 6, 0.75, True),
    "small_no_dx": (2, 6, 5, 9, 6, None, False),
    "wide_keep_0.75": (4, 6, 40, 200, 64, 0.75, True),
    "wide_keep_0.75_no_dx": (4, 6, 40, 200, 64, 0.75, False),
}


@pytest.mark.parametrize("impl", ["function", "decomposition"])
@pytest.mark.parametrize("case", list(LSTM_CASES))
def test_lstm_train_bf16_matches_pallas(case, impl):
    S, T, I, C, R, keep, need_dx = LSTM_CASES[case]
    args = lstm_inputs(S, T, I, C, R, keep, seed=len(case))
    j16 = jax_lstm(*args, keep, need_dx, jnp.bfloat16)
    j32 = jax_lstm(*args, keep, need_dx, None)
    lt.reset_counts()
    port = (torch_lstm if impl == "function" else split_lstm)(
        *args, keep, need_dx)
    if impl == "function":
        assert (lt.FWD_BF16_LAUNCHES, lt.BWD_BF16_LAUNCHES,
                lt.PLAIN_CALLS) == (0, 0, 2)
    for names, p_, a, b in zip(LSTM_NAMES, port, j16, j32):
        for n, pv, av, bv in zip(names, p_, a, b):
            if n == "dx" and not need_dx:
                continue
            assert_bf16_close(n, pv, av, bv)


# ---------------------------------------------------------------------------
# K5
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("dims", [(3, 5, 9, 6), (4, 40, 200, 64)])
def test_lstm_infer_bf16_matches_pallas_primal(dims):
    """Two chunks of T=6 with the state carried; the JAX side is the
    custom-VJP primal (no gradient taken), i.e. _infer_kernel. Each chunk
    of the port starts from the reference's carried state, and the state
    each carries out is compared: a flip (module docstring) then stays in
    the chunk where it happens instead of running through the rest of
    the recurrence."""
    S, I, C, R = dims
    p, x, c0, r0, _, _ = lstm_inputs(S, 12, I, C, R, None, seed=I)
    jp = JLstmParams(**{k: jnp.asarray(v) for k, v in p.items()})
    ref = {}
    for name, dt in (("bf16", jnp.bfloat16), ("f32", None)):
        set_matmul_dtype(dt)
        st = JLstmState(c=jnp.asarray(c0), r=jnp.asarray(r0))
        chunks = []
        for k in range(2):
            o, st2 = lstm_scan_pallas(jp, jnp.asarray(x[:, 6 * k:6 * k + 6]),
                                      st, 50.0, interpret=True)
            chunks.append((st, np.asarray(o), np.asarray(st2.c),
                           np.asarray(st2.r)))
            st = st2
        ref[name] = chunks
        set_matmul_dtype(None)
    tp = LstmParams(**{k: t(v) for k, v in p.items()})
    outs = []
    for k in range(2):
        st = ref["bf16"][k][0]
        x_tm = t(x[:, 6 * k:6 * k + 6]).transpose(0, 1).contiguous()
        r_seq, c = li.lstm_infer_sliced_plain(tp, x_tm, t(st.c), t(st.r),
                                              compute_dtype=BF16)
        outs.append(r_seq.transpose(0, 1).numpy())
        assert_bf16_close(f"chunk {k} c_T", c.numpy(), ref["bf16"][k][2],
                          ref["f32"][k][2])
    # the output sequence of both chunks, [S, 12, R] (r_T is its last
    # frame of each chunk)
    assert_bf16_close("out", np.concatenate(outs, 1),
                      *(np.concatenate([c[1] for c in ref[k]], 1)
                        for k in ("bf16", "f32")))
    # the plain path of the entry point (lstm_scan) rounds the same
    li.reset_counts()
    outs = []
    for k in range(2):
        st = ref["bf16"][k][0]
        with torch.no_grad():
            out, _ = li.lstm_infer(tp, t(x[:, 6 * k:6 * k + 6]),
                                   LstmState(t(st.c), t(st.r)),
                                   compute_dtype=BF16)
        outs.append(out.numpy())
    assert (li.BF16_LAUNCHES, li.PLAIN_CALLS) == (0, 2)
    assert_bf16_close("lstm_scan out", np.concatenate(outs, 1),
                      *(np.concatenate([c[1] for c in ref[k]], 1)
                        for k in ("bf16", "f32")))


# ---------------------------------------------------------------------------
# K3/K4
# ---------------------------------------------------------------------------

XENT_CASES = {
    # name: (N, R, K, Km, mask_p)
    "small": (24, 6, 5, 2, 1.0),
    "masked_half_ragged_K": (70, 64, 300, 2, 0.5),
}


@pytest.mark.parametrize("case", list(XENT_CASES))
def test_fused_xent_bf16_matches_pallas(case):
    N, R, K, Km, mask_p = XENT_CASES[case]
    rng = np.random.RandomState(N)
    r = rng.randn(N, R).astype(np.float32)
    w = (rng.randn(K, R) * 0.3).astype(np.float32)
    b = (rng.randn(K) * 0.1).astype(np.float32)
    ids = rng.randint(0, K, (N, Km)).astype(np.int32)
    tw = rng.rand(N, Km).astype(np.float32)
    mask = (rng.rand(N) < mask_p).astype(np.float32)
    ref = {}
    for name, dt in (("bf16", jnp.bfloat16), ("f32", None)):
        set_matmul_dtype(dt)
        (loss, aux), vjp = jax.vjp(
            lambda a, c, d: j_fused_xent(a, c, d, jnp.asarray(ids),
                                         jnp.asarray(tw), jnp.asarray(mask),
                                         True),
            jnp.asarray(r), jnp.asarray(w), jnp.asarray(b))
        g = vjp((jnp.float32(1.0), jax.tree_util.tree_map(jnp.zeros_like,
                                                          aux)))
        # K3's per-row statistics (lse, picked, max, first argmax)
        padded = j_xent_pad(*(jnp.asarray(a) for a in (r, w, b, ids, tw,
                                                        mask)))
        ft, kt = j_xent_tiles(N, K)
        rows = [np.asarray(v)[:N, 0] for v in j_xent_rows(
            *padded[:5], ft=ft, kt=kt, interpret=True)]
        ref[name] = ([float(loss), float(aux.correct)],
                     [np.asarray(v) for v in g], rows)
        set_matmul_dtype(None)
    tr, tw_, tb = (t(a).requires_grad_() for a in (r, w, b))
    xa.reset_counts()
    loss, aux = xa.fused_affine_xent(tr, tw_, tb, torch.from_numpy(ids),
                                     t(tw), t(mask), compute_dtype=BF16)
    loss.backward()
    assert (xa.FWD_BF16_LAUNCHES, xa.BWD_BF16_LAUNCHES,
            xa.PLAIN_CALLS) == (0, 0, 2)
    assert_bf16_close("loss", loss.item(), ref["bf16"][0][0],
                      ref["f32"][0][0])
    assert float(aux.correct) == ref["bf16"][0][1]
    for n, a, j16, j32 in zip(("dr", "dW", "db"), (tr.grad, tw_.grad,
                                                    tb.grad),
                              ref["bf16"][1], ref["f32"][1]):
        assert_bf16_close(n, a.numpy(), j16, j32)
    # the per-row statistics, also through K3's chunked decomposition
    for impl in ("plain", "chunked"):
        args = (t(r), t(w), t(b), torch.from_numpy(ids), t(tw))
        rows = xa.xent_fwd_plain(*args, compute_dtype=BF16) \
            if impl == "plain" else \
            xa.xent_fwd_chunked_plain(*args, 128, compute_dtype=BF16)
        for n, a, j16, j32 in zip(("lse", "picked", "max"), rows[:3],
                                  ref["bf16"][2][:3], ref["f32"][2][:3]):
            assert_bf16_close(f"{impl} {n}", a.numpy(), j16, j32)
        assert np.array_equal(rows[3].numpy(), ref["bf16"][2][3])


# ---------------------------------------------------------------------------
# the unfused AffineTransform
# ---------------------------------------------------------------------------

def test_affine_bf16_matches_jax_autodiff():
    """apply's forward and dx, dW, db against the JAX component's apply
    under set_matmul_dtype(bf16) and jax.vjp: dx and dW are rounded to
    bf16 after an f32 product of the unrounded cotangent (the transpose
    of JAX's casts), so they match to the last bit but for summation
    order; db is the plain sum."""
    rng = np.random.RandomState(5)
    x = rng.randn(3, 7, 33).astype(np.float32)
    w = (rng.randn(11, 33) * 0.2).astype(np.float32)
    b = rng.randn(11).astype(np.float32)
    g = rng.randn(3, 7, 11).astype(np.float32)
    jc = JAffine(33, 11)
    ref = {}
    for name, dt in (("bf16", jnp.bfloat16), ("f32", None)):
        set_matmul_dtype(dt)
        y, vjp = jax.vjp(lambda xx, ww, bb: jc.apply(
            {"linearity": ww, "bias": bb}, xx)[0], jnp.asarray(x),
            jnp.asarray(w), jnp.asarray(b))
        ref[name] = [np.asarray(v) for v in (y, *vjp(jnp.asarray(g)))]
        set_matmul_dtype(None)
    tc = AffineTransform(33, 11)
    tc.matmul_dtype = BF16
    tx, tw_, tb = (t(a).requires_grad_() for a in (x, w, b))
    y, _ = tc.apply({"linearity": tw_, "bias": tb}, tx)
    y.backward(t(g))
    for n, a, j16, j32 in zip(("y", "dx", "dW", "db"),
                              (y.detach(), tx.grad, tw_.grad, tb.grad),
                              ref["bf16"], ref["f32"]):
        if n == "db":   # no product: the same f32 sum on both sides
            np.testing.assert_allclose(a.numpy(), j16, rtol=1e-6,
                                       atol=1e-6)
            continue
        assert_bf16_close(n, a.numpy(), j16, j32)
    for a in (tx.grad, tw_.grad):   # rounded to bf16, as JAX's
        assert torch.equal(a, a.to(BF16).float())


def test_set_matmul_dtype_reaches_every_matmul_component():
    nnet, _ = Nnet.init_from_proto(
        TINY_PROTO, torch.Generator().manual_seed(0), "cpu")
    nnet.set_matmul_dtype(BF16)
    dts = [getattr(c, "matmul_dtype", "none") for c in nnet.components]
    assert dts.count(BF16) == sum(
        type(c).__name__ in ("AffineTransform", "LstmProjected",
                             "LstmProjectedStreams")
        for c in nnet.components) > 0
    nnet.set_matmul_dtype(None)
    assert all(getattr(c, "matmul_dtype", None) is None
               for c in nnet.components)
    with pytest.raises(TypeError):
        nnet.set_matmul_dtype(torch.float16)


# ---------------------------------------------------------------------------
# the slice: the training CLI and the recipe
# ---------------------------------------------------------------------------

def assert_models_bf16_close(t_path, j16_path, j32_path, init_path):
    """The trained params, as their updates from the initial model (the
    same subtraction on all three sides, so the error and the distance
    are the params'; the distance is then measured against the size of
    the update, not of the weights): the whole model as one vector by
    the bf16 rule, and each tensor by it down to a millionth of its
    weights' RMS (module docstring)."""
    t_leaves = tree_leaves(Nnet.read(t_path, "cpu")[1])
    init = tree_leaves(Nnet.read(init_path, "cpu")[1])
    j16 = jax.tree_util.tree_leaves(JNnet.read(j16_path)[1])
    j32 = jax.tree_util.tree_leaves(JNnet.read(j32_path)[1])
    assert len(t_leaves) == len(init) == len(j16) == len(j32)
    upd = [[], [], []]
    for k, (a, p0, b, c) in enumerate(zip(t_leaves, init, j16, j32)):
        p0 = p0.numpy().astype(np.float64)
        sides = (a.numpy() - p0, np.asarray(b) - p0, np.asarray(c) - p0)
        assert_bf16_close(f"param {k} update", *sides,
                          F32_FLOOR * rms(np.asarray(b)))
        for u, v in zip(upd, sides):
            u.append(v.ravel())
    assert_bf16_close("the model's update", *(np.concatenate(u)
                                              for u in upd))


def assert_stats_bf16_close(t_st, j16, j32):
    """The same report text but for its numbers; the loss, entropy,
    correct-frame and frame sums (weighted with --frame-weights) by the
    bf16 rule down to float32's resolution."""
    rep = t_st.report()
    assert _NUM.sub("#", rep) == _NUM.sub("#", j16.report()), \
        (rep, j16.report())
    for what in ("loss", "entropy", "correct", "frames"):
        a, b, c = (getattr(st, what) for st in (t_st, j16, j32))
        assert_bf16_close(what, a, b, c, F32_FLOOR * abs(b))


@pytest.fixture
def pallas_lstm(monkeypatch):
    """The JAX CLI's LSTMs on the Pallas kernels (interpret mode on the
    CPU), whose bf16 contract the port's kernels follow; the CPU default
    is the eager scan, whose autodiff rounds the gradients of bf16 dots."""
    monkeypatch.setenv("KLT_LSTM_IMPL", "pallas")


CLI_CASES = {
    # name: (fused xent, extra flags)
    "unfused": ("false", []),
    "fused": ("true", []),
    "fused_step_group_2": ("true", ["--step-group=2"]),
    "unfused_transform_weights": ("false", "extras"),
}


@pytest.mark.parametrize("case", list(CLI_CASES))
def test_cli_bf16_matches_jax_cli(tmp_path, pallas_lstm, case):
    fused, extra = CLI_CASES[case]
    feats, post = write_corpus(tmp_path)
    model = tiny_models(tmp_path)
    flags = ["--learn-rate=0.02", "--momentum=0.5", "--num-stream=4",
             "--batch-size=5", "--targets-delay=1", f"--fused-xent={fused}"]
    if extra == "extras":
        flags += write_transform_and_weights(tmp_path, feats)
    else:
        flags += extra
    j_flags = [f for f in flags if not f.startswith("--step-group")]
    out = {k: str(tmp_path / f"{k}.nnet") for k in ("j16", "j32", "t")}
    rc, j16 = j_cli.run_main([feats, post, model, out["j16"]] + j_flags
                             + ["--bf16=true"])
    set_matmul_dtype(None)
    assert rc == 0
    rc, j32 = j_cli.run_main([feats, post, model, out["j32"]] + j_flags)
    assert rc == 0
    counts.reset_counts()
    rc, t16 = t_cli.run_main([feats, post, model, out["t"]] + flags
                             + ["--bf16", "true", "--device", "cpu"])
    assert rc == 0
    assert counts.plain_calls() > 0 and not any(
        v for k, v in counts.launch_counts().items()
        if not k.startswith("plain."))
    assert_stats_bf16_close(t16, j16, j32)
    assert_models_bf16_close(out["t"], out["j16"], out["j32"], model)
    # cross-validation of the trained models, in bf16 on both sides
    cv = ["--cross-validate=true", "--bf16=true"] + flags[2:]
    j_cv_flags = [f for f in cv if not f.startswith("--step-group")]
    rc, j_cv16 = j_cli.run_main([feats, post, out["j16"]] + j_cv_flags)
    set_matmul_dtype(None)
    assert rc == 0
    rc, j_cv32 = j_cli.run_main([feats, post, out["j16"]]
                                + j_cv_flags[:1] + j_cv_flags[2:])
    assert rc == 0
    rc, t_cv = t_cli.run_main([feats, post, out["j16"]] + cv
                              + ["--device", "cpu"])
    assert rc == 0
    assert_stats_bf16_close(t_cv, j_cv16, j_cv32)


def test_run_recipe_bf16_reaches_the_trainer(tmp_path, monkeypatch):
    """run_recipe --bf16 true passes the flag to the trainer, which sets
    the net's matmul dtype (in place of the refusal it replaced)."""
    feats, post = write_corpus(tmp_path, n=6)
    model = tiny_models(tmp_path)
    seen = []
    real = Nnet.set_matmul_dtype

    def spy(self, dtype):
        seen.append(dtype)
        real(self, dtype)

    monkeypatch.setattr(Nnet, "set_matmul_dtype", spy)
    d = str(tmp_path / "exp")
    os.makedirs(d)
    import shutil
    shutil.copy(model, f"{d}/nnet.init")
    rc = run_recipe.main([
        "--tr-feats", feats, "--tr-targets", post, "--cv-feats", feats,
        "--cv-targets", post, "--dir", d, "--max-iters", "1",
        "--learn-rate", "0.02", "--num-stream", "4", "--batch-size", "5",
        "--targets-delay", "1", "--bf16", "true", "--device", "cpu"])
    assert rc == 0
    assert seen and all(dt == BF16 for dt in seen)
    assert os.path.getsize(f"{d}/nnet/nnet.iter1") > 0


# ---------------------------------------------------------------------------
# on the card (skipped without one): each bf16 kernel against its bf16
# plain version, and the grouped bf16 step against eager bf16 steps
# ---------------------------------------------------------------------------

@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: the bf16 kernels run only there")
    torch.backends.cuda.matmul.allow_tf32 = False
    return torch.device("cuda")


def bf16_distance_close(name, got, ref, ref_f32):
    assert_bf16_close(name, got.float().cpu().numpy(),
                      ref.float().cpu().numpy(),
                      ref_f32.float().cpu().numpy())


@pytest.mark.gpu
@pytest.mark.parametrize("dims,keep,need_dx", [
    ((64, 8, 40, 200, 64), None, False),
    ((64, 8, 40, 200, 64), 0.75, True),
    ((3, 5, 37, 200, 130), 0.75, True),     # 4-byte copies, ragged tiles
    ((256, 20, 40, 800, 512), None, False),  # the flagship step
])
def test_k1_k2_bf16_kernels_match_plain(cuda_device, dims, keep, need_dx):
    """Each bf16 kernel's outputs against its bf16 plain version, within
    a tenth of the bf16-vs-f32 distance; at the flagship shape (T=20 of
    C=800, weights scaled by 0.1 so that the recurrence is not chaotic)
    within the greater of that and twice the plain version's own
    f32-vs-f64 noise, chip_smoke.py's rule: there a bf16 rounding that
    flips between two correct summation orders is carried through the
    recurrence, and two correct plain versions may already differ by a
    tenth of the distance or more. The flagship readings are printed
    (`pytest -s`), with the term of the rule that passes each."""
    S, T, I, C, R = dims
    flagship = S * T * C >= 256 * 20 * 800
    p, x, c0, r0, mask, cot = lstm_inputs(S, T, I, C, R, keep, seed=3)
    if flagship:
        p = {k: v * 0.1 for k, v in p.items()}
    tp = LstmParams(**{k: t(v).cuda() for k, v in p.items()})
    x_tm = t(x).transpose(0, 1).contiguous().cuda()
    m8 = None if mask is None else torch.from_numpy(mask).transpose(
        0, 1).to(torch.int8).contiguous().cuda()
    ik = 1.0 if keep is None else 1.0 / keep
    fa = (tp, x_tm, t(c0).cuda(), t(r0).cuda(), m8, ik, 50.0)
    lt.reset_counts()
    fk = lt.lstm_fwd_residuals_cuda(*fa, compute_dtype=BF16)
    assert (lt.FWD_BF16_LAUNCHES, lt.FWD_LAUNCHES) == (lt.fwd_launches(T), 0)
    fp = lt.lstm_fwd_residuals_plain(*fa, compute_dtype=BF16)
    f32 = lt.lstm_fwd_residuals_plain(*fa)
    assert fk[0].dtype == BF16

    def f64(args):
        return [a.double() if isinstance(a, torch.Tensor)
                and a.dtype == torch.float32 else a for a in args]

    def close(n, a, b, c, d):
        if not flagship:
            return bf16_distance_close(n, a, b, c)
        a, b, c, d = (v.double().cpu() for v in (a, b, c, d))
        err, dist = rms((a - b).numpy()), rms((b - c).numpy())
        noise = rms((d - b).numpy())
        by = "distance" if err <= SHARE * dist else "noise"
        print(f"flagship K1/K2 {n}: error {err:.3e}, distance {dist:.3e}, "
              f"noise {noise:.3e}, error/distance {err / dist:.4f}, "
              f"passed by the {by} term")
        assert dist > MIN_DISTANCE * rms(b.numpy()), n
        assert err <= max(SHARE * dist, 2 * noise), \
            f"{n}: error {err:.3e}, distance {dist:.3e}, noise {noise:.3e}"

    fd = lt.lstm_fwd_residuals_plain(
        LstmParams(*f64(tp)), *f64(fa[1:]), compute_dtype=BF16) \
        if flagship else fp
    for n, a, b, c, d in zip(("gifo", "c", "r"), fk, fp, f32, fd):
        close(n, a, b, c, d)
    g_r = t(cot[0]).transpose(0, 1).contiguous().cuda()
    gcT = t(cot[1]).cuda()
    ba = (tp, x_tm, t(c0).cuda(), t(r0).cuda())
    bk = lt.lstm_bwd_cuda(*ba, *fp, m8, ik, g_r, gcT, need_dx,
                          compute_dtype=BF16)
    bp = lt.lstm_bwd_plain(*ba, *fp, m8, ik, g_r, gcT, need_dx,
                           compute_dtype=BF16)
    b32 = lt.lstm_bwd_plain(*ba, *f32, m8, ik, g_r, gcT, need_dx)
    assert lt.BWD_BF16_LAUNCHES == lt.bwd_launches(T, need_dx, bf16=True)
    bd = lt.lstm_bwd_plain(LstmParams(*f64(tp)),
                           *f64((*ba[1:], *fp, m8, ik, g_r, gcT)), need_dx,
                           compute_dtype=BF16) if flagship else bp
    for n, a, b, c, d in zip(LstmParams._fields, bk[0], bp[0], b32[0],
                             bd[0]):
        close(n, a, b, c, d)
    close("dc0", bk[2], bp[2], b32[2], bd[2])
    close("dr0", bk[3], bp[3], b32[3], bd[3])
    if need_dx:
        close("dx", bk[1], bp[1], b32[1], bd[1])


@pytest.mark.gpu
@pytest.mark.parametrize("N,R,K,Km", [
    (1001, 136, 1003, 2), (1001, 130, 1003, 2),   # 130: rows of 260 bytes
    (5120, 512, 8000, 1),      # the flagship step
    (5120, 512, 16624, 1),     # the deep config
    (5120, 512, 3999, 1),      # a class count off every tile
    (256, 1024, 8000, 1),      # the DNN's minibatch, R = 1024
])
def test_k3_k4_bf16_kernels_match_plain(cuda_device, N, R, K, Km):
    """Each output of the bf16 K3/K4 against its bf16 plain version on
    the card. The ragged R = 130 / 136 cases within a tenth of the
    bf16-vs-f32 distance; the others within the greater of that and
    twice the plain version's own f32-vs-f64 noise, chip_smoke.py's rule.
    Error, distance and noise are printed (`pytest -s`), with the term
    of the rule that passes each output."""
    g = torch.Generator().manual_seed(4)
    r = torch.randn(N, R, generator=g).cuda()
    w = (torch.randn(K, R, generator=g) * 0.05).cuda()
    b = (torch.randn(K, generator=g) * 0.1).cuda()
    ids = torch.randint(0, K, (N, Km), generator=g).to(torch.int32).cuda()
    tw = torch.rand(N, Km, generator=g).cuda()
    scale = (torch.rand(N, generator=g) < 0.5).float().cuda()
    ragged = R in (130, 136)

    def f64(args):
        return [a.double() if a.dtype == torch.float32 else a for a in args]

    def close(n, a, ref, ref32, ref64):
        a, ref, ref32, ref64 = (v.double().cpu() for v in (a, ref, ref32,
                                                          ref64))
        err, dist = rms((a - ref).numpy()), rms((ref - ref32).numpy())
        noise = rms((ref64 - ref).numpy())
        by = "distance" if err <= SHARE * dist else "noise"
        print(f"K3/K4 bf16 N={N} R={R} K={K} {n}: error {err:.3e}, "
              f"distance {dist:.3e}, noise {noise:.3e}, error/distance "
              f"{err / dist:.4f}, passed by the {by} term")
        assert dist > MIN_DISTANCE * rms(ref.numpy()), n
        limit = SHARE * dist if ragged else max(SHARE * dist, 2 * noise)
        assert err <= limit, \
            f"{n}: error {err:.3e}, distance {dist:.3e}, noise {noise:.3e}"

    fwd_n, bwd_n = xa.xent_launches(bf16=True)
    xa.reset_counts()
    fk = xa.xent_fwd_cuda(r, w, b, ids, tw, compute_dtype=BF16)
    fp = xa.xent_fwd_plain(r, w, b, ids, tw, compute_dtype=BF16)
    f32 = xa.xent_fwd_plain(r, w, b, ids, tw)
    f64_ = xa.xent_fwd_plain(*f64((r, w, b, ids, tw)), compute_dtype=BF16)
    assert (xa.FWD_BF16_LAUNCHES, xa.FWD_LAUNCHES) == (fwd_n, 0)
    for n, a, bb, c, d in zip(("lse", "picked", "max"), fk[:3], fp[:3],
                              f32[:3], f64_[:3]):
        close(n, a, bb, c, d)
    wtot = tw.sum(-1)
    args = (r, w, b, ids, tw, fp[0], scale, wtot)
    bk = xa.xent_bwd_cuda(*args, compute_dtype=BF16)
    bp = xa.xent_bwd_plain(*args, compute_dtype=BF16)
    b32 = xa.xent_bwd_plain(*args)
    b64 = xa.xent_bwd_plain(*f64(args), compute_dtype=BF16)
    assert (xa.BWD_BF16_LAUNCHES, xa.BWD_LAUNCHES) == (bwd_n, 0)
    for n, a, bb, c, d in zip(("dr", "dW", "db"), bk, bp, b32, b64):
        close(n, a, bb, c, d)
    assert not bool(bk[0][scale == 0].any())


@pytest.mark.gpu
@pytest.mark.parametrize("S,T,I,C,R", [(8, 16, 40, 800, 512),
                                       (8, 16, 2400, 800, 512),
                                       (3, 16, 37, 200, 130),
                                       (256, 20, 40, 800, 512)])
def test_k5_bf16_kernel_matches_plain(cuda_device, S, T, I, C, R):
    p, x, c0, r0, _, _ = lstm_inputs(S, T, I, C, R, None, seed=I)
    p = {k: v * 0.1 for k, v in p.items()}
    tp = LstmParams(**{k: t(v).cuda() for k, v in p.items()})
    x_tm = t(x).transpose(0, 1).contiguous().cuda()
    st = LstmState(t(c0).cuda(), t(r0).cuda())
    plan = li.device_plan(S, I, C, R, cuda_device, bf16=True)
    assert plan == li.k5_bf16_plan(S, I, C, R, plan["sms"])
    assert plan["resident"] == int(I < 2400)
    li.reset_counts()
    with torch.no_grad():
        rk, fk = li.lstm_infer_cuda(tp, x_tm, st, compute_dtype=BF16)
        rp, cp = li.lstm_infer_sliced_plain(tp, x_tm, st.c, st.r,
                                            compute_dtype=BF16)
        r32, c32 = li.lstm_infer_sliced_plain(tp, x_tm, st.c, st.r)
    assert (li.BF16_LAUNCHES, li.LAUNCHES) == (1, 0)
    for n, a, b, c in (("r", rk, rp, r32), ("c_T", fk.c, cp, c32)):
        if S * T * C >= 256 * 20 * 800:
            ka, pa, fa = (v.double().cpu().numpy() for v in (a, b, c))
            err, dist = rms(ka - pa), rms(pa - fa)
            print(f"flagship K5 {n}: error {err:.3e}, distance {dist:.3e}, "
                  f"error/distance {err / dist:.4f} (the tenth alone)")
        bf16_distance_close(n, a, b, c)


@pytest.mark.gpu
@pytest.mark.parametrize("cv", [False, True])
def test_grouped_bf16_step_matches_eager_bf16_steps(cuda_device, tmp_path,
                                                    cv):
    """Three bf16 groups of 3 (an eager warm-up group, the capture, a
    replay) against nine eager bf16 steps: params, momentum, states and
    statistics bitwise, the same launches, all of them bf16."""
    from kaldi_lstm_tpu_torch.train.optim import init_momentum
    from kaldi_lstm_tpu_torch.train.trainer import (
        TrainOptions,
        make_grouped_train_step,
        make_train_step,
        place_batch,
    )
    from test_torch_grouped import S, t_sched, write_model
    from test_torch_grouped import write_corpus as write_grouped_corpus
    feats, post = write_grouped_corpus(tmp_path, n=30)
    path = write_model(tmp_path)
    batches = list(t_sched(feats, post))[:9]
    opts = TrainOptions(learn_rate=0.02, momentum=0.9)
    out = {}
    for grouped in (False, True):
        nnet, params = Nnet.read(path, "cuda")
        nnet.set_matmul_dtype(BF16)
        opt, states = init_momentum(params), nnet.init_states(S, "cuda")
        lr = torch.tensor(0.02, device="cuda")
        before = counts.launch_counts()
        rows = []
        if grouped:
            g = make_grouped_train_step(nnet, opts, None, cv, device="cuda",
                                        group=3)
            for k in range(3):
                host = [torch.stack(x) for x in zip(*(
                    place_batch(b, "cpu") for b in batches[3 * k:3 * k + 3]))]
                params, opt, states, aux = g(params, opt, states, (), *host,
                                             lr)
                rows.append(aux)
        else:
            step = make_train_step(nnet, opts, None, cv, device="cuda")
            for b in batches:
                params, opt, states, aux = step(
                    params, opt, states, (), *place_batch(b, "cuda"), lr)
                rows.append(torch.stack([a.float() for a in aux])[None])
        torch.cuda.synchronize()
        out[grouped] = ([x.clone() for x in tree_leaves((params, opt.corr,
                                                         states))],
                        torch.cat(rows),
                        {k: v - before[k]
                         for k, v in counts.launch_counts().items()})
    (pe, ae, ce), (pg, ag, cg) = out[False], out[True]
    for a, b in zip(pe, pg):
        assert torch.equal(a, b)
    assert torch.equal(ae, ag)
    assert ce == cg
    assert all(v == 0 for k, v in ce.items() if not k.endswith("_bf16"))
    assert (ce["lstmp_infer_bf16"] > 0) == cv
    assert (ce["lstmp_train_fwd_bf16"] > 0) != cv
