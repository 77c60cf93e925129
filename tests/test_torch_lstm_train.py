"""The port's `lstm_train` (K1 forward with residuals, K2 BPTT, behind one
autograd Function; on the CPU their plain versions) against the JAX
package's `lstm_scan_pallas` run in interpret mode, as
tests/test_pallas.py runs it: forward outputs, final state and every
gradient, with the same numpy-made inputs, keep-mask and cotangents
handed to both.

Tolerance: float32 on both sides at rtol = atol = 1e-5, as
tests/test_torch_lstm_cell.py (the products and frame sums are taken in
different orders in XLA and PyTorch; differences are ~1e-7).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from kaldi_lstm_tpu.ops import LstmState as JLstmState
from kaldi_lstm_tpu.ops.lstm_cell import LstmParams as JLstmParams
from kaldi_lstm_tpu.ops.lstm_pallas import (
    _lstm_pallas_fwd,
    lstm_scan_pallas,
)
from kaldi_lstm_tpu_torch.models import Nnet
from kaldi_lstm_tpu_torch.ops import lstm_infer as li
from kaldi_lstm_tpu_torch.ops import lstm_train as lt
from kaldi_lstm_tpu_torch.ops.lstm_cell import LstmParams, LstmState

TOL = dict(rtol=1e-5, atol=1e-5)


def make(S, T, I, C, R, seed=0, scale=0.3, x_scale=1.0, keep=None,
         time_major=False):
    rng = np.random.RandomState(seed)

    def u(*shape):
        return rng.uniform(-scale, scale, shape).astype(np.float32)

    p = dict(w_gifo_x=u(4 * C, I), w_gifo_r=u(4 * C, R), bias=u(4 * C),
             peephole_i_c=u(C), peephole_f_c=u(C), peephole_o_c=u(C),
             w_r_m=u(R, C))
    lead = (T, S) if time_major else (S, T)
    x = (rng.randn(*lead, I) * x_scale).astype(np.float32)
    c0 = (rng.randn(S, C) * 0.5).astype(np.float32)
    r0 = (rng.randn(S, R) * 0.5).astype(np.float32)
    mask = None if keep is None else rng.rand(*lead, 4 * C) < keep
    cot = ((rng.randn(*lead, R)).astype(np.float32),
           rng.randn(S, C).astype(np.float32),
           rng.randn(S, R).astype(np.float32))
    return p, x, c0, r0, mask, cot


def jax_run(p, x, c0, r0, mask, cot, clip, time_major, keep, need_dx):
    jp = JLstmParams(**{k: jnp.asarray(v) for k, v in p.items()})

    def f(params, xx, c, r):
        out, fin = lstm_scan_pallas(
            params, xx, JLstmState(c=c, r=r), clip, interpret=True,
            time_major=time_major,
            gate_keep_mask=None if mask is None else jnp.asarray(mask),
            keep_prob=1.0 if keep is None else keep,
            need_input_grad=need_dx)
        return out, fin.c, fin.r

    outs, vjp = jax.vjp(f, jp, jnp.asarray(x), jnp.asarray(c0),
                        jnp.asarray(r0))
    gp, gx, gc, gr = vjp(tuple(jnp.asarray(c) for c in cot))
    return [np.asarray(o) for o in outs], gp, gx, gc, gr


def torch_run(p, x, c0, r0, mask, cot, clip, time_major, keep, need_dx):
    tp = LstmParams(**{k: torch.tensor(v, requires_grad=True)
                       for k, v in p.items()})
    tx = torch.tensor(x, requires_grad=True)
    tc = torch.tensor(c0, requires_grad=True)
    tr = torch.tensor(r0, requires_grad=True)
    out, fin = lt.lstm_train(
        tp, tx, LstmState(c=tc, r=tr), clip, time_major=time_major,
        gate_keep_mask=None if mask is None else torch.from_numpy(mask),
        keep_prob=1.0 if keep is None else keep, need_input_grad=need_dx)
    torch.autograd.backward([out, fin.c, fin.r],
                            [torch.from_numpy(c) for c in cot])
    return [out, fin.c, fin.r], tp, tx, tc, tr


CASES = {
    # name: (S, T, I, C, R, clip, time_major, keep, need_dx, x_scale,
    #        weight scale; the wide case keeps pre-activations O(1), as
    #        in a trained net, so float32 rounding stays near 1e-7)
    "nonzero_state": (3, 5, 7, 9, 6, 50.0, False, None, True, 1.0, 0.3),
    "clip_active": (3, 5, 7, 9, 6, 0.5, False, None, True, 5.0, 0.3),
    "keep_mask": (3, 5, 7, 9, 6, 50.0, False, 0.8, True, 1.0, 0.3),
    "no_input_grad": (3, 5, 7, 9, 6, 50.0, False, None, False, 1.0, 0.3),
    "time_major": (3, 5, 7, 9, 6, 50.0, True, None, True, 1.0, 0.3),
    "ragged_mask_time_major": (2, 4, 5, 200, 130, 0.1, True, 0.7, True,
                               3.0, 0.05),
}


@pytest.mark.parametrize("case", list(CASES))
def test_lstm_train_matches_pallas_forward_and_gradients(case):
    S, T, I, C, R, clip, tm, keep, need_dx, xs, scale = CASES[case]
    p, x, c0, r0, mask, cot = make(S, T, I, C, R, scale=scale, x_scale=xs,
                                   keep=keep, time_major=tm)
    j_outs, jgp, jgx, jgc, jgr = jax_run(p, x, c0, r0, mask, cot, clip, tm,
                                         keep, need_dx)
    lt.reset_counts()
    t_outs, tp, tx, tc, tr = torch_run(p, x, c0, r0, mask, cot, clip, tm,
                                       keep, need_dx)
    assert (lt.FWD_LAUNCHES, lt.BWD_LAUNCHES, lt.PLAIN_CALLS) == (0, 0, 2)
    if clip < 1.0:
        assert (t_outs[1].abs() == clip).any(), "the clip never engaged"
    for a, b in zip(t_outs, j_outs):
        np.testing.assert_allclose(a.detach().numpy(), b, **TOL)
    for name in JLstmParams._fields:
        np.testing.assert_allclose(getattr(tp, name).grad.numpy(),
                                   np.asarray(getattr(jgp, name)),
                                   err_msg=name, **TOL)
    np.testing.assert_allclose(tc.grad.numpy(), np.asarray(jgc), **TOL)
    np.testing.assert_allclose(tr.grad.numpy(), np.asarray(jgr), **TOL)
    if need_dx:
        np.testing.assert_allclose(tx.grad.numpy(), np.asarray(jgx), **TOL)
    else:
        # JAX returns symbolic zeros; the port computes no dx at all
        assert tx.grad is None
        assert not np.asarray(jgx).any()


def test_lstm_train_chunk_chaining_matches_pallas():
    """Two chunks, the first's final state carried into the second
    without detaching: the gradient flows back through both."""
    S, T, I, C, R = 3, 4, 5, 9, 6
    p, x, c0, r0, _, _ = make(S, 2 * T, I, C, R, seed=3)
    rng = np.random.RandomState(4)
    g = rng.randn(S, 2 * T, R).astype(np.float32)
    jp = JLstmParams(**{k: jnp.asarray(v) for k, v in p.items()})

    def jf(params, xx, c, r):
        st = JLstmState(c=c, r=r)
        o1, st = lstm_scan_pallas(params, xx[:, :T], st, interpret=True)
        o2, st = lstm_scan_pallas(params, xx[:, T:], st, interpret=True)
        return jnp.sum(jnp.concatenate([o1, o2], 1) * g)

    jg = jax.grad(jf, argnums=(0, 1, 2, 3))(
        jp, jnp.asarray(x), jnp.asarray(c0), jnp.asarray(r0))
    tp = LstmParams(**{k: torch.tensor(v, requires_grad=True)
                       for k, v in p.items()})
    tx = torch.tensor(x, requires_grad=True)
    st = LstmState(c=torch.tensor(c0, requires_grad=True),
                   r=torch.tensor(r0, requires_grad=True))
    o1, st1 = lt.lstm_train(tp, tx[:, :T], st)
    o2, _ = lt.lstm_train(tp, tx[:, T:], st1)
    (torch.cat([o1, o2], 1) * torch.from_numpy(g)).sum().backward()
    for name in JLstmParams._fields:
        np.testing.assert_allclose(getattr(tp, name).grad.numpy(),
                                   np.asarray(getattr(jg[0], name)),
                                   err_msg=name, **TOL)
    for got, ref in ((tx.grad, jg[1]), (st.c.grad, jg[2]),
                     (st.r.grad, jg[3])):
        np.testing.assert_allclose(got.numpy(), np.asarray(ref), **TOL)


@pytest.mark.parametrize("keep", [None, 0.75])
def test_fwd_residuals_plain_match_pallas_fwd_kernel(keep):
    """K1's outputs (post-activation gates, clipped c, r for every t)
    against the residuals the Pallas forward kernel writes."""
    S, T, I, C, R = 3, 5, 7, 9, 6
    p, x, c0, r0, mask, _ = make(S, T, I, C, R, x_scale=4.0, keep=keep,
                                 time_major=True)
    jp = JLstmParams(**{k: jnp.asarray(v) for k, v in p.items()})
    inv_keep = 1.0 if keep is None else 1.0 / keep
    (_, _), res = _lstm_pallas_fwd(
        jp, jnp.asarray(x), JLstmState(c=jnp.asarray(c0),
                                       r=jnp.asarray(r0)),
        None if mask is None else jnp.asarray(mask), 1.0, True, True,
        inv_keep, True)
    gifo_p, c_p, r_p = (np.asarray(a) for a in res[2:5])
    cp = gifo_p.shape[2] // 4
    gifo_ref = gifo_p[:, :S].reshape(T, S, 4, cp)[..., :C].reshape(
        T, S, 4 * C)
    tp = LstmParams(**{k: torch.from_numpy(v) for k, v in p.items()})
    m8 = None if mask is None else torch.from_numpy(mask).to(torch.int8)
    gifo, c_seq, r_seq = lt.lstm_fwd_residuals_plain(
        tp, torch.from_numpy(x), torch.from_numpy(c0), torch.from_numpy(r0),
        m8, inv_keep, 1.0)
    assert (c_seq.abs() == 1.0).any()
    np.testing.assert_allclose(gifo.numpy(), gifo_ref, **TOL)
    np.testing.assert_allclose(c_seq.numpy(), c_p[:, :S, :C], **TOL)
    np.testing.assert_allclose(r_seq.numpy(), r_p[:, :S, :R], **TOL)


SPLIT_CASES = {
    # name: (S, T, I, C, R, clip, keep, need_dx, x_scale, weight scale,
    #        SMs): the wide cases split the per-step dr and dx over 4C,
    #        the long ones the frame-axis products over T S
    "no_split": (3, 5, 7, 9, 6, 50.0, None, True, 1.0, 0.3, 132),
    "dr_dx_split_dropout": (2, 4, 5, 200, 130, 0.1, 0.7, True, 3.0, 0.05,
                            132),
    "dr_split_no_dx": (3, 3, 6, 200, 40, 50.0, None, False, 1.0, 0.05, 132),
    "frame_split_dropout": (64, 10, 5, 9, 6, 50.0, 0.8, True, 1.0, 0.3, 132),
    "frame_split_no_dx": (64, 10, 5, 9, 6, 50.0, None, False, 1.0, 0.3, 16),
}


@pytest.mark.parametrize("case", list(SPLIT_CASES))
def test_bwd_split_decomposition_matches_pallas(case):
    """K2's decomposition (`lstm_bwd_split_plain`: dgifo, dr_total, h o
    and dxw materialised by the serial loop, the per-step dr as split-K
    partials added in order, the four frame-axis products from the
    materialised operands, r_prev made contiguous) against
    `lstm_scan_pallas`'s gradients."""
    S, T, I, C, R, clip, keep, need_dx, xs, scale, sms = SPLIT_CASES[case]
    p, x, c0, r0, mask, cot = make(S, T, I, C, R, scale=scale, x_scale=xs,
                                   keep=keep, time_major=True)
    _, jgp, jgx, jgc, jgr = jax_run(p, x, c0, r0, mask, cot, clip, True,
                                    keep, need_dx)
    plan = lt.bwd_plan(T, S, I, C, R, sms)
    if case != "no_split":
        assert max(plan.values()) > 1, plan
    tp = LstmParams(**{k: torch.from_numpy(v) for k, v in p.items()})
    args = [torch.from_numpy(a) for a in (x, c0, r0)]
    m8 = None if mask is None else torch.from_numpy(mask).to(torch.int8)
    ik = 1.0 if keep is None else 1.0 / keep
    res = lt.lstm_fwd_residuals_plain(tp, *args, m8, ik, clip)
    g_r = torch.from_numpy(cot[0]).clone()
    g_r[T - 1] += torch.from_numpy(cot[2])
    dp, dx, dc0, dr0 = lt.lstm_bwd_split_plain(
        tp, *args, *res, m8, ik, g_r, torch.from_numpy(cot[1]), need_dx,
        sms)
    for name in JLstmParams._fields:
        np.testing.assert_allclose(getattr(dp, name).numpy(),
                                   np.asarray(getattr(jgp, name)),
                                   err_msg=name, **TOL)
    np.testing.assert_allclose(dc0.numpy(), np.asarray(jgc), **TOL)
    np.testing.assert_allclose(dr0.numpy(), np.asarray(jgr), **TOL)
    if need_dx:
        np.testing.assert_allclose(dx.numpy(), np.asarray(jgx), **TOL)
    else:
        assert dx is None


def test_bwd_plan_fills_the_card_at_the_flagship_shape():
    """The per-step dr and dWx at I=40 have too few 64 x 64 tiles to fill
    132 SMs and are split; dWr has enough; every split is at least 8
    stages deep."""
    plan = lt.bwd_plan(20, 256, 40, 800, 512)
    assert plan == {"dr": 9, "wx": 6, "wr": 1, "wrm": 3, "dx": 4}
    assert lt.bwd_plan(20, 256, 512, 800, 512)["wx"] == 1
    assert lt.bwd_launches(20, False) == 45
    assert lt.bwd_launches(20, True) == 46


def test_lstm_train_empty_time_keeps_state():
    p, x, c0, r0, _, _ = make(2, 3, 4, 5, 3)
    tp = LstmParams(**{k: torch.from_numpy(v) for k, v in p.items()})
    st = LstmState(c=torch.from_numpy(c0), r=torch.from_numpy(r0))
    out, fin = lt.lstm_train(tp, torch.from_numpy(x)[:, :0], st)
    assert out.shape == (2, 0, 3) and fin is st


def test_component_routes_training_to_lstm_train():
    """A gradient-needing call of an LSTM component goes to lstm_train,
    an inference call to lstm_infer; a dropout keep-mask from the
    component's generator reaches lstm_train as well."""
    proto = """<NnetProto>
<Transmit> <InputDim> 4 <OutputDim> 4
<LstmProjectedStreams> <InputDim> 4 <OutputDim> 3 <CellDim> 5 <NumStream> 2 <DropoutRate> 0.25
</NnetProto>"""
    nnet, params = Nnet.init_from_proto(
        proto, torch.Generator().manual_seed(1), "cpu")
    x = torch.randn(2, 6, 4)
    lt.reset_counts()
    li.reset_counts()
    with torch.no_grad():
        nnet.propagate(params, x)
    assert (li.PLAIN_CALLS, lt.PLAIN_CALLS) == (1, 0)
    with torch.no_grad():
        y1, _ = nnet.propagate(params, x, rng=torch.Generator().manual_seed(
            5), train=True)
        y2, _ = nnet.propagate(params, x, rng=torch.Generator().manual_seed(
            5), train=True)
    assert (li.PLAIN_CALLS, lt.PLAIN_CALLS) == (1, 1 + 1)
    assert torch.equal(y1, y2)
    live = tuple(type(p)(*(t.requires_grad_() for t in p)) if p else p
                 for p in params)
    y, _ = nnet.propagate(live, x)
    y.sum().backward()
    assert lt.PLAIN_CALLS == 2 + 2 and li.PLAIN_CALLS == 1
    assert live[1].w_gifo_x.grad is not None


@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card (the K1/K2 kernels have no CPU "
                    "mode); run on the card with: python -m pytest -m gpu "
                    "tests/test_torch_lstm_train.py")
    return torch.device("cuda")


@pytest.mark.gpu
@pytest.mark.parametrize("S,T,I,C,R,keep,need_dx", [
    (8, 6, 40, 800, 512, None, False),
    (3, 7, 37, 200, 130, 0.8, True),
    (1, 1, 1, 1, 1, None, True),
    (32, 6, 512, 800, 512, 0.8, True),   # the deep net's layer 2
])
def test_cuda_kernels_match_plain_versions(cuda_device, S, T, I, C, R, keep,
                                           need_dx):
    """Tolerance 1e-4 abs + 1e-4 rel to each tensor's largest entry: both
    float32; K2's frame sums run in another order than the plain
    version's matmuls (see chip_smoke.py)."""
    p, x, c0, r0, mask, cot = make(S, T, I, C, R, scale=0.1, keep=keep,
                                   time_major=True)
    dev = cuda_device
    tp = LstmParams(**{k: torch.tensor(v, device=dev) for k, v in p.items()})
    args = [torch.tensor(a, device=dev) for a in (x, c0, r0)]
    m8 = None if mask is None else \
        torch.tensor(mask, device=dev).to(torch.int8)
    ik = 1.0 if keep is None else 1.0 / keep
    lt.reset_counts()
    fk = lt.lstm_fwd_residuals_cuda(tp, *args, m8, ik, 1.0)
    fp = lt.lstm_fwd_residuals_plain(tp, *args, m8, ik, 1.0)
    g_r, gc = (torch.tensor(cot[0], device=dev),
               torch.tensor(cot[1], device=dev))
    bk = lt.lstm_bwd_cuda(tp, *args, *fp, m8, ik, g_r, gc, need_dx)
    bp = lt.lstm_bwd_plain(tp, *args, *fp, m8, ik, g_r, gc, need_dx)
    torch.cuda.synchronize()
    assert lt.FWD_LAUNCHES == 2 * T
    assert lt.BWD_LAUNCHES == lt.bwd_launches(T, need_dx)
    got = [*fk, *bk[0], bk[2], bk[3]] + ([bk[1]] if need_dx else [])
    ref = [*fp, *bp[0], bp[2], bp[3]] + ([bp[1]] if need_dx else [])
    for a, b in zip(got, ref):
        tol = 1e-4 * (1.0 + float(b.abs().max()))
        assert float((a - b).abs().max()) <= tol
    assert bk[1] is None if not need_dx else bk[1] is not None
