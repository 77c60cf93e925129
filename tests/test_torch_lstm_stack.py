"""The port's two-layer wavefront ops (`ops/lstm_stack.py`: K6 training
forward with both layers' residuals, K7 inference forward) against the
JAX package's `_fwd2_call` / `_infer2_call` run in interpret mode, as
tests/test_lstm_stack.py runs them: the same numpy-made weights, inputs
and nonzero initial states handed to both, at every time block.

The JAX kernels return padded arrays (streams to 8, lanes to 128, gate
blocks padded each, one dummy time block: layer 1 valid at [:T], layer 2
at [tb:tb + T]); the port returns unpadded [T, S, .] arrays, so the JAX
side is sliced. Tolerance rtol = atol = 1e-5, float32 on both sides, as
tests/test_lstm_stack.py holds the wavefront to the serial scans: layer
2's hoisted input projection sums in another order than a per-step one
(~1e-7). The `gpu`-marked tests hold the CUDA kernels to the plain
versions on the card.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from kaldi_lstm_tpu.ops import lstm_stack_pallas as w2
from kaldi_lstm_tpu.ops.lstm_cell import LstmParams as JLstmParams
from kaldi_lstm_tpu.ops.lstm_cell import LstmState as JLstmState
from kaldi_lstm_tpu.ops.lstm_pallas import _plan_dims
from kaldi_lstm_tpu_torch.convert import params_from_numpy
from kaldi_lstm_tpu_torch.models import Nnet
from kaldi_lstm_tpu_torch.models.components import LstmProjectedStreams
from kaldi_lstm_tpu_torch.ops import lstm_stack as ls
from kaldi_lstm_tpu_torch.ops import lstm_train as lt
from kaldi_lstm_tpu_torch.ops.lstm_cell import LstmState

S, T, I, C, R = 6, 20, 12, 24, 16
CLIP = 0.4  # small so the clip engages in both layers
TOL = dict(rtol=1e-5, atol=1e-5)


def _lstm_np(rng, i, c, r, scale=0.3):
    def u(*shape):
        return rng.uniform(-scale, scale, shape).astype(np.float32)
    return JLstmParams(w_gifo_x=u(4 * c, i), w_gifo_r=u(4 * c, r),
                       bias=u(4 * c), peephole_i_c=u(c), peephole_f_c=u(c),
                       peephole_o_c=u(c), w_r_m=u(r, c))


def make(seed=0, s=S, t=T, i=I, c=C, r=R, device="cpu"):
    """Numpy weights, time-major x and both initial states; returns
    (jax operands, port operands)."""
    rng = np.random.RandomState(seed)
    p1, p2 = _lstm_np(rng, i, c, r), _lstm_np(rng, r, c, r)
    x = rng.randn(t, s, i).astype(np.float32)
    st = [(rng.randn(s, c) * 0.1).astype(np.float32),
          (rng.randn(s, r) * 0.1).astype(np.float32),
          (rng.randn(s, c) * 0.1).astype(np.float32),
          (rng.randn(s, r) * 0.1).astype(np.float32)]
    nnet = Nnet([LstmProjectedStreams(i, r, c), LstmProjectedStreams(r, r, c)])
    tp1, tp2 = params_from_numpy(nnet, (p1, p2), device)
    ts = [torch.tensor(a, device=device) for a in st]
    port = (tp1, tp2, torch.tensor(x, device=device),
            LstmState(ts[0], ts[1]), LstmState(ts[2], ts[3]))
    jx = (JLstmParams(*map(jnp.asarray, p1)),
          JLstmParams(*map(jnp.asarray, p2)), jnp.asarray(x),
          JLstmState(jnp.asarray(st[0]), jnp.asarray(st[1])),
          JLstmState(jnp.asarray(st[2]), jnp.asarray(st[3])))
    return jx, port


def _jax_prep(jx, tb):
    d = _plan_dims(S, T, I, C, R)._replace(tb=tb)
    return d, w2._prep2(*jx, d, True)


def _gates(a, d, lo):
    """Padded JAX gates [Tp, sp, 4cp] -> [T, S, 4C] from time row lo."""
    a = np.asarray(a)[lo:lo + T, :S].reshape(T, S, 4, d.cp)[..., :C]
    return a.reshape(T, S, 4 * C)


def _jax_fwd2(jx, tb, phases="both"):
    d, ops = _jax_prep(jx, tb)
    g1, c1, r1, g2, c2, r2 = w2._fwd2_call(
        *ops, st=d.st, tb=tb, cell_clip=CLIP, gifo_dtype=jnp.float32,
        interpret=True, phases=phases)
    l1 = (_gates(g1, d, 0), np.asarray(c1)[:T, :S, :C],
          np.asarray(r1)[:T, :S, :R])
    l2 = (_gates(g2, d, tb), np.asarray(c2)[tb:tb + T, :S, :C],
          np.asarray(r2)[tb:tb + T, :S, :R])
    return l1 + l2


@pytest.mark.parametrize("tb", [5, 4, 2, 1])
def test_fwd2_plain_matches_jax_interpret(tb):
    jx, port = make(seed=tb)
    ls.reset_counts()
    got = ls.lstm_stack_fwd2(*port, CLIP, tb=tb)
    assert (ls.FWD2_LAUNCHES, ls.PLAIN_CALLS) == (0, 1)
    want = _jax_fwd2(jx, tb)
    names = ("gifo1", "c1", "r1", "gifo2", "c2", "r2")
    for name, a, b in zip(names, got, want):
        assert a.shape == b.shape, name
        np.testing.assert_allclose(a.numpy(), b, **TOL, err_msg=name)
    assert bool((got[1].abs() == CLIP).any()), "the clip never engaged"


@pytest.mark.parametrize("tb", [5, 4, 2, 1])
def test_infer2_plain_matches_jax_interpret(tb):
    jx, port = make(seed=10 + tb)
    d, ops = _jax_prep(jx, tb)
    r2, c1T, r1T, c2T = w2._infer2_call(*ops, st=d.st, tb=tb, cell_clip=CLIP,
                                        interpret=True)
    ls.reset_counts()
    got_r2, f1, f2 = ls.lstm_stack_infer2(*port, CLIP, tb=tb)
    assert (ls.INFER2_LAUNCHES, ls.PLAIN_CALLS) == (0, 1)
    want_r2 = np.asarray(r2)[tb:tb + T, :S, :R]
    np.testing.assert_allclose(got_r2.numpy(), want_r2, **TOL)
    np.testing.assert_allclose(f1.c.numpy(), np.asarray(c1T)[:S, :C], **TOL)
    np.testing.assert_allclose(f1.r.numpy(), np.asarray(r1T)[:S, :R], **TOL)
    np.testing.assert_allclose(f2.c.numpy(), np.asarray(c2T)[:S, :C], **TOL)
    np.testing.assert_allclose(f2.r.numpy(), want_r2[T - 1], **TOL)


@pytest.mark.parametrize("dims2", [
    (R, C, R),          # the deep config's shape: compatible
    (R, C + 8, R),      # cell widths differ
    (R, C, R + 4),      # projection widths differ
    (R + 1, C, R),      # layer 2 does not take layer 1's output
])
def test_stack_compatible_matches_jax(dims2):
    rng = np.random.RandomState(0)
    p1, p2 = _lstm_np(rng, I, C, R), _lstm_np(rng, *dims2)
    nnet = Nnet([LstmProjectedStreams(I, R, C),
                 LstmProjectedStreams(dims2[0], dims2[2], dims2[1])])
    tp1, tp2 = params_from_numpy(nnet, (p1, p2))
    assert ls.stack_compatible(tp1, tp2) == w2.stack_compatible(
        JLstmParams(*map(jnp.asarray, p1)), JLstmParams(*map(jnp.asarray, p2)))


def test_phase_l1_matches_jax_live_phase():
    """The ablation's live phase: with "l1" layer 1's residuals are the
    JAX kernel's (its layer-2 outputs are uninitialised there; the plain
    version leaves them zero)."""
    jx, port = make(seed=21)
    got = ls.lstm_stack_fwd2(*port, CLIP, tb=5, phases="l1")
    want = _jax_fwd2(jx, 5, phases="l1")
    for a, b in zip(got[:3], want[:3]):
        np.testing.assert_allclose(a.numpy(), b, **TOL)
    assert all(not t.any() for t in got[3:])


def test_phase_l2_runs_layer2_over_zero_input():
    """With "l2" layer 1 never runs: layer 2 runs over r1 = 0 (the JAX
    kernel's r1 ring is uninitialised there, so only the definition is
    checked)."""
    _, (p1, p2, x, s1, s2) = make(seed=22)
    got = ls.lstm_stack_fwd2(p1, p2, x, s1, s2, CLIP, tb=4, phases="l2")
    want = lt.lstm_fwd_residuals_plain(p2, torch.zeros(T, S, R), s2.c, s2.r,
                                       cell_clip=CLIP)
    assert all(not t.any() for t in got[:3])
    for a, b in zip(got[3:], want):
        torch.testing.assert_close(a, b, rtol=0, atol=0)


@pytest.mark.parametrize("t,tb,want", [
    (20, None, 5), (12, None, 4), (23, None, 1), (9, None, 3), (1, None, 1),
    (20, 2, 2), (20, 20, 20), (23, 1, 1),
    (20, 3, ValueError), (20, 0, ValueError), (20, 2.0, ValueError),
    (0, None, ValueError),
])
def test_time_block(t, tb, want):
    if want is ValueError:
        with pytest.raises(ValueError):
            ls.time_block(t, tb)
    else:
        assert ls.time_block(t, tb) == want


def test_launch_counts_per_call():
    # K6: the Wr interleave of the running layers, layer 1's hoisted input
    # projection, layer 2's per time block (K of them), and one gates and
    # one projection launch per wavefront step (T + tb of them with both
    # layers, T with one); K7: one persistent launch whatever tb is
    assert ls.wavefront_launches(20, 5) == 2 + 4 + 2 * 25
    assert ls.wavefront_launches(20, 1) == 2 + 20 + 2 * 21
    assert ls.wavefront_launches(20, 5, "l1") == 2 + 40
    assert ls.wavefront_launches(20, 5, "l2") == 1 + 4 + 40
    for tb in (5, 4, 2, 1):
        assert ls.wavefront_launches(20, tb, kernel="infer2") == 1
    with pytest.raises(ValueError):
        ls.wavefront_launches(20, 5, "l1", kernel="infer2")
    with pytest.raises(ValueError):
        ls.wavefront_launches(20, 5, kernel="fwd3")


def test_dispatch_rejects_bad_operands():
    _, (p1, p2, x, s1, s2) = make(seed=23)
    ls.reset_counts()
    with pytest.raises(ValueError):
        ls.lstm_stack_fwd2(p1, p2, x, s1, s2, CLIP, tb=3)
    with pytest.raises(ValueError):
        ls.lstm_stack_fwd2(p1, p2, x, s1, s2, CLIP, phases="l3")
    with pytest.raises(ValueError):   # layer 2 fed the features
        ls.lstm_stack_infer2(p1, p1, x, s1, s1, CLIP)
    with pytest.raises(TypeError):
        ls.lstm_stack_infer2(p1, p2, x.double(), s1, s2, CLIP)
    with pytest.raises(ValueError):
        ls.lstm_stack_infer2(p1, p2, x[0], s1, s2, CLIP)
    assert ls.PLAIN_CALLS == 0


# ---------------------------------------------------------------------------
# on the card
# ---------------------------------------------------------------------------

@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card (the kernels have no CPU mode); run "
                    "on the card with: python -m pytest -m gpu "
                    "tests/test_torch_lstm_stack.py")
    return torch.device("cuda")


def _close(a, b):
    """1e-4 x (1 + max|plain|), chip_smoke.py's TRAIN_TOL rule."""
    scale = 1.0 + float(b.abs().max())
    assert float((a - b).abs().max()) <= 1e-4 * scale


@pytest.mark.gpu
@pytest.mark.parametrize("tb", [5, 4, 2, 1])
def test_cuda_fwd2_and_infer2_match_plain(cuda_device, tb):
    _, port = make(seed=30 + tb, s=10, i=37, c=200, r=130, device=cuda_device)
    ls.reset_counts()
    got = ls.lstm_stack_fwd2(*port, CLIP, tb=tb)
    want = ls.lstm_stack_fwd2_plain(*port, CLIP)
    r2, f1, f2 = ls.lstm_stack_infer2(*port, CLIP, tb=tb)
    ref = ls.lstm_stack_infer2_plain(*port, CLIP)
    torch.cuda.synchronize()
    assert ls.FWD2_LAUNCHES == ls.wavefront_launches(T, tb)
    assert ls.INFER2_LAUNCHES == ls.wavefront_launches(T, tb,
                                                       kernel="infer2")
    assert ls.PLAIN_CALLS == 0
    for a, b in zip(got, want):
        _close(a, b)
    for a, b in ((r2, ref[0]), (f1.c, ref[1].c), (f1.r, ref[1].r),
                 (f2.c, ref[2].c), (f2.r, ref[2].r)):
        _close(a, b)


@pytest.mark.gpu
def test_cuda_fwd2_residuals_give_k1_gradients(cuda_device):
    """K6's residuals through K2 give the gradients of K1's residuals
    through K2, for both layers (layer 2 with dx): K6 runs K1's tiles."""
    p1, p2, x, s1, s2 = make(seed=40, s=9, i=37, c=200, r=130,
                             device=cuda_device)[1]
    g1, c1, r1, g2, c2, r2 = ls.lstm_stack_fwd2(p1, p2, x, s1, s2, CLIP, tb=5)
    rng = np.random.RandomState(41)
    g_r = torch.tensor(rng.randn(T, 9, 130).astype(np.float32),
                       device=cuda_device)
    gcT = torch.tensor(rng.randn(9, 200).astype(np.float32),
                       device=cuda_device)
    k1a = lt.lstm_fwd_residuals_cuda(p1, x, s1.c, s1.r, cell_clip=CLIP)
    k1b = lt.lstm_fwd_residuals_cuda(p2, k1a[2], s2.c, s2.r, cell_clip=CLIP)
    for p, xin, s, res, ref, dx in ((p1, x, s1, (g1, c1, r1), k1a, False),
                                    (p2, r1, s2, (g2, c2, r2), k1b, True)):
        xin_ref = x if p is p1 else k1a[2]
        a = lt.lstm_bwd_cuda(p, xin, s.c, s.r, *res, None, 1.0, g_r, gcT, dx)
        b = lt.lstm_bwd_cuda(p, xin_ref, s.c, s.r, *ref, None, 1.0, g_r, gcT,
                             dx)
        for u, v in zip(a[0], b[0]):
            _close(u, v)
        for u, v in zip(a[1:], b[1:]):
            if v is not None:
                _close(u, v)


@pytest.mark.gpu
def test_cuda_phases_live_layer(cuda_device):
    _, port = make(seed=50, s=10, i=37, c=200, r=130, device=cuda_device)
    want = ls.lstm_stack_fwd2_plain(*port, CLIP, phases="l1")
    got = ls.lstm_stack_fwd2(*port, CLIP, tb=5, phases="l1")
    for a, b in zip(got[:3], want[:3]):
        _close(a, b)
    want = ls.lstm_stack_fwd2_plain(*port, CLIP, phases="l2")
    got = ls.lstm_stack_fwd2(*port, CLIP, tb=5, phases="l2")
    for a, b in zip(got[3:], want[3:]):
        _close(a, b)
