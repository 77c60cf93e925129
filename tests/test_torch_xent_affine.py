"""The port's `fused_affine_xent` (K3 forward, K4 backward behind one
autograd Function; on the CPU their plain versions) against the JAX
package's `fused_affine_xent` run in interpret mode: loss, xent,
entropy, correct and frames, and the gradients in r, w and b, with the
same numpy-made inputs handed to both. K3's split over class chunks
(`xent_fwd_chunked_plain`) against the Pallas forward kernel's outputs.

Tolerances as tests/test_xent_pallas.py: rtol 1e-5 on the loss and the
statistics, rtol 1e-4 / atol 1e-5 on the gradients (float32; the class
sums run in other orders).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from kaldi_lstm_tpu.ops import xent_pallas as xp
from kaldi_lstm_tpu.ops.xent_pallas import fused_affine_xent as j_fused
from kaldi_lstm_tpu_torch.ops import xent_affine as xa
from kaldi_lstm_tpu_torch.train.loss import masked_xent_loss

GRAD_TOL = dict(rtol=1e-4, atol=1e-5)


def make(N, R, K, Km, seed=0, bias_scale=0.1, mask_p=0.8):
    rng = np.random.RandomState(seed)
    r = rng.randn(N, R).astype(np.float32)
    w = (rng.randn(K, R) * 0.3).astype(np.float32)
    b = (rng.randn(K) * bias_scale).astype(np.float32)
    ids = rng.randint(0, K, (N, Km)).astype(np.int32)
    tw = rng.rand(N, Km).astype(np.float32)
    if Km > 1:
        tw[:, -1] = 0.0   # an empty slot, as posteriors padded to Kmax
    mask = (rng.rand(N) < mask_p).astype(np.float32)
    return r, w, b, ids, tw, mask


def jax_run(r, w, b, ids, tw, mask):
    def f(rr, ww, bb):
        return j_fused(rr, ww, bb, jnp.asarray(ids), jnp.asarray(tw),
                       jnp.asarray(mask), True)

    (loss, aux), grads = jax.value_and_grad(f, argnums=(0, 1, 2),
                                            has_aux=True)(
        jnp.asarray(r), jnp.asarray(w), jnp.asarray(b))
    return float(loss), [float(a) for a in aux], \
        [np.asarray(g) for g in grads]


def torch_run(r, w, b, ids, tw, mask):
    leaves = [torch.tensor(a, requires_grad=True) for a in (r, w, b)]
    loss, aux = xa.fused_affine_xent(*leaves, torch.from_numpy(ids),
                                     torch.from_numpy(tw),
                                     torch.from_numpy(mask))
    grads = torch.autograd.grad(loss, leaves)
    return float(loss.detach()), [float(a) for a in aux], \
        [g.numpy() for g in grads]


def assert_match(t, j):
    (tl, ta, tg), (jl, ja, jg) = t, j
    np.testing.assert_allclose(tl, jl, rtol=1e-5)
    np.testing.assert_allclose(ta, ja, rtol=1e-5, atol=1e-6)
    for a, b in zip(tg, jg):
        np.testing.assert_allclose(a, b, **GRAD_TOL)


@pytest.mark.parametrize("N,R,K,Km", [(37, 13, 45, 1), (40, 20, 300, 3),
                                      (9, 130, 1100, 2)])
def test_fused_xent_matches_pallas(N, R, K, Km):
    args = make(N, R, K, Km)
    xa.reset_counts()
    t = torch_run(*args)
    assert (xa.FWD_LAUNCHES, xa.BWD_LAUNCHES, xa.PLAIN_CALLS) == (0, 0, 2)
    assert_match(t, jax_run(*args))


def test_fused_xent_matches_unfused_loss():
    """The same numbers as masked_xent_loss on the formed logits."""
    r, w, b, ids, tw, mask = make(30, 11, 50, 3)
    t = torch_run(r, w, b, ids, tw, mask)
    leaves = [torch.tensor(a, requires_grad=True) for a in (r, w, b)]
    logits = (leaves[0] @ leaves[1].T + leaves[2])[None]
    loss, aux = masked_xent_loss(logits, torch.from_numpy(ids)[None],
                                 torch.from_numpy(tw)[None],
                                 torch.from_numpy(mask)[None])
    grads = torch.autograd.grad(loss, leaves)
    assert_match(t, (float(loss.detach()), [float(a) for a in aux],
                     [g.numpy() for g in grads]))


def test_all_masked_is_zero():
    r, w, b, ids, tw, mask = make(20, 8, 40, 1)
    mask[:] = 0.0
    loss, aux, grads = torch_run(r, w, b, ids, tw, mask)
    assert loss == 0.0 and aux[3] == 0.0
    for g in grads:
        assert not g.any()
    assert_match((loss, aux, grads), jax_run(r, w, b, ids, tw, mask))


def test_large_bias_no_nan():
    """A bias of 200 would overflow exp(bias); masked rows must still
    contribute exactly 0 and no NaN may reach dW or db."""
    r, w, b, ids, tw, mask = make(24, 8, 40, 2, bias_scale=200.0,
                                  mask_p=0.5)
    t = torch_run(r, w, b, ids, tw, mask)
    for g in t[2]:
        assert np.isfinite(g).all()
    dr = t[2][0]
    assert not dr[mask == 0].any()
    assert_match(t, jax_run(r, w, b, ids, tw, mask))


def test_argmax_tie_across_tile_edge_takes_first():
    """Duplicated logits at classes 1023 and 1024 straddle the Pallas
    kernel's 1024-class tile edge (and the CUDA kernel's 64-class one):
    the first max wins, as Kaldi's FindRowMaxId. Small integers and
    powers of two keep every sum exact, so the tie is exact in any
    summation order."""
    N, R, K = 6, 8, 1100
    rng = np.random.RandomState(2)
    r = rng.randint(-2, 3, (N, R)).astype(np.float32)
    w = (rng.randint(-4, 5, (K, R)) / 8.0).astype(np.float32)
    b = np.zeros(K, np.float32)
    w[1023] = w[1024] = np.abs(r).max(0) * np.sign(r[0]) * 8.0
    ids = np.full((N, 1), 1024, np.int32)
    tw = np.ones((N, 1), np.float32)
    mask = np.ones(N, np.float32)
    lse, picked, amax, aidx = xa.xent_fwd_plain(
        *(torch.from_numpy(a) for a in (r, w, b, ids, tw)))
    assert int(aidx[0]) == 1023
    t = torch_run(r, w, b, ids, tw, mask)
    j = jax_run(r, w, b, ids, tw, mask)
    assert t[1][2] == j[1][2] == 0.0   # row 0 predicts 1023, target 1024
    assert_match(t, j)


def jax_fwd_outputs(r, w, b, ids, tw):
    """lse, picked, amax, aidx of the Pallas forward kernel (interpret
    mode) on the same inputs."""
    n = r.shape[0]
    args = [jnp.asarray(a) for a in (r, w, b, ids, tw,
                                     np.ones(n, np.float32))]
    r_p, w_p, b_p, ids_p, tw_p = xp._pad_inputs(*args)[:5]
    ft, kt = xp._tiles(n, w.shape[0])
    outs = xp._fwd_call(r_p, w_p, b_p, ids_p, tw_p, ft=ft, kt=kt,
                        interpret=True)
    return [np.asarray(o[:n, 0]) for o in outs]


def assert_fwd_match(got, want):
    """lse, picked, amax within 1e-5 (float32, other sum orders); the
    first-max index exactly."""
    for a, b in zip(got[:3], want[:3]):
        np.testing.assert_allclose(a.numpy(), b, rtol=1e-5, atol=1e-5)
    np.testing.assert_array_equal(got[3].numpy(), want[3])


@pytest.mark.parametrize("chunk", [16, 64, 128, 1024])
@pytest.mark.parametrize("N,R,K,Km", [(37, 13, 45, 1), (40, 20, 300, 3),
                                      (9, 130, 1100, 2)])
def test_chunked_forward_matches_pallas(N, R, K, Km, chunk):
    """K3's per-chunk partials merged in chunk order give the Pallas
    kernel's lse, picked logit, max and first index, whatever the chunk
    width (one chunk, a ragged last chunk, many chunks)."""
    r, w, b, ids, tw, _ = make(N, R, K, Km)
    got = xa.xent_fwd_chunked_plain(
        *(torch.from_numpy(a) for a in (r, w, b, ids, tw)), chunk)
    assert_fwd_match(got, jax_fwd_outputs(r, w, b, ids, tw))


def tie_inputs(N, R, K, tie_at, seed=2):
    """Duplicated logits at classes tie_at and tie_at + 1, the row max of
    row 0. Small integers and powers of two keep every sum exact, so the
    tie is exact in any summation order."""
    rng = np.random.RandomState(seed)
    r = rng.randint(-2, 3, (N, R)).astype(np.float32)
    w = (rng.randint(-4, 5, (K, R)) / 8.0).astype(np.float32)
    b = np.zeros(K, np.float32)
    w[tie_at] = w[tie_at + 1] = np.abs(r).max(0) * np.sign(r[0]) * 8.0
    ids = np.full((N, 1), tie_at + 1, np.int32)
    tw = np.ones((N, 1), np.float32)
    return r, w, b, ids, tw


@pytest.mark.parametrize("chunk,tie_at", [(64, 63), (128, 255),
                                          (1024, 1023)])
def test_chunked_forward_tie_across_chunk_edge_takes_first(chunk, tie_at):
    """An exact tie whose two classes lie in neighbouring chunks: the
    merge's strict > keeps the first, as the Pallas kernel does."""
    r, w, b, ids, tw = tie_inputs(6, 8, 1100, tie_at)
    got = xa.xent_fwd_chunked_plain(
        *(torch.from_numpy(a) for a in (r, w, b, ids, tw)), chunk)
    assert int(got[3][0]) == tie_at
    assert_fwd_match(got, jax_fwd_outputs(r, w, b, ids, tw))


def test_chunked_forward_large_bias_masked_half():
    """A bias of 200 (exp(bias) overflows float32) with half the frames
    masked: the chunk sums stay finite, and the loss and statistics from
    the chunked forward equal the JAX fused op's."""
    r, w, b, ids, tw, mask = make(24, 8, 300, 2, bias_scale=200.0,
                                  mask_p=0.5)
    assert (mask == 0).any()
    t = [torch.from_numpy(a) for a in (r, w, b, ids, tw, mask)]
    got = xa.xent_fwd_chunked_plain(*t[:5], 64)
    for a in got[:3]:
        assert bool(torch.isfinite(a).all())
    assert_fwd_match(got, jax_fwd_outputs(r, w, b, ids, tw))
    loss, aux = xa.fused_loss_and_stats(got[0], got[1], got[3], t[3], t[4],
                                        t[5])
    jl, ja, _ = jax_run(r, w, b, ids, tw, mask)
    np.testing.assert_allclose(float(loss), jl, rtol=1e-5)
    np.testing.assert_allclose([float(a) for a in aux], ja, rtol=1e-5,
                               atol=1e-6)


@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card (the K3/K4 kernels have no CPU "
                    "mode); run on the card with: python -m pytest -m gpu "
                    "tests/test_torch_xent_affine.py")
    return torch.device("cuda")


@pytest.mark.gpu
@pytest.mark.parametrize("N,R,K,Km,bias_scale", [
    (1000, 512, 8000, 1, 0.1), (37, 130, 1000, 3, 0.1),
    (70, 64, 300, 2, 200.0), (5120, 512, 16624, 1, 0.1),
    (1001, 136, 1003, 2, 0.1)])
def test_cuda_kernels_match_plain_versions(cuda_device, N, R, K, Km,
                                           bias_scale):
    """K3 exactly on argmax, 1e-5 relative on the rest; K4 1e-4 abs +
    1e-4 rel to each tensor's largest entry (float32 from 3xTF32 tensor
    cores, other sum order). Shapes: the flagship's and the deep net's
    senone layers, R not a multiple of 4 (4-byte copies), N, R and K off
    the 128/32 tiles with K not a multiple of 4, a bias of 200."""
    dev = cuda_device
    r, w, b, ids, tw, mask = (torch.tensor(a, device=dev) for a in make(
        N, R, K, Km, bias_scale=bias_scale))
    xa.reset_counts()
    fk = xa.xent_fwd_cuda(r, w, b, ids, tw)
    fp = xa.xent_fwd_plain(r, w, b, ids, tw)
    scale, wtot = mask, tw.sum(-1)
    bk = xa.xent_bwd_cuda(r, w, b, ids, tw, fp[0], scale, wtot)
    bp = xa.xent_bwd_plain(r, w, b, ids, tw, fp[0], scale, wtot)
    torch.cuda.synchronize()
    assert (xa.FWD_LAUNCHES, xa.BWD_LAUNCHES, xa.PLAIN_CALLS) == (2, 3, 0)
    assert torch.equal(fk[3], fp[3])
    for a, ref in zip(fk[:3], fp[:3]):
        torch.testing.assert_close(a, ref, rtol=1e-5, atol=1e-5)
    for a, ref in zip(bk, bp):
        assert float((a - ref).abs().max()) <= \
            1e-4 * (1.0 + float(ref.abs().max()))
    assert not bk[0][mask == 0].any()
    for a in bk:
        assert bool(torch.isfinite(a).all())


@pytest.mark.gpu
@pytest.mark.parametrize("tie_at", [63, 127, xa.FWD_CHUNK - 1])
def test_cuda_argmax_tie_across_tile_and_chunk_edges(cuda_device, tie_at):
    """Exact ties straddling a 64- and a 128-class tile edge and the edge
    between K3's first two class chunks: the kernel keeps the first, and
    every output equals the plain version's (all sums exact)."""
    dev = cuda_device
    r, w, b, ids, tw = (torch.tensor(a, device=dev) for a in tie_inputs(
        40, 16, 2 * xa.FWD_CHUNK + 100, tie_at))
    fk = xa.xent_fwd_cuda(r, w, b, ids, tw)
    fp = xa.xent_fwd_plain(r, w, b, ids, tw)
    torch.cuda.synchronize()
    assert int(fk[3][0]) == tie_at
    assert torch.equal(fk[3], fp[3])
    torch.testing.assert_close(fk[2], fp[2], rtol=0, atol=0)
    for a, ref in zip(fk[:2], fp[:2]):
        torch.testing.assert_close(a, ref, rtol=1e-5, atol=1e-5)
