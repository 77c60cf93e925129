"""K5's decomposition (`lstm_infer.lstm_infer_sliced_plain`: per step a
gates phase over each CTA's cells, a grid barrier, a projection phase
over each CTA's columns of r, every CTA's sums split over its threads)
against the JAX package's Pallas inference kernel `_infer_call` in
interpret mode, with the same numpy-made inputs handed to both; the plan
that deals cells and columns to CTAs; and, on a card (marked `gpu`), the
persistent kernel against the plain version.

Tolerance: float32 on both sides at rtol = atol = 1e-5, as
tests/test_torch_lstm_cell.py (the products are summed in other orders
in XLA and PyTorch; differences are ~1e-7).
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from kaldi_lstm_tpu.ops import LstmState as JLstmState
from kaldi_lstm_tpu.ops.lstm_cell import LstmParams as JLstmParams
from kaldi_lstm_tpu.ops.lstm_pallas import _infer_call, _plan_dims, _prepare
from kaldi_lstm_tpu_torch.ops import lstm_infer as li
from kaldi_lstm_tpu_torch.ops.lstm_cell import LstmParams, LstmState, lstm_scan

TOL = dict(rtol=1e-5, atol=1e-5)


def make(S, T, I, C, R, seed=0, scale=0.3, x_scale=1.0):
    rng = np.random.RandomState(seed)

    def u(*shape):
        return rng.uniform(-scale, scale, shape).astype(np.float32)

    p = dict(w_gifo_x=u(4 * C, I), w_gifo_r=u(4 * C, R), bias=u(4 * C),
             peephole_i_c=u(C), peephole_f_c=u(C), peephole_o_c=u(C),
             w_r_m=u(R, C))
    x = (rng.randn(T, S, I) * x_scale).astype(np.float32)
    c0 = (rng.randn(S, C) * 0.5).astype(np.float32)
    r0 = (rng.randn(S, R) * 0.5).astype(np.float32)
    return p, x, c0, r0


def pallas_infer(p, x, c0, r0, clip):
    """r [T, S, R] and the final c of `_infer_call` (interpret mode)."""
    T, S, I = x.shape
    C, R = p["w_r_m"].shape[1], p["w_r_m"].shape[0]
    jp = JLstmParams(**{k: jnp.asarray(v) for k, v in p.items()})
    d = _plan_dims(S, T, I, C, R)
    ops = _prepare(jp, jnp.asarray(x),
                   JLstmState(c=jnp.asarray(c0), r=jnp.asarray(r0)), d,
                   time_major=True)
    r, c = _infer_call(*ops[:8], st=d.st, tb=d.tb, cell_clip=clip,
                       interpret=True)
    return np.asarray(r)[:, :S, :R], np.asarray(c)[:S, :C]


CASES = {
    # name: (S, T, I, C, R, clip, x_scale, SMs): few SMs deal several
    # cells and columns to each CTA, with a ragged last CTA
    "cells_per_cta_3": (3, 5, 7, 9, 6, 50.0, 1.0, 4),
    "two_stream_tiles_clip": (70, 3, 13, 37, 20, 0.5, 3.0, 5),
    "one_cta_each": (1, 2, 1, 1, 1, 50.0, 1.0, 132),
    "more_ctas_than_cells": (9, 4, 5, 3, 11, 50.0, 1.0, 8),
}


@pytest.mark.parametrize("case", list(CASES))
def test_sliced_decomposition_matches_pallas_infer_call(case):
    S, T, I, C, R, clip, xs, sms = CASES[case]
    p, x, c0, r0 = make(S, T, I, C, R, x_scale=xs)
    want_r, want_c = pallas_infer(p, x, c0, r0, clip)
    tp = LstmParams(**{k: torch.from_numpy(v) for k, v in p.items()})
    r, c = li.lstm_infer_sliced_plain(tp, torch.from_numpy(x),
                                      torch.from_numpy(c0),
                                      torch.from_numpy(r0), clip, sms)
    if clip < 1.0:
        assert (c.abs() == clip).any(), "the clip never engaged"
    np.testing.assert_allclose(r.numpy(), want_r, **TOL)
    np.testing.assert_allclose(c.numpy(), want_c, **TOL)


@pytest.mark.parametrize("C,R,sms", [(800, 512, 132), (1, 1, 132),
                                     (200, 130, 132), (37, 20, 5),
                                     (3, 11, 8)])
def test_plan_deals_every_cell_and_column_once(C, R, sms):
    grid, ncell, nq = li.k5_plan(C, R, sms)
    assert grid <= sms
    cells = [j for b in range(grid)
             for j in range(b * ncell, min(C, (b + 1) * ncell))]
    cols = [q for b in range(grid)
            for q in range(b * nq, min(R, (b + 1) * nq))]
    assert cells == list(range(C)) and cols == list(range(R))


def test_stream_tiles_cover_every_stream():
    """block_product's tiles: up to 64 streams, at most 256 threads in
    (quads x stream groups x contraction splits), the splits a power of
    two (a unit's threads are aligned lanes of one warp or whole
    warps)."""
    for S in (1, 8, 63, 64, 65, 256, 1000):
        for ncb in (1, 4, 7, 40, 256):
            tiles = list(li._tiles(S, ncb))
            assert [s0 for s0, _, _ in tiles] == \
                list(range(0, S, tiles[0][1]))
            assert sum(sn for _, sn, _ in tiles) == S
            for _, sn, ksn in tiles:
                assert sn <= 64 and ncb * -(-sn // 8) * ksn <= 256
                assert ksn & (ksn - 1) == 0


@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card (the kernel has no CPU mode); "
                    "run on the card with: python -m pytest -m gpu "
                    "tests/test_torch_lstm_infer.py")
    return torch.device("cuda")


@pytest.mark.gpu
@pytest.mark.parametrize("S,T,I,C,R,resident", [
    (256, 20, 40, 800, 512, True),     # the cross-validation shape
    (8, 64, 512, 800, 512, True),      # the deep net's layer 2
    (256, 20, 512, 800, 512, True),
    (3, 9, 37, 200, 130, True),
    # weight slices too wide for shared memory: read from device memory
    (8, 16, 1024, 800, 512, False),
    (3, 9, 1501, 800, 130, False),     # and unaligned rows
])
def test_cuda_kernel_matches_plain_version(cuda_device, S, T, I, C, R,
                                           resident):
    """Tolerance 1e-4 abs + 1e-4 rel, as chip_smoke.py's phase 3: both
    float32, different summation orders. ``resident``: whether the plan
    keeps the weights in shared memory at these widths."""
    p, x, c0, r0 = make(S, T, I, C, R, scale=0.04)
    tp = LstmParams(**{k: torch.tensor(v, device=cuda_device)
                       for k, v in p.items()})
    x_tm = torch.tensor(x, device=cuda_device)
    st = LstmState(torch.tensor(c0, device=cuda_device),
                   torch.tensor(r0, device=cuda_device))
    li.reset_counts()
    with torch.inference_mode():
        r, fin = li.lstm_infer(tp, x_tm, st, 50.0, time_major=True)
        ref, ref_fin = lstm_scan(tp, x_tm, st, 50.0, time_major=True)
        torch.cuda.synchronize()
    assert (li.LAUNCHES, li.PLAIN_CALLS) == (1, 0)
    assert li.device_plan(S, I, C, R, cuda_device)["resident"] == \
        int(resident)
    for a, b in ((r, ref), (fin.c, ref_fin.c), (fin.r, ref_fin.r)):
        torch.testing.assert_close(a, b, rtol=1e-4, atol=1e-4)
