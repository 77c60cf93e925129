"""Hand-rolled LSTMP BPTT with the reference's three gradient variants,
PyTorch edition's own copy of ``kaldi_lstm_tpu.ops.lstm_grad_variants``
(host numpy, a per-frame loop): the host reference that
`tools/nnet_debug_dump.py` prints from.

The reference ships gradient "Version 1" (precise gradients) live and
keeps Versions 2/3 as commented correctness references
(bd-nnet-lstm-projected-streams.h:388-405):

* **Variant 1** (precise): backprop all four gate pre-activation
  gradients of t+1 into r(t). This is what autograd of the forward
  gives, and what K2 (`ops/lstm_train.py`) computes.
* **Variant 2** (Graves' dissertation): only the g (cell-input) gate of
  t+1 backprops to r(t).
* **Variant 3** (Gers' dissertation): no gate backprops to r(t); the
  CEC (cell state via the forget gate, plus the i/f peepholes) is the
  only error bridge through time.

Also exposes the full per-frame activation/derivative tensors the
reference's ``int DEBUG`` blocks print
(bd-nnet-lstm-projected-streams.h:314-324,443-453).

Parameters may be torch tensors on any device or numpy arrays; every
tensor is copied to host float32 first.
"""

from __future__ import annotations

from typing import NamedTuple

import numpy as np
import torch


def _f32(a) -> np.ndarray:
    if isinstance(a, torch.Tensor):
        a = a.detach().cpu().numpy()
    return np.asarray(a, np.float32)


def _sigmoid(x):
    return 1.0 / (1.0 + np.exp(-x))


class LstmActs(NamedTuple):
    """Per-frame forward activations, each [T, S, ...] — the reference's
    propagate-buffer columns YG..YR (bd-nnet-lstm-projected-streams.h:222)."""
    g: np.ndarray
    i: np.ndarray
    f: np.ndarray
    o: np.ndarray
    c: np.ndarray
    h: np.ndarray
    m: np.ndarray
    r: np.ndarray


class LstmDerivs(NamedTuple):
    """Per-frame backward derivatives DG..DR (pre-activation for gates)."""
    g: np.ndarray
    i: np.ndarray
    f: np.ndarray
    o: np.ndarray
    c: np.ndarray
    h: np.ndarray
    m: np.ndarray
    r: np.ndarray


class LstmGrads(NamedTuple):
    """Summed-over-frames weight gradients (nnet1 semantics) + input diff."""
    w_gifo_x: np.ndarray
    w_gifo_r: np.ndarray
    bias: np.ndarray
    peephole_i_c: np.ndarray
    peephole_f_c: np.ndarray
    peephole_o_c: np.ndarray
    w_r_m: np.ndarray
    dx: np.ndarray  # [T, S, I]


def forward_full(params, x, c0, r0, cell_clip: float = 50.0) -> LstmActs:
    """Forward over a [T, S, I] chunk keeping every per-frame activation.

    params: ops/lstm_cell.py LstmParams (Kaldi orientation); tensors are
    copied to host numpy. Math mirrors lstm_cell.lstm_step and the
    reference propagate loop (bd-nnet-lstm-projected-streams.h:222-332).
    """
    wx = _f32(params.w_gifo_x)
    wr = _f32(params.w_gifo_r)
    b = _f32(params.bias)
    p_i = _f32(params.peephole_i_c)
    p_f = _f32(params.peephole_f_c)
    p_o = _f32(params.peephole_o_c)
    wrm = _f32(params.w_r_m)
    x = _f32(x)
    T, S, _ = x.shape
    C = wx.shape[0] // 4
    R = wrm.shape[0]

    Y = LstmActs(*[np.zeros((T, S, d), np.float32)
                   for d in (C, C, C, C, C, C, C, R)])
    c_prev = _f32(c0).copy()
    r_prev = _f32(r0).copy()
    for t in range(T):
        gifo = x[t] @ wx.T + b + r_prev @ wr.T
        g_pre, i_pre, f_pre, o_pre = np.split(gifo, 4, axis=-1)
        i = _sigmoid(i_pre + c_prev * p_i)
        f = _sigmoid(f_pre + c_prev * p_f)
        g = np.tanh(g_pre)
        c = g * i + c_prev * f
        if cell_clip > 0:
            c = np.clip(c, -cell_clip, cell_clip)
        h = np.tanh(c)
        o = _sigmoid(o_pre + c * p_o)
        m = h * o
        r = m @ wrm.T
        Y.g[t], Y.i[t], Y.f[t], Y.o[t] = g, i, f, o
        Y.c[t], Y.h[t], Y.m[t], Y.r[t] = c, h, m, r
        c_prev, r_prev = c, r
    return Y


def backward_variant(params, x, c0, r0, d_out, variant: int = 1,
                     cell_clip: float = 50.0
                     ) -> tuple[LstmDerivs, LstmGrads]:
    """The reference's hand-written backward loop
    (bd-nnet-lstm-projected-streams.h:334-499) with the variant switch.

    d_out: [T, S, R] upstream gradient w.r.t. the r outputs.
    The cell clip is straight-through (forward clips, backward ignores),
    as the reference's backward reads clipped activations but never
    masks d_c.
    """
    if variant not in (1, 2, 3):
        raise ValueError(f"gradient variant must be 1, 2 or 3: {variant}")
    Y = forward_full(params, x, c0, r0, cell_clip)
    wx = _f32(params.w_gifo_x)
    wr = _f32(params.w_gifo_r)
    p_i = _f32(params.peephole_i_c)
    p_f = _f32(params.peephole_f_c)
    p_o = _f32(params.peephole_o_c)
    wrm = _f32(params.w_r_m)
    x = _f32(x)
    d_out = _f32(d_out)
    T, S, _ = x.shape
    C = wx.shape[0] // 4

    D = LstmDerivs(*[np.zeros_like(a) for a in Y])
    c_prevs = np.concatenate([_f32(c0)[None], Y.c[:-1]])
    for t in range(T - 1, -1, -1):
        # r: variant switch (…streams.h:388-405)
        d_r = d_out[t].copy()
        if t + 1 < T:
            if variant == 1:
                dgifo_next = np.concatenate(
                    [D.g[t + 1], D.i[t + 1], D.f[t + 1], D.o[t + 1]], -1)
                d_r += dgifo_next @ wr
            elif variant == 2:
                d_r += D.g[t + 1] @ wr[:C]
            # variant 3: nothing — CEC is the only error bridge
        d_m = d_r @ wrm
        d_h = d_m * Y.o[t] * (1.0 - Y.h[t] ** 2)
        d_o = d_m * Y.h[t] * Y.o[t] * (1.0 - Y.o[t])
        d_c = d_h + d_o * p_o
        if t + 1 < T:
            d_c += (D.c[t + 1] * Y.f[t + 1]
                    + D.i[t + 1] * p_i + D.f[t + 1] * p_f)
        d_f = d_c * c_prevs[t] * Y.f[t] * (1.0 - Y.f[t])
        d_i = d_c * Y.g[t] * Y.i[t] * (1.0 - Y.i[t])
        d_g = d_c * Y.i[t] * (1.0 - Y.g[t] ** 2)
        D.g[t], D.i[t], D.f[t], D.o[t] = d_g, d_i, d_f, d_o
        D.c[t], D.h[t], D.m[t], D.r[t] = d_c, d_h, d_m, d_r

    dgifo = np.concatenate([D.g, D.i, D.f, D.o], -1)       # [T, S, 4C]
    r_prevs = np.concatenate([_f32(r0)[None], Y.r[:-1]])
    flat = lambda a: a.reshape(-1, a.shape[-1])
    grads = LstmGrads(
        w_gifo_x=flat(dgifo).T @ flat(x),
        w_gifo_r=flat(dgifo).T @ flat(r_prevs),
        bias=flat(dgifo).sum(0),
        peephole_i_c=(D.i * c_prevs).sum((0, 1)),
        peephole_f_c=(D.f * c_prevs).sum((0, 1)),
        peephole_o_c=(D.o * Y.c).sum((0, 1)),
        w_r_m=flat(D.r).T @ flat(Y.m),
        dx=dgifo @ wx,
    )
    return D, grads
