"""Projected-LSTM (LSTMP, Sak et al. 2014) cell numerics, eager PyTorch.

The same recurrence as ``kaldi_lstm_tpu.ops.lstm_cell`` (gate order
g, i, f, o along the 4C axis; Kaldi weight orientation [4C, I], [4C, R],
[R, C]):

    gifo = x_t @ W_gifo_x^T + bias + r_{t-1} @ W_gifo_r^T      (4C pre-acts)
    i    = sigmoid(i_pre + c_{t-1} * p_i)                       (peephole, diagonal)
    f    = sigmoid(f_pre + c_{t-1} * p_f)
    g    = tanh(g_pre)
    c    = clip(g*i + c_{t-1}*f, +-cell_clip)                   (straight-through)
    o    = sigmoid(o_pre + c * p_o)                             (clipped c(t))
    r    = (tanh(c) * o) @ W_r_m^T                              (recurrent projection)

The input projection has no sequential dependence and is hoisted out of
the time loop as one [S*T, I] x [I, 4C] product. This eager scan is the
plain version of the CUDA kernel in ``ops/lstm_infer.py``: CPU tensors
take it, and the kernel is held against it on the card.
"""

from __future__ import annotations

from typing import NamedTuple

import torch


class LstmParams(NamedTuple):
    """Parameters of one projected-LSTM layer (Kaldi tensor orientation).

    Field order is the serialization order: w_gifo_x, w_gifo_r, bias,
    peephole_i_c, peephole_f_c, peephole_o_c, w_r_m.
    """

    w_gifo_x: torch.Tensor  # [4C, I]
    w_gifo_r: torch.Tensor  # [4C, R]
    bias: torch.Tensor      # [4C]
    peephole_i_c: torch.Tensor  # [C]
    peephole_f_c: torch.Tensor  # [C]
    peephole_o_c: torch.Tensor  # [C]
    w_r_m: torch.Tensor     # [R, C]

    @property
    def cell_dim(self) -> int:
        return self.w_gifo_x.shape[0] // 4

    @property
    def input_dim(self) -> int:
        return self.w_gifo_x.shape[1]

    @property
    def recur_dim(self) -> int:
        return self.w_r_m.shape[0]


class LstmState(NamedTuple):
    """Carried (c, r) state between chunks."""

    c: torch.Tensor  # [S, C] cell activation (post-clip)
    r: torch.Tensor  # [S, R] recurrent projection output


def zero_state(nstream: int, cell_dim: int, recur_dim: int,
               dtype=torch.float32, device=None) -> LstmState:
    return LstmState(
        c=torch.zeros((nstream, cell_dim), dtype=dtype, device=device),
        r=torch.zeros((nstream, recur_dim), dtype=dtype, device=device),
    )


def init_lstm_params(generator: torch.Generator, input_dim: int,
                     cell_dim: int, recur_dim: int,
                     param_scale: float = 0.02, dtype=torch.float32,
                     device=None) -> LstmParams:
    """Uniform [-scale, +scale] init (the reference's InitData). Numbers
    are drawn on the generator's device, then moved, so a seed gives the
    same parameters on every device."""

    def u(*shape):
        t = torch.rand(shape, generator=generator, dtype=dtype,
                       device=generator.device)
        return (t * (2 * param_scale) - param_scale).to(device)

    return LstmParams(
        w_gifo_x=u(4 * cell_dim, input_dim),
        w_gifo_r=u(4 * cell_dim, recur_dim),
        bias=u(4 * cell_dim),
        peephole_i_c=u(cell_dim),
        peephole_f_c=u(cell_dim),
        peephole_o_c=u(cell_dim),
        w_r_m=u(recur_dim, cell_dim),
    )


def _straight_through_clip(x: torch.Tensor, limit: float) -> torch.Tensor:
    """clip(x, -limit, +limit) forward; identity backward (the
    reference's backward pass ignores the clip)."""
    return x + (torch.clamp(x, -limit, limit) - x).detach()


def rounded(t: torch.Tensor, compute_dtype) -> torch.Tensor:
    """``t`` rounded to ``compute_dtype`` (to nearest even) and back to
    its own dtype, as a product with that compute dtype reads it; ``t``
    itself when ``compute_dtype`` is None."""
    if compute_dtype is None:
        return t
    return t.to(compute_dtype).to(t.dtype)


def _dot(a: torch.Tensor, w: torch.Tensor, compute_dtype) -> torch.Tensor:
    """a @ w^T. With ``compute_dtype`` the inputs are rounded to it and
    the product is taken in float32 — matmul inputs in the compute dtype
    with float32 accumulation and a float32 result."""
    return rounded(a, compute_dtype) @ rounded(w, compute_dtype).T


def lstm_step(params: LstmParams, state: LstmState, xw_t: torch.Tensor,
              cell_clip: float = 50.0,
              compute_dtype=None) -> tuple[LstmState, torch.Tensor]:
    """One recurrence step for all streams.

    Args:
      state: (c, r) each [S, ...] from t-1.
      xw_t:  [S, 4C] input-projection pre-activations (x_t @ W^T + bias).
    Returns: (new_state, r_t [S, R]).
    """
    c_prev, r_prev = state.c, state.r
    gifo = xw_t + _dot(r_prev, params.w_gifo_r, compute_dtype)
    g_pre, i_pre, f_pre, o_pre = gifo.chunk(4, dim=-1)
    i = torch.sigmoid(i_pre + c_prev * params.peephole_i_c)
    f = torch.sigmoid(f_pre + c_prev * params.peephole_f_c)
    g = torch.tanh(g_pre)
    c = g * i + c_prev * f
    if cell_clip > 0:
        c = _straight_through_clip(c, cell_clip)
    o = torch.sigmoid(o_pre + c * params.peephole_o_c)
    r = _dot(torch.tanh(c) * o, params.w_r_m, compute_dtype)
    return LstmState(c=c, r=r), r


def lstm_scan(params: LstmParams, x: torch.Tensor, state: LstmState,
              cell_clip: float = 50.0,
              compute_dtype=None,
              gate_dropout_mask: torch.Tensor | None = None,
              time_major: bool = False,
              advance_mask: torch.Tensor | None = None
              ) -> tuple[torch.Tensor, LstmState]:
    """Run the projected LSTM over a [S, T, I] chunk.

    Args:
      x: [S, T, I] input features (stream-major), or [T, S, I] with
        ``time_major=True``.
      state: carried (c, r) from the previous chunk ([S, C], [S, R]);
        reset rows to zero *before* the call for streams that start a
        new utterance.
      compute_dtype: optional matmul-input dtype (e.g. torch.bfloat16)
        for all three weight products, with float32 accumulation; the
        carry, gate math, bias add and outputs stay float32.
      gate_dropout_mask: optional [S, T, 4C] ([T, S, 4C] if time_major)
        multiplier on the input-projection pre-activations, before the
        bias (inverted gate dropout).
      advance_mask: optional [S, T] ([T, S] if time_major) 0/1 mask:
        frames with 0 leave the carried state UNCHANGED. Output rows at
        masked frames are unspecified and must be discarded by the
        caller.

    Returns: (r_out [S, T, R] — [T, S, R] if time_major — and the final
    state).
    """
    d0, d1, I = x.shape
    C4 = params.w_gifo_x.shape[0]
    xw = _dot(x.reshape(d0 * d1, I), params.w_gifo_x, compute_dtype)
    xw = xw.reshape(d0, d1, C4)
    if gate_dropout_mask is not None:
        xw = xw * gate_dropout_mask
    xw = xw + params.bias
    xw_tm = xw if time_major else xw.transpose(0, 1)        # [T, S, 4C]
    a_tm = None
    if advance_mask is not None:
        a_tm = advance_mask if time_major else advance_mask.transpose(0, 1)
        a_tm = a_tm.to(xw.dtype).unsqueeze(-1)              # [T, S, 1]

    outs = []
    for t in range(xw_tm.shape[0]):
        new_state, r = lstm_step(params, state, xw_tm[t], cell_clip,
                                 compute_dtype=compute_dtype)
        if a_tm is not None:
            a_t = a_tm[t]
            new_state = LstmState(
                c=a_t * new_state.c + (1.0 - a_t) * state.c,
                r=a_t * new_state.r + (1.0 - a_t) * state.r)
        state = new_state
        outs.append(r)
    if outs:
        r_seq = torch.stack(outs)
    else:
        r_seq = xw.new_zeros((0, xw_tm.shape[1], params.recur_dim))
    return (r_seq if time_major else r_seq.transpose(0, 1)), state
