"""LSTMP training forward and backward: the hand-written CUDA
counterparts of ``kaldi_lstm_tpu/ops/lstm_pallas.py::_fwd_kernel`` (K1)
and ``::_bwd_kernel`` (K2), behind one ``torch.autograd.Function``.

``lstm_train`` has the signature and semantics of the JAX package's
``lstm_scan_pallas``: forward = K1, which also keeps the residuals
(post-activation gates g, i, f, o, the clipped c and r for every t);
backward = K2, the reverse recurrence from those residuals plus the
frame-axis weight-gradient contractions. On a CUDA tensor each half
launches ``csrc/lstmp_train.cu`` or raises; on a CPU tensor it runs its
plain version beside it here, ``lstm_fwd_residuals_plain`` and
``lstm_bwd_plain``. It never falls back from the card to the plain
version.

Semantics kept from the reference: the int8 keep-mask times 1/keep
multiplies the input projection before the bias; dbias and the
recurrent path see the undropped gate gradient, dWx and dx the dropped
one; dc flows straight through the cell clip; the i/f peepholes' grads
use c(t-1) (the chunk's c0 at t = 0), the o peephole's the clipped c(t);
the final r's cotangent joins r(T-1)'s and the final c's seeds dc.
With ``need_input_grad=False`` no dx is computed and the Function
returns None for it.

K2 runs its products on the tensor cores, split over the contraction
where a product has too few tiles to fill the card (``bwd_plan``).
``lstm_bwd_split_plain`` spells that decomposition out in torch (the
serial loop writing dgifo, dr_total, h o and dxw, the split-K partials
of the per-step dr added in a fixed order, then the four frame-axis
products from the materialised operands); the CPU tests hold it
against the JAX package's Pallas kernel.

Counters: ``FWD_LAUNCHES`` and ``BWD_LAUNCHES`` count the CUDA kernel
launches (K1: 2 per step; K2: ``bwd_launches``, 2 per step + 5, + 1
with dx); ``PLAIN_CALLS`` counts the calls of either half that took the
plain version. ``reset_counts`` zeroes all three.
"""

from __future__ import annotations

import ctypes

import torch

from kaldi_lstm_tpu_torch.ops.lstm_cell import LstmParams, LstmState
from kaldi_lstm_tpu_torch.ops.lstm_infer import (
    H100_SMS,
    _check,
    _kernel_operands,
    check_lstm_operands,
)

FWD_LAUNCHES = 0
BWD_LAUNCHES = 0
PLAIN_CALLS = 0


def reset_counts() -> None:
    global FWD_LAUNCHES, BWD_LAUNCHES, PLAIN_CALLS
    FWD_LAUNCHES = 0
    BWD_LAUNCHES = 0
    PLAIN_CALLS = 0


def _entries():
    from kaldi_lstm_tpu_torch.ops import _build
    lib = _build.load("lstmp_train")
    fwd, bwd = lib.lstmp_train_fwd_f32, lib.lstmp_train_bwd_f32
    p, i, f = ctypes.c_void_p, ctypes.c_int, ctypes.c_float
    if fwd.argtypes is None:
        fwd.argtypes = [p, p, p, p, p, p, p, p, f, p, p, p, p,
                        i, i, i, i, i, f, p]
        fwd.restype = ctypes.c_int
    if bwd.argtypes is None:
        bwd.argtypes = [p] * 11 + [f] + [p] * 19 + [i] * 10 + [p]
        bwd.restype = ctypes.c_int
    return fwd, bwd


# csrc/lstmp_train.cu's tensor-core products: 64 x 64 output tiles, 32-deep
# stages of the contraction
_TILE, _STAGE = 64, 32


def _split(M: int, N: int, K: int, sms: int) -> int:
    """Contraction splits of an [M, N] product over K: enough (tile,
    split) CTAs for two per SM, each split at least 8 stages deep, and
    no split empty."""
    tiles = -(-M // _TILE) * -(-N // _TILE)
    ksteps = -(-K // _STAGE)
    want = max(1, min(-(-2 * sms // tiles), ksteps // 8))
    per = -(-ksteps // want)
    return -(-ksteps // per)


def bwd_plan(T: int, S: int, I: int, C: int, R: int,
             sms: int = H100_SMS) -> dict[str, int]:
    """K2's split counts: the per-step dr = dgifo_t Wr ([S, R] over 4C),
    dWx ([4C, I] over T S), dWr ([4C, R]), dWrm ([R, C]) and dx ([T S, I]
    over 4C)."""
    N = T * S
    return {"dr": _split(S, R, 4 * C, sms), "wx": _split(4 * C, I, N, sms),
            "wr": _split(4 * C, R, N, sms), "wrm": _split(R, C, N, sms),
            "dx": _split(N, I, 4 * C, sms)}


def bwd_launches(T: int, need_dx: bool) -> int:
    """K2's launches per call: bwd_cell and dr per step; dWx, dWr, dWrm,
    the column sums and the partials' sum; dx."""
    return 2 * T + 5 + int(need_dx)


def _split_matmul(a: torch.Tensor, b: torch.Tensor, splits: int
                  ) -> torch.Tensor:
    """a [M, K] @ b [K, N] as the kernel sums it: partial products over
    `splits` consecutive ranges of k (whole 32-deep stages each), added
    in range order."""
    K = a.shape[1]
    ksteps = -(-K // _STAGE)
    kc = -(-ksteps // splits) * _STAGE
    out = a.new_zeros((a.shape[0], b.shape[1]))
    for k0 in range(0, K, kc):
        out = out + a[:, k0:k0 + kc] @ b[k0:k0 + kc]
    return out


def _ptr(t: torch.Tensor | None) -> int | None:
    return None if t is None else t.data_ptr()


def _peep(params: LstmParams) -> torch.Tensor:
    return torch.stack([params.peephole_i_c, params.peephole_f_c,
                        params.peephole_o_c]).contiguous()


# ---------------------------------------------------------------------------
# plain versions (CPU tensors; the card holds the kernels against them)
# ---------------------------------------------------------------------------

def lstm_fwd_residuals_plain(params: LstmParams, x_tm: torch.Tensor,
                             c0: torch.Tensor, r0: torch.Tensor,
                             keep_mask_tm: torch.Tensor | None = None,
                             inv_keep: float = 1.0, cell_clip: float = 50.0
                             ) -> tuple[torch.Tensor, torch.Tensor,
                                        torch.Tensor]:
    """K1's outputs in torch ops: (gifo [T, S, 4C] gate activations,
    c_seq [T, S, C] clipped cells, r_seq [T, S, R]) from x [T, S, I]."""
    T, S, I = x_tm.shape
    C = params.cell_dim
    xw = (x_tm.reshape(T * S, I) @ params.w_gifo_x.T).reshape(T, S, 4 * C)
    if keep_mask_tm is not None:
        xw = xw * (keep_mask_tm.to(torch.float32) * inv_keep)
    xw = xw + params.bias
    gifo = xw.new_empty((T, S, 4 * C))
    c_seq = xw.new_empty((T, S, C))
    r_seq = xw.new_empty((T, S, params.recur_dim))
    c, r = c0, r0
    for t in range(T):
        pre = xw[t] + r @ params.w_gifo_r.T
        g = torch.tanh(pre[:, :C])
        i = torch.sigmoid(pre[:, C:2 * C] + c * params.peephole_i_c)
        f = torch.sigmoid(pre[:, 2 * C:3 * C] + c * params.peephole_f_c)
        c = g * i + c * f
        if cell_clip > 0:
            c = torch.clamp(c, -cell_clip, cell_clip)
        o = torch.sigmoid(pre[:, 3 * C:] + c * params.peephole_o_c)
        r = (torch.tanh(c) * o) @ params.w_r_m.T
        gifo[t] = torch.cat([g, i, f, o], dim=-1)
        c_seq[t] = c
        r_seq[t] = r
    return gifo, c_seq, r_seq


def lstm_bwd_plain(params: LstmParams, x_tm: torch.Tensor,
                   c0: torch.Tensor, r0: torch.Tensor, gifo: torch.Tensor,
                   c_seq: torch.Tensor, r_seq: torch.Tensor,
                   keep_mask_tm: torch.Tensor | None, inv_keep: float,
                   g_r: torch.Tensor, gcT: torch.Tensor, need_dx: bool
                   ) -> tuple[LstmParams, torch.Tensor | None,
                              torch.Tensor, torch.Tensor]:
    """K2 in torch ops: the reverse recurrence over the residuals, then
    the hoisted frame-axis contractions. ``g_r`` [T, S, R] is every r_t's
    cotangent (the final r's already added at T-1), ``gcT`` [S, C] the
    final c's. Returns (dparams, dx [T, S, I] or None, dc0, dr0)."""
    T, S, I = x_tm.shape
    C, R = params.cell_dim, params.recur_dim
    pi, pf, po = (params.peephole_i_c, params.peephole_f_c,
                  params.peephole_o_c)
    dc = gcT.clone()
    dr = gcT.new_zeros((S, R))
    dgifo = gifo.new_empty((T, S, 4 * C))
    drt = gifo.new_empty((T, S, R))
    for t in range(T - 1, -1, -1):
        g, i, f, o = gifo[t].split(C, dim=-1)
        c = c_seq[t]
        cp = c_seq[t - 1] if t > 0 else c0
        h = torch.tanh(c)
        dr_total = g_r[t] + dr
        dm = dr_total @ params.w_r_m
        dh = dm * o
        dc_from_h = dh * (1.0 - h * h)
        d_o = dm * h * o * (1.0 - o)
        dc_total = dc + dc_from_h + d_o * po
        df = dc_total * cp * f * (1.0 - f)
        di = dc_total * g * i * (1.0 - i)
        dg = dc_total * i * (1.0 - g * g)
        dgifo[t] = torch.cat([dg, di, df, d_o], dim=-1)
        drt[t] = dr_total
        dc = dc_total * f + di * pi + df * pf
        dr = dgifo[t] @ params.w_gifo_r

    N = T * S
    dg2 = dgifo.reshape(N, 4 * C)
    dxw = dg2 if keep_mask_tm is None else \
        dg2 * (keep_mask_tm.reshape(N, 4 * C).to(torch.float32) * inv_keep)
    r_prev = torch.cat([r0[None], r_seq[:-1]]).reshape(N, R)
    c_prev = torch.cat([c0[None], c_seq[:-1]]).reshape(N, C)
    c_all = c_seq.reshape(N, C)
    ho = torch.tanh(c_all) * gifo.reshape(N, 4 * C)[:, 3 * C:]
    dparams = LstmParams(
        w_gifo_x=dxw.T @ x_tm.reshape(N, I),
        w_gifo_r=dg2.T @ r_prev,
        bias=dg2.sum(0),
        peephole_i_c=(dg2[:, C:2 * C] * c_prev).sum(0),
        peephole_f_c=(dg2[:, 2 * C:3 * C] * c_prev).sum(0),
        peephole_o_c=(dg2[:, 3 * C:] * c_all).sum(0),
        w_r_m=drt.reshape(N, R).T @ ho,
    )
    dx = (dxw @ params.w_gifo_x).reshape(T, S, I) if need_dx else None
    return dparams, dx, dc, dr


def lstm_bwd_split_plain(params: LstmParams, x_tm: torch.Tensor,
                         c0: torch.Tensor, r0: torch.Tensor,
                         gifo: torch.Tensor, c_seq: torch.Tensor,
                         r_seq: torch.Tensor,
                         keep_mask_tm: torch.Tensor | None, inv_keep: float,
                         g_r: torch.Tensor, gcT: torch.Tensor, need_dx: bool,
                         sms: int = H100_SMS
                         ) -> tuple[LstmParams, torch.Tensor | None,
                                    torch.Tensor, torch.Tensor]:
    """K2's decomposition in torch, the arguments and results of
    ``lstm_bwd_plain``: the serial loop writes dgifo, dr_total, h o and
    (with a mask) dxw for every t, the per-step dr comes as ``bwd_plan``'s
    split-K partials that the next step adds in order, then the four
    frame-axis products run from the materialised operands (r_prev made
    contiguous), each split as the kernel splits it."""
    T, S, I = x_tm.shape
    C, R = params.cell_dim, params.recur_dim
    N = T * S
    sp = bwd_plan(T, S, I, C, R, sms)
    pi, pf, po = (params.peephole_i_c, params.peephole_f_c,
                  params.peephole_o_c)
    dc = gcT.clone()
    dr = gcT.new_zeros((S, R))
    dgifo = gifo.new_empty((T, S, 4 * C))
    drt = gifo.new_empty((T, S, R))
    ho = gifo.new_empty((T, S, C))
    dxw = None if keep_mask_tm is None else gifo.new_empty((T, S, 4 * C))
    for t in range(T - 1, -1, -1):
        g, i, f, o = gifo[t].split(C, dim=-1)
        cp = c_seq[t - 1] if t > 0 else c0
        h = torch.tanh(c_seq[t])
        dr_total = g_r[t] + dr
        dm = dr_total @ params.w_r_m
        d_o = dm * h * o * (1.0 - o)
        dc_total = dc + dm * o * (1.0 - h * h) + d_o * po
        df = dc_total * cp * f * (1.0 - f)
        di = dc_total * g * i * (1.0 - i)
        dg = dc_total * i * (1.0 - g * g)
        dgifo[t] = torch.cat([dg, di, df, d_o], dim=-1)
        drt[t] = dr_total
        ho[t] = h * o
        if dxw is not None:
            dxw[t] = dgifo[t] * (keep_mask_tm[t].to(torch.float32) * inv_keep)
        dc = dc_total * f + di * pi + df * pf
        dr = _split_matmul(dgifo[t], params.w_gifo_r, sp["dr"])

    dg2 = dgifo.reshape(N, 4 * C)
    dxw2 = dg2 if dxw is None else dxw.reshape(N, 4 * C)
    r_prev = torch.cat([r0[None], r_seq[:-1]]).reshape(N, R)
    c_prev = torch.cat([c0[None], c_seq[:-1]]).reshape(N, C)
    dparams = LstmParams(
        w_gifo_x=_split_matmul(dxw2.T, x_tm.reshape(N, I), sp["wx"]),
        w_gifo_r=_split_matmul(dg2.T, r_prev, sp["wr"]),
        bias=dg2.sum(0),
        peephole_i_c=(dg2[:, C:2 * C] * c_prev).sum(0),
        peephole_f_c=(dg2[:, 2 * C:3 * C] * c_prev).sum(0),
        peephole_o_c=(dg2[:, 3 * C:] * c_seq.reshape(N, C)).sum(0),
        w_r_m=_split_matmul(drt.reshape(N, R).T, ho.reshape(N, C),
                            sp["wrm"]),
    )
    dx = _split_matmul(dxw2, params.w_gifo_x, sp["dx"]).reshape(T, S, I) \
        if need_dx else None
    return dparams, dx, dc, dr


# ---------------------------------------------------------------------------
# kernels (CUDA tensors)
# ---------------------------------------------------------------------------

def _check_mask(mask: torch.Tensor | None, shape: tuple, dev) -> None:
    if mask is not None:
        _check("keep mask", mask, shape, dev, "lstm_train", torch.int8)
        if not mask.is_contiguous():
            raise ValueError("lstm_train: keep mask must be contiguous")


def lstm_fwd_residuals_cuda(params: LstmParams, x_tm: torch.Tensor,
                            c0: torch.Tensor, r0: torch.Tensor,
                            keep_mask_tm: torch.Tensor | None = None,
                            inv_keep: float = 1.0, cell_clip: float = 50.0
                            ) -> tuple[torch.Tensor, torch.Tensor,
                                       torch.Tensor]:
    """K1 on the card; same arguments and results as the plain version.
    ``keep_mask_tm`` is int8 [T, S, 4C], contiguous."""
    global FWD_LAUNCHES
    T, S, I = x_tm.shape
    C, R = params.cell_dim, params.recur_dim
    dev = x_tm.device
    _check("x", x_tm, (T, S, I), dev, "lstm_train")
    check_lstm_operands(params, T, S, I, LstmState(c0, r0), dev,
                        "lstm_train")
    _check_mask(keep_mask_tm, (T, S, 4 * C), dev)
    x_c = x_tm.contiguous()
    w_cat, bias, peep, wrm_t = _kernel_operands(params)
    c0c, r0c = c0.contiguous(), r0.contiguous()
    gifo = torch.empty((T, S, 4 * C), dtype=torch.float32, device=dev)
    c_seq = torch.empty((T, S, C), dtype=torch.float32, device=dev)
    r_seq = torch.empty((T, S, R), dtype=torch.float32, device=dev)
    m = torch.empty((S, C), dtype=torch.float32, device=dev)
    fwd, _ = _entries()
    with torch.cuda.device(dev):
        stream = torch.cuda.current_stream(dev).cuda_stream
        err = fwd(x_c.data_ptr(), w_cat.data_ptr(), bias.data_ptr(),
                  peep.data_ptr(), wrm_t.data_ptr(), c0c.data_ptr(),
                  r0c.data_ptr(), _ptr(keep_mask_tm), float(inv_keep),
                  gifo.data_ptr(), c_seq.data_ptr(), r_seq.data_ptr(),
                  m.data_ptr(), T, S, I, C, R, float(cell_clip), stream)
    if err != 0:
        raise RuntimeError(f"lstm_train: K1 launch failed with CUDA error "
                           f"{err}")
    FWD_LAUNCHES += 2 * T
    return gifo, c_seq, r_seq


def lstm_bwd_cuda(params: LstmParams, x_tm: torch.Tensor, c0: torch.Tensor,
                  r0: torch.Tensor, gifo: torch.Tensor, c_seq: torch.Tensor,
                  r_seq: torch.Tensor, keep_mask_tm: torch.Tensor | None,
                  inv_keep: float, g_r: torch.Tensor, gcT: torch.Tensor,
                  need_dx: bool) -> tuple[LstmParams, torch.Tensor | None,
                                          torch.Tensor, torch.Tensor]:
    """K2 on the card; same arguments and results as the plain version."""
    global BWD_LAUNCHES
    T, S, I = x_tm.shape
    C, R = params.cell_dim, params.recur_dim
    dev = x_tm.device
    _check("x", x_tm, (T, S, I), dev, "lstm_train")
    check_lstm_operands(params, T, S, I, LstmState(c0, r0), dev,
                        "lstm_train")
    for name, t, shape in (("gifo", gifo, (T, S, 4 * C)),
                           ("c_seq", c_seq, (T, S, C)),
                           ("r_seq", r_seq, (T, S, R)),
                           ("g_r", g_r, (T, S, R)), ("gcT", gcT, (S, C))):
        _check(name, t, shape, dev, "lstm_train")
    _check_mask(keep_mask_tm, (T, S, 4 * C), dev)
    cont = [t.contiguous() for t in (x_tm, params.w_gifo_x, params.w_gifo_r,
                                     params.w_r_m, c0, r0, gifo, c_seq,
                                     r_seq, g_r)]
    peep = _peep(params)
    f32 = dict(dtype=torch.float32, device=dev)
    sp = bwd_plan(T, S, I, C, R,
                  torch.cuda.get_device_properties(dev).multi_processor_count)
    if not need_dx:
        sp["dx"] = 1
    N = T * S

    def partials(key, rows, cols):
        return torch.empty((sp[key], rows, cols), **f32) if sp[key] > 1 \
            else None

    dc = gcT.contiguous().clone()
    dr = torch.empty((S, R), **f32)
    scratch = [torch.empty((T, S, 4 * C), **f32),           # dgifo
               torch.empty((T, S, R), **f32),               # dr_total
               torch.empty((T, S, C), **f32),               # h o
               None if keep_mask_tm is None
               else torch.empty((T, S, 4 * C), **f32),      # dxw
               torch.empty((T, S, R), **f32),               # r_prev
               torch.empty((sp["dr"], S, R), **f32),        # dr partials
               partials("wx", 4 * C, I), partials("wr", 4 * C, R),
               partials("wrm", R, C), partials("dx", N, I)]
    dx = torch.empty((T, S, I), **f32) if need_dx else None
    dwx = torch.empty((4 * C, I), **f32)
    dwr = torch.empty((4 * C, R), **f32)
    dwrm = torch.empty((R, C), **f32)
    dbias = torch.empty((4 * C,), **f32)
    dpeep = torch.empty((3, C), **f32)
    x_c, wx, wr, wrm, c0c, r0c, gifo_c, c_c, r_c, g_r_c = cont
    _, bwd = _entries()
    with torch.cuda.device(dev):
        stream = torch.cuda.current_stream(dev).cuda_stream
        err = bwd(x_c.data_ptr(), wx.data_ptr(), wr.data_ptr(),
                  wrm.data_ptr(), peep.data_ptr(), c0c.data_ptr(),
                  r0c.data_ptr(), gifo_c.data_ptr(), c_c.data_ptr(),
                  r_c.data_ptr(), _ptr(keep_mask_tm), float(inv_keep),
                  g_r_c.data_ptr(), dc.data_ptr(), dr.data_ptr(),
                  *(_ptr(t) for t in scratch), _ptr(dx),
                  dwx.data_ptr(), dwr.data_ptr(), dwrm.data_ptr(),
                  dbias.data_ptr(), dpeep.data_ptr(), T, S, I, C, R,
                  sp["dr"], sp["wx"], sp["wr"], sp["wrm"], sp["dx"], stream)
    if err != 0:
        raise RuntimeError(f"lstm_train: K2 launch failed with CUDA error "
                           f"{err}")
    BWD_LAUNCHES += bwd_launches(T, need_dx)
    dparams = LstmParams(w_gifo_x=dwx, w_gifo_r=dwr, bias=dbias,
                         peephole_i_c=dpeep[0], peephole_f_c=dpeep[1],
                         peephole_o_c=dpeep[2], w_r_m=dwrm)
    return dparams, dx, dc, dr


def lstm_fwd_residuals(*args, **kwargs):
    """K1 for a CUDA tensor, its plain version for a CPU tensor."""
    global PLAIN_CALLS
    dev = args[1].device
    if dev.type == "cuda":
        return lstm_fwd_residuals_cuda(*args, **kwargs)
    if dev.type != "cpu":
        raise ValueError(f"lstm_train: unsupported device {dev}")
    PLAIN_CALLS += 1
    return lstm_fwd_residuals_plain(*args, **kwargs)


def lstm_bwd(*args, **kwargs):
    """K2 for a CUDA tensor, its plain version for a CPU tensor."""
    global PLAIN_CALLS
    dev = args[1].device
    if dev.type == "cuda":
        return lstm_bwd_cuda(*args, **kwargs)
    if dev.type != "cpu":
        raise ValueError(f"lstm_train: unsupported device {dev}")
    PLAIN_CALLS += 1
    return lstm_bwd_plain(*args, **kwargs)


# ---------------------------------------------------------------------------
# the differentiable op
# ---------------------------------------------------------------------------

class _LstmTrain(torch.autograd.Function):
    """forward = K1 (residuals kept), backward = K2."""

    @staticmethod
    def forward(ctx, x_tm, c0, r0, w_gifo_x, w_gifo_r, bias, peephole_i_c,
                peephole_f_c, peephole_o_c, w_r_m, keep_mask_tm, cell_clip,
                inv_keep, need_input_grad):
        params = LstmParams(w_gifo_x, w_gifo_r, bias, peephole_i_c,
                            peephole_f_c, peephole_o_c, w_r_m)
        gifo, c_seq, r_seq = lstm_fwd_residuals(
            params, x_tm, c0, r0, keep_mask_tm, inv_keep, cell_clip)
        ctx.save_for_backward(x_tm, c0, r0, *params, keep_mask_tm, gifo,
                              c_seq, r_seq)
        ctx.inv_keep = inv_keep
        ctx.need_input_grad = need_input_grad
        T = x_tm.shape[0]
        return r_seq, c_seq[T - 1].clone(), r_seq[T - 1].clone()

    @staticmethod
    def backward(ctx, g_seq, g_c, g_rT):
        (x_tm, c0, r0, *p, keep_mask_tm, gifo, c_seq,
         r_seq) = ctx.saved_tensors
        params = LstmParams(*p)
        T = x_tm.shape[0]
        g_r = g_seq.contiguous().clone()
        g_r[T - 1] += g_rT
        need_dx = ctx.need_input_grad and ctx.needs_input_grad[0]
        dparams, dx, dc0, dr0 = lstm_bwd(
            params, x_tm, c0, r0, gifo, c_seq, r_seq, keep_mask_tm,
            ctx.inv_keep, g_r, g_c.contiguous(), need_dx)
        return (dx, dc0, dr0, *dparams, None, None, None, None)


def lstm_train(params: LstmParams, x: torch.Tensor, state: LstmState,
               cell_clip: float = 50.0, time_major: bool = False,
               gate_keep_mask: torch.Tensor | None = None,
               keep_prob: float = 1.0, need_input_grad: bool = True
               ) -> tuple[torch.Tensor, LstmState]:
    """One LSTMP layer over a [S, T, I] chunk ([T, S, I] with
    ``time_major``) from the carried ``state``, differentiable in the
    params, x and the state. Returns (r_out with x's layout, final
    state).

    ``gate_keep_mask`` (bool, x's leading layout, last dim 4C) turns on
    inverted gate dropout on the input projection: kept pre-activations
    scale by 1/keep_prob. With ``need_input_grad=False`` the backward
    computes no dx (the layer's input needs none, e.g. the features)."""
    if x.dim() != 3:
        raise ValueError(f"lstm_train: x must be 3-D, got {tuple(x.shape)}")
    T = x.shape[0] if time_major else x.shape[1]
    if T == 0:
        S = x.shape[1] if time_major else x.shape[0]
        out = x.new_empty((0, S, params.recur_dim) if time_major
                          else (S, 0, params.recur_dim))
        return out, state
    x_tm = (x if time_major else x.transpose(0, 1)).contiguous()
    mask_tm = None
    if gate_keep_mask is not None:
        m = gate_keep_mask if time_major else gate_keep_mask.transpose(0, 1)
        mask_tm = m.to(torch.int8).contiguous()
    inv_keep = 1.0 if keep_prob >= 1.0 else 1.0 / keep_prob
    r_seq, c_T, r_T = _LstmTrain.apply(
        x_tm, state.c, state.r, *params, mask_tm, float(cell_clip),
        inv_keep, bool(need_input_grad))
    out = r_seq if time_major else r_seq.transpose(0, 1)
    return out, LstmState(c=c_T, r=r_T)
