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

K1 runs its products on the tensor cores: the input projection hoisted
over all T steps in one launch, then per step the gates (the recurrent
product with the cell math in its epilogue, over a gate-interleaved
copy of Wr) and the projection, tiled by ``fwd_plan``.
``lstm_fwd_tc_plain`` spells that decomposition out in torch (the
hoisted xw with mask and bias, the per-step gates through the
interleaved column order and back, the projection); the CPU tests hold
it against the JAX package's Pallas kernel.

K2 runs its products on the tensor cores, split over the contraction
where a product has too few tiles to fill the card (``bwd_plan``).
``lstm_bwd_split_plain`` spells that decomposition out in torch (the
serial loop writing dgifo, dr_total, h o and dxw, the split-K partials
of the per-step dr added in a fixed order, then the four frame-axis
products from the materialised operands); the CPU tests hold it
against the JAX package's Pallas kernel.

bf16 (``compute_dtype=torch.bfloat16``, the ``--bf16`` training path):
the JAX package's ``set_matmul_dtype(jnp.bfloat16)`` contract of
``lstm_pallas.py`` (``_prepare``, ``_cell_forward``, ``_bwd_kernel``).
Every product rounds its operands to bf16 and sums in float32: x, Wx,
r_{t-1}, Wr, tanh(c) o and Wrm in K1; dr_total and Wrm (dm), dgifo and
Wr (dr), dxw and x (dWx), dgifo and r_{t-1} (dWr), dr_total and h o
(dWrm), dxw and Wx (dx) in K2. K1 stores the gate residual ``gifo`` in
bf16, which K2 reads; the gate math, c, r, dbias and the peephole sums
stay float32. On a CUDA tensor it launches the ``_bf16`` entry points;
the plain versions take the same argument and round the same operands
at the same points (``lstm_cell.rounded``), never a bf16 matmul, which
would round its output too. K2's bf16 entry point is its own design on
bf16 tiles (csrc/lstmp_train.cu): each operand is rounded once where it
is made (a prologue launch rounds the weights, x and r_prev; the
epilogues write dgifo, dxw, dr_total and h o in bf16 beside what stays
f32), dm runs on the tensor cores with the gate gradients as its
epilogue, dr is unsplit and forms the next step's dr_total. Its launch
counts are ``bwd_launches(T, need_dx, bf16=True)``, one more than the
f32 entry point's; ``bwd_plan(..., bf16=True)`` its splits,
``bwd_bf16_launches`` its tiles, ``lstm_bwd_split_plain`` in bf16 its
sums (``_stage_matmul``). K1's bf16 entry point is its own design on the
same tiles in 64-deep stages: a prologue launch rounds the
gate-interleaved Wr, Wrm, Wx, x and r0 once into bf16 copies (one
allocation, ``_ld8`` rows), the gates epilogue writes m in bf16 and the
projection's the next step's bf16 r beside the f32 r; still
``fwd_launches(T)``. ``fwd_plan(..., bf16=True)`` gives its tiles and
the xw's route, ``lstm_fwd_tc_plain`` in bf16 its interleave.

Counters: ``FWD_LAUNCHES`` and ``BWD_LAUNCHES`` count the CUDA kernel
launches of the float32 entry points (K1: ``fwd_launches``, 2 per step
+ 2; K2: ``bwd_launches``, 2 per step + 5, + 1 with dx),
``FWD_BF16_LAUNCHES`` and ``BWD_BF16_LAUNCHES`` those of the bf16 ones
(K1 the same number a call, K2 one more); ``PLAIN_CALLS`` counts the
calls of either half that took the plain version. ``reset_counts``
zeroes them all.
"""

from __future__ import annotations

import ctypes
import functools

import torch

from kaldi_lstm_tpu_torch.ops.lstm_cell import (
    LstmParams,
    LstmState,
    rounded,
)
from kaldi_lstm_tpu_torch.ops.lstm_infer import (
    H100_SMS,
    _check,
    check_compute_dtype,
    check_lstm_operands,
)
from kaldi_lstm_tpu_torch.ops.tc_sum import (
    cell_grad_math,
    cell_math,
    fma_f32,
    tc_matmul,
)

FWD_LAUNCHES = 0
BWD_LAUNCHES = 0
FWD_BF16_LAUNCHES = 0
BWD_BF16_LAUNCHES = 0
PLAIN_CALLS = 0


def reset_counts() -> None:
    global FWD_LAUNCHES, BWD_LAUNCHES, FWD_BF16_LAUNCHES, BWD_BF16_LAUNCHES
    global PLAIN_CALLS
    FWD_LAUNCHES = 0
    BWD_LAUNCHES = 0
    FWD_BF16_LAUNCHES = 0
    BWD_BF16_LAUNCHES = 0
    PLAIN_CALLS = 0


def _entries(bf16: bool = False):
    """K1's and K2's C entry points: the float32 ones, or the bf16 ones."""
    from kaldi_lstm_tpu_torch.ops import _build
    lib = _build.load("lstmp_train")
    tag = "bf16" if bf16 else "f32"
    fwd = getattr(lib, f"lstmp_train_fwd_{tag}")
    bwd = getattr(lib, f"lstmp_train_bwd_{tag}")
    p, i, f = ctypes.c_void_p, ctypes.c_int, ctypes.c_float
    if fwd.argtypes is None:
        fwd.argtypes = [p] * 9 + [f] + ([p] * 10 + [i] * 5 + [f] + [i] * 2
                                        if bf16 else
                                        [p] * 6 + [i] * 5 + [f, i]) + [p]
        fwd.restype = ctypes.c_int
    if bwd.argtypes is None:
        bwd.argtypes = [p] * 11 + [f] + ([p] * 24 + [i] * 10 if bf16
                                         else [p] * 19 + [i] * 10) + [p]
        bwd.restype = ctypes.c_int
    return fwd, bwd


# csrc/lstmp_train.cu's tensor-core products: 64 x 64 output tiles, 32-deep
# stages of the contraction; K1's gate tiles are 64 columns wide, the four
# gates of 16 cells
_TILE, _STAGE = 64, 32
_GATE_CELLS = 16
_PROJ_TILE = 32


def _ld8(n: int) -> int:
    """The row length of a kernel's bf16 copy: n padded to a multiple of
    8 elements (16 bytes)."""
    return -(-n // 8) * 8


def _ctas(M: int, N: int, bm: int, bn: int) -> int:
    return -(-M // bm) * -(-N // bn)


def fwd_plan(T: int, S: int, I: int, C: int, R: int,
             sms: int = H100_SMS, bf16: bool = False) -> dict:
    """K1's tiles. In f32: the hoisted xw [T S, 4C] takes 64 x 64 tiles;
    the per-step gates [S, 4Cp] (Cp = C padded to whole 16-cell tiles)
    take 64 x 64 tiles, or 32 x 64 where 64 rows leave SMs without a
    tile; the per-step projection [S, R] takes 32 x 32 tiles at every
    shape (64 x 64 measured slower wherever tried). No product is split
    over its contraction: r_t feeds step t+1 with no summing pass.

    With ``bf16`` the bf16 design's (csrc/lstmp_train.cu::train_fwd_bf16):
    the gates on ``K1_BF16_GATE_TILE`` (its width 4 x ``gate_cells``,
    which the interleave follows), the hoisted xw's route ("mma": Gemm16
    ``K1_BF16_XW_TILE``; "wg": wgmma 128 x 128 tiles on a persistent
    grid of at most ``sms`` CTAs, where the contraction is deeper than
    one stage), the CTA counts and the Gemm16 kernels' dynamic shared
    memory in bytes."""
    if not bf16:
        Cp = -(-C // _GATE_CELLS) * _GATE_CELLS
        gate_bm = 64 if _ctas(S, 4 * Cp, 64, 64) >= sms else 32
        return {"padded_cells": Cp, "gate_bm": gate_bm,
                "xw_ctas": _ctas(T * S, 4 * C, 64, 64),
                "gate_ctas": _ctas(S, 4 * Cp, gate_bm, 64),
                "proj_ctas": _ctas(S, R, _PROJ_TILE, _PROJ_TILE)}
    bm, bn, wm, wn, stages = K1_BF16_GATE_TILE
    cells = bn // 4
    Cp = -(-C // cells) * cells
    xbm, xbn, xst = K1_BF16_XW_TILE
    pbm, pbn, pst = K1_BF16_PROJ_TILE
    xw_route = "wg" if I > K1_BF16_STAGE else "mma"
    xw_ctas = (min(_ctas(T * S, 4 * C, 128, 128), sms) if xw_route == "wg"
               else _ctas(T * S, 4 * C, xbm, xbn))
    return {"gate_bm": bm, "gate_bn": bn, "gate_threads": 32 * wm * wn,
            "gate_cells": cells, "padded_cells": Cp,
            "gate_ctas": _ctas(S, 4 * Cp, bm, bn),
            "gate_smem": _gemm16_smem(bm, bn, stages, True, True,
                                      K1_BF16_STAGE),
            "xw_route": xw_route, "xw_ctas": xw_ctas,
            "xw_smem": _gemm16_smem(xbm, xbn, xst, True, True,
                                    K1_BF16_STAGE),
            "proj_ctas": _ctas(S, R, pbm, pbn),
            "proj_smem": _gemm16_smem(pbm, pbn, pst, True, True,
                                      K1_BF16_STAGE)}


# csrc/lstmp_train.cu's bf16 K1 tiles (tc::Gemm16 in 64-deep bf16 stages):
# the gate tile (rows, columns = 4 x its cells, warps along m and n, ring
# stages), the hoisted xw's mma-route tile and the projection's (rows,
# columns, stages)
K1_BF16_STAGE = 64
K1_BF16_GATE_TILE = (64, 128, 2, 4, 4)
K1_BF16_GATE_CELLS = K1_BF16_GATE_TILE[1] // 4
K1_BF16_XW_TILE = (64, 64, 4)
K1_BF16_PROJ_TILE = (32, 32, 8)


def fwd_launches(T: int) -> int:
    """K1's launches per call (f32 and bf16 alike): the gate interleave
    (in bf16 the prologue that also rounds the operands), the hoisted xw,
    and gates and projection per step."""
    return 2 * T + 2


def gate_interleave(C: int, cells: int = _GATE_CELLS) -> torch.Tensor:
    """Row p of K1's gate-interleaved copy of w_gifo_r [4C, R] is row
    ``gate_interleave(C, cells)[p]`` of it, or a zero row where that is
    -1 (a padding cell): gate tile b (rows 4 cells b .. 4 cells (b + 1)
    - 1) holds gates g, i, f, o of cells ``cells`` b .. ``cells`` (b + 1)
    - 1 in that order. ``cells`` is the gate tile's width over 4: 16 in
    f32, ``K1_BF16_GATE_CELLS`` in bf16."""
    p = torch.arange(4 * (-(-C // cells) * cells))
    q = (p % (4 * cells)) // cells
    j = (p // (4 * cells)) * cells + p % cells
    return torch.where(j < C, q * C + j, -1)


def gate_deinterleave(C: int, cells: int = _GATE_CELLS) -> torch.Tensor:
    """The inverse: column n of the natural g|i|f|o layout [4C] sits at
    column ``gate_deinterleave(C, cells)[n]`` of the interleaved
    product."""
    rows = gate_interleave(C, cells)
    cols = torch.empty(4 * C, dtype=torch.long)
    real = rows >= 0
    cols[rows[real]] = torch.nonzero(real).flatten()
    return cols


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
             sms: int = H100_SMS, bf16: bool = False) -> dict[str, int]:
    """K2's split counts: the per-step dr = dgifo_t Wr ([S, R] over 4C;
    unsplit in bf16, where its epilogue forms the next step's dr_total),
    dWx ([4C, I] over T S), dWr ([4C, R]), dWrm ([R, C]) and dx ([T S, I]
    over 4C); in bf16 also the column sums' row ranges ("cols": enough
    blocks of 32 columns x ranges for 8 a SM, each range at least 64
    rows)."""
    N = T * S
    plan = {"dr": 1 if bf16 else _split(S, R, 4 * C, sms),
            "wx": _split(4 * C, I, N, sms),
            "wr": _split(4 * C, R, N, sms), "wrm": _split(R, C, N, sms),
            "dx": _split(N, I, 4 * C, sms)}
    if bf16:
        plan["cols"] = max(1, min(-(-8 * sms // -(-7 * C // 32)),
                                  -(-N // 64)))
    return plan


# csrc/lstmp_train.cu's bf16 tiles (tc::Gemm16, 32-deep bf16 stages):
# rows, columns and ring depth of the per-step dm and dr and of the
# frame-axis products
BF16_TILES = {"dm": (32, 32, 8), "dr": (32, 32, 8), "frame": (64, 64, 4)}


def _gemm16_smem(bm: int, bn: int, stages: int, a_kmajor: bool,
                 b_kmajor: bool = False, bk: int = _STAGE) -> int:
    """Dynamic shared memory of a Gemm16 in ``bk``-deep stages: per stage
    a bf16 tile of each operand, [rows][bk + 8] K-major, [bk][rows + 8]
    along the output dimension."""
    def tile(rows, kmajor):
        return rows * (bk + 8) if kmajor else bk * (rows + 8)
    return stages * (tile(bm, a_kmajor) + tile(bn, b_kmajor)) * 2


def bwd_bf16_launches(T: int, S: int, I: int, C: int, R: int,
                      need_dx: bool, sms: int = H100_SMS) -> dict:
    """The bf16 K2's tile launches (csrc/lstmp_train.cu::train_bwd_bf16):
    name -> (grid (x, y, z), dynamic shared memory bytes, launches a
    call): dm and dr per step over [S, C] and [S, R], the frame-axis
    products over their outputs and ``bwd_plan``'s splits."""
    N = T * S
    sp = bwd_plan(T, S, I, C, R, sms, bf16=True)
    out = {}
    for name, tile, M, Nn, z, a_kmajor, n in (
            ("dm", "dm", S, C, 1, True, T), ("dr", "dr", S, R, 1, True, T),
            ("dWx", "frame", 4 * C, I, sp["wx"], False, 1),
            ("dWr", "frame", 4 * C, R, sp["wr"], False, 1),
            ("dWrm", "frame", R, C, sp["wrm"], False, 1),
            ("dx", "frame", N, I, sp["dx"], True, int(need_dx))):
        bm, bn, stages = BF16_TILES[tile]
        out[name] = ((-(-M // bm), -(-Nn // bn), z),
                     _gemm16_smem(bm, bn, stages, a_kmajor), n)
    return out


def bwd_launches(T: int, need_dx: bool, bf16: bool = False) -> int:
    """K2's launches per call: bwd_cell (in bf16 dm with the gate
    gradients) and dr per step; dWx, dWr, dWrm, the column sums and the
    partials' sum; dx; in bf16 also the prologue that rounds the weights,
    x, r_prev and the last step's dr_total once."""
    return 2 * T + 5 + int(need_dx) + int(bf16)


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


def _stage_matmul(a: torch.Tensor, b: torch.Tensor, splits: int = 1,
                  tc: bool = False) -> torch.Tensor:
    """a [M, K] @ b [K, N] as the bf16 tiles sum it (operands already
    rounded): within each of `splits` consecutive ranges of whole stages,
    each 32-deep stage's product summed on its own and added in stage
    order from zero; then the ranges' partial products in range order. A
    stage's product is an IEEE f32 sum, or with ``tc`` the tensor core's
    own (its two mma.sync chained, ``tc_sum.tc_matmul``)."""
    K = a.shape[1]
    ksteps = -(-K // _STAGE)
    kc = -(-ksteps // splits) * _STAGE
    out = a.new_zeros((a.shape[0], b.shape[1]))
    for k0 in range(0, K, kc):
        part = a.new_zeros((a.shape[0], b.shape[1]))
        for s0 in range(k0, min(K, k0 + kc), _STAGE):
            sa, sb = a[:, s0:s0 + _STAGE], b[s0:s0 + _STAGE]
            part = part + (tc_matmul(sa, sb, _STAGE // 16) if tc
                           else sa @ sb)
        out = out + part
    return out


def _col_sums(v: torch.Tensor, w: torch.Tensor | None = None,
              ranges: int = 1) -> torch.Tensor:
    """The column sums of v [N, K] (of v * w with ``w``) as K2's
    col_reduce_kernel makes them: N split into ``ranges`` row ranges;
    in each, 8 running f32 sums over the rows n = r (mod 8), a product
    fused into its add (fmaf(v, w, acc)); then the 8 in order, then the
    ranges in order."""
    N, K = v.shape
    rows = -(-N // ranges)
    per = -(-rows // 8)

    def lay(t):     # [ranges, per, 8, K], each range zero-padded
        t = torch.nn.functional.pad(t, (0, 0, 0, ranges * rows - N))
        return torch.nn.functional.pad(t.view(ranges, rows, K),
                                       (0, 0, 0, 8 * per - rows)).view(
            ranges, per, 8, K)

    vv = lay(v)
    ww = None if w is None else lay(w)
    acc = v.new_zeros((ranges, 8, K))
    for j in range(per):
        acc = acc + vv[:, j] if ww is None else \
            fma_f32(vv[:, j], ww[:, j], acc)
    part = v.new_zeros((ranges, K))
    for r in range(8):
        part = part + acc[:, r]
    out = v.new_zeros(K)
    for y in range(ranges):
        out = out + part[y]
    return out


def _ptr(t: torch.Tensor | None) -> int | None:
    return None if t is None else t.data_ptr()


def _peep(params: LstmParams) -> torch.Tensor:
    return torch.stack([params.peephole_i_c, params.peephole_f_c,
                        params.peephole_o_c]).contiguous()


# ---------------------------------------------------------------------------
# plain versions (CPU tensors; the card holds the kernels against them)
# ---------------------------------------------------------------------------

def _fwd_scan(params: LstmParams, x_tm: torch.Tensor, c0: torch.Tensor,
              r0: torch.Tensor, keep_mask_tm: torch.Tensor | None,
              inv_keep: float, cell_clip: float, recurrent, compute_dtype,
              xw_mm=torch.matmul, proj_mm=torch.matmul, fused: bool = False
              ) -> tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """K1's function with ``recurrent(r)`` [S, 4C] giving r_{t-1} Wr^T
    (its operands rounded to ``compute_dtype``): the hoisted xw = x Wx^T
    (``xw_mm``), times the keep-mask * inv_keep, + bias (one fused
    multiply-add with ``fused``, as K1 bf16's xw epilogue); per step pre =
    xw_t + recurrent(r_{t-1}), the cell (the o peephole reads the clipped
    c_t; ``tc_sum.cell_math`` with ``fused``) and r_t = (tanh(c_t) o)
    Wrm^T (``proj_mm``). With a ``compute_dtype`` the products' operands
    are rounded to it and gifo is stored in it."""
    T, S, I = x_tm.shape
    C = params.cell_dim
    xw = xw_mm(rounded(x_tm.reshape(T * S, I), compute_dtype),
               rounded(params.w_gifo_x, compute_dtype).T
               ).reshape(T, S, 4 * C)
    if keep_mask_tm is not None and fused:
        xw = fma_f32(xw, keep_mask_tm.to(xw.dtype) * inv_keep,
                     params.bias.expand_as(xw))
    else:
        if keep_mask_tm is not None:
            xw = xw * (keep_mask_tm.to(xw.dtype) * inv_keep)
        xw = xw + params.bias
    wrm_t = rounded(params.w_r_m, compute_dtype).T
    gifo = xw.new_empty((T, S, 4 * C), dtype=compute_dtype or xw.dtype)
    c_seq = xw.new_empty((T, S, C))
    r_seq = xw.new_empty((T, S, params.recur_dim))
    c, r = c0, r0
    for t in range(T):
        pre = xw[t] + recurrent(rounded(r, compute_dtype))
        g, i, f, c, o = cell_math(
            pre[:, :C], pre[:, C:2 * C], pre[:, 2 * C:3 * C], pre[:, 3 * C:],
            c, params.peephole_i_c, params.peephole_f_c,
            params.peephole_o_c, cell_clip, fused)
        r = proj_mm(rounded(torch.tanh(c) * o, compute_dtype), wrm_t)
        gifo[t] = torch.cat([g, i, f, o], dim=-1)
        c_seq[t] = c
        r_seq[t] = r
    return gifo, c_seq, r_seq


def lstm_fwd_residuals_plain(params: LstmParams, x_tm: torch.Tensor,
                             c0: torch.Tensor, r0: torch.Tensor,
                             keep_mask_tm: torch.Tensor | None = None,
                             inv_keep: float = 1.0, cell_clip: float = 50.0,
                             compute_dtype=None
                             ) -> tuple[torch.Tensor, torch.Tensor,
                                        torch.Tensor]:
    """K1's outputs in torch ops: (gifo [T, S, 4C] gate activations,
    c_seq [T, S, C] clipped cells, r_seq [T, S, R]) from x [T, S, I].
    gifo is bf16 when ``compute_dtype`` is torch.bfloat16."""
    wr_t = rounded(params.w_gifo_r, compute_dtype).T
    return _fwd_scan(params, x_tm, c0, r0, keep_mask_tm, inv_keep,
                     cell_clip, lambda r: r @ wr_t, compute_dtype)


def lstm_fwd_tc_plain(params: LstmParams, x_tm: torch.Tensor,
                      c0: torch.Tensor, r0: torch.Tensor,
                      keep_mask_tm: torch.Tensor | None = None,
                      inv_keep: float = 1.0, cell_clip: float = 50.0,
                      compute_dtype=None, tc: bool = False
                      ) -> tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """K1's decomposition in torch, the arguments and results of
    ``lstm_fwd_residuals_plain``: the hoisted xw with the mask and the
    bias, then per step the recurrent product against the
    gate-interleaved copy of Wr (zero rows for the padding cells; 16
    cells a tile in f32, ``K1_BF16_GATE_CELLS`` in bf16), taken back to
    the g|i|f|o order and added to xw_t, the cell, and the projection.
    With ``tc`` (bf16 only) it is the bf16 kernel's arithmetic: every
    product summed as its tensor cores sum it (``tc_sum.tc_matmul``: the
    gates and the projection in ``K1_BF16_STAGE``-deep stages of chained
    mma.sync added in f32, the xw likewise on ``fwd_plan``'s "mma" route
    and in one wgmma chain over the whole contraction on its "wg"
    route), and the cell math fused as nvcc compiles it."""
    T, S, I = x_tm.shape
    C = params.cell_dim
    cells = _GATE_CELLS if compute_dtype is None else K1_BF16_GATE_CELLS
    rows = gate_interleave(C, cells).to(x_tm.device)
    cols = gate_deinterleave(C, cells).to(x_tm.device)
    wr_perm = torch.where((rows >= 0)[:, None],
                          params.w_gifo_r[rows.clamp_min(0)], 0.0)
    wr_perm_t = rounded(wr_perm, compute_dtype).T
    if not tc:
        return _fwd_scan(params, x_tm, c0, r0, keep_mask_tm, inv_keep,
                         cell_clip, lambda r: (r @ wr_perm_t)[:, cols],
                         compute_dtype)
    if compute_dtype is None:
        raise ValueError("lstm_fwd_tc_plain: tc models the bf16 kernel's "
                         "sums; give compute_dtype=torch.bfloat16")
    chain = K1_BF16_STAGE // 16
    wg = fwd_plan(T, S, I, C, params.recur_dim, bf16=True)["xw_route"] \
        == "wg"
    return _fwd_scan(params, x_tm, c0, r0, keep_mask_tm, inv_keep,
                     cell_clip,
                     lambda r: tc_matmul(r, wr_perm_t, chain)[:, cols],
                     compute_dtype,
                     xw_mm=lambda x, w: tc_matmul(x, w, None if wg
                                                  else chain),
                     proj_mm=lambda m, w: tc_matmul(m, w, chain), fused=True)


def lstm_bwd_plain(params: LstmParams, x_tm: torch.Tensor,
                   c0: torch.Tensor, r0: torch.Tensor, gifo: torch.Tensor,
                   c_seq: torch.Tensor, r_seq: torch.Tensor,
                   keep_mask_tm: torch.Tensor | None, inv_keep: float,
                   g_r: torch.Tensor, gcT: torch.Tensor, need_dx: bool,
                   compute_dtype=None
                   ) -> tuple[LstmParams, torch.Tensor | None,
                              torch.Tensor, torch.Tensor]:
    """K2 in torch ops: the reverse recurrence over the residuals, then
    the hoisted frame-axis contractions. ``g_r`` [T, S, R] is every r_t's
    cotangent (the final r's already added at T-1), ``gcT`` [S, C] the
    final c's. With a ``compute_dtype`` every product's operands are
    rounded to it (gifo as K1 stored it, in that dtype). Returns
    (dparams, dx [T, S, I] or None, dc0, dr0)."""
    T, S, I = x_tm.shape
    C, R = params.cell_dim, params.recur_dim
    pi, pf, po = (params.peephole_i_c, params.peephole_f_c,
                  params.peephole_o_c)

    def rd(t):
        return rounded(t, compute_dtype)

    wrm, wr, wx = rd(params.w_r_m), rd(params.w_gifo_r), rd(params.w_gifo_x)
    gifo = gifo.to(c_seq.dtype)
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
        dm = rd(dr_total) @ wrm
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
        dr = rd(dgifo[t]) @ wr

    N = T * S
    dg2 = dgifo.reshape(N, 4 * C)
    dxw = dg2 if keep_mask_tm is None else \
        dg2 * (keep_mask_tm.reshape(N, 4 * C).to(dg2.dtype) * inv_keep)
    r_prev = torch.cat([r0[None], r_seq[:-1]]).reshape(N, R)
    c_prev = torch.cat([c0[None], c_seq[:-1]]).reshape(N, C)
    c_all = c_seq.reshape(N, C)
    ho = torch.tanh(c_all) * gifo.reshape(N, 4 * C)[:, 3 * C:]
    dparams = LstmParams(
        w_gifo_x=rd(dxw).T @ rd(x_tm.reshape(N, I)),
        w_gifo_r=rd(dg2).T @ rd(r_prev),
        bias=dg2.sum(0),
        peephole_i_c=(dg2[:, C:2 * C] * c_prev).sum(0),
        peephole_f_c=(dg2[:, 2 * C:3 * C] * c_prev).sum(0),
        peephole_o_c=(dg2[:, 3 * C:] * c_all).sum(0),
        w_r_m=rd(drt.reshape(N, R)).T @ rd(ho),
    )
    dx = (rd(dxw) @ wx).reshape(T, S, I) if need_dx else None
    return dparams, dx, dc, dr


def lstm_bwd_split_plain(params: LstmParams, x_tm: torch.Tensor,
                         c0: torch.Tensor, r0: torch.Tensor,
                         gifo: torch.Tensor, c_seq: torch.Tensor,
                         r_seq: torch.Tensor,
                         keep_mask_tm: torch.Tensor | None, inv_keep: float,
                         g_r: torch.Tensor, gcT: torch.Tensor, need_dx: bool,
                         sms: int = H100_SMS, compute_dtype=None,
                         tc: bool = False
                         ) -> tuple[LstmParams, torch.Tensor | None,
                                    torch.Tensor, torch.Tensor]:
    """K2's decomposition in torch, the arguments and results of
    ``lstm_bwd_plain``: the serial loop writes dgifo, dr_total, h o and
    (with a mask) dxw for every t, the per-step dr comes as ``bwd_plan``'s
    split-K partials that the next step adds in order, then the four
    frame-axis products run from the materialised operands (r_prev made
    contiguous), each split as the kernel splits it. ``compute_dtype``
    as for ``lstm_bwd_plain``; in bf16 it mirrors the bf16 design: dm
    and dr unsplit, every product summed stage by stage
    (``_stage_matmul``) from operands rounded once; with ``tc`` the bf16
    kernel's arithmetic: each stage summed as the tensor cores sum it and
    the gate gradients fused as nvcc compiles them
    (``tc_sum.cell_grad_math``)."""
    T, S, I = x_tm.shape
    C, R = params.cell_dim, params.recur_dim
    N = T * S
    bf16 = compute_dtype is not None
    sp = bwd_plan(T, S, I, C, R, sms, bf16=bf16)
    if tc and not bf16:
        raise ValueError("lstm_bwd_split_plain: tc models the bf16 "
                         "kernel's sums; give compute_dtype=torch.bfloat16")

    def mm(a, b, splits=1):
        return _stage_matmul(a, b, splits, tc) if bf16 else \
            _split_matmul(a, b, splits)

    pi, pf, po = (params.peephole_i_c, params.peephole_f_c,
                  params.peephole_o_c)

    def rd(t):
        return rounded(t, compute_dtype)

    wrm, wr, wx = rd(params.w_r_m), rd(params.w_gifo_r), rd(params.w_gifo_x)
    gifo = gifo.to(c_seq.dtype)
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
        dm = mm(rd(dr_total), wrm) if bf16 else rd(dr_total) @ wrm
        dg, di, df, d_o, dc = cell_grad_math(dm, g, i, f, o, h, cp, dc, pi,
                                             pf, po, tc)
        dgifo[t] = torch.cat([dg, di, df, d_o], dim=-1)
        drt[t] = dr_total
        ho[t] = h * o
        if dxw is not None:
            dxw[t] = dgifo[t] * (keep_mask_tm[t].to(dxw.dtype) * inv_keep)
        dr = mm(rd(dgifo[t]), wr, sp["dr"])

    dg2 = dgifo.reshape(N, 4 * C)
    dxw2 = dg2 if dxw is None else dxw.reshape(N, 4 * C)
    r_prev = torch.cat([r0[None], r_seq[:-1]]).reshape(N, R)
    c_prev = torch.cat([c0[None], c_seq[:-1]]).reshape(N, C)
    c_all = c_seq.reshape(N, C)
    if tc:
        col = functools.partial(_col_sums, ranges=sp["cols"])
        sums = (col(dg2), col(dg2[:, C:2 * C], c_prev),
                col(dg2[:, 2 * C:3 * C], c_prev), col(dg2[:, 3 * C:], c_all))
    else:
        sums = (dg2.sum(0), (dg2[:, C:2 * C] * c_prev).sum(0),
                (dg2[:, 2 * C:3 * C] * c_prev).sum(0),
                (dg2[:, 3 * C:] * c_all).sum(0))
    dparams = LstmParams(
        w_gifo_x=mm(rd(dxw2).T, rd(x_tm.reshape(N, I)), sp["wx"]),
        w_gifo_r=mm(rd(dg2).T, rd(r_prev), sp["wr"]),
        bias=sums[0], peephole_i_c=sums[1], peephole_f_c=sums[2],
        peephole_o_c=sums[3],
        w_r_m=mm(rd(drt.reshape(N, R)).T, rd(ho.reshape(N, C)), sp["wrm"]),
    )
    dx = mm(rd(dxw2), wx, sp["dx"]).reshape(T, S, I) if need_dx else None
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
                            inv_keep: float = 1.0, cell_clip: float = 50.0,
                            compute_dtype=None, plan: dict | None = None
                            ) -> tuple[torch.Tensor, torch.Tensor,
                                       torch.Tensor]:
    """K1 on the card (``lstmp_train_fwd_bf16`` when ``compute_dtype`` is
    torch.bfloat16); same arguments and results as the plain version.
    ``keep_mask_tm`` is int8 [T, S, 4C], contiguous. ``plan`` replaces
    the card's ``fwd_plan`` (a timing tool compares the xw's routes with
    it)."""
    global FWD_LAUNCHES, FWD_BF16_LAUNCHES
    bf16 = check_compute_dtype(compute_dtype, "lstm_train")
    T, S, I = x_tm.shape
    C, R = params.cell_dim, params.recur_dim
    dev = x_tm.device
    _check("x", x_tm, (T, S, I), dev, "lstm_train")
    check_lstm_operands(params, T, S, I, LstmState(c0, r0), dev,
                        "lstm_train")
    _check_mask(keep_mask_tm, (T, S, 4 * C), dev)
    sms = torch.cuda.get_device_properties(dev).multi_processor_count
    if plan is None:
        plan = fwd_plan(T, S, I, C, R, sms, bf16=bf16)
    cont = [t.contiguous() for t in (x_tm, params.w_gifo_x, params.w_gifo_r,
                                     params.bias, params.w_r_m, c0, r0)]
    x_c, wx, wr, bias, wrm, c0c, r0c = cont
    peep = _peep(params)
    f32 = dict(dtype=torch.float32, device=dev)
    gifo = torch.empty((T, S, 4 * C), device=dev,
                       dtype=torch.bfloat16 if bf16 else torch.float32)
    c_seq = torch.empty((T, S, C), **f32)
    r_seq = torch.empty((T, S, R), **f32)
    xw = torch.empty((T, S, 4 * C), **f32)
    if bf16:
        # the bf16 copies wr_b, wrm_b, wx_b, x_b, r_b, m_b in one
        # allocation, each [rows, ld8(cols)]: every one starts 16-byte
        # aligned
        shapes = [(4 * plan["padded_cells"], R), (R, C), (4 * C, I),
                  (T * S, I), (S, R), (S, C)]
        sizes = [rows * _ld8(cols) for rows, cols in shapes]
        flat = torch.empty(sum(sizes), dtype=torch.bfloat16, device=dev)
        scratch = list(flat.split(sizes))
        tail = [int(plan["xw_route"] == "wg"), sms]
    else:
        scratch = [torch.empty((4 * plan["padded_cells"], R), **f32),
                   torch.empty((S, C), **f32)]
        tail = [plan["gate_bm"]]
    fwd, _ = _entries(bf16)
    with torch.cuda.device(dev):
        stream = torch.cuda.current_stream(dev).cuda_stream
        err = fwd(x_c.data_ptr(), wx.data_ptr(), wr.data_ptr(),
                  bias.data_ptr(), peep.data_ptr(), wrm.data_ptr(),
                  c0c.data_ptr(), r0c.data_ptr(), _ptr(keep_mask_tm),
                  float(inv_keep), gifo.data_ptr(), c_seq.data_ptr(),
                  r_seq.data_ptr(), xw.data_ptr(),
                  *(t.data_ptr() for t in scratch), T, S, I, C, R,
                  float(cell_clip), *tail, stream)
    if err != 0:
        raise RuntimeError(f"lstm_train: K1 launch failed with CUDA error "
                           f"{err}")
    if bf16:
        FWD_BF16_LAUNCHES += fwd_launches(T)
    else:
        FWD_LAUNCHES += fwd_launches(T)
    return gifo, c_seq, r_seq


def lstm_bwd_cuda(params: LstmParams, x_tm: torch.Tensor, c0: torch.Tensor,
                  r0: torch.Tensor, gifo: torch.Tensor, c_seq: torch.Tensor,
                  r_seq: torch.Tensor, keep_mask_tm: torch.Tensor | None,
                  inv_keep: float, g_r: torch.Tensor, gcT: torch.Tensor,
                  need_dx: bool, compute_dtype=None
                  ) -> tuple[LstmParams, torch.Tensor | None, torch.Tensor,
                             torch.Tensor]:
    """K2 on the card (``lstmp_train_bwd_bf16``, reading a bf16 gifo,
    when ``compute_dtype`` is torch.bfloat16); same arguments and results
    as the plain version."""
    global BWD_LAUNCHES, BWD_BF16_LAUNCHES
    bf16 = check_compute_dtype(compute_dtype, "lstm_train")
    T, S, I = x_tm.shape
    C, R = params.cell_dim, params.recur_dim
    dev = x_tm.device
    _check("x", x_tm, (T, S, I), dev, "lstm_train")
    check_lstm_operands(params, T, S, I, LstmState(c0, r0), dev,
                        "lstm_train")
    _check("gifo", gifo, (T, S, 4 * C), dev, "lstm_train",
           torch.bfloat16 if bf16 else torch.float32)
    for name, t, shape in (("c_seq", c_seq, (T, S, C)),
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
                  torch.cuda.get_device_properties(dev).multi_processor_count,
                  bf16=bf16)
    if not need_dx:
        sp["dx"] = 1
    N = T * S

    def partials(key, rows, cols):
        return torch.empty((sp[key], rows, cols), **f32) if sp[key] > 1 \
            else None

    dc = gcT.contiguous().clone()
    dr = torch.empty((S, R), **f32)
    dgifo = torch.empty((T, S, 4 * C), **f32)
    parts = [partials("wx", 4 * C, I), partials("wr", 4 * C, R),
             partials("wrm", R, C), partials("dx", N, I)]
    if bf16:
        parts.append(partials("cols", 1, 7 * C))
    if bf16:
        def b16(*shape):
            # a bf16 copy, its rows padded to a multiple of 8 elements
            return torch.empty((*shape[:-1], _ld8(shape[-1])),
                               dtype=torch.bfloat16, device=dev)
        scratch = [dgifo, b16(T, S, 4 * C),                   # dgifo_b
                   None if keep_mask_tm is None
                   else b16(T, S, 4 * C),                     # dxw_b
                   b16(T, S, R), b16(T, S, C),                # drt_b, ho_b
                   b16(N, I), b16(N, R),                      # x_b, rprev_b
                   b16(4 * C, R), b16(R, C), b16(4 * C, I),   # weights
                   *parts]
        splits = [sp["wx"], sp["wr"], sp["wrm"], sp["dx"], sp["cols"]]
    else:
        scratch = [dgifo,
                   torch.empty((T, S, R), **f32),               # dr_total
                   torch.empty((T, S, C), **f32),               # h o
                   None if keep_mask_tm is None
                   else torch.empty((T, S, 4 * C), **f32),      # dxw
                   torch.empty((T, S, R), **f32),               # r_prev
                   torch.empty((sp["dr"], S, R), **f32),        # dr partials
                   *parts]
        splits = [sp["dr"], sp["wx"], sp["wr"], sp["wrm"], sp["dx"]]
    dx = torch.empty((T, S, I), **f32) if need_dx else None
    dwx = torch.empty((4 * C, I), **f32)
    dwr = torch.empty((4 * C, R), **f32)
    dwrm = torch.empty((R, C), **f32)
    dbias = torch.empty((4 * C,), **f32)
    dpeep = torch.empty((3, C), **f32)
    x_c, wx, wr, wrm, c0c, r0c, gifo_c, c_c, r_c, g_r_c = cont
    _, bwd = _entries(bf16)
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
                  *splits, stream)
    if err != 0:
        raise RuntimeError(f"lstm_train: K2 launch failed with CUDA error "
                           f"{err}")
    if bf16:
        BWD_BF16_LAUNCHES += bwd_launches(T, need_dx, bf16=True)
    else:
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
                inv_keep, need_input_grad, compute_dtype):
        params = LstmParams(w_gifo_x, w_gifo_r, bias, peephole_i_c,
                            peephole_f_c, peephole_o_c, w_r_m)
        gifo, c_seq, r_seq = lstm_fwd_residuals(
            params, x_tm, c0, r0, keep_mask_tm, inv_keep, cell_clip,
            compute_dtype)
        ctx.save_for_backward(x_tm, c0, r0, *params, keep_mask_tm, gifo,
                              c_seq, r_seq)
        ctx.inv_keep = inv_keep
        ctx.need_input_grad = need_input_grad
        ctx.compute_dtype = compute_dtype
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
            ctx.inv_keep, g_r, g_c.contiguous(), need_dx, ctx.compute_dtype)
        return (dx, dc0, dr0, *dparams, None, None, None, None, None)


def lstm_train(params: LstmParams, x: torch.Tensor, state: LstmState,
               cell_clip: float = 50.0, time_major: bool = False,
               gate_keep_mask: torch.Tensor | None = None,
               keep_prob: float = 1.0, need_input_grad: bool = True,
               compute_dtype=None) -> tuple[torch.Tensor, LstmState]:
    """One LSTMP layer over a [S, T, I] chunk ([T, S, I] with
    ``time_major``) from the carried ``state``, differentiable in the
    params, x and the state. Returns (r_out with x's layout, final
    state).

    ``gate_keep_mask`` (bool, x's leading layout, last dim 4C) turns on
    inverted gate dropout on the input projection: kept pre-activations
    scale by 1/keep_prob. With ``need_input_grad=False`` the backward
    computes no dx (the layer's input needs none, e.g. the features).
    ``compute_dtype`` (None or torch.bfloat16) is the products' operand
    dtype (the module docstring's bf16 contract)."""
    if x.dim() != 3:
        raise ValueError(f"lstm_train: x must be 3-D, got {tuple(x.shape)}")
    check_compute_dtype(compute_dtype, "lstm_train")
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
        inv_keep, bool(need_input_grad), compute_dtype)
    out = r_seq if time_major else r_seq.transpose(0, 1)
    return out, LstmState(c=c_T, r=r_T)
