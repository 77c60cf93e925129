"""Two stacked LSTMP layers on the wavefront schedule: the hand-written
CUDA counterparts of ``kaldi_lstm_tpu/ops/lstm_stack_pallas.py``'s
``_fwd2_kernel`` (K6) and ``_infer2_kernel`` (K7).

Layer 1 takes x [T, S, I], layer 2 takes layer 1's r; the two layers
share the cell and projection widths (``stack_compatible``). The
wavefront runs layer 2 one step (K7) or one time block (K6) behind
layer 1, so one launch covers both layers (see ``csrc/lstmp_stack.cu``).
``tb`` is the number of timesteps per block and must divide T; the
default is the largest divisor of T up to 5, as the JAX package plans
its time blocks. K6's launches follow it; K7 checks it and is one
persistent launch whatever it is.

* ``lstm_stack_fwd2`` (K6): the training forward of both layers with
  K1's residuals for each, ``(gifo1, c1, r1, gifo2, c2, r2)``, every one
  [T, S, .] and unpadded: the post-activation gates g, i, f, o (float32,
  or bf16 under bf16), the clipped c and r (float32).
  ``lstm_train.lstm_bwd`` takes each layer's triple as it takes K1's
  (layer 2's x is r1). On the card it runs K1's tensor-core tiles:
  the hoisted input projection of layer 1, layer 2's per time block,
  and per wavefront step one gates and one projection launch over both
  layers (tiles from ``fwd2_plan``).
* ``lstm_stack_infer2`` (K7): the inference forward; returns (r2
  [T, S, R], final state of layer 1, final state of layer 2). On the
  card it is K5's persistent, weight-resident cooperative kernel over
  both layers (``infer2_plan``).

``compute_dtype`` (None or torch.bfloat16, ``lstm_infer.
check_compute_dtype``): the JAX package's ``set_matmul_dtype`` contract,
under which ``_prep2`` casts both layers' weights and the kernels cast
their operands to bf16 before each dot. With bf16 the ``_bf16`` entry
points run, each its own design with every operand rounded once where
it is made: K6 bf16 on K1 bf16's tiles (``csrc/lstmp_tc16.cuh``; tiles
and xw routes from ``fwd2_plan(..., bf16=True)``, its decomposition
``lstm_stack_fwd2_tc_plain``), K7 bf16 on K5 bf16's persistent mma.sync
recurrence with both layers' gate rows fed by one staged [x | r1 | r2]
row (plan ``k7_bf16_plan``, decomposition ``lstm_stack_infer2_tc_plain``).
The plain versions round the same operands (``lstm_fwd_residuals_plain``
and ``lstm_scan`` with the same ``compute_dtype``).

On a CUDA tensor each launches its kernel or raises; on a CPU tensor it
runs the plain version beside it here, the serial composition of the
one-layer functions (``lstm_train.lstm_fwd_residuals_plain`` twice,
``lstm_cell.lstm_scan`` twice). It never falls back from the card to the
plain version. No dropout and no advance mask, as the TPU kernels take
neither. The results are not differentiable: a gradient goes through
``lstm_train.lstm_bwd`` layer by layer.

``phases`` ("both" | "l1" | "l2") is the reference's timing ablation of
K6: one layer's work is left out. With "l2", layer 2 runs over r1 = 0
(layer 1 never runs). The outputs of the left-out layer are unspecified
on the card and zero in the plain version.

Counters: ``FWD2_LAUNCHES`` and ``INFER2_LAUNCHES`` count the CUDA kernel
launches of the float32 entry points (``wavefront_launches`` per call),
``FWD2_BF16_LAUNCHES`` and ``INFER2_BF16_LAUNCHES`` those of the bf16
ones; ``PLAIN_CALLS`` counts the calls that took a plain version.
``reset_counts`` zeroes them all.
"""

from __future__ import annotations

import ctypes
import functools

import torch

from kaldi_lstm_tpu_torch.ops.lstm_cell import (
    LstmParams,
    LstmState,
    lstm_scan,
    rounded,
)
from kaldi_lstm_tpu_torch.ops.lstm_infer import (
    _TILE_STREAMS,
    _UNIT_FLOATS,
    _WARPS,
    H100_OPTIN,
    H100_SMS,
    _check,
    _kernel_operands,
    _mma_tile,
    _pad,
    _up,
    check_compute_dtype,
    check_lstm_operands,
    mma_ksplit,
)
from kaldi_lstm_tpu_torch.ops.lstm_train import (
    _GATE_CELLS,
    K1_BF16_GATE_TILE,
    K1_BF16_PROJ_TILE,
    K1_BF16_STAGE,
    K1_BF16_XW_TILE,
    _ctas,
    _gemm16_smem,
    _ld8,
    _peep,
    lstm_fwd_residuals_plain,
    lstm_fwd_tc_plain,
)
from kaldi_lstm_tpu_torch.ops.tc_sum import cell_math

FWD2_LAUNCHES = 0
INFER2_LAUNCHES = 0
FWD2_BF16_LAUNCHES = 0
INFER2_BF16_LAUNCHES = 0
PLAIN_CALLS = 0

PHASES = {"both": 0, "l1": 1, "l2": 2}
MAX_TIME_BLOCK = 5


def reset_counts() -> None:
    global FWD2_LAUNCHES, INFER2_LAUNCHES, FWD2_BF16_LAUNCHES
    global INFER2_BF16_LAUNCHES, PLAIN_CALLS
    FWD2_LAUNCHES = 0
    INFER2_LAUNCHES = 0
    FWD2_BF16_LAUNCHES = 0
    INFER2_BF16_LAUNCHES = 0
    PLAIN_CALLS = 0


def stack_compatible(p1: LstmParams, p2: LstmParams) -> bool:
    """The wavefront needs equal cell and projection widths and layer 2's
    input width equal to layer 1's output width."""
    return (p1.cell_dim == p2.cell_dim
            and p1.recur_dim == p2.recur_dim
            and p2.input_dim == p1.recur_dim)


def time_block(T: int, tb: int | None = None) -> int:
    """``tb`` checked against T (it must divide T), or the default: the
    largest divisor of T up to MAX_TIME_BLOCK."""
    if T <= 0:
        raise ValueError(f"lstm_stack: T must be positive, got {T}")
    if tb is None:
        return next(b for b in range(min(MAX_TIME_BLOCK, T), 0, -1)
                    if T % b == 0)
    if isinstance(tb, bool) or not isinstance(tb, int) or tb < 1 \
            or T % tb != 0:
        raise ValueError(f"lstm_stack: tb={tb!r} must be a positive "
                         f"divisor of T={T}")
    return tb


def wavefront_launches(T: int, tb: int, phases: str = "both",
                       kernel: str = "fwd2") -> int:
    """CUDA launches of one call, the same in f32 and bf16. K6
    (``kernel="fwd2"``): one launch making the running layers'
    gate-interleaved Wr copies, layer 1's hoisted input projection (when
    it runs), layer 2's hoisted input projection per time block, and per
    wavefront step one gates and one projection launch over the running
    layers (T + tb steps with both layers, T with one). K7
    (``kernel="infer2"``, both layers only): one persistent launch."""
    if kernel == "infer2":
        if phases != "both":
            raise ValueError("lstm_stack: K7 runs both layers")
        return 1
    if kernel != "fwd2":
        raise ValueError(f"lstm_stack: kernel must be 'fwd2' or 'infer2', "
                         f"got {kernel!r}")
    K = T // tb
    if phases == "l1":
        return 2 + 2 * T
    if phases == "l2":
        return 1 + K + 2 * T
    return 2 + K + 2 * (T + tb)


def fwd2_plan(S: int, C: int, phases: str = "both",
              sms: int = H100_SMS, bf16: bool = False,
              T: int | None = None, I: int | None = None,
              R: int | None = None, tb: int | None = None) -> dict:
    """K6's tiles. In f32: the gate tile's rows, 64 where the running
    layers' 64 x 64 tiles (both layers' in one launch) fill the card,
    else 32; the projection takes K1's 32 x 32 tiles. Returns the padded
    cells and the gate tile's rows.

    With ``bf16`` (needs T, I, R and tb) the bf16 design's
    (csrc/lstmp_stack.cu::stack_fwd2_bf16, on K1 bf16's tiles): the
    gates on ``K1_BF16_GATE_TILE`` over both running layers (Cp = C
    padded to its 32 cells), the projection on ``K1_BF16_PROJ_TILE``,
    the hoisted xw1 over T S rows and xw2 over tb S rows each on K1
    bf16's route for its contraction ("mma" at most one 64-deep stage,
    "wg" past it: wgmma 128 x 128 tiles on a persistent grid of at most
    ``sms`` CTAs); CTA counts a launch and the Gemm16 kernels' dynamic
    shared memory in bytes."""
    layers = 2 if phases == "both" else 1
    if not bf16:
        Cp = -(-C // _GATE_CELLS) * _GATE_CELLS
        gate_bm = 64 if layers * _ctas(S, 4 * Cp, 64, 64) >= sms else 32
        return {"padded_cells": Cp, "gate_bm": gate_bm}
    if None in (T, I, R, tb):
        raise ValueError("lstm_stack: fwd2_plan in bf16 needs T, I, R, tb")
    bm, bn, wm, wn, stages = K1_BF16_GATE_TILE
    cells = bn // 4
    Cp = -(-C // cells) * cells
    xbm, xbn, xst = K1_BF16_XW_TILE
    pbm, pbn, pst = K1_BF16_PROJ_TILE

    def xw(rows, depth):
        route = "wg" if depth > K1_BF16_STAGE else "mma"
        ctas = (min(_ctas(rows, 4 * C, 128, 128), sms) if route == "wg"
                else _ctas(rows, 4 * C, xbm, xbn))
        return route, ctas

    xw1_route, xw1_ctas = xw(T * S, I)
    xw2_route, xw2_ctas = xw(tb * S, R)
    return {"gate_bm": bm, "gate_bn": bn, "gate_threads": 32 * wm * wn,
            "gate_cells": cells, "padded_cells": Cp, "layers": layers,
            "gate_ctas": layers * _ctas(S, 4 * Cp, bm, bn),
            "gate_smem": _gemm16_smem(bm, bn, stages, True, True,
                                      K1_BF16_STAGE),
            "xw1_route": xw1_route, "xw1_ctas": xw1_ctas,
            "xw2_route": xw2_route, "xw2_ctas": xw2_ctas,
            "xw_smem": _gemm16_smem(xbm, xbn, xst, True, True,
                                    K1_BF16_STAGE),
            "proj_ctas": layers * _ctas(S, R, pbm, pbn),
            "proj_smem": _gemm16_smem(pbm, pbn, pst, True, True,
                                      K1_BF16_STAGE)}


# the fields of K7 bf16's plan, in the order lstmp_stack_infer2_plan
# writes them (csrc/lstmp_stack.cu::Tc2Plan)
K7_BF16_PLAN_KEYS = (
    "grid", "sms", "ncell", "gcgroups", "gsgroups", "gnsg", "gate_ctas",
    "mg", "mq", "qgroups", "sgroups", "nsg", "proj_ctas", "xp", "rp", "kg1",
    "kg2", "kg", "ksg", "cp", "kq", "ksq", "ns_g", "ns_q", "res_g1",
    "res_q", "res_g2", "c_smem", "part_floats", "stage_elems", "off_cst",
    "off_c", "off_g1", "off_q", "off_g2", "off_stage", "smem")


def _k7_part_floats(q: dict, ns_g: int, ns_q: int) -> int:
    """K7 bf16's partial sums for tiles of ns_g / ns_q streams: 128
    floats an output tile and split (csrc/lstmp_stack.cu::
    tc2_part_floats)."""
    gate = 2 * (q["mg"] // 16) * (ns_g // 8)
    proj = (q["mq"] // 16) * (ns_q // 8)
    return _UNIT_FLOATS * max(_WARPS, gate, proj)


def _k7_stage_bytes(q: dict, ns_g: int, ns_q: int) -> int:
    """Shared bytes of K7 bf16's staging buffers and partial sums for
    tiles of ns_g / ns_q streams (csrc/lstmp_stack.cu::tc2_stage_bytes)."""
    stage = 2 * 2 * max(ns_g * q["ksg"], ns_q * q["ksq"])
    return stage + 4 * _k7_part_floats(q, ns_g, ns_q)


def _even_tile(n: int, most: int) -> int:
    """Tiles of at most `most` over n, as even as multiples of 8 allow."""
    return _up(-(-n // -(-n // most)), 8)


def _k7_tiles(q: dict, avail: int) -> tuple[int, int] | None:
    """The largest staging tiles (multiples of 8 up to 64) that fit in
    `avail` bytes, or None where two 8-stream tiles do not."""
    for most in range(_TILE_STREAMS, 7, -8):
        ng, nq = _even_tile(q["gnsg"], most), _even_tile(q["nsg"], most)
        if _k7_stage_bytes(q, ng, nq) <= avail:
            return ng, nq
    return None


def _k7_bf16_plan_for(S: int, I: int, C: int, R: int, sms: int,
                      optin: int, gs: int) -> dict | None:
    """csrc/lstmp_stack.cu::tc2_plan_for: the plan with the gate streams
    in ``gs`` groups, or None where two 8-stream tiles do not fit."""
    q = {"sms": sms}
    q["ncell"] = ncell = _up(-(-C // (sms // gs)), 4)
    q["gcgroups"] = -(-C // ncell)
    q["gnsg"] = _up(-(-S // gs), 8)
    q["gsgroups"] = -(-S // q["gnsg"])
    q["gate_ctas"] = q["gcgroups"] * q["gsgroups"]
    q["mg"] = 4 * ncell
    r_tiles = -(-R // 16)            # both layers' column groups fit
    q["mq"] = 16 * -(-r_tiles // (sms // 2))
    q["qgroups"] = -(-R // q["mq"])
    sgroups = max(1, min(sms // (2 * q["qgroups"]), -(-S // 8)))
    q["nsg"] = _up(-(-S // sgroups), 8)
    q["sgroups"] = -(-S // q["nsg"])
    q["proj_ctas"] = 2 * q["qgroups"] * q["sgroups"]
    q["grid"] = max(q["gate_ctas"], q["proj_ctas"])
    q["xp"], q["rp"] = _up(I, 16), _up(R, 16)
    q["kg1"], q["kg2"] = q["xp"] + q["rp"], 2 * q["rp"]
    q["kg"] = q["xp"] + 2 * q["rp"]
    q["ksg"] = q["kg"] + 8
    q["cp"] = _up(C, 8)
    q["kq"] = _up(q["cp"], 16)
    q["ksq"] = q["kq"] + 8
    cst = 4 * 2 * _up(7 * ncell, 4)
    cstate = 4 * 2 * _up(q["gnsg"] * ncell, 4)
    sizes = {"g1": 2 * q["mg"] * (q["kg1"] + 8),
             "q": 2 * q["mq"] * (q["kq"] + 8),
             "g2": 2 * q["mg"] * (q["kg2"] + 8)}
    least = _k7_stage_bytes(q, 8, 8)
    used, held = cst, True
    for name in ("g1", "q", "g2"):       # the order they stay resident
        held = held and used + sizes[name] + least <= optin
        q[f"res_{name}"] = int(held)
        used += sizes[name] if held else 0
    tiles = _k7_tiles(q, optin - used)
    if tiles is None:
        return None

    def count(ns):          # staged tiles a step, both phases
        return -(-q["gnsg"] // ns[0]) + -(-q["nsg"] // ns[1])

    with_c = _k7_tiles(q, optin - used - cstate)
    q["c_smem"] = int(with_c is not None and count(with_c) == count(tiles))
    q["ns_g"], q["ns_q"] = with_c if q["c_smem"] else tiles
    q["part_floats"] = _k7_part_floats(q, q["ns_g"], q["ns_q"])
    q["stage_elems"] = max(q["ns_g"] * q["ksg"], q["ns_q"] * q["ksq"])
    off = 4 * q["part_floats"]
    q["off_cst"] = off
    off += cst
    q["off_c"] = off
    off += cstate if q["c_smem"] else 0
    for name in ("g1", "q", "g2"):
        q[f"off_{name}"] = off
        off += sizes[name] if q[f"res_{name}"] else 0
    q["off_stage"] = off
    q["smem"] = off + 2 * 2 * q["stage_elems"]
    return {k: q[k] for k in K7_BF16_PLAN_KEYS}


def k7_bf16_plan(S: int, I: int, C: int, R: int, sms: int = H100_SMS,
                 optin: int = H100_OPTIN) -> dict:
    """K7 bf16's plan (csrc/lstmp_stack.cu::make_tc2_plan), field for
    field. Gates: ``gate_ctas`` CTAs, each ``ncell`` cells (ceil(C gs /
    SMs) rounded up to 4) of BOTH layers for one of ``gsgroups`` stream
    groups of ``gnsg`` streams (two groups from S=128 on where that plan
    keeps every slice resident with tiles of 32 streams or more, else
    one). Projection: ``proj_ctas`` = 2 x ``qgroups`` x ``sgroups`` CTAs,
    each ``mq`` columns (16, one m16 tile) of one layer for one stream
    group of ``nsg``. The staged gate row is [x | r1 | r2], x and r
    padded to 16 (``xp``, ``rp``): layer 1 contracts over ``kg1`` = xp +
    rp from element 0, layer 2 over ``kg2`` = 2 rp from element xp. Shared
    memory: the partial sums and both layers' bias and peepholes; layer
    1's gate slice, the projection slice and layer 2's gate slice in
    that order, each resident (``res_*``) while it and those before it
    leave room for two 8-stream staging tiles (the rest in device
    memory); staging tiles (``ns_g``, ``ns_q``: at most 64, as even as
    multiples of 8 allow) as large as the rest allows; the c state
    (``c_smem``) only where it does not make the tiles more."""
    if S >= 128:
        two = _k7_bf16_plan_for(S, I, C, R, sms, optin, 2)
        if two is not None and two["res_g1"] and two["res_q"] \
                and two["res_g2"] and two["ns_g"] >= 32:
            return two
    one = _k7_bf16_plan_for(S, I, C, R, sms, optin, 1)
    if one is None:
        raise ValueError(f"lstm_stack: no K7 bf16 plan for S={S} I={I} "
                         f"C={C} R={R}: two 8-stream tiles do not fit")
    return one


def _check_stack(p1: LstmParams, p2: LstmParams, x_tm: torch.Tensor,
                 s1: LstmState, s2: LstmState, tb, phases: str,
                 compute_dtype=None
                 ) -> tuple[int, int, int, int, int, int]:
    """Shapes, dtypes and devices of both layers' operands and the
    compute dtype; returns (T, S, I, C, R, tb)."""
    check_compute_dtype(compute_dtype, "lstm_stack")
    if x_tm.dim() != 3:
        raise ValueError(f"lstm_stack: x must be 3-D [T, S, I], got "
                         f"{tuple(x_tm.shape)}")
    if phases not in PHASES:
        raise ValueError(f"lstm_stack: phases must be one of "
                         f"{sorted(PHASES)}, got {phases!r}")
    if not stack_compatible(p1, p2):
        raise ValueError(
            f"lstm_stack: layers are not stack-compatible (C {p1.cell_dim}/"
            f"{p2.cell_dim}, R {p1.recur_dim}/{p2.recur_dim}, layer-2 input "
            f"{p2.input_dim})")
    T, S, I = x_tm.shape
    dev = x_tm.device
    _check("x", x_tm, (T, S, I), dev, "lstm_stack")
    check_lstm_operands(p1, T, S, I, s1, dev, "lstm_stack")
    check_lstm_operands(p2, T, S, p1.recur_dim, s2, dev, "lstm_stack")
    return T, S, I, p1.cell_dim, p1.recur_dim, time_block(T, tb)


# ---------------------------------------------------------------------------
# plain versions (CPU tensors; the card holds the kernels against them)
# ---------------------------------------------------------------------------

@torch.no_grad()
def lstm_stack_fwd2_plain(p1: LstmParams, p2: LstmParams, x_tm: torch.Tensor,
                          s1: LstmState, s2: LstmState,
                          cell_clip: float = 50.0, phases: str = "both",
                          compute_dtype=None) -> tuple[torch.Tensor, ...]:
    """K6's outputs in torch ops: K1's plain version over layer 1, then
    over layer 2 with r1 as its input, each with ``compute_dtype``."""
    T, S, _ = x_tm.shape
    C, R = p1.cell_dim, p1.recur_dim
    if phases == "l2":
        l1 = (x_tm.new_zeros((T, S, 4 * C), dtype=compute_dtype
                             or x_tm.dtype),
              x_tm.new_zeros((T, S, C)), x_tm.new_zeros((T, S, R)))
    else:
        l1 = lstm_fwd_residuals_plain(p1, x_tm, s1.c, s1.r,
                                      cell_clip=cell_clip,
                                      compute_dtype=compute_dtype)
    if phases == "l1":
        l2 = tuple(torch.zeros_like(t) for t in l1)
    else:
        l2 = lstm_fwd_residuals_plain(p2, l1[2], s2.c, s2.r,
                                      cell_clip=cell_clip,
                                      compute_dtype=compute_dtype)
    return (*l1, *l2)


@torch.no_grad()
def lstm_stack_infer2_plain(p1: LstmParams, p2: LstmParams,
                            x_tm: torch.Tensor, s1: LstmState, s2: LstmState,
                            cell_clip: float = 50.0, compute_dtype=None
                            ) -> tuple[torch.Tensor, LstmState, LstmState]:
    """K7's outputs in torch ops: two eager scans with ``compute_dtype``."""
    r1, f1 = lstm_scan(p1, x_tm, s1, cell_clip, compute_dtype=compute_dtype,
                       time_major=True)
    r2, f2 = lstm_scan(p2, r1, s2, cell_clip, compute_dtype=compute_dtype,
                       time_major=True)
    return r2, f1, f2


@torch.no_grad()
def lstm_stack_fwd2_tc_plain(p1: LstmParams, p2: LstmParams,
                             x_tm: torch.Tensor, s1: LstmState,
                             s2: LstmState, cell_clip: float = 50.0,
                             phases: str = "both", tc: bool = False
                             ) -> tuple[torch.Tensor, ...]:
    """K6 bf16's decomposition in torch: K1 bf16's (``lstm_train.
    lstm_fwd_tc_plain`` in bf16: the gate interleave at 32 cells, every
    operand rounded once) over layer 1, then over layer 2 with r1 as its
    input (xw2 from r1's rounded copy); with ``tc`` K1 bf16's arithmetic
    (``lstm_fwd_tc_plain``'s). Outputs as ``lstm_stack_fwd2_plain``'s."""
    T, S, _ = x_tm.shape
    C, R = p1.cell_dim, p1.recur_dim
    bf = torch.bfloat16
    if phases == "l2":
        l1 = (x_tm.new_zeros((T, S, 4 * C), dtype=bf),
              x_tm.new_zeros((T, S, C)), x_tm.new_zeros((T, S, R)))
    else:
        l1 = lstm_fwd_tc_plain(p1, x_tm, s1.c, s1.r, cell_clip=cell_clip,
                               compute_dtype=bf, tc=tc)
    if phases == "l1":
        l2 = tuple(torch.zeros_like(t) for t in l1)
    else:
        l2 = lstm_fwd_tc_plain(p2, l1[2], s2.c, s2.r, cell_clip=cell_clip,
                               compute_dtype=bf, tc=tc)
    return (*l1, *l2)


def _k7_rows(p: LstmParams, xo: int, kk: int) -> torch.Tensor:
    """One layer's gate weights [4C, kk] in K7 bf16's padded layout:
    Wx in columns [0, I_l), Wr from column xo, zero elsewhere; rounded."""
    C4, n_in = p.w_gifo_x.shape
    R = p.w_gifo_r.shape[1]
    w = p.w_gifo_x.new_zeros((C4, kk))
    w[:, :n_in] = p.w_gifo_x
    w[:, xo:xo + R] = p.w_gifo_r
    return rounded(w, torch.bfloat16)


@torch.no_grad()
def lstm_stack_infer2_tc_plain(p1: LstmParams, p2: LstmParams,
                               x_tm: torch.Tensor, s1: LstmState,
                               s2: LstmState, cell_clip: float = 50.0,
                               sms: int = H100_SMS, optin: int = H100_OPTIN,
                               tc: bool = False
                               ) -> tuple[torch.Tensor, LstmState,
                                          LstmState]:
    """K7 bf16's decomposition in torch (``k7_bf16_plan``): the weights,
    x, r01 and r02 rounded once; per wavefront step k each gate CTA's
    rows of both layers (layer 1 at t = k while k < T, layer 2 at t = k -
    1 from k = 1) against its stream group's staged [x_k | r1 | r2], tile
    by tile of ``ns_g`` streams, the two row sets' slices split over
    ``mma_ksplit`` of their m16 tiles together (``_mma_tile``), the cell
    math writing c and the rounded m of each layer; then each projection
    CTA's columns of its layer from the staged m, tiles of ``ns_q``
    streams: r1_k and r2_{k-1}, each rounded for the next step. With
    ``tc`` it is the kernel's arithmetic: each slice summed as the tensor
    core sums it and the cell math fused as nvcc compiles it. Returns
    ``lstm_stack_infer2_plain``'s results."""
    T, S, I = x_tm.shape
    C, R = p1.cell_dim, p1.recur_dim
    pl = k7_bf16_plan(S, I, C, R, sms, optin)
    bf = torch.bfloat16
    xp, rp, mg, mq, ncell = pl["xp"], pl["rp"], pl["mg"], pl["mq"], \
        pl["ncell"]
    ps = (p1, p2)
    wg = (_k7_rows(p1, xp, pl["kg1"]), _k7_rows(p2, rp, pl["kg2"]))
    koff = (0, xp)
    wq = [rounded(_pad(p.w_r_m, pl["kq"]), bf) for p in ps]      # [R, kq]
    xb = rounded(_pad(x_tm, xp), bf)
    rb = [rounded(_pad(s.r, rp), bf) for s in (s1, s2)]
    c = [s1.c.clone(), s2.c.clone()]
    r1 = s1.r.clone()
    r2 = x_tm.new_empty((T, S, R))
    for k in range(T + 1):
        live = [l for l, on in ((0, k < T), (1, k > 0)) if on]
        a = torch.cat([xb[min(k, T - 1)], rb[0], rb[1]], dim=1)
        mb = [x_tm.new_zeros((S, pl["kq"])) for _ in ps]
        for b in range(pl["gate_ctas"]):
            j0, sg = (b % pl["gcgroups"]) * ncell, b // pl["gcgroups"]
            j = torch.arange(j0, min(C, j0 + ncell))
            rows = torch.stack([j + g * C for g in range(4)], 1).flatten()
            ws = []
            for l in live:
                kk = pl["kg1"] if l == 0 else pl["kg2"]
                w = x_tm.new_zeros((mg, kk))
                w[:len(rows)] = wg[l][rows]
                ws.append(w)
            end = min(S, (sg + 1) * pl["gnsg"])
            for s0 in range(sg * pl["gnsg"], end, pl["ns_g"]):
                s = slice(s0, min(end, s0 + pl["ns_g"]))
                ks = mma_ksplit(len(live) * (mg // 16)
                                * -(-(s.stop - s0) // 8))
                for l, w in zip(live, ws):
                    at = a[s, koff[l]:koff[l] + w.shape[1]]
                    pre = _mma_tile(at, w, ks, tc)[:, :len(rows)]
                    pre = pre.view(-1, len(j), 4) \
                        + ps[l].bias[rows].view(len(j), 4)
                    _, _, _, cn, o = cell_math(
                        *pre.unbind(-1), c[l][s, j], ps[l].peephole_i_c[j],
                        ps[l].peephole_f_c[j], ps[l].peephole_o_c[j],
                        cell_clip, tc)
                    c[l][s, j] = cn
                    mb[l][s, j] = rounded(torch.tanh(cn) * o, bf)
        per = pl["qgroups"] * pl["sgroups"]
        for b in range(pl["proj_ctas"]):
            l, q0 = b // per, (b % per % pl["qgroups"]) * mq
            if l not in live:
                continue
            sg = b % per // pl["qgroups"]
            q = slice(q0, min(R, q0 + mq))
            w = x_tm.new_zeros((mq, pl["kq"]))
            w[:q.stop - q0] = wq[l][q]
            out = r1 if l == 0 else r2[k - 1]
            end = min(S, (sg + 1) * pl["nsg"])
            for s0 in range(sg * pl["nsg"], end, pl["ns_q"]):
                s = slice(s0, min(end, s0 + pl["ns_q"]))
                out[s, q] = _mma_tile(mb[l][s], w, tc=tc)[:, :q.stop - q0]
        if 0 in live:
            rb[0] = rounded(_pad(r1, rp), bf)
        if 1 in live:
            rb[1] = rounded(_pad(r2[k - 1], rp), bf)
    return r2, LstmState(c=c[0], r=r1), LstmState(c=c[1], r=r2[T - 1])


# ---------------------------------------------------------------------------
# kernels (CUDA tensors)
# ---------------------------------------------------------------------------

def _entries(bf16: bool = False):
    """K6's and K7's C entry points (float32 or bf16) and K7's planner."""
    from kaldi_lstm_tpu_torch.ops import _build
    lib = _build.load("lstmp_stack")
    tag = "bf16" if bf16 else "f32"
    fwd = getattr(lib, f"lstmp_stack_fwd2_{tag}")
    infer = getattr(lib, f"lstmp_stack_infer2_{tag}")
    plan = lib.lstmp_stack_infer2_plan
    p, i, f = ctypes.c_void_p, ctypes.c_int, ctypes.c_float
    if fwd.argtypes is None:
        fwd.argtypes = ([p] * 31 + [i] * 7 + [f, i, i, i, p] if bf16
                        else [p] * 25 + [i] * 7 + [f, i, p])
        fwd.restype = ctypes.c_int
    if infer.argtypes is None:
        infer.argtypes = ([p] * 24 + [i] * 6 + [f, p] if bf16
                          else [p] * 17 + [i] * 6 + [f, p])
        infer.restype = ctypes.c_int
    if plan.argtypes is None:
        plan.argtypes = [i] * 5 + [ctypes.POINTER(ctypes.c_int)]
        plan.restype = ctypes.c_int
    return fwd, infer, plan


def infer2_plan(S: int, I: int, C: int, R: int, device=None,
                bf16: bool = False) -> dict:
    """K7's launch plan on the card for these widths. f32: grid, cells
    and projection columns per CTA, the slices' strides, floats per
    staging buffer, dynamic shared memory, SM count, whether the bias and
    peepholes and the c state sit in shared memory, and the
    shared-memory byte offsets of each layer's gate and projection slices
    (-1: read from device memory). With ``bf16`` the bf16 kernel's plan,
    ``K7_BF16_PLAN_KEYS`` (what ``k7_bf16_plan`` mirrors)."""
    _, _, plan = _entries()
    keys = K7_BF16_PLAN_KEYS if bf16 else (
        "grid", "ncell", "nq", "wld", "qld", "buf", "smem", "sms",
        "const_smem", "c_smem", "wg1", "wg2", "wq1", "wq2")
    out = (ctypes.c_int * len(keys))()
    with torch.cuda.device(device):
        err = plan(S, I, C, R, int(bf16), out)
    if err != 0:
        raise RuntimeError(f"lstm_stack: K7 planning failed with CUDA error "
                           f"{err}")
    return dict(zip(keys, list(out)))


@functools.lru_cache(maxsize=64)
def _k7_bf16_launch_plan(S: int, I: int, C: int, R: int, device) -> dict:
    """infer2_plan(..., bf16=True), once per widths and card: a call's
    scratch sizes (the plan reads the card's attributes)."""
    return infer2_plan(S, I, C, R, device, bf16=True)


def _ptrs(ts) -> list[int | None]:
    return [None if t is None else t.data_ptr() for t in ts]


def _train_weights(p: LstmParams) -> list[torch.Tensor]:
    """One layer's weights as K1 takes them: w_gifo_x, w_gifo_r, bias,
    peepholes [3, C], w_r_m, all contiguous."""
    return [p.w_gifo_x.contiguous(), p.w_gifo_r.contiguous(),
            p.bias.contiguous(), _peep(p), p.w_r_m.contiguous()]


def _bf16_scratch(shapes, dev) -> list[torch.Tensor]:
    """bf16 copies [rows, cols] in one allocation, each starting 16-byte
    aligned (every size is a multiple of 8 elements)."""
    sizes = [rows * cols for rows, cols in shapes]
    assert all(s % 8 == 0 for s in sizes)
    flat = torch.empty(sum(sizes), dtype=torch.bfloat16, device=dev)
    return list(flat.split(sizes))


def lstm_stack_fwd2_cuda(p1: LstmParams, p2: LstmParams, x_tm: torch.Tensor,
                         s1: LstmState, s2: LstmState, cell_clip: float = 50.0,
                         tb: int | None = None, phases: str = "both",
                         compute_dtype=None) -> tuple[torch.Tensor, ...]:
    """K6 on the card (``lstmp_stack_fwd2_bf16`` when ``compute_dtype`` is
    torch.bfloat16); same arguments and results as the plain version."""
    global FWD2_LAUNCHES, FWD2_BF16_LAUNCHES
    T, S, I, C, R, tb = _check_stack(p1, p2, x_tm, s1, s2, tb, phases,
                                     compute_dtype)
    bf16 = compute_dtype is not None
    dev = x_tm.device
    sms = torch.cuda.get_device_properties(dev).multi_processor_count
    plan = fwd2_plan(S, C, phases, sms, bf16, T=T, I=I, R=R, tb=tb)
    f32 = dict(dtype=torch.float32, device=dev)
    g_dtype = torch.bfloat16 if bf16 else torch.float32
    w = [*_train_weights(p1), *_train_weights(p2)]
    states = [t.contiguous() for t in (s1.c, s1.r, s2.c, s2.r)]
    # with "l2" layer 1 never runs and layer 2 reads r1 = 0
    r1 = torch.zeros((T, S, R), **f32) if phases == "l2" else \
        torch.empty((T, S, R), **f32)
    outs = [torch.empty((T, S, 4 * C), dtype=g_dtype, device=dev),
            torch.empty((T, S, C), **f32), r1,
            torch.empty((T, S, 4 * C), dtype=g_dtype, device=dev),
            torch.empty((T, S, C), **f32), torch.empty((T, S, R), **f32)]
    xws = [torch.empty((T, S, 4 * C), **f32),
           torch.empty((tb, S, 4 * C), **f32)]
    Cp = plan["padded_cells"]
    if bf16:
        # wr_b, wrm_b (both layers), wx1_b, wx2_b, x_b, r0_b (both
        # layers), r1_b, m_b (both layers), rows padded to 8 elements
        R8, C8, I8 = _ld8(R), _ld8(C), _ld8(I)
        scratch = _bf16_scratch(
            [(2 * 4 * Cp, R8), (2 * R, C8), (4 * C, I8), (4 * C, R8),
             (T * S, I8), (2 * S, R8), (T * S, R8), (2 * S, C8)], dev)
        if phases == "l2":
            scratch[6].zero_()       # r1's copy: layer 2 reads r1 = 0
        tail = [T, S, I, C, R, tb, PHASES[phases], float(cell_clip),
                int(plan["xw1_route"] == "wg"),
                int(plan["xw2_route"] == "wg"), sms]
    else:
        scratch = [torch.empty((2, 4 * Cp, R), **f32),
                   torch.empty((2, S, C), **f32)]
        tail = [T, S, I, C, R, tb, PHASES[phases], float(cell_clip),
                plan["gate_bm"]]
    fwd, _, _ = _entries(bf16)
    with torch.cuda.device(dev):
        stream = torch.cuda.current_stream(dev).cuda_stream
        err = fwd(*_ptrs([x_tm.contiguous(), *w, *states, *outs, *xws,
                          *scratch]), *tail, stream)
    if err != 0:
        raise RuntimeError(f"lstm_stack: K6 launch failed with CUDA error "
                           f"{err}")
    if bf16:
        FWD2_BF16_LAUNCHES += wavefront_launches(T, tb, phases)
    else:
        FWD2_LAUNCHES += wavefront_launches(T, tb, phases)
    return tuple(outs)


def infer2_operands(p1: LstmParams, p2: LstmParams, x_tm: torch.Tensor,
                    s1: LstmState, s2: LstmState, bf16: bool,
                    plan: dict | None = None) -> tuple[list, tuple]:
    """K7's pointer operands on the card, in its entry point's order (None
    for a null pointer), and its outputs (c1, c2, r1, r2) among them.
    f32: the weights in K5's layout and m [2, S, C]; bf16: the weights as
    the params hold them, the bf16 copies the kernel stages (x once a
    call, r and m as the epilogues write them) and the weight slices the
    plan (the card's, or `plan`) keeps in device memory."""
    T, S, I = x_tm.shape
    C, R = p1.cell_dim, p1.recur_dim
    dev = x_tm.device
    f32 = dict(dtype=torch.float32, device=dev)
    c1 = s1.c.clone(memory_format=torch.contiguous_format)
    c2 = s2.c.clone(memory_format=torch.contiguous_format)
    r1 = torch.empty((S, R), **f32)
    r2 = torch.empty((T, S, R), **f32)
    bar = torch.empty(1, dtype=torch.int32, device=dev)   # barrier count
    if bf16:
        pl = plan or _k7_bf16_launch_plan(S, I, C, R, dev)
        w = [*_train_weights(p1), *_train_weights(p2)]
        scratch = _bf16_scratch(
            [(T * S, pl["xp"]), (2 * S, pl["rp"]), (2 * S, pl["cp"])], dev)
        for rows, cols, held in (
                (pl["grid"] * pl["mg"], pl["kg1"], pl["res_g1"]),
                (pl["grid"] * pl["mg"], pl["kg2"], pl["res_g2"]),
                (pl["grid"] * pl["mq"], pl["kq"], pl["res_q"])):
            scratch.append(None if held else torch.empty(
                (rows, cols), dtype=torch.bfloat16, device=dev))
    else:
        w = [*_kernel_operands(p1), *_kernel_operands(p2)]
        scratch = [torch.empty((2, S, C), **f32)]
    args = [x_tm.contiguous(), *w, s1.r.contiguous(), s2.r.contiguous(), c1,
            c2, r1, r2, *scratch, bar]
    return args, (c1, c2, r1, r2)


def lstm_stack_infer2_cuda(p1: LstmParams, p2: LstmParams,
                           x_tm: torch.Tensor, s1: LstmState, s2: LstmState,
                           cell_clip: float = 50.0, tb: int | None = None,
                           compute_dtype=None
                           ) -> tuple[torch.Tensor, LstmState, LstmState]:
    """K7 on the card (``lstmp_stack_infer2_bf16`` when ``compute_dtype``
    is torch.bfloat16); same arguments and results as the plain
    version."""
    global INFER2_LAUNCHES, INFER2_BF16_LAUNCHES
    T, S, I, C, R, tb = _check_stack(p1, p2, x_tm, s1, s2, tb, "both",
                                     compute_dtype)
    bf16 = compute_dtype is not None
    dev = x_tm.device
    args, (c1, c2, r1, r2) = infer2_operands(p1, p2, x_tm, s1, s2, bf16)
    _, infer, _ = _entries(bf16)
    with torch.cuda.device(dev):
        stream = torch.cuda.current_stream(dev).cuda_stream
        err = infer(*_ptrs(args), T, S, I, C, R, tb, float(cell_clip),
                    stream)
    if err != 0:
        raise RuntimeError(f"lstm_stack: K7 launch failed with CUDA error "
                           f"{err}")
    if bf16:
        INFER2_BF16_LAUNCHES += wavefront_launches(T, tb, kernel="infer2")
    else:
        INFER2_LAUNCHES += wavefront_launches(T, tb, kernel="infer2")
    return r2, LstmState(c=c1, r=r1), LstmState(c=c2, r=r2[T - 1])


# ---------------------------------------------------------------------------
# dispatch
# ---------------------------------------------------------------------------

def lstm_stack_fwd2(p1: LstmParams, p2: LstmParams, x_tm: torch.Tensor,
                    s1: LstmState, s2: LstmState, cell_clip: float = 50.0,
                    tb: int | None = None, phases: str = "both",
                    compute_dtype=None) -> tuple[torch.Tensor, ...]:
    """K6 for a CUDA tensor, its plain version for a CPU tensor."""
    global PLAIN_CALLS
    if x_tm.device.type == "cuda":
        return lstm_stack_fwd2_cuda(p1, p2, x_tm, s1, s2, cell_clip, tb,
                                    phases, compute_dtype)
    if x_tm.device.type != "cpu":
        raise ValueError(f"lstm_stack: unsupported device {x_tm.device}")
    _check_stack(p1, p2, x_tm, s1, s2, tb, phases, compute_dtype)
    PLAIN_CALLS += 1
    return lstm_stack_fwd2_plain(p1, p2, x_tm, s1, s2, cell_clip, phases,
                                 compute_dtype)


def lstm_stack_infer2(p1: LstmParams, p2: LstmParams, x_tm: torch.Tensor,
                      s1: LstmState, s2: LstmState, cell_clip: float = 50.0,
                      tb: int | None = None, compute_dtype=None
                      ) -> tuple[torch.Tensor, LstmState, LstmState]:
    """K7 for a CUDA tensor, its plain version for a CPU tensor."""
    global PLAIN_CALLS
    if x_tm.device.type == "cuda":
        return lstm_stack_infer2_cuda(p1, p2, x_tm, s1, s2, cell_clip, tb,
                                      compute_dtype)
    if x_tm.device.type != "cpu":
        raise ValueError(f"lstm_stack: unsupported device {x_tm.device}")
    _check_stack(p1, p2, x_tm, s1, s2, tb, "both", compute_dtype)
    PLAIN_CALLS += 1
    return lstm_stack_infer2_plain(p1, p2, x_tm, s1, s2, cell_clip,
                                   compute_dtype)
