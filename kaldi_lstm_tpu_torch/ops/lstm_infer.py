"""LSTMP inference forward: the hand-written CUDA counterpart of
``kaldi_lstm_tpu/ops/lstm_pallas.py::_infer_kernel``.

``lstm_infer`` takes the same arguments as the eager ``lstm_scan`` for
an inference call (no dropout, float32). On a CUDA
tensor it launches ``csrc/lstmp_infer.cu`` (one persistent cooperative
launch per call on the current stream, the weights resident in shared
memory; see the source for the design) or raises; on a CPU tensor it
runs the plain version, ``lstm_cell.lstm_scan``. It never falls back
from the card to the plain version. A call that autograd would record
(a gradient is needed) goes to ``lstm_train.lstm_train``, whose kernels
keep the residuals the backward reads.

The launch is cooperative: the card refuses a grid that cannot be
co-resident (the wrapper raises) instead of hanging at a grid barrier,
and work that another process or stream holds on the SMs delays it.

bf16 (``compute_dtype=torch.bfloat16``, the ``--bf16`` cross-validation
pass): the JAX package's primal under ``set_matmul_dtype(jnp.bfloat16)``
rounds x, Wx, r_{t-1}, Wr, tanh(c) o and Wrm to bf16 before its dots and
sums in float32. The ``lstmp_infer_bf16`` entry point is its own design
(``lstmp_infer_tc_kernel``): the same persistent cooperative launch,
both products on the bf16 tensor cores, every operand rounded once where
it is made (the weights and x once a call, m and r by the epilogues
that compute them) and staged as bf16. Its plan is ``k5_bf16_plan``
(the C planner's mirror), its sums ``lstm_infer_sliced_plain`` with
``compute_dtype``; the plain version of the entry point
(``lstm_cell.lstm_scan``) rounds the same operands.

``advance_mask`` (the sticky server's ragged ticks): a [S, T] ([T, S]
with ``time_major``) 0/1 mask; a stream keeps its (c, r) through a frame
whose entry is 0, and its output row there is unspecified (callers
discard it). The kernel selects on entry != 0; for a 0/1 mask and finite
values that equals the plain scan's blend a new + (1 - a) old, which
gives NaN where the selection does not when a masked stream's new state
is inf. On the card the ``lstmp_infer_masked_f32`` / ``_bf16``
entry points read it as bytes at its own strides (a uint8 mask as it is,
any other dtype compared with 0 first); on the CPU
``lstm_scan(advance_mask=...)`` is the plain version. A masked call that
needs a gradient raises: the training kernels have no mask, and the JAX
package never trains with one (``_LstmBase._run_scan`` sends such a call
on a CPU tensor to ``lstm_scan`` itself).

``LAUNCHES`` counts the CUDA kernel launches of the float32 entry point
(one per call), ``BF16_LAUNCHES`` those of the bf16 one,
``MASKED_LAUNCHES`` and ``MASKED_BF16_LAUNCHES`` those of the masked
entry points; ``PLAIN_CALLS`` counts the calls that took the plain
version. A caller can zero them before a run and read them after it.

``k5_plan`` (f32), ``k5_bf16_plan`` (bf16) and ``lstm_infer_sliced_plain``
spell out in torch how each kernel deals the cells and projection
columns to its CTAs and splits each CTA's sums; the CPU tests hold that
decomposition against the JAX package's Pallas kernel.
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
from kaldi_lstm_tpu_torch.ops.tc_sum import cell_math, tc_runs

LAUNCHES = 0
BF16_LAUNCHES = 0
MASKED_LAUNCHES = 0
MASKED_BF16_LAUNCHES = 0
PLAIN_CALLS = 0

_MAX_STREAMS = 65535 * 8  # the limit the wrapper has always enforced
# csrc/lstmp_infer.cu's block_product: threads per CTA, stream groups of 8
# per tile, threads per contraction
_THREADS, _MAX_GROUPS, _MAX_KSPLIT = 256, 8, 256
H100_SMS = 132
# shared memory a block may opt in to on an H100 (bytes)
H100_OPTIN = 232448
# csrc/lstmp_infer.cu's bf16 kernel: warps per CTA, streams a staged tile
# holds at most, floats of one m16n8 fragment
_WARPS, _TILE_STREAMS, _UNIT_FLOATS = 8, 64, 128
# the fields of its plan, in the order lstmp_infer_bf16_plan writes them
BF16_PLAN_KEYS = ("grid", "sms", "ncell", "gcgroups", "gsgroups", "gnsg",
                  "gate_ctas", "mg", "mq", "qgroups", "sgroups", "nsg", "ip",
                  "rp", "kg", "ksg", "cp", "kq", "ksq", "ns_g", "ns_q",
                  "resident", "c_smem", "part_floats", "stage_elems",
                  "off_cst", "off_c", "off_w", "off_stage", "smem")


def reset_counts() -> None:
    global LAUNCHES, BF16_LAUNCHES, MASKED_LAUNCHES, MASKED_BF16_LAUNCHES
    global PLAIN_CALLS
    LAUNCHES = 0
    BF16_LAUNCHES = 0
    MASKED_LAUNCHES = 0
    MASKED_BF16_LAUNCHES = 0
    PLAIN_CALLS = 0


def check_compute_dtype(compute_dtype, op: str) -> bool:
    """True for bf16 products (torch.bfloat16), False for float32 ones
    (None); any other dtype raises."""
    if compute_dtype is None:
        return False
    if compute_dtype == torch.bfloat16:
        return True
    raise TypeError(f"{op}: compute_dtype must be None or torch.bfloat16, "
                    f"got {compute_dtype}")


def _entries(bf16: bool = False, masked: bool = False):
    """The kernel's C entry point (float32 or bf16, with or without the
    advance mask) and the planner."""
    from kaldi_lstm_tpu_torch.ops import _build
    lib = _build.load("lstmp_infer")
    name = ("lstmp_infer_masked_" if masked else "lstmp_infer_") \
        + ("bf16" if bf16 else "f32")
    fn = getattr(lib, name)
    plan = lib.lstmp_infer_bf16_plan if bf16 else lib.lstmp_infer_plan
    p, i = ctypes.c_void_p, ctypes.c_int
    if fn.argtypes is None:
        ll = ctypes.c_longlong
        fn.argtypes = [p] * (15 if bf16 else 10) + [i] * 5 \
            + [ctypes.c_float] + ([p, ll, ll] if masked else []) + [p]
        fn.restype = ctypes.c_int
    if plan.argtypes is None:
        plan.argtypes = [i] * (6 if bf16 else 4) \
            + [ctypes.POINTER(ctypes.c_int)]
        plan.restype = ctypes.c_int
    return fn, plan


def device_plan(S: int, I: int, C: int, R: int, device=None,
                bf16: bool = False) -> dict:
    """The kernel's launch plan on the card for these widths: for the
    f32 kernel grid, cells and projection columns per CTA, dynamic
    shared memory, whether the weights are resident, the SM count, and
    whether the cells' bias and peepholes and their c state sit in
    shared memory; for the bf16 one (``bf16``) the fields of
    ``k5_bf16_plan``."""
    _, plan = _entries(bf16)
    keys = BF16_PLAN_KEYS if bf16 else (
        "grid", "ncell", "nq", "wld", "qld", "smem", "resident", "sms",
        "const_smem", "c_smem")
    out = (ctypes.c_int * len(keys))()
    with torch.cuda.device(device):
        err = plan(S, I, C, R, 0, 0, out) if bf16 else plan(S, I, C, R, out)
    if err != 0:
        raise RuntimeError(f"lstm_infer: planning failed with CUDA error "
                           f"{err}")
    return dict(zip(keys, list(out)))


def k5_plan(C: int, R: int, sms: int = H100_SMS) -> tuple[int, int, int]:
    """(grid, cells per CTA, projection columns per CTA), as the kernel
    deals them: equal slices of ceil(C / SMs) cells and ceil(R / SMs)
    columns, one CTA per SM at most."""
    ncell = -(-C // sms)
    nq = -(-R // sms)
    return max(-(-C // ncell), -(-R // nq)), ncell, nq


def _up(n: int, m: int) -> int:
    return -(-n // m) * m


def _k5_bf16_plan_for(S: int, I: int, C: int, R: int, sms: int,
                      optin: int, gs: int) -> dict | None:
    """csrc/lstmp_infer.cu::tc_plan_for: the plan with the gate streams
    in ``gs`` groups, or None where two 8-stream tiles do not fit."""
    ncell = _up(-(-C // (sms // gs)), 4)
    gcgroups = -(-C // ncell)
    gnsg = _up(-(-S // gs), 8)
    gsgroups = -(-S // gnsg)
    mg = 4 * ncell
    mq = 16 * -(-(-(-R // 16)) // sms)
    qgroups = -(-R // mq)
    sgroups = max(1, min(sms // qgroups, -(-S // 8)))
    nsg = _up(-(-S // sgroups), 8)
    sgroups = -(-S // nsg)
    ip, rp = _up(I, 8), _up(R, 8)
    kg = _up(ip + rp, 16)
    cp = _up(C, 8)
    kq = _up(cp, 16)
    ksg, ksq = kg + 8, kq + 8
    part_floats = _UNIT_FLOATS * _WARPS * max(1, max(mg, mq) // 16)
    part, cst = 4 * part_floats, 4 * _up(7 * ncell, 4)
    cstate = 4 * _up(gnsg * ncell, 4)
    wbytes = _up(2 * (mg * ksg + mq * ksq), 16)
    stage_min = 2 * 2 * 8 * max(ksg, ksq)
    used = part + cst
    resident = used + wbytes + stage_min <= optin
    used += wbytes if resident else 0
    c_smem = used + cstate + stage_min <= optin
    used += cstate if c_smem else 0
    avail = optin - used
    if avail < stage_min:
        return None
    def even(n, most):      # tiles of at most `most`, as even as 8s allow
        return _up(-(-n // -(-n // most)), 8)

    ns_g = even(gnsg, min(_TILE_STREAMS, avail // (4 * ksg) // 8 * 8))
    ns_q = even(nsg, min(_TILE_STREAMS, avail // (4 * ksq) // 8 * 8))
    stage_elems = max(ns_g * ksg, ns_q * ksq)
    off_w = part + cst + (cstate if c_smem else 0)
    off_stage = off_w + (wbytes if resident else 0)
    return dict(grid=max(gcgroups * gsgroups, qgroups * sgroups), sms=sms,
                ncell=ncell, gcgroups=gcgroups, gsgroups=gsgroups,
                gnsg=gnsg, gate_ctas=gcgroups * gsgroups, mg=mg, mq=mq,
                qgroups=qgroups, sgroups=sgroups, nsg=nsg, ip=ip, rp=rp,
                kg=kg, ksg=ksg, cp=cp, kq=kq, ksq=ksq, ns_g=ns_g, ns_q=ns_q,
                resident=int(resident), c_smem=int(c_smem),
                part_floats=part_floats, stage_elems=stage_elems,
                off_cst=part, off_c=part + cst, off_w=off_w,
                off_stage=off_stage, smem=off_stage + 4 * stage_elems)


def k5_bf16_plan(S: int, I: int, C: int, R: int, sms: int = H100_SMS,
                 optin: int = H100_OPTIN) -> dict:
    """The bf16 kernel's plan (csrc/lstmp_infer.cu::make_tc_plan), field
    for field. Gates: ``gsgroups`` stream groups of ``gnsg`` streams
    (two from S=128 on where that plan keeps the weights resident with
    tiles of 32 streams or more, else one), in each ``gcgroups`` CTAs of
    ``ncell`` cells (ceil(C gs / SMs) rounded up to 4, so 4 ncell gate
    rows fill whole m16 tiles). Projection: ``mq`` columns a CTA (16, one
    m16 tile) in ``qgroups`` column groups times ``sgroups`` stream
    groups of ``nsg`` streams (as many as the SMs the column groups leave
    allow). The contractions padded (x and r to 8, [x | r] to ``kg``, m
    to ``kq``, multiples of 16), row strides ``ksg``/``ksq`` 8 longer;
    shared memory given to the partial sums and the cells' constants,
    then the weight slices if they leave room for two 8-stream staging
    tiles (``resident``), then the c state, the rest to staging tiles of
    ``ns_g``/``ns_q`` streams (at most 64, as even as multiples of 8
    allow)."""
    if S >= 128:
        two = _k5_bf16_plan_for(S, I, C, R, sms, optin, 2)
        if two is not None and two["resident"] and two["ns_g"] >= 32:
            return two
    one = _k5_bf16_plan_for(S, I, C, R, sms, optin, 1)
    if one is None:
        raise ValueError(f"lstm_infer: no bf16 plan for S={S} I={I} C={C} "
                         f"R={R}: two 8-stream tiles do not fit")
    return one


def mma_ksplit(units: int) -> int:
    """Warps sharing one output tile's contraction in the bf16 kernel:
    the largest power of two that keeps units x splits within its 8
    warps."""
    ks = 1
    while 2 * ks * units <= _WARPS:
        ks *= 2
    return ks


def _mma_tile(a: torch.Tensor, w: torch.Tensor, ks: int | None = None,
              tc: bool = False) -> torch.Tensor:
    """One staged tile's product as the bf16 kernel sums it: a [sn, K]
    (rounded, K a multiple of 16) against w [M, K] (M a multiple of 16):
    each 16-deep slice's product on its own, added in slice order from
    zero by each of ``ks`` warps (default ``mma_ksplit`` of this tile's
    output tiles) over the slices j = ks (mod ksplit), then the warps'
    sums in warp order. A slice's product is an IEEE f32 sum, or with
    ``tc`` the tensor core's own (one mma.sync from a zero accumulator,
    ``tc_sum.tc_runs``). Returns [sn, M]."""
    sn, K = a.shape
    if ks is None:
        ks = mma_ksplit((w.shape[0] // 16) * -(-sn // 8))
    parts = tc_runs(a, w.T, 1) if tc else None      # [sn, M, K / 16]
    out = a.new_zeros((sn, w.shape[0]))
    for kidx in range(ks):
        acc = a.new_zeros((sn, w.shape[0]))
        for j in range(kidx, K // 16, ks):
            acc = acc + (parts[..., j] if tc else
                         a[:, 16 * j:16 * j + 16] @ w[:, 16 * j:16 * j + 16].T)
        out = out + acc
    return out


def _pad(t: torch.Tensor, n: int) -> torch.Tensor:
    """t with its last dimension zero-padded to n."""
    return torch.nn.functional.pad(t, (0, n - t.shape[-1]))


def lstm_infer_tc_plain(params: LstmParams, x_tm: torch.Tensor,
                        c0: torch.Tensor, r0: torch.Tensor,
                        cell_clip: float = 50.0, sms: int = H100_SMS,
                        optin: int = H100_OPTIN, tc: bool = False
                        ) -> tuple[torch.Tensor, torch.Tensor]:
    """The bf16 kernel's decomposition in torch (``k5_bf16_plan``): the
    weights and x rounded once; per step each gate CTA's rows [4 c + g]
    against the staged [x_t | r_{t-1}] (padded) of its stream group,
    tile by tile of ``ns_g`` streams (``_mma_tile``), its cell math
    writing c and the
    rounded m; then each (column group, stream group) CTA's columns of
    r_t from the staged m, tiles of ``ns_q`` streams, r_t rounded for
    the next step. With ``tc`` it is the kernel's arithmetic: each slice
    summed as the tensor core sums it (``_mma_tile``) and the cell math
    fused as nvcc compiles it (``tc_sum.cell_math``). x [T, S, I];
    returns (r [T, S, R], final c)."""
    T, S, I = x_tm.shape
    C, R = params.cell_dim, params.recur_dim
    pl = k5_bf16_plan(S, I, C, R, sms, optin)
    bf = torch.bfloat16
    w_cat, bias, peep, wrm_t = _kernel_operands(params)
    # [Wx^T; Wr^T] rows placed in the padded [x | r] layout, as [4C, kg]
    wk = x_tm.new_zeros((pl["kg"], 4 * C))
    wk[:I] = w_cat[:I]
    wk[pl["ip"]:pl["ip"] + R] = w_cat[I:]
    wk = rounded(wk, bf).T
    wq = rounded(_pad(wrm_t.T, pl["kq"]), bf)               # [R, kq]
    xb = rounded(_pad(x_tm, pl["ip"]), bf)
    rb = rounded(_pad(r0, pl["rp"]), bf)
    c = c0.clone()
    r_out = x_tm.new_empty((T, S, R))
    ncell, mq = pl["ncell"], pl["mq"]
    for t in range(T):
        a = _pad(torch.cat([xb[t], rb], dim=1), pl["kg"])
        mb = x_tm.new_zeros((S, pl["kq"]))
        for b in range(pl["gate_ctas"]):
            j0, sg = (b % pl["gcgroups"]) * ncell, b // pl["gcgroups"]
            j = torch.arange(j0, min(C, j0 + ncell))
            rows = torch.stack([j + g * C for g in range(4)], 1).flatten()
            w = x_tm.new_zeros((pl["mg"], pl["kg"]))
            w[:len(rows)] = wk[rows]
            end = min(S, (sg + 1) * pl["gnsg"])
            for s0 in range(sg * pl["gnsg"], end, pl["ns_g"]):
                s = slice(s0, min(end, s0 + pl["ns_g"]))
                pre = _mma_tile(a[s], w, tc=tc)[:, :len(rows)]
                pre = pre.view(-1, len(j), 4) + bias[rows].view(len(j), 4)
                _, _, _, cn, o = cell_math(
                    *pre.unbind(-1), c[s, j], peep[0, j], peep[1, j],
                    peep[2, j], cell_clip, tc)
                c[s, j] = cn
                mb[s, j] = rounded(torch.tanh(cn) * o, bf)
        for b in range(pl["qgroups"] * pl["sgroups"]):
            q0, sg = (b % pl["qgroups"]) * mq, b // pl["qgroups"]
            q = slice(q0, min(R, q0 + mq))
            w = x_tm.new_zeros((mq, pl["kq"]))
            w[:q.stop - q0] = wq[q]
            end = min(S, (sg + 1) * pl["nsg"])
            for s0 in range(sg * pl["nsg"], end, pl["ns_q"]):
                s = slice(s0, min(end, s0 + pl["ns_q"]))
                r_out[t, s, q] = _mma_tile(mb[s], w, tc=tc)[:, :q.stop - q0]
        rb = rounded(_pad(r_out[t], pl["rp"]), bf)
    return r_out, c


@functools.lru_cache(maxsize=64)
def _bf16_launch_plan(S: int, I: int, C: int, R: int, device) -> dict:
    """device_plan(..., bf16=True), once per widths and card: a call's
    scratch sizes (the plan reads the card's attributes)."""
    return device_plan(S, I, C, R, device, bf16=True)


def _k_split(units: int) -> int:
    """Threads summing one unit: the largest power of two that keeps
    every unit within the CTA's 256 threads."""
    ksn = 1
    while 2 * ksn <= _MAX_KSPLIT and 2 * ksn * units <= _THREADS:
        ksn *= 2
    return ksn


def _tiles(S: int, ncb: int):
    """The stream tiles of block_product over ncb quads of columns: for
    each, (first stream, streams, lanes splitting the contraction)."""
    groups_max = min(_MAX_GROUPS, max(1, _THREADS // ncb))
    for s0 in range(0, S, 8 * groups_max):
        sn = min(8 * groups_max, S - s0)
        yield s0, sn, _k_split(ncb * -(-sn // 8))


def _sliced_product(a: torch.Tensor, w: torch.Tensor, nquad: int
                    ) -> torch.Tensor:
    """a [S, K] @ w [K, n] for one CTA's n <= 4 nquad columns, split as
    the kernel's block_product splits it: quads of 4 columns in blocks of
    at most 256, and per stream tile ksn partial products over
    k = ks (mod ksn). The kernel adds the partials by a fixed butterfly
    within each warp and then in warp order, this mirror in the order
    ks = 0, 1, ..."""
    S, n = a.shape[0], w.shape[1]
    out = a.new_empty((S, n))
    for cb0 in range(0, nquad, _THREADS):
        ncb = min(_THREADS, nquad - cb0)
        cols = slice(4 * cb0, min(n, 4 * (cb0 + ncb)))
        for s0, sn, ksn in _tiles(S, ncb):
            rows = a[s0:s0 + sn]
            acc = rows.new_zeros((sn, cols.stop - cols.start))
            for ks in range(ksn):
                acc = acc + rows[:, ks::ksn] @ w[ks::ksn, cols]
            out[s0:s0 + sn, cols] = acc
    return out


def lstm_infer_sliced_plain(params: LstmParams, x_tm: torch.Tensor,
                            c0: torch.Tensor, r0: torch.Tensor,
                            cell_clip: float = 50.0, sms: int = H100_SMS,
                            compute_dtype=None
                            ) -> tuple[torch.Tensor, torch.Tensor]:
    """The kernel's decomposition in torch: per step, a gates phase in
    which each of the ``k5_plan`` CTAs computes its cells' four gates
    from [x_t | r_{t-1}] and its columns of [Wx^T; Wr^T], then (after
    the grid barrier) a projection phase in which each CTA computes its
    columns of r_t from all of m and its columns of Wrm^T; each CTA's
    sums split as ``_sliced_product``. With ``compute_dtype``
    torch.bfloat16 it is the bf16 kernel's decomposition,
    ``lstm_infer_tc_plain``. x [T, S, I]; returns (r [T, S, R], final
    c)."""
    if check_compute_dtype(compute_dtype, "lstm_infer"):
        return lstm_infer_tc_plain(params, x_tm, c0, r0, cell_clip, sms)
    T, S, _ = x_tm.shape
    C, R = params.cell_dim, params.recur_dim
    grid, ncell, nq = k5_plan(C, R, sms)
    w_cat, bias, peep, wrm_t = _kernel_operands(params)
    c, r = c0.clone(), r0
    r_out = x_tm.new_empty((T, S, R))
    for t in range(T):
        a = torch.cat([x_tm[t], r], dim=1)
        m = torch.empty_like(c)
        for b in range(grid):
            j = torch.arange(min(C, b * ncell), min(C, (b + 1) * ncell))
            if not len(j):
                continue
            cols = torch.stack([j + g * C for g in range(4)], 1).flatten()
            pre = _sliced_product(a, w_cat[:, cols], len(j))
            pre = pre.view(S, len(j), 4) + bias[cols].view(len(j), 4)
            cp = c[:, j]
            g = torch.tanh(pre[..., 0])
            i = torch.sigmoid(pre[..., 1] + cp * peep[0, j])
            f = torch.sigmoid(pre[..., 2] + cp * peep[1, j])
            cn = g * i + cp * f
            if cell_clip > 0:
                cn = torch.clamp(cn, -cell_clip, cell_clip)
            o = torch.sigmoid(pre[..., 3] + cn * peep[2, j])
            c[:, j] = cn
            m[:, j] = torch.tanh(cn) * o
        for b in range(grid):
            q = torch.arange(min(R, b * nq), min(R, (b + 1) * nq))
            if len(q):
                r_out[t][:, q] = _sliced_product(m, wrm_t[:, q],
                                                 -(-len(q) // 4))
        r = r_out[t]
    return r_out, c


def _check(name: str, t: torch.Tensor, shape: tuple, device,
           op: str = "lstm_infer", dtype=torch.float32) -> None:
    if t.device != device:
        raise ValueError(f"{op}: {name} is on {t.device}, x is on {device}")
    if t.dtype != dtype:
        raise TypeError(f"{op}: {name} must be {dtype}, got {t.dtype}")
    if tuple(t.shape) != shape:
        raise ValueError(f"{op}: {name} has shape {tuple(t.shape)}, "
                         f"expected {shape}")


def check_lstm_operands(params: LstmParams, T: int, S: int, I: int,
                        state: LstmState, device, op: str) -> None:
    """Device, dtype and shape checks shared by the LSTMP kernels'
    wrappers (the kernels take float32 [T, S, .] operands only)."""
    C, R = params.cell_dim, params.recur_dim
    _check("w_gifo_x", params.w_gifo_x, (4 * C, I), device, op)
    _check("w_gifo_r", params.w_gifo_r, (4 * C, R), device, op)
    _check("bias", params.bias, (4 * C,), device, op)
    for name in ("peephole_i_c", "peephole_f_c", "peephole_o_c"):
        _check(name, getattr(params, name), (C,), device, op)
    _check("w_r_m", params.w_r_m, (R, C), device, op)
    _check("state.c", state.c, (S, C), device, op)
    _check("state.r", state.r, (S, R), device, op)
    if min(S, I, C, R) <= 0:
        raise ValueError(f"{op}: empty dimension S={S} I={I} C={C} R={R}")
    if S > _MAX_STREAMS:
        raise ValueError(f"{op}: S={S} exceeds {_MAX_STREAMS}")


def needs_grad(params: LstmParams, x: torch.Tensor,
               state: LstmState) -> bool:
    """Whether autograd would record a call on these operands."""
    return torch.is_grad_enabled() and (
        x.requires_grad or any(p.requires_grad for p in params)
        or state.c.requires_grad or state.r.requires_grad)


def _kernel_operands(params: LstmParams) -> tuple[torch.Tensor, ...]:
    """The weights in the kernel's layout: [Wx^T; Wr^T] as one
    [I + R, 4C] matrix, bias [4C], peepholes [3, C] and Wrm^T [C, R],
    all contiguous, so that neighbouring threads read neighbouring
    addresses."""
    w_cat = torch.cat([params.w_gifo_x.T, params.w_gifo_r.T]).contiguous()
    peep = torch.stack([params.peephole_i_c, params.peephole_f_c,
                        params.peephole_o_c]).contiguous()
    return (w_cat, params.bias.contiguous(), peep,
            params.w_r_m.T.contiguous())


def lstm_infer(params: LstmParams, x: torch.Tensor, state: LstmState,
               cell_clip: float = 50.0, time_major: bool = False,
               compute_dtype=None, advance_mask: torch.Tensor | None = None
               ) -> tuple[torch.Tensor, LstmState]:
    """Inference forward of one LSTMP layer over a [S, T, I] chunk
    ([T, S, I] with ``time_major``) from the carried ``state``, with the
    products' operands in ``compute_dtype`` (None or torch.bfloat16) and
    the optional 0/1 ``advance_mask`` ([S, T], [T, S] with
    ``time_major``; see the module docstring). Returns (r_out with x's
    layout, final state)."""
    global PLAIN_CALLS
    check_compute_dtype(compute_dtype, "lstm_infer")
    if needs_grad(params, x, state):
        # the inference kernel keeps no residuals: a gradient needs the
        # training kernels (K1 forward, K2 backward), which have no mask
        if advance_mask is not None:
            raise NotImplementedError(
                "lstm_infer: advance_mask on a call that needs a gradient: "
                "the training kernels (K1/K2) have no per-frame state "
                "gating (lstm_scan is the differentiable masked scan)")
        from kaldi_lstm_tpu_torch.ops.lstm_train import lstm_train
        return lstm_train(params, x, state, cell_clip, time_major=time_major,
                          compute_dtype=compute_dtype)
    if x.device.type == "cpu":
        PLAIN_CALLS += 1
        return lstm_scan(params, x, state, cell_clip,
                         compute_dtype=compute_dtype, time_major=time_major,
                         advance_mask=advance_mask)
    if x.device.type != "cuda":
        raise ValueError(f"lstm_infer: unsupported device {x.device}")
    if x.dim() != 3:
        raise ValueError(f"lstm_infer: x must be 3-D, got {tuple(x.shape)}")
    x_tm = x if time_major else x.transpose(0, 1)
    amask_tm = None
    if advance_mask is not None:
        amask_tm = advance_mask if time_major else advance_mask.transpose(0, 1)
    r_out, final = lstm_infer_cuda(params, x_tm, state, cell_clip,
                                   compute_dtype, amask_tm)
    return (r_out if time_major else r_out.transpose(0, 1)), final


def lstm_infer_cuda(params: LstmParams, x_tm: torch.Tensor,
                    state: LstmState, cell_clip: float = 50.0,
                    compute_dtype=None,
                    advance_mask_tm: torch.Tensor | None = None
                    ) -> tuple[torch.Tensor, LstmState]:
    """K5 on the card over x [T, S, I] (``lstmp_infer_bf16`` when
    ``compute_dtype`` is torch.bfloat16; the ``_masked_`` entry points
    with a [T, S] 0/1 ``advance_mask_tm``): (r [T, S, R], final state)."""
    global LAUNCHES, BF16_LAUNCHES, MASKED_LAUNCHES, MASKED_BF16_LAUNCHES
    bf16 = check_compute_dtype(compute_dtype, "lstm_infer")
    T, S, I = x_tm.shape
    C, R = params.cell_dim, params.recur_dim
    dev = x_tm.device
    _check("x", x_tm, (T, S, I), dev)
    check_lstm_operands(params, T, S, I, state, dev, "lstm_infer")
    masked = advance_mask_tm is not None
    if masked:
        if advance_mask_tm.device != dev:
            raise ValueError(f"lstm_infer: advance_mask is on "
                             f"{advance_mask_tm.device}, x is on {dev}")
        if tuple(advance_mask_tm.shape) != (T, S):
            raise ValueError(
                f"lstm_infer: advance_mask has shape "
                f"{tuple(advance_mask_tm.shape)} in time-major layout, "
                f"expected {(T, S)}")
        # the kernel reads one byte per (t, s) at any strides: nonzero
        # advances (a uint8 mask goes as it is, without a transpose)
        amask = advance_mask_tm if advance_mask_tm.dtype == torch.uint8 \
            else (advance_mask_tm != 0).to(torch.uint8)
    if T == 0:
        return x_tm.new_empty((0, S, R)), state

    x_c = x_tm.contiguous()
    if bf16:
        # the kernel reads the weights as the params hold them
        weights = [params.w_gifo_x.contiguous(),
                   params.w_gifo_r.contiguous(), params.bias.contiguous(),
                   torch.stack([params.peephole_i_c, params.peephole_f_c,
                                params.peephole_o_c]),
                   params.w_r_m.contiguous()]
    else:
        weights = list(_kernel_operands(params))
    r0 = state.r.contiguous()
    c = torch.empty((S, C), dtype=torch.float32, device=dev)
    c.copy_(state.c)
    r_out = torch.empty((T, S, R), dtype=torch.float32, device=dev)
    bar = torch.empty(1, dtype=torch.int32, device=dev)   # barrier count
    if bf16:
        # the bf16 copies the kernel stages (x once a call, r and m as the
        # epilogues write them), and the weight slices where the plan
        # keeps them in device memory
        pl = _bf16_launch_plan(S, I, C, R, dev)

        def b16(*shape):
            return torch.empty(shape, dtype=torch.bfloat16, device=dev)

        ws = [None, None] if pl["resident"] else [
            b16(pl["grid"], pl["mg"], pl["kg"]),
            b16(pl["grid"], pl["mq"], pl["kq"])]
        outs = [r_out, b16(T, S, pl["ip"]), b16(S, pl["rp"]),
                b16(S, pl["cp"]), *ws]
    else:
        m = torch.empty((S, C), dtype=torch.float32, device=dev)
        outs = [m, r_out]
    fn, _ = _entries(bf16, masked)
    with torch.cuda.device(dev):
        stream = torch.cuda.current_stream(dev).cuda_stream
        args = [x_c.data_ptr(), *(w.data_ptr() for w in weights),
                r0.data_ptr(), c.data_ptr(),
                *(None if t is None else t.data_ptr()
                                for t in outs),
                bar.data_ptr(), T, S, I, C, R, float(cell_clip)]
        if masked:
            args += [amask.data_ptr(), amask.stride(0), amask.stride(1)]
        err = fn(*args, stream)
    if err != 0:
        raise RuntimeError(f"lstm_infer: CUDA launch failed with error "
                           f"{err}")
    if masked and bf16:
        MASKED_BF16_LAUNCHES += 1
    elif masked:
        MASKED_LAUNCHES += 1
    elif bf16:
        BF16_LAUNCHES += 1
    else:
        LAUNCHES += 1
    return r_out, LstmState(c=c, r=r_out[T - 1])
