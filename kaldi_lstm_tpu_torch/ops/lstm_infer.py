"""LSTMP inference forward: the hand-written CUDA counterpart of
``kaldi_lstm_tpu/ops/lstm_pallas.py::_infer_kernel``.

``lstm_infer`` takes the same arguments as the eager ``lstm_scan`` for
an inference call (no dropout, no advance mask, float32). On a CUDA
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

``LAUNCHES`` counts the CUDA kernel launches made (one per call);
``PLAIN_CALLS`` counts the calls that took the plain version. A caller
can zero both before a run and read them after it.

``k5_plan`` and ``lstm_infer_sliced_plain`` spell out in torch how the
kernel deals the cells and projection columns to its CTAs and splits
each CTA's sums; the CPU tests hold that decomposition against the JAX
package's Pallas kernel.
"""

from __future__ import annotations

import ctypes

import torch

from kaldi_lstm_tpu_torch.ops.lstm_cell import LstmParams, LstmState, lstm_scan

LAUNCHES = 0
PLAIN_CALLS = 0

_MAX_STREAMS = 65535 * 8  # the limit the wrapper has always enforced
# csrc/lstmp_infer.cu's block_product: threads per CTA, stream groups of 8
# per tile, threads per contraction
_THREADS, _MAX_GROUPS, _MAX_KSPLIT = 256, 8, 256
H100_SMS = 132


def reset_counts() -> None:
    global LAUNCHES, PLAIN_CALLS
    LAUNCHES = 0
    PLAIN_CALLS = 0


def _entries():
    from kaldi_lstm_tpu_torch.ops import _build
    lib = _build.load("lstmp_infer")
    fn, plan = lib.lstmp_infer_f32, lib.lstmp_infer_plan
    p, i = ctypes.c_void_p, ctypes.c_int
    if fn.argtypes is None:
        fn.argtypes = [p, p, p, p, p, p, p, p, p, p, i, i, i, i, i,
                       ctypes.c_float, p]
        fn.restype = ctypes.c_int
    if plan.argtypes is None:
        plan.argtypes = [i, i, i, i, ctypes.POINTER(ctypes.c_int)]
        plan.restype = ctypes.c_int
    return fn, plan


def device_plan(S: int, I: int, C: int, R: int, device=None) -> dict:
    """The kernel's launch plan on the card for these widths: grid,
    cells and projection columns per CTA, dynamic shared memory, whether
    the weights are resident, the SM count, and whether the cells' bias
    and peepholes and their c state sit in shared memory."""
    _, plan = _entries()
    out = (ctypes.c_int * 10)()
    with torch.cuda.device(device):
        err = plan(S, I, C, R, out)
    if err != 0:
        raise RuntimeError(f"lstm_infer: planning failed with CUDA error "
                           f"{err}")
    keys = ("grid", "ncell", "nq", "wld", "qld", "smem", "resident", "sms",
            "const_smem", "c_smem")
    return dict(zip(keys, list(out)))


def k5_plan(C: int, R: int, sms: int = H100_SMS) -> tuple[int, int, int]:
    """(grid, cells per CTA, projection columns per CTA), as the kernel
    deals them: equal slices of ceil(C / SMs) cells and ceil(R / SMs)
    columns, one CTA per SM at most."""
    ncell = -(-C // sms)
    nq = -(-R // sms)
    return max(-(-C // ncell), -(-R // nq)), ncell, nq


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
                            cell_clip: float = 50.0, sms: int = H100_SMS
                            ) -> tuple[torch.Tensor, torch.Tensor]:
    """The kernel's decomposition in torch: per step, a gates phase in
    which each of the ``k5_plan`` CTAs computes its cells' four gates
    from [x_t | r_{t-1}] and its columns of [Wx^T; Wr^T], then (after
    the grid barrier) a projection phase in which each CTA computes its
    columns of r_t from all of m and its columns of Wrm^T; each CTA's
    sums split as ``_sliced_product``. x [T, S, I]; returns (r [T, S,
    R], final c)."""
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
               cell_clip: float = 50.0, time_major: bool = False
               ) -> tuple[torch.Tensor, LstmState]:
    """Inference forward of one LSTMP layer over a [S, T, I] chunk
    ([T, S, I] with ``time_major``) from the carried ``state``.
    Returns (r_out with x's layout, final state)."""
    global PLAIN_CALLS
    if needs_grad(params, x, state):
        # the inference kernel keeps no residuals: a gradient needs the
        # training kernels (K1 forward, K2 backward)
        from kaldi_lstm_tpu_torch.ops.lstm_train import lstm_train
        return lstm_train(params, x, state, cell_clip, time_major=time_major)
    if x.device.type == "cpu":
        PLAIN_CALLS += 1
        return lstm_scan(params, x, state, cell_clip, time_major=time_major)
    if x.device.type != "cuda":
        raise ValueError(f"lstm_infer: unsupported device {x.device}")
    if x.dim() != 3:
        raise ValueError(f"lstm_infer: x must be 3-D, got {tuple(x.shape)}")
    x_tm = x if time_major else x.transpose(0, 1)
    r_out, final = lstm_infer_cuda(params, x_tm, state, cell_clip)
    return (r_out if time_major else r_out.transpose(0, 1)), final


def lstm_infer_cuda(params: LstmParams, x_tm: torch.Tensor,
                    state: LstmState, cell_clip: float = 50.0
                    ) -> tuple[torch.Tensor, LstmState]:
    """K5 on the card over x [T, S, I]: (r [T, S, R], final state)."""
    global LAUNCHES
    T, S, I = x_tm.shape
    C, R = params.cell_dim, params.recur_dim
    dev = x_tm.device
    _check("x", x_tm, (T, S, I), dev)
    check_lstm_operands(params, T, S, I, state, dev, "lstm_infer")
    if T == 0:
        return x_tm.new_empty((0, S, R)), state

    x_c = x_tm.contiguous()
    w_cat, bias, peep, wrm_t = _kernel_operands(params)
    r0 = state.r.contiguous()
    c = torch.empty((S, C), dtype=torch.float32, device=dev)
    c.copy_(state.c)
    m = torch.empty((S, C), dtype=torch.float32, device=dev)
    r_out = torch.empty((T, S, R), dtype=torch.float32, device=dev)
    bar = torch.empty(1, dtype=torch.int32, device=dev)   # barrier count
    fn, _ = _entries()
    with torch.cuda.device(dev):
        stream = torch.cuda.current_stream(dev).cuda_stream
        err = fn(x_c.data_ptr(), w_cat.data_ptr(), bias.data_ptr(),
                 peep.data_ptr(), wrm_t.data_ptr(), r0.data_ptr(),
                 c.data_ptr(), m.data_ptr(), r_out.data_ptr(),
                 bar.data_ptr(), T, S, I, C, R, float(cell_clip), stream)
    if err != 0:
        raise RuntimeError(f"lstm_infer: CUDA launch failed with error "
                           f"{err}")
    LAUNCHES += 1
    return r_out, LstmState(c=c, r=r_out[T - 1])
