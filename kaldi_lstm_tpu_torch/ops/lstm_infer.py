"""LSTMP inference forward: the hand-written CUDA counterpart of
``kaldi_lstm_tpu/ops/lstm_pallas.py::_infer_kernel``.

``lstm_infer`` takes the same arguments as the eager ``lstm_scan`` for
an inference call (no dropout, no advance mask, float32). On a CUDA
tensor it launches ``csrc/lstmp_infer.cu`` (two kernels per timestep on
the current stream; see the source for the design) or raises; on a CPU
tensor it runs the plain version, ``lstm_cell.lstm_scan``. It never
falls back from the card to the plain version. A call that autograd
would record (a gradient is needed) goes to ``lstm_train.lstm_train``,
whose kernels keep the residuals the backward reads.

``LAUNCHES`` counts the CUDA kernel launches made (two per timestep);
``PLAIN_CALLS`` counts the calls that took the plain version. A caller
can zero both before a run and read them after it.
"""

from __future__ import annotations

import ctypes

import torch

from kaldi_lstm_tpu_torch.ops.lstm_cell import LstmParams, LstmState, lstm_scan

LAUNCHES = 0
PLAIN_CALLS = 0

_MAX_STREAMS = 65535 * 8  # grid.y limit times the streams per block


def reset_counts() -> None:
    global LAUNCHES, PLAIN_CALLS
    LAUNCHES = 0
    PLAIN_CALLS = 0


def _entry():
    from kaldi_lstm_tpu_torch.ops import _build
    fn = _build.load("lstmp_infer").lstmp_infer_f32
    if fn.argtypes is None:
        p, i = ctypes.c_void_p, ctypes.c_int
        fn.argtypes = [p, p, p, p, p, p, p, p, p, i, i, i, i, i,
                       ctypes.c_float, p]
        fn.restype = ctypes.c_int
    return fn


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
    global LAUNCHES, PLAIN_CALLS
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
    T, S, I = x.shape if time_major else (x.shape[1], x.shape[0], x.shape[2])
    C, R = params.cell_dim, params.recur_dim
    dev = x.device
    _check("x", x, (T, S, I) if time_major else (S, T, I), dev)
    check_lstm_operands(params, T, S, I, state, dev, "lstm_infer")
    if T == 0:
        out = x.new_empty((T, S, R) if time_major else (S, T, R))
        return out, state

    x_tm = (x if time_major else x.transpose(0, 1)).contiguous()
    w_cat, bias, peep, wrm_t = _kernel_operands(params)
    r0 = state.r.contiguous()
    c = torch.empty((S, C), dtype=torch.float32, device=dev)
    c.copy_(state.c)
    m = torch.empty((S, C), dtype=torch.float32, device=dev)
    r_out = torch.empty((T, S, R), dtype=torch.float32, device=dev)
    fn = _entry()
    with torch.cuda.device(dev):
        stream = torch.cuda.current_stream(dev).cuda_stream
        err = fn(x_tm.data_ptr(), w_cat.data_ptr(), bias.data_ptr(),
                 peep.data_ptr(), wrm_t.data_ptr(), r0.data_ptr(),
                 c.data_ptr(), m.data_ptr(), r_out.data_ptr(),
                 T, S, I, C, R, float(cell_clip), stream)
    if err != 0:
        raise RuntimeError(f"lstm_infer: CUDA launch failed with error "
                           f"{err}")
    LAUNCHES += 2 * T
    final = LstmState(c=c, r=r_out[T - 1])
    return (r_out if time_major else r_out.transpose(0, 1)), final
