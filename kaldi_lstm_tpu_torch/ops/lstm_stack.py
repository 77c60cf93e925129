"""Two stacked LSTMP layers on the wavefront schedule: the hand-written
CUDA counterparts of ``kaldi_lstm_tpu/ops/lstm_stack_pallas.py``'s
``_fwd2_kernel`` (K6) and ``_infer2_kernel`` (K7).

Layer 1 takes x [T, S, I], layer 2 takes layer 1's r; the two layers
share the cell and projection widths (``stack_compatible``). The
wavefront runs layer 1 over time block k while layer 2 runs over block
k - 1, so one launch covers both layers (see ``csrc/lstmp_stack.cu``).
``tb`` is the number of timesteps per block and must divide T; the
default is the largest divisor of T up to 5, as the JAX package plans
its time blocks.

* ``lstm_stack_fwd2`` (K6): the training forward of both layers with
  K1's residuals for each, ``(gifo1, c1, r1, gifo2, c2, r2)``, every one
  [T, S, .] float32 and unpadded: the post-activation gates g, i, f, o,
  the clipped c and r. ``lstm_train.lstm_bwd`` takes each layer's triple
  as it takes K1's (layer 2's x is r1).
* ``lstm_stack_infer2`` (K7): the inference forward; returns (r2
  [T, S, R], final state of layer 1, final state of layer 2).

On a CUDA tensor each launches its kernel or raises; on a CPU tensor it
runs the plain version beside it here, the serial composition of the
one-layer functions (``lstm_train.lstm_fwd_residuals_plain`` twice,
``lstm_cell.lstm_scan`` twice). It never falls back from the card to the
plain version. float32 only (bf16 variants are ROADMAP B.3); no dropout
and no advance mask, as the TPU kernels take neither. The results are
not differentiable: a gradient goes through ``lstm_train.lstm_bwd``
layer by layer.

``phases`` ("both" | "l1" | "l2") is the reference's timing ablation of
K6: one layer's work is left out. With "l2", layer 2 runs over r1 = 0
(layer 1 never runs). The outputs of the left-out layer are unspecified
on the card and zero in the plain version.

Counters: ``FWD2_LAUNCHES`` and ``INFER2_LAUNCHES`` count the CUDA kernel
launches (``wavefront_launches`` per call); ``PLAIN_CALLS`` counts the
calls that took a plain version. ``reset_counts`` zeroes all three.
"""

from __future__ import annotations

import ctypes

import torch

from kaldi_lstm_tpu_torch.ops.lstm_cell import LstmParams, LstmState, lstm_scan
from kaldi_lstm_tpu_torch.ops.lstm_infer import (
    _check,
    _kernel_operands,
    check_lstm_operands,
)
from kaldi_lstm_tpu_torch.ops.lstm_train import lstm_fwd_residuals_plain

FWD2_LAUNCHES = 0
INFER2_LAUNCHES = 0
PLAIN_CALLS = 0

PHASES = {"both": 0, "l1": 1, "l2": 2}
MAX_TIME_BLOCK = 5


def reset_counts() -> None:
    global FWD2_LAUNCHES, INFER2_LAUNCHES, PLAIN_CALLS
    FWD2_LAUNCHES = 0
    INFER2_LAUNCHES = 0
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


def wavefront_launches(T: int, tb: int, phases: str = "both") -> int:
    """CUDA launches of one K6 or K7 call: per wavefront step one gates
    and one projection launch (T + tb steps with both layers, T with
    one), and one hoisted layer-2 projection per block that runs layer
    2."""
    K = T // tb
    if phases == "l1":
        return 2 * T
    if phases == "l2":
        return 2 * T + K
    return 2 * (T + tb) + K


def _check_stack(p1: LstmParams, p2: LstmParams, x_tm: torch.Tensor,
                 s1: LstmState, s2: LstmState, tb, phases: str
                 ) -> tuple[int, int, int, int, int, int]:
    """Shapes, dtypes and devices of both layers' operands; returns
    (T, S, I, C, R, tb)."""
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
                          cell_clip: float = 50.0, phases: str = "both"
                          ) -> tuple[torch.Tensor, ...]:
    """K6's outputs in torch ops: K1's plain version over layer 1, then
    over layer 2 with r1 as its input."""
    T, S, _ = x_tm.shape
    C, R = p1.cell_dim, p1.recur_dim
    if phases == "l2":
        l1 = (x_tm.new_zeros((T, S, 4 * C)), x_tm.new_zeros((T, S, C)),
              x_tm.new_zeros((T, S, R)))
    else:
        l1 = lstm_fwd_residuals_plain(p1, x_tm, s1.c, s1.r,
                                      cell_clip=cell_clip)
    if phases == "l1":
        l2 = tuple(torch.zeros_like(t) for t in l1)
    else:
        l2 = lstm_fwd_residuals_plain(p2, l1[2], s2.c, s2.r,
                                      cell_clip=cell_clip)
    return (*l1, *l2)


@torch.no_grad()
def lstm_stack_infer2_plain(p1: LstmParams, p2: LstmParams,
                            x_tm: torch.Tensor, s1: LstmState, s2: LstmState,
                            cell_clip: float = 50.0
                            ) -> tuple[torch.Tensor, LstmState, LstmState]:
    """K7's outputs in torch ops: two eager scans."""
    r1, f1 = lstm_scan(p1, x_tm, s1, cell_clip, time_major=True)
    r2, f2 = lstm_scan(p2, r1, s2, cell_clip, time_major=True)
    return r2, f1, f2


# ---------------------------------------------------------------------------
# kernels (CUDA tensors)
# ---------------------------------------------------------------------------

def _entries():
    from kaldi_lstm_tpu_torch.ops import _build
    lib = _build.load("lstmp_stack")
    fwd, infer = lib.lstmp_stack_fwd2_f32, lib.lstmp_stack_infer2_f32
    p, i, f = ctypes.c_void_p, ctypes.c_int, ctypes.c_float
    if fwd.argtypes is None:
        fwd.argtypes = [p] * 21 + [i] * 7 + [f, p]
        fwd.restype = ctypes.c_int
    if infer.argtypes is None:
        infer.argtypes = [p] * 17 + [i] * 6 + [f, p]
        infer.restype = ctypes.c_int
    return fwd, infer


def _weights(p1: LstmParams, p2: LstmParams) -> list[torch.Tensor]:
    """Both layers' weights in the kernels' layout (see
    ``lstm_infer._kernel_operands``): [Wx^T; Wr^T], bias, peepholes,
    Wrm^T, layer 1 then layer 2."""
    return [*_kernel_operands(p1), *_kernel_operands(p2)]


def _ptrs(ts) -> list[int]:
    return [t.data_ptr() for t in ts]


def lstm_stack_fwd2_cuda(p1: LstmParams, p2: LstmParams, x_tm: torch.Tensor,
                         s1: LstmState, s2: LstmState, cell_clip: float = 50.0,
                         tb: int | None = None, phases: str = "both"
                         ) -> tuple[torch.Tensor, ...]:
    """K6 on the card; same arguments and results as the plain version."""
    global FWD2_LAUNCHES
    T, S, I, C, R, tb = _check_stack(p1, p2, x_tm, s1, s2, tb, phases)
    dev = x_tm.device
    f32 = dict(dtype=torch.float32, device=dev)
    w = _weights(p1, p2)
    states = [t.contiguous() for t in (s1.c, s1.r, s2.c, s2.r)]
    # with "l2" layer 1 never runs and layer 2 reads r1 = 0
    r1 = torch.zeros((T, S, R), **f32) if phases == "l2" else \
        torch.empty((T, S, R), **f32)
    outs = [torch.empty((T, S, 4 * C), **f32), torch.empty((T, S, C), **f32),
            r1, torch.empty((T, S, 4 * C), **f32),
            torch.empty((T, S, C), **f32), torch.empty((T, S, R), **f32)]
    scratch = [torch.empty((tb, S, 4 * C), **f32),
               torch.empty((2, S, C), **f32)]
    fwd, _ = _entries()
    with torch.cuda.device(dev):
        stream = torch.cuda.current_stream(dev).cuda_stream
        err = fwd(*_ptrs([x_tm.contiguous(), *w, *states, *outs, *scratch]),
                  T, S, I, C, R, tb, PHASES[phases], float(cell_clip),
                  stream)
    if err != 0:
        raise RuntimeError(f"lstm_stack: K6 launch failed with CUDA error "
                           f"{err}")
    FWD2_LAUNCHES += wavefront_launches(T, tb, phases)
    return tuple(outs)


def lstm_stack_infer2_cuda(p1: LstmParams, p2: LstmParams,
                           x_tm: torch.Tensor, s1: LstmState, s2: LstmState,
                           cell_clip: float = 50.0, tb: int | None = None
                           ) -> tuple[torch.Tensor, LstmState, LstmState]:
    """K7 on the card; same arguments and results as the plain version."""
    global INFER2_LAUNCHES
    T, S, I, C, R, tb = _check_stack(p1, p2, x_tm, s1, s2, tb, "both")
    dev = x_tm.device
    f32 = dict(dtype=torch.float32, device=dev)
    w = _weights(p1, p2)
    c1 = s1.c.clone(memory_format=torch.contiguous_format)
    c2 = s2.c.clone(memory_format=torch.contiguous_format)
    r01, r02 = s1.r.contiguous(), s2.r.contiguous()
    r2 = torch.empty((T, S, R), **f32)
    ring = torch.empty((2, tb, S, R), **f32)
    scratch = [torch.empty((tb, S, 4 * C), **f32),
               torch.empty((2, S, C), **f32)]
    _, infer = _entries()
    with torch.cuda.device(dev):
        stream = torch.cuda.current_stream(dev).cuda_stream
        err = infer(*_ptrs([x_tm.contiguous(), *w, r01, r02, c1, c2, r2,
                            ring, *scratch]),
                    T, S, I, C, R, tb, float(cell_clip), stream)
    if err != 0:
        raise RuntimeError(f"lstm_stack: K7 launch failed with CUDA error "
                           f"{err}")
    INFER2_LAUNCHES += wavefront_launches(T, tb)
    r1T = ring[(T // tb - 1) % 2, tb - 1]
    return r2, LstmState(c=c1, r=r1T), LstmState(c=c2, r=r2[T - 1])


# ---------------------------------------------------------------------------
# dispatch
# ---------------------------------------------------------------------------

def lstm_stack_fwd2(p1: LstmParams, p2: LstmParams, x_tm: torch.Tensor,
                    s1: LstmState, s2: LstmState, cell_clip: float = 50.0,
                    tb: int | None = None, phases: str = "both"
                    ) -> tuple[torch.Tensor, ...]:
    """K6 for a CUDA tensor, its plain version for a CPU tensor."""
    global PLAIN_CALLS
    if x_tm.device.type == "cuda":
        return lstm_stack_fwd2_cuda(p1, p2, x_tm, s1, s2, cell_clip, tb,
                                    phases)
    if x_tm.device.type != "cpu":
        raise ValueError(f"lstm_stack: unsupported device {x_tm.device}")
    _check_stack(p1, p2, x_tm, s1, s2, tb, phases)
    PLAIN_CALLS += 1
    return lstm_stack_fwd2_plain(p1, p2, x_tm, s1, s2, cell_clip, phases)


def lstm_stack_infer2(p1: LstmParams, p2: LstmParams, x_tm: torch.Tensor,
                      s1: LstmState, s2: LstmState, cell_clip: float = 50.0,
                      tb: int | None = None
                      ) -> tuple[torch.Tensor, LstmState, LstmState]:
    """K7 for a CUDA tensor, its plain version for a CPU tensor."""
    global PLAIN_CALLS
    if x_tm.device.type == "cuda":
        return lstm_stack_infer2_cuda(p1, p2, x_tm, s1, s2, cell_clip, tb)
    if x_tm.device.type != "cpu":
        raise ValueError(f"lstm_stack: unsupported device {x_tm.device}")
    _check_stack(p1, p2, x_tm, s1, s2, tb, "both")
    PLAIN_CALLS += 1
    return lstm_stack_infer2_plain(p1, p2, x_tm, s1, s2, cell_clip)
