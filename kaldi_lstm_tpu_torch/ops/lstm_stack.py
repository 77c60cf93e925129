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
points run; the plain versions round the same operands
(``lstm_fwd_residuals_plain`` and ``lstm_scan`` with the same
``compute_dtype``).

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

import torch

from kaldi_lstm_tpu_torch.ops.lstm_cell import LstmParams, LstmState, lstm_scan
from kaldi_lstm_tpu_torch.ops.lstm_infer import (
    H100_SMS,
    _check,
    _kernel_operands,
    check_compute_dtype,
    check_lstm_operands,
)
from kaldi_lstm_tpu_torch.ops.lstm_train import (
    _GATE_CELLS,
    _ctas,
    _peep,
    lstm_fwd_residuals_plain,
)

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
              sms: int = H100_SMS) -> dict[str, int]:
    """K6's gate tile: 64 rows where the running layers' 64 x 64 tiles
    (both layers' in one launch) fill the card, else 32; the projection
    takes K1's 32 x 32 tiles. Returns the padded cells and the gate
    tile's rows."""
    Cp = -(-C // _GATE_CELLS) * _GATE_CELLS
    layers = 2 if phases == "both" else 1
    gate_bm = 64 if layers * _ctas(S, 4 * Cp, 64, 64) >= sms else 32
    return {"padded_cells": Cp, "gate_bm": gate_bm}


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
        fwd.argtypes = [p] * 25 + [i] * 7 + [f, i, p]
        fwd.restype = ctypes.c_int
    if infer.argtypes is None:
        infer.argtypes = [p] * 17 + [i] * 6 + [f, p]
        infer.restype = ctypes.c_int
    if plan.argtypes is None:
        plan.argtypes = [i] * 5 + [ctypes.POINTER(ctypes.c_int)]
        plan.restype = ctypes.c_int
    return fwd, infer, plan


def infer2_plan(S: int, I: int, C: int, R: int, device=None,
                bf16: bool = False) -> dict:
    """K7's launch plan on the card for these widths (the bf16 entry
    point's with ``bf16``): grid, cells and projection columns per CTA,
    the slices' strides, floats per staging buffer, dynamic shared
    memory, SM count, whether the bias and peepholes and the c state sit
    in shared memory, and the shared-memory byte offsets of each layer's
    gate and projection slices (-1: read from device memory)."""
    _, _, plan = _entries()
    out = (ctypes.c_int * 14)()
    with torch.cuda.device(device):
        err = plan(S, I, C, R, int(bf16), out)
    if err != 0:
        raise RuntimeError(f"lstm_stack: K7 planning failed with CUDA error "
                           f"{err}")
    keys = ("grid", "ncell", "nq", "wld", "qld", "buf", "smem", "sms",
            "const_smem", "c_smem", "wg1", "wg2", "wq1", "wq2")
    return dict(zip(keys, list(out)))


def _ptrs(ts) -> list[int]:
    return [t.data_ptr() for t in ts]


def _train_weights(p: LstmParams) -> list[torch.Tensor]:
    """One layer's weights as K1 takes them: w_gifo_x, w_gifo_r, bias,
    peepholes [3, C], w_r_m, all contiguous."""
    return [p.w_gifo_x.contiguous(), p.w_gifo_r.contiguous(),
            p.bias.contiguous(), _peep(p), p.w_r_m.contiguous()]


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
    plan = fwd2_plan(S, C, phases, torch.cuda.get_device_properties(
        dev).multi_processor_count)
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
    scratch = [torch.empty((T, S, 4 * C), **f32),
               torch.empty((tb, S, 4 * C), **f32),
               torch.empty((2, 4 * plan["padded_cells"], R), **f32),
               torch.empty((2, S, C), **f32)]
    fwd, _, _ = _entries(bf16)
    with torch.cuda.device(dev):
        stream = torch.cuda.current_stream(dev).cuda_stream
        err = fwd(*_ptrs([x_tm.contiguous(), *w, *states, *outs, *scratch]),
                  T, S, I, C, R, tb, PHASES[phases], float(cell_clip),
                  plan["gate_bm"], stream)
    if err != 0:
        raise RuntimeError(f"lstm_stack: K6 launch failed with CUDA error "
                           f"{err}")
    if bf16:
        FWD2_BF16_LAUNCHES += wavefront_launches(T, tb, phases)
    else:
        FWD2_LAUNCHES += wavefront_launches(T, tb, phases)
    return tuple(outs)


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
    f32 = dict(dtype=torch.float32, device=dev)
    w = [*_kernel_operands(p1), *_kernel_operands(p2)]
    c1 = s1.c.clone(memory_format=torch.contiguous_format)
    c2 = s2.c.clone(memory_format=torch.contiguous_format)
    r01, r02 = s1.r.contiguous(), s2.r.contiguous()
    r1 = torch.empty((S, R), **f32)
    r2 = torch.empty((T, S, R), **f32)
    m = torch.empty((2, S, C), **f32)
    bar = torch.empty(1, dtype=torch.int32, device=dev)   # barrier count
    _, infer, _ = _entries(bf16)
    with torch.cuda.device(dev):
        stream = torch.cuda.current_stream(dev).cuda_stream
        err = infer(*_ptrs([x_tm.contiguous(), *w, r01, r02, c1, c2, r1, r2,
                            m, bar]),
                    T, S, I, C, R, tb, float(cell_clip), stream)
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
