"""The yardstick: the card's peaks, the operations and bytes each kernel
needs, the model's operations per frame, the kernel-name map, and the
reduction of a profiler trace to busy time, idle gaps and device time
by kernel.

Everything here is frozen with the benchmark: a change to the program
cannot move it. Operations are the model's products, 2 m n k each,
counted once from the shapes; bytes are each input read once and each
output written once, in float32. Both count the frames the inputs need
(valid, unpadded frames), not the padded slots a kernel may sweep.
"""

from __future__ import annotations

import bisect
from typing import Iterable, NamedTuple

# NVIDIA H100 SXM data sheet, dense rates at the 700 W limit. TF32 is
# the highest rate at which the tensor cores take float32 operands; an
# exact float32 implementation needs at least as much work per product,
# so every float32 kernel and the whole step are held to it.
PEAK_FLOPS = 495e12
PEAK_BYTES_PER_S = 3.35e12
F32 = 4
I32 = 4
FRAMES_PER_AUDIO_SECOND = 100
# the host span (torch.profiler.record_function) around a traced window
WINDOW_MARK = "bench.window"


def lstmp_fwd_ops(frames: float, I: int, C: int, R: int) -> float:
    """x Wx^T, r Wr^T and m Wrm^T over `frames` frames."""
    return 2.0 * frames * (4 * C * I + 4 * C * R + R * C)


def lstmp_weight_elems(I: int, C: int, R: int) -> int:
    """Wx, Wr, the bias, the three peepholes and Wrm."""
    return 4 * C * I + 4 * C * R + 4 * C + 3 * C + R * C


def k1_ops(frames, I, C, R):
    return lstmp_fwd_ops(frames, I, C, R)


def k1_bytes(frames, S, I, C, R):
    """x and the weights and the carried state in; r out and the new
    state out."""
    return F32 * (frames * I + lstmp_weight_elems(I, C, R)
                  + 2 * S * (C + R) + frames * R + 2 * S * (C + R))


def k2_ops(frames, I, C, R, need_dx):
    """dWx, dWr, dWrm; dr through Wr and dm through Wrm every step; dx
    through Wx where the layer below needs it."""
    dw = 2.0 * frames * (4 * C * I + 4 * C * R + R * C)
    data = 2.0 * frames * (4 * C * R + R * C)
    dx = 2.0 * frames * 4 * C * I if need_dx else 0.0
    return dw + data + dx


def k2_bytes(frames, S, I, C, R, need_dx):
    """x, dr and the weights in; their gradients (and dx) out."""
    w = lstmp_weight_elems(I, C, R)
    return F32 * (frames * I + frames * R + w + 2 * S * (C + R) + w
                  + (frames * I if need_dx else 0))


def k3_ops(frames, R, K):
    return 2.0 * frames * R * K


def k3_bytes(frames, R, K):
    """r, W, b, ids, weights and mask in; the four statistics out."""
    return F32 * (frames * R + K * R + K) + frames * (I32 + 2 * F32) + 16


def k4_ops(frames, R, K):
    """dr and dW; the recomputed logits are not counted."""
    return 2.0 * 2.0 * frames * R * K


def k4_bytes(frames, R, K):
    """r, W, ids, weights and mask in; dr, dW and db out."""
    return (F32 * (frames * R + K * R) + frames * (I32 + 2 * F32)
            + F32 * (frames * R + K * R + K))


def k5_ops(frames, I, C, R):
    return lstmp_fwd_ops(frames, I, C, R)


def k5_bytes(frames, I, C, R):
    """x and the weights in; r out."""
    return F32 * (frames * I + lstmp_weight_elems(I, C, R) + frames * R)


def bound_s(ops: float, nbytes: float) -> tuple[float, str]:
    """The least time a call could take on the card, and which bound
    sets it."""
    tc, tb = ops / PEAK_FLOPS, nbytes / PEAK_BYTES_PER_S
    return (tc, "compute") if tc >= tb else (tb, "bytes")


def layer_dims(config: dict) -> list[tuple[int, int, int]]:
    """(I, C, R) of every LSTMP layer, bottom first."""
    dims, i = [], config["input_dim"]
    for layer in config["lstmp_layers"]:
        dims.append((i, layer["cell_dim"], layer["proj_dim"]))
        i = layer["proj_dim"]
    return dims


def model_ops_per_frame(config: dict, train: bool) -> float:
    """The model's products per frame: forward; in training also every
    weight gradient and every data gradient that a trainable layer
    below needs (the bottom layer's dx is not needed)."""
    K = config["num_pdfs"]
    total = 0.0
    for n, (I, C, R) in enumerate(layer_dims(config)):
        total += (k1_ops(1, I, C, R)
                  + (k2_ops(1, I, C, R, n > 0) if train else 0.0))
    R = layer_dims(config)[-1][2]
    total += k3_ops(1, R, K) + (k4_ops(1, R, K) if train else 0.0)
    return total


# Kernel names of each counted entry point as the profiler lists them
# (frozen from chip_smoke.py's KERNEL_NAMES). A name belongs to the first
# entry whose key it contains: K1's projection is the one contraction
# with both operands K-major, so it is listed before K2's generic one.
KERNEL_NAMES = {
    "lstmp_train_fwd": ("interleave_gate_rows_kernel", "xw_tc_kernel",
                        "gates_tc_kernel",
                        "contract_tc_kernel<32, 32, true, true", "fwd16_"),
    "lstmp_train_bwd": ("bwd_cell_kernel", "col_reduce_kernel",
                        "reduce_parts_kernel", "contract_tc_kernel<",
                        "bwd16_prep_kernel",
                        "bwd16_dm_kernel", "bwd16_dr_kernel",
                        "contract16_kernel"),
    "xent_affine_fwd": ("xent_fwd_chunk_kernel", "xent_fwd_combine_kernel",
                        "xent16_fwd"),
    "xent_affine_bwd": ("xent_bwd_dz_kernel", "xent_bwd_dr_kernel",
                        "xent_bwd_dw_kernel", "xent16_bwd"),
    "lstmp_infer": ("lstmp_infer_kernel", "lstmp_infer_tc_kernel"),
}


def entry_of(kernel_name: str) -> str | None:
    for entry, keys in KERNEL_NAMES.items():
        if any(k in kernel_name for k in keys):
            return entry
    return None


class DeviceEvent(NamedTuple):
    name: str
    kind: str      # "kernel", "memcpy_dtoh", "memcpy", "memset"
    start: float   # seconds, on the trace's clock
    end: float


class HostEvent(NamedTuple):
    name: str
    start: float
    end: float


class Trace(NamedTuple):
    """A traced window reduced to what the readers need."""
    device: list   # DeviceEvent
    host: list     # HostEvent
    t0: float      # the window's start and end on the trace's clock
    t1: float

    @property
    def window_s(self) -> float:
        return self.t1 - self.t0


def device_kind(name: str) -> str:
    if name.startswith("Memcpy"):
        return "memcpy_dtoh" if "DtoH" in name else "memcpy"
    if name.startswith("Memset"):
        return "memset"
    return "kernel"


def merged(intervals: Iterable[tuple[float, float]]) -> list:
    """The union of [start, end) intervals as sorted disjoint ones."""
    out: list = []
    for s, e in sorted(intervals):
        if out and s <= out[-1][1]:
            if e > out[-1][1]:
                out[-1][1] = e
        else:
            out.append([s, e])
    return out


def clipped(trace: Trace, events) -> list:
    return [(max(e.start, trace.t0), min(e.end, trace.t1)) for e in events
            if e.end > trace.t0 and e.start < trace.t1]


def union_s(trace: Trace, kinds=("kernel",)) -> float:
    """Seconds of the window in which a device event of `kinds` ran; two
    that overlap count once."""
    return sum(e - s for s, e in merged(clipped(
        trace, [d for d in trace.device if d.kind in kinds])))


def busy_s(trace: Trace) -> float:
    """Seconds of the window in which any operation ran on the device."""
    return union_s(trace, ("kernel", "memcpy_dtoh", "memcpy", "memset"))


def kernel_time_s(trace: Trace, entries) -> float:
    """Summed device time of the kernels of the given entry points."""
    return sum(e - s for s, e in clipped(
        trace, [d for d in trace.device
                if d.kind == "kernel" and entry_of(d.name) in entries]))


def top_device_ops(trace: Trace, n: int = 10) -> list:
    tot: dict = {}
    for d in trace.device:
        key = d.name[:120]
        tot[key] = tot.get(key, 0.0) + (d.end - d.start)
    return sorted(([k, v] for k, v in tot.items()),
                  key=lambda kv: -kv[1])[:n]


def idle_gaps(trace: Trace, n: int = 10, short: float = 20e-6) -> list:
    """The window's idle time on the device by what the host was doing:
    each gap of `short` seconds or more between device events is named
    by the innermost host event that covers its middle ("host:
    untraced" where none does), the shorter ones together as "between
    device ops"; the gaps' seconds summed by name, the `n` largest
    sums."""
    busy = merged(clipped(trace, trace.device))
    gaps, cur = [], trace.t0
    for s, e in busy:
        if s > cur:
            gaps.append((cur, s))
        cur = max(cur, e)
    if trace.t1 > cur:
        gaps.append((cur, trace.t1))
    host = sorted((h for h in trace.host if h.name != WINDOW_MARK),
                  key=lambda h: h.start)
    starts = [h.start for h in host]
    tot: dict = {}
    for s, e in gaps:
        key = "between device ops"
        if e - s >= short:
            mid = 0.5 * (s + e)
            best = None
            for h in host[max(0, bisect.bisect_right(starts, mid) - 256):
                          bisect.bisect_right(starts, mid)]:
                if h.end >= mid and (best is None or h.start >= best.start):
                    best = h
            key = best.name[:120] if best is not None else "host: untraced"
        tot[key] = tot.get(key, 0.0) + (e - s)
    return sorted(([k, v] for k, v in tot.items()),
                  key=lambda kv: -kv[1])[:n]


def trace_from_profiler(prof) -> tuple[list, list]:
    """(device events, host events) of a finished torch.profiler run, in
    seconds on the profiler's clock."""
    import torch
    dev, host = [], []
    for e in prof.profiler.kineto_results.events():
        try:
            s, d = e.start_ns() * 1e-9, e.duration_ns() * 1e-9
        except AttributeError:
            s, d = e.start_us() * 1e-6, e.duration_us() * 1e-6
        name = e.name()
        if e.device_type() == torch.autograd.DeviceType.CUDA:
            if name == WINDOW_MARK or getattr(
                    e, "is_user_annotation", lambda: False)():
                continue  # a host span's shadow on the device's timeline

            dev.append(DeviceEvent(name, device_kind(name), s, s + d))
        else:
            host.append(HostEvent(name, s, s + d))
    return dev, host
