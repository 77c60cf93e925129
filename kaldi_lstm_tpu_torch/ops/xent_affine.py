"""Fused senone affine + softmax + masked cross-entropy: the hand-written
CUDA counterparts of ``kaldi_lstm_tpu/ops/xent_pallas.py::_fwd_kernel``
(K3) and ``::_bwd_kernel`` (K4), behind one ``torch.autograd.Function``.

``fused_affine_xent(r, w, b, ids, tw, mask) -> (loss, LossAux)`` gives
the numbers of ``train.loss.masked_xent_loss`` on the logits
r @ w.T + b without forming the logits, and is differentiable in r, w
and b. Forward = K3 (per-frame logsumexp, weighted picked logit, first
max and its index), then the torch epilogue ``fused_loss_and_stats``;
backward = K4 (dz stored once, then dr, dW, db). Both are 3xTF32
tensor-core kernels, float32-accurate. On a CUDA tensor each half
launches ``csrc/xent_affine.cu`` or raises; on a CPU tensor it runs its
plain version beside it here (``xent_fwd_plain``, ``xent_bwd_plain``),
which forms the logits in torch. ``xent_fwd_chunked_plain`` spells out
K3's split over class chunks in torch, for the tests and chip_smoke.py.

Shapes: r [N, R]; w [K, R] (Kaldi orientation); b [K]; ids/tw [N, Km]
sparse targets; mask [N].

Counters: ``FWD_LAUNCHES`` (K3: 2 per call, the class-chunk pass and
the merge) and ``BWD_LAUNCHES`` (K4: 3 per call, dz, dr and dW/db)
count the CUDA kernel launches, ``PLAIN_CALLS`` the calls of either half
that took the plain version.
"""

from __future__ import annotations

import ctypes

import torch

from kaldi_lstm_tpu_torch.ops.lstm_infer import _check
from kaldi_lstm_tpu_torch.train.loss import (
    LossAux,
    target_best,
    target_entropy,
)

FWD_LAUNCHES = 0
BWD_LAUNCHES = 0
PLAIN_CALLS = 0
# classes per K3 chunk (a multiple of the kernels' 128-class tile): the
# forward's grid is (frame tiles of 128) x (chunks), 40 x 8 CTAs at the
# flagship shape (N = 5120, K = 8000)
FWD_CHUNK = 1024


def reset_counts() -> None:
    global FWD_LAUNCHES, BWD_LAUNCHES, PLAIN_CALLS
    FWD_LAUNCHES = 0
    BWD_LAUNCHES = 0
    PLAIN_CALLS = 0


def _entries():
    from kaldi_lstm_tpu_torch.ops import _build
    lib = _build.load("xent_affine")
    fwd, bwd = lib.xent_affine_fwd_f32, lib.xent_affine_bwd_f32
    p, i = ctypes.c_void_p, ctypes.c_int
    if fwd.argtypes is None:
        fwd.argtypes = [p] * 10 + [i] * 5 + [p]
        fwd.restype = ctypes.c_int
    if bwd.argtypes is None:
        bwd.argtypes = [p] * 12 + [i] * 6 + [p]
        bwd.restype = ctypes.c_int
    return fwd, bwd


# ---------------------------------------------------------------------------
# plain versions (CPU tensors; the card holds the kernels against them)
# ---------------------------------------------------------------------------

def xent_fwd_plain(r, w, b, ids, tw):
    """K3's outputs from the logits formed in torch: (lse, picked, amax
    [N] float32, aidx [N] int32; aidx is the first max)."""
    z = r @ w.T + b
    lse = torch.logsumexp(z, dim=-1)
    picked = torch.sum(tw * torch.gather(z, 1, ids.long()), dim=-1)
    amax = z.amax(dim=-1)
    aidx = torch.argmax(z, dim=-1).to(torch.int32)
    return lse, picked, amax, aidx


def xent_fwd_chunked_plain(r, w, b, ids, tw, chunk: int):
    """K3's decomposition in torch: per chunk of `chunk` classes the
    chunk's max, its first index, the sum of exp(z - max) and the
    weighted picked logits of the targets inside it; then the chunks
    merged in increasing order with a strict >, as the kernel's second
    launch does. Same results as ``xent_fwd_plain``."""
    K = w.shape[0]
    ids_l = ids.long()
    parts = []
    for c0 in range(0, K, chunk):
        z = r @ w[c0:c0 + chunk].T + b[c0:c0 + chunk]
        i = torch.argmax(z, dim=-1)
        v = z.gather(1, i[:, None])[:, 0]
        s = torch.exp(z - v[:, None]).sum(-1)
        local = ids_l - c0
        inside = (local >= 0) & (local < z.shape[1])
        zt = z.gather(1, local.clamp(0, z.shape[1] - 1))
        p = torch.where(inside, tw * zt, torch.zeros_like(zt)).sum(-1)
        parts.append((v, i + c0, s, p))
    v, i, s, p = parts[0]
    for v2, i2, s2, p2 in parts[1:]:
        gt = v2 > v
        m = torch.where(gt, v2, v)
        s = s * torch.exp(v - m) + s2 * torch.exp(v2 - m)
        i = torch.where(gt, i2, i)
        v = m
        p = p + p2
    return v + torch.log(s), p, v, i.to(torch.int32)


def xent_bwd_plain(r, w, b, ids, tw, lse, scale, wtot):
    """K4's outputs from the logits formed in torch: dz = scale * (wtot *
    exp(z - lse) - sum_j tw_j onehot(id_j)); returns (dr, dW, db)."""
    z = r @ w.T + b
    dz = torch.exp(z - lse[:, None]) * wtot[:, None]
    for j in range(ids.shape[1]):
        dz.scatter_add_(1, ids[:, j:j + 1].long(), -tw[:, j:j + 1])
    dz = dz * scale[:, None]
    return dz @ w, dz.T @ r, dz.sum(0)


# ---------------------------------------------------------------------------
# kernels (CUDA tensors)
# ---------------------------------------------------------------------------

def _check_inputs(r, w, b, ids, tw) -> tuple[int, int, int, int]:
    N, R = r.shape
    K = w.shape[0]
    Km = ids.shape[1]
    dev = r.device
    _check("r", r, (N, R), dev, "fused_affine_xent")
    _check("w", w, (K, R), dev, "fused_affine_xent")
    _check("b", b, (K,), dev, "fused_affine_xent")
    _check("ids", ids, (N, Km), dev, "fused_affine_xent", torch.int32)
    _check("tw", tw, (N, Km), dev, "fused_affine_xent")
    if min(N, R, K, Km) <= 0:
        raise ValueError(f"fused_affine_xent: empty dimension N={N} R={R} "
                         f"K={K} Km={Km}")
    return N, R, K, Km


def xent_fwd_cuda(r, w, b, ids, tw):
    """K3 on the card; same arguments and results as the plain version
    (ids int32)."""
    global FWD_LAUNCHES
    N, R, K, Km = _check_inputs(r, w, b, ids, tw)
    ops = [t.contiguous() for t in (r, w, b, ids, tw)]
    f32 = dict(dtype=torch.float32, device=r.device)
    lse = torch.empty((N,), **f32)
    picked = torch.empty((N,), **f32)
    amax = torch.empty((N,), **f32)
    aidx = torch.empty((N,), dtype=torch.int32, device=r.device)
    # per-(chunk, row) max, sum-exp, picked and first index
    part = torch.empty((4, -(-K // FWD_CHUNK), N), **f32)
    fwd, _ = _entries()
    with torch.cuda.device(r.device):
        stream = torch.cuda.current_stream(r.device).cuda_stream
        err = fwd(*(t.data_ptr() for t in ops), lse.data_ptr(),
                  picked.data_ptr(), amax.data_ptr(), aidx.data_ptr(),
                  part.data_ptr(), N, R, K, Km, FWD_CHUNK, stream)
    if err != 0:
        raise RuntimeError(f"fused_affine_xent: K3 launch failed with CUDA "
                           f"error {err}")
    FWD_LAUNCHES += 2
    return lse, picked, amax, aidx


def xent_bwd_cuda(r, w, b, ids, tw, lse, scale, wtot):
    """K4 on the card; same arguments and results as the plain version."""
    global BWD_LAUNCHES
    N, R, K, Km = _check_inputs(r, w, b, ids, tw)
    for name, t in (("lse", lse), ("scale", scale), ("wtot", wtot)):
        _check(name, t, (N,), r.device, "fused_affine_xent")
    ops = [t.contiguous() for t in (r, w, b, ids, tw, lse, scale, wtot)]
    f32 = dict(dtype=torch.float32, device=r.device)
    dr = torch.empty((N, R), **f32)
    dw = torch.empty((K, R), **f32)
    db = torch.empty((K,), **f32)
    # dz, written once by the first launch and read by the other two;
    # rows padded to a multiple of 4 floats for 16-byte copies
    ldz = -(-K // 4) * 4
    dz = torch.empty((N, ldz), **f32)
    _, bwd = _entries()
    with torch.cuda.device(r.device):
        stream = torch.cuda.current_stream(r.device).cuda_stream
        err = bwd(*(t.data_ptr() for t in ops), dr.data_ptr(),
                  dw.data_ptr(), db.data_ptr(), dz.data_ptr(), ldz, N, R,
                  K, Km, FWD_CHUNK, stream)
    if err != 0:
        raise RuntimeError(f"fused_affine_xent: K4 launch failed with CUDA "
                           f"error {err}")
    BWD_LAUNCHES += 3
    return dr, dw, db


def xent_fwd(r, w, b, ids, tw):
    """K3 for a CUDA tensor, its plain version for a CPU tensor."""
    global PLAIN_CALLS
    if r.device.type == "cuda":
        return xent_fwd_cuda(r, w, b, ids, tw)
    if r.device.type != "cpu":
        raise ValueError(f"fused_affine_xent: unsupported device {r.device}")
    PLAIN_CALLS += 1
    return xent_fwd_plain(r, w, b, ids, tw)


def xent_bwd(r, w, b, ids, tw, lse, scale, wtot):
    """K4 for a CUDA tensor, its plain version for a CPU tensor."""
    global PLAIN_CALLS
    if r.device.type == "cuda":
        return xent_bwd_cuda(r, w, b, ids, tw, lse, scale, wtot)
    if r.device.type != "cpu":
        raise ValueError(f"fused_affine_xent: unsupported device {r.device}")
    PLAIN_CALLS += 1
    return xent_bwd_plain(r, w, b, ids, tw, lse, scale, wtot)


# ---------------------------------------------------------------------------
# the differentiable op
# ---------------------------------------------------------------------------

def fused_loss_and_stats(lse, picked, aidx, ids, tw, mask):
    """(xent, LossAux) from per-frame logsumexp, picked-logit sums and
    the net's argmax: the numbers of masked_xent_loss."""
    m = mask.to(torch.float32)
    wtot = torch.sum(tw, dim=-1)
    xent = torch.sum((wtot * lse - picked) * m)
    ent = target_entropy(tw, m)
    correct = torch.sum((aidx == target_best(ids, tw)).to(torch.float32)
                        * m)
    return xent, LossAux(xent=xent.detach(), entropy=ent, correct=correct,
                         frames=torch.sum(m))


class _FusedAffineXent(torch.autograd.Function):
    """forward = K3 + the torch epilogue, backward = K4."""

    @staticmethod
    def forward(ctx, r, w, b, ids, tw, mask):
        lse, picked, _, aidx = xent_fwd(r, w, b, ids, tw)
        xent, aux = fused_loss_and_stats(lse, picked, aidx, ids, tw, mask)
        ctx.save_for_backward(r, w, b, ids, tw, mask, lse)
        ctx.mark_non_differentiable(aux.entropy, aux.correct, aux.frames)
        return xent, aux.entropy, aux.correct, aux.frames

    @staticmethod
    def backward(ctx, g_loss, *_):
        r, w, b, ids, tw, mask, lse = ctx.saved_tensors
        scale = (g_loss * mask.to(torch.float32)).contiguous()
        wtot = torch.sum(tw, dim=-1)
        dr, dw, db = xent_bwd(r, w, b, ids, tw, lse, scale, wtot)
        return dr, dw, db, None, None, None


def fused_affine_xent(r, w, b, ids, tw, mask
                      ) -> tuple[torch.Tensor, LossAux]:
    """loss = masked xent of softmax(r @ w.T + b) vs sparse targets, and
    its statistics, without forming the logits. Differentiable in r, w,
    b."""
    loss, ent, correct, frames = _FusedAffineXent.apply(
        r, w, b, ids.to(torch.int32), tw, mask)
    return loss, LossAux(xent=loss.detach(), entropy=ent, correct=correct,
                         frames=frames)
