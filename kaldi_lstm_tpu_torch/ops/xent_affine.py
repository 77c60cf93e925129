"""Fused senone affine + softmax + masked cross-entropy: the hand-written
CUDA counterparts of ``kaldi_lstm_tpu/ops/xent_pallas.py::_fwd_kernel``
(K3) and ``::_bwd_kernel`` (K4), behind one ``torch.autograd.Function``.

``fused_affine_xent(r, w, b, ids, tw, mask) -> (loss, LossAux)`` gives
the numbers of ``train.loss.masked_xent_loss`` on the logits
r @ w.T + b without forming the logits, and is differentiable in r, w
and b. Forward = K3 (per-frame logsumexp, weighted picked logit, first
max and its index), then the torch epilogue ``fused_loss_and_stats``;
backward = K4 (dz stored once, then dr, dW, db). In float32 both are
3xTF32 tensor-core kernels, float32-accurate. On a CUDA tensor each half
launches ``csrc/xent_affine.cu`` or raises; on a CPU tensor it runs its
plain version beside it here (``xent_fwd_plain``, ``xent_bwd_plain``),
which forms the logits in torch. ``xent_fwd_chunked_plain`` spells out
K3's split over class chunks in torch, for the tests and chip_smoke.py.

Shapes: r [N, R]; w [K, R] (Kaldi orientation); b [K]; ids/tw [N, Km]
sparse targets; mask [N].

bf16 (``compute_dtype=torch.bfloat16``, the ``--bf16`` path): the JAX
package's ``xent_pallas.py`` under ``set_matmul_dtype(jnp.bfloat16)``
rounds r and W to bf16 for the logits, and dz with W (dr) and with r
(dW) in the backward, summing in float32; db is summed from the float32
dz. On a CUDA tensor the ``_bf16`` entry points round r and W once a
call into bf16 copies, store dz in bf16 (the reference's one rounding of
dz), and run every product on wgmma fed by TMA (``csrc/wg_gemm.cuh``),
with the tiles and class chunks of ``xent_bf16_plan``;
``xent_bwd_bf16_split_plain`` spells out the backward's sum order in
torch. The plain versions round the same
operands and compute in float32.

Counters: ``FWD_LAUNCHES`` and ``BWD_LAUNCHES`` count the CUDA kernel
launches of the float32 entry points, ``FWD_BF16_LAUNCHES`` and
``BWD_BF16_LAUNCHES`` those of the bf16 ones, as many a call as
``xent_launches`` says (float32: K3 the class-chunk pass and the merge,
K4 dz, dr and dW/db; bf16: K3 adds the prologue that rounds r and W, K4
the prologue, dz, dr, dW and the fold of db's partials);
``PLAIN_CALLS`` the calls of either half that took the plain version.
"""

from __future__ import annotations

import ctypes
import functools

import torch

from kaldi_lstm_tpu_torch.ops.lstm_cell import rounded
from kaldi_lstm_tpu_torch.ops.lstm_infer import (
    H100_SMS,
    _check,
    check_compute_dtype,
)
from kaldi_lstm_tpu_torch.train.loss import (
    LossAux,
    target_best,
    target_entropy,
)

FWD_LAUNCHES = 0
BWD_LAUNCHES = 0
FWD_BF16_LAUNCHES = 0
BWD_BF16_LAUNCHES = 0
PLAIN_CALLS = 0
# classes per K3 chunk (a multiple of the kernels' 128-class tile): the
# float32 forward's grid is (frame tiles of 128) x (chunks), 40 x 8 CTAs
# at the flagship shape (N = 5120, K = 8000)
FWD_CHUNK = 1024
# the bf16 kernels' output tiles (csrc/wg_gemm.cuh): 128 x 128
TILE16 = 128


def xent_launches(bf16: bool = False) -> tuple[int, int]:
    """(K3, K4) CUDA kernel launches a call of the float32 entry points
    or, with `bf16`, the bf16 ones."""
    return (3, 5) if bf16 else (2, 3)


def _ld8(n: int) -> int:
    return -(-n // 8) * 8


def xent_bf16_plan(N: int, R: int, K: int, sms: int = H100_SMS) -> dict:
    """The bf16 kernels' plan at these widths on a card of `sms` SMs:

    * the logits walk (K3, K4's dz): items of one 128-frame row tile and
      one chunk of `chunk` classes (ct tiles of 128), a persistent grid of
      min(items, sms) CTAs; ct from 1 to 8 with the fewest tile times on
      the busiest SM (ceil(items / sms) x ct), then the widest chunk;
    * dr: 128 x 128 tiles over the frames and R, each over the whole
      contraction (every bf16 path runs it at N = 5120 or a shard of
      it: 80 tiles or more);
    * dW: 128 x 128 tiles over the classes and R;
    * the bf16 copies' leading dimensions (multiples of 8)."""
    return dict(_bf16_plan(N, R, K, sms))


@functools.lru_cache(maxsize=256)
def _bf16_plan(N: int, R: int, K: int, sms: int) -> tuple:
    nrt, nct, njt = -(-N // TILE16), -(-K // TILE16), -(-R // TILE16)
    best = None
    for ct in range(1, 9):
        items = nrt * -(-nct // ct)
        key = (-(-items // sms) * ct, -ct)
        if best is None or key < best[0]:
            best = (key, ct)
    ct = best[1]
    nch = -(-nct // ct)
    return tuple(dict(
        chunk=ct * TILE16, nch=nch, nrt=nrt, njt=njt, nct=nct,
        logits_items=nrt * nch, logits_grid=min(nrt * nch, sms),
        dr_items=nrt * njt, dr_grid=min(nrt * njt, sms),
        dw_items=nct * njt, dw_grid=min(nct * njt, sms), r_ld=_ld8(R),
        dz_ld=_ld8(K), sms=sms).items())


_SMS: dict = {}


def _sms(device) -> int:
    """The card's SM count (cached per device)."""
    key = torch.device(device).index
    if key not in _SMS:
        _SMS[key] = torch.cuda.get_device_properties(
            device).multi_processor_count
    return _SMS[key]


def reset_counts() -> None:
    global FWD_LAUNCHES, BWD_LAUNCHES, FWD_BF16_LAUNCHES, BWD_BF16_LAUNCHES
    global PLAIN_CALLS
    FWD_LAUNCHES = 0
    BWD_LAUNCHES = 0
    FWD_BF16_LAUNCHES = 0
    BWD_BF16_LAUNCHES = 0
    PLAIN_CALLS = 0


def _entries(bf16: bool = False):
    """K3's and K4's C entry points: the float32 ones, or the bf16 ones."""
    from kaldi_lstm_tpu_torch.ops import _build
    return _bind(_build.load("xent_affine"), bf16)


def _bind(lib, bf16: bool):
    """The (K3, K4) entry points of a loaded csrc/xent_affine.cu library,
    their ctypes signatures set."""
    tag = "bf16" if bf16 else "f32"
    fwd = getattr(lib, f"xent_affine_fwd_{tag}")
    bwd = getattr(lib, f"xent_affine_bwd_{tag}")
    p, i = ctypes.c_void_p, ctypes.c_int
    if fwd.argtypes is None:
        fwd.argtypes = ([p] * 12 + [i] * 6 if bf16 else
                        [p] * 10 + [i] * 5) + [p]
        fwd.restype = ctypes.c_int
    if bwd.argtypes is None:
        bwd.argtypes = ([p] * 14 + [i] + [p] + [i] * 6 if bf16 else
                        [p] * 12 + [i] * 6) + [p]
        bwd.restype = ctypes.c_int
    return fwd, bwd


# ---------------------------------------------------------------------------
# plain versions (CPU tensors; the card holds the kernels against them)
# ---------------------------------------------------------------------------

def _class_ids(ids, K: int):
    """(ids clamped into [0, K) as int64, mask of the ids inside it): a
    target id outside the classes matches none of them, as in the
    kernels, which skip it (a class shard's out-of-shard targets)."""
    ids_l = ids.long()
    inside = (ids_l >= 0) & (ids_l < K)
    return ids_l.clamp(0, K - 1), inside


def xent_fwd_plain(r, w, b, ids, tw, compute_dtype=None):
    """K3's outputs from the logits formed in torch: (lse, picked, amax
    [N] float32, aidx [N] int32; aidx is the first max). A target id
    outside [0, K) adds nothing to picked. With a
    ``compute_dtype`` the logits product's operands are rounded to it."""
    z = rounded(r, compute_dtype) @ rounded(w, compute_dtype).T + b
    lse = torch.logsumexp(z, dim=-1)
    ids_l, inside = _class_ids(ids, z.shape[1])
    picked = torch.sum(torch.where(inside, tw * torch.gather(z, 1, ids_l),
                                   torch.zeros_like(tw)), dim=-1)
    amax = z.amax(dim=-1)
    aidx = torch.argmax(z, dim=-1).to(torch.int32)
    return lse, picked, amax, aidx


def xent_fwd_chunked_plain(r, w, b, ids, tw, chunk: int,
                           compute_dtype=None):
    """K3's decomposition in torch: per chunk of `chunk` classes the
    chunk's max, its first index, the sum of exp(z - max) and the
    weighted picked logits of the targets inside it; then the chunks
    merged in increasing order with a strict >, as the kernel's second
    launch does. Same results as ``xent_fwd_plain``."""
    K = w.shape[0]
    r, w = rounded(r, compute_dtype), rounded(w, compute_dtype)
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


def xent_bwd_plain(r, w, b, ids, tw, lse, scale, wtot, compute_dtype=None):
    """K4's outputs from the logits formed in torch: dz = scale * (wtot *
    exp(z - lse) - sum_j tw_j onehot(id_j)), where an id outside [0, K)
    has no one-hot; returns (dr, dW, db). With a
    ``compute_dtype`` the operands of the three products (r and W, dz and
    W, dz and r) are rounded to it; db is summed from the unrounded dz."""
    r, w = rounded(r, compute_dtype), rounded(w, compute_dtype)
    z = r @ w.T + b
    dz = torch.exp(z - lse[:, None]) * wtot[:, None]
    ids_l, inside = _class_ids(ids, z.shape[1])
    neg_tw = torch.where(inside, -tw, torch.zeros_like(tw))
    for j in range(ids.shape[1]):
        dz.scatter_add_(1, ids_l[:, j:j + 1], neg_tw[:, j:j + 1])
    dz = dz * scale[:, None]
    dzc = rounded(dz, compute_dtype)
    return dzc @ w, dzc.T @ r, dz.sum(0)


def xent_bwd_bf16_split_plain(r, w, b, ids, tw, lse, scale, wtot):
    """The bf16 K4's sums in torch: dz formed in float32 from the logits
    of r and W rounded to bf16 and rounded once to bf16 (dzc); dr = dzc W
    and dW = dzc^T r; db from the float32 dz split by 128-frame tile,
    each tile summed apart and the tiles added in order. The same results
    as ``xent_bwd_plain`` in bf16."""
    N, K = r.shape[0], w.shape[0]
    bf = torch.bfloat16
    r16, w16 = rounded(r, bf), rounded(w, bf)
    z = r16 @ w16.T + b
    dz = torch.exp(z - lse[:, None]) * wtot[:, None]
    ids_l, inside = _class_ids(ids, K)
    neg_tw = torch.where(inside, -tw, torch.zeros_like(tw))
    for j in range(ids.shape[1]):
        dz.scatter_add_(1, ids_l[:, j:j + 1], neg_tw[:, j:j + 1])
    dz = dz * scale[:, None]
    dzc = rounded(dz, bf)
    db = None
    for m0 in range(0, N, TILE16):
        part = dz[m0:m0 + TILE16].sum(0)
        db = part if db is None else db + part
    return dzc @ w16, dzc.T @ r16, db


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


def xent_fwd_cuda(r, w, b, ids, tw, compute_dtype=None):
    """K3 on the card (``xent_affine_fwd_bf16`` when ``compute_dtype`` is
    torch.bfloat16); same arguments and results as the plain version
    (ids int32)."""
    global FWD_LAUNCHES, FWD_BF16_LAUNCHES
    bf16 = check_compute_dtype(compute_dtype, "fused_affine_xent")
    N, R, K, Km = _check_inputs(r, w, b, ids, tw)
    ops = [t.contiguous() for t in (r, w, b, ids, tw)]
    f32 = dict(dtype=torch.float32, device=r.device)
    lse = torch.empty((N,), **f32)
    picked = torch.empty((N,), **f32)
    amax = torch.empty((N,), **f32)
    aidx = torch.empty((N,), dtype=torch.int32, device=r.device)
    extra = []
    if bf16:
        plan = xent_bf16_plan(N, R, K, _sms(r.device))
        chunk = plan["chunk"]
        # the bf16 copies of r and W, made anew on every call
        extra = [torch.empty((n, plan["r_ld"]), dtype=torch.bfloat16,
                             device=r.device) for n in (N, K)]
    else:
        chunk = FWD_CHUNK
    # per-(chunk, row) max, sum-exp, picked and first index
    part = torch.empty((4, -(-K // chunk), N), **f32)
    fwd, _ = _entries(bf16)
    with torch.cuda.device(r.device):
        stream = torch.cuda.current_stream(r.device).cuda_stream
        args = [*(t.data_ptr() for t in ops), lse.data_ptr(),
                picked.data_ptr(), amax.data_ptr(), aidx.data_ptr(),
                part.data_ptr(), *(t.data_ptr() for t in extra), N, R, K,
                Km, chunk]
        if bf16:
            args.append(plan["sms"])
        err = fwd(*args, stream)
    if err != 0:
        raise RuntimeError(f"fused_affine_xent: K3 launch failed with CUDA "
                           f"error {err}")
    if bf16:
        FWD_BF16_LAUNCHES += xent_launches(True)[0]
    else:
        FWD_LAUNCHES += xent_launches(False)[0]
    return lse, picked, amax, aidx


def xent_bwd_cuda(r, w, b, ids, tw, lse, scale, wtot, compute_dtype=None):
    """K4 on the card (``xent_affine_bwd_bf16`` when ``compute_dtype`` is
    torch.bfloat16); same arguments and results as the plain version."""
    global BWD_LAUNCHES, BWD_BF16_LAUNCHES
    bf16 = check_compute_dtype(compute_dtype, "fused_affine_xent")
    N, R, K, Km = _check_inputs(r, w, b, ids, tw)
    for name, t in (("lse", lse), ("scale", scale), ("wtot", wtot)):
        _check(name, t, (N,), r.device, "fused_affine_xent")
    ops = [t.contiguous() for t in (r, w, b, ids, tw, lse, scale, wtot)]
    f32 = dict(dtype=torch.float32, device=r.device)
    dr = torch.empty((N, R), **f32)
    dw = torch.empty((K, R), **f32)
    db = torch.empty((K,), **f32)
    _, bwd = _entries(bf16)
    if bf16:
        plan = xent_bf16_plan(N, R, K, _sms(r.device))
        b16 = dict(dtype=torch.bfloat16, device=r.device)
        # the bf16 copies of r and W (made anew on every call), dz in bf16
        # (written once by the dz launch, read by dr and dW) and the db
        # partials of the frame tiles
        ldz = plan["dz_ld"]
        r16 = torch.empty((N, plan["r_ld"]), **b16)
        w16 = torch.empty((K, plan["r_ld"]), **b16)
        dz = torch.empty((N, ldz), **b16)
        dbp = torch.empty((plan["nrt"], K), **f32)
        with torch.cuda.device(r.device):
            stream = torch.cuda.current_stream(r.device).cuda_stream
            err = bwd(*(t.data_ptr() for t in ops), dr.data_ptr(),
                      dw.data_ptr(), db.data_ptr(), r16.data_ptr(),
                      w16.data_ptr(), dz.data_ptr(), ldz, dbp.data_ptr(),
                      N, R, K, Km, plan["chunk"], plan["sms"], stream)
    else:
        # dz, written once by the first launch and read by the other two;
        # rows padded to a multiple of 4 floats for 16-byte copies
        ldz = -(-K // 4) * 4
        dz = torch.empty((N, ldz), **f32)
        with torch.cuda.device(r.device):
            stream = torch.cuda.current_stream(r.device).cuda_stream
            err = bwd(*(t.data_ptr() for t in ops), dr.data_ptr(),
                      dw.data_ptr(), db.data_ptr(), dz.data_ptr(), ldz, N,
                      R, K, Km, FWD_CHUNK, stream)
    if err != 0:
        raise RuntimeError(f"fused_affine_xent: K4 launch failed with CUDA "
                           f"error {err}")
    if bf16:
        BWD_BF16_LAUNCHES += xent_launches(True)[1]
    else:
        BWD_LAUNCHES += xent_launches(False)[1]
    return dr, dw, db


def xent_fwd(r, w, b, ids, tw, compute_dtype=None):
    """K3 for a CUDA tensor, its plain version for a CPU tensor."""
    global PLAIN_CALLS
    if r.device.type == "cuda":
        return xent_fwd_cuda(r, w, b, ids, tw, compute_dtype)
    if r.device.type != "cpu":
        raise ValueError(f"fused_affine_xent: unsupported device {r.device}")
    check_compute_dtype(compute_dtype, "fused_affine_xent")
    PLAIN_CALLS += 1
    return xent_fwd_plain(r, w, b, ids, tw, compute_dtype)


def xent_bwd(r, w, b, ids, tw, lse, scale, wtot, compute_dtype=None):
    """K4 for a CUDA tensor, its plain version for a CPU tensor."""
    global PLAIN_CALLS
    if r.device.type == "cuda":
        return xent_bwd_cuda(r, w, b, ids, tw, lse, scale, wtot,
                             compute_dtype)
    if r.device.type != "cpu":
        raise ValueError(f"fused_affine_xent: unsupported device {r.device}")
    check_compute_dtype(compute_dtype, "fused_affine_xent")
    PLAIN_CALLS += 1
    return xent_bwd_plain(r, w, b, ids, tw, lse, scale, wtot, compute_dtype)


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
    def forward(ctx, r, w, b, ids, tw, mask, compute_dtype):
        lse, picked, _, aidx = xent_fwd(r, w, b, ids, tw, compute_dtype)
        xent, aux = fused_loss_and_stats(lse, picked, aidx, ids, tw, mask)
        ctx.save_for_backward(r, w, b, ids, tw, mask, lse)
        ctx.compute_dtype = compute_dtype
        ctx.mark_non_differentiable(aux.entropy, aux.correct, aux.frames)
        return xent, aux.entropy, aux.correct, aux.frames

    @staticmethod
    def backward(ctx, g_loss, *_):
        r, w, b, ids, tw, mask, lse = ctx.saved_tensors
        scale = (g_loss * mask.to(torch.float32)).contiguous()
        wtot = torch.sum(tw, dim=-1)
        dr, dw, db = xent_bwd(r, w, b, ids, tw, lse, scale, wtot,
                              ctx.compute_dtype)
        return dr, dw, db, None, None, None, None


def fused_affine_xent(r, w, b, ids, tw, mask, compute_dtype=None
                      ) -> tuple[torch.Tensor, LossAux]:
    """loss = masked xent of softmax(r @ w.T + b) vs sparse targets, and
    its statistics, without forming the logits. Differentiable in r, w,
    b. ``compute_dtype`` (None or torch.bfloat16) is the products'
    operand dtype (the module docstring's bf16 contract)."""
    loss, ent, correct, frames = _FusedAffineXent.apply(
        r, w, b, ids.to(torch.int32), tw, mask, compute_dtype)
    return loss, LossAux(xent=loss.detach(), entropy=ent, correct=correct,
                         frames=frames)
