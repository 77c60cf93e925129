"""Tensor-parallel fused senone-output loss over the mesh's model group;
PyTorch edition of ``kaldi_lstm_tpu.parallel.xent_tp``.

Each model rank holds the rows [lo, hi) of the senone affine (W [K_m, R],
b [K_m]) and the same frames as the other model ranks of its data
position. It runs K3 (``ops/xent_affine.py``, the hand-written CUDA
kernel on the card, its plain version on the CPU) on its class shard:
the shard's logsumexp, weighted picked logit and first argmax, never
forming the logits. Three O(N) collectives over the model group combine
the shards:

* the global logsumexp: ``mx + log(sum(exp(lse_m - mx)))`` (a MAX of the
  shard lse, packed with the shard maxima, then a SUM);
* the picked logits: each target id lies in one shard, so a SUM (packed
  with the exp sums);
* the frame-accuracy argmax: the MAX of the shard maxima (above), then
  the MIN class index among the shards that reach it. The shards are
  contiguous, so that is the FIRST global max (FindRowMaxId semantics).

Backward runs K4 on the shard with the GLOBAL lse and a `wtot` that sums
ALL of a frame's target weights (not only the in-shard ones), then sums
dr over the model group (each shard contributes its classes' part).

Ids are localised: an out-of-shard id becomes -1, which K3/K4 (and their
plain versions) match to no class. Subtracting the shard offset alone is
wrong: an id from another shard could land inside this shard's range.

The port's K4 pads no frame rows, so no row ever needs the JAX package's
lse guard; a large bias, which overflows exp(bias - 0) on the JAX TP
path's padded rows, is exact here (tests/test_torch_xent_tp.py).

Frames are this rank's: the loss and statistics are sums over its own
frames (global over classes), and dW/db are its frames' part, which the
sharded step sums over the data group with the other gradients
(``parallel/sharded_trainer.py``). `fused=False` runs the same function
with the logits formed in torch on the shard (the plain versions of
K3/K4): the unfused loss (--fused-xent false).
"""

from __future__ import annotations

import torch
import torch.distributed as dist

from kaldi_lstm_tpu_torch.ops import xent_affine
from kaldi_lstm_tpu_torch.ops.xent_affine import fused_loss_and_stats
from kaldi_lstm_tpu_torch.parallel.mesh import class_bounds
from kaldi_lstm_tpu_torch.train.loss import LossAux


def shard_local_ids(ids: torch.Tensor, lo: int, hi: int) -> torch.Tensor:
    """Global target ids as ids of the shard [lo, hi): out-of-shard ids
    become -1 (they match no class of the shard)."""
    loc = ids - lo
    return torch.where((ids >= lo) & (ids < hi), loc,
                       torch.full_like(loc, -1)).to(torch.int32)


def combine_shards(lse, picked, amax, aidx, lo: int, K: int, group):
    """(global lse, picked, first argmax) of the frames from each shard's
    K3 results, by the three collectives over `group` (none without
    one)."""
    aidx = aidx.to(torch.int64) + lo
    if group is None:
        return lse, picked, aidx
    mx = torch.stack([lse, amax])
    dist.all_reduce(mx, op=dist.ReduceOp.MAX, group=group)
    lse_max, gmax = mx[0], mx[1]
    sums = torch.stack([torch.exp(lse - lse_max), picked])
    dist.all_reduce(sums, op=dist.ReduceOp.SUM, group=group)
    cand = torch.where(amax >= gmax, aidx, torch.full_like(aidx, K))
    dist.all_reduce(cand, op=dist.ReduceOp.MIN, group=group)
    return lse_max + torch.log(sums[0]), sums[1], cand


class _TpXent(torch.autograd.Function):
    """forward = K3 on the shard + the collectives + the torch epilogue,
    backward = K4 on the shard + the SUM of dr over the model group."""

    @staticmethod
    def forward(ctx, r, w, b, ids, tw, mask, spec, compute_dtype):
        lo, hi, K, group, fused = spec
        ids_l = shard_local_ids(ids, lo, hi)
        fwd = xent_affine.xent_fwd if fused else xent_affine.xent_fwd_plain
        lse, picked, amax, aidx = fwd(r, w, b, ids_l, tw, compute_dtype)
        lse, picked, aidx = combine_shards(lse, picked, amax, aidx, lo, K,
                                           group)
        xent, aux = fused_loss_and_stats(lse, picked, aidx, ids, tw, mask)
        ctx.save_for_backward(r, w, b, ids_l, tw, mask, lse)
        ctx.spec = spec
        ctx.compute_dtype = compute_dtype
        ctx.mark_non_differentiable(aux.entropy, aux.correct, aux.frames)
        return xent, aux.entropy, aux.correct, aux.frames

    @staticmethod
    def backward(ctx, g_loss, *_):
        r, w, b, ids_l, tw, mask, lse = ctx.saved_tensors
        _, _, _, group, fused = ctx.spec
        scale = (g_loss * mask.to(torch.float32)).contiguous()
        wtot = torch.sum(tw, dim=-1)  # every target's weight, all shards
        bwd = xent_affine.xent_bwd if fused else xent_affine.xent_bwd_plain
        dr, dw, db = bwd(r, w, b, ids_l, tw, lse.contiguous(), scale, wtot,
                         ctx.compute_dtype)
        if group is not None:
            dist.all_reduce(dr, op=dist.ReduceOp.SUM, group=group)
        return dr, dw, db, None, None, None, None, None


def make_tp_fused_xent(mesh, num_classes: int, fused: bool = True):
    """`(r, w, b, ids, tw, mask, compute_dtype=None) -> (loss, LossAux)`
    over this rank's frames (r [N, R], ids/tw [N, Km] with GLOBAL class
    ids, mask [N]) and its shard of the `num_classes` senone classes on
    `mesh` (w [K_m, R], b [K_m]: the rows `class_bounds` gives its model
    index), differentiable in r, w and b: the numbers of
    ``fused_affine_xent`` on the whole senone layer for these frames.
    `fused=False` forms the shard's logits in torch."""
    bounds = class_bounds(num_classes, mesh.shape["model"])
    lo, hi = (int(bounds[mesh.model_index]),
              int(bounds[mesh.model_index + 1]))
    spec = (lo, hi, num_classes, mesh.model_group, fused)

    def tp_xent(r, w, b, ids, tw, mask, compute_dtype=None):
        if w.shape[0] != hi - lo:
            raise ValueError(f"tp xent: the shard holds {hi - lo} classes, "
                             f"got w of {w.shape[0]} rows")
        loss, ent, correct, frames = _TpXent.apply(
            r, w, b, ids.to(torch.int32), tw, mask, spec, compute_dtype)
        return loss, LossAux(xent=loss.detach(), entropy=ent,
                             correct=correct, frames=frames)

    return tp_xent
