"""SGD with classical momentum, nnet1 semantics; PyTorch edition of
``kaldi_lstm_tpu.train.optim``.

    corr_t = grad_t + momentum * corr_{t-1}        (grads SUMMED over frames)
    w_t    = w_{t-1} - lr * corr_t

`grad_clip` clips corr element-wise in place before the update (the
standard variant's +-50), so the carried momentum buffer is the clipped
one. Unlike the JAX package, which returns new arrays, `momentum_update`
updates the parameter and momentum tensors IN PLACE (under
``torch.no_grad``, with ``mul_``/``add_``/``sub_``) and returns the same
objects: a step then needs no second copy of the weights. The
arithmetic, and its order, is the JAX package's.
"""

from __future__ import annotations

from typing import Any, NamedTuple

import torch

from kaldi_lstm_tpu_torch.utils.tree import tree_leaves, tree_map

Params = Any


class MomentumState(NamedTuple):
    corr: Params  # momentum-accumulated correction, same tree as params


def init_momentum(params: Params) -> MomentumState:
    return MomentumState(corr=tree_map(torch.zeros_like, params))


@torch.no_grad()
def momentum_update(params: Params, grads: Params, opt_state: MomentumState,
                    learn_rate, momentum=0.0, grad_clip: float = 0.0,
                    lr_scale: Params = None, l1_penalty: float = 0.0,
                    l2_penalty: float = 0.0, num_frames: int = 0,
                    reg_mask: Params = None) -> tuple[Params, MomentumState]:
    """`learn_rate` and `momentum` are floats or 0-d tensors on the
    parameters' device (the trainer passes tensors, so a filler batch's
    lr 0 / momentum 1 guard costs no host sync). `lr_scale` is an
    optional tree of per-leaf floats (nnet1's <LearnRateCoef> /
    <BiasLearnRateCoef>; 0 freezes a tensor). `reg_mask` marks with 1 the
    leaves that take --l1/--l2-penalty (AffineTransform linearity).

    Order and scaling, as upstream (both penalties scaled by lr and by
    num_frames = rows of the minibatch, padding included):
      1. corr = grad + mmt*corr
      2. clip corr to +-grad_clip (when > 0)
      3. l2: w -= lr*l2*num_frames * w      (decay of the OLD weights)
      4. l1: shrink each nonzero weight by the signed lr*l1*num_frames
         unless the full update would cross zero; then weight := 0 and
         its corr entry := 0 (the zeroed corr is what momentum carries)
      5. w -= lr*corr
    """
    flat_p = tree_leaves(params)
    flat_g = tree_leaves(grads)
    flat_c = tree_leaves(opt_state.corr)
    n = len(flat_p)
    flat_s = tree_leaves(lr_scale) if lr_scale is not None else [1.0] * n
    flat_m = tree_leaves(reg_mask) if reg_mask is not None else [0.0] * n
    if not (len(flat_g) == len(flat_c) == len(flat_s) == len(flat_m) == n):
        raise ValueError("momentum_update: trees of different shapes")
    for p, g, c, s, m in zip(flat_p, flat_g, flat_c, flat_s, flat_m):
        c.mul_(momentum).add_(g)
        if grad_clip > 0:
            c.clamp_(-grad_clip, grad_clip)
        lr = learn_rate * s
        if l2_penalty != 0.0 and m:
            p.sub_((lr * l2_penalty * num_frames) * p)
        if l1_penalty != 0.0 and m:
            l1v = lr * l1_penalty * num_frames
            l1v = torch.as_tensor(l1v, dtype=p.dtype, device=p.device)
            nonzero = p != 0.0
            l1_signed = torch.where(p > 0.0, l1v, -l1v)
            after = p - lr * c - l1_signed
            cross = nonzero & ((after > 0.0) != (p > 0.0))
            p.copy_(torch.where(nonzero,
                                torch.where(cross, torch.zeros_like(p),
                                            p - l1_signed), p))
            c.masked_fill_(cross, 0.0)
        p.sub_(lr * c)
    return params, opt_state
