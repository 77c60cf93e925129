"""The sharded training step over a ('data', 'model') mesh of
torch.distributed ranks; PyTorch edition of
``kaldi_lstm_tpu.parallel.sharded_trainer``.

The step body is the single-card one (`train/trainer.py::_make_step_fn`)
on this rank's streams and parameters (`MeshPlan.place_*`), with:

* the tensor-parallel loss (`parallel/xent_tp.py`) substituted for the
  senone affine + softmax + xent when the model axis has more than one
  rank: K3/K4 on this rank's class shard, of whatever size
  `class_bounds` gives it, where the fused loss is on
  (`default_use_fused`: the xent objective on an [AffineTransform,
  Softmax] tail, by default for CUDA tensors, or --fused-xent), else the
  same collectives around the logits formed in torch on the shard;
* one SUM all-reduce over the data group of every gradient (the
  replicated ones and the class shard's) and the step's statistics, in
  one flat buffer, before the update. nnet1 sums gradients over frames,
  so the global batch's gradient is the SUM of the ranks' (a mean, as
  DDP takes by default, would be wrong). The all-reduce hands every rank
  the same result, so the momentum update, L2 and max-norm run
  identically on every rank and the replicated parameters stay
  bit-identical;
* the penalties' frame count of the global batch (S x D x T).

The grouped sharded step is a loop of sharded steps with the same math:
the JAX package's is one lax.scan, but a CUDA graph cannot capture the
collectives of the gloo backend (the one-card path), so it is not a
graph replay here.
"""

from __future__ import annotations

from typing import Optional

import torch
import torch.distributed as dist

from kaldi_lstm_tpu_torch.models.nnet import Nnet
from kaldi_lstm_tpu_torch.parallel.mesh import MeshPlan
from kaldi_lstm_tpu_torch.parallel.xent_tp import make_tp_fused_xent
from kaldi_lstm_tpu_torch.train.loss import LossAux
from kaldi_lstm_tpu_torch.train.trainer import (
    TrainOptions,
    _make_step_fn,
    default_use_fused,
    pack_aux,
)
from kaldi_lstm_tpu_torch.utils.tree import tree_leaves, tree_unflatten


def _validate_stream_count(plan: MeshPlan, states_example) -> None:
    """Fail fast with a clear message when the global stream count does
    not divide over the data axis."""
    data = plan.mesh.shape["data"]
    if states_example is None or data <= 1:
        return
    for leaf in tree_leaves(states_example):
        if hasattr(leaf, "shape") and len(leaf.shape) >= 1:
            s = leaf.shape[0]
            if s % data != 0:
                raise ValueError(
                    f"num_stream={s} is not divisible by the mesh data "
                    f"axis ({data}); pick S as a multiple of the data "
                    f"axis (pad with dummy streams if needed — masked "
                    f"frames contribute nothing)")
            return


def make_data_reduce(group):
    """`reduce(grads, aux) -> (grads, aux)`: the SUM over `group` of
    every gradient leaf and the four statistics, in one flat all-reduce
    (`grads` None: the statistics alone)."""

    def reduce(grads, aux: LossAux):
        stats = torch.stack([torch.as_tensor(v).to(torch.float32).reshape(())
                             for v in aux])
        leaves = tree_leaves(grads) if grads is not None else []
        if any(g.dtype != torch.float32 for g in leaves):
            raise ValueError("sharded step: gradients must be float32")
        flat = torch.cat([stats] + [g.reshape(-1) for g in leaves])
        dist.all_reduce(flat, op=dist.ReduceOp.SUM, group=group)
        out_aux = LossAux(*flat[:4].unbind())
        if grads is None:
            return None, out_aux
        parts, at = [], 4
        for g in leaves:
            parts.append(flat[at:at + g.numel()].view_as(g))
            at += g.numel()
        return tree_unflatten(grads, parts), out_aux

    return reduce


def _build_step(nnet: Nnet, opts: TrainOptions, plan: MeshPlan,
                transf: Optional[Nnet], crossvalidate: bool,
                states_example):
    _validate_stream_count(plan, states_example)
    fused_fn = None
    use_fused = None
    if plan.tp_index is not None:
        if opts.objective != "xent":
            raise ValueError("a model axis > 1 shards the senone softmax "
                             "of the xent objective; use --mesh data=D "
                             f"with --objective-function {opts.objective}")
        fused_fn = make_tp_fused_xent(
            plan.mesh, int(plan.bounds[-1]),
            fused=default_use_fused(nnet, opts, plan.mesh.device))
        use_fused = True
    group = plan.mesh.data_group
    return _make_step_fn(
        nnet, opts, transf, crossvalidate, plan.mesh.device,
        use_fused=use_fused, fused_fn=fused_fn,
        reduce_fn=make_data_reduce(group) if group is not None else None,
        data_parallel=plan.mesh.shape["data"])


def make_sharded_train_step(nnet: Nnet, opts: TrainOptions, plan: MeshPlan,
                            transf: Optional[Nnet] = None,
                            crossvalidate: bool = False,
                            states_example=None):
    """The sharded step: (params, opt_state, states, transf_params,
    feats, tgt_ids, tgt_weights, mask, reset_flags, learn_rate, rng=None)
    -> (params, opt_state, states, aux), over this rank's parameters
    (`plan.place_params`), carry states and batch rows, with `aux` the
    statistics of the GLOBAL batch. `states_example` is the global carry
    (its stream count is checked against the data axis). Every rank of
    the mesh must call the step the same number of times."""
    return _build_step(nnet, opts, plan, transf, crossvalidate,
                       states_example)


def make_sharded_grouped_train_step(
        nnet: Nnet, opts: TrainOptions, plan: MeshPlan,
        transf: Optional[Nnet] = None, crossvalidate: bool = False,
        states_example=None):
    """B sharded steps per call over batch tensors with a leading [B]
    axis (the streams on axis 1): (params, opt_state, states,
    transf_params, feats, tgt_ids, tgt_weights, mask, reset_flags,
    learn_rate, rng=None) -> (params, opt_state, states, aux [B, 4]
    float32 rows of (xent, entropy, correct, frames)). A loop of the
    plain sharded step (see the module docstring)."""
    step = _build_step(nnet, opts, plan, transf, crossvalidate,
                       states_example)

    def gstep(params, opt_state, states, transf_params, feats, tgt_ids,
              tgt_weights, mask, reset_flags, learn_rate, rng=None):
        rows = []
        for i in range(feats.shape[0]):
            params, opt_state, states, aux = step(
                params, opt_state, states, transf_params, feats[i],
                tgt_ids[i], tgt_weights[i], mask[i], reset_flags[i],
                learn_rate, rng=rng)
            rows.append(pack_aux(aux))
        return params, opt_state, states, torch.cat(rows)

    return gstep
