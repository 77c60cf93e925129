"""The ('data', 'model') mesh over torch.distributed ranks, and the
sharding plan of a net on it; PyTorch edition of
``kaldi_lstm_tpu.parallel.mesh``.

In the JAX package a mesh is laid over devices of one program. Here one
rank is one process holding one device:

* ``--mesh data=D,model=M`` needs a world of exactly D x M ranks; rank
  ``d*M + m`` sits at mesh position (d, m), the row-major layout of
  ``np.asarray(devices).reshape(data, model)``;
* the data and model axes are process subgroups (``dist.new_group``):
  the gradient sum runs over the ranks of one model position (the data
  group), the tensor-parallel loss's collectives over the ranks of one
  data position (the model group);
* **data parallelism over streams**: each rank runs its own stream
  scheduler; the M ranks of one data position read the same feature
  shard, so they hold identical batches (they share frames and split
  classes). The global batch is the D data positions' rows concatenated
  in rank order, [S_global = S x D, T];
* **tensor parallelism for the senone output layer**: the last
  AffineTransform (a net ending in [AffineTransform, Softmax]) keeps
  only its rows [K_m lo, K_m hi) of `linearity` and `bias` on model rank
  m, the classes split as evenly as `np.array_split` splits them;
  everything else (LSTM weights, feature transform) is replicated.

`MeshPlan.place_*` take the whole (global) tree or batch and return this
rank's part of it, `gather_params` the whole tree from every rank's
part (a collective: every rank must call it).
"""

from __future__ import annotations

from typing import Any, Optional

import numpy as np
import torch
import torch.distributed as dist

from kaldi_lstm_tpu_torch.models.components import AffineTransform, Softmax
from kaldi_lstm_tpu_torch.models.nnet import Nnet
from kaldi_lstm_tpu_torch.train.optim import MomentumState
from kaldi_lstm_tpu_torch.utils.tree import tree_map


class Mesh:
    """This rank's place on a D x M mesh of the world's ranks, with its
    two process subgroups (None where the axis has one rank) and the
    device its tensors live on."""

    axis_names = ("data", "model")

    def __init__(self, data: int, model: int, rank: int, world: int,
                 device: torch.device,
                 data_group=None, model_group=None):
        self.shape = {"data": data, "model": model}
        self.rank = rank
        self.world = world
        self.device = torch.device(device)
        self.data_index, self.model_index = divmod(rank, model)
        self.data_group = data_group
        self.model_group = model_group


def make_mesh(data: int = 1, model: int = 1, device=None) -> Mesh:
    """The ('data', 'model') mesh of the initialized process group (a
    world of one rank without one). Every rank must call it, in the same
    order, since it creates the subgroups. Raises ValueError unless the
    world has exactly data x model ranks."""
    world = dist.get_world_size() if dist.is_initialized() else 1
    rank = dist.get_rank() if dist.is_initialized() else 0
    if data < 1 or model < 1:
        raise ValueError(f"mesh {data}x{model}: both axes must be >= 1")
    if data * model > world:
        raise ValueError(f"mesh {data}x{model} needs {data * model} "
                         f"devices, have {world}")
    if data * model < world:
        raise ValueError(f"mesh {data}x{model} needs {data * model} "
                         f"devices, the world has {world} ranks")
    device = torch.device("cpu" if device is None else device)
    data_group = model_group = None
    # new_group is collective: every rank creates every group of an
    # axis with more than one rank, in the same order
    if data > 1:
        for m in range(model):
            g = dist.new_group([d * model + m for d in range(data)])
            if rank % model == m:
                data_group = g
    if model > 1:
        for d in range(data):
            g = dist.new_group([d * model + m for m in range(model)])
            if rank // model == d:
                model_group = g
    return Mesh(data, model, rank, world, device, data_group, model_group)


def class_bounds(K: int, model: int) -> np.ndarray:
    """[model + 1] class boundaries of the senone shards: shard m holds
    classes [b[m], b[m + 1]), sizes differing by at most one."""
    if K < model:
        raise ValueError(f"{K} classes cannot be split over a model axis "
                         f"of {model}")
    sizes = [len(a) for a in np.array_split(np.arange(K), model)]
    return np.concatenate([[0], np.cumsum(sizes)]).astype(np.int64)


class MeshPlan:
    """Which parameters shard and how, for `nnet` on `mesh`."""

    def __init__(self, mesh: Mesh, nnet: Nnet):
        self.mesh = mesh
        self.nnet = nnet
        # index of the senone output AffineTransform (the TP target):
        # the affine of an [AffineTransform, Softmax] tail, when the
        # model axis has more than one rank
        self.tp_index: Optional[int] = None
        comps = nnet.components
        if (mesh.shape["model"] > 1
                and len(comps) >= 2
                and isinstance(comps[-2], AffineTransform)
                and isinstance(comps[-1], Softmax)):
            self.tp_index = len(comps) - 2
        self.bounds = (class_bounds(comps[self.tp_index].output_dim,
                                    mesh.shape["model"])
                       if self.tp_index is not None else None)

    @property
    def shard(self) -> tuple[int, int]:
        """[lo, hi) of this rank's senone classes."""
        m = self.mesh.model_index
        return int(self.bounds[m]), int(self.bounds[m + 1])

    # ------------------------------------------------------------------
    def _to(self, t: torch.Tensor) -> torch.Tensor:
        return t.to(self.mesh.device)

    def place_params(self, params: Any) -> Any:
        """This rank's parameters on its device: the TP affine's rows of
        its class shard (a copy), every other leaf whole."""
        out = []
        for i, p in enumerate(params):
            if i == self.tp_index:
                lo, hi = self.shard
                out.append({k: self._to(v[lo:hi]).clone()
                            for k, v in p.items()})
            else:
                out.append(tree_map(self._to, p))
        return tuple(out)

    def place_opt(self, opt_state: MomentumState) -> MomentumState:
        return MomentumState(corr=self.place_params(opt_state.corr))

    def stream_rows(self, S_global: int) -> slice:
        """This rank's rows of a global [S_global, ...] batch."""
        s = S_global // self.mesh.shape["data"]
        d = self.mesh.data_index
        return slice(d * s, (d + 1) * s)

    def place_states(self, states: Any) -> Any:
        """This rank's rows of global carry states (stream axis 0)."""
        def rows(t):
            return self._to(t[self.stream_rows(t.shape[0])]).clone()
        return tuple(None if s is None else tree_map(rows, s)
                     for s in states)

    def place_batch(self, feats, tgt_ids, tgt_weights, mask, reset_flags,
                    group: bool = False) -> tuple[torch.Tensor, ...]:
        """This rank's rows of a global batch (numpy arrays or tensors),
        as tensors on its device. With `group` every array has a leading
        [B] axis and the streams are axis 1."""
        out = []
        for a in (feats, tgt_ids, tgt_weights, mask, reset_flags):
            t = torch.as_tensor(np.ascontiguousarray(a)) \
                if isinstance(a, np.ndarray) else a
            ax = 1 if group else 0
            sl = self.stream_rows(t.shape[ax])
            t = t[:, sl] if group else t[sl]
            out.append(self._to(t.contiguous()))
        return tuple(out)

    def gather_params(self, params: Any) -> Any:
        """The whole parameter tree from this rank's part (every rank
        gets it). A collective over the model group: every rank must call
        it."""
        if self.tp_index is None:
            return params
        out = list(params)
        group = self.mesh.model_group
        K = int(self.bounds[-1])
        width = int(np.max(np.diff(self.bounds)))
        full = {}
        for k, v in params[self.tp_index].items():
            pad = torch.zeros((width,) + tuple(v.shape[1:]), dtype=v.dtype,
                              device=v.device)
            pad[:v.shape[0]] = v
            parts = [torch.empty_like(pad)
                     for _ in range(self.mesh.shape["model"])]
            dist.all_gather(parts, pad, group=group)
            rows = [p[:hi - lo] for p, lo, hi in
                    zip(parts, self.bounds[:-1], self.bounds[1:])]
            full[k] = torch.cat(rows)[:K]
        out[self.tp_index] = full
        return tuple(out)
