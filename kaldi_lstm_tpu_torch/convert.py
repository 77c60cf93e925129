"""Carry weights across between the JAX package and this one.

``params_from_numpy(nnet, params_np, device)`` takes the JAX package's
per-component parameters as numpy arrays, i.e.
``jax.tree_util.tree_map(np.asarray, params)``: LSTM layers are
NamedTuples whose fields are read by attribute name, parameterised
layers are dicts read by key, the rest are empty. It needs no import of
the JAX package. ``params_to_numpy`` is its inverse: it returns this
package's structure (``LstmParams`` of numpy arrays, dicts of numpy
arrays), which the JAX side rebuilds with ``LstmParams(**p._asdict())``.
``momentum_from_numpy`` / ``momentum_to_numpy`` do the same for the
optimizer's momentum buffer (``MomentumState.corr``, a tree shaped like
the params), so both packages can start from one state.
"""

from __future__ import annotations

import numpy as np
import torch

from kaldi_lstm_tpu_torch.models.components import _LstmBase
from kaldi_lstm_tpu_torch.ops.lstm_cell import LstmParams
from kaldi_lstm_tpu_torch.train.optim import MomentumState


def _t(a, device) -> torch.Tensor:
    return torch.tensor(np.asarray(a, np.float32), device=device)


def params_from_numpy(nnet, params_np, device=None) -> tuple:
    if len(params_np) != len(nnet.components):
        raise ValueError(f"params_from_numpy: {len(params_np)} entries for "
                         f"{len(nnet.components)} components")
    out = []
    for c, p in zip(nnet.components, params_np):
        if isinstance(c, _LstmBase):
            out.append(LstmParams(**{f: _t(getattr(p, f), device)
                                     for f in LstmParams._fields}))
        else:
            out.append({k: _t(v, device) for k, v in dict(p).items()})
    return tuple(out)


def params_to_numpy(params) -> tuple:
    out = []
    for p in params:
        if isinstance(p, LstmParams):
            out.append(LstmParams(*(t.detach().cpu().numpy() for t in p)))
        else:
            out.append({k: v.detach().cpu().numpy() for k, v in p.items()})
    return tuple(out)


def momentum_from_numpy(nnet, corr_np, device=None) -> MomentumState:
    """The JAX package's ``MomentumState.corr`` as numpy arrays (same
    structure as its params) -> this package's MomentumState."""
    return MomentumState(corr=params_from_numpy(nnet, corr_np, device))


def momentum_to_numpy(opt_state: MomentumState) -> tuple:
    return params_to_numpy(opt_state.corr)
