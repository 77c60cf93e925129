"""Native checkpoints with the optimizer state, in the JAX package's
``.npz`` layout, so that a ``--state-out`` of either package resumes in
the other: leaves ``p{i}`` (params) and ``o{i}`` (momentum corr) in JAX
tree-flatten order (utils/tree.py: dicts by sorted key, so an
AffineTransform's leaves are bias then linearity), and ``__meta__``, a
JSON document as uint8 bytes with ``meta``, ``num_params`` and
``has_opt``.
"""

from __future__ import annotations

import json
from typing import Any, Optional

import numpy as np
import torch

from kaldi_lstm_tpu_torch.train.optim import MomentumState
from kaldi_lstm_tpu_torch.utils.tree import tree_leaves, tree_unflatten


def _host(leaves: list) -> list:
    """All leaves on the host with one device-to-host copy."""
    if not leaves:
        return []
    flat = torch.cat([t.detach().reshape(-1).to(torch.float32)
                      for t in leaves]).cpu().numpy()
    out, off = [], 0
    for t in leaves:
        n = t.numel()
        out.append(flat[off:off + n].reshape(tuple(t.shape)))
        off += n
    return out


def save_train_state(path: str, params: Any,
                     opt_state: Optional[MomentumState] = None,
                     meta: Optional[dict] = None) -> None:
    leaves_p = tree_leaves(params)
    leaves_o = tree_leaves(opt_state.corr) if opt_state is not None else []
    host = _host(leaves_p + leaves_o)
    payload = {f"p{i}": x for i, x in enumerate(host[:len(leaves_p)])}
    payload.update({f"o{i}": x
                    for i, x in enumerate(host[len(leaves_p):])})
    payload["__meta__"] = np.frombuffer(
        json.dumps({"meta": meta or {},
                    "num_params": len(leaves_p),
                    "has_opt": opt_state is not None}).encode(), np.uint8)
    # a file object: np.savez(path) would append .npz to a bare path
    with open(path, "wb") as f:
        np.savez(f, **payload)


def load_train_state(path: str, params_example: Any, device=None
                     ) -> tuple[Any, Optional[MomentumState], dict]:
    """Restore (params, opt_state, meta); `params_example` gives the tree
    structure (and, when `device` is None, the device)."""
    if device is None:
        leaves = tree_leaves(params_example)
        device = leaves[0].device if leaves else None
    with np.load(path) as z:
        info = json.loads(bytes(z["__meta__"].tobytes()).decode())
        n = info["num_params"]
        if n != len(tree_leaves(params_example)):
            raise ValueError(f"load_train_state: {path} holds {n} "
                             f"parameter tensors, the model has "
                             f"{len(tree_leaves(params_example))}")

        def load(prefix):
            return tree_unflatten(params_example, [
                torch.tensor(np.asarray(z[f"{prefix}{i}"], np.float32),
                             device=device) for i in range(n)])

        params = load("p")
        opt_state = MomentumState(corr=load("o")) if info["has_opt"] \
            else None
    return params, opt_state, info["meta"]
