"""Parameter trees: tuples (NamedTuples among them), lists and dicts of
tensors, with JAX's flattening order, so that leaf i here is leaf i of
``jax.tree_util.tree_leaves`` on the JAX package's parameters (dicts in
sorted key order, tuples in field order, None and {} without leaves).
The checkpoint layout and the per-leaf optimizer settings rest on it."""

from __future__ import annotations

from typing import Any, Callable, Iterator

import torch


def tree_leaves(tree: Any) -> list:
    if tree is None:
        return []
    if isinstance(tree, dict):
        return [leaf for k in sorted(tree) for leaf in tree_leaves(tree[k])]
    if isinstance(tree, (tuple, list)):
        return [leaf for t in tree for leaf in tree_leaves(t)]
    return [tree]


def params_device(params: Any) -> torch.device:
    """The device of a parameter tree's first tensor (the CPU for a tree
    without tensors)."""
    leaves = tree_leaves(params)
    return leaves[0].device if leaves else torch.device("cpu")


def tree_map(fn: Callable, tree: Any, *rest: Any) -> Any:
    """fn applied leaf by leaf over `tree` and trees of the same shape."""
    if tree is None:
        return None
    if isinstance(tree, dict):
        return {k: tree_map(fn, tree[k], *(r[k] for r in rest))
                for k in tree}
    if isinstance(tree, (tuple, list)):
        mapped = [tree_map(fn, t, *(r[i] for r in rest))
                  for i, t in enumerate(tree)]
        if hasattr(tree, "_fields"):  # NamedTuple
            return type(tree)(*mapped)
        return type(tree)(mapped)
    return fn(tree, *rest)


def tree_unflatten(example: Any, leaves: list) -> Any:
    """A tree shaped like `example` whose leaves, in `tree_leaves`
    order, are `leaves`."""
    it = iter(leaves)
    out = _unflatten(example, it)
    if next(it, None) is not None:
        raise ValueError("tree_unflatten: more leaves than the tree has")
    return out


def _unflatten(example: Any, it: Iterator) -> Any:
    if example is None:
        return None
    if isinstance(example, dict):
        vals = {k: _unflatten(example[k], it) for k in sorted(example)}
        return {k: vals[k] for k in example}
    if isinstance(example, (tuple, list)):
        mapped = [_unflatten(t, it) for t in example]
        if hasattr(example, "_fields"):
            return type(example)(*mapped)
        return type(example)(mapped)
    try:
        return next(it)
    except StopIteration:
        raise ValueError("tree_unflatten: fewer leaves than the tree "
                         "has") from None
