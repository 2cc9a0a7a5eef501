"""Walks over the port's train state: params dicts, optimizer objects and
the tuples that carry them (``(optimizer, ps_weight)`` under push-sum,
``(optimizer, MixState)`` under top-k mixing).

The JAX package's state is a pytree of arrays that ``jax.tree`` maps
over.  The port's optimizer state lives inside a ``torch.optim``
object (``optimizer.state[param]``), which no pytree utility opens, so
the checkpointer and the elastic row hygiene walk the state here: every
leaf under a path of dict keys, sequence indices, NamedTuple field names
and, for an optimizer, ``("state", i, key)`` with ``i`` the param's
index over its param groups.
"""

from __future__ import annotations

from typing import Any, Callable, Iterator, Tuple

import torch

__all__ = ["leaves", "replace_leaves", "tensor_leaves", "optimizer_params"]

Path = Tuple[Any, ...]


def optimizer_params(opt: torch.optim.Optimizer):
    """The optimizer's params in param-group order."""
    return [p for group in opt.param_groups for p in group["params"]]


def leaves(tree, path: Path = (), open_optimizers: bool = True
           ) -> Iterator[Tuple[Path, Any]]:
    """Every leaf of ``tree`` with its path, in a fixed order: dicts in
    insertion order, sequences by index (NamedTuples by field name), an
    optimizer's per-param state by param index and sorted key (or the
    optimizer itself as one leaf, with ``open_optimizers=False``).
    Anything else (tensors, numpy arrays, numbers, None) is a leaf."""
    if isinstance(tree, torch.optim.Optimizer):
        if not open_optimizers:
            yield path, tree
            return
        for i, p in enumerate(optimizer_params(tree)):
            state = tree.state.get(p, {})
            for key in sorted(state):
                yield path + ("state", i, key), state[key]
    elif isinstance(tree, dict):
        for k, v in tree.items():
            yield from leaves(v, path + (k,), open_optimizers)
    elif isinstance(tree, tuple) and hasattr(tree, "_fields"):
        for k, v in zip(tree._fields, tree):
            yield from leaves(v, path + (k,), open_optimizers)
    elif isinstance(tree, (tuple, list)):
        for i, v in enumerate(tree):
            yield from leaves(v, path + (i,), open_optimizers)
    else:
        yield path, tree


def replace_leaves(tree, fn: Callable[[Path, Any], Any], path: Path = ()):
    """``tree`` with each leaf of :func:`leaves` (optimizers unopened)
    replaced by ``fn(path, leaf)``: dicts are updated in place, tuples and
    lists rebuilt."""
    if isinstance(tree, dict):
        for k in list(tree):
            tree[k] = replace_leaves(tree[k], fn, path + (k,))
        return tree
    if isinstance(tree, tuple) and hasattr(tree, "_fields"):
        return type(tree)(*(replace_leaves(v, fn, path + (k,))
                            for k, v in zip(tree._fields, tree)))
    if isinstance(tree, (tuple, list)):
        return type(tree)(replace_leaves(v, fn, path + (i,))
                          for i, v in enumerate(tree))
    return fn(path, tree)


def tensor_leaves(tree) -> Iterator[Tuple[Path, torch.Tensor]]:
    """The tensor leaves of :func:`leaves`."""
    for path, leaf in leaves(tree):
        if isinstance(leaf, torch.Tensor):
            yield path, leaf
