"""Nested dicts/lists/tuples of tensors — the port's stand-in for JAX
pytrees of parameters."""

import typing

import torch


def tree_map(fn: typing.Callable[[torch.Tensor], typing.Any], tree):
    """Apply ``fn`` to every tensor leaf; containers keep their type and
    ``None`` stays ``None``."""
    if isinstance(tree, torch.Tensor):
        return fn(tree)
    if isinstance(tree, dict):
        return {k: tree_map(fn, v) for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        return type(tree)(tree_map(fn, v) for v in tree)
    return tree


def tree_index(tree, i: int):
    """Entry ``i`` of every stacked leaf (a layer or block of stacked
    params); views, no copies."""
    return tree_map(lambda a: a[i], tree)
