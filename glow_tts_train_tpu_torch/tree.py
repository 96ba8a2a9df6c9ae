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


def flatten(tree, prefix: str = "") -> typing.Dict[str, typing.Any]:
    """Nested dicts -> {"a/b/c": leaf} (the JAX param-path names)."""
    out = {}
    for k, v in tree.items():
        if isinstance(v, dict):
            out.update(flatten(v, f"{prefix}{k}/"))
        else:
            out[prefix + k] = v
    return out


def unflatten(flat: typing.Mapping[str, typing.Any]) -> dict:
    """{"a/b/c": leaf} -> nested dicts."""
    out: dict = {}
    for path, leaf in flat.items():
        *parents, name = path.split("/")
        node = out
        for k in parents:
            node = node.setdefault(k, {})
        node[name] = leaf
    return out
