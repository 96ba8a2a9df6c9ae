"""Tensor-parallel partitioning of the weights and Adam moments: the
counterpart of the JAX package's ``parallel/partitioning.py``
(``param_partition_specs``, ``shardable``, ``opt_state_partition_specs``),
on the port's flat ``"a/b/c"`` keys.

The rule is JAX's, key for key (the port keeps JAX's channels-last
layouts): ``gamma``, ``beta`` and every leaf under ``actnorm`` or
``invconv`` stay replicated, and so does a leaf whose last dimension is 1;
every other leaf shards its last dimension over the ``model`` axis.
Where M does not divide that dimension the leaf is downgraded to
replicated.  Adam's moments follow their leaf's plan; the count and the
step stay replicated.

A spec is a tuple of axis names a dimension, as a ``PartitionSpec``
spells it: ``()`` replicated, ``(None, ..., "model")`` the last dimension
sharded.  The kernels still take whole weights: a rank updates its slice
and the model group gathers the whole (``mesh.all_gather_shards``).
"""

import typing

import torch

MODEL_AXIS = "model"

Spec = typing.Tuple[typing.Optional[str], ...]
Shapes = typing.Mapping[str, typing.Sequence[int]]


def param_partition_specs(shapes: Shapes, model_axis: str = MODEL_AXIS) -> typing.Dict[str, Spec]:
    """{key: spec} for the param shapes ({"a/b/c": shape}): the last
    dimension sharded over ``model_axis`` but for norms, ActNorm, the
    invertible 1x1 conv and leaves whose last dimension is 1."""
    specs = {}
    for key, shape in shapes.items():
        names = key.split("/")
        if names[-1] in ("gamma", "beta") or "actnorm" in names or "invconv" in names:
            specs[key] = ()
        elif len(shape) >= 1 and shape[-1] > 1:
            specs[key] = (None,) * (len(shape) - 1) + (model_axis,)
        else:
            specs[key] = ()
    return specs


def shardable(
    shapes: Shapes, specs: typing.Mapping[str, Spec], axis_sizes: typing.Mapping[str, int]
) -> typing.Dict[str, Spec]:
    """Downgrade to replicated each spec whose sharded dimension the axis
    size (``{"model": M}``) does not divide."""
    out = {}
    for key, spec in specs.items():
        fits = all(name is None or shapes[key][dim] % axis_sizes[name] == 0
                   for dim, name in enumerate(spec))
        out[key] = spec if fits else ()
    return out


def opt_state_partition_specs(param_specs: typing.Mapping[str, Spec]) -> typing.Dict[str, Spec]:
    """Specs of the Adam state (``mu/<key>``, ``nu/<key>``, ``count``):
    the moments as their leaves, the count replicated."""
    out: typing.Dict[str, Spec] = {"count": ()}
    for moment in ("mu", "nu"):
        out.update({f"{moment}/{key}": spec for key, spec in param_specs.items()})
    return out


def sharded_keys(shapes: Shapes, model_parallel: int) -> typing.List[str]:
    """The keys whose last dimension shards over M ranks, in the order of
    ``shapes`` (none for M = 1)."""
    if model_parallel <= 1:
        return []
    specs = shardable(shapes, param_partition_specs(shapes), {MODEL_AXIS: model_parallel})
    return [key for key, spec in specs.items() if spec]


def take_slice(whole: torch.Tensor, model_parallel: int, model_rank: int) -> torch.Tensor:
    """Slice ``model_rank`` of M along the last dimension, as a contiguous
    copy."""
    width = whole.shape[-1] // model_parallel
    return whole[..., model_rank * width:(model_rank + 1) * width].contiguous()
