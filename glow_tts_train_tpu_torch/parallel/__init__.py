"""Data parallelism over processes, one a GPU, and tensor parallelism
over model groups of them (``parallel/mesh.py``, ``parallel/partitioning.py``)."""

from .mesh import (
    Launch,
    all_gather_shards,
    all_reduce_sum,
    check_model_parallel,
    first_row,
    is_chief,
    join,
    launch_from,
    leave,
    model_groups,
    model_parallel,
    model_rank,
    rank,
    world,
)

__all__ = [
    "Launch", "all_gather_shards", "all_reduce_sum", "check_model_parallel", "first_row",
    "is_chief", "join", "launch_from", "leave", "model_groups", "model_parallel", "model_rank",
    "rank", "world",
]
