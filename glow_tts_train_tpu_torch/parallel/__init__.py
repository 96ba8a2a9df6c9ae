"""Data parallelism over processes, one a GPU (``parallel/mesh.py``)."""

from .mesh import (
    Launch,
    all_reduce_sum,
    first_row,
    is_chief,
    join,
    launch_from,
    leave,
    rank,
    world,
)

__all__ = [
    "Launch", "all_reduce_sum", "first_row", "is_chief", "join", "launch_from", "leave",
    "rank", "world",
]
