"""Data and tensor parallelism over processes, one a GPU: the counterpart
of the JAX package's ``parallel/mesh.py``.

The JAX package builds a 1-D mesh over every device it sees, shards the
global batch along it and lets XLA insert the gradient all-reduce.  The
port runs one process a GPU (``python -m torch.distributed.run``, or the
JAX CLI's ``--coordinator``, ``--num-processes`` and ``--process-id``),
each with its own rows of the global batch, and reduces explicitly
(``training.py``): DDI's masked sums once a flow block, the step's loss
denominators before the backward, every gradient in one summed
all-reduce before the norm and Adam, and the metrics' numerators.  The
global batch is the ranks' local batches concatenated in rank order, as
JAX's global array is (``jax.make_array_from_process_local_data``).

The backend is NCCL on GPUs and gloo on the CPU; gloo also takes CUDA
tensors, which lets two ranks share one card where that is asked for
(NCCL refuses it, and :func:`join` refuses it first).  The process group
gets an explicit timeout, so that a rank that dies fails the run instead
of hanging it.  A world of one joins no process group: :func:`world` is 1
and :func:`all_reduce_sum` the identity, the single-device path.  The
mesh and sharding names of the JAX module (``default_mesh``,
``batch_sharding``, ``replicated``, ``shard_batch``) have no meaning for
a process group and have no counterpart here.

``model_parallel`` M > 1 (``default_mesh(model_parallel=M)``) lays the W
ranks out as JAX reshapes its devices, a (W / M, M) grid with the model
axis innermost: rank r = d * M + m sits in row d, and the M ranks of a
row form its model group (:func:`join` makes every group, on every rank,
in one order).  A rank keeps its slice of the sharded weights and of
their Adam moments (``partitioning.py``, ``training.TrainState``) and
:func:`all_gather_shards` makes them whole again over the group.  The
batch still splits over all W ranks and the gradients still sum over
all W.
"""

import dataclasses
import datetime
import os
import typing

import torch
import torch.distributed as dist

# how long a collective waits for a rank before the run fails
TIMEOUT = datetime.timedelta(minutes=10)

# this rank's model group and its size (model_parallel), set by join
_MODEL: typing.Dict[str, typing.Any] = {"size": 1, "group": None}


@dataclasses.dataclass(frozen=True)
class Launch:
    """Where this process stands: its rank, the world size, its index
    among the ranks of its host (which GPU it takes), and the rendezvous
    (``env://`` under torchrun, ``tcp://host:port`` from a coordinator;
    None for a world of one)."""

    rank: int = 0
    world: int = 1
    local_rank: int = 0
    init_method: typing.Optional[str] = None


def launch_from(
    coordinator: typing.Optional[str] = None,
    num_processes: typing.Optional[int] = None,
    process_id: typing.Optional[int] = None,
) -> Launch:
    """The launch of this process, read without joining anything: from
    ``coordinator`` (host:port), ``num_processes`` and ``process_id`` when
    a coordinator is given (the local rank from ``LOCAL_RANK``, else the
    process id), else from torchrun's ``RANK``, ``WORLD_SIZE`` and
    ``LOCAL_RANK``, else a world of one.  ``ValueError`` for an
    incomplete or inconsistent set."""
    environ = os.environ
    if coordinator:
        if num_processes is None or process_id is None:
            raise ValueError("--coordinator needs --num-processes and --process-id")
        if not 0 <= process_id < num_processes:
            raise ValueError(
                f"--process-id {process_id} is not in [0, --num-processes {num_processes})"
            )
        local_rank = int(environ.get("LOCAL_RANK", process_id))
        return Launch(process_id, num_processes, local_rank, f"tcp://{coordinator}")
    if num_processes is not None or process_id is not None:
        raise ValueError("--num-processes and --process-id need --coordinator")
    world_size = int(environ.get("WORLD_SIZE", 1))
    if world_size <= 1:
        return Launch()
    if "RANK" not in environ:
        raise ValueError(f"WORLD_SIZE is {world_size} but RANK is not set")
    rank_ = int(environ["RANK"])
    return Launch(rank_, world_size, int(environ.get("LOCAL_RANK", rank_)), "env://")


def check_model_parallel(world_size: int, model_parallel: int) -> None:
    """``ValueError`` where ``model_parallel`` is below 1 or does not
    divide ``world_size`` (the JAX mesh's assert)."""
    if model_parallel < 1:
        raise ValueError(f"model_parallel={model_parallel} is below 1")
    if world_size % model_parallel:
        raise ValueError(
            f"{world_size} devices do not split into model_parallel={model_parallel}"
        )


def model_groups(world_size: int, model_parallel: int) -> typing.List[typing.List[int]]:
    """The model groups of a (world / M, M) grid: row d holds ranks d * M
    to d * M + M - 1 (the model axis innermost, as JAX's reshape)."""
    check_model_parallel(world_size, model_parallel)
    return [list(range(d * model_parallel, (d + 1) * model_parallel))
            for d in range(world_size // model_parallel)]


def join(
    launch: Launch,
    platform: str,
    backend: typing.Optional[str] = None,
    timeout: datetime.timedelta = TIMEOUT,
    model_parallel: int = 1,
) -> torch.device:
    """Take this rank's device and join the process group -> the device.

    ``platform`` "cuda": GPU ``local_rank`` modulo the visible count,
    made the current device before anything else touches the card; "cpu":
    the host.  With more than one rank the group is joined with
    ``backend`` (default NCCL for "cuda", gloo for "cpu").  Under NCCL the
    ranks compare their cards (over a gloo side group, before NCCL's first
    collective) and a card that two ranks would share raises
    ``ValueError`` on every rank, after leaving the group.
    ``model_parallel`` M > 1 then makes the model groups
    (:func:`model_groups`); an M that does not divide the world raises
    ``ValueError`` before anything is joined."""
    check_model_parallel(launch.world, model_parallel)
    if platform == "cuda":
        count = torch.cuda.device_count()
        if count == 0:
            raise ValueError("--platform cuda: no CUDA device is available")
        device = torch.device("cuda", launch.local_rank % count)
        torch.cuda.set_device(device)
    else:
        device = torch.device("cpu")
    if launch.world <= 1:
        return device
    backend = backend or ("nccl" if platform == "cuda" else "gloo")
    dist.init_process_group(
        backend, init_method=launch.init_method, rank=launch.rank,
        world_size=launch.world, timeout=timeout,
    )
    if backend == "nccl":
        _refuse_shared_cards(device)
    if model_parallel > 1:
        for ranks in model_groups(launch.world, model_parallel):
            group = dist.new_group(ranks)
            if launch.rank in ranks:
                _MODEL.update(size=model_parallel, group=group)
    return device


def _refuse_shared_cards(device: torch.device) -> None:
    card = str(torch.cuda.get_device_properties(device).uuid)
    side = dist.new_group(backend="gloo")
    cards: typing.List[typing.Any] = [None] * world()
    dist.all_gather_object(cards, card, group=side)
    dist.destroy_process_group(side)
    if len(set(cards)) < len(cards):
        shared = sorted({c for c in cards if cards.count(c) > 1})
        ranks = [r for r, c in enumerate(cards) if c in shared]
        leave()
        raise ValueError(
            f"ranks {ranks} would share a card under NCCL ({len(cards)} ranks on "
            f"{len(set(cards))} cards): start one rank a GPU (--nproc-per-node at most "
            "the visible device count)"
        )


def leave() -> None:
    """Leave the process group, if this process joined one."""
    _MODEL.update(size=1, group=None)
    if dist.is_available() and dist.is_initialized():
        dist.destroy_process_group()


def world() -> int:
    """Ranks in the process group; 1 without one."""
    if dist.is_available() and dist.is_initialized():
        return dist.get_world_size()
    return 1


def rank() -> int:
    """This process's rank; 0 without a process group."""
    if dist.is_available() and dist.is_initialized():
        return dist.get_rank()
    return 0


def is_chief() -> bool:
    """Rank 0: the one that writes checkpoints, metrics and traces."""
    return rank() == 0


def first_row(local_batch: int) -> int:
    """This rank's first row in the global batch (rank x local batch)."""
    return rank() * int(local_batch)


def all_reduce_sum(tensors: typing.Sequence[torch.Tensor]) -> typing.List[torch.Tensor]:
    """The sums over ranks of ``tensors`` (one dtype, one device), in one
    all-reduce through a single flat buffer; the tensors themselves as
    they are in a world of one.  Every rank gets the same bits."""
    tensors = list(tensors)
    if world() == 1 or not tensors:
        return tensors
    flat = torch.cat([t.reshape(-1) for t in tensors])
    dist.all_reduce(flat)
    parts = torch.split(flat, [t.numel() for t in tensors])
    return [p.view(t.shape) for p, t in zip(parts, tensors)]


def model_parallel() -> int:
    """M, the ranks of a model group; 1 without one."""
    return _MODEL["size"]


def model_rank() -> int:
    """This rank's place in its model group (rank modulo M): which slice
    of each sharded leaf it keeps."""
    return rank() % model_parallel()


def all_gather_shards(
    slices: typing.Sequence[torch.Tensor], wholes: typing.Sequence[torch.Tensor]
) -> None:
    """Fill ``wholes`` (f32, one device) from the model group's slices of
    them, in one collective through a single flat buffer: rank m of the
    group holds ``slices[i]``, columns m * c to (m + 1) * c of the last
    dimension of ``wholes[i]`` (c = its last dimension over M).  Every
    rank of the group gets the same bits; a failed collective raises.
    The collective is ``all_gather_into_tensor`` under NCCL and under
    gloo, on the host and on CUDA tensors alike (two ranks sharing one
    card: gloo copies through the host).  Called only in a model group
    (M > 1) and with at least one slice."""
    slices, wholes = list(slices), list(wholes)
    size = model_parallel()
    assert size > 1 and slices, "all_gather_shards needs a model group and a slice"
    flat = torch.cat([s.reshape(-1) for s in slices])
    n = flat.numel()
    out = torch.empty(size * n, dtype=flat.dtype, device=flat.device)
    dist.all_gather_into_tensor(out, flat, group=_MODEL["group"])
    out = out.view(size, n)
    offset = 0
    for s, w in zip(slices, wholes):
        count = s.numel()
        part = out[:, offset:offset + count].reshape(size, *s.shape)
        w.copy_(torch.movedim(part, 0, -2).reshape(w.shape))
        offset += count
