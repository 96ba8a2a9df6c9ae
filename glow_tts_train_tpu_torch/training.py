"""Training: fresh init with data-dependent ActNorm init, the train step,
and the epoch loop (glow_tts_train_tpu training.py).

One step: the training graph (``models.forward_train``), the MLE and
duration losses, backward, the global gradient norm, then value clip and
Noam-scheduled Adam (``optimize.py``).  With ``grad_accum_steps`` n > 1 the
batch's rows go through in n slices, each slice's loss numerators over the
whole batch's denominators and the gradients summed, so the step equals
the full-batch step to round-off.  Over W ranks (``parallel``: one
process a GPU) a step is the step of the global batch, the ranks' local
batches in rank order: the same rule, each rank's slices over the global
denominators, the gradients and the metrics' numerators summed over the
ranks in one all-reduce before the norm and Adam, so every rank applies
the same update; dropout draws each row's masks as one process draws
them for that row of the global batch (``attention.RowsGenerator``), in
an accumulated step too.  On CUDA tensors the flow blocks, MAS and
(``encoder_fuse`` true, what "auto" resolves to for the shipped encoder
configuration) the text side run the hand-written kernels, forward and
backward, once a slice; ``encoder_fuse: false`` runs the text side op by
op.  Under tensor parallelism (``--model-parallel`` M, a model group of M
ranks: ``parallel``) the step is the same, the gradients reduced over all
W ranks and the norm taken on them whole; then each rank runs Adam on its
slices of the sharded leaves (:class:`TrainState`) and the model group
gathers the whole weights, so a step gives the bits of the W-rank
data-parallel step.  The decoder runs in the mode the config picks
(``models.hyper_from_config``): ``flow_block_fuse`` (each block one kernel
pair, the default) or op by op around the WN stack's kernels, with
``wn_residuals`` "store" (the default) or "recompute" (a block's residuals
live only inside its backward).  ``fp16_run`` computes in bf16 as the
JAX package does (bf16 activations and product operands, f32 params,
gradients, Adam state, logdet, logp/MAS and losses) in each of the
decoder's four modes, the text side through its kernels or, with
``encoder_fuse: false`` or an encoder configuration the encoder kernel
does not take, op by op as XLA rounds it.  Checkpoints
carry the Adam state (``checkpoint.save_checkpoint``), and ``profile_dir``
writes a ``torch.profiler`` trace of steps 5-15; rank 0 alone writes
them and the metrics.
"""

import json
import logging
import math
import time
import typing
from pathlib import Path

import numpy as np
import torch

from . import parallel
from .checkpoint import param_shapes, save_checkpoint
from .models.glow_tts import (
    GlowTTS,
    ddi_init,
    forward_train,
    hyper_from_config,
    init_model,
)
from .models.losses import duration_loss, mle_loss
from .ops.attention import rows_of
from .optimize import AdamState, adam_init, adam_update, learning_rate_fn
from .parallel import partitioning
from .tree import unflatten

_LOGGER = logging.getLogger("glow_tts_train_tpu_torch")
# steps between DEBUG loss lines
_LOG_EVERY = 10


class TrainState:
    """Trainable model, Adam moments and the 1-indexed global step.

    ``model_parallel`` M > 1 (default ``parallel.model_parallel()``, the
    M the process joined with; 1 trains data parallel in any group): the
    model keeps the whole weights, which the kernels read; ``sharded``
    names the leaves whose last dimension shards over the model group
    (``partitioning.sharded_keys``), ``master`` holds this rank's
    contiguous slice of each of them and the model's own tensor of every
    other leaf, and ``opt`` the moments of ``master``.  Adam updates
    ``master`` and :meth:`gather` makes the weights whole again; a state
    is made from whole weights, so take whole moments with
    :meth:`take_opt` and give them with :meth:`whole_opt`.

    Under M > 1 a sharded weight lives twice, in ``master`` and in the
    model, and ``master`` is the one that counts: a write to the model's
    tensor of a sharded leaf after the state is made (a merge, a weight
    load) is undone by the next :meth:`gather`.  So write weights first
    and make the state after, as the train CLI does; DDI may run at any
    time, since ActNorm's leaves are replicated (``master`` holds the
    model's own tensors of those)."""

    def __init__(self, model: GlowTTS, step: int = 1, model_parallel: typing.Optional[int] = None):
        size = parallel.model_parallel() if model_parallel is None else int(model_parallel)
        if size not in (1, parallel.model_parallel()):
            raise ValueError(f"model_parallel {size}: this process joined model groups of "
                             f"{parallel.model_parallel()}")
        self.model = model
        self.step = step
        self.model_parallel = size
        params = model.flat()
        self.sharded = partitioning.sharded_keys({k: p.shape for k, p in params.items()}, size)
        self.master = self.shard(params, detach=True)
        self.opt: AdamState = adam_init(self.master)

    def shard(self, whole: typing.Mapping[str, torch.Tensor], detach: bool = False) -> dict:
        """This rank's slices of ``whole`` ({key: tensor} over every leaf)
        where the leaf is sharded (contiguous copies), the tensor itself
        elsewhere."""
        sharded, rank_ = set(self.sharded), parallel.model_rank()
        return {k: partitioning.take_slice(v.detach() if detach else v, self.model_parallel, rank_)
                if k in sharded else v for k, v in whole.items()}

    @torch.no_grad()
    def gather(self) -> None:
        """The model's whole weights from the model group's master slices."""
        params = self.model.flat()
        parallel.all_gather_shards([self.master[k] for k in self.sharded],
                                   [params[k].detach() for k in self.sharded])

    def take_opt(self, opt: AdamState) -> None:
        """Adopt Adam state of whole moments (a checkpoint's): this rank
        keeps its slices."""
        self.opt = AdamState(self.shard(opt.mu), self.shard(opt.nu), opt.count)

    @torch.no_grad()
    def whole_opt(self) -> AdamState:
        """The Adam state with whole moments; under M > 1 a collective over
        the model group, which every rank of it must call."""
        if not self.sharded:
            return self.opt
        whole = []
        for moments in (self.opt.mu, self.opt.nu):
            out = dict(moments)
            for k in self.sharded:
                shape = (*moments[k].shape[:-1], moments[k].shape[-1] * self.model_parallel)
                out[k] = moments[k].new_empty(shape)
            parallel.all_gather_shards([moments[k] for k in self.sharded],
                                       [out[k] for k in self.sharded])
            whole.append(out)
        return AdamState(whole[0], whole[1], self.opt.count)


def trainable_model(flat: typing.Mapping[str, torch.Tensor], hp, device) -> GlowTTS:
    """A :class:`GlowTTS` with trainable parameters holding ``flat``
    ({"a/b/c": tensor}) on ``device``."""
    shapes = {k[len("model/"):]: v for k, v in param_shapes(hp).items()}
    model = GlowTTS(shapes, requires_grad=True)
    params = model.flat()
    with torch.no_grad():
        for key, value in flat.items():
            params[key].copy_(torch.as_tensor(value))
    return model.to(device)


def batch_to(batch: typing.Mapping[str, np.ndarray], device) -> dict:
    """Host batch (numpy, from the package's ``data`` pipeline) -> tensors on
    ``device``: ids and lengths int64, mels f32.  A CUDA copy is made with
    ``device`` current, so that a prefetch thread of rank r touches card r
    only."""
    out = {}
    for k, v in batch.items():
        t = torch.from_numpy(np.asarray(v))
        t = t.to(torch.float32) if t.is_floating_point() else t.to(torch.int64)
        if torch.device(device).type == "cuda":
            with torch.cuda.device(device):
                out[k] = t.pin_memory().to(device, non_blocking=True)
        else:
            out[k] = t.to(device)
    return out


def initialize_model(config, batch: dict, device) -> GlowTTS:
    """Fresh init from ``config.seed`` + data-dependent ActNorm init on one
    batch (``batch_to`` tensors; :func:`actnorm_init`)."""
    hp = hyper_from_config(config)
    generator = torch.Generator().manual_seed(config.seed)
    return actnorm_init(trainable_model(init_model(hp, generator), hp, device), config, batch)


def actnorm_init(model: GlowTTS, config, batch: dict) -> GlowTTS:
    """Data-dependent ActNorm init of ``model`` in place (DDI) on one
    batch; over W ranks ``batch`` is this rank's rows of one global batch,
    whose statistics DDI takes (each block's masked sums summed over the
    ranks)."""
    hp = hyper_from_config(config)
    g_ids = batch.get("speaker_ids") if config.model.n_speakers > 1 else None
    reduce = None if parallel.world() == 1 else (lambda t: parallel.all_reduce_sum([t])[0])
    actnorm = ddi_init(model.tree(), hp, batch["y"], batch["y_lengths"], g_ids, reduce)
    params = model.flat()
    with torch.no_grad():
        for name, value in actnorm.items():
            params[f"decoder/blocks/actnorm/{name}"].copy_(value)
    return model


def check_trainable(config) -> None:
    """Refuse a decoder-mode key (``wn_impl``, ``wn_residuals``,
    ``flow_block_fuse``, ``flow_block_fuse_reverse``) whose value this
    trainer cannot honour, and a ``checkpoint_format`` other than "npz"
    (``ValueError``)."""
    hyper_from_config(config)
    if config.checkpoint_format != "npz":
        raise ValueError(
            f"checkpoint_format {config.checkpoint_format!r}: this trainer writes .npz "
            "checkpoints only; set checkpoint_format to \"npz\""
        )


def make_train_step(config):
    """-> ``step_fn(state, batch, generator, seed_generator) -> metrics``:
    one optimizer step on ``state`` in place; metrics are 0-d tensors
    (loss, mle_loss, duration_loss, grad_norm).  Dropout is on when the
    generators are given (``models.forward_train``).

    ``grad_accum_steps`` n > 1 (the JAX package's exact accumulation): the
    batch, whose size n must divide, goes through in n row slices; slice
    i's numerators (the MLE loss less its 1/2 log 2 pi times its masked
    element count, the duration loss times its phoneme count) go over the
    whole batch's denominators, the gradients are summed, and the metrics
    are rebuilt from the summed numerators.  Over W > 1 ranks
    (``parallel.world()``) ``batch`` is this rank's rows of the global
    batch and the same rule spans the ranks: the denominators are summed
    over them before the backward, the gradients and the numerators after
    the slices, in one all-reduce each.  Each slice draws its dropout
    masks from a copy of the generators' state at the step's start, as the
    rows it holds of the global batch (``attention.rows_of``), so the
    masks do not depend on n or W."""
    check_trainable(config)
    hp = hyper_from_config(config)
    multispeaker = config.model.n_speakers > 1
    accum = max(1, int(getattr(config, "grad_accum_steps", 1) or 1))
    n_sqz, n_mel = config.model.n_sqz, config.audio.mel_channels
    half_log_2pi = 0.5 * math.log(2.0 * math.pi)
    # the JAX package's compute dtype (training.py: bf16 under fp16_run);
    # params, gradients, Adam state, logdet, logp/MAS and the losses stay f32
    compute_dtype = torch.bfloat16 if config.fp16_run else torch.float32

    def losses(params, batch, generator, seed_generator):
        g_ids = batch.get("speaker_ids") if multispeaker else None
        (z, z_m, z_logs, logdet, z_mask), _, (_, logw, logw_) = forward_train(
            unflatten(params), hp, batch["x"], batch["x_lengths"], batch["y"],
            batch["y_lengths"], g_ids=g_ids, generator=generator,
            seed_generator=seed_generator, compute_dtype=compute_dtype,
        )
        return mle_loss(z, z_m, z_logs, logdet, z_mask), duration_loss(logw, logw_, batch["x_lengths"])

    def den_mle(y_lengths):  # masked elements after the squeeze
        return torch.sum(((y_lengths // n_sqz) * n_sqz).to(torch.float32)) * n_mel

    def den_dur(x_lengths):
        return torch.sum(x_lengths.to(torch.float32))

    def step_fn(state: TrainState, batch: dict, generator=None, seed_generator=None) -> dict:
        params = state.model.flat()
        leaves = list(params.values())
        ranks = parallel.world()
        if accum == 1 and ranks == 1:
            l_mle, l_dur = losses(params, batch, generator, seed_generator)
            loss = l_mle + l_dur
            grads = list(torch.autograd.grad(loss, leaves, allow_unused=True))
        else:
            b = batch["x"].shape[0]
            if b % accum:
                raise ValueError(f"batch_size {b} must divide by grad_accum_steps {accum}")
            mb = b // accum
            rows, first = ranks * b, parallel.first_row(b)
            d_mle, d_dur = parallel.all_reduce_sum([torch.stack([
                den_mle(batch["y_lengths"]), den_dur(batch["x_lengths"])
            ])])[0]
            grads = [None] * len(leaves)
            num_mle = num_dur = 0.0
            for i in range(accum):
                micro = {k: v[i * mb:(i + 1) * mb] for k, v in batch.items()}
                m_mle, m_dur = losses(
                    params, micro, rows_of(generator, first + i * mb, rows),
                    rows_of(seed_generator, first + i * mb, rows),
                )
                n_mle = (m_mle - half_log_2pi) * den_mle(micro["y_lengths"])
                n_dur = m_dur * den_dur(micro["x_lengths"])
                micro_grads = torch.autograd.grad(
                    n_mle / d_mle + n_dur / d_dur, leaves, allow_unused=True
                )
                grads = [g if acc is None else acc if g is None else acc + g
                         for acc, g in zip(grads, micro_grads)]
                num_mle, num_dur = num_mle + n_mle.detach(), num_dur + n_dur.detach()
            if ranks > 1:  # the gradients, then the numerators, in one buffer
                grads = [torch.zeros_like(p) if g is None else g for p, g in zip(leaves, grads)]
                *grads, nums = parallel.all_reduce_sum([*grads, torch.stack([num_mle, num_dur])])
                num_mle, num_dur = nums[0], nums[1]
            l_mle = num_mle / d_mle + half_log_2pi
            l_dur = num_dur / d_dur
            loss = l_mle + l_dur
        grads = {
            k: torch.zeros_like(p) if g is None else g
            for (k, p), g in zip(params.items(), grads)
        }
        grad_norm = torch.sqrt(sum(torch.sum(g * g) for g in grads.values()))
        if state.sharded:  # Adam on this rank's slices, then the whole weights
            state.opt = adam_update(state.master, state.shard(grads), state.opt, config)
            state.gather()
        else:
            state.opt = adam_update(params, grads, state.opt, config)
        state.step += 1
        return {
            "loss": loss.detach(), "mle_loss": l_mle.detach(),
            "duration_loss": l_dur.detach(), "grad_norm": grad_norm,
        }

    return step_fn


def dropout_seed(seed: int, step: int) -> int:
    """The seed of both dropout generators at 1-indexed global step
    ``step``: ``seed`` at step 1, then a 64-bit odd-constant stride per
    step, so that a run resumed at step s draws what an uninterrupted run
    draws there."""
    return (int(seed) + (int(step) - 1) * 0x9E3779B97F4A7C15) % (1 << 64)


def _host_rss_mb() -> typing.Optional[float]:
    """Resident set size of this process in MB (Linux; None elsewhere)."""
    try:
        with open("/proc/self/status") as status:
            for line in status:
                if line.startswith("VmRSS:"):
                    return round(int(line.split()[1]) / 1024.0, 1)
    except OSError:
        pass
    return None


def _prefetch(iterable, prepare, size: int):
    """Background-thread prefetch: a daemon thread pulls host batches and
    runs ``prepare`` (collate output -> device tensors) up to ``size``
    batches ahead, so mel reads and the host-to-device copy overlap the
    step.  Exceptions reach the consumer; the order is unchanged."""
    import queue
    import threading

    q: "queue.Queue" = queue.Queue(maxsize=max(size, 1))
    sentinel = object()
    stop = threading.Event()
    errors = []

    def put(item) -> bool:
        while not stop.is_set():
            try:
                q.put(item, timeout=0.1)
                return True
            except queue.Full:
                continue
        return False

    def worker():
        try:
            for item in iterable:
                if not put(prepare(item)):
                    return
        except BaseException as exc:  # surface loader errors to the consumer
            errors.append(exc)
        finally:
            put(sentinel)

    threading.Thread(target=worker, daemon=True).start()
    try:
        while True:
            item = q.get()
            if item is sentinel:
                if errors:
                    raise errors[0]
                return
            yield item
    finally:
        stop.set()


def train(
    batches: typing.Callable[[], typing.Iterable[dict]],
    config,
    model_dir: Path,
    state: TrainState,
    device,
    checkpoint_epochs: int = 1,
    metrics_path: typing.Optional[Path] = None,
    profile_dir: typing.Optional[Path] = None,
) -> TrainState:
    """Epoch loop with per-epoch metrics and periodic checkpoints.
    ``batches`` returns a fresh iterable of host batches each epoch.

    Each epoch appends one JSON line to ``metrics_path`` (epoch,
    global_step, avg_loss, learning_rate, epoch_seconds, host_rss_mb);
    every ``checkpoint_epochs`` epochs writes ``checkpoint_<step>.npz``
    (params and Adam state, JAX format) and ``config_<step>.json``.  The
    learning rate written is the one the next update applies,
    ``lr(count)``.  ``profile_dir``: a ``torch.profiler`` trace (host and,
    on a GPU, device activity; each step a ``train_step`` range) of the
    run's 6th to 15th steps (the JAX trainer's "steps 5-15"), written there
    as a Chrome trace when the 15th ends or the run does.  Over W ranks
    rank 0 alone writes the metrics line, the checkpoints, their configs
    and the trace; every rank's losses are the global batch's.  Under
    tensor parallelism every rank takes part in a checkpoint's gather of
    the Adam moments (:meth:`TrainState.whole_opt`).

    Dropout: before each step both generators, ``generator`` on
    ``device`` (the op-by-op text side's masks) and ``seed_generator`` on
    the host (the kernels' seeds), are seeded with
    ``dropout_seed(config.seed, global step)``; a step's masks depend on
    (seed, step) alone, so a run resumed from ``checkpoint_<s>.npz`` draws
    at step s what an uninterrupted run draws there."""
    step_fn = make_train_step(config)
    lr_at = learning_rate_fn(config)
    chief = parallel.is_chief()
    if not chief:
        metrics_path = profile_dir = None
    generator = torch.Generator(device=device)
    seed_generator = torch.Generator()

    def prepare(b):
        return batch_to(b, device)

    profiler = None
    steps_done = 0
    for epoch in range(1, config.epochs + 1):
        epoch_start = time.perf_counter()
        losses = []
        epoch_batches = (
            _prefetch(batches(), prepare, config.prefetch_batches)
            if config.prefetch_batches
            else (prepare(b) for b in batches())
        )
        for batch in epoch_batches:
            if profile_dir is not None and steps_done == 5 and profiler is None:
                profiler = _start_profiler(device)
            generator.manual_seed(dropout_seed(config.seed, state.step))
            seed_generator.manual_seed(dropout_seed(config.seed, state.step))
            if profiler is None:
                metrics = step_fn(state, batch, generator, seed_generator)
            else:
                with torch.profiler.record_function("train_step"):
                    metrics = step_fn(state, batch, generator, seed_generator)
            steps_done += 1
            if profiler is not None and steps_done >= 15:
                _stop_profiler(profiler, profile_dir, device)
                profiler, profile_dir = None, None
            losses.append(metrics["loss"])
            if state.step % _LOG_EVERY == 0 and _LOGGER.isEnabledFor(logging.DEBUG):
                _LOGGER.debug("Loss: %s (step=%s)", float(metrics["loss"]), state.step)
        epoch_seconds = time.perf_counter() - epoch_start
        if losses:
            avg = float(torch.mean(torch.stack(losses)))
            _LOGGER.info("Avg. Loss for epoch %s: %s (global step=%s)", epoch, avg, state.step)
            if metrics_path is not None:
                with open(metrics_path, "a") as metrics_file:
                    json.dump(
                        {
                            "epoch": epoch,
                            "global_step": state.step,
                            "avg_loss": avg,
                            "learning_rate": lr_at(state.opt.count),
                            "epoch_seconds": epoch_seconds,
                            "host_rss_mb": _host_rss_mb(),
                        },
                        metrics_file,
                    )
                    metrics_file.write("\n")
        if epoch % checkpoint_epochs == 0:
            opt = state.whole_opt()  # every rank: the moments may be gathered
            if chief:
                checkpoint_path = Path(model_dir) / f"checkpoint_{state.step}.npz"
                save_checkpoint(state.model.flat(), checkpoint_path, state.step,
                                lr_at(state.opt.count), config.version, opt, config.scheduler)
                with open(Path(model_dir) / f"config_{state.step}.json", "w") as config_file:
                    config.save(config_file)
                _LOGGER.info("Saved checkpoint to %s", checkpoint_path)
    if profiler is not None:
        _stop_profiler(profiler, profile_dir, device)  # the run ended mid-capture
    return state


def _start_profiler(device):
    activities = [torch.profiler.ProfilerActivity.CPU]
    if torch.device(device).type == "cuda":
        activities.append(torch.profiler.ProfilerActivity.CUDA)
    profiler = torch.profiler.profile(activities=activities)
    profiler.__enter__()
    return profiler


def _stop_profiler(profiler, profile_dir: Path, device) -> None:
    if torch.device(device).type == "cuda":
        torch.cuda.synchronize(device)
    profiler.__exit__(None, None, None)
    Path(profile_dir).mkdir(parents=True, exist_ok=True)
    trace = Path(profile_dir) / "train_steps.pt.trace.json"
    profiler.export_chrome_trace(str(trace))
    _LOGGER.info("Wrote profiler trace to %s", trace)
