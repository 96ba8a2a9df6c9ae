"""Training: fresh init with data-dependent ActNorm init, the train step,
and the epoch loop (glow_tts_train_tpu training.py).

One step: the training graph (``models.forward_train``), the MLE and
duration losses, backward, the global gradient norm, then value clip and
Noam-scheduled Adam (``optimize.py``).  On CUDA tensors the flow blocks,
MAS and (``encoder_fuse`` true, what "auto" resolves to for the shipped
encoder configuration) the text side run the hand-written kernels, forward
and backward; ``encoder_fuse: false`` runs the text side op by op.  The
decoder runs in the mode the config picks (``models.hyper_from_config``):
``flow_block_fuse`` (each block one kernel pair, the default) or op by op
around the WN stack's kernels, with ``wn_residuals`` "store" (the default)
or "recompute" (a block's residuals live only inside its backward).  Not ported yet, and
refused with the ROADMAP item named: ``fp16_run`` (bf16 compute) and
``grad_accum_steps`` > 1.
"""

import json
import logging
import time
import typing
from pathlib import Path

import numpy as np
import torch

from .checkpoint import param_shapes, save_checkpoint
from .models.glow_tts import (
    GlowTTS,
    ddi_init,
    forward_train,
    hyper_from_config,
    init_model,
)
from .models.losses import duration_loss, mle_loss
from .optimize import AdamState, adam_init, adam_update, current_lr
from .tree import unflatten

_LOGGER = logging.getLogger("glow_tts_train_tpu_torch")
# steps between DEBUG loss lines
_LOG_EVERY = 10


class TrainState:
    """Trainable model, Adam moments and the 1-indexed global step."""

    def __init__(self, model: GlowTTS, step: int = 1):
        self.model = model
        self.opt: AdamState = adam_init(model.flat())
        self.step = step


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
    ``device``: ids and lengths int64, mels f32."""
    out = {}
    for k, v in batch.items():
        t = torch.from_numpy(np.asarray(v))
        t = t.to(torch.float32) if t.is_floating_point() else t.to(torch.int64)
        if torch.device(device).type == "cuda":
            out[k] = t.pin_memory().to(device, non_blocking=True)
        else:
            out[k] = t.to(device)
    return out


def initialize_model(config, batch: dict, device) -> GlowTTS:
    """Fresh init from ``config.seed`` + data-dependent ActNorm init on one
    batch (``batch_to`` tensors)."""
    hp = hyper_from_config(config)
    generator = torch.Generator().manual_seed(config.seed)
    model = trainable_model(init_model(hp, generator), hp, device)
    g_ids = batch.get("speaker_ids") if config.model.n_speakers > 1 else None
    actnorm = ddi_init(model.tree(), hp, batch["y"], batch["y_lengths"], g_ids)
    params = model.flat()
    with torch.no_grad():
        for name, value in actnorm.items():
            params[f"decoder/blocks/actnorm/{name}"].copy_(value)
    return model


def check_trainable(config) -> None:
    """Refuse what this trainer does not do yet, naming the ROADMAP item
    (``NotImplementedError``), and a decoder-mode key (``wn_impl``,
    ``wn_residuals``, ``flow_block_fuse``, ``flow_block_fuse_reverse``)
    whose value it cannot honour (``ValueError``)."""
    hyper_from_config(config)
    if config.fp16_run:
        raise NotImplementedError(
            "fp16_run (bf16 training) is not ported yet (ROADMAP, queue 1 "
            "item 6); set fp16_run to false"
        )
    if int(getattr(config, "grad_accum_steps", 1) or 1) > 1:
        raise NotImplementedError(
            "grad_accum_steps > 1 is not ported yet (ROADMAP, queue 1 item 6)"
        )


def make_train_step(config):
    """-> ``step_fn(state, batch, generator, seed_generator) -> metrics``:
    one optimizer step on ``state`` in place; metrics are 0-d tensors
    (loss, mle_loss, duration_loss, grad_norm).  Dropout is on when the
    generators are given (``models.forward_train``)."""
    check_trainable(config)
    hp = hyper_from_config(config)
    multispeaker = config.model.n_speakers > 1

    def step_fn(state: TrainState, batch: dict, generator=None, seed_generator=None) -> dict:
        params = state.model.flat()
        g_ids = batch.get("speaker_ids") if multispeaker else None
        (z, z_m, z_logs, logdet, z_mask), _, (_, logw, logw_) = forward_train(
            unflatten(params), hp, batch["x"], batch["x_lengths"], batch["y"],
            batch["y_lengths"], g_ids=g_ids, generator=generator,
            seed_generator=seed_generator,
        )
        l_mle = mle_loss(z, z_m, z_logs, logdet, z_mask)
        l_dur = duration_loss(logw, logw_, batch["x_lengths"])
        loss = l_mle + l_dur
        grads = torch.autograd.grad(loss, list(params.values()), allow_unused=True)
        grads = {
            k: torch.zeros_like(p) if g is None else g
            for (k, p), g in zip(params.items(), grads)
        }
        grad_norm = torch.sqrt(sum(torch.sum(g * g) for g in grads.values()))
        state.opt = adam_update(params, grads, state.opt, config)
        state.step += 1
        return {
            "loss": loss.detach(), "mle_loss": l_mle.detach(),
            "duration_loss": l_dur.detach(), "grad_norm": grad_norm,
        }

    return step_fn


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
) -> TrainState:
    """Epoch loop with per-epoch metrics and periodic checkpoints.
    ``batches`` returns a fresh iterable of host batches each epoch.

    Each epoch appends one JSON line to ``metrics_path`` (epoch,
    global_step, avg_loss, learning_rate, epoch_seconds, host_rss_mb);
    every ``checkpoint_epochs`` epochs writes ``checkpoint_<step>.npz``
    (params, JAX format) and ``config_<step>.json``."""
    step_fn = make_train_step(config)
    generator = torch.Generator(device=device).manual_seed(config.seed)
    seed_generator = torch.Generator().manual_seed(config.seed)

    def prepare(b):
        return batch_to(b, device)

    for epoch in range(1, config.epochs + 1):
        epoch_start = time.perf_counter()
        losses = []
        epoch_batches = (
            _prefetch(batches(), prepare, config.prefetch_batches)
            if config.prefetch_batches
            else (prepare(b) for b in batches())
        )
        for batch in epoch_batches:
            metrics = step_fn(state, batch, generator, seed_generator)
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
                            "learning_rate": current_lr(config, state.step),
                            "epoch_seconds": epoch_seconds,
                            "host_rss_mb": _host_rss_mb(),
                        },
                        metrics_file,
                    )
                    metrics_file.write("\n")
        if epoch % checkpoint_epochs == 0:
            checkpoint_path = Path(model_dir) / f"checkpoint_{state.step}.npz"
            save_checkpoint(
                state.model.flat(), checkpoint_path, state.step,
                current_lr(config, state.step), config.version,
            )
            with open(Path(model_dir) / f"config_{state.step}.json", "w") as config_file:
                config.save(config_file)
            _LOGGER.info("Saved checkpoint to %s", checkpoint_path)
    return state
