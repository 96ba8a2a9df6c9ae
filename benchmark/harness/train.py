"""Training cells: the port's own epoch loop, ``training.train``, fed by its
own data path, one epoch a call.

Set-up, as the train CLI's ``__main__`` sets a run up: the corpus (made
from the seed) in a ``PhonemeMelDataset`` held in memory, a length-bucketed
``DataPipeline`` (one shard a rank), the benchmark's weights through
``training.trainable_model``, DDI (``training.actnorm_init``) on the first
batch, then ``TrainState``.  Then the first three steps, each one call of
``train`` on one batch of the next epoch, so that the program's state can
be read after step 1 and step 3 for the check (they are the window's own
call and feed, and each step's loss terms are read from what the step
``train`` builds returns); then one whole epoch, which warms up every
bucketed shape.

The window is whole epochs until ``--seconds`` have passed; each ends on
the loop's own sync (the mean of its losses).  Its rate is the valid mel
frames of those epochs, over all ranks, over their wall time.  The traced
run profiles one whole epoch instead.
"""

import contextlib
import gc
import json
import tempfile
import time
import typing
from pathlib import Path

import numpy as np
import torch

from . import corpus, flops, trace
from . import weights as bench_weights

CHECK_STEPS = 3


class Feed:
    """Between ``DataPipeline.batches`` and the loop's prefetch: the host
    clock around each ``next()`` of the pipeline's iterator, and the
    lengths of every batch handed on (read once the epoch is over)."""

    def __init__(self):
        self.data_s: typing.List[float] = []
        self.lengths: typing.List[typing.Tuple[np.ndarray, np.ndarray]] = []

    def __call__(self, source: typing.Callable[[], typing.Iterable[dict]]):
        def batches():
            it = iter(source())
            while True:
                start = time.perf_counter()
                try:
                    batch = next(it)
                except StopIteration:
                    return
                self.data_s.append(time.perf_counter() - start)
                self.lengths.append((np.array(batch["x_lengths"]), np.array(batch["y_lengths"])))
                yield batch

        return batches


@contextlib.contextmanager
def step_terms(training, into: list):
    """While the block runs, every metrics dict that the step ``train``
    builds (``training.make_train_step``) returns is appended to ``into``."""
    make = training.make_train_step

    def recording(config):
        step = make(config)

        def step_fn(*args):
            metrics = step(*args)
            into.append(metrics)
            return metrics

        return step_fn

    training.make_train_step = recording
    try:
        yield
    finally:
        training.make_train_step = make


def global_batches(dataset, config, local_batch: int, world: int, epoch: int, count: int):
    """The first ``count`` global batches of data epoch ``epoch`` as the
    ranks hold them: each rank's collated rows, concatenated in rank
    order."""
    from glow_tts_train_tpu_torch.data import DataPipeline

    parts = []
    for r in range(world):
        pipeline = DataPipeline(dataset, config, batch_size=local_batch, num_shards=world,
                                shard_index=r)
        pipeline.epoch = epoch
        it = pipeline.batches()
        parts.append([next(it) for _ in range(count)])
        it.close()
    return [{k: np.concatenate([parts[r][i][k] for r in range(world)]) for k in parts[0][i]}
            for i in range(count)]


def _host(tensors: typing.Mapping[str, torch.Tensor]) -> typing.Dict[str, torch.Tensor]:
    return {k: v.detach().to("cpu", torch.float32).clone() for k, v in tensors.items()}


def _stop(local: bool, world: int, device) -> bool:
    """Rank 0's decision, the same on every rank."""
    if world == 1:
        return local
    flag = torch.tensor([1 if local else 0], device=device)
    torch.distributed.broadcast(flag, 0)
    return bool(flag.item())


def run(ctx) -> typing.Tuple[dict, dict]:
    """One run of a training cell (``ctx``: ``launch.Context``) -> (record,
    probe): the record of the window (rank 0; empty elsewhere), and what the
    check needs of the program: its losses of steps 1-3, the first gradient
    as Adam got it, the MLE term of each step's loss, the weights after DDI
    and after step 3, and the global batches of DDI and of the three
    steps."""
    from glow_tts_train_tpu_torch import training
    from glow_tts_train_tpu_torch.config import load_config
    from glow_tts_train_tpu_torch.data import DataPipeline, PhonemeMelDataset
    from glow_tts_train_tpu_torch.models import hyper_from_config

    traffic, device, world, rank = ctx.traffic, ctx.device, ctx.world, ctx.rank
    cuda = device.type == "cuda"
    config = load_config([ctx.config_path])
    local_batch = int(traffic["batch_size"])
    config.batch_size = local_batch * world
    config.epochs = 1
    config.seed = int(ctx.seed)
    hp_ref = bench_weights.hyper(json.loads(Path(ctx.config_path).read_text()))
    hp = hyper_from_config(config)

    id_phonemes, id_mels, _ = corpus.training_corpus(traffic, ctx.seed, hp_ref["mel_channels"],
                                                     device)
    dataset = PhonemeMelDataset(id_phonemes, id_mels, multispeaker=config.model.n_speakers > 1)
    pipeline = DataPipeline(dataset, config, batch_size=local_batch, num_shards=world,
                            shard_index=rank)
    model = training.trainable_model(bench_weights.make(hp_ref, ctx.seed, device), hp, device)
    training.actnorm_init(model, config, training.batch_to(next(iter(pipeline.batches())), device))
    state = training.TrainState(model)

    feed = Feed()
    probe: dict = {}
    record: dict = {}
    with tempfile.TemporaryDirectory() as model_dir:
        metrics_path = Path(model_dir) / "metrics.jsonl"
        if rank == 0:
            probe["theta0"] = _host(state.model.flat())
        check_batches = pipeline.batches()
        terms: typing.List[dict] = []
        with step_terms(training, terms):
            for i in range(CHECK_STEPS):
                host_batch = next(check_batches)
                training.train(feed(lambda b=host_batch: iter([b])), config, Path(model_dir),
                               state, device, checkpoint_epochs=2, metrics_path=metrics_path)
                if rank == 0 and i == 0:
                    probe["grad1"] = {k: v / (1.0 - config.betas[0])
                                      for k, v in _host(state.opt.mu).items()}
        check_batches.close()
        if rank == 0:
            probe["theta3"] = _host(state.model.flat())
            probe["loss"] = [json.loads(line)["avg_loss"]
                             for line in metrics_path.read_text().splitlines()]
            probe["mle"] = [float(m["mle_loss"]) for m in terms]

        def epoch():
            training.train(feed(pipeline.batches), config, Path(model_dir), state, device,
                           checkpoint_epochs=2)

        if ctx.window:
            epoch()  # warm-up: every bucketed shape of an epoch
            if cuda:
                torch.cuda.synchronize(device)
                torch.cuda.reset_peak_memory_stats(device)
            record["setup_s"] = time.perf_counter() - ctx.t0
            feed.__init__()
            if ctx.trace:
                _, summary = trace.traced(epoch, device)
                record["trace"] = summary
            else:
                start = time.perf_counter()
                walls = []
                while True:
                    epoch()
                    walls.append(time.perf_counter() - start - sum(walls))
                    if _stop(time.perf_counter() - start >= ctx.seconds, world, device):
                        break
                record.update(window_s=time.perf_counter() - start, epoch_s=walls)
            record["peak_bytes"] = int(torch.cuda.max_memory_allocated(device)) if cuda else 0

    mine = {
        "frames": int(sum(int(y.sum()) for _, y in feed.lengths)),
        "steps": len(feed.lengths),
        "flops": sum(flops.train_flops(hp_ref, x, y) for x, y in feed.lengths),
        "peak_bytes": record.get("peak_bytes", 0),
        "busy_s": record.get("trace", {}).get("busy_s", 0.0),
    }
    ranks = [mine]
    if world > 1:
        ranks = [None] * world
        torch.distributed.all_gather_object(ranks, mine)
    del state, model
    gc.collect()
    if cuda:
        torch.cuda.empty_cache()
    if rank != 0:
        return {}, {}
    record.update(
        driver="train", world=world, steps=ranks[0]["steps"],
        peak_flops=flops.PEAK_FLOPS["bf16" if config.fp16_run else "tf32"],
        frames=sum(r["frames"] for r in ranks), flops=sum(r["flops"] for r in ranks),
        peak_bytes=max(r["peak_bytes"] for r in ranks),
        data_ms=[s * 1e3 for s in feed.data_s],
    )
    if "trace" in record:
        record["trace"]["busy_s"] = sum(r["busy_s"] for r in ranks) / len(ranks)
    probe["ddi"] = global_batches(dataset, config, local_batch, world, 0, 1)[0]
    probe["batches"] = global_batches(dataset, config, local_batch, world, 1, CHECK_STEPS)
    probe["opt"] = {"betas": tuple(config.betas), "eps": config.eps,
                    "grad_clip": config.grad_clip, "warmup_steps": config.warmup_steps,
                    "learning_rate": config.learning_rate}
    probe["hp"] = hp_ref
    return record, probe
