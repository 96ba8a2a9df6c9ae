#!/usr/bin/env python3
"""Training CLI of the port, with the JAX CLI's flags on this path
(``python -m glow_tts_train_tpu``): --output, repeatable --dataset
<speaker_id> <phonemes_csv> <mels>, --mels-dir, --config (repeatable,
merged in order), --batch-size, --checkpoint, --checkpoint-epochs,
--skip-missing-mels, --metrics-file, --profile-dir, --git-commit, --debug,
plus ``--platform {cuda,cpu}`` and ``--dist-backend {nccl,gloo}``.

``--platform cuda`` (the default) trains with the hand-written CUDA
kernels and exits with an error when no GPU is present; ``--platform
cpu`` runs their plain PyTorch versions.  Without --checkpoint the model
is initialised fresh and ActNorm data-dependently on the first batch.  A
--checkpoint (a ``.npz`` of either package, or a reference PyTorch
Glow-TTS ``.pth`` to fine-tune from) resumes: its params merge into a
fresh init (a missing or mis-shaped key keeps its fresh value, an unused
one is left out, each with a warning), its Adam moments and count (and
with them the Noam schedule) and its global step carry over, and the data order and
the dropout seeds continue where the run that wrote it stopped.  Optimizer
state that does not match this config (keys, shapes or ``opt_treedef``)
is dropped with a warning and Adam starts fresh, as in the JAX CLI.
``grad_accum_steps`` in the config splits each batch into that many row
slices (exact accumulation); DDI takes the whole first batch.  The corpus
and batches come from the package's own ``data`` pipeline (numpy).

Data parallel, one process a GPU: launched by ``python -m
torch.distributed.run --nproc-per-node N -m glow_tts_train_tpu_torch ...``
(or with the JAX CLI's --coordinator host:port, --num-processes and
--process-id), each rank takes GPU ``LOCAL_RANK`` and joins an NCCL
process group (gloo with ``--platform cpu``; ``parallel/mesh.py``).
``batch_size`` is the global batch: each rank loads its strided rows of
every global batch (``DataPipeline(num_shards, shard_index)``), DDI takes
the global first batch's statistics, and a step is the global batch's
step (``training.make_train_step``); rank 0 alone writes checkpoints,
their configs, the metrics file and the profile.  A batch that the world
size does not divide, a local batch that ``grad_accum_steps`` does not
divide, ``--no-mesh`` under a world of more than one, and two ranks on one
card under NCCL exit 2; ``--virtual-devices`` (XLA's virtual CPU devices)
is not ported and exits 2.  ``--dist-backend gloo`` takes gloo on the
GPUs too, which lets ranks share a card (NCCL refuses that): a test's
setting, for one card; with one rank a GPU the default is the one to use.

Tensor parallelism, ``--model-parallel M`` (the JAX CLI's flag): the W
ranks form a (W / M, M) grid, the model axis innermost, and each row of
M ranks is a model group (``parallel/mesh.py``).  The batch still splits
over all W ranks and the gradients still sum over all W; each rank keeps
its slice of the last dimension of every weight that shards
(``parallel/partitioning.py``, JAX's rule) and of that weight's Adam
moments, updates it, and the group gathers the whole weights that the
kernels read.  A step gives the bits of the W-rank data-parallel step;
checkpoints hold whole params and moments (gathered, rank 0 writes) and
resume under any M.  An M below 1, one that does not divide the world,
and ``--no-mesh`` with M above 1 exit 2 before any rendezvous.
"""

import argparse
import logging
import random
import sys
from pathlib import Path

_LOGGER = logging.getLogger("glow_tts_train_tpu_torch")


def main(argv=None):
    parser = argparse.ArgumentParser(prog="glow-tts-train-torch")
    parser.add_argument("--output", required=True, help="Directory to store model artifacts")
    parser.add_argument(
        "--dataset",
        required=True,
        nargs=3,
        action="append",
        default=[],
        metavar=("speaker_id", "phonemes_csv", "mels"),
        help="Speaker id, phonemes CSV, and JSONL file with mel spectrograms "
        "or directory with .npy files (--mels-dir)",
    )
    parser.add_argument(
        "--mels-dir", action="store_true", help="mels argument is a directory with .npy files"
    )
    parser.add_argument("--config", action="append", help="Path to JSON configuration file(s)")
    parser.add_argument("--batch-size", type=int, help="Batch size (default: use config)")
    parser.add_argument(
        "--checkpoint", help="Path to a checkpoint to start from (.npz, or a reference .pth)"
    )
    parser.add_argument("--git-commit", help="Git commit to store in config")
    parser.add_argument(
        "--checkpoint-epochs", type=int, default=1, help="Number of epochs between checkpoints"
    )
    parser.add_argument(
        "--skip-missing-mels", action="store_true", help="Only warn about missing mel files"
    )
    parser.add_argument("--metrics-file", help="Append per-epoch metrics as JSON lines to this file")
    parser.add_argument(
        "--profile-dir", help="Write a torch.profiler trace of training steps 5-15 to this directory"
    )
    parser.add_argument(
        "--platform",
        default="cuda",
        choices=("cuda", "cpu"),
        help="'cuda' runs the CUDA kernels (error without a GPU); 'cpu' runs "
        "their plain PyTorch versions",
    )
    parser.add_argument(
        "--no-mesh", action="store_true",
        help="Run as one process; refused under a launcher that starts more than one",
    )
    parser.add_argument(
        "--model-parallel", type=int, default=1, metavar="M",
        help="Tensor parallelism: lay the ranks out as a 2-D (data, model) grid of shape "
        "(n_ranks/M, M); weights and Adam moments shard over the model axis, each rank "
        "updating its slice and the model group gathering the whole weights "
        "(parallel/partitioning.py).  Default 1 = pure data parallelism",
    )
    parser.add_argument(
        "--dist-backend", choices=("nccl", "gloo"),
        help="Process-group backend (default nccl with --platform cuda, gloo with cpu). "
        "gloo with --platform cuda is for ranks that share one card (tests); with one "
        "rank a GPU leave the default",
    )
    parser.add_argument(
        "--virtual-devices", type=int,
        help="XLA's virtual CPU devices: not ported (refused); launch N CPU ranks with "
        "torch.distributed.run and --platform cpu instead",
    )
    parser.add_argument(
        "--coordinator",
        help="Multi-process without torch.distributed.run: rendezvous address host:port of "
        "rank 0 (also needs --num-processes and --process-id)",
    )
    parser.add_argument("--num-processes", type=int, help="With --coordinator: the world size")
    parser.add_argument("--process-id", type=int, help="With --coordinator: this process's rank")
    parser.add_argument("--debug", action="store_true", help="Print DEBUG messages to the console")
    args = parser.parse_args(argv)

    logging.basicConfig(level=logging.DEBUG if args.debug else logging.INFO)
    _LOGGER.debug(args)

    import torch

    from . import parallel
    from .config import load_config
    from .training import check_trainable

    output = Path(args.output)
    config = load_config(args.config or ())
    config.git_commit = args.git_commit or ""
    _LOGGER.debug(config)
    # refused up front, before the corpus loads or a kernel builds
    try:
        check_trainable(config)
    except ValueError as err:
        parser.error(str(err))
    if args.virtual_devices is not None:
        parser.error(
            "--virtual-devices: not ported; launch CPU ranks with "
            "python -m torch.distributed.run --nproc-per-node N and --platform cpu"
        )
    try:
        launch = parallel.launch_from(args.coordinator, args.num_processes, args.process_id)
    except ValueError as err:
        parser.error(str(err))
    if args.no_mesh and launch.world > 1:
        parser.error(f"--no-mesh runs one process, but the launch has {launch.world} ranks")
    if args.no_mesh and args.model_parallel > 1:
        parser.error(f"--model-parallel {args.model_parallel} requires a mesh (--no-mesh)")
    try:
        parallel.check_model_parallel(launch.world, args.model_parallel)
    except ValueError as err:
        parser.error(f"--model-parallel {args.model_parallel}: {err}")
    if args.batch_size is not None:
        config.batch_size = args.batch_size
    if config.batch_size % launch.world:
        parser.error(
            f"batch_size {config.batch_size} (the global batch) must divide evenly over "
            f"{launch.world} ranks"
        )
    local_batch = config.batch_size // launch.world
    accum = max(1, int(getattr(config, "grad_accum_steps", 1) or 1))
    if local_batch % accum:
        parser.error(
            f"the local batch {local_batch} (batch_size {config.batch_size} over {launch.world} "
            f"ranks) must divide by grad_accum_steps {accum}"
        )
    if args.platform == "cuda" and not torch.cuda.is_available():
        parser.error("--platform cuda: no CUDA device is available")
    try:
        device = parallel.join(launch, args.platform, backend=args.dist_backend,
                               model_parallel=args.model_parallel)
    except ValueError as err:
        parser.error(str(err))
    try:
        _train(args, parser, config, output, device, local_batch)
    finally:
        parallel.leave()


def _train(args, parser, config, output, device, local_batch):
    import torch

    from . import parallel
    from .checkpoint import merge_into, read_checkpoint, restore_opt_state
    from .data import (
        CorpusError,
        DataPipeline,
        MissingMelsError,
        SpeakerSource,
        build_dataset,
        detect_num_symbols,
    )
    from .models import hyper_from_config, init_model
    from .training import TrainState, batch_to, initialize_model, train, trainable_model

    if not parallel.is_chief() and not args.debug:
        _LOGGER.setLevel(logging.WARNING)
    if parallel.is_chief():
        output.mkdir(parents=True, exist_ok=True)
    random.seed(config.seed)
    torch.manual_seed(config.seed)

    num_speakers = config.model.n_speakers
    if num_speakers > 1 and config.model.gin_channels <= 0:
        parser.error("Multispeaker model must have gin_channels > 0")
    if len(args.dataset) > num_speakers:
        parser.error("More datasets than speakers in model config")
    if len(args.dataset) < num_speakers:
        _LOGGER.warning(
            "Model has %s speaker(s), but only %s dataset(s) were provided",
            num_speakers, len(args.dataset),
        )

    sources = [SpeakerSource(int(idx), Path(phonemes), Path(mels)) for idx, phonemes, mels in args.dataset]
    try:
        dataset = build_dataset(
            sources, config, mels_are_dirs=args.mels_dir,
            skip_missing_mels=args.skip_missing_mels, multispeaker=(num_speakers > 1),
        )
    except MissingMelsError as err:
        _LOGGER.fatal("%s (re-run with --skip-missing-mels to train anyway)", err)
        sys.exit(1)
    except CorpusError as err:
        _LOGGER.fatal("%s", err)
        sys.exit(1)

    if config.model.num_symbols < 1:
        config.model.num_symbols = detect_num_symbols(dataset)
    # each rank's strided rows of every global batch, padded to its shape
    pipeline = DataPipeline(
        dataset, config, batch_size=local_batch, num_shards=parallel.world(),
        shard_index=parallel.rank(),
    )
    hp = hyper_from_config(config)

    if args.checkpoint:
        saved_opt: dict = {}
        try:
            flat, meta = read_checkpoint(Path(args.checkpoint), config, saved_opt)
        except ValueError as err:
            parser.error(str(err))
        fresh = init_model(hp, torch.Generator().manual_seed(config.seed))
        model = trainable_model(merge_into(fresh, flat), hp, device)
        state = TrainState(model, step=int(meta.get("global_step", 1)))
        if saved_opt:
            opt, why = restore_opt_state(
                saved_opt, meta.get("opt_treedef"), model.flat(), config.scheduler
            )
            if opt is None:
                _LOGGER.warning(
                    "%s: dropped %s optimizer-state (opt/) keys (%s); Adam starts fresh at "
                    "count 0 (its learning rate from the start of the schedule)",
                    args.checkpoint, len(saved_opt), why,
                )
            else:
                state.take_opt(opt)  # under --model-parallel this rank's slices
                _LOGGER.info("Restored Adam state (count=%s)", opt.count)
        # continue the data order: epoch e shuffles with seed + e, and a
        # fresh run spent the epoch-0 draw on its DDI batch
        steps_per_epoch = len(pipeline)
        if steps_per_epoch > 0:
            pipeline.epoch = (state.step - 1) // steps_per_epoch + 1
        _LOGGER.info(
            "Loaded checkpoint from %s (global step=%s, resuming at data epoch %s)",
            args.checkpoint, state.step, pipeline.epoch + 1,
        )
    else:
        _LOGGER.info("Doing data-dependent initialization...")
        first_batch = batch_to(next(iter(pipeline.batches())), device)
        state = TrainState(initialize_model(config, first_batch, device))

    _LOGGER.info(
        "Training started (batch size=%s, %s rank(s) of %s, model parallel %s, platform=%s)",
        config.batch_size, parallel.world(), local_batch, parallel.model_parallel(),
        args.platform,
    )
    try:
        train(
            pipeline.batches, config, output, state, device,
            checkpoint_epochs=args.checkpoint_epochs,
            metrics_path=Path(args.metrics_file) if args.metrics_file else None,
            profile_dir=Path(args.profile_dir) if args.profile_dir else None,
        )
        _LOGGER.info("Training finished")
    except KeyboardInterrupt:
        _LOGGER.info("Training stopped")


if __name__ == "__main__":
    main()
