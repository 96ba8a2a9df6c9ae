#!/usr/bin/env python3
"""Training CLI of the port, with the JAX CLI's flags on this path
(``python -m glow_tts_train_tpu``): --output, repeatable --dataset
<speaker_id> <phonemes_csv> <mels>, --mels-dir, --config (repeatable,
merged in order), --batch-size, --checkpoint, --checkpoint-epochs,
--skip-missing-mels, --metrics-file, --git-commit, --debug, plus
``--platform {cuda,cpu}``.

``--platform cuda`` (the default) trains with the hand-written CUDA
kernels and exits with an error when no GPU is present; ``--platform
cpu`` runs their plain PyTorch versions.  Without --checkpoint the model
is initialised fresh and ActNorm data-dependently on the first batch; a
--checkpoint (``.npz``, params) starts Adam fresh, as the JAX CLI does for
a checkpoint without optimizer state, and warns when the file holds
optimizer state (``opt/`` keys), which this CLI does not read yet.  The corpus and batches come from
the package's own ``data`` pipeline (numpy).  Single device:
the mesh and multi-host flags are not taken.
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
    parser.add_argument("--checkpoint", help="Path to a checkpoint (.npz) to start from")
    parser.add_argument("--git-commit", help="Git commit to store in config")
    parser.add_argument(
        "--checkpoint-epochs", type=int, default=1, help="Number of epochs between checkpoints"
    )
    parser.add_argument(
        "--skip-missing-mels", action="store_true", help="Only warn about missing mel files"
    )
    parser.add_argument("--metrics-file", help="Append per-epoch metrics as JSON lines to this file")
    parser.add_argument(
        "--platform",
        default="cuda",
        choices=("cuda", "cpu"),
        help="'cuda' runs the CUDA kernels (error without a GPU); 'cpu' runs "
        "their plain PyTorch versions",
    )
    parser.add_argument("--debug", action="store_true", help="Print DEBUG messages to the console")
    args = parser.parse_args(argv)

    logging.basicConfig(level=logging.DEBUG if args.debug else logging.INFO)
    _LOGGER.debug(args)

    import torch

    from .checkpoint import read_npz
    from .config import load_config
    from .data import (
        CorpusError,
        DataPipeline,
        MissingMelsError,
        SpeakerSource,
        build_dataset,
        detect_num_symbols,
    )
    from .models import hyper_from_config
    from .training import TrainState, batch_to, check_trainable, initialize_model, train, trainable_model

    output = Path(args.output)
    config = load_config(args.config or ())
    config.git_commit = args.git_commit or ""
    _LOGGER.debug(config)
    # refused up front, before the corpus loads or a kernel builds
    try:
        check_trainable(config)
    except (NotImplementedError, ValueError) as err:
        parser.error(str(err))
    if args.platform == "cuda" and not torch.cuda.is_available():
        parser.error("--platform cuda: no CUDA device is available")
    device = torch.device(args.platform)

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
    if args.batch_size is not None:
        config.batch_size = args.batch_size
    pipeline = DataPipeline(dataset, config, batch_size=config.batch_size)
    hp = hyper_from_config(config)

    if args.checkpoint:
        dropped: list = []
        flat, meta = read_npz(Path(args.checkpoint), dropped)
        if dropped:
            _LOGGER.warning(
                "%s: dropped %s optimizer-state (opt/) keys; Adam starts fresh at count 0 "
                "(its learning rate from the start of the schedule)",
                args.checkpoint, len(dropped),
            )
        model = trainable_model({k[len("model/"):]: v for k, v in flat.items()}, hp, device)
        state = TrainState(model, step=int(meta.get("global_step", 1)))
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

    _LOGGER.info("Training started (batch size=%s, platform=%s)", config.batch_size, args.platform)
    try:
        train(
            pipeline.batches, config, output, state, device,
            checkpoint_epochs=args.checkpoint_epochs,
            metrics_path=Path(args.metrics_file) if args.metrics_file else None,
        )
        _LOGGER.info("Training finished")
    except KeyboardInterrupt:
        _LOGGER.info("Training stopped")


if __name__ == "__main__":
    main()
