#!/usr/bin/env python3
"""Inference CLI of the port: phoneme ids on stdin -> mel spectrograms on
stdout, the same contract as ``python -m glow_tts_train_tpu.infer``:

* stdin: whitespace-separated phoneme ids, one utterance per line; with
  ``--csv`` the line is ``id|p1 p2 …``
* stdout: JSONL ``{"id", "audio", "mel"}`` with mel as [n_mel, t], or
  ``.npy`` files under ``--numpy-dir``
* ``--batch-size`` lines per pass; texts padded to ``bucket_size_text``
  and frames generated into a budget bucketed by ``bucket_size_mel``

``--platform cuda`` (the default) runs the hand-written CUDA kernels and
exits with an error when no GPU is present; ``--platform cpu`` runs their
plain PyTorch versions.  Each inverse flow block is one kernel:
``flow_block_fuse_reverse: false`` in the config is refused.  The
checkpoint is a ``.npz`` of either package, a reference ``.pth``, or an
export directory (``export.py``), which runs its artifact through
``infer_export.run`` on ``--platform`` (the speaker is baked into an
artifact, so ``--speaker`` is refused there; one utterance a call, so
``--batch-size`` is ignored with a warning).
"""

import argparse
import logging
import time
from pathlib import Path

_LOGGER = logging.getLogger("glow_tts_train_tpu_torch.infer")


def build_synthesizer(weights, hp, config, noise_scale: float, length_scale: float):
    """Returns synth(batch_ids: List[List[int]], speaker: Optional[int]) ->
    List[np.ndarray [n_mel, t]].  ``weights``: ServingWeights on the
    device to run on."""
    import numpy as np
    import torch

    from .models.glow_tts import _speaker_vector, encoder_forward, forward_gen

    device = weights.emb.device
    bucket_t = max(config.bucket_size_text, 1)
    bucket_y = max(config.bucket_size_mel, 1)
    generator = torch.Generator(device=device)
    generator.manual_seed(config.seed)

    @torch.inference_mode()
    def synth(batch_ids, speaker=None):
        b = len(batch_ids)
        t_max = max(len(ids) for ids in batch_ids)
        t_pad = ((t_max + bucket_t - 1) // bucket_t) * bucket_t
        x = np.zeros((b, t_pad), np.int64)
        x_lengths = np.zeros((b,), np.int64)
        for i, ids in enumerate(batch_ids):
            x[i, : len(ids)] = ids
            x_lengths[i] = len(ids)
        x = torch.from_numpy(x).to(device)
        x_lengths = torch.from_numpy(x_lengths).to(device)
        g_ids = None
        if speaker is not None:
            g_ids = torch.full((b,), speaker, dtype=torch.int64, device=device)

        # frame budget from an encoder pre-pass, handed on to forward_gen
        enc = encoder_forward(weights, hp, x, x_lengths, g=_speaker_vector(weights.emb_g, g_ids))
        _, _, logw, x_mask = enc
        frames = torch.sum(torch.ceil(torch.exp(logw) * x_mask * length_scale), dim=(1, 2))
        budget = int(frames.max().item()) + hp.n_sqz
        y_max = ((budget + bucket_y - 1) // bucket_y) * bucket_y

        (y, _, _, _), _, _, y_lengths = forward_gen(
            weights, hp, x, x_lengths, y_max,
            noise_scale=noise_scale, length_scale=length_scale, g_ids=g_ids,
            generator=generator, encoder_out=enc,
        )
        y = y.float().cpu().numpy()
        y_lengths = y_lengths.cpu().numpy()
        # [b, t, n_mel] -> per-utterance [n_mel, t]
        return [y[i, : y_lengths[i]].T for i in range(b)]

    return synth


def main(argv=None):
    parser = argparse.ArgumentParser(prog="glow-tts-infer-torch")
    parser.add_argument(
        "checkpoint",
        help="Path to a model checkpoint (.npz or a reference .pth) or an export directory",
    )
    parser.add_argument(
        "--numpy-dir", help="Output numpy files to a directory instead of JSONL"
    )
    parser.add_argument(
        "--config", action="append", help="Path to JSON configuration file(s)"
    )
    parser.add_argument("--num-symbols", type=int, help="Number of symbols in the model")
    parser.add_argument(
        "--csv", action="store_true", help="Input format is id|p1 p2 p3..."
    )
    parser.add_argument("--noise-scale", type=float, default=0.333)
    parser.add_argument("--length-scale", type=float, default=1.0)
    parser.add_argument(
        "--batch-size", type=int, default=1, help="Utterances per device pass"
    )
    parser.add_argument(
        "--speaker", type=int, help="Speaker id number (multispeaker model only)"
    )
    parser.add_argument(
        "--platform",
        default="cuda",
        choices=("cuda", "cpu"),
        help="'cuda' runs the CUDA kernels (error without a GPU); 'cpu' runs "
        "their plain PyTorch versions",
    )
    parser.add_argument(
        "--debug", action="store_true", help="Print DEBUG messages to the console"
    )
    args = parser.parse_args(argv)

    logging.basicConfig(level=logging.DEBUG if args.debug else logging.INFO)
    _LOGGER.debug(args)

    import torch

    if args.platform == "cuda" and not torch.cuda.is_available():
        parser.error("--platform cuda: no CUDA device is available")
    device = torch.device(args.platform)

    checkpoint = Path(args.checkpoint)
    if checkpoint.is_dir():
        from . import infer_export
        from .export import ARTIFACT_NAME, ONNX_NAME

        if not any((checkpoint / name).exists() for name in (ARTIFACT_NAME, ONNX_NAME)):
            parser.error(f"{checkpoint}: a directory holds no {ARTIFACT_NAME} or {ONNX_NAME}")
        if args.speaker is not None:
            parser.error(
                "--speaker is baked into exported artifacts; re-export with the desired "
                "speaker or run from a checkpoint"
            )
        if args.batch_size != 1:
            _LOGGER.warning("--batch-size is ignored for exported artifacts (one utterance per call)")
        return infer_export.run(
            checkpoint, numpy_dir=args.numpy_dir, csv=args.csv, noise_scale=args.noise_scale,
            length_scale=args.length_scale, platform=args.platform,
        )

    from .checkpoint import load_checkpoint
    from .config import load_config
    from .models import hyper_from_config, store_inverse
    from .utils.stdio import exit_if_skipped, make_emitter, stdin_utterances, validate_speaker

    config = load_config(args.config or ())
    if args.num_symbols is not None:
        config.model.num_symbols = args.num_symbols
    if config.model.num_symbols <= 0:
        parser.error("Number of symbols not set (did you forget --config or --num-symbols?)")
    if args.speaker is not None:
        validate_speaker(parser, config.model.n_speakers, args.speaker)

    try:
        hp = hyper_from_config(config)
    except ValueError as err:  # a decoder-mode key the port cannot honour
        parser.error(str(err))
    start_time = time.perf_counter()
    model, meta = load_checkpoint(checkpoint, hp)
    weights = store_inverse(model, hp).to(device)
    _LOGGER.info(
        "Loaded checkpoint from %s in %s second(s) (global step=%s)",
        args.checkpoint,
        time.perf_counter() - start_time,
        meta.get("global_step"),
    )

    speaker = args.speaker
    if speaker is None and config.model.n_speakers > 1:
        speaker = 0

    synth = build_synthesizer(
        weights, hp, config, noise_scale=args.noise_scale, length_scale=args.length_scale
    )
    emit = make_emitter(args.numpy_dir, config.audio)
    pending = []  # (utt_id, phoneme_ids)
    skipped: list = []
    try:
        for utt_id, phoneme_ids in stdin_utterances(
            args.csv, config.model.num_symbols, skipped=skipped
        ):
            _LOGGER.debug("%s (id=%s)", phoneme_ids, utt_id)
            pending.append((utt_id, phoneme_ids))
            if len(pending) >= args.batch_size:
                flush(pending, synth, speaker, emit)
                pending = []
        if pending:
            flush(pending, synth, speaker, emit)
    except KeyboardInterrupt:
        pass
    exit_if_skipped(skipped)


def flush(pending, synth, speaker, emit):
    start_time = time.perf_counter()
    mels = synth([ids for _, ids in pending], speaker=speaker)
    elapsed = time.perf_counter() - start_time
    for (utt_id, _), mel in zip(pending, mels):
        emit(utt_id, mel)
        _LOGGER.debug(
            "Generated mel in %s second(s) (%s, shape=%s)", elapsed, utt_id, list(mel.shape)
        )


if __name__ == "__main__":
    main()
