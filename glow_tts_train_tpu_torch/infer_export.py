#!/usr/bin/env python3
"""Run an exported voice: the CLI of ``python -m
glow_tts_train_tpu.infer_export`` for the port's artifacts (``export.py``).

    python -m glow_tts_train_tpu_torch.infer_export MODEL_DIR < ids.txt

The same stdin/stdout contract as the infer CLI (JSONL, or ``.npy`` files
under ``--numpy-dir``), ``--noise-scale`` 0.667 by default.  MODEL_DIR is
an export directory, or a ``.onnx`` file itself:

* ``generator.pt2`` runs on ``--platform`` (``cuda``, the default, exits
  with an error without a GPU; ``cpu`` runs on the host); each text is
  padded to the artifact's ``max_text_length`` (longer ones are cut, with
  a warning) and the noise comes from ``--seed``;
* ``generator.onnx`` runs on the host by design, with exact shapes:
  through onnxruntime where it can be imported, else through the
  package's numpy executor (``onnx/runtime.py``); the log names which.
"""

import argparse
import json
import logging
import time
import typing
from pathlib import Path

_LOGGER = logging.getLogger("glow_tts_train_tpu_torch.infer_export")


def main(argv=None):
    parser = argparse.ArgumentParser(prog="glow-tts-infer-export-torch")
    parser.add_argument("model_dir", help="Directory with an exported model, or a .onnx file")
    parser.add_argument("--numpy-dir", help="Output .npy files instead of JSONL")
    parser.add_argument("--csv", action="store_true", help="Input format is id|p1 p2 p3...")
    parser.add_argument("--noise-scale", type=float, default=0.667)
    parser.add_argument("--length-scale", type=float, default=1.0)
    parser.add_argument("--seed", type=int, default=1234)
    parser.add_argument(
        "--platform",
        default="cuda",
        choices=("cuda", "cpu"),
        help="'cuda' runs a .pt2 on the card (error without a GPU); 'cpu' on the host. "
        "A .onnx runs on the host either way",
    )
    parser.add_argument("--debug", action="store_true", help="Print DEBUG messages to the console")
    args = parser.parse_args(argv)

    logging.basicConfig(level=logging.DEBUG if args.debug else logging.INFO)
    _LOGGER.debug(args)

    import torch

    if args.platform == "cuda" and not torch.cuda.is_available():
        parser.error("--platform cuda: no CUDA device is available")
    run(
        args.model_dir,
        numpy_dir=args.numpy_dir,
        csv=args.csv,
        noise_scale=args.noise_scale,
        length_scale=args.length_scale,
        seed=args.seed,
        platform=args.platform,
    )


class Artifact(typing.NamedTuple):
    """A loaded artifact: ``call(phoneme_ids, [noise, length])`` -> mel
    [n_mel, t] (numpy); ``max_text_length`` the text budget of a ``.pt2``
    (None for a ``.onnx``)."""

    config: typing.Any
    call: typing.Callable
    description: str
    max_text_length: typing.Optional[int]


def load_artifact(model_dir, platform: str = "cuda", seed: int = 1234) -> Artifact:
    """An export directory or a ``.onnx`` path -> :class:`Artifact`; a
    ``.pt2`` on ``platform``, a ``.onnx`` on the host."""
    import numpy as np
    import torch

    from .config import TrainingConfig
    from .export import ARTIFACT_NAME, META_NAME, ONNX_NAME, load_pt2

    model_dir = Path(model_dir)
    onnx_file = None
    if model_dir.is_file():
        if model_dir.suffix != ".onnx":
            raise SystemExit(
                f"{model_dir} is a file but not .onnx; pass an export directory or a .onnx path"
            )
        onnx_file, model_dir = model_dir, model_dir.parent
    elif (model_dir / ONNX_NAME).exists() and not (model_dir / ARTIFACT_NAME).exists():
        onnx_file = model_dir / ONNX_NAME

    if (model_dir / "config.json").exists():
        with open(model_dir / "config.json") as config_file:
            config = TrainingConfig.load(config_file)
    elif onnx_file is not None:
        # a .onnx made elsewhere may come alone: the audio fields of the
        # output fall back to the defaults
        _LOGGER.warning("no config.json next to %s; using defaults", onnx_file)
        config = TrainingConfig()
    else:
        raise SystemExit(f"missing {model_dir / 'config.json'}")
    meta = None
    if (model_dir / META_NAME).exists():
        with open(model_dir / META_NAME) as meta_file:
            meta = json.load(meta_file)

    if onnx_file is not None:
        try:
            import onnxruntime

            sess = onnxruntime.InferenceSession(str(onnx_file))
            runtime = "onnxruntime"
        except ImportError:
            from .onnx import OnnxRuntime

            sess = OnnxRuntime.from_file(onnx_file, seed=seed)
            runtime = "glow_tts_train_tpu_torch.onnx.runtime (numpy)"

        def call(phoneme_ids, scales):
            # ONNX graphs have dynamic axes: exact shapes, int64 as the
            # reference's traced export takes them
            mel, mel_lengths = sess.run(None, {
                "input": np.asarray(phoneme_ids, np.int64)[None, :],
                "input_lengths": np.asarray([len(phoneme_ids)], np.int64),
                "scales": np.asarray(scales, np.float32),
            })
            return np.asarray(mel)[0, :, : int(np.asarray(mel_lengths)[0])]

        return Artifact(config, call, f"{onnx_file} on the host through {runtime}", None)

    if not (model_dir / ARTIFACT_NAME).exists():
        raise SystemExit(
            f"no runnable artifact in {model_dir}: expected {ARTIFACT_NAME} or {ONNX_NAME}"
        )
    if meta is None:
        raise SystemExit(f"missing {model_dir / META_NAME}")
    device = torch.device(platform)
    module, _ = load_pt2(model_dir / ARTIFACT_NAME, device)
    max_text_length = int(meta["max_text_length"])
    seed_t = torch.tensor(seed, dtype=torch.int32, device=device)

    def call(phoneme_ids, scales):
        text = torch.zeros((1, max_text_length), dtype=torch.int32)
        text[0, : len(phoneme_ids)] = torch.as_tensor(phoneme_ids, dtype=torch.int32)
        with torch.no_grad():
            mel, mel_lengths = module(
                text.to(device),
                torch.tensor([len(phoneme_ids)], dtype=torch.int32, device=device),
                torch.as_tensor(scales, dtype=torch.float32).to(device),
                seed_t,
            )
        return mel[0, :, : int(mel_lengths[0])].cpu().numpy()

    return Artifact(config, call, f"{model_dir / ARTIFACT_NAME} on {device}", max_text_length)


def run(
    model_dir,
    *,
    numpy_dir=None,
    csv: bool = False,
    noise_scale: float = 0.667,
    length_scale: float = 1.0,
    seed: int = 1234,
    platform: str = "cuda",
) -> None:
    """Stream stdin utterances through an exported artifact (the library
    entry; the infer CLI hands export directories here)."""
    from .utils.stdio import exit_if_skipped, make_emitter, stdin_utterances

    start = time.perf_counter()
    artifact = load_artifact(model_dir, platform, seed)
    _LOGGER.info("Loaded %s in %s second(s)", artifact.description, time.perf_counter() - start)
    max_text_length = artifact.max_text_length
    scales = [noise_scale, length_scale]
    emit = make_emitter(numpy_dir, artifact.config.audio)
    skipped: list = []
    try:
        for utt_id, phoneme_ids in stdin_utterances(
            csv, artifact.config.model.num_symbols, skipped=skipped
        ):
            if max_text_length is not None and len(phoneme_ids) > max_text_length:
                _LOGGER.warning(
                    "Utterance %s longer than export budget (%s > %s); truncating",
                    utt_id, len(phoneme_ids), max_text_length,
                )
                phoneme_ids = phoneme_ids[:max_text_length]
            start = time.perf_counter()
            mel = artifact.call(phoneme_ids, scales)
            emit(utt_id, mel)
            _LOGGER.debug(
                "Generated mel in %s second(s) (%s, shape=%s)",
                time.perf_counter() - start, utt_id, list(mel.shape),
            )
    except KeyboardInterrupt:
        pass
    exit_if_skipped(skipped)


if __name__ == "__main__":
    main()
