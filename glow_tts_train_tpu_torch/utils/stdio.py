"""Stdin/stdout plumbing of the inference CLI (the port's own copy of
``glow_tts_train_tpu/utils/stdio.py`` without its JAX backend options;
the same contract as the JAX package's CLIs):

* input: whitespace-separated phoneme ids, one utterance per line; with
  ``csv=True`` the line is ``id|p1 p2 …``
* output: JSONL ``{"id", "audio": <AudioConfig dict>, "mel": [[...]]}`` to
  stdout, or per-utterance ``.npy`` files under ``numpy_dir`` (timestamp
  filename when the utterance has no id)
"""

import dataclasses
import json
import logging
import sys
import time
import typing
from pathlib import Path

import numpy as np

_LOGGER = logging.getLogger("glow_tts_train_tpu_torch")


def stdin_utterances(
    csv: bool,
    num_symbols: int,
    skipped: typing.Optional[typing.List[str]] = None,
) -> typing.Iterator[typing.Tuple[str, typing.List[int]]]:
    """Yield (utt_id, phoneme_ids) per stdin line, skipping blank lines and
    rejecting out-of-range ids loudly, before they reach the embedding
    lookup on the device.

    A rejected line breaks the 1:1 input-line↔output-line correspondence
    that positional JSONL consumers rely on, so callers pass ``skipped``
    (a list the rejected ids/lines are appended to) and exit non-zero when
    it is non-empty at end of stream."""
    import os

    try:
        interactive = os.isatty(sys.stdin.fileno())
    except (OSError, ValueError):  # stdin replaced by a pipe-less object
        interactive = False
    if interactive:
        print(
            "Reading whitespace-separated phoneme ids from stdin...",
            file=sys.stderr,
        )

    for line in sys.stdin:
        line = line.strip()
        if not line:
            continue
        utt_id = ""
        if csv:
            utt_id, line = line.split("|", maxsplit=1)
        phoneme_ids = [int(p) for p in line.split()]
        bad = [p for p in phoneme_ids if not 0 <= p < num_symbols]
        if bad:
            _LOGGER.error(
                "phoneme ids %s out of range [0, %s) (id=%s); skipping — "
                "check the config matches the phoneme inventory",
                bad,
                num_symbols,
                utt_id or "<no id>",
            )
            if skipped is not None:
                skipped.append(utt_id or line)
            continue
        yield utt_id, phoneme_ids


def exit_if_skipped(skipped: typing.List[str]) -> None:
    """Exit non-zero when any stdin line was rejected: the JSONL output is no
    longer line-aligned with the input, so positional consumers would
    silently misalign.  (The reference's torch path raises instead.)"""
    if skipped:
        _LOGGER.error(
            "%s utterance(s) were rejected (out-of-range phoneme ids); "
            "output is incomplete — exiting non-zero",
            len(skipped),
        )
        sys.exit(1)


def make_emitter(numpy_dir, audio_config) -> typing.Callable[[str, np.ndarray], None]:
    """Emit one mel: ``.npy`` into ``numpy_dir`` when set, else a JSONL line
    (reference infer.py:178-194 contract, mel as [n_mel, t])."""
    if numpy_dir:
        numpy_dir = Path(numpy_dir)
        numpy_dir.mkdir(parents=True, exist_ok=True)

        def emit(utt_id: str, mel: np.ndarray) -> None:
            if not utt_id:
                utt_id = str(time.time())
            mel_path = numpy_dir / (utt_id + ".npy")
            np.save(str(mel_path), mel, allow_pickle=False)
            _LOGGER.debug("Wrote %s", mel_path)

        return emit

    output_obj = {"id": "", "audio": dataclasses.asdict(audio_config), "mel": []}

    def emit(utt_id: str, mel: np.ndarray) -> None:
        output_obj["id"] = utt_id
        output_obj["mel"] = mel.tolist()
        json.dump(output_obj, sys.stdout)
        sys.stdout.write("\n")
        sys.stdout.flush()

    return emit


def validate_speaker(parser, n_speakers: int, speaker) -> int:
    """--speaker validation of the infer CLI: exits via
    ``parser.error`` on a single-speaker model or an out-of-range id (an
    out-of-range id would silently clamp onto the last speaker's
    embedding).  Returns the effective speaker id (0 when unset)."""
    if speaker is not None and n_speakers <= 1:
        parser.error("--speaker requires a multispeaker model config")
    speaker = speaker or 0
    if n_speakers > 1 and not 0 <= speaker < n_speakers:
        parser.error(f"--speaker {speaker} out of range [0, {n_speakers})")
    return speaker
