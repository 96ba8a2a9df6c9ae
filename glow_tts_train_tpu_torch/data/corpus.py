"""Corpus assembly: merge per-speaker phoneme/mel sources into one dataset.

The port's own copy of ``glow_tts_train_tpu/data/corpus.py`` (numpy only).
Functions, so the CLI stays thin and other entry points (tests, smoke
runs) can assemble corpora without argparse:

* missing ``.npy`` mels raise :class:`MissingMelsError` instead of calling
  ``sys.exit`` from library code - the CLI decides how to die
* ``detect_num_symbols`` sizes the symbol table from the corpus
"""

import dataclasses
import logging
import typing
from pathlib import Path

import numpy as np

from .dataset import (
    PhonemeMelDataset,
    UttKey,
    load_mels,
    load_phonemes,
    read_npy_shape,
)

_LOGGER = logging.getLogger("glow_tts_train_tpu_torch.corpus")


@dataclasses.dataclass
class SpeakerSource:
    """One ``--dataset`` triple: a speaker and its phoneme/mel files."""

    speaker_idx: int
    phonemes_path: Path
    mels_path: Path  # JSONL file, or a directory of <utt_id>.npy files


class CorpusError(ValueError):
    """A corpus inconsistency the user must fix (clear one-line message)."""


class MissingMelsError(RuntimeError):
    """Raised when .npy mels are absent and skipping is not allowed."""

    def __init__(self, speaker_idx: int, missing_ids: typing.Collection[str]):
        self.speaker_idx = speaker_idx
        self.missing_ids = sorted(missing_ids)
        preview = ", ".join(self.missing_ids[:10])
        if len(self.missing_ids) > 10:
            preview += ", …"
        super().__init__(
            f"speaker {speaker_idx}: no .npy mel for {len(self.missing_ids)} "
            f"utterance(s): {preview}"
        )


def _npy_presence(
    utt_ids: typing.Iterable[str], mels_dir: Path
) -> typing.Tuple[typing.Set[str], typing.Set[str]]:
    """Partition utterance ids by whether ``<id>.npy`` exists in mels_dir."""
    present: typing.Set[str] = set()
    absent: typing.Set[str] = set()
    for utt_id in utt_ids:
        target = present if (mels_dir / f"{utt_id}.npy").is_file() else absent
        target.add(utt_id)
    return present, absent


def _source_mel_channel_samples(src, per_utt, mels, mels_are_dirs, n_dir_samples=8):
    """(utt_id, channels) samples from a speaker source.

    JSONL sources check every in-memory mel (np.shape is O(1)); directory
    sources spot-check ``n_dir_samples`` spread across the id list, reading
    only .npy headers.  Sampling more than one utterance catches partially
    regenerated corpora with mixed channel counts, which a single
    representative would miss and which otherwise fail steps later inside
    the model."""
    ids = list(per_utt)
    if not ids:
        return []
    if not mels_are_dirs:
        return [
            (u, int(np.shape(mel)[0]))
            for u in ids
            if (mel := mels.get((src.speaker_idx, u))) is not None
        ]
    stride = max(len(ids) // n_dir_samples, 1)
    sampled = ids[::stride][:n_dir_samples]
    if ids[-1] not in sampled:
        sampled.append(ids[-1])
    return [
        (u, int(read_npy_shape(Path(src.mels_path) / (u + ".npy"))[0]))
        for u in sampled
    ]


def build_dataset(
    sources: typing.Sequence[SpeakerSource],
    config,
    *,
    mels_are_dirs: bool = False,
    skip_missing_mels: bool = False,
    multispeaker: typing.Optional[bool] = None,
) -> PhonemeMelDataset:
    """Load every speaker source and merge into one PhonemeMelDataset.

    Utterances are keyed ``(speaker_idx, utt_id)`` so ids may repeat across
    speakers.  JSONL sources load mels eagerly; directory sources only
    verify ``.npy`` presence here and stream lazily during training.
    """
    phonemes: typing.Dict[UttKey, typing.Any] = {}
    mels: typing.Dict[UttKey, typing.Any] = {}
    mel_dirs: typing.Dict[int, Path] = {}

    # Speaker-id range check up front (needs no I/O): ids index the speaker
    # embedding; an out-of-range row would silently clamp onto the last
    # speaker after minutes of corpus loading.
    n_speakers = config.model.n_speakers
    for src in sources:
        if n_speakers > 1 and not 0 <= src.speaker_idx < n_speakers:
            raise CorpusError(
                f"--dataset speaker id {src.speaker_idx} out of range "
                f"[0, {n_speakers}) for this model (speaker ids are 0-based)"
            )

    for src in sources:
        with open(src.phonemes_path, "r", encoding="utf-8") as fh:
            per_utt = load_phonemes(fh, config)

        if mels_are_dirs:
            present, absent = _npy_presence(per_utt, Path(src.mels_path))
            if absent:
                if not skip_missing_mels:
                    raise MissingMelsError(src.speaker_idx, absent)
                _LOGGER.warning(
                    "speaker %s: %s of %s utterances have no .npy mel — "
                    "training on the %s that do",
                    src.speaker_idx,
                    len(absent),
                    len(per_utt),
                    len(present),
                )
                per_utt = {u: p for u, p in per_utt.items() if u in present}
            mel_dirs[src.speaker_idx] = Path(src.mels_path)
            n_mels = len(per_utt)
        else:
            with open(src.mels_path, "r", encoding="utf-8") as fh:
                per_mel = load_mels(fh)
            mels.update(
                {(src.speaker_idx, u): m for u, m in per_mel.items()}
            )
            n_mels = len(per_mel)

        phonemes.update({(src.speaker_idx, u): p for u, p in per_utt.items()})
        _LOGGER.info(
            "speaker %s: %s phoneme utterance(s), %s mel(s) from %s",
            src.speaker_idx,
            len(per_utt),
            n_mels,
            src.mels_path,
        )

        # Channel-count check on sampled mels per source: a mismatch would
        # otherwise surface steps later as an einsum shape error deep inside
        # the model, with no hint it's a data problem.
        expected = config.audio.mel_channels
        for utt_id, found in _source_mel_channel_samples(
            src, per_utt, mels, mels_are_dirs
        ):
            if found != expected:
                raise CorpusError(
                    f"speaker {src.speaker_idx}: mel for {utt_id!r} in "
                    f"{src.mels_path} has {found} channels but the config "
                    f"says audio.mel_channels={expected} — fix the config "
                    f"or regenerate the mels"
                )

        # Phoneme-id range check when num_symbols is preset: ids outside
        # [0, num_symbols) would silently clamp/wrap in the embedding gather
        # and train the wrong symbol (the infer CLI rejects them loudly).
        n_sym = config.model.num_symbols
        if n_sym >= 1:
            bounds = [
                (int(np.min(p)), int(np.max(p)))
                for p in per_utt.values()
                if len(p)
            ]
            if bounds:
                corpus_min = min(lo for lo, _ in bounds)
                corpus_max = max(hi for _, hi in bounds)
                if corpus_min < 0 or corpus_max >= n_sym:
                    offender = corpus_min if corpus_min < 0 else corpus_max
                    raise CorpusError(
                        f"speaker {src.speaker_idx}: {src.phonemes_path} "
                        f"contains phoneme id {offender} but the config says "
                        f"model.num_symbols={n_sym} (valid ids are "
                        f"0..{n_sym - 1})"
                    )

    if multispeaker is None:
        multispeaker = len(sources) > 1
    return PhonemeMelDataset(
        id_phonemes=phonemes,
        id_mels=mels,
        mel_dirs=mel_dirs,
        multispeaker=multispeaker,
        cache_frames=getattr(config, "mel_cache_frames", 500_000),
    )


def detect_num_symbols(dataset: PhonemeMelDataset) -> int:
    """Smallest symbol-table size covering every phoneme id in the corpus."""
    highest = max(
        int(ids.max()) for ids in dataset.id_phonemes.values() if ids.size
    )
    return highest + 1
