"""Phoneme/mel dataset loading and length-bucketed batching.

The port's own copy of the JAX package's host-side pipeline
(``glow_tts_train_tpu/data/dataset.py``; numpy only): from one corpus and
seed it yields the same batches in the same order.

* ``load_phonemes`` - CSV ``id|p1 p2 ...`` with min/max length filter
* ``load_mels`` - JSONL ``{"id": ..., "mel": [[...]]}``
* ``PhonemeMelDataset`` - (speaker_idx, utt_id)-keyed map dataset with lazy
  ``.npy`` loading and a bounded in-RAM cache
* ``collate`` - sort batch by text length descending, zero-pad, round mel
  frames up to ``n_frames_per_step``

Batches are padded to *length buckets* (multiples of ``bucket_size_text`` /
``bucket_size_mel``): a bounded set of shapes, so scratch sizes and kernel
grids repeat from step to step.  The batcher sorts by mel length and
batches neighbours ("bucket_by_length") to cut padding waste, and can
shard utterances across processes by ``shard_index``.
"""

import collections
import csv
import json
import logging
import typing
from pathlib import Path

import numpy as np

from ..config import TrainingConfig

_LOGGER = logging.getLogger("glow_tts_train_tpu_torch.dataset")

UttKey = typing.Tuple[int, str]


def load_phonemes(
    csv_file: typing.TextIO, config: TrainingConfig
) -> typing.Dict[str, np.ndarray]:
    """Parse ``id|p1 p2 …`` rows, filtering by min/max_seq_length."""
    phonemes: typing.Dict[str, np.ndarray] = {}
    num_too_small = 0
    num_too_large = 0

    reader = csv.reader(csv_file, delimiter="|")
    for row in reader:
        utt_id, phoneme_str = row[0], row[1]
        phoneme_ids = [int(p) for p in phoneme_str.strip().split()]
        num_phonemes = len(phoneme_ids)

        if (config.min_seq_length is not None) and (
            num_phonemes < config.min_seq_length
        ):
            _LOGGER.debug(
                "Dropping %s (%s < %s)", utt_id, num_phonemes, config.min_seq_length
            )
            num_too_small += 1
            continue
        if (config.max_seq_length is not None) and (
            num_phonemes > config.max_seq_length
        ):
            _LOGGER.debug(
                "Dropping %s (%s > %s)", utt_id, num_phonemes, config.max_seq_length
            )
            num_too_large += 1
            continue

        phonemes[utt_id] = np.asarray(phoneme_ids, dtype=np.int32)

    if (num_too_small > 0) or (num_too_large > 0):
        _LOGGER.warning(
            "Dropped some utterance (%s too small, %s too large)",
            num_too_small,
            num_too_large,
        )
    return phonemes


def load_mels(jsonl_file: typing.TextIO) -> typing.Dict[str, np.ndarray]:
    """Parse JSONL mels; values stored [n_mel, t] like the reference."""
    mels = {}
    for line in jsonl_file:
        line = line.strip()
        if not line:
            continue
        mel_obj = json.loads(line)
        mels[mel_obj["id"]] = np.asarray(mel_obj["mel"], dtype=np.float32)
    return mels


class PhonemeMelDataset:
    """(speaker_idx, utt_id)-keyed dataset with lazy .npy mel loading.

    Lazily-loaded mels go through a frames-budgeted LRU cache instead of
    the reference's grow-forever dict (reference dataset.py:56-59): at
    LJSpeech scale (~13k utts x 80 x ~800 f32) unbounded caching is
    several GB of host RSS climbing through epoch 1, in the same process
    as the prefetch thread's in-flight device batches.  ``cache_frames``
    bounds the cache by total mel frames (bytes ~= frames*channels*4);
    0 disables it (the OS page cache still makes re-reads cheap), and -1
    keeps everything like the reference.  Eagerly-loaded JSONL mels
    (``id_mels``) are owned by the caller and not counted.
    """

    def __init__(
        self,
        id_phonemes: typing.Dict[UttKey, np.ndarray],
        id_mels: typing.Dict[UttKey, np.ndarray],
        mel_dirs: typing.Optional[typing.Dict[int, Path]] = None,
        multispeaker: bool = False,
        cache_frames: int = 500_000,
    ):
        self.id_phonemes = id_phonemes
        self.id_mels = dict(id_mels)
        self.mel_dirs = mel_dirs or {}
        self.multispeaker = multispeaker
        self.cache_frames = cache_frames
        self._mel_cache: "typing.OrderedDict[UttKey, np.ndarray]" = (
            collections.OrderedDict()
        )
        self._cached_frames = 0
        self._mel_lengths: typing.Dict[UttKey, int] = {}

        if id_mels:
            self.ids = sorted(
                set(id_phonemes.keys()) & set(id_mels.keys()),
                key=lambda k: (k[0], k[1]),
            )
            assert self.ids, "No shared utterance ids between phonemes and mels"
        else:
            self.ids = sorted(id_phonemes.keys(), key=lambda k: (k[0], k[1]))

    def __len__(self) -> int:
        return len(self.ids)

    def get(self, utt_key: UttKey):
        """Returns (text [t_x] int32, mel [n_mel, t_y] f32, speaker_idx)."""
        speaker_idx, utt_id = utt_key
        text = self.id_phonemes[utt_key]
        mel = self.id_mels.get(utt_key)
        if mel is None:
            mel = self._mel_cache.get(utt_key)
            if mel is not None:
                self._mel_cache.move_to_end(utt_key)
        if mel is None:
            mels_dir = self.mel_dirs.get(speaker_idx)
            assert mels_dir, f"Missing mel for id {utt_id}, but no mels_dir"
            # allow_pickle=False: corpus mels are plain float arrays; pickle
            # loading is an arbitrary-code-execution vector from an
            # untrusted corpus (the reference passes True — a deliberate
            # behavioral divergence, documented in MIGRATING.md)
            mel = np.load(Path(mels_dir) / (utt_id + ".npy")).astype(np.float32)
            self._cache_put(utt_key, mel)
        return text, mel, speaker_idx

    def _cache_put(self, utt_key: UttKey, mel: np.ndarray) -> None:
        if self.cache_frames == 0:
            return
        frames = int(mel.shape[1])
        self._mel_cache[utt_key] = mel
        self._cached_frames += frames
        if self.cache_frames < 0:  # unbounded (reference behavior)
            return
        while self._cached_frames > self.cache_frames and len(self._mel_cache) > 1:
            _, evicted = self._mel_cache.popitem(last=False)
            self._cached_frames -= int(evicted.shape[1])

    def mel_length(self, utt_key: UttKey) -> int:
        """Mel frame count WITHOUT loading the mel data.

        For .npy-backed utterances only the npy header is read (the
        length-bucketing sort calls this for every utterance; loading full
        arrays here would pull the whole corpus into RAM before step 1).
        """
        cached = self._mel_lengths.get(utt_key)
        if cached is not None:
            return cached
        mel = self.id_mels.get(utt_key)
        if mel is not None:
            length = int(mel.shape[1])
        else:
            speaker_idx, utt_id = utt_key
            mels_dir = self.mel_dirs.get(speaker_idx)
            assert mels_dir, f"Missing mel for id {utt_id}, but no mels_dir"
            length = int(read_npy_shape(Path(mels_dir) / (utt_id + ".npy"))[1])
        self._mel_lengths[utt_key] = length
        return length


def read_npy_shape(path) -> tuple:
    """Array shape from a .npy header without loading the data."""
    with open(path, "rb") as f:
        version = np.lib.format.read_magic(f)
        if version == (1, 0):
            shape, _, _ = np.lib.format.read_array_header_1_0(f)
        else:
            shape, _, _ = np.lib.format.read_array_header_2_0(f)
    return shape


def _round_up(n: int, multiple: int) -> int:
    return ((n + multiple - 1) // multiple) * multiple


def collate(
    items: typing.Sequence[typing.Tuple[np.ndarray, np.ndarray, int]],
    n_frames_per_step: int = 1,
    multispeaker: bool = False,
    bucket_size_text: int = 1,
    bucket_size_mel: int = 1,
    pad_to_text: typing.Optional[int] = None,
    pad_to_mel: typing.Optional[int] = None,
) -> dict:
    """Assemble a channels-last batch dict with bucketed padding.

    Mirrors PhonemeMelCollate (dataset.py:72-116): sorts by text length
    descending, zero-pads, rounds the mel axis up to n_frames_per_step — and
    additionally rounds both axes up to bucket multiples for shape stability.

    ``pad_to_text``/``pad_to_mel`` override the local maxima (still rounded
    up to the bucket grid): multi-host runs pass the GLOBAL batch maxima so
    every host pads to the identical shape (a shape disagreement between
    hosts deadlocks the pod's all-reduce).
    """
    order = sorted(
        range(len(items)), key=lambda i: len(items[i][0]), reverse=True
    )
    items = [items[i] for i in order]

    max_text = max(len(it[0]) for it in items)
    max_text = max(max_text, pad_to_text or 0)
    max_text = _round_up(max_text, max(bucket_size_text, 1))
    max_mel = max(it[1].shape[1] for it in items)
    max_mel = max(max_mel, pad_to_mel or 0)
    max_mel = _round_up(max_mel, max(n_frames_per_step, 1))
    max_mel = _round_up(max_mel, max(bucket_size_mel, 1))

    b = len(items)
    n_mel = items[0][1].shape[0]
    x = np.zeros((b, max_text), np.int32)
    x_lengths = np.zeros((b,), np.int32)
    y = np.zeros((b, max_mel, n_mel), np.float32)
    y_lengths = np.zeros((b,), np.int32)
    speaker_ids = np.zeros((b,), np.int32) if multispeaker else None

    for i, (text, mel, speaker_idx) in enumerate(items):
        x[i, : len(text)] = text
        x_lengths[i] = len(text)
        y[i, : mel.shape[1]] = mel.T  # [n_mel, t] -> [t, n_mel] channels-last
        y_lengths[i] = mel.shape[1]
        if speaker_ids is not None:
            speaker_ids[i] = speaker_idx

    batch = {"x": x, "x_lengths": x_lengths, "y": y, "y_lengths": y_lengths}
    if speaker_ids is not None:
        batch["speaker_ids"] = speaker_ids
    return batch


class DataPipeline:
    """Epoch batch iterator: shuffling, optional length-bucketing, drop_last,
    and per-host sharding.

    ``drop_last=False`` (library use only — the CLI always drops) can yield
    a final partial batch; that is fine on a single device but does not
    split evenly over several — keep drop_last=True when training on more
    than one.

    Multi-host determinism: every host computes the identical GLOBAL batch
    plan from the shared seed and the corpus metadata (text lengths are in
    memory; mel lengths come from .npy headers) — same shuffle, same bucket
    sort, same batch order, same padded shape per step — then takes its own
    strided rows of each global batch.  This is the property the reference
    gets from DistributedSampler's rank-strided same-everywhere schedule
    (reference __main__.py:235); without it, hosts can disagree on padded
    shapes in the same step and hang the pod's all-reduce."""

    def __init__(
        self,
        dataset: PhonemeMelDataset,
        config: TrainingConfig,
        batch_size: typing.Optional[int] = None,
        seed: typing.Optional[int] = None,
        bucket_by_length: bool = True,
        drop_last: bool = True,
        num_shards: int = 1,
        shard_index: int = 0,
    ):
        self.dataset = dataset
        self.config = config
        self.batch_size = batch_size or config.batch_size
        self.seed = config.seed if seed is None else seed
        self.bucket_by_length = bucket_by_length
        self.drop_last = drop_last
        self.num_shards = num_shards
        self.shard_index = shard_index
        self.epoch = 0

    def __len__(self) -> int:
        n = len(self.dataset.ids)
        global_batch = self.batch_size * self.num_shards
        if self.drop_last or self.num_shards > 1:
            return n // global_batch
        return (n + global_batch - 1) // global_batch

    def _global_plan(self, rng) -> typing.List[typing.List[UttKey]]:
        """The epoch's global batch schedule — identical on every host."""
        ids = list(self.dataset.ids)
        rng.shuffle(ids)
        global_batch = self.batch_size * self.num_shards
        leftover = len(ids) % global_batch
        # Drop the leftover BEFORE the bucket sort: post-shuffle the tail is
        # a random subset, so no fixed set of utterances (previously: always
        # the longest ones) is excluded every epoch.  Multi-host always
        # drops — a partial batch can't split evenly across hosts.
        if leftover and (self.drop_last or self.num_shards > 1):
            ids = ids[:-leftover]

        if self.bucket_by_length:
            # sort by mel length, batch neighbors, shuffle batch order:
            # minimizes padding waste while keeping epoch-level randomness
            ids.sort(key=self.dataset.mel_length)

        plan = [
            ids[i : i + global_batch]
            for i in range(0, len(ids), global_batch)
        ]
        rng.shuffle(plan)
        return plan

    def _batch_pad(self, batch_ids) -> typing.Tuple[int, int]:
        """Global pad targets (t_x, t_y) for one global batch — metadata
        only (text lengths in memory, mel lengths from .npy headers)."""
        pad_text = max(len(self.dataset.id_phonemes[k]) for k in batch_ids)
        pad_mel = max(self.dataset.mel_length(k) for k in batch_ids)
        return pad_text, pad_mel

    def batches(self) -> typing.Iterator[dict]:
        """One epoch of host batches.  Reshuffles every call (the reference
        leaves sampler.set_epoch commented out, train.py:101 — same order
        every epoch; we fix that)."""
        rng = np.random.default_rng(self.seed + self.epoch)
        self.epoch += 1
        m = self.config.model
        for batch_ids in self._global_plan(rng):
            # pad targets from the GLOBAL batch so every host's shard of it
            # collates to the same (t_x, t_y)
            pad_text, pad_mel = self._batch_pad(batch_ids)
            local_ids = batch_ids[self.shard_index :: self.num_shards]
            items = [self.dataset.get(k) for k in local_ids]
            yield collate(
                items,
                n_frames_per_step=m.n_frames_per_step,
                multispeaker=self.dataset.multispeaker,
                bucket_size_text=self.config.bucket_size_text,
                bucket_size_mel=self.config.bucket_size_mel,
                pad_to_text=pad_text,
                pad_to_mel=pad_mel,
            )

    def epoch_shapes(self, epoch: typing.Optional[int] = None):
        """Distinct collated batch shapes of one epoch WITHOUT loading any
        mel data: sorted set of (local_batch, t_x, t_y).

        Every shape a step will see is determined by the global batch plan
        plus the collate rounding rules, so a train loop can size its
        buffers for all of them up front.  Shape-only peek: does not advance the epoch
        counter.
        """
        m = self.config.model
        rng = np.random.default_rng(
            self.seed + (self.epoch if epoch is None else epoch)
        )
        shapes = set()
        for batch_ids in self._global_plan(rng):
            pad_text, pad_mel = self._batch_pad(batch_ids)
            t_x = _round_up(pad_text, max(self.config.bucket_size_text, 1))
            t_y = _round_up(pad_mel, max(m.n_frames_per_step, 1))
            t_y = _round_up(t_y, max(self.config.bucket_size_mel, 1))
            b_local = len(batch_ids) // self.num_shards
            shapes.add((b_local, t_x, t_y))
        return sorted(shapes)

    __iter__ = batches
