"""Data loading: phoneme CSVs, JSONL / .npy mels, length-bucketed batching."""

from .corpus import (  # noqa: F401
    CorpusError,
    MissingMelsError,
    SpeakerSource,
    build_dataset,
    detect_num_symbols,
)
from .dataset import (  # noqa: F401
    DataPipeline,
    PhonemeMelDataset,
    collate,
    load_mels,
    load_phonemes,
)
