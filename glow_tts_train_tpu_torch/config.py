"""Configuration dataclasses with JSON overlay merging.

The port's own copy of the JAX package's schema
(``glow_tts_train_tpu/config.py``): the same field names, defaults and
nested structure, so one JSON file configures both packages and
``dataclasses.asdict`` of the two loads is equal.  Stdlib ``dataclasses``
only.  Fields that steer the JAX package's TPU graph (``unroll_blocks``,
``remat_*``, ``prng_impl``, ``mesh_axis``, ``scoped_vmem_limit_kib``)
are carried so configs round-trip; the port reads ``checkpoint_format``
(the trainer refuses any value but "npz"),
``encoder_fuse``, the decoder-mode keys ``wn_residuals`` and
``flow_block_fuse`` (``models.hyper_from_config`` resolves their "auto",
and refuses ``wn_impl: "xla"`` and ``flow_block_fuse_reverse: false``,
which the port has no second path for), ``fp16_run``,
``grad_accum_steps`` and the shared training, bucketing and data fields.
"""

import collections.abc
import dataclasses
import json
import typing
from dataclasses import dataclass, field
from pathlib import Path


def _from_dict(cls, data: typing.Mapping) -> typing.Any:
    """Build a dataclass from a dict, recursing into nested dataclass
    fields.  Unknown keys are ignored (tolerant load)."""
    kwargs = {}
    for f in dataclasses.fields(cls):
        if f.name not in data:
            continue
        value = data[f.name]
        if dataclasses.is_dataclass(f.type) and isinstance(value, dict):
            value = _from_dict(f.type, value)
        elif f.name == "betas" and isinstance(value, (list, tuple)):
            value = tuple(value)
        kwargs[f.name] = value
    return cls(**kwargs)


@dataclass
class AudioConfig:
    filter_length: int = 1024
    hop_length: int = 256
    win_length: int = 1024
    mel_channels: int = 80
    sample_rate: int = 22050
    sample_bytes: int = 2
    channels: int = 1
    mel_fmin: float = 0.0
    mel_fmax: typing.Optional[float] = 8000.0
    ref_level_db: float = 20.0
    spec_gain: float = 1.0

    # Normalization
    signal_norm: bool = True
    min_level_db: float = -100.0
    max_norm: float = 1.0
    clip_norm: bool = True
    symmetric_norm: bool = True
    do_dynamic_range_compression: bool = True
    convert_db_to_amp: bool = True

    def to_dict(self) -> dict:
        return dataclasses.asdict(self)

    @staticmethod
    def from_dict(data: typing.Mapping) -> "AudioConfig":
        return _from_dict(AudioConfig, data)


@dataclass
class ModelConfig:
    num_symbols: int = 0
    hidden_channels: int = 192
    filter_channels: int = 768
    filter_channels_dp: int = 256
    kernel_size: int = 3
    p_dropout: float = 0.1
    n_blocks_dec: int = 12
    n_layers_enc: int = 6
    n_heads: int = 2
    p_dropout_dec: float = 0.05
    dilation_rate: int = 1
    kernel_size_dec: int = 5
    n_block_layers: int = 4
    n_sqz: int = 2
    prenet: bool = True
    mean_only: bool = True
    hidden_channels_enc: int = 192
    hidden_channels_dec: int = 192
    window_size: int = 4
    n_speakers: int = 1
    n_split: int = 4
    sigmoid_scale: bool = False
    block_length: typing.Optional[int] = None
    gin_channels: int = 0
    n_frames_per_step: int = 1

    def to_dict(self) -> dict:
        return dataclasses.asdict(self)

    @staticmethod
    def from_dict(data: typing.Mapping) -> "ModelConfig":
        return _from_dict(ModelConfig, data)


@dataclass
class TrainingConfig:
    seed: int = 1234
    epochs: int = 10000
    learning_rate: float = 1e0
    betas: typing.Tuple[float, float] = field(default=(0.9, 0.98))
    eps: float = 1e-9
    grad_clip: float = 5.0
    warmup_steps: int = 4000
    scheduler: str = "noam"
    batch_size: int = 32
    fp16_run: bool = False  # bf16 compute: bf16 activations and products, f32 params and losses
    min_seq_length: typing.Optional[int] = None
    max_seq_length: typing.Optional[int] = None
    audio: AudioConfig = field(default_factory=AudioConfig)
    model: ModelConfig = field(default_factory=ModelConfig)
    version: int = 1
    git_commit: str = ""

    # Length-bucket granularity of the batches (phoneme axis / mel-frame
    # axis): coarser buckets mean fewer distinct shapes and more padding.
    bucket_size_text: int = 32
    bucket_size_mel: int = 128
    mesh_axis: str = "data"
    # Microbatches per optimizer step: exact accumulation over row slices.
    grad_accum_steps: int = 1
    unroll_blocks: typing.Union[bool, str] = "auto"
    remat_blocks: typing.Union[bool, str] = "auto"
    remat_encoder: typing.Union[bool, str] = False
    checkpoint_format: str = "npz"
    prng_impl: str = "rbg"
    # Batches to prepare (mel loads, collate, host-to-device copy) ahead
    # of the step on a background thread; 0 disables prefetch.
    prefetch_batches: int = 2
    # The WN stack of the op-by-op decoder: "pallas" (the port's WN
    # kernels; "auto").  The port refuses "xla".
    wn_impl: str = "auto"
    # Backward of the WN stack, alone or inside a flow block: "store" ("auto")
    # saves the per-layer inputs and gates in forward, "recompute" re-runs
    # the forward inside the backward and holds one block's at a time.
    wn_residuals: str = "auto"
    # Each training-forward flow block as one kernel ("auto": true); false
    # runs ActNorm, InvConvNear and the coupling op by op around the WN stack.
    flow_block_fuse: typing.Union[bool, str] = "auto"
    # Each inverse (serving) flow block as one kernel ("auto": true); the
    # port refuses false.
    flow_block_fuse_reverse: typing.Union[bool, str] = "auto"
    # The text side through its kernels: each encoder layer, the prenet and
    # the duration-predictor stack.  "auto" -> true when the model uses the
    # configuration the encoder kernel takes (window_size set, no
    # block_length); True/False force.
    encoder_fuse: typing.Union[bool, str] = "auto"
    # Host-RAM budget for lazily loaded .npy mels, in total cached frames
    # (bytes ~= frames * mel_channels * 4); least-recently-used mels are
    # evicted past it.  0 disables caching, -1 caches without bound.
    mel_cache_frames: int = 500_000
    scoped_vmem_limit_kib: int = 65536

    def to_dict(self) -> dict:
        d = dataclasses.asdict(self)
        d["betas"] = list(self.betas)
        return d

    @staticmethod
    def from_dict(data: typing.Mapping) -> "TrainingConfig":
        return _from_dict(TrainingConfig, data)

    def save(self, config_file: typing.TextIO) -> None:
        """Save config as JSON to a file."""
        json.dump(self.to_dict(), config_file, indent=4)

    @staticmethod
    def load(config_file: typing.TextIO) -> "TrainingConfig":
        """Load config from a JSON file."""
        return TrainingConfig.from_dict(json.load(config_file))

    @staticmethod
    def load_and_merge(
        config: "TrainingConfig",
        config_files: typing.Iterable[typing.Union[str, Path, typing.TextIO]],
    ) -> "TrainingConfig":
        """Overlay one or more JSON config files onto an existing config."""
        base_dict = config.to_dict()
        for maybe_config_file in config_files:
            if isinstance(maybe_config_file, (str, Path)):
                config_file = open(maybe_config_file, "r")
            else:
                config_file = maybe_config_file

            with config_file:
                new_dict = json.load(config_file)
                TrainingConfig.recursive_update(base_dict, new_dict)

        return TrainingConfig.from_dict(base_dict)

    @staticmethod
    def recursive_update(
        base_dict: typing.Dict[typing.Any, typing.Any],
        new_dict: typing.Mapping[typing.Any, typing.Any],
    ) -> None:
        """Recursively overwrite values in ``base_dict`` with ``new_dict``."""
        for k, v in new_dict.items():
            if isinstance(v, collections.abc.Mapping) and (
                base_dict.get(k) is not None
            ):
                TrainingConfig.recursive_update(base_dict[k], v)
            else:
                base_dict[k] = v


def load_config(paths: typing.Sequence = ()) -> TrainingConfig:
    """The defaults merged with each JSON file of ``paths`` in order."""
    config = TrainingConfig()
    if paths:
        config = TrainingConfig.load_and_merge(config, [Path(p) for p in paths])
    return config
