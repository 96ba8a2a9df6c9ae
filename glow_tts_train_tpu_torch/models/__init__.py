"""The Glow-TTS generation graph of the port."""

from .glow_tts import (  # noqa: F401
    GlowTTS,
    GlowTTSHyper,
    ServingWeights,
    encoder_forward,
    forward_gen,
    hyper_from_config,
    store_inverse,
)
