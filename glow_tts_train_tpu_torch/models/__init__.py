"""The Glow-TTS graph of the port: generation and training."""

from .glow_tts import (  # noqa: F401
    GlowTTS,
    GlowTTSHyper,
    ServingWeights,
    ddi_init,
    encoder_forward,
    forward_gen,
    forward_train,
    hyper_from_config,
    init_model,
    store_inverse,
)
