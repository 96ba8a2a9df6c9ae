"""Analytic FLOP counts of Glow-TTS, the numerator of every ``mfu`` and
peak share.

A frozen copy of ``glow_tts_train_tpu_torch/utils/flops.py`` at commit
fd792a0 (its JAX twin agreed with XLA's cost analysis to 0.998-1.007).
What changed: it reads the plain dict of ``weights.hyper`` instead of the
port's ``GlowTTSHyper``, and the utterance-level helpers at the end count
each utterance at its own ``t_x``, ``t_y``, so padding is not counted as
work.  Multiply-accumulates count 2; elementwise work is not counted.
"""

# dense peaks of one NVIDIA H100 SXM (data sheet, without sparsity)
PEAK_FLOPS = {"bf16": 989e12, "tf32": 495e12, "fp32": 67e12}


def _conv(b, t, k, c_in, c_out) -> float:
    return 2.0 * b * t * k * c_in * c_out


def encoder_forward(hp: dict, b: int, t_x: int) -> float:
    h = hp["hidden_channels"]
    total = 0.0
    if hp["prenet"]:
        total += 3 * _conv(b, t_x, 5, h, h) + _conv(b, t_x, 1, h, h)
    heads = hp["n_heads"]
    d = h // heads
    for _ in range(hp["n_layers_enc"]):
        total += 4 * _conv(b, t_x, 1, h, h)
        total += 2 * (2.0 * b * heads * t_x * t_x * d)
        if hp["window_size"] is not None:
            total += 2 * (2.0 * b * heads * t_x * t_x * d)
        total += _conv(b, t_x, hp["kernel_size"], h, hp["filter_channels"])
        total += _conv(b, t_x, hp["kernel_size"], hp["filter_channels"], h)
    out = hp["mel_channels"]
    total += _conv(b, t_x, 1, h, out)
    if not hp["mean_only"]:
        total += _conv(b, t_x, 1, h, out)
    gin = hp["gin_channels"] if hp["n_speakers"] > 1 else 0
    fdp = hp["filter_channels_dp"]
    total += _conv(b, t_x, hp["kernel_size"], h + gin, fdp)
    total += _conv(b, t_x, hp["kernel_size"], fdp, fdp)
    total += _conv(b, t_x, 1, fdp, 1)
    return total


def decoder_forward(hp: dict, b: int, t_y: int) -> float:
    t_c = t_y // hp["n_sqz"]
    c = hp["mel_channels"] * hp["n_sqz"]
    h = hp["hidden_channels"]
    per_block = 2.0 * b * t_c * c * hp["n_split"]
    per_block += _conv(b, t_c, 1, c // 2, h)
    for _ in range(hp["n_block_layers"]):
        per_block += _conv(b, t_c, hp["kernel_size_dec"], h, 2 * h)
        per_block += _conv(b, t_c, 1, h, 2 * h)
    per_block += _conv(b, t_c, 1, h, c)
    gin = hp["gin_channels"] if hp["n_speakers"] > 1 else 0
    if gin:
        per_block += _conv(b, 1, 1, gin, 2 * h * hp["n_block_layers"])
    return per_block * hp["n_blocks_dec"]


def alignment(hp: dict, b: int, t_x: int, t_y: int) -> float:
    return 4 * (2.0 * b * t_x * t_y * hp["mel_channels"])


def model_flops(hp: dict, b: int, t_x: int, t_y: int) -> float:
    """Useful FLOPs of a train step: forward + the 2x-forward backward."""
    return 3.0 * (encoder_forward(hp, b, t_x) + decoder_forward(hp, b, t_y)
                  + alignment(hp, b, t_x, t_y))


def train_flops(hp: dict, x_lengths, y_lengths) -> float:
    """A batch's useful FLOPs, each utterance at its own lengths."""
    return sum(model_flops(hp, 1, int(tx), int(ty)) for tx, ty in zip(x_lengths, y_lengths))


def synth_flops(hp: dict, x_lengths, y_lengths) -> float:
    """A call's forward FLOPs: the encoder and the inverse decoder, each
    sentence at its own lengths."""
    return sum(encoder_forward(hp, 1, int(tx)) + decoder_forward(hp, 1, int(ty))
               for tx, ty in zip(x_lengths, y_lengths))
