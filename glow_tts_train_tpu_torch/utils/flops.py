"""Analytic FLOP counts of a Glow-TTS train step, the counterpart of
glow_tts_train_tpu ``utils/flops.py``: the same counts, read from the
port's ``GlowTTSHyper``.

Counts multiply-accumulate-dominated ops (convs, matmuls, attention) as
2·MACs; elementwise work is ignored (it is bandwidth-, not FLOP-bound).
The structure mirrors the training forward graph (``models/glow_tts.py``
``forward_train``):

    encoder (prenet → rel-pos attention stack → heads)
    flow decoder (n_blocks × [actnorm, invconv, coupling(WN)])
    pairwise log-likelihood matmul decomposition + stat expansion

``t_y`` counts mel frames before the squeeze.  ``training_flops`` is
forward + backward (≈2× the forward's matmul work) + the flow decoder's
forward once more where ``wn_residuals`` is "recompute": the recompute
backwards (``gtt_block_bwd``, ``gtt_wn_bwd`` and their bf16 versions) run
the forward again inside the backward call (op by op only the WN stack's,
so there the count is a small overcount, as JAX counts its "xin" remat).
``model_flops`` never counts a recompute.
"""


def _conv_flops(b: int, t: int, k: int, c_in: int, c_out: int) -> float:
    return 2.0 * b * t * k * c_in * c_out


def encoder_forward_flops(hp, b: int, t_x: int) -> float:
    h = hp.h_enc
    total = 0.0
    if hp.prenet:
        # 3 × (k=5 conv h→h) + 1×1 proj
        total += 3 * _conv_flops(b, t_x, 5, h, h)
        total += _conv_flops(b, t_x, 1, h, h)
    d_head = h // hp.n_heads
    for _ in range(hp.n_layers_enc):
        # q,k,v,o projections
        total += 4 * _conv_flops(b, t_x, 1, h, h)
        # scores QK^T and attn·V — 2 each of [t_x,d]×[d,t_x] per head
        total += 2 * (2.0 * b * hp.n_heads * t_x * t_x * d_head)
        if hp.window_size is not None:
            # rel-pos: Q·rel_k and weights·rel_v
            total += 2 * (2.0 * b * hp.n_heads * t_x * t_x * d_head)
        # conv FFN h→filter→h with kernel_size
        total += _conv_flops(b, t_x, hp.kernel_size, h, hp.filter_channels)
        total += _conv_flops(b, t_x, hp.kernel_size, hp.filter_channels, h)
    # heads: proj_m (+ proj_s), duration predictor (2 convs + proj)
    total += _conv_flops(b, t_x, 1, h, hp.out_channels)
    if not hp.mean_only:
        total += _conv_flops(b, t_x, 1, h, hp.out_channels)
    dp_in = h + hp.gin_channels
    total += _conv_flops(b, t_x, hp.kernel_size, dp_in, hp.filter_channels_dp)
    total += _conv_flops(b, t_x, hp.kernel_size, hp.filter_channels_dp, hp.filter_channels_dp)
    total += _conv_flops(b, t_x, 1, hp.filter_channels_dp, 1)
    return total


def decoder_forward_flops(hp, b: int, t_y: int) -> float:
    t_c = t_y // hp.n_sqz  # squeezed time axis
    c = hp.out_channels * hp.n_sqz  # squeezed channels
    h = hp.h_dec
    per_block = 0.0
    # invconv: grouped 1×1 over n_split channels
    per_block += 2.0 * b * t_c * c * hp.n_split
    # coupling: start 1×1 c/2→h, WN stack, end 1×1
    per_block += _conv_flops(b, t_c, 1, c // 2, h)
    for _ in range(hp.n_block_layers):
        per_block += _conv_flops(b, t_c, hp.kernel_size_dec, h, 2 * h)
        per_block += _conv_flops(b, t_c, 1, h, 2 * h)  # res+skip
    per_block += _conv_flops(b, t_c, 1, h, c)  # end (m, logs)
    if hp.gin_channels:
        # the speaker conditioning is a per-utterance vector: its conv runs
        # on g of time-length 1 and broadcasts over t
        per_block += _conv_flops(b, 1, 1, hp.gin_channels, 2 * h * hp.n_block_layers)
    return per_block * hp.n_blocks_dec


def alignment_flops(hp, b: int, t_x: int, t_y: int) -> float:
    """logp's 4-term matmul decomposition + the z_m/z_logs expansion: four
    [t_x, c]×[c, t_y]-shaped products."""
    c = hp.out_channels
    return 4 * (2.0 * b * t_x * t_y * c)


def forward_flops(hp, b: int, t_x: int, t_y: int) -> float:
    return (
        encoder_forward_flops(hp, b, t_x)
        + decoder_forward_flops(hp, b, t_y)
        + alignment_flops(hp, b, t_x, t_y)
    )


def training_flops(hp, b: int, t_x: int, t_y: int) -> float:
    """FLOPs one train step executes: forward + backward (≈2× the forward's
    matmul work) + the flow decoder's forward again where the backward
    recomputes it (``wn_residuals: "recompute"``)."""
    total = 3.0 * forward_flops(hp, b, t_x, t_y)
    if hp.wn_residuals == "recompute":
        total += decoder_forward_flops(hp, b, t_y)
    return total


def model_flops(hp, b: int, t_x: int, t_y: int) -> float:
    """Useful model FLOPs a step (the MFU numerator): forward + the 2×
    forward backward, never a recompute (overhead the implementation
    chose, not model work).  Equals ``training_flops`` in store mode."""
    return 3.0 * forward_flops(hp, b, t_x, t_y)
