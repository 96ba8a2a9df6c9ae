#!/usr/bin/env python3
"""Smoke test of the PyTorch/CUDA port (glow_tts_train_tpu_torch) on one
NVIDIA GPU.

    python3 chip_smoke.py        # from the repository root, one GPU

Phases, each fatal on failure:

1. builds the CUDA kernels from ``glow_tts_train_tpu_torch/csrc`` with
   nvcc for sm_90a; then holds the two tensor-core device kernels alone
   (``csrc/tc_gemm.cu``: the wgmma conv-GEMM and the wgmma
   weight-gradient GEMM, both 3xTF32) at every product of one flow block at
   [16, 704, .]: against float64 of the same operands within PRODUCT_RTOL
   and against the plain emulation of the split, beside the CUDA-core
   kernel's error and time, with ms and achieved TFLOP/s (the in-layer
   conv also by the TMA-fed kernel the WN forward chains take, beside the
   tap-by-tap one); and the
   conv-GEMM at the encoder layer's products at [16, 192, .], [16, 64, .]
   and serving b=4 [4, 250, .], and at the serving flow block's products
   at b=1 [160, .] and [832, .], three ways (the tensor cores over the
   whole K walk, what the chain takes: split-K where it makes fewer waves,
   for the serving chain at any row count and in 64-row tiles where
   128-row ones are too few blocks, and the CUDA cores), each against
   float64 (max and mean signed error) with its device time; and the bf16
   products of the flow block's rows at [32, 704] and of the text rows
   (the encoder layer's, the prenet's, the duration stack's) at [32, 192]
   (the latter by the text chains' plan: chunks a tile and split-K
   shares), each on the mma.sync kernel and on the
   TMA-fed wgmma one, against float64, with device us and TFLOP/s;
2. writes a checkpoint at the full width of ``configs/base.json`` in the
   JAX package's ``.npz`` format, with random non-zero weights from a
   numpy seed (duration bias log 6: about 6 frames per phoneme);
3. serves 4 requests (48, 96, 160 and 250 phonemes) through the port's
   inference CLI entry point, ``glow_tts_train_tpu_torch.infer.main``,
   once at ``--batch-size 1`` and once at ``--batch-size 4``; checks the
   mels (finite, [80, t]) and each kernel's launch count, prints which
   device kernel each pass's products took, and checks that no product
   split its weights during a synthesis (the serving blocks' weights are
   split once at load, the text chains' once a call);
4. holds each kernel against its plain PyTorch version on the card, on the
   inputs the batch-4 pass gave it, and the whole batch-4 mel of the
   kernel path against the plain path on the CPU; the serving flow block
   also on the inputs of the first and the last b=1 request (48 and 250
   phonemes), each call's products against the serving plan
   (``tc_gemm.block_inverse_products``), and its weights' splits made at
   load against the split kernel's bits;
5. times each kernel against its plain version with CUDA events;
6. times whole syntheses through ``build_synthesizer`` (the CLI's synth
   without stdin or JSON), kernel path against plain path on the card,
   and profiles one to read the device's busy time and idle share;
7. trains at the full width of ``configs/base.json`` (``encoder_fuse:
   "auto"``, which resolves to the text kernels; ``fp16_run: false``,
   batch 16, dropout on) through the port's train CLI entry point,
   ``glow_tts_train_tpu_torch.__main__.main``, on a 64-utterance corpus
   from ``scripts/make-synthetic-corpus.py``: DDI, then 2 epochs of 4
   steps; checks every loss and grad norm, that the loss falls, each
   training kernel's launch count (WN forward once per block in DDI; per
   step the block forward-save and backward-store once per block, MAS
   once, the prenet and the duration stack forward and backward once each,
   the encoder layer forward and backward once per layer), and serves one
   request from the last checkpoint through the infer CLI; then one step
   at ``grad_accum_steps: 2`` from a copy of the run's last state on its
   last batch against the full-batch step from another copy (each kernel
   launched once a slice; the paths MAS gives each way compared, and the
   accumulation held within the JAX package's tolerances on the full
   batch's alignment; both step times); then through the train CLI 1
   epoch, its checkpoint and 1 epoch resumed from it (params, Adam moments
   and count, global step) against the 2-epoch run: the checkpoints, every
   resumed step's loss and the metrics line equal bit for bit; then 2 steps
   with ``encoder_fuse: false`` (the op-by-op text side; 2 encoder layers,
   4 blocks), which launch no text kernel;
8. holds each training kernel against its plain version on inputs that
   run recorded in its last step (a backward against autograd of the plain
   forward with the same dropout seed and, for the text stacks, at the
   kernel's own ReLU gates, which are themselves compared; the text
   stacks' forward kernels again with dropout on; MAS bit for bit, also at
   a long shape the TPU streams, with tied scores at text widths around
   its lanes and bands, and at texts past the short path's ring (t_x 1,345,
   2,600 and 4,096: the long path, timed against its bound), and its cost
   a mel frame) and times both with CUDA events, and the train step;
9. trains the same 8 steps (same corpus, seed and dropout seeds) through
   the train CLI in each of the decoder's other modes: the fused block
   with ``wn_residuals: recompute`` (per step the block forward and the
   recompute backward once per block, no forward-save or backward-store),
   ``flow_block_fuse: false`` with ``wn_residuals: store`` (the WN
   forward-save and backward-store once per block) and with ``recompute``
   (the WN forward with dropout and the WN recompute backward once per
   block); checks the launch counts, that the loss falls over the epochs,
   and every step's loss against the main run's (the modes compute one
   function: recompute against store to the bit, op by op against fused
   within MODE_LOSS_RTOL); serves one of those checkpoints through the
   infer CLI;
10. holds each of those kernels against its plain version on the inputs
    the runs recorded in their last step, a recompute backward also
    against the store backward on the same inputs (equal bits), and times
    them; the four backwards of the flow decoder (rows 7, 8, 11, 12: the WN
    reverse walk alone or in the block) are held to their plan
    (``tc_gemm.walk_products``: device operations a call and products, the
    tap-staged transposed convs, the bias rows, dW_in from d_xin's split),
    and a profiled ``wn_bwd_store`` call gives the device time of one
    layer's four walk products (``product wn_walk`` lines) and fails the run
    if a weight split (beyond the call's one) or a column sum runs in it;
    the four forwards (rows 5, 6, 9, 10) are held to theirs
    (``tc_gemm.forward_products``: device operations a call, the one
    weight-split launch first, the TMA-fed in-layer convs), and a profiled
    ``wn_fwd_save`` call gives the device time of one layer's two products
    and of the call's split and copy (``product wn_fwd`` lines);
11. times the train step and reads its peak device memory in the four
    decoder configurations, from one init in one process, in turns, and
    holds the four loss trajectories together as in 9;
12. (between 8 and 9) trains in bf16: ``configs/base.json`` as shipped
    (``fp16_run: true``, batch 32, full width; its epochs cut to 2)
    through the train CLI on the same corpus: DDI (in f32, as the JAX
    package does it), 2 epochs of 2 steps, each bf16 kernel launched once
    a step (the 12 blocks' forward-save and backward-store, the 6 encoder
    layers', the prenet's and the duration stack's forward and backward)
    and no f32 training kernel; 1 epoch, its checkpoint and 1 resumed
    epoch equal to the 2-epoch run bit for bit; one profiled bf16 step
    (its products all on the bf16 kernels but the 12 folded-A products,
    every product of the flow block's, the encoder layer's, the prenet's
    and the duration stack's chains on the TMA-fed wgmma ones, none on the
    mma.sync ones);
    each bf16 kernel against its plain bf16 version on the last step's
    inputs within BF16_KERNEL_RTOL (backwards at the kernel's own ReLU
    gates), timed, its device time from a trace bracketed by spin
    kernels, with its bound at the dense BF16 peak, every bf16 row also
    with its products on the mma.sync kernels and on the TMA-fed ones in
    turns, the text rows' product counts and device operations held to
    their plan and BF16_REPEATS calls of each giving the same bits; then
    the bf16 step against the f32 step from one init, on the same batches and
    dropout seeds, step by step on the f32 step's alignment (losses within
    BF16_LOSS_RTOL, the grad norm within BF16_GRAD_NORM_RTOL, bf16's own
    alignment within BF16_PATH_SCORE_RTOL of f32's optimum), and both steps in turns at batch
    32: step ms quartiles, peak device memory, a profiled step each;
13. (after 12) trains in bf16 in all four decoder modes through the train
    CLI, ``configs/base.json`` as shipped but its warm-up cut to 200 steps
    (BF16_MODE_OVERRIDE), 2 epochs of 2 steps from one init: each mode's
    bf16 decoder kernels launched 12 times a step and no other decoder
    kernel (DDI's f32 WN forward aside), the MLE loss falling, fused recompute's
    losses fused store's and op-by-op recompute's op-by-op store's to the
    bit, op by op's first step within MODE_LOSS_RTOL_BF16 of fused (its MLE
    loss within MODE_MLE_RTOL_BF16); each run's checkpoint serves; each of the
    six bf16 kernels of those modes (rows 5-9, 11) against its plain bf16
    version on the inputs of its run's last step, a forward that saves
    nothing against the forward-save's bits and a recompute backward against
    the store backward's, timed, its device time and operations from a
    bracketed trace held to ``tc_gemm.bf16_block_products``, its bound at
    the dense BF16 peak; then the four bf16 modes from one init in one
    process, in turns (as 11, as shipped): 34 steps each, recompute's losses
    store's to the bit (the bf16 TMA kernels' second path), op by op's first
    4 within the same bounds of fused, step ms, peak memory over resident
    and device busy of each;
14. (last) exports the trained checkpoint of 7 through the export CLI in
    its three formats (``pt2``, ``onnx``, ``torch``; the ``.pt2`` checked
    on the card by the CLI) and holds what serves them against the infer
    CLI on the checkpoint, all at noise 0: the 4 requests through
    ``infer_export`` on the ``.pt2`` on the card and through the ``.pth``
    in the infer CLI (bit for bit), the 48-phoneme one through the
    ``.onnx`` on the host, each mel within EXPORT_MEL_RTOL of max |mel|
    with the live path's frame count; counts the live path's four serving
    kernels (once a request each) and the artifacts' (none: plain graphs);
    the ``.pt2``'s seed contract at noise 0.667, its load time, and its ms
    a request against the live path's; then a multispeaker voice at the
    width of ``configs/multispeaker.json`` (random weights, speaker
    EXPORT_SPEAKER baked into a ``.pt2``) against live ``infer --speaker``
    on the card.

The profiled train step also counts its device products: every product the
block chains send to the tensor cores must run there (10 conv-GEMMs per
block forward, 12 conv-GEMMs and 11 weight gradients per block backward),
none declined, and the encoder layers', the prenet's and the duration
stack's where the batch's rows fill the card (encoder: 4 conv-GEMMs per
forward, 8 and 4 weight gradients per backward; prenet: 4, and 8 and 4;
duration stack: 2, and 4 and 2, at [16, 192]); the text stacks' forward
and backward kernels are held to the same counts per call and each
backward's recomputed output to its forward kernel's bits.

Each kernel's line in ``{"kernels": [...]}`` carries its bound on this
card: the larger of its bytes (every input read once, every output written
once, from the tensors of the timed call; for MAS what the data needs:
logp in the samples' length rectangles, the mask's first column and row,
the whole path) over 3.35 TB/s and its
operations (from the shapes of that call, ``kernel_flops``) over 165
TFLOP/s where the call's products ran on the tensor cores (a third of the
TF32 peak: three passes a product; ``bound_by`` "operations, 3xTF32") or
over the 67 TFLOP/s of the CUDA cores where they did not, and for the
bf16 kernels (``<name>_bf16``) over the dense BF16 peak, 989 TFLOP/s
(``bound_by`` "operations, bf16"); a kernel faster
than its bound fails the run; and ``library_ms`` null: no single PyTorch call computes any of
these functions (a whole conv/LayerNorm stack, a layer with rel-pos band
terms, a flow block, a monotonic alignment).

Prints the GPU's name and power limit, a ``{"products": [...]}``, a
``{"decoder_modes": {...}}``, a ``{"train_bf16": {...}}``, an
``{"export": {...}}`` and a ``{"kernels": [...]}`` JSON line, and last ``{"ok": true, "device": {...}}``.  Exits non-zero without a GPU
or outside a checkout of the repository.
"""

import contextlib
import copy
import io
import json
import math
import statistics
import subprocess
import sys
import tempfile
import time
from pathlib import Path

SEED = 0
REQUEST_LENGTHS = (48, 96, 160, 250)
# the device the kernel path runs on
PLATFORM = "cuda"
# kernel vs plain version on the card, both f32: they differ only in
# summation order (the kernels' tiled FMA chains vs cuBLAS), so max abs
# error must stay within 1e-4 of the output's max magnitude
KERNEL_RTOL = 1e-4
# whole mel, kernels on the card vs plain path on the CPU: 6 encoder
# layers and 12 inverse flow blocks of f32 GEMMs in different summation
# orders, the inverse flow scaling by exp(-logs) per block
MEL_RTOL = 1e-3
TIMED_RUNS = 30
# whole syntheses: phoneme counts per batch; median of SYNTH_RUNS calls
# after 3 warm-ups, kernel and plain path in turns (kernel, plain, plain,
# kernel)
SERVE_BATCHES = {
    "b1_48": (48,), "b1_250": (250,), "b4_mix": REQUEST_LENGTHS, "b8_160": (160,) * 8,
}
SYNTH_RUNS = 10
PROFILED = ("b1_48", "b1_250", "b4_mix")
# exported voices against the live kernel path at noise 0: the serving
# tolerance (PERF.md section 2) of max |mel|; a request's time, median of
# this many calls by CUDA events; the speaker baked into the multispeaker voice
EXPORT_MEL_RTOL = 1e-3
EXPORT_TIMED_RUNS = 10
EXPORT_SPEAKER = 7

# training: 64 utterances, batch 16, 2 epochs -> 8 steps after DDI
TRAIN_UTTERANCES = 64
TRAIN_OVERRIDE = {"fp16_run": False, "batch_size": 16, "epochs": 2, "warmup_steps": 50}
TRAIN_STEPS = 8
# the op-by-op text side keeps working: 1 epoch of 2 steps at batch 32, depth cut
UNFUSED_OVERRIDE = {
    "encoder_fuse": False, "fp16_run": False, "batch_size": 32, "epochs": 1,
    "warmup_steps": 50, "model": {"n_layers_enc": 2, "n_blocks_dec": 4},
}
UNFUSED_STEPS = 2
# the decoder's other modes train the main run's steps again
DECODER_MODES = {
    "fused_recompute": {"flow_block_fuse": True, "wn_residuals": "recompute"},
    "unfused_store": {"flow_block_fuse": False, "wn_residuals": "store"},
    "unfused_recompute": {"flow_block_fuse": False, "wn_residuals": "recompute"},
}
# launches per block and step of each decoder kernel in each mode (the default
# mode, fused_store, is the main training run)
MODE_LAUNCHES = {
    "fused_store": {"block_fwd_save": 1, "block_bwd_store": 1},
    "fused_recompute": {"block_fwd": 1, "block_bwd": 1},
    "unfused_store": {"wn_fwd_save": 1, "wn_bwd_store": 1},
    "unfused_recompute": {"wn_forward": 1, "wn_bwd": 1},
}
DECODER_KERNELS = ("wn_forward", "wn_fwd_save", "wn_bwd_store", "wn_bwd",
                   "block_fwd", "block_fwd_save", "block_bwd_store", "block_bwd")
# the loss of a step in two modes from one init, batch and dropout seeds:
# store against recompute (same launches on the same inputs) is equal to the
# bit; the op-by-op decoder against the fused block differs by the
# summation order of the folds, and the difference grows with the updates,
# so it is held over the first steps only
MODE_LOSS_RTOL = 1e-4
MODE_LOSS_STEPS = 4
# ... in bf16 (fp16_run): the op-by-op decoder rounds its bijectors in bf16
# where the fused block folds them (ActNorm's bias and scale of a log-mel's
# large mean cancel in bf16, inside the folded product in f32), and the
# alignment's near-ties move the duration loss with z; so its losses are
# held to the fused block's within three times JAX's own bf16 op by op
# against fused, measured on the CPU at base width on four batches of two
# corpus utterances (tests/test_torch_bf16_modes.py: at most 1.5e-2 of the
# loss and 2.6e-3 of the MLE loss, the port's MLE within a tenth of JAX's
# on every batch)
MODE_LOSS_RTOL_BF16 = 4.5e-2
MODE_MLE_RTOL_BF16 = 8e-3
# step time and peak memory of the four modes: turns of MODE_TURN_STEPS steps,
# MODE_ROUNDS rounds of (a, b, c, d, d, c, b, a), after 2 warm-up steps each
MODE_TURN_STEPS = 4
MODE_ROUNDS = 4
# kernel vs plain forward with dropout on: the keep masks are equal bit for
# bit, so the outputs differ by summation order only
DROPOUT_FWD_RTOL = 1e-5
# a ReLU gate may differ between kernel and plain version only where the
# ReLU's input is within this share of its max (rounding of a value at zero)
GATE_TIE_RTOL = 1e-5
# the card's published peaks (NVIDIA H100 SXM data sheet): f32 outside the
# tensor cores and HBM3 bandwidth (PEAK_3XTF32_FLOPS, below: a third of the
# 495 TFLOP/s of dense TF32)
PEAK_F32_FLOPS = 67e12
PEAK_BYTES_PER_S = 3.35e12
# traces taken at most for one bracketed device time (a trace that lost
# its edge records does not count)
BRACKET_TRACES = 8
# a shape the TPU kernel streams through VMEM (mas_pallas.py :254/:264)
MAS_LONG = (2, 400, 2600)
# MAS past the short path's shared-memory ring (t_x 1,345 on): the long path,
# the counterpart of the streamed pair (rows 17-18)
MAS_LONG_TEXTS = ((2, 1345, 1400), (2, 2600, 2700), (1, 4096, 4200))
# an accumulated step against the full-batch step from the same state: the
# JAX package's tolerances (tests/test_grad_accum.py)
ACCUM_STEPS = 2
ACCUM_PARAM_RTOL, ACCUM_PARAM_ATOL, ACCUM_METRIC_RTOL, ACCUM_METRIC_ATOL = 3e-4, 2e-6, 3e-4, 1e-6
# both steps timed in turns (1, n, n, 1), this many rounds, each from a fresh copy
ACCUM_TIMED_ROUNDS = 3
# the cells of the path matrices in which the accumulated step's own alignment
# may differ from the full batch's, as a share of the path's cells: near-ties
# of MAS flip with the logp product's rounding (a moved frame differs in two
# cells); a slice taken from the wrong rows would differ almost everywhere
ACCUM_MAX_PATH_DIFF = 0.05
# the one leaf whose gradient is 0 up to round-off (softmax over keys is
# invariant to q . b_k): Adam's step on it is noise of either sign, bounded
# by the lr (as in tests/test_torch_train.py's trajectory)
ZERO_GRADIENT_LEAF = "encoder/attn/k/b"
# MAS with integer (tied) scores at text widths around the kernel's edges:
# a warp's 32 lanes, a lane's rows (6 at 192), one warp's 512 rows
MAS_TIE_WIDTHS = (32, 33, 193, 513)
# the MAS scan's cost a mel frame: the training shape's samples at these
# frame counts, all lengths full
MAS_SCAN_FRAMES = (704, 1408, 2816)

KERNEL_META = {
    "prenet": ("glow_tts_train_tpu_torch/csrc/text.cu",
               "glow_tts_train_tpu/ops/text_pallas.py:118"),
    "encoder_layer": ("glow_tts_train_tpu_torch/csrc/encoder.cu",
                      "glow_tts_train_tpu/ops/encoder_pallas.py:250"),
    "duration_stack": ("glow_tts_train_tpu_torch/csrc/text.cu",
                       "glow_tts_train_tpu/ops/text_pallas.py:212"),
    "block_inverse": ("glow_tts_train_tpu_torch/csrc/block.cu",
                      "glow_tts_train_tpu/ops/block_pallas.py:714"),
    "wn_forward": ("glow_tts_train_tpu_torch/csrc/block_train.cu",
                   "glow_tts_train_tpu/ops/wn_pallas.py:188"),
    "wn_forward_dropout": ("glow_tts_train_tpu_torch/csrc/block_train.cu",
                           "glow_tts_train_tpu/ops/wn_pallas.py:188"),
    "wn_fwd_save": ("glow_tts_train_tpu_torch/csrc/block_train.cu",
                    "glow_tts_train_tpu/ops/wn_pallas.py:202"),
    "wn_bwd": ("glow_tts_train_tpu_torch/csrc/block_train.cu",
               "glow_tts_train_tpu/ops/wn_pallas.py:285"),
    "wn_bwd_store": ("glow_tts_train_tpu_torch/csrc/block_train.cu",
                     "glow_tts_train_tpu/ops/wn_pallas.py:330"),
    "block_fwd": ("glow_tts_train_tpu_torch/csrc/block_train.cu",
                  "glow_tts_train_tpu/ops/block_pallas.py:144"),
    "block_bwd": ("glow_tts_train_tpu_torch/csrc/block_train.cu",
                  "glow_tts_train_tpu/ops/block_pallas.py:327"),
    "block_fwd_save": ("glow_tts_train_tpu_torch/csrc/block_train.cu",
                       "glow_tts_train_tpu/ops/block_pallas.py:172"),
    "block_bwd_store": ("glow_tts_train_tpu_torch/csrc/block_train.cu",
                        "glow_tts_train_tpu/ops/block_pallas.py:271"),
    "mas": ("glow_tts_train_tpu_torch/csrc/mas.cu",
            "glow_tts_train_tpu/ops/mas_pallas.py:41"),
    "prenet_bwd": ("glow_tts_train_tpu_torch/csrc/text_train.cu",
                   "glow_tts_train_tpu/ops/text_pallas.py:126"),
    "encoder_layer_bwd": ("glow_tts_train_tpu_torch/csrc/encoder_train.cu",
                          "glow_tts_train_tpu/ops/encoder_pallas.py:257"),
    "duration_stack_bwd": ("glow_tts_train_tpu_torch/csrc/text_train.cu",
                           "glow_tts_train_tpu/ops/text_pallas.py:220"),
}
# the bf16 versions (fp16_run): the same TPU kernels with dtype bf16, their
# products in csrc/bf16_gemm.cu
BF16_KERNELS = ("prenet", "encoder_layer", "duration_stack", "block_fwd_save",
                "prenet_bwd", "encoder_layer_bwd", "duration_stack_bwd", "block_bwd_store",
                *DECODER_KERNELS[:4], "block_fwd", "block_bwd")
KERNEL_META.update({name + "_bf16": KERNEL_META[name] for name in BF16_KERNELS})


def kernel_flops(name: str, args) -> float:
    """f32 operations (2 per multiply-add) of one call of kernel ``name``,
    from the shapes of its wrapper's arguments: every matrix product the
    function is made of, padded rows included.  A backward that recomputes
    its forward counts it: forward plus, per product, the weight and the
    input gradient (3 x forward)."""
    base = name[:-4] if name.endswith("_bwd") else name
    if base == "prenet":
        w, x = args[0][0], args[1]
        rows, h = x.shape[0] * x.shape[1], x.shape[2]
        flops = 2.0 * rows * (w.shape[0] * w.shape[1] * h + h * h)
    elif base == "duration_stack":
        (w1, _, _, _, w2, *_), x = args[0], args[1]
        flops = 2.0 * x.shape[0] * x.shape[1] * (w1.numel() + w2.numel())
    elif base == "encoder_layer":
        from glow_tts_train_tpu_torch.ops import encoder_cuda

        weights, x = encoder_cuda.merge_qkv(args[0]) if len(args[0]) == 18 else args[0], args[1]
        b, t, h = x.shape
        band = weights[4].shape[0]
        # 4 projections, q.k and p.v per head (+ both band terms), 2 FFN convs
        flops = 2.0 * b * t * (4 * h * h + 2 * t * h + 2 * band * h
                               + weights[10].numel() + weights[12].numel())
    elif name == "mas":
        # per cell of the length rectangles an add and a compare-select
        # going forward, and the backtrack's one choice per frame
        flops = 3.0 * mas_cells(args[1])
    else:  # the flow block and the WN stack
        if name == "wn_bwd_store":  # (w_in, w_rs, with_g, x_mask, saves, dout, ...)
            folded, x = {"W_in": args[0], "W_rs": args[1]}, args[5]
        else:
            folded = args[0] if isinstance(args[0], dict) else dict(zip(("W_in", "b_in", "W_rs", "b_rs"), args[0]))
            x = args[2]
        rows = x.shape[0] * x.shape[1]
        h = folded["W_rs"].shape[1]  # the last layer has no residual half: h x h
        flops = 2.0 * rows * (folded["W_in"].numel() + folded["W_rs"].numel() - h * h)
        end_conv = 0.0
        if "W_s" in folded:  # the block: folded actnorm/invconv, start and end convs
            flops += 2.0 * rows * (folded["A"].numel() + folded["W_s"].numel() + folded["W_e"].numel())
            end_conv = 2.0 * rows * folded["W_e"].numel() / 2  # logs rebuilt from skipm
        # a backward from saves: the weight and the input gradient of every
        # product (2 x forward), the block's also rebuilds logs; a recompute
        # backward runs the forward first, which leaves it logs
        passes = {"block_bwd_store": 2.0, "wn_bwd_store": 2.0, "block_bwd": 3.0, "wn_bwd": 3.0}
        if name in passes:
            flops = passes[name] * flops + (end_conv if name == "block_bwd_store" else 0.0)
        return flops
    return 3.0 * flops if name.endswith("_bwd") else flops


def mas_cells(mask) -> int:
    """Cells of the samples' length rectangles (the mask is rectangular per
    sample: lengths from its first column and first row)."""
    return int((mask[:, :, 0].sum(1) * mask[:, 0, :].sum(1)).sum().item())


def tensor_bytes(tree) -> int:
    """Bytes of every tensor in a nest of tuples, lists and dicts."""
    import torch

    if isinstance(tree, torch.Tensor):
        return tree.numel() * tree.element_size()
    if isinstance(tree, dict):
        return sum(tensor_bytes(v) for v in tree.values())
    if isinstance(tree, (tuple, list)):
        return sum(tensor_bytes(v) for v in tree)
    return 0


def bound(name: str, args, kwargs, outputs, fn=None) -> dict:
    """The least time this card could take for one call: bytes (inputs read
    once, outputs written once) over the memory rate, or operations over
    the peak of the unit that does them, whichever is larger.  ``fn`` (the
    kernel's wrapper) is called once more, under torch.profiler and between
    two reads of the product counters: where its products ran on the tensor
    cores the peak is a third of the TF32 rate (three passes a product),
    else the f32 rate of the CUDA cores; ``device_ms`` is the time its
    device operations took without the host's gaps between them."""
    from glow_tts_train_tpu_torch import kernels

    if name == "mas":  # what this data needs: logp in the rectangles, the mask's
        # first column and row, the whole path
        mask = args[1]
        n_bytes = 4 * (mas_cells(mask) + mask.shape[0] * (mask.shape[1] + mask.shape[2]))
        n_bytes += tensor_bytes(outputs)
    elif name == "block_inverse":  # the weights once: their splits are a second copy
        folded = {k: v for k, v in args[0].items() if not k.endswith("_split")}
        n_bytes = tensor_bytes((folded, args[1:], kwargs)) + tensor_bytes(outputs)
    else:
        n_bytes = tensor_bytes((args, kwargs)) + tensor_bytes(outputs)
    flops = kernel_flops(name, args)
    products = device = None
    if fn is not None:
        kernels.product_counts(reset=True)
        fn(*args, **kwargs)
        products = kernels.product_counts(reset=True)
        traced = device_profile(lambda: fn(*args, **kwargs), runs=3)
        device = {"device_ms": traced[0], "device_operations": traced[1]}
    on_tensor_cores = bool(products and products["tc_gemm"] + products["tc_wgrad"])
    by_bytes = n_bytes / PEAK_BYTES_PER_S * 1e3
    by_flops = flops / (PEAK_3XTF32_FLOPS if on_tensor_cores else PEAK_F32_FLOPS) * 1e3
    by = "operations, 3xTF32" if on_tensor_cores else "operations"
    if device and (device["device_ms"] or 0.0) < max(by_bytes, by_flops):
        device["device_ms"] = None  # below the bound: a trace short of records
    return {
        "bound_ms": max(by_bytes, by_flops),
        "bound_by": "bytes" if by_bytes >= by_flops else by,
        "bytes": n_bytes, "flops": flops, "library_ms": None,
        **({"products": products, **device} if products else {}),
    }


BF16_PRODUCT_KEYS = ("bf16_gemm", "bf16_wgrad", "bf16_tma_gemm", "bf16_tma_wgrad")


def bf16_bound(name: str, args, kwargs, outputs, fn) -> dict:
    """``bound`` of a bf16 kernel (``<name>_bf16``): its products run on the
    tensor cores in bf16 (the mma.sync kernels, ``bf16_gemm`` and
    ``bf16_wgrad``, or the TMA-fed wgmma ones, ``bf16_tma_gemm`` and
    ``bf16_tma_wgrad``), so the operations' time is at the dense BF16 peak;
    the bytes are its bf16 and f32 tensors as they are.  Its device time:
    one call's operations in a trace bracketed by spin kernels."""
    roof = bound(name[: -len("_bf16")], args, kwargs, outputs, fn)
    products = roof.get("products") or {}
    if not sum(products.get(k, 0) for k in BF16_PRODUCT_KEYS):
        fail(f"{name}: no product ran on the bf16 kernels: {products}")
    by_flops = roof["flops"] / PEAK_BF16_FLOPS * 1e3
    by_bytes = roof["bytes"] / PEAK_BYTES_PER_S * 1e3
    roof["bound_ms"] = max(by_bytes, by_flops)
    roof["bound_by"] = "bytes" if by_bytes >= by_flops else "operations, bf16"
    ops = bracketed_trace(lambda: fn(*args, **kwargs), calls=1)
    device, operations = sum(us for _, us in ops) / 1e3, len(ops)
    roof["device_operations"] = operations
    # below the bound: a trace short of records
    roof["device_ms"] = device if device is not None and device >= roof["bound_ms"] else None
    return roof


def held_to_bound(name: str, ms: float, roof: dict) -> None:
    """A kernel faster than the least time the card could take is a fault
    of the operation count or of the timing."""
    if not ms >= roof["bound_ms"]:
        fail(f"{name}: {ms} ms is below its bound of {roof['bound_ms']} ms by {roof['bound_by']}")


# the two tensor-core device kernels alone, at the products of one block at
# [16, 704, .]: (name, c_in, taps, dilation, tap_sign, n)
PRODUCT_ROWS = (16, 704)
CONV_PRODUCTS = (
    ("in_conv_d1", 192, 5, 1, 1, 384), ("in_conv_d4", 192, 5, 4, 1, 384),
    ("in_conv_d1_tma", 192, 5, 1, 1, 384), ("in_conv_d4_tma", 192, 5, 4, 1, 384),
    ("res_skip", 192, 1, 1, 1, 384), ("res_skip_tma", 192, 1, 1, 1, 384),
    ("in_conv_transposed", 384, 5, 2, -1, 192),
    ("fold_a", 160, 1, 1, 1, 160), ("start", 80, 1, 1, 1, 192), ("end", 192, 1, 1, 1, 160),
)
# (name, c_in, taps, dilation, n) -> out [taps * c_in, n]
WGRAD_PRODUCTS = (
    ("dW_in", 192, 5, 2, 384), ("dW_rs", 192, 1, 1, 384), ("dW_e", 192, 1, 1, 160),
    ("dA", 160, 1, 1, 160),
)
# a bare product against float64 of the same operands, relative to max |ref|:
# the 3xTF32 split drops terms below 2^-20 of each product term
PRODUCT_RTOL = 5e-6
# and against the plain emulation of the split (ops/tc_gemm.py
# matmul_3xtf32_plain), which differs from the kernel only in the f32
# accumulation order of the tensor cores
EMULATION_RTOL = 2e-6
PEAK_3XTF32_FLOPS = 495e12 / 3
# the dense BF16 tensor peak (the bf16 kernels' products: one pass each)
PEAK_BF16_FLOPS = 989e12


def bare_products(device_line: str) -> list:
    """The tensor-core conv-GEMM and weight-gradient GEMM alone (bare
    epilogue), each product of one block at PRODUCT_ROWS: against float64
    of the same operands within PRODUCT_RTOL, against the plain emulation of
    the 3xTF32 split, with the CUDA-core kernel's error and time on the same
    operands beside them, the weight gradients' bits equal across two runs,
    and the weights' K-major split against its plain version bit for bit."""
    import numpy as np
    import torch

    from glow_tts_train_tpu_torch import kernels
    from glow_tts_train_tpu_torch.ops import tc_gemm

    rng = np.random.default_rng(SEED + 5)
    batch, t = PRODUCT_ROWS

    def randn(*shape):
        return torch.from_numpy(rng.standard_normal(shape).astype(np.float32)).to(PLATFORM)

    w = randn(960, 384)
    if not torch.equal(tc_gemm.split_weights(w), tc_gemm.split_weights_plain(w)):
        fail("split_weights: the kernel's K-major split differs from the plain version's bits")

    rows = []

    def held(kind, name, shape, flops, run, ref64, emulated):
        kernels.product_counts(reset=True)
        out_tc = run("tc")
        counts = kernels.product_counts(reset=True)
        want = {"tc_gemm": int(kind == "conv_gemm"), "tc_wgrad": int(kind == "wgrad"),
                "tma_gemm": int(name.endswith("_tma"))}
        if {k: counts[k] for k in want} != want or counts["core_gemm"] + counts["core_wgrad"]:
            fail(f"{kind} {name}: product counts {counts}")
        out_auto, out_core = run("auto"), run("core")
        if not torch.equal(out_auto, out_tc):
            fail(f"{kind} {name}: the dispatch did not take the tensor-core kernel at {shape}")
        scale = ref64.abs().max().item()
        err = (out_tc.double() - ref64).abs().max().item()
        core_err = (out_core.double() - ref64).abs().max().item()
        emu_err = (out_tc - emulated).abs().max().item()
        if not (math.isfinite(err) and err <= PRODUCT_RTOL * scale):
            fail(f"{kind} {name}: max abs err {err} vs float64, max |ref| {scale} "
                 f"(tolerance {PRODUCT_RTOL} relative)")
        if not emu_err <= EMULATION_RTOL * scale:
            fail(f"{kind} {name}: max abs err {emu_err} vs the plain 3xTF32 emulation, "
                 f"max |ref| {scale} (tolerance {EMULATION_RTOL} relative)")
        if kind == "wgrad" and not torch.equal(out_tc, run("tc")):
            fail(f"wgrad {name}: two runs gave different bits")
        # the wrapper's time by CUDA events (at these sizes mostly the host's)
        # and the device's own: the product's launches (the weights' split or
        # the column sum of the row splits included) under torch.profiler
        ms = time_ms(lambda: run("tc"), (), {})
        # (where the traces do not agree or read below the bound, the events' time)
        floor = flops / PEAK_3XTF32_FLOPS * 1e3
        on_device = {}
        for mode in ("tc", "core"):
            traced = device_ms(lambda: run(mode), runs=10)
            traced_ok = traced is not None and traced >= floor
            on_device[mode] = traced if traced_ok else time_ms(lambda: run(mode), (), {})
        row = {"kernel": kind, "name": name, "shape": shape, "max_abs_err_f64": err,
               "max_abs_ref": scale, "core_max_abs_err_f64": core_err,
               "max_abs_err_emulation": emu_err, "ms": ms, "device_ms": on_device["tc"],
               "tflops": flops / on_device["tc"] / 1e9, "core_device_ms": on_device["core"],
               "core_tflops": flops / on_device["core"] / 1e9,
               "bound_ms": floor}
        if not on_device["tc"] >= floor:
            fail(f"{kind} {name}: {on_device['tc']} ms is below its bound of {floor} ms")
        rows.append(row)
        print(f"product {kind} {name}: {shape} err vs float64 {err:.3e} (CUDA-core kernel "
              f"{core_err:.3e}, vs 3xTF32 emulation {emu_err:.3e}; max|ref| {scale:.3e}), "
              f"{on_device['tc']:.4f} ms on the device = {row['tflops']:.1f} TFLOP/s ({ms:.4f} ms "
              f"by events; CUDA-core kernel {on_device['core']:.4f} ms = "
              f"{row['core_tflops']:.1f} TFLOP/s), bound {row['bound_ms']:.4f} ms at 165 TFLOP/s "
              f"[{device_line}]")

    for name, c_in, taps, dilation, tap_sign, n in CONV_PRODUCTS:
        a, w = randn(batch, t, c_in), randn(taps * c_in, n) / math.sqrt(taps * c_in)
        cols = tc_gemm.im2col_plain(a, taps, dilation, tap_sign)
        # the TMA-fed kernel as the WN forward chains take it: "tc" and "auto"
        # are the chains' dispatch ("fwd"), "core" the CUDA cores
        fwd = name.endswith("_tma")
        held("conv_gemm", name, [batch * t, taps * c_in, n], 2.0 * batch * t * taps * c_in * n,
             lambda mode: tc_gemm.conv_product(
                 a, w, taps, dilation, tap_sign, mode="fwd" if fwd and mode != "core" else mode),
             cols.double() @ w.double(), tc_gemm.matmul_3xtf32_plain(cols, w))
    for name, c_in, taps, dilation, n in WGRAD_PRODUCTS:
        a, dy = randn(batch, t, c_in), randn(batch, t, n)
        cols = tc_gemm.im2col_plain(a, taps, dilation).reshape(batch * t, -1)
        dy2 = dy.reshape(batch * t, n)
        held("wgrad", name, [taps * c_in, batch * t, n], 2.0 * batch * t * taps * c_in * n,
             lambda mode: tc_gemm.weight_gradient(a, dy, taps, dilation, mode=mode),
             cols.double().T @ dy2.double(), tc_gemm.matmul_3xtf32_plain(cols.T, dy2))
    return rows


# the encoder layer's products: (name, c_in, taps, n, w_t) -> [rows, taps *
# c_in, n]; w_t: the transposed product, read from the forward's weights; at
# the training shape [16, 192, .] (t_x <= 192: short, deep products), the
# shortest training bucket [16, 64, .] and serving b=4 [4, 250, .]
TEXT_PRODUCT_ROWS = ((16, 192), (16, 64), (4, 250))
TEXT_PRODUCTS = (
    ("ffn2", 768, 3, 192, False), ("ffn1", 192, 3, 768, False),
    ("dx_qkv_transposed", 576, 1, 192, True), ("qkv", 192, 1, 576, False),
    ("out_proj", 192, 1, 192, False), ("db_ffn_transposed", 768, 3, 192, True),
)
# the serving flow block's products at b=1: a 48-phoneme request (160
# rows) and a 250-phoneme one (832 rows)
SERVE_PRODUCT_ROWS = ((1, 160), (1, 832))
SERVE_PRODUCTS = (
    ("in_conv", 192, 5, 384, False), ("res_skip", 192, 1, 384, False),
    ("start", 80, 1, 192, False), ("end", 192, 1, 160, False), ("fold_a", 160, 1, 160, False),
)


def text_products(device_line: str) -> list:
    """The conv-GEMM at the encoder's shapes and at the serving flow block's
    b=1 shapes three ways: the tensor cores over the whole K walk ("tc"),
    what the chain takes ("text": ``tc_gemm.text_product_plan``, "serve":
    ``tc_gemm.inverse_product_plan``, which say which unit, tile and how
    many K shares, held against the product counters) and the CUDA-core
    kernel, each against float64 of the same operands (max error within
    PRODUCT_RTOL of max |ref|, and the lean: the error along the sign of
    the reference over its mean magnitude), with the device's own time and
    TFLOP/s; the chain's bits the same twice."""
    import numpy as np
    import torch

    from glow_tts_train_tpu_torch import kernels
    from glow_tts_train_tpu_torch.ops import tc_gemm

    rng = np.random.default_rng(SEED + 6)
    sms = torch.cuda.get_device_properties(0).multi_processor_count

    def text_plan(rows, kdim, n):
        on_tc, splits = tc_gemm.text_product_plan(rows, kdim, n, sms)
        return on_tc, splits, f"tensor cores, {splits} K shares"

    def serve_plan(rows, kdim, n):
        tile, splits = tc_gemm.inverse_product_plan(rows, kdim, n, sms)
        return tile > 0, splits, f"tensor cores, {tile}-row tiles, {splits} K shares"

    cases = [("text", text_plan, rows, p) for rows in TEXT_PRODUCT_ROWS for p in TEXT_PRODUCTS]
    cases += [("serve", serve_plan, rows, p) for rows in SERVE_PRODUCT_ROWS for p in SERVE_PRODUCTS]
    rows = []
    for chain, plan, (batch, t), (name, c_in, taps, n, w_t) in cases:
        modes = ("tc", chain, "core")
        a = torch.from_numpy(rng.standard_normal((batch, t, c_in)).astype(np.float32)).to(PLATFORM)
        shape = (taps * n, c_in) if w_t else (taps * c_in, n)
        w = torch.from_numpy(
            (rng.standard_normal(shape) / math.sqrt(taps * c_in)).astype(np.float32)).to(PLATFORM)
        tap_sign = -1 if w_t else 1
        b = tc_gemm.transposed_weights_plain(w, taps) if w_t else w
        ref = tc_gemm.im2col_plain(a, taps, 1, tap_sign).double() @ b.double()
        scale = ref.abs().max().item()
        flops = 2.0 * batch * t * taps * c_in * n
        on_tc, splits, takes = plan(batch * t, taps * c_in, n)
        row = {"kernel": "conv_gemm", "chain": chain, "name": name,
               "shape": [batch * t, taps * c_in, n], "w_t": w_t, "max_abs_ref": scale,
               "chain_takes": takes if on_tc else "CUDA cores",
               "bound_ms": flops / PEAK_3XTF32_FLOPS * 1e3}
        outs = {}
        for mode in modes:
            run = lambda: tc_gemm.conv_product(a, w, taps, 1, tap_sign, mode=mode, w_t=w_t)
            kernels.product_counts(reset=True)
            outs[mode] = out = run()
            counts = kernels.product_counts(reset=True)
            unit = "core_gemm" if mode == "core" or (mode == chain and not on_tc) else "tc_gemm"
            if counts[unit] != 1:
                fail(f"{chain} product {name} {row['shape']} {mode}: product counts {counts}, "
                     f"expected one {unit}")
            err = out.double() - ref
            # the lean: the error along the sign of the reference, over the
            # mean magnitude (negative: the outputs shrink alike)
            max_err = err.abs().max().item()
            lean = (err * ref.sign()).mean().item() / ref.abs().mean().item()
            rtol = 1e-5 if unit == "core_gemm" else PRODUCT_RTOL
            if not (math.isfinite(max_err) and max_err <= rtol * scale):
                fail(f"{chain} product {name} {row['shape']} {mode}: max abs err {max_err} vs "
                     f"float64, max |ref| {scale} (tolerance {rtol} relative)")
            traced = device_ms(run, runs=10)
            ok = traced is not None and traced >= row["bound_ms"]
            on_device = traced if ok else time_ms(run, (), {})
            row[mode] = {"device_ms": on_device, "tflops": flops / on_device / 1e9,
                         "max_abs_err_f64": max_err, "lean_f64": lean}
        # one share: each output is the whole-K walk's sum, whatever the tile
        if on_tc and splits == 1 and not torch.equal(outs[chain], outs["tc"]):
            fail(f"{chain} product {name} {row['shape']}: one K share, yet not the whole-K bits")
        again = tc_gemm.conv_product(a, w, taps, 1, tap_sign, mode=chain, w_t=w_t)
        if not torch.equal(outs[chain], again):
            fail(f"{chain} product {name} {row['shape']}: different bits twice")
        rows.append(row)
        print(f"product conv_gemm {chain} {name}: {row['shape']} the chain takes "
              f"{row['chain_takes']}; " + ", ".join(
                  f"{m} {row[m]['device_ms'] * 1e3:.1f} us ({row[m]['tflops']:.1f} TFLOP/s, err "
                  f"{row[m]['max_abs_err_f64'] / scale:.2e} of max|ref|, lean "
                  f"{row[m]['lean_f64']:+.2e})" for m in modes) + f" [{device_line}]")
    return rows


def fail(msg: str) -> None:
    raise SystemExit(f"chip_smoke: FAILED: {msg}")


def gpu_line() -> str:
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True,
    ).stdout.strip().splitlines()
    return out[0]


def make_checkpoint(workdir: Path, config_path: Path):
    import numpy as np

    from glow_tts_train_tpu_torch import checkpoint
    from glow_tts_train_tpu_torch.config import load_config
    from glow_tts_train_tpu_torch.models import hyper_from_config

    config = load_config([config_path])
    hp = hyper_from_config(config)
    flat = checkpoint.random_params(hp, SEED)
    flat["model/proj_w/proj/w"] *= np.float32(0.1)
    flat["model/proj_w/proj/b"][:] = math.log(6.0)
    path = workdir / "checkpoint_base.npz"
    checkpoint.save_npz(path, flat)
    return path, config, hp


def requests(num_symbols: int = 130) -> str:
    import numpy as np

    rng = np.random.default_rng(SEED)
    lines = []
    for i, n in enumerate(REQUEST_LENGTHS):
        ids = rng.integers(1, num_symbols, size=n)
        lines.append(f"utt{i}|{' '.join(map(str, ids))}")
    return "\n".join(lines) + "\n"


def serve(ckpt: Path, config_path: Path, stdin_text: str, batch_size: int, n_mel: int):
    """One pass of the inference CLI in-process -> (mels by id, seconds)."""
    import numpy as np
    import torch

    from glow_tts_train_tpu_torch import infer

    argv = [str(ckpt), "--config", str(config_path), "--csv",
            "--batch-size", str(batch_size), "--platform", PLATFORM]
    out = io.StringIO()
    old_stdin = sys.stdin
    sys.stdin = io.StringIO(stdin_text)
    try:
        start = time.perf_counter()
        with contextlib.redirect_stdout(out):
            infer.main(argv)
        torch.cuda.synchronize()
        seconds = time.perf_counter() - start
    finally:
        sys.stdin = old_stdin
    mels = {}
    for line in out.getvalue().splitlines():
        obj = json.loads(line)
        mels[obj["id"]] = np.asarray(obj["mel"], np.float32)
    if len(mels) != len(REQUEST_LENGTHS):
        fail(f"batch {batch_size}: {len(mels)} mels for {len(REQUEST_LENGTHS)} requests")
    for utt, mel in mels.items():
        if mel.ndim != 2 or mel.shape[0] != n_mel or mel.shape[1] < 1:
            fail(f"{utt}: mel shape {mel.shape}")
        if not np.isfinite(mel).all():
            fail(f"{utt}: non-finite mel")
    return mels, seconds


class Recorder:
    """Wraps a kernel wrapper to keep a copy of the arguments of its first
    call while armed (``args``) and, with ``keep_last``, of its last
    (``last``) (copies: a training step later updates the parameters in
    place, and some folded weights are views of them)."""

    def __init__(self, module, name, keep_last=False):
        self.module, self.name = module, name
        self.fn = getattr(module, name)
        self.args = self.last = None
        self.armed = False
        self.keep_last = keep_last
        setattr(module, name, self)

    def __call__(self, *args, **kwargs):
        if self.armed and (self.args is None or self.keep_last):
            from glow_tts_train_tpu_torch.tree import tree_map

            copy = tree_map(lambda a: a.detach().clone(), (args, kwargs))
            if self.args is None:
                self.args = copy
            self.last = copy
        return self.fn(*args, **kwargs)

    def restore(self):
        setattr(self.module, self.name, self.fn)


def time_ms(fn, args, kwargs, runs: int = TIMED_RUNS, warmup: int = 5) -> float:
    import torch

    for _ in range(warmup):
        fn(*args, **kwargs)
    times = []
    for _ in range(runs):
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        fn(*args, **kwargs)
        end.record()
        end.synchronize()
        times.append(start.elapsed_time(end))
    return statistics.median(times)


@contextlib.contextmanager
def plain_path_on_card():
    """Send CUDA tensors to the kernels' plain versions (every wrapper asks
    ``kernels.route``), to time the plain path end to end on the card."""
    from glow_tts_train_tpu_torch import kernels

    route = kernels.route
    kernels.route = lambda x: "plain"
    try:
        yield
    finally:
        kernels.route = route


def serving_times(ckpt: Path, config, hp, device_line: str) -> list:
    """The device memory the serving blocks' weight splits hold; then
    synthesis wall time per batch, kernel path vs plain path on the card,
    with the real-time factor (synth seconds / audio seconds) of each; then
    the device's busy time, idle share and operations of one profiled
    synthesis on the kernel path."""
    import numpy as np
    import torch
    from torch.profiler import ProfilerActivity, profile

    from glow_tts_train_tpu_torch.checkpoint import load_checkpoint
    from glow_tts_train_tpu_torch.infer import build_synthesizer
    from glow_tts_train_tpu_torch.models import store_inverse

    model, _ = load_checkpoint(ckpt, hp)
    weights = store_inverse(model, hp).to(PLATFORM)
    split_bytes = tensor_bytes([{k: v for k, v in b.items() if k.endswith("_split")}
                                for b in weights.blocks])
    print(f"serve: the serving blocks' weight splits made at load hold {split_bytes} bytes "
          f"({split_bytes / 2 ** 20:.1f} MiB) of device memory, "
          f"{torch.cuda.memory_allocated() / 2 ** 20:.1f} MiB allocated with every serving weight "
          f"[{device_line}]")
    synth = build_synthesizer(weights, hp, config, noise_scale=0.333, length_scale=1.0)
    rng = np.random.default_rng(SEED + 2)
    lengths = sorted({n for batch in SERVE_BATCHES.values() for n in batch})
    ids = {n: rng.integers(1, 130, size=n).tolist() for n in lengths}
    seconds_per_frame = config.audio.hop_length / config.audio.sample_rate

    def median_ms(batch):
        for _ in range(3):
            synth(batch)
        times = []
        for _ in range(SYNTH_RUNS):
            start = time.perf_counter()
            mels = synth(batch)  # ends in the copy of the mels to the host
            times.append(time.perf_counter() - start)
        return statistics.median(times) * 1e3, sum(m.shape[1] for m in mels)

    rows = []
    for case, batch_lengths in SERVE_BATCHES.items():
        batch = [ids[n] for n in batch_lengths]
        ms = {"kernel": [], "plain": []}
        for path in ("kernel", "plain", "plain", "kernel"):
            with plain_path_on_card() if path == "plain" else contextlib.nullcontext():
                t, frames = median_ms(batch)
            ms[path].append(t)
        audio_s = frames * seconds_per_frame
        row = {
            "case": case, "frames": frames, "audio_s": audio_s,
            "kernel_ms": ms["kernel"], "plain_ms": ms["plain"],
            "rtf_kernel": min(ms["kernel"]) / 1e3 / audio_s,
            "rtf_plain": min(ms["plain"]) / 1e3 / audio_s,
        }
        if case in PROFILED:
            synth(batch)
            with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
                start = time.perf_counter()
                synth(batch)
                wall_ms = (time.perf_counter() - start) * 1e3
            # device kernels run on one stream, so their times add up
            events = [e for e in prof.key_averages() if e.device_type.name == "CUDA"]
            by_kernel = {e.key: e.self_device_time_total / 1e3 for e in events}
            busy_ms = sum(by_kernel.values())
            row["profiled_wall_ms"] = wall_ms
            row["device_busy_ms"] = busy_ms
            row["device_operations"] = sum(e.count for e in events)
            # the text chains' once-a-call weight splits (the serving
            # blocks' were made at load)
            row["split_weights_launches"] = sum(
                e.count for e in events if "split_weights_kernel" in e.key)
            row["idle_share"] = 1.0 - busy_ms / wall_ms if busy_ms > 0 else None
            top = sorted(by_kernel.items(), key=lambda kv: -kv[1])[:4]
            row["top_kernels_ms"] = {k[:60]: v for k, v in top}
        rows.append(row)
        print(f"synth {case}: {frames} frames, kernel path {ms['kernel']} ms, "
              f"plain path {ms['plain']} ms, RTF {row['rtf_kernel']:.3e} vs "
              f"{row['rtf_plain']:.3e} [{device_line}]")
        if case in PROFILED:
            print(f"  profiled: wall {row['profiled_wall_ms']:.3f} ms, device busy "
                  f"{busy_ms:.3f} ms, idle share {row['idle_share']}, {row['device_operations']} "
                  f"device operations ({row['split_weights_launches']} weight-split launches), "
                  f"top {row['top_kernels_ms']}")
    return rows


def cli_mels(main, argv: list, stdin_text: str) -> dict:
    """One CLI run in-process on ``stdin_text`` (``--csv`` lines) -> mels by id."""
    import numpy as np
    import torch

    out = io.StringIO()
    old_stdin = sys.stdin
    sys.stdin = io.StringIO(stdin_text)
    try:
        with contextlib.redirect_stdout(out):
            main(argv)
        torch.cuda.synchronize()
    finally:
        sys.stdin = old_stdin
    return {obj["id"]: np.asarray(obj["mel"], np.float32)
            for obj in map(json.loads, out.getvalue().splitlines())}


def held_mels(name: str, got: dict, want: dict, exact: bool = False) -> dict:
    """Each request's mel of an artifact against the live path's: the same
    frame count (fails on a mismatch of mel_lengths), then within
    EXPORT_MEL_RTOL of max |mel| (``exact``: bit for bit)."""
    import numpy as np

    rows = {}
    if sorted(got) != sorted(want):
        fail(f"export {name}: mels for {sorted(got)}, expected {sorted(want)}")
    for utt, ref in want.items():
        mel = got[utt]
        if mel.shape != ref.shape:
            fail(f"export {name} {utt}: mel {mel.shape} vs the live path's {ref.shape} "
                 "(mel_lengths differ)")
        err = float(np.abs(mel - ref).max())
        scale = float(np.abs(ref).max())
        bound = 0.0 if exact else EXPORT_MEL_RTOL * scale
        if not np.isfinite(mel).all() or not err <= bound:
            fail(f"export {name} {utt}: max abs err {err} against the bound {bound} "
                 f"(max |mel| {scale})")
        rows[utt] = {"frames": mel.shape[1], "max_abs_err": err, "max_abs_mel": scale,
                     "bound": bound}
    return rows


def events_ms(fn, runs: int = EXPORT_TIMED_RUNS, warmup: int = 2) -> float:
    """Median of ``runs`` calls of ``fn`` by CUDA events, after ``warmup``."""
    import torch

    for _ in range(warmup):
        fn()
    times = []
    for _ in range(runs):
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        fn()
        end.record()
        end.synchronize()
        times.append(start.elapsed_time(end))
    return statistics.median(times)


def serving_launches(hp) -> dict:
    """Launches of the four serving kernels when the infer CLI serves the
    requests one at a time."""
    n = len(REQUEST_LENGTHS)
    return {"prenet": int(hp.prenet) * n, "encoder_layer": hp.n_layers_enc * n,
            "duration_stack": n, "block_inverse": hp.n_blocks_dec * n}


def export_artifacts(ckpt: Path, config_path: Path, out: Path, formats, extra=()) -> dict:
    """The export CLI once per format -> {format: (dir, bytes, seconds)}."""
    from glow_tts_train_tpu_torch import export

    names = {"pt2": export.ARTIFACT_NAME, "onnx": export.ONNX_NAME, "torch": export.TORCH_NAME}
    made = {}
    for fmt in formats:
        start = time.perf_counter()
        export.main([str(ckpt), str(out / fmt), "--config", str(config_path), "--format", fmt,
                     "--platform", PLATFORM, *extra])
        seconds = time.perf_counter() - start
        made[fmt] = (out / fmt, (out / fmt / names[fmt]).stat().st_size, seconds)
    return made


def export_phase(workdir: Path, repo: Path, ckpt: Path, config_path: Path,
                 device_line: str) -> dict:
    """The export CLI's three formats from the trained base checkpoint and
    what serves them, against the live kernel path; then a multispeaker
    voice at the width of configs/multispeaker.json."""
    import numpy as np
    import torch

    from glow_tts_train_tpu_torch import checkpoint, infer, infer_export, kernels
    from glow_tts_train_tpu_torch.config import load_config
    from glow_tts_train_tpu_torch.infer import build_synthesizer
    from glow_tts_train_tpu_torch.models import hyper_from_config, store_inverse

    config = load_config([config_path])
    hp = hyper_from_config(config)
    # the trained model's vocabulary is the corpus's
    stdin_text = requests(config.model.num_symbols)
    first = stdin_text.splitlines()[0] + "\n"
    made = export_artifacts(ckpt, config_path, workdir / "export", ("pt2", "onnx", "torch"))
    for fmt, (_, size, seconds) in made.items():
        print(f"export {fmt}: {size} bytes in {seconds:.2f} s (the CLI, checkpoint load and, "
              f"for pt2, the trace and a check run on the card included) [{device_line}]")
    live_argv = [str(ckpt), "--config", str(config_path), "--csv", "--noise-scale", "0",
                 "--platform", PLATFORM]
    want = serving_launches(hp)
    kernels.reset_launch_counts()
    live = cli_mels(infer.main, live_argv, stdin_text)
    got = {k: kernels.launch_counts()[k] for k in want}
    if got != want:
        fail(f"export: the live path launched {got}, expected {want}")
    # the artifacts are plain graphs: no kernel of this package runs in them
    pt2_dir, onnx_dir, pth_dir = (made[f][0] for f in ("pt2", "onnx", "torch"))
    kernels.reset_launch_counts()
    pt2 = cli_mels(infer_export.main, [str(pt2_dir), "--csv", "--noise-scale", "0",
                                       "--platform", PLATFORM], stdin_text)
    start = time.perf_counter()
    onnx = cli_mels(infer_export.main, [str(onnx_dir / "generator.onnx"), "--csv",
                                        "--noise-scale", "0", "--platform", PLATFORM], first)
    onnx_s = time.perf_counter() - start
    if any(kernels.launch_counts().values()):
        fail(f"export: an artifact launched kernels: {kernels.launch_counts()}")
    pth = cli_mels(infer.main, [str(pth_dir / "generator.pth"), *live_argv[1:]], stdin_text)
    rows = {"pt2": held_mels("pt2", pt2, live),
            "onnx": held_mels("onnx", onnx, {k: live[k] for k in onnx}),
            "pth": held_mels("pth", pth, live, exact=True)}
    for name, held in rows.items():
        print(f"export {name} vs the live kernel path at noise 0: " + ", ".join(
            f"{u} {r['frames']} frames err {r['max_abs_err']:.3e} (bound {r['bound']:.3e})"
            for u, r in held.items()))

    # the .pt2 loaded on the card, its seed contract, and its time a request
    # against the live path's
    start = time.perf_counter()
    artifact = infer_export.load_artifact(pt2_dir, PLATFORM, seed=5)
    load_s = time.perf_counter() - start
    rng = np.random.default_rng(SEED)
    ids = {n: rng.integers(1, config.model.num_symbols, size=n).tolist() for n in REQUEST_LENGTHS}
    short = ids[min(REQUEST_LENGTHS)]
    a = artifact.call(short, [0.667, 1.0])
    b = artifact.call(short, [0.667, 1.0])
    other = infer_export.load_artifact(pt2_dir, PLATFORM, seed=6).call(short, [0.667, 1.0])
    n = min(a.shape[1], other.shape[1])
    seed_diff = float(np.abs(a[:, :n] - other[:, :n]).max())
    if not np.array_equal(a, b) or not seed_diff > 1e-2:
        fail(f"export pt2 seed: same seed equal {np.array_equal(a, b)}, another seed differs "
             f"by {seed_diff}")
    model, _ = checkpoint.load_checkpoint(ckpt, hp)
    synth = build_synthesizer(store_inverse(model, hp).to(PLATFORM), hp, config,
                              noise_scale=0.0, length_scale=1.0)
    timing = {}
    for n_ph, phonemes in ids.items():
        timing[str(n_ph)] = {
            "pt2_ms": events_ms(lambda: artifact.call(phonemes, [0.0, 1.0])),
            "live_ms": events_ms(lambda: synth([phonemes])),
        }
    print(f"export pt2: loaded on the card in {load_s:.2f} s; ms a request (events, median of "
          f"{EXPORT_TIMED_RUNS}, the mel copied to the host) by phonemes, .pt2 against the "
          f"live kernel path: {timing}; same seed equal, another seed max diff {seed_diff:.3f}; "
          f"onnx on the host {onnx_s:.2f} s for the {min(REQUEST_LENGTHS)}-phoneme request "
          f"[{device_line}]")

    # a multispeaker voice at the width of configs/multispeaker.json
    ms_config_path = repo / "configs" / "multispeaker.json"
    ms_hp = hyper_from_config(load_config([ms_config_path]))
    flat = checkpoint.random_params(ms_hp, SEED)
    flat["model/proj_w/proj/w"] *= np.float32(0.1)
    flat["model/proj_w/proj/b"][:] = math.log(6.0)
    ms_ckpt = workdir / "checkpoint_multispeaker.npz"
    checkpoint.save_npz(ms_ckpt, flat)
    ms_made = export_artifacts(ms_ckpt, ms_config_path, workdir / "export_ms", ("pt2",),
                               ("--speaker", str(EXPORT_SPEAKER)))
    ms_argv = ["--config", str(ms_config_path), "--csv", "--noise-scale", "0",
               "--platform", PLATFORM]
    kernels.reset_launch_counts()
    ms_text = requests(ms_hp.n_vocab)
    ms_live = cli_mels(infer.main, [str(ms_ckpt), *ms_argv, "--speaker", str(EXPORT_SPEAKER)],
                       ms_text)
    ms_want = serving_launches(ms_hp)
    ms_launches = {k: kernels.launch_counts()[k] for k in ms_want}
    if ms_launches != ms_want:
        fail(f"export multispeaker: the live path launched {ms_launches}, expected {ms_want}")
    ms_pt2 = cli_mels(infer_export.main, [str(ms_made["pt2"][0]), "--csv", "--noise-scale", "0",
                                          "--platform", PLATFORM], ms_text)
    rows["multispeaker_pt2"] = held_mels("multispeaker pt2", ms_pt2, ms_live)
    print(f"export multispeaker ({ms_hp.n_speakers} speakers, gin {ms_hp.gin_channels}, "
          f"--speaker {EXPORT_SPEAKER}): pt2 "
          f"{ms_made['pt2'][1]} bytes in {ms_made['pt2'][2]:.2f} s; against live infer "
          f"--speaker {EXPORT_SPEAKER} on the card (launches {ms_launches}): " + ", ".join(
              f"{u} {r['frames']} frames err {r['max_abs_err']:.3e} (bound {r['bound']:.3e})"
              for u, r in rows["multispeaker_pt2"].items()) + f" [{device_line}]")
    return {
        "artifacts": {fmt: {"bytes": size, "export_s": sec} for fmt, (_, size, sec) in made.items()},
        "multispeaker_pt2": {"bytes": ms_made["pt2"][1], "export_s": ms_made["pt2"][2],
                             "speaker": EXPORT_SPEAKER},
        "pt2_load_s": load_s, "ms_per_request": timing, "onnx_host_s": onnx_s,
        "seed": {"same_seed_equal": True, "other_seed_max_diff": seed_diff},
        "errors": rows, "live_launches": got, "device": device_line,
    }


def rel_err(name: str, port, ref, rtol: float) -> tuple:
    """(max abs err, max |ref|); fails past rtol * max |ref|."""
    err = (port - ref).abs().max().item()
    scale = ref.abs().max().item()
    if not math.isfinite(err) or err > rtol * max(scale, 1e-6):
        fail(f"{name}: max abs err {err} vs max |ref| {scale} (tolerance {rtol} relative)")
    return err, scale


TEXT_KERNELS = ("prenet", "encoder_layer", "duration_stack")


def make_corpus(workdir: Path, repo: Path) -> tuple:
    corpus = workdir / "corpus"
    proc = subprocess.run(
        [sys.executable, str(repo / "scripts" / "make-synthetic-corpus.py"), str(corpus),
         str(TRAIN_UTTERANCES), str(SEED)],
        capture_output=True, text=True,
    )
    if proc.returncode != 0:
        fail(f"make-synthetic-corpus.py: {proc.stderr[-2000:]}")
    manifest = json.loads((corpus / "manifest.json").read_text())
    print(f"train: corpus {manifest['n_utterances']} utterances, phonemes "
          f"{manifest['phonemes_min_max']}, frames {manifest['frames_min_max']}")
    return corpus, manifest


def run_train_cli(workdir: Path, corpus: Path, manifest: dict, config_path: Path,
                  override: dict, tag: str, n_steps: int, recorders: dict, extra=(),
                  corpus_symbols: bool = True):
    """The train CLI in-process on the corpus (``extra``: more of its
    arguments) -> (launch counts of the run, per-step rows, the last step's
    function, state and batch, the output directory, seconds).
    ``recorders`` are armed for the last step.  ``corpus_symbols``: the
    model's num_symbols set to the corpus's (else the config's, which must
    cover it)."""
    import torch

    from glow_tts_train_tpu_torch import __main__ as train_cli
    from glow_tts_train_tpu_torch import kernels, training

    override_path = workdir / f"{tag}_override.json"
    if corpus_symbols:
        model_over = dict(override.get("model", {}), num_symbols=manifest["num_symbols"])
        override = dict(override, model=model_over)
    override_path.write_text(json.dumps(override))
    steps = []
    last = {}  # the last step's function, state and batch, for the profile
    make_step = training.make_train_step

    def timed_make_train_step(config):
        step_fn = make_step(config)

        def timed(state, batch, *args):
            # kernels are held to their plain versions on the last step's
            # inputs: by then the zero-initialised end convs and prenet
            # projection have moved, so no gradient is zero by construction
            arm = len(steps) == n_steps - 1
            for rec in recorders.values():
                rec.armed = rec.armed or arm
            last.update(step_fn=step_fn, state=state, batch=batch, args=args)
            torch.cuda.synchronize()
            start = time.perf_counter()
            metrics = step_fn(state, batch, *args)
            torch.cuda.synchronize()
            steps.append({
                "seconds": time.perf_counter() - start,
                "shape": [list(batch["x"].shape), list(batch["y"].shape)],
                **{k: float(v) for k, v in metrics.items()},
            })
            return metrics

        return timed

    training.make_train_step = timed_make_train_step
    out = workdir / f"model_{tag}"
    kernels.reset_launch_counts()
    start = time.perf_counter()
    try:
        train_cli.main([
            "--output", str(out), "--dataset", "0", str(corpus / "phonemes.csv"),
            str(corpus / "mels"), "--mels-dir", "--config", str(config_path),
            "--config", str(override_path), "--metrics-file", str(workdir / f"{tag}.jsonl"),
            "--platform", PLATFORM, *extra,
        ])
        torch.cuda.synchronize()
    finally:
        training.make_train_step = make_step
        for rec in recorders.values():
            rec.restore()
    seconds = time.perf_counter() - start
    launches = kernels.launch_counts()
    if len(steps) != n_steps:
        fail(f"train {tag}: {len(steps)} steps, expected {n_steps}")
    for i, row in enumerate(steps):
        if not all(math.isfinite(row[k]) for k in ("loss", "mle_loss", "duration_loss")):
            fail(f"train {tag} step {i + 1}: non-finite loss {row}")
        if not (math.isfinite(row["grad_norm"]) and row["grad_norm"] > 0):
            fail(f"train {tag} step {i + 1}: grad_norm {row['grad_norm']}")
    return launches, steps, last, out, seconds


def train(workdir: Path, repo: Path, config_path: Path, device_line: str):
    """Both training runs -> (launch counts of the main run, recorders of the
    training kernels, per-step rows, median step ms, the profiled step, the
    last checkpoint and its config)."""
    from glow_tts_train_tpu_torch.config import load_config
    from glow_tts_train_tpu_torch.ops import block_cuda, encoder_cuda, mas_cuda, text_cuda, wn_cuda

    corpus, manifest = make_corpus(workdir, repo)
    config = load_config([config_path])
    n_blocks, n_layers = config.model.n_blocks_dec, config.model.n_layers_enc

    recorders = {
        "wn_forward": Recorder(wn_cuda, "wn_stack"),
        "block_fwd_save": Recorder(block_cuda, "block_fwd_save"),
        "block_bwd_store": Recorder(block_cuda, "block_bwd_store"),
        "mas": Recorder(mas_cuda, "maximum_path"),
        "prenet": Recorder(text_cuda, "prenet"),
        "prenet_bwd": Recorder(text_cuda, "prenet_bwd"),
        "encoder_layer": Recorder(encoder_cuda, "encoder_layer"),
        "encoder_layer_bwd": Recorder(encoder_cuda, "encoder_layer_bwd"),
        "duration_stack": Recorder(text_cuda, "duration_stack"),
        "duration_stack_bwd": Recorder(text_cuda, "duration_stack_bwd"),
    }
    recorders["wn_forward"].armed = True  # DDI, before the first step
    launches, steps, last, out, seconds = run_train_cli(
        workdir, corpus, manifest, config_path, TRAIN_OVERRIDE, "fused", TRAIN_STEPS, recorders
    )
    # DDI runs each block's WN stack once; each step each block once, MAS
    # once, and the text side's kernels forward and backward
    want = {"wn_forward": n_blocks, "block_fwd_save": n_blocks * TRAIN_STEPS,
            "block_bwd_store": n_blocks * TRAIN_STEPS, "mas": TRAIN_STEPS,
            "prenet": TRAIN_STEPS, "prenet_bwd": TRAIN_STEPS,
            "encoder_layer": n_layers * TRAIN_STEPS, "encoder_layer_bwd": n_layers * TRAIN_STEPS,
            "duration_stack": TRAIN_STEPS, "duration_stack_bwd": TRAIN_STEPS}
    got = {k: launches[k] for k in want}
    if got != want:
        fail(f"train: launches {got}, expected {want}")
    epochs = [json.loads(line) for line in (workdir / "fused.jsonl").read_text().splitlines()]
    ckpt = out / f"checkpoint_{1 + TRAIN_STEPS}.npz"
    if len(epochs) != 2 or not ckpt.exists():
        fail(f"train: {len(epochs)} epoch lines, checkpoint {ckpt.name} exists: {ckpt.exists()}")
    if not epochs[1]["avg_loss"] < epochs[0]["avg_loss"]:
        fail(f"train: the loss did not fall over the epochs: {epochs}")
    for i, row in enumerate(steps):
        print(f"train step {i + 1}: x {row['shape'][0]} y {row['shape'][1]} loss {row['loss']:.4f} "
              f"(mle {row['mle_loss']:.4f}, dur {row['duration_loss']:.4f}) grad_norm "
              f"{row['grad_norm']:.4f}, {row['seconds'] * 1e3:.1f} ms [{device_line}]")
    step_ms = statistics.median(r["seconds"] for r in steps[1:]) * 1e3
    print(f"train: CLI {seconds:.1f} s (corpus load, DDI, 8 steps, 2 checkpoints), encoder_fuse auto; "
          f"median step after the first {step_ms:.1f} ms; epochs {epochs}; launches {got}")
    profile = profile_step(last, device_line, config.model)
    accum = accumulated_step(last, workdir / "fused_override.json", config_path, device_line)
    resume = resumed_run(workdir, corpus, manifest, config_path, steps, out, want, device_line)

    # the op-by-op text side still trains, and launches none of the text kernels
    u_launches, u_steps, _, _, u_seconds = run_train_cli(
        workdir, corpus, manifest, config_path, UNFUSED_OVERRIDE, "unfused", UNFUSED_STEPS, {}
    )
    u_blocks = UNFUSED_OVERRIDE["model"]["n_blocks_dec"]
    u_want = {"wn_forward": u_blocks, "block_fwd_save": u_blocks * UNFUSED_STEPS,
              "block_bwd_store": u_blocks * UNFUSED_STEPS, "mas": UNFUSED_STEPS,
              **{k: 0 for name in TEXT_KERNELS for k in (name, name + "_bwd")}}
    u_got = {k: u_launches[k] for k in u_want}
    if u_got != u_want:
        fail(f"train encoder_fuse false: launches {u_got}, expected {u_want}")
    print(f"train: encoder_fuse false, {UNFUSED_OVERRIDE['model']}: {UNFUSED_STEPS} steps in "
          f"{u_seconds:.1f} s, losses {[round(r['loss'], 4) for r in u_steps]}, launches {u_got}")
    return (launches, recorders, steps, step_ms, profile, ckpt,
            out / f"config_{1 + TRAIN_STEPS}.json", {"accumulated_step": accum, "resume": resume})


def clone_state(state, hp, device):
    """A copy of a train state: params, Adam moments and count, step."""
    from glow_tts_train_tpu_torch import training
    from glow_tts_train_tpu_torch.optimize import AdamState

    model = training.trainable_model(
        {k: p.detach() for k, p in state.model.flat().items()}, hp, device
    )
    copy_ = training.TrainState(model, state.step)
    copy_.opt = AdamState({k: v.clone() for k, v in state.opt.mu.items()},
                          {k: v.clone() for k, v in state.opt.nu.items()}, state.opt.count)
    return copy_


def accumulated_step(last: dict, override_path: Path, config_path: Path, device_line: str) -> dict:
    """One optimizer step at ``grad_accum_steps`` ACCUM_STEPS through the
    kernels against the full-batch step, each from a copy of the main run's
    state after its last step, on its last batch (b=16, dropout off: the
    slices draw other masks than the whole batch), each kernel of the
    default mode launched once a slice.

    MAS is an argmax over cumulative sums (~1e4 at this width, ulp ~1e-3),
    and the logp product rounds differently at b=8 and b=16 on the card, so
    a slice's alignment may differ from the whole batch's in a few cells
    (counted, ``path_cells_differing``, at most ACCUM_MAX_PATH_DIFF of the
    path's cells, with that step's metric errors).  The
    accumulation is then held on one alignment: the accumulated step again,
    its MAS kernel launched in every slice and its path replaced by the
    whole batch's rows: loss, mle and duration loss and grad norm within
    ACCUM_METRIC_RTOL, every param within ACCUM_PARAM_RTOL /
    ACCUM_PARAM_ATOL (ZERO_GRADIENT_LEAF within 2 lr: its Adam step is the
    sign of round-off).  Then both steps timed in turns (1, n, n, 1),
    ACCUM_TIMED_ROUNDS rounds, each from a fresh copy."""
    import torch

    from glow_tts_train_tpu_torch import kernels, training
    from glow_tts_train_tpu_torch.config import load_config
    from glow_tts_train_tpu_torch.models import hyper_from_config
    from glow_tts_train_tpu_torch.ops import mas_cuda

    base = last["state"]
    batch = last["batch"]
    configs = {}
    for accum in (1, ACCUM_STEPS):
        configs[accum] = load_config([config_path, override_path])
        configs[accum].grad_accum_steps = accum
    hp = hyper_from_config(configs[1])
    device = batch["x"].device
    kernel_mas = mas_cuda.maximum_path

    def run(accum, pinned=None):
        """-> (state, metrics, step ms, launch counts, the MAS paths)."""
        paths = []

        def mas(logp, mask):
            path = kernel_mas(logp, mask)
            if pinned is not None:
                path = pinned[sum(p.shape[0] for p in paths):][: path.shape[0]]
            paths.append(path)
            return path

        state = clone_state(base, hp, device)
        step_fn = training.make_train_step(configs[accum])
        mas_cuda.maximum_path = mas
        try:
            kernels.reset_launch_counts()
            torch.cuda.synchronize()
            start = time.perf_counter()
            metrics = step_fn(state, batch)
            torch.cuda.synchronize()
            ms = (time.perf_counter() - start) * 1e3
        finally:
            mas_cuda.maximum_path = kernel_mas
        return state, metrics, ms, kernels.launch_counts(), torch.cat(paths)

    def metric_errors(metrics, ref):
        return {k: abs(float(metrics[k]) - float(ref[k]))
                for k in ("loss", "mle_loss", "duration_loss", "grad_norm")}

    full, full_metrics, _, full_launches, full_path = run(1)
    _, free_metrics, _, _, free_path = run(ACCUM_STEPS)
    differ, path_cells = int((free_path != full_path).sum().item()), int(full_path.sum().item())
    if not differ <= ACCUM_MAX_PATH_DIFF * path_cells:
        fail(f"accumulated step: its alignment differs from the full batch's in {differ} cells "
             f"of {path_cells} on the path")
    acc, acc_metrics, _, acc_launches, _ = run(ACCUM_STEPS, pinned=full_path)
    n_blocks, n_layers = hp.n_blocks_dec, hp.n_layers_enc
    per_slice = {"block_fwd_save": n_blocks, "block_bwd_store": n_blocks, "mas": 1, "prenet": 1,
                 "prenet_bwd": 1, "encoder_layer": n_layers, "encoder_layer_bwd": n_layers,
                 "duration_stack": 1, "duration_stack_bwd": 1}
    for accum, launches in ((1, full_launches), (ACCUM_STEPS, acc_launches)):
        want = {k: v * accum for k, v in per_slice.items()}
        if {k: launches[k] for k in want} != want:
            fail(f"accumulated step x{accum}: launches {launches}, expected {want}")
    metric_err = metric_errors(acc_metrics, full_metrics)
    for key, err in metric_err.items():
        ref = float(full_metrics[key])
        if not err <= ACCUM_METRIC_ATOL + ACCUM_METRIC_RTOL * abs(ref):
            fail(f"accumulated step: {key} {float(acc_metrics[key])} against the full batch's {ref}")
    lr = training.learning_rate_fn(configs[1])(base.opt.count)
    full_params = full.model.flat()
    worst, zero_leaf_err = (0.0, None), 0.0
    for key, p in acc.model.flat().items():
        diff = (p - full_params[key]).abs()
        if key == ZERO_GRADIENT_LEAF:
            zero_leaf_err = diff.max().item()
            if not zero_leaf_err <= 2 * lr:
                fail(f"accumulated step: {key} moved {zero_leaf_err} apart, beyond 2 lr = {2 * lr}")
            continue
        excess = (diff - ACCUM_PARAM_RTOL * full_params[key].abs()).max().item()
        if not excess <= ACCUM_PARAM_ATOL:
            fail(f"accumulated step: {key} beyond rtol {ACCUM_PARAM_RTOL} by {excess}")
        if diff.max().item() >= worst[0]:
            worst = (diff.max().item(), key)
    times = {1: [], ACCUM_STEPS: []}
    for accum in (1, ACCUM_STEPS, ACCUM_STEPS, 1) * ACCUM_TIMED_ROUNDS:
        times[accum].append(run(accum)[2])
    free_err = metric_errors(free_metrics, full_metrics)
    row = {"batch_x": list(batch["x"].shape), "batch_y": list(batch["y"].shape),
           "grad_accum_steps": ACCUM_STEPS, "metric_abs_err": metric_err,
           "max_param_abs_err": worst[0], "worst_leaf": worst[1],
           f"{ZERO_GRADIENT_LEAF}_abs_err": zero_leaf_err, "lr": lr,
           "path_cells_differing": differ, "path_cells": path_cells,
           "metric_abs_err_own_paths": free_err,
           "step_ms_full": times[1], f"step_ms_accum_{ACCUM_STEPS}": times[ACCUM_STEPS],
           "median_step_ms_full": statistics.median(times[1]),
           f"median_step_ms_accum_{ACCUM_STEPS}": statistics.median(times[ACCUM_STEPS])}
    print(f"train accumulated step: x {row['batch_x']} at grad_accum_steps {ACCUM_STEPS} against "
          f"the full batch: with its own MAS paths {differ} cells differ ({path_cells} on the "
          f"path), metrics abs err {free_err}; on the full batch's paths metrics abs err "
          f"{metric_err}, params max abs err {worst[0]:.3e} ({worst[1]}), {ZERO_GRADIENT_LEAF} "
          f"{zero_leaf_err:.3e} (lr {lr:.3e}); step ms full {[round(t, 1) for t in times[1]]} "
          f"(median {row['median_step_ms_full']:.1f}), accumulated "
          f"{[round(t, 1) for t in times[ACCUM_STEPS]]} (median "
          f"{row[f'median_step_ms_accum_{ACCUM_STEPS}']:.1f}); launches "
          f"{ {k: acc_launches[k] for k in per_slice} } [{device_line}]")
    return row


def resumed_run(workdir: Path, corpus: Path, manifest: dict, config_path: Path, main_steps: list,
                main_out: Path, per_run: dict, device_line: str, override: dict = TRAIN_OVERRIDE,
                n_steps: int = TRAIN_STEPS, main_tag: str = "fused", tag: str = "",
                corpus_symbols: bool = True) -> dict:
    """Through the train CLI: 1 epoch (fresh init, DDI), its checkpoint, and
    1 epoch resumed from it (params, Adam moments and count, global step),
    against the main run's 2 epochs: the first run's checkpoint equals the
    main run's epoch-1 checkpoint bit for bit, every resumed step's loss
    equals the main run's step, and the resumed run's last checkpoint and
    metrics line equal the main run's; each kernel launched as the main
    run's second epoch launched it (no DDI)."""
    import numpy as np

    half = n_steps // 2
    one_epoch = dict(override, epochs=1)
    first_launches, _, _, first_out, _ = run_train_cli(
        workdir, corpus, manifest, config_path, one_epoch, tag + "first", half, {},
        corpus_symbols=corpus_symbols,
    )
    mid = f"checkpoint_{1 + half}.npz"
    launches, steps, _, out, seconds = run_train_cli(
        workdir, corpus, manifest, config_path, one_epoch, tag + "resumed", half, {},
        extra=("--checkpoint", str(first_out / mid)), corpus_symbols=corpus_symbols,
    )
    want = {k: 0 if k == "wn_forward" else v // 2 for k, v in per_run.items()}
    if {k: launches[k] for k in want} != want:
        fail(f"train resumed: launches {launches}, expected {want}")
    last_ckpt = f"checkpoint_{1 + n_steps}.npz"
    for name, a, b in ((mid, first_out / mid, main_out / mid),
                       (last_ckpt, out / last_ckpt, main_out / last_ckpt)):
        with np.load(a) as x, np.load(b) as y:
            if sorted(x.files) != sorted(y.files) or not any(k.startswith("opt/1/mu/") for k in x.files):
                fail(f"train resumed: {name} keys differ or hold no Adam state")
            differ = [k for k in x.files if not np.array_equal(x[k], y[k])]
            if differ:
                fail(f"train resumed: {name} differs from the uninterrupted run's at {differ[:8]}")
    losses = [row["loss"] for row in steps]
    ref = [row["loss"] for row in main_steps[half:]]
    if losses != ref:
        fail(f"train resumed: step losses {losses}, the uninterrupted run's {ref}")
    line = json.loads((workdir / f"{tag}resumed.jsonl").read_text().splitlines()[-1])
    main_line = json.loads((workdir / f"{main_tag}.jsonl").read_text().splitlines()[-1])
    keys = ("global_step", "avg_loss", "learning_rate")
    if any(line[k] != main_line[k] for k in keys):
        fail(f"train resumed: metrics line {line}, the uninterrupted run's {main_line}")
    print(f"train {tag}resumed: 1 epoch, {mid}, 1 resumed epoch ({seconds:.1f} s) equal the 2-epoch run: "
          f"step losses {[round(x, 6) for x in losses]}, checkpoints and metrics line bit for bit; "
          f"launches {dict((k, launches[k]) for k in want)} [{device_line}]")
    return {"step_losses": losses, "metrics_line": {k: line[k] for k in keys},
            "first_run_launches": {k: first_launches[k] for k in want}}


def profiled(fn) -> tuple:
    """``fn()`` once under torch.profiler -> (wall ms, the device's self time
    in ms by kernel or copy, its count of device operations).  A trace
    that comes back without a device record (seen once in the forty-odd
    traces of one run of this script) is taken again, at most twice; see
    also ``device_ms``."""
    import torch
    from torch.profiler import ProfilerActivity, profile

    for _ in range(3):
        torch.cuda.synchronize()
        # the device's records only: with the host's on too, traces of the
        # text kernels' calls came back short of device records
        with profile(activities=[ProfilerActivity.CUDA]) as prof:
            start = time.perf_counter()
            fn()
            torch.cuda.synchronize()
            wall_ms = (time.perf_counter() - start) * 1e3
        by_kernel, launches = {}, 0
        for e in prof.key_averages():
            if e.device_type.name == "CUDA":
                by_kernel[e.key] = e.self_device_time_total / 1e3
                launches += e.count
        if launches:
            break
    return wall_ms, by_kernel, launches


def device_profile(fn, runs: int = 1) -> tuple:
    """(the device's own time for one call of ``fn`` in ms, its device
    operations a call): the self time of its kernels and copies under
    torch.profiler, mean of ``runs`` calls in one trace.  A trace can come
    back short of some device records, so two of up to six traces must
    count the same device operations, a multiple of ``runs`` (every call
    issues the same operations; the smaller time of those is taken);
    (None, None) where none agree."""
    seen = {}
    for _ in range(6):
        _, by_kernel, operations = profiled(lambda: [fn() for _ in range(runs)])
        total = sum(by_kernel.values())
        if operations % runs:
            continue  # a trace short of records
        if operations and operations in seen:
            return min(seen[operations], total) / runs, operations / runs
        seen[operations] = total
    return None, None


def device_ms(fn, runs: int = 1):
    """The device's own time for one call of ``fn`` in ms (``device_profile``)."""
    return device_profile(fn, runs)[0]


def profile_step(last: dict, device_line: str, model) -> dict:
    """One more step on the last batch under torch.profiler: wall time,
    device busy time (the kernels' and copies' self time; one stream, so
    they add up), idle share, kernel launches, and the top kernels."""

    def step():
        last["step_fn"](last["state"], last["batch"], *last["args"])

    from glow_tts_train_tpu_torch import kernels
    from glow_tts_train_tpu_torch.ops import text_cuda

    if not model.prenet:
        fail("train: the base config has a prenet")
    # the step's device products: every product of the 12 block forward and
    # 12 block backward chains on the tensor cores, none of them declined,
    # and the encoder layers', the prenet's and the duration stack's where
    # the batch's rows fill the card
    kernels.product_counts(reset=True)
    step()
    products = kernels.product_counts(reset=True)
    n_blocks, n_layers = model.n_blocks_dec, model.n_layers_enc
    rows = last["batch"]["x"].numel()
    block = block_products(model.n_block_layers, forward=n_blocks, backward=n_blocks)
    text = encoder_products(
        rows, model.hidden_channels_enc or model.hidden_channels,
        model.filter_channels, model.kernel_size, forward=n_layers, backward=n_layers,
    )
    tree = last["state"].model.tree()
    prenet = prenet_products(rows, text_cuda.prenet_weights(tree["prenet"]), forward=1, backward=1)
    duration = duration_products(rows, text_cuda.dp_weights(tree["proj_w"]), forward=1, backward=1)
    want = {k: block[k] + text[k] + prenet[k] + duration[k] for k in block}
    if {k: products[k] for k in want} != want:
        fail(f"train step: device products {products}, expected {want}")
    wall_ms, by_kernel, launches = profiled(step)
    busy_ms = sum(by_kernel.values())
    tc = {name: sum(v for k, v in by_kernel.items() if name in k)
          for name in ("conv_gemm_tc_kernel", "conv_gemm_tap_kernel", "conv_gemm_tma_kernel",
                       "wgrad_tc_kernel",
                       "wgrad_tc_split_kernel", "wgrad_reduce_kernel", "split_weights_kernel",
                       "conv_gemm_kernel", "wgrad_kernel", "col_sum_kernel")}
    block = sum(tc.values())
    attention = sum(v for k, v in by_kernel.items()
                    if any(a in k for a in ("attention_tc_kernel", "attn_bwd", "rel_grads")))
    norms = sum(v for k, v in by_kernel.items() if "layer_norm" in k)
    top = sorted(by_kernel.items(), key=lambda kv: -kv[1])[:8]
    row = {
        "batch_x": list(last["batch"]["x"].shape), "batch_y": list(last["batch"]["y"].shape),
        "wall_ms": wall_ms, "device_busy_ms": busy_ms,
        "idle_share": 1.0 - busy_ms / wall_ms if busy_ms > 0 else None,
        "device_launches": launches, "gemm_wgrad_colsum_ms": block,
        "device_products": products, "device_ms_by_kernel": tc,
        "attention_ms": attention, "layer_norm_ms": norms,
        "top_ms": {k[:70]: v for k, v in top},
    }
    print(f"train profiled step: x {row['batch_x']} y {row['batch_y']} wall {wall_ms:.1f} ms, "
          f"device busy {busy_ms:.1f} ms, idle share {row['idle_share']}, {launches} device "
          f"operations, device products {products}, conv_gemm+wgrad+col_sum of both kinds "
          f"{block:.1f} ms ({ {k: round(v, 2) for k, v in tc.items()} }), attention fwd+bwd "
          f"{attention:.1f} ms, layer_norm fwd+bwd {norms:.1f} ms [{device_line}]")
    for k, v in top:
        print(f"  {v:9.3f} ms  {k[:100]}")
    return row


def serve_trained(ckpt: Path, config: Path, n_mel: int) -> None:
    """One request through the infer CLI from the trained checkpoint."""
    import numpy as np

    from glow_tts_train_tpu_torch import infer

    out = io.StringIO()
    old_stdin = sys.stdin
    sys.stdin = io.StringIO("3 7 12 5 9 14 2 21 30 4 8 11\n")
    try:
        with contextlib.redirect_stdout(out):
            infer.main([str(ckpt), "--config", str(config), "--platform", PLATFORM])
    finally:
        sys.stdin = old_stdin
    mel = np.asarray(json.loads(out.getvalue().splitlines()[0])["mel"], np.float32)
    if mel.ndim != 2 or mel.shape[0] != n_mel or not np.isfinite(mel).all():
        fail(f"serving the trained checkpoint: mel shape {mel.shape}")
    print(f"train: the trained checkpoint {ckpt.parent.name}/{ckpt.name} serves a 12-phoneme "
          f"request: mel {list(mel.shape)}")


def entry_writer(report: list, launches: dict, device_line: str):
    """-> entry(name, err, scale, ms, plain_ms, shape, roof, **extra): appends
    one kernel's line to ``report`` (its launches from ``launches``) and
    prints it."""

    def entry(name, err, scale, ms, plain_ms, shape, roof, **extra):
        held_to_bound(name, ms, roof)
        source, replaces = KERNEL_META[name]
        report.append({
            "name": name, "route": "cuda", "source": source, "replaces": replaces,
            "launches": launches[name], "max_abs_err": err, "ms": ms, "plain_ms": plain_ms,
            **roof, "shape": shape, "max_abs_ref": scale, **extra,
        })
        on_device = (f" ({roof['device_ms']:.4f} on the device, {roof['device_operations']} device "
                     f"operations a call)" if roof.get("device_ms") else "")
        print(f"kernel {name}: {shape} err {err:.3e} (max|ref| {scale:.3e}) kernel {ms:.4f} ms"
              f"{on_device}, plain {plain_ms:.4f} ms, bound {roof['bound_ms']:.4f} ms by "
              f"{roof['bound_by']}, products {roof.get('products')} {extra or ''}[{device_line}]")

    return entry


def held_gradients(name: str, grads: dict, names: list, ref) -> float:
    """Every gradient ``grads[n]`` against ``ref`` within KERNEL_RTOL of its
    max -> the worst error relative to its gradient's max."""
    worst = 0.0
    for n, r in zip(names, ref):
        e, sc = rel_err(f"{name} {n}", grads[n], r, KERNEL_RTOL)
        if r.abs().max().item() == 0.0:
            fail(f"{name}: {n} is zero in the plain version: nothing was compared")
        worst = max(worst, e / max(sc, 1e-6))
    return worst


def block_products(n_layers: int, forward: int, backward: int) -> dict:
    """Tensor-core products of ``forward`` block forward chains and
    ``backward`` block backward chains (csrc/block_train.cu), none of the
    products that ask for the tensor cores declined.  Forward: the start
    conv, per WN layer the in-conv and the res/skip conv, the end conv (the
    folded A's product does not ask: it stays on the CUDA cores, see
    block_fwd_chain).  Backward: the coupling's rebuilt logs, dskip, per
    layer da and the transposed in-conv, the start conv's and the folded A's
    input gradients; weight gradients dW_e, per layer dW_rs and dW_in, dW_s,
    dA."""
    return {
        "tc_gemm": forward * (2 + 2 * n_layers) + backward * (4 + 2 * n_layers),
        "tc_wgrad": backward * (3 + 2 * n_layers),
        "declined_gemm": 0, "declined_wgrad": 0,
    }


def encoder_products(rows: int, h: int, f: int, taps: int, forward: int, backward: int) -> dict:
    """Device products of ``forward`` encoder-layer forward chains and
    ``backward`` backward chains (each recomputes the forward) over ``rows``
    rows (csrc/encoder.cu, csrc/encoder_train.cu): every product asks for
    the tensor cores and takes them where ``conv_gemm_tc_fits`` /
    ``wgrad_tc_fits`` say so (``tc_gemm.text_product_plan``: at least 64
    columns and blocks for a quarter of the SMs, 128-row tiles times K
    shares; 256 rows), else it is declined to the CUDA cores.  Forward:
    Q/K/V, the output projection, the FFN's two convs; backward: those
    again, the FFN's two transposed convs, the projection's and Q/K/V's
    input gradients, and four weight gradients."""
    import torch

    from glow_tts_train_tpu_torch.ops import tc_gemm

    sms = torch.cuda.get_device_properties(0).multi_processor_count
    # (K, N) of each conv-GEMM
    fwd = ((h, 3 * h), (h, h), (taps * h, f), (taps * f, h))
    bwd = fwd + ((taps * h, f), (taps * f, h), (h, h), (3 * h, h))
    counts = dict(tc_gemm=0, tc_wgrad=0, core_gemm=0, core_wgrad=0,
                  declined_gemm=0, declined_wgrad=0, **tc_gemm.WALK_MODES_NONE)
    for chains, products in ((forward, fwd), (backward, bwd)):
        for k, n in products:
            on = tc_gemm.text_product_plan(rows, k, n, sms)[0]
            counts["tc_gemm"] += chains * on
            counts["core_gemm"] += chains * (not on)
            counts["declined_gemm"] += chains * (not on)
    on = rows >= 256
    counts["tc_wgrad" if on else "core_wgrad"] += 4 * backward
    counts["declined_wgrad"] += 0 if on else 4 * backward
    return counts


def prenet_products(rows: int, weights: tuple, forward: int, backward: int) -> dict:
    """Device products of ``forward`` prenet forward chains and ``backward``
    backward chains over ``rows`` rows (``tc_gemm.prenet_products``, the
    plan of ``tc_gemm.text_product_plan`` on this card's SMs): the convs and
    the projection on the tensor cores where the rows fill the card, split-K
    for the short, deep ones; at b=1 declined to the CUDA cores."""
    import torch

    from glow_tts_train_tpu_torch.ops import tc_gemm

    w = weights[0]
    n_layers, h = w.shape[0], w.shape[2]
    sms = torch.cuda.get_device_properties(0).multi_processor_count
    return tc_gemm.prenet_products(rows, h, n_layers, w.shape[1] // h, sms, forward, backward)


def held_inverse_plan(name: str, args, roof: dict) -> dict:
    """The products of one serving block call against its plan
    (``tc_gemm.block_inverse_products`` on this card's SMs: each product on
    the tensor cores where the plan puts it, in its tile and K shares, the
    rest declined to the CUDA cores) -> the plan."""
    import torch

    from glow_tts_train_tpu_torch.ops import tc_gemm

    folded, x = args[0], args[2]
    n_layers, kh, h2 = folded["W_in"].shape
    sms = torch.cuda.get_device_properties(0).multi_processor_count
    plan = tc_gemm.block_inverse_products(
        x.shape[0] * x.shape[1], x.shape[2], h2 // 2, n_layers, kh * 2 // h2, sms)
    want = dict(tc_gemm.plan_counts(plan), tc_wgrad=0, core_wgrad=0, declined_wgrad=0,
                **tc_gemm.WALK_MODES_NONE)
    if roof["products"] != want:
        fail(f"{name} {list(x.shape)}: device products {roof['products']}, expected {want} "
             f"by the plan {plan}")
    return plan


def held_inverse_splits(folded: dict) -> None:
    """The serving weights' splits made at load (on the CPU, by the plain
    version) equal the split kernel's own on the card, bit for bit."""
    import torch

    from glow_tts_train_tpu_torch.ops import block_cuda, tc_gemm

    for key in block_cuda.INVERSE_SPLIT_KEYS:
        w = folded[key]
        on_card = torch.stack([tc_gemm.split_weights(wl) for wl in w]) if w.dim() == 3 else \
            tc_gemm.split_weights(w)
        if not torch.equal(on_card, folded[key + "_split"]):
            fail(f"block_inverse: the split of {key} made at load differs from the kernel's bits")


def serving_block_b1(args, phonemes: int, device_line: str) -> dict:
    """The serving block on the inputs of a b=1 request: against its plain
    version (KERNEL_RTOL), times by events and on the device, its device
    operations, its products against the plan, its bound."""
    import torch

    from glow_tts_train_tpu_torch.ops import block_cuda

    args, kwargs = args
    with torch.inference_mode():
        out_k = block_cuda.block_inverse(*args, **kwargs)
        out_p = block_cuda.block_inverse_plain(*args, **kwargs)
        err, scale = rel_err(f"block_inverse b=1 {phonemes} phonemes", out_k, out_p, KERNEL_RTOL)
        ms = time_ms(block_cuda.block_inverse, args, kwargs)
        plain_ms = time_ms(block_cuda.block_inverse_plain, args, kwargs)
        roof = bound("block_inverse", args, kwargs, out_k, block_cuda.block_inverse)
    held_to_bound(f"block_inverse b=1 {phonemes} phonemes", ms, roof)
    plan = held_inverse_plan(f"block_inverse b=1 {phonemes} phonemes", args, roof)
    row = {"shape": list(args[2].shape), "max_abs_err": err, "max_abs_ref": scale, "ms": ms,
           "plain_ms": plain_ms, **roof,
           "plan": [f"{p['name']} {p['tile_rows']}x{p['splits']}" for p in plan]}
    print(f"kernel block_inverse b=1 ({phonemes} phonemes): x {row['shape']} err {err:.3e} "
          f"(max|ref| {scale:.3f}) kernel {ms:.4f} ms ({roof.get('device_ms')} on the device, "
          f"{roof.get('device_operations')} device operations a call), plain {plain_ms:.4f} ms, "
          f"bound {roof['bound_ms']:.4f} ms by {roof['bound_by']}, products {roof['products']}, "
          f"plan (tile rows x K shares; 0: CUDA cores) {row['plan']} [{device_line}]")
    return row


def duration_products(rows: int, weights: tuple, forward: int, backward: int) -> dict:
    """Device products of ``forward`` duration-stack forward chains and
    ``backward`` backward chains over ``rows`` rows
    (``tc_gemm.duration_products`` on this card's SMs): both convs, their
    transposed convs and weight gradients on the tensor cores where the
    rows fill the card, split-K for the short, deep ones; at b=1 declined
    to the CUDA cores."""
    import torch

    from glow_tts_train_tpu_torch.ops import tc_gemm

    w1, w2 = weights[0], weights[4]
    f = w1.shape[1]
    taps = w2.shape[0] // f
    sms = torch.cuda.get_device_properties(0).multi_processor_count
    return tc_gemm.duration_products(rows, w1.shape[0] // taps, f, taps, sms, forward, backward)


def held_walk_plan(name: str, fn, roof: dict, rows: int, c: int, folded_in, taps: int,
                   rate: int, recompute: bool, with_g: bool) -> dict:
    """A backward of the flow decoder (the WN walk alone, c 0, or in the
    block) against its plan (``tc_gemm.walk_products`` on this card's SMs):
    its product counts (``roof``, from the call ``bound`` made) and the
    device operations of one call of ``fn`` (``bracketed_trace``) -> the
    plan, with ``device_ms``: the call's device time in that trace."""
    import torch

    from glow_tts_train_tpu_torch.ops import tc_gemm

    n_layers, kh, h2 = folded_in.shape
    sms = torch.cuda.get_device_properties(0).multi_processor_count
    plan = tc_gemm.walk_products(rows, c, h2 // 2, n_layers, taps, rate, sms, recompute, with_g)
    if roof["products"] != plan["counts"]:
        fail(f"{name}: device products {roof['products']}, expected {plan['counts']} by its plan")
    ops = bracketed_trace(fn, calls=1)
    if len(ops) != plan["launches"]:
        fail(f"{name}: {len(ops)} device operations a call, expected {plan['launches']} by its "
             f"plan: {[n[:60] for n, _ in ops]}")
    on_device = sum(us for _, us in ops) / 1e3
    print(f"kernel {name}: {len(ops)} device operations a call as its plan has them, "
          f"{on_device:.4f} ms on the device")
    return dict(plan, device_ms=on_device)


def held_forward_plan(name: str, fn, roof: dict, rows: int, c: int, folded_in, taps: int,
                      rate: int, save: bool) -> dict:
    """A forward of the flow decoder (the WN stack alone, c 0, or the flow
    block; ``save``: the forward-save call) against its plan
    (``tc_gemm.forward_products`` on this card's SMs): its product counts
    (``roof``, from the call ``bound`` made) and the device operations of
    one call of ``fn`` (``bracketed_trace``), the weight-split launch its
    first and only one -> the plan, with ``device_ms``: the call's device
    time in that trace."""
    import torch

    from glow_tts_train_tpu_torch.ops import tc_gemm

    n_layers, kh, h2 = folded_in.shape
    sms = torch.cuda.get_device_properties(0).multi_processor_count
    plan = tc_gemm.forward_products(rows, c, h2 // 2, n_layers, taps, rate, sms, save)
    if roof["products"] != plan["counts"]:
        fail(f"{name}: device products {roof['products']}, expected {plan['counts']} by its plan")
    ops = bracketed_trace(fn, calls=1)
    if len(ops) != plan["launches"]:
        fail(f"{name}: {len(ops)} device operations a call, expected {plan['launches']} by its "
             f"plan: {[n[:60] for n, _ in ops]}")
    splits = [i for i, (n, _) in enumerate(ops) if "split_weights_kernel" in n]
    if splits != ([0] if plan["splits"] else []):
        fail(f"{name}: weight-split launches at {splits} of a call's operations (one, first, "
             "expected)")
    on_device = sum(us for _, us in ops) / 1e3
    print(f"kernel {name}: {len(ops)} device operations a call as its plan has them, one "
          f"weight-split launch first, {plan['counts']['tma_gemm']} TMA-fed products, "
          f"{on_device:.4f} ms on the device")
    return dict(plan, device_ms=on_device)


def forward_product_lines(fn, plan: dict, n_layers: int, device_line: str) -> dict:
    """One layer's two products of a ``wn_fwd_save`` call by the device's
    own time (the in-layer conv and the res/skip, the call's conv-GEMMs
    alternating in launch order), and the call's weight split and input
    copy, from a trace of 3 calls.  Fails unless each call holds its plan's
    device operations with one weight split, its first."""
    calls = 3
    ops = bracketed_trace(fn, calls)
    per_call = plan["launches"]
    if len(ops) != calls * per_call:
        fail(f"forward trace: {len(ops)} device operations in {calls} calls, {per_call} a call "
             "expected")
    total = {"in_conv": 0.0, "res_skip": 0.0, "splits": 0.0, "copy": 0.0}
    kernels_of = {"in_conv": set(), "res_skip": set()}
    for c in range(calls):
        call = ops[c * per_call:(c + 1) * per_call]
        splits = [i for i, (n, _) in enumerate(call) if "split_weights_kernel" in n]
        if splits != [0]:
            fail(f"forward trace: weight-split launches at {splits} of a call's operations "
                 "(one, first, expected)")
        gemm = 0
        for n, us in call:
            if "split_weights_kernel" in n:
                total["splits"] += us
            elif "emcpy" in n:
                total["copy"] += us
            else:
                kind = "in_conv" if gemm % 2 == 0 else "res_skip"
                total[kind] += us
                kernels_of[kind].add(n.split("(")[0].replace("void ", "").split("::")[-1])
                gemm += 1
    by_name = {p["name"]: p for p in plan["products"]}
    rows = {}
    for kind, p in (("in_conv", by_name["in_0"]), ("res_skip", by_name["res_skip_0"])):
        us = total[kind] / (calls * n_layers)
        flops = 2.0 * math.prod(p["shape"])
        rows[kind] = {"shape": p["shape"], "mode": p["mode"], "tile_rows": p["tile_rows"],
                      "cluster": p["cluster"], "kernels": sorted(kernels_of[kind]),
                      "device_us": us, "tflops": flops / us / 1e6,
                      "bound_us": flops / PEAK_3XTF32_FLOPS * 1e6}
        print(f"product wn_fwd {kind}: {p['shape']} {p['mode']}, {p['tile_rows']}-row tiles, "
              f"clusters of {p['cluster']} ({', '.join(rows[kind]['kernels'])}): {us:.1f} us on "
              f"the device a layer = {rows[kind]['tflops']:.1f} TFLOP/s, bound "
              f"{rows[kind]['bound_us']:.1f} us at 165 TFLOP/s [{device_line}]")
    rows["splits_us"] = total["splits"] / calls
    rows["copy_us"] = total["copy"] / calls
    print(f"product wn_fwd splits: {rows['splits_us']:.1f} us a call in one launch; copy: "
          f"{rows['copy_us']:.1f} us a call; {per_call} device operations a call [{device_line}]")
    return rows


def bracketed_trace(fn, calls: int) -> list:
    """The device operations of ``calls`` calls of ``fn`` in launch order,
    [(name, device us)], from one trace under torch.profiler in which they
    stand between spin kernels (``torch.cuda._sleep``), 16 launched before
    the calls and 16 after.  Traces late in this script come back short of
    records at an edge (1 to 4 seen, the first or the last ones) or with
    none (3 traces of 4 in a row seen), so a trace counts only where a spin
    kernel is left on each side of the calls' operations (up to
    BRACKET_TRACES are taken)."""
    import torch
    from torch.profiler import ProfilerActivity, profile

    fn()
    seen = []
    for _ in range(BRACKET_TRACES):
        torch.cuda.synchronize()
        with profile(activities=[ProfilerActivity.CUDA]) as prof:
            for _ in range(16):
                torch.cuda._sleep(1000)
            for _ in range(calls):
                fn()
            for _ in range(16):
                torch.cuda._sleep(1000)
            torch.cuda.synchronize()
        ops = sorted((e for e in prof.events() if e.device_type.name == "CUDA"),
                     key=lambda e: e.time_range.start)
        spin = ["spin" in e.name for e in ops]
        inner = [i for i, is_spin in enumerate(spin) if not is_spin]
        if inner and any(spin[:inner[0]]) and any(spin[inner[-1]:]):
            if not any(spin[inner[0]:inner[-1]]):
                return [(ops[i].name, ops[i].time_range.elapsed_us()) for i in inner]
        seen.append((sum(spin[:inner[0]]) if inner else sum(spin), len(inner),
                     sum(spin[inner[-1]:]) if inner else 0))
    fail(f"bracketed trace: no trace of {BRACKET_TRACES} held a spin kernel on each side of the "
         f"calls' operations (spins before, operations, spins after): {seen}")


def bracketed_groups(fns, calls: int) -> list:
    """The device operations of ``calls`` calls of each of ``fns`` in
    launch order, [[(name, device us)] for each fn], from one trace under
    torch.profiler in which each fn's calls stand between spin kernels (16
    before the first, 4 between two, 16 after the last): many short
    measurements in one trace, where a trace each would add a trace each
    to a script whose late traces come back short of records (see
    bracketed_trace).  A trace counts only where every group is there."""
    import torch
    from torch.profiler import ProfilerActivity, profile

    for fn in fns:
        fn()
    seen = []
    for _ in range(BRACKET_TRACES):
        torch.cuda.synchronize()
        with profile(activities=[ProfilerActivity.CUDA]) as prof:
            for _ in range(16):
                torch.cuda._sleep(1000)
            for i, fn in enumerate(fns):
                for _ in range(calls):
                    fn()
                for _ in range(4 if i + 1 < len(fns) else 16):
                    torch.cuda._sleep(1000)
            torch.cuda.synchronize()
        ops = sorted((e for e in prof.events() if e.device_type.name == "CUDA"),
                     key=lambda e: e.time_range.start)
        groups, run = [], []
        for e in ops:
            if "spin" in e.name:
                if run:
                    groups.append(run)
                run = []
            else:
                run.append((e.name, e.time_range.elapsed_us()))
        if ops and "spin" in ops[0].name and not run and len(groups) == len(fns):
            return groups
        seen.append((len(ops), len(groups)))
    fail(f"bracketed groups: no trace of {BRACKET_TRACES} held {len(fns)} groups of operations "
         f"between spin kernels (operations, groups): {seen}")


def walk_trace(fn, operations: int, calls: int = 3) -> list:
    """``calls`` calls of ``fn`` in one bracketed trace -> each call's
    device operations in launch order, [(name, device us)] a call.  Fails
    unless each call holds ``operations`` of them, its one weight-split
    launch first and no column sum."""
    ops = bracketed_trace(fn, calls)
    if len(ops) != calls * operations:
        fail(f"walk trace: {len(ops)} device operations in {calls} calls, {operations} a call "
             "expected")
    per_call = [ops[i * operations:(i + 1) * operations] for i in range(calls)]
    for call in per_call:
        splits = [i for i, (n, _) in enumerate(call) if "split_weights_kernel" in n]
        if splits != [0]:
            fail(f"walk trace: weight split launches at {splits} of a call's operations "
                 "(one, first, expected)")
        if any("col_sum_kernel" in n for n, _ in call):
            fail("walk trace: a column-sum launch inside the walk without dg")
    return per_call


# the walk's products by the device kernel each launches (a second pass
# belongs to the weight gradient before it)
WALK_KERNELS = (("conv_gemm_tap_kernel", "transposed_conv"), ("conv_gemm_tc_kernel", "gate_bwd"),
                ("wgrad_tc_split_kernel", "dW_in"), ("wgrad_tc_kernel", "dW_rs"))


def walk_product_lines(fn, plan: dict, n_layers: int, device_line: str) -> dict:
    """One layer's four walk products of a ``wn_bwd_store`` call (no dg) by
    the device's own time, from a trace of 3 calls in launch order: the
    transposed conv (its mode and tile), dW_in and dW_rs with their bias
    rows and second passes, the gate backward.  Fails if the call splits a
    weight beyond its one split launch or runs a column sum."""
    calls = walk_trace(fn, plan["launches"])
    total = {k: 0.0 for _, k in WALK_KERNELS}
    for ops in calls:
        last = None
        for name, us in ops:
            kind = next((k for key, k in WALK_KERNELS if key in name), None)
            if kind is not None:
                last = kind
            elif "wgrad_reduce_kernel" in name and last in ("dW_in", "dW_rs"):
                kind = last
            if kind is not None:
                total[kind] += us
    per_layer = {k: v / (len(calls) * n_layers) for k, v in total.items()}
    by_name = {p["name"].rsplit("_", 1)[0]: p for p in plan["products"]}
    rows = {}
    for kind, us in per_layer.items():
        p = by_name["transposed" if kind == "transposed_conv" else
                    "gate" if kind == "gate_bwd" else kind]
        flops = 2.0 * math.prod(p["shape"])  # [rows, K, N] or [K, rows, N]
        rows[kind] = {"shape": p["shape"], "mode": p["mode"], "tile_rows": p["tile_rows"],
                      "splits": p["splits"], "bias_row": p["bias"], "device_us": us,
                      "tflops": flops / us / 1e6, "bound_us": flops / PEAK_3XTF32_FLOPS * 1e6}
        print(f"product wn_walk {kind}: {p['shape']} {p['mode']}, {p['tile_rows']}-row tiles"
              f"{', bias row' if p['bias'] else ''}"
              f"{', %d row splits' % p['splits'] if p['kind'] == 'wgrad' else ''}: "
              f"{us:.1f} us on the device a layer = {rows[kind]['tflops']:.1f} TFLOP/s, bound "
              f"{rows[kind]['bound_us']:.1f} us at 165 TFLOP/s [{device_line}]")
    return rows


def held_products(name: str, roof: dict, forward: int, backward: int, n_layers: int) -> None:
    """The products of one call of a block kernel: on the tensor cores but
    for the forward's folded A."""
    want = dict(block_products(n_layers, forward, backward), core_gemm=forward, core_wgrad=0)
    got = {k: roof["products"][k] for k in want}
    if got != want:
        fail(f"{name}: device products {roof['products']}, expected {want}")


def training_kernels(recorders: dict, launches: dict, device_line: str) -> tuple:
    """Each training kernel against its plain version on the recorded
    inputs, and both timed -> (the kernels' report entries, the text
    stacks' forward kernels held again with dropout on)."""
    import numpy as np
    import torch

    from glow_tts_train_tpu_torch.ops import block_cuda, mas_cuda, wn_cuda

    report = []
    entry = entry_writer(report, launches, device_line)

    # WN forward (DDI)
    args, kwargs = recorders["wn_forward"].args
    with torch.no_grad():
        skip = recorders["wn_forward"].fn(*args, **kwargs)
        err, scale = rel_err("wn_forward", skip, wn_cuda.wn_stack_plain(*args, **kwargs), KERNEL_RTOL)
        roof = bound("wn_forward", args, kwargs, skip, recorders["wn_forward"].fn)
        wn, _, x, _, *cfg = args
        plan = held_forward_plan("wn_forward", lambda: recorders["wn_forward"].fn(*args, **kwargs),
                                 roof, x.shape[0] * x.shape[1], 0, wn[0], cfg[0], cfg[1], False)
        entry("wn_forward", err, scale, time_ms(recorders["wn_forward"].fn, args, kwargs),
              time_ms(wn_cuda.wn_stack_plain, args, kwargs), list(args[2].shape), roof,
              device_operations_plan=plan["launches"], device_ms_whole_traces=plan["device_ms"])

    # block forward-save: z, ld and every saved residual
    args, kwargs = recorders["block_fwd_save"].args
    folded, g_all, x, x_mask, *cfg = args
    with torch.no_grad():
        z, ld, saves = block_cuda.block_fwd_save(*args, **kwargs)
        ref_saves: dict = {}
        z_p, ld_p = block_cuda.block_forward_plain(folded, g_all, x, x_mask, *cfg, saves=ref_saves)
        errs = [rel_err("block_fwd_save z", z, z_p, KERNEL_RTOL),
                rel_err("block_fwd_save ld", ld, ld_p, KERNEL_RTOL)]
        for k in ("zp", "skipm"):
            errs.append(rel_err(f"block_fwd_save {k}", saves[k], ref_saves[k], KERNEL_RTOL))
        for k in ("xs", "th", "sg"):
            errs.append(rel_err(f"block_fwd_save {k}", saves[k], torch.stack(ref_saves[k]), KERNEL_RTOL))
        err, scale = errs[0]
        ms = time_ms(block_cuda.block_fwd_save, args, kwargs)
        plain_ms = time_ms(block_cuda.block_forward_plain, (folded, g_all, x, x_mask, *cfg), {})
        roof = bound("block_fwd_save", args, kwargs, (z, ld, saves), block_cuda.block_fwd_save)
    held_products("block_fwd_save", roof, n_layers=folded["W_in"].shape[0], forward=1, backward=0)
    plan = held_forward_plan("block_fwd_save", lambda: block_cuda.block_fwd_save(*args, **kwargs),
                             roof, x.shape[0] * x.shape[1], x.shape[2], folded["W_in"], cfg[0],
                             cfg[1], True)
    entry("block_fwd_save", err, scale, ms, plain_ms, list(x.shape), roof, p_dropout=cfg[3],
          max_abs_err_ld=errs[1][0], max_abs_err_saves=max(e for e, _ in errs[2:]),
          device_operations_plan=plan["launches"], device_ms_whole_traces=plan["device_ms"])

    # block backward-store: every gradient against autograd of the plain forward
    args, kwargs = recorders["block_bwd_store"].args
    folded, with_g, x, x_mask, saves, dz, dld, *cfg = args
    # the backward is linear in (dz, dld): scaled to max |dz| = 1, the
    # gradients are O(1) instead of O(1 / frames) as the mean loss makes them
    unit = dz.abs().max().clamp_min(1e-30)
    dz, dld = dz / unit, dld / unit
    args = (folded, with_g, x, x_mask, saves, dz, dld, *cfg)
    grads = block_cuda.block_bwd_store(*args, **kwargs)
    fp = {k: v.detach().clone().requires_grad_(True) for k, v in folded.items()}
    xp = x.detach().clone().requires_grad_(True)
    inputs = [xp] + [fp[k] for k in block_cuda.FOLD_KEYS]
    z_p, ld_p = block_cuda.block_forward_plain(fp, None, xp, x_mask, *cfg)
    if with_g:
        fail("block_bwd_store: the base config has no speaker conditioning")
    loss = (z_p * dz).sum() + (ld_p * dld).sum()
    ref = torch.autograd.grad(loss, inputs, retain_graph=True)
    worst = held_gradients(
        "block_bwd_store", grads, ["dx"] + ["d" + k for k in block_cuda.FOLD_KEYS], ref
    )
    dx_err, dx_scale = rel_err("block_bwd_store dx", grads["dx"], ref[0], KERNEL_RTOL)
    ms = time_ms(block_cuda.block_bwd_store, args, kwargs)
    plain_ms = time_ms(lambda: torch.autograd.grad(loss, inputs, retain_graph=True), (), {})
    roof = bound("block_bwd_store", args, kwargs, grads, block_cuda.block_bwd_store)
    held_products("block_bwd_store", roof, n_layers=folded["W_in"].shape[0], forward=0, backward=1)
    plan = held_walk_plan("block_bwd_store", lambda: block_cuda.block_bwd_store(*args, **kwargs),
                          roof, x.shape[0] * x.shape[1], x.shape[2], folded["W_in"], cfg[0], cfg[1],
                          recompute=False, with_g=with_g)
    entry("block_bwd_store", dx_err, dx_scale, ms, plain_ms, list(x.shape), roof,
          device_operations_plan=plan["launches"],
          device_ms_whole_traces=plan["device_ms"], worst_rel_err_grad=worst,
          max_abs_w_e=folded["W_e"].abs().max().item())

    # MAS, bit for bit: the training shape, then a long one the TPU streams
    def mas_err(logp, mask, shape_name):
        path = mas_cuda.maximum_path(logp, mask)
        plain = mas_cuda.maximum_path_plain(logp, mask)
        if not torch.equal(path, plain):
            fail(f"mas: path differs from the plain version at {shape_name}")
        err, scale = (path - plain).abs().max().item(), plain.abs().max().item()
        if scale != 1.0:  # a 0/1 path with at least one step
            fail(f"mas: max |path| {scale} at {shape_name}")
        return err, scale

    args, kwargs = recorders["mas"].args
    logp, mask = args
    err, scale = mas_err(logp, mask, list(logp.shape))
    ms = time_ms(mas_cuda.maximum_path, args, kwargs)
    plain_ms = time_ms(mas_cuda.maximum_path_plain, args, kwargs, runs=20)
    rng = np.random.default_rng(SEED + 3)
    b, t_x, t_y = MAS_LONG
    long_logp = torch.from_numpy(rng.standard_normal(MAS_LONG).astype(np.float32) * 3).to(PLATFORM)
    long_mask = torch.zeros(MAS_LONG, device=PLATFORM)
    long_mask[0] = 1.0
    long_mask[1, : t_x - 37, : t_y - 411] = 1.0
    long_err, long_scale = mas_err(long_logp, long_mask, list(MAS_LONG))
    long_ms = time_ms(mas_cuda.maximum_path, (long_logp, long_mask), {})
    long_plain_ms = time_ms(mas_cuda.maximum_path_plain, (long_logp, long_mask), {}, runs=20)
    long_roof = bound("mas", (long_logp, long_mask), {}, mas_cuda.maximum_path(long_logp, long_mask),
                      mas_cuda.maximum_path)
    # integer (tied) scores at widths around the kernel's lane and band
    # edges: 32 rows a warp's lanes, 16 a lane, then bands of warps
    for t_x in MAS_TIE_WIDTHS:
        shape = (2, t_x, t_x + 301)
        tied = torch.from_numpy(np.round(rng.standard_normal(shape) * 3).astype(np.float32))
        tie_mask = torch.zeros(shape)
        tie_mask[0] = 1.0
        tie_mask[1, : t_x - 5, : t_x + 200] = 1.0
        mas_err(tied.to(PLATFORM), tie_mask.to(PLATFORM), f"{list(shape)}, tied")
    long_texts = [mas_long_text(shape, rng, mas_err, device_line) for shape in MAS_LONG_TEXTS]
    scan = mas_scan_times(logp)
    roof = bound("mas", args, kwargs, mas_cuda.maximum_path(*args, **kwargs), mas_cuda.maximum_path)
    entry("mas", err, scale, ms, plain_ms, list(logp.shape), roof,
          long_shape=list(MAS_LONG), long_bound_ms=long_roof["bound_ms"],
          long_device_ms=long_roof.get("device_ms"), long_err=long_err,
          long_max_abs_ref=long_scale, long_ms=long_ms, long_plain_ms=long_plain_ms,
          tied_widths=list(MAS_TIE_WIDTHS), long_texts=long_texts, **scan)
    return report, text_kernels(recorders, launches, entry)


def mas_long_text(shape, rng, mas_err, device_line: str) -> dict:
    """MAS past the short path's ring (the long path, rows 17-18) at
    ``shape``: sample 0 full, sample 1 ragged; bit for bit against the
    plain version, timed (events; the plain version once, after the
    comparison's call), and its bound."""
    import torch

    from glow_tts_train_tpu_torch import kernels
    from glow_tts_train_tpu_torch.ops import mas_cuda

    b, t_x, t_y = shape
    logp = torch.from_numpy(rng.standard_normal(shape).astype("float32") * 3).to(PLATFORM)
    mask = torch.zeros(shape, device=PLATFORM)
    mask[0] = 1.0
    if b > 1:
        mask[1, : t_x - 37, : t_y - 11] = 1.0
    err, scale = mas_err(logp, mask, list(shape))
    ms = time_ms(mas_cuda.maximum_path, (logp, mask), {}, runs=10)
    plain_ms = time_ms(mas_cuda.maximum_path_plain, (logp, mask), {}, runs=1, warmup=0)
    roof = bound("mas", (logp, mask), {}, mas_cuda.maximum_path(logp, mask), mas_cuda.maximum_path)
    held_to_bound(f"mas {list(shape)}", ms, roof)
    words = kernels.mas_bits_words(b, t_x, t_y, logp.device)
    row = {"shape": list(shape), "max_abs_err": err, "max_abs_ref": scale, "ms": ms,
           "plain_ms": plain_ms, "bound_ms": roof["bound_ms"], "bound_by": roof["bound_by"],
           "device_ms": roof.get("device_ms"), "device_words": words}
    print(f"mas long text {list(shape)}: bit for bit, kernel {ms:.4f} ms ({roof.get('device_ms')} "
          f"on the device), plain {plain_ms:.1f} ms, bound {roof['bound_ms']:.4f} ms by "
          f"{roof['bound_by']}, {words} words of device memory [{device_line}]")
    return row


# the text kernels whose chains ask for the tensor cores
TEXT_TC_KERNELS = ("prenet", "encoder_layer", "duration_stack")


def chain_products(name: str, weights: tuple, x, forward: int, backward: int) -> dict:
    """The device products of ``forward`` and ``backward`` calls of the
    prenet's, the encoder layer's or the duration stack's kernels on ``x``
    [b, t, h]."""
    rows, h = x.shape[0] * x.shape[1], x.shape[2]
    if name == "prenet":
        return prenet_products(rows, weights, forward, backward)
    if name == "duration_stack":
        return duration_products(rows, weights, forward, backward)
    w1 = weights[-4]  # the FFN's first conv [taps * h, f]
    return encoder_products(rows, h, w1.shape[1], w1.shape[0] // h, forward, backward)


def mas_scan_times(logp) -> dict:
    """MAS's serial floor on this card: the kernel's time (events, median)
    at the recorded batch and text width with every length full, at
    MAS_SCAN_FRAMES frames, and the slope: the cost of one mel frame of
    the column scan, which no parallelism removes."""
    import torch

    from glow_tts_train_tpu_torch.ops import mas_cuda

    b, t_x, _ = logp.shape
    gen = torch.Generator(device=logp.device).manual_seed(SEED)
    times = {}
    for t_y in MAS_SCAN_FRAMES:
        lp = torch.randn((b, t_x, t_y), device=logp.device, generator=gen)
        times[t_y] = time_ms(mas_cuda.maximum_path, (lp, torch.ones_like(lp)), {})
    lo, hi = MAS_SCAN_FRAMES[0], MAS_SCAN_FRAMES[-1]
    us = (times[hi] - times[lo]) / (hi - lo) * 1e3
    print(f"mas scan: [{b}, {t_x}, t_y] full lengths, ms by t_y {times}: {us:.4f} us a mel frame")
    return {"scan_ms_by_frames": times, "scan_us_per_frame": us}


def text_kernels(recorders: dict, launches: dict, entry) -> list:
    """The text side's training kernels on the last step's recorded inputs:
    each forward kernel with dropout on against its plain version (equal
    keep masks), and each backward kernel against autograd of the plain
    version: first its ReLU gates against the plain version's (they may
    differ only at ties, GATE_TIE_RTOL), then dx and every weight gradient,
    with the cotangent scaled to max 1, at those gates."""
    import torch

    from glow_tts_train_tpu_torch.ops import encoder_cuda, text_cuda

    plain_fwd = {
        "prenet": lambda w, x, m, p, seed: text_cuda.prenet_plain(w, x, m, p, seed=seed),
        "encoder_layer": encoder_cuda.encoder_layer_plain,
        "duration_stack": lambda w, x, m, p, seed: text_cuda.duration_stack_plain(w, x, m, p, seed=seed),
    }
    plain_bwd = {
        "prenet": text_cuda.prenet_bwd_plain,
        "encoder_layer": encoder_cuda.encoder_layer_bwd_plain,
        "duration_stack": text_cuda.duration_stack_bwd_plain,
    }
    forward_rows = []
    for name in TEXT_KERNELS:
        # forward, dropout on
        args, kwargs = recorders[name].args
        p_dropout = args[-2]
        if not p_dropout > 0.0:
            fail(f"{name}: the recorded training call has no dropout ({args[3:]})")
        with torch.no_grad():
            out_k = recorders[name].fn(*args, **kwargs)
            out_p = plain_fwd[name](*args, **kwargs)
            err, scale = rel_err(f"{name} with dropout", out_k, out_p, DROPOUT_FWD_RTOL)
            ms = time_ms(recorders[name].fn, args, kwargs)
            plain_ms = time_ms(plain_fwd[name], args, kwargs)
            roof = bound(name, args, kwargs, out_k, recorders[name].fn)
        held_to_bound(f"{name} with dropout", ms, roof)
        extra = {}
        if name in TEXT_TC_KERNELS:
            want = chain_products(name, args[0], args[1], forward=1, backward=0)
            if roof["products"] != want:
                fail(f"{name} (training): device products {roof['products']}, expected {want}")
        forward_rows.append({
            "name": name, "train_launches": launches[name], "train_shape": list(args[1].shape),
            "train_p_dropout": p_dropout, "train_max_abs_err": err, "train_max_abs_ref": scale,
            "train_ms": ms, "train_plain_ms": plain_ms,
            **{"train_" + k: v for k, v in roof.items()}, **extra,
        })
        print(f"kernel {name} (training, p_dropout {p_dropout}): {list(args[1].shape)} err {err:.3e} "
              f"(max|ref| {scale:.3e}) kernel {ms:.4f} ms ({roof['device_ms']} on the device, "
              f"{roof['device_operations']} device operations a call), plain {plain_ms:.4f} ms, "
              f"bound {roof['bound_ms']:.4f} ms by {roof['bound_by']}, products {roof['products']}, "
              f"{launches[name]} launches in training {extra}")

        # backward
        bwd = name + "_bwd"
        args, kwargs = recorders[bwd].args
        weights, x, mask, dout, *cfg = args
        dout = dout / dout.abs().max().clamp_min(1e-30)  # the backward is linear in dout
        args = (weights, x, mask, dout, *cfg)
        saves, plain_saves = {}, {}
        grads = recorders[bwd].fn(*args, saves=saves, **kwargs)
        plain_bwd[name](*args, saves=plain_saves, **kwargs)
        ties = 0
        for l, (gk, gp, pre) in enumerate(zip(saves["gates"], plain_saves["gates"], plain_saves["pre"])):
            differ = gk != gp
            ties += int(differ.sum())
            if differ.any() and not pre[differ].abs().max() <= GATE_TIE_RTOL * pre.abs().max():
                fail(f"{bwd}: layer {l}: a ReLU gate differs from the plain version's where "
                     f"|input| is {pre[differ].abs().max().item()} (max {pre.abs().max().item()})")
        if ties > 64:
            fail(f"{bwd}: {ties} ReLU gates differ from the plain version's")
        ref = plain_bwd[name](*args, gates=saves["gates"], **kwargs)
        worst = (0.0, 1.0)
        # encoder layer in the JAX fold's 18 weights: the key bias's gradient
        # (index 4) is zero but for rounding, a row's scores all shift alike:
        # held to the query bias's scale (the merged layout's Q/K/V bias
        # holds both)
        key_bias = 4 if name == "encoder_layer" and len(weights) == 18 else None
        for i, (g, r) in enumerate(zip(grads, ref)):
            floor = ref[2].abs().max().item() if i == key_bias else 1e-6
            e = (g - r).abs().max().item()
            sc = max(r.abs().max().item(), floor)
            if not math.isfinite(e) or e > KERNEL_RTOL * sc:
                fail(f"{bwd}: gradient {i} max abs err {e} vs max |ref| {sc} "
                     f"(tolerance {KERNEL_RTOL} relative)")
            if i > 0 and r.abs().max().item() == 0.0 and i != key_bias:
                fail(f"{bwd}: gradient {i} is zero in the plain version: nothing was compared")
            if e / sc > worst[0] / worst[1]:
                worst = (e, sc)
        again = recorders[bwd].fn(*args, **kwargs)
        if not all(torch.equal(a, b) for a, b in zip(grads, again)):
            fail(f"{bwd}: two runs gave different bits")
        dx_err = (grads[0] - ref[0]).abs().max().item()
        dx_scale = ref[0].abs().max().item()
        ms = time_ms(recorders[bwd].fn, args, kwargs)
        plain_ms = time_ms(plain_bwd[name], args, kwargs)
        roof = bound(bwd, args, kwargs, grads, recorders[bwd].fn)
        extra = {}
        if name in TEXT_TC_KERNELS:
            # the recompute is the forward's chain: its output equals the
            # forward kernel's bit for bit (and so do the ReLU gates)
            if not torch.equal(saves["out"], recorders[name].fn(weights, x, mask, *cfg, **kwargs)):
                fail(f"{bwd}: the recomputed forward differs from the forward kernel's bits")
            want = chain_products(name, weights, x, forward=0, backward=1)
            if roof["products"] != want:
                fail(f"{bwd}: device products {roof['products']}, expected {want}")
            extra = {"recompute_equals_forward": True}
        entry(bwd, dx_err, dx_scale, ms, plain_ms, list(x.shape), roof,
              p_dropout=cfg[-2], worst_rel_err_grad=worst[0] / worst[1], n_gradients=len(grads),
              relu_ties=ties, same_bits_twice=True, **extra)
    return forward_rows


# the flow block's bf16 products alone (bf16 rows 10 and 12, base width) at
# the bf16 run's batch shape: (name, c_in, taps, dilation, tap_sign, n, w_t)
# for a conv-GEMM, (name, c_in, taps, dilation, n) for a weight gradient
BF16_PRODUCT_ROWS = (32, 704)
BF16_CONV_PRODUCTS = (
    ("start", 80, 1, 1, 1, 192, False), ("in_conv_d1", 192, 5, 1, 1, 384, False),
    ("res_skip", 192, 1, 1, 1, 384, False), ("coupling", 192, 1, 1, 1, 160, False),
    ("coupling_bwd", 192, 1, 1, 1, 80, False), ("dskip", 160, 1, 1, 1, 192, True),
    ("gate_bwd", 384, 1, 1, 1, 192, True), ("transposed_d1", 384, 5, 1, -1, 192, True),
    ("dzp", 192, 1, 1, 1, 80, True), ("dx", 160, 1, 1, 1, 160, True),
)
BF16_WGRAD_PRODUCTS = (
    ("dW_e", 192, 1, 1, 160), ("dW_rs", 192, 1, 1, 384), ("dW_in_d1", 192, 5, 1, 384),
    ("dW_s", 80, 1, 1, 192), ("dA", 160, 1, 1, 160),
)
# the text rows' bf16 products alone (base width) at the bf16 run's longest
# text bucket, as the rows above, their conv-GEMMs by the text chains' plan
# (split-K): the encoder layer's (bf16 rows 2 and 13), then the prenet's
# (rows 1 and 14, "prenet_"; its 1x1 projection and that product's
# transpose are out_proj's and datt's shapes) and the duration stack's
# (rows 3 and 15, "dp_")
BF16_TEXT_PRODUCT_ROWS = (32, 192)
BF16_TEXT_CONV_PRODUCTS = (
    ("qkv", 192, 1, 1, 1, 576, False), ("out_proj", 192, 1, 1, 1, 192, False),
    ("ffn1", 192, 3, 1, 1, 768, False), ("ffn2", 768, 3, 1, 1, 192, False),
    ("dffn", 192, 3, 1, -1, 768, True), ("dx1", 768, 3, 1, -1, 192, True),
    ("datt", 192, 1, 1, 1, 192, True), ("dx", 576, 1, 1, 1, 192, True),
    ("prenet_conv", 192, 5, 1, 1, 192, False), ("prenet_transposed", 192, 5, 1, -1, 192, True),
    ("dp_conv_0", 192, 3, 1, 1, 256, False), ("dp_conv_1", 256, 3, 1, 1, 256, False),
    ("dp_transposed_1", 256, 3, 1, -1, 256, True), ("dp_transposed_0", 256, 3, 1, -1, 192, True),
)
BF16_TEXT_WGRAD_PRODUCTS = (
    ("dW2", 768, 3, 1, 192), ("dW1", 192, 3, 1, 768), ("dWo", 192, 1, 1, 192),
    ("dW_qkv", 192, 1, 1, 576), ("prenet_dW", 192, 5, 1, 192), ("dp_dW_0", 192, 3, 1, 256),
    ("dp_dW_1", 256, 3, 1, 256),
)


def text_product_row(name: str) -> str:
    """The bf16 text row pair a product of BF16_TEXT_*_PRODUCTS belongs to."""
    return ("prenet" if name.startswith("prenet_") else
            "duration_stack" if name.startswith("dp_") else "encoder_layer")
# a bare bf16 product against float64 of the same bf16 operands, relative to
# max |ref|: f32 sums over K up to 2,304 (conv) or 22,528 rows (weight
# gradient) in another order
BF16_PRODUCT_RTOL = 1e-5


def bf16_block_products(device_line: str, text: bool = False) -> list:
    """Each product of the flow block's bf16 rows alone (bare epilogue, f32
    out, random bf16 operands from a seed) at BF16_PRODUCT_ROWS (``text``:
    the text rows' at BF16_TEXT_PRODUCT_ROWS, their conv-GEMMs by the
    text chains' plan) on the mma.sync kernel and on the TMA-fed wgmma one:
    both against float64 within BF16_PRODUCT_RTOL, then each one's device
    time (a bracketed trace of 5 calls, the weight gradient's splits' sum
    and the split-K shares' pass included; mma.sync, TMA, TMA, mma.sync)
    and TFLOP/s against the dense BF16 peak (``product bf16`` lines)."""
    import torch

    from glow_tts_train_tpu_torch import kernels
    from glow_tts_train_tpu_torch.ops import tc_gemm

    dev = torch.device("cuda")
    gen = torch.Generator().manual_seed(13)
    batch, t = BF16_TEXT_PRODUCT_ROWS if text else BF16_PRODUCT_ROWS
    conv_unit = {"mma": "mma", "tma": "text" if text else "tma"}

    def r(*shape, scale=1.0):
        return (torch.randn(*shape, generator=gen) * scale).to(torch.bfloat16).to(dev)

    cases = []
    for name, c_in, taps, dil, sign, n, w_t in (BF16_TEXT_CONV_PRODUCTS if text
                                                else BF16_CONV_PRODUCTS):
        a = r(batch, t, c_in)
        w = r(*((taps * n, c_in) if w_t else (taps * c_in, n)), scale=(taps * c_in) ** -0.5)
        cases.append(("conv", name, [batch * t, taps * c_in, n],
                      lambda u, a=a, w=w, taps=taps, dil=dil, sign=sign, w_t=w_t:
                      tc_gemm.bf16_conv_product(a, w, taps, dil, sign, w_t, conv_unit[u]),
                      tc_gemm.conv_product_plain(a.double(), w.double(), taps, dil, sign, w_t=w_t)))
    for name, c_in, taps, dil, n in BF16_TEXT_WGRAD_PRODUCTS if text else BF16_WGRAD_PRODUCTS:
        a, dy = r(batch, t, c_in), r(batch, t, n)
        cases.append(("wgrad", name, [taps * c_in, batch * t, n],
                      lambda u, a=a, dy=dy, taps=taps, dil=dil:
                      tc_gemm.bf16_weight_gradient(a, dy, taps, dil, u),
                      tc_gemm.weight_gradient_plain(a.double(), dy.double(), taps, dil)))
    checked = []  # (errors by unit, max |ref|) of each case
    for kind, name, shape, run, ref in cases:
        scale = ref.abs().max().item()
        errs = {}
        checked.append((errs, scale))
        for unit in ("mma", "tma"):
            kernels.product_counts(reset=True)
            out = run(unit)
            torch.cuda.synchronize()
            counts = kernels.product_counts(reset=True)
            key = ("bf16_tma_" if unit == "tma" else "bf16_") + ("gemm" if kind == "conv" else "wgrad")
            if counts[key] != 1:
                fail(f"product bf16 {kind} {name}: {unit} counts {counts}")
            errs[unit] = (out.double() - ref).abs().max().item()
            if not (math.isfinite(errs[unit]) and errs[unit] <= BF16_PRODUCT_RTOL * scale):
                fail(f"product bf16 {kind} {name} ({unit}): max abs err {errs[unit]} vs float64, "
                     f"max |ref| {scale} (tolerance {BF16_PRODUCT_RTOL} relative)")
    # every product's 5 calls in one trace a turn
    turns = {"mma": [], "tma": []}
    for unit in ("mma", "tma", "tma", "mma"):
        groups = bracketed_groups([lambda run=case[3]: run(unit) for case in cases], calls=5)
        turns[unit].append([sum(op_us for _, op_us in ops) / 5 for ops in groups])
    rows = []
    for i, ((kind, name, shape, run, ref), (errs, scale)) in enumerate(zip(cases, checked)):
        us = {unit: [turn[i] for turn in got] for unit, got in turns.items()}
        flops = 2.0 * shape[0] * shape[1] * shape[2]
        row = {"kernel": "bf16_" + kind, "row": text_product_row(name) if text else "flow_block",
               "name": name, "shape": shape, "max_abs_ref": scale,
               "max_abs_err_f64": errs, "device_us": {u: min(v) for u, v in us.items()},
               "device_us_turns": us}
        row["tflops"] = {u: flops / (v * 1e-6) / 1e12 for u, v in row["device_us"].items()}
        print(f"product bf16 {kind} {'text ' if text else ''}{name} {shape}: err (max |ref| "
              f"{scale:.3g}) mma.sync "
              f"{errs['mma']:.2e}, TMA {errs['tma']:.2e}; device us mma.sync "
              f"{row['device_us']['mma']:.1f}, TMA {row['device_us']['tma']:.1f} (turns {us}); "
              f"TFLOP/s mma.sync {row['tflops']['mma']:.1f}, TMA {row['tflops']['tma']:.1f} of "
              f"{PEAK_BF16_FLOPS / 1e12:.0f} [{device_line}]")
        rows.append(row)
    return rows


# a bf16 kernel against its plain bf16 version on the same inputs, relative
# to max |ref| of each output and gradient: both round to bf16 at the JAX
# kernels' casts, so they differ where an f32 sum in another order rounds to
# the neighbouring bf16 value (one bf16 step, 2^-8 relative, at a few
# elements) and where that difference travels on; the encoder layer's
# streaming softmax also rounds its running (unnormalised) probabilities
# where JAX rounds the final ones.  The JAX package's own bf16 against f32
# is 4.8e-3 to 6.3e-3 of max |z| on the CPU (tests/test_torch_bf16.py).
BF16_KERNEL_RTOL = 2e-2
# calls of each bf16 text row that must give the same bits (split-K shares
# and row splits added in a fixed order, no atomics)
BF16_REPEATS = 50


def bf16_text_plan(name: str, weights: tuple, x, backward: bool) -> dict:
    """The plan of one call of a bf16 text row on these inputs
    (``tc_gemm.bf16_{encoder,prenet,duration}_products``: its
    ``kernels.product_counts`` and device operations)."""
    import torch

    from glow_tts_train_tpu_torch.ops import tc_gemm

    batch, t, c = x.shape
    sms = torch.cuda.get_device_properties(0).multi_processor_count
    if name == "prenet":
        w = weights[0]
        plan = tc_gemm.bf16_prenet_products(batch, t, c, w.shape[0], w.shape[1] // c, sms,
                                            backward)
    elif name == "duration_stack":
        w = weights[0]
        plan = tc_gemm.bf16_duration_products(batch, t, c, w.shape[1], w.shape[0] // c, sms,
                                              backward)
    else:  # the FFN's first conv: the last four of the 14 or the JAX fold's 18
        w1 = weights[-4]
        plan = tc_gemm.bf16_encoder_products(batch, t, c, w1.shape[1], w1.shape[0] // c, sms,
                                             backward)
    return plan


def bf16_kernels(recorders: dict, launches: dict, device_line: str) -> list:
    """Each bf16 kernel of the main path against its plain bf16 version on
    the card, on the inputs it got in the bf16 run (``recorders``: the
    first call of each wrapper): the forwards (dropout on, equal keep
    masks), the backwards at the kernel's own ReLU gates with the
    cotangent scaled to max 1; each within BF16_KERNEL_RTOL, timed against
    its plain version, with its bound at the BF16 peak and its device time
    with its products on either unit in turns; a text row's products held
    to its plan (product counts, device operations a call) and
    BF16_REPEATS calls of it to the first call's bits."""
    import torch

    from glow_tts_train_tpu_torch import kernels
    from glow_tts_train_tpu_torch.ops import block_cuda, encoder_cuda, text_cuda

    report = []

    def counted(name, backward, weights, x, fn):
        """fn() with its device products held to the row's plan."""
        kernels.product_counts(reset=True)
        out = fn()
        torch.cuda.synchronize()
        counts = kernels.product_counts(reset=True)
        want = bf16_text_plan(name, weights, x, backward)["counts"]
        if {k: counts[k] for k in want} != want:
            fail(f"{name}{'_bwd' if backward else ''}_bf16: device products {counts}, "
                 f"expected {want}")
        return out

    def held_operations(name, backward, weights, x, roof):
        want = bf16_text_plan(name, weights, x, backward)["launches"]
        if roof["device_operations"] != want:
            fail(f"{name}{'_bwd' if backward else ''}_bf16: {roof['device_operations']} device "
                 f"operations a call, its plan {want}")

    def repeats_bits(name, fn, first):
        for _ in range(BF16_REPEATS):
            again = fn()
            if not all(torch.equal(a, b) for a, b in zip(again, first)):
                fail(f"{name}: {BF16_REPEATS} calls did not all give the first call's bits")

    entry = entry_writer(report, launches, device_line)
    unit = unit_bf16

    plain_fwd = {
        "prenet": text_cuda.prenet_plain_bf16,
        "duration_stack": text_cuda.duration_stack_plain_bf16,
        "encoder_layer": encoder_cuda.encoder_layer_plain_bf16,
    }
    plain_bwd = {
        "prenet": text_cuda.prenet_bwd_plain,
        "duration_stack": text_cuda.duration_stack_bwd_plain,
        "encoder_layer": encoder_cuda.encoder_layer_bwd_plain,
    }
    for name in TEXT_KERNELS:
        args, kwargs = recorders[name].args
        kernel_fn = recorders[name].fn
        x = args[1]
        with torch.inference_mode():
            out_k = counted(name, False, args[0], x, lambda: kernel_fn(*args, **kwargs))
            out_p = plain_fwd[name](*args, **kwargs)
            repeats_bits(name + "_bf16", lambda: (kernel_fn(*args, **kwargs),), (out_k,))
        torch.cuda.synchronize()
        err, scale = rel_err(f"{name}_bf16", out_k.float(), out_p.float(), BF16_KERNEL_RTOL)
        with torch.inference_mode():
            ms = time_ms(kernel_fn, args, kwargs, runs=10, warmup=2)
            plain_ms = time_ms(plain_fwd[name], args, kwargs, runs=3, warmup=1)
            roof = bf16_bound(name + "_bf16", args, kwargs, out_k, kernel_fn)
            held_operations(name, False, args[0], x, roof)
            # its products on either unit
            turns = units_in_turns(name + "_bf16", lambda: kernel_fn(*args, **kwargs),
                                   device_line)
        entry(name + "_bf16", err, scale, ms, plain_ms, list(x.shape), roof,
              device_ms_in_turns=turns, products_held_to_plan=True,
              same_bits_repeats=BF16_REPEATS)

        bname = name + "_bwd"
        bargs, bkwargs = recorders[bname].args
        bkernel = recorders[bname].fn
        weights, x, x_mask, dout, *cfg = bargs
        dout = unit(dout)
        saves = {}
        call = (weights, x, x_mask, dout, *cfg)
        grads_k = counted(name, True, weights, x, lambda: bkernel(*call, saves=saves))
        grads_p = plain_bwd[name](weights, x, x_mask, dout, *cfg, gates=saves["gates"])
        repeats_bits(bname + "_bf16", lambda: bkernel(*call), grads_k)
        torch.cuda.synchronize()
        worst, scale = held_bf16(name + "_bwd_bf16", grads_k, grads_p)
        ms = time_ms(bkernel, call, {}, runs=10, warmup=2)
        plain_ms = time_ms(lambda *a: plain_bwd[name](*a, gates=saves["gates"]), call, {},
                           runs=3, warmup=1)
        roof = bf16_bound(bname + "_bf16", call, {}, grads_k, bkernel)
        held_operations(name, True, weights, x, roof)
        turns = units_in_turns(bname + "_bf16", lambda: bkernel(*call), device_line)
        entry(bname + "_bf16", worst * scale, scale, ms, plain_ms, list(x.shape), roof,
              worst_relative=worst, device_ms_in_turns=turns, products_held_to_plan=True,
              same_bits_repeats=BF16_REPEATS)

    # the flow block: forward-save, then backward-store from its saves
    args, kwargs = recorders["block_fwd_save"].args
    fwd = recorders["block_fwd_save"].fn
    folded, g_all, x, x_mask, *cfg = args
    z_k, ld_k, saves = fwd(*args, **kwargs)
    z_p, ld_p = block_cuda.block_forward_plain_bf16(folded, g_all, x, x_mask, *cfg)
    torch.cuda.synchronize()
    err, scale = rel_err("block_fwd_save_bf16 z", z_k.float(), z_p.float(), BF16_KERNEL_RTOL)
    rel_err("block_fwd_save_bf16 ld", ld_k, ld_p, BF16_KERNEL_RTOL)
    ms = time_ms(fwd, args, kwargs, runs=10, warmup=2)
    plain_ms = time_ms(block_cuda.block_forward_plain_bf16, (folded, g_all, x, x_mask, *cfg), {},
                       runs=3, warmup=1)
    roof = bf16_bound("block_fwd_save_bf16", args, kwargs, (z_k, ld_k, saves), fwd)
    turns = units_in_turns("block_fwd_save_bf16", lambda: fwd(*args, **kwargs), device_line)
    entry("block_fwd_save_bf16", err, scale, ms, plain_ms, list(x.shape), roof,
          device_ms_in_turns=turns)

    bargs, bkwargs = recorders["block_bwd_store"].args
    bwd = recorders["block_bwd_store"].fn
    folded, with_g, x, x_mask, saves, dz, dld, *cfg = bargs
    dz, dld = unit(dz), unit(dld)
    call = (folded, with_g, x, x_mask, saves, dz, dld, *cfg)
    grads_k = bwd(*call)
    with torch.enable_grad():
        leaves = {k: v.detach().requires_grad_(True) for k, v in folded.items()}
        xl = x.detach().requires_grad_(True)
        z, ld = block_cuda.block_forward_plain_bf16(leaves, None, xl, x_mask, *cfg)
        ref = torch.autograd.grad((z, ld), [xl, *leaves.values()], (dz, dld))
    names = ["dx"] + ["d" + k for k in leaves]
    worst, scale = held_bf16("block_bwd_store_bf16", [grads_k[n] for n in names], ref)
    ms = time_ms(bwd, call, {}, runs=10, warmup=2)

    def plain_bwd_store():  # autograd of the plain forward: the plain backward's cost
        with torch.enable_grad():
            z, ld = block_cuda.block_forward_plain_bf16(leaves, None, xl, x_mask, *cfg)
            return torch.autograd.grad((z, ld), [xl, *leaves.values()], (dz, dld))

    plain_ms = time_ms(plain_bwd_store, (), {}, runs=3, warmup=1)
    roof = bf16_bound("block_bwd_store_bf16", call, {}, grads_k, bwd)
    turns = units_in_turns("block_bwd_store_bf16", lambda: bwd(*call), device_line)
    entry("block_bwd_store_bf16", worst * scale, scale, ms, plain_ms, list(x.shape), roof,
          worst_relative=worst, device_ms_in_turns=turns)
    return report


def units_in_turns(name: str, fn, device_line: str, calls: int = 3) -> dict:
    """The device's time of one call of a bf16 row (every bf16 chain asks
    for the TMA-fed kernels) with its products on the mma.sync kernels
    (``kernels.bf16_mma_only``)
    and on the TMA-fed wgmma ones, in turns (mma.sync, TMA, TMA, mma.sync;
    ``calls`` calls a bracketed trace) -> {"mma_sync": ms, "tma": ms}, the
    smaller of each unit's two."""
    from glow_tts_train_tpu_torch import kernels

    got = {"mma_sync": [], "tma": []}
    for unit in ("mma_sync", "tma", "tma", "mma_sync"):
        with kernels.bf16_mma_only() if unit == "mma_sync" else contextlib.nullcontext():
            ops = bracketed_trace(fn, calls)
        got[unit].append(sum(us for _, us in ops) / calls / 1e3)
    out = {unit: min(v) for unit, v in got.items()}
    print(f"kernel {name} in turns: device ms a call, products on the mma.sync kernels "
          f"{got['mma_sync']}, on the TMA-fed wgmma kernels {got['tma']} [{device_line}]")
    return out


# the decoder's bf16 kernels the default mode (fused store) launches
BF16_DECODER_FS = ("block_fwd_save_bf16", "block_bwd_store_bf16")
# the four decoder modes in bf16 through the train CLI: the bf16 run's
# config, its warm-up cut to 200 steps so that 4 steps move the MLE loss (as
# shipped, 4000, the lr of step 4 is 1.1e-6 and the loss moves by dropout
# alone; at 50, as TRAIN_OVERRIDE cuts f32's, the duration loss of the
# long bucket overshot at step 4, 2.85 -> 4.82 in the fused store run)
BF16_MODE_OVERRIDE = {"epochs": 2, "warmup_steps": 200}
# bf16 training (fp16_run): configs/base.json as shipped (fp16_run true,
# batch 32, full width), its epochs cut to 2: 64 utterances at batch 32
# are 2 steps an epoch
BF16_OVERRIDE = {"epochs": 2}
BF16_STEPS = 4
# the bf16 run against an f32 run from the same init, data and dropout
# seeds, step by step, the bf16 step on the f32 step's alignment: every
# loss within BF16_LOSS_RTOL of the f32 step's and the grad norm within
# BF16_GRAD_NORM_RTOL: the CPU measurement (tests/test_torch_bf16.py: the
# JAX package's own bf16 against f32 on the tiny config's 3-step
# trajectory, losses 1.2e-3 relative at most and the grad norm 4.5e-3),
# widened for the base width's depth (12 blocks of 4 WN layers and 6
# encoder layers against 2, 2 and 2: about ten times the roundings along a
# path) and for 4 steps.
BF16_LOSS_RTOL = 2e-2
BF16_GRAD_NORM_RTOL = 5e-2
# bf16's own alignment against f32's: the cells it moves are counted, and
# its log-likelihood under f32's logp must be within
# BF16_PATH_SCORE_RTOL of the f32 path's (the maximum MAS finds).  An
# untrained model's logp is flat: on the H100 bf16 moves 9-14% of the
# path's cells at init, each move a near-tie (2.5e-5 below f32's score at
# most), so the cells are reported and the score is bounded.
BF16_PATH_SCORE_RTOL = 1e-3
BF16_TIMED_ROUNDS = 3


def bf16_train(workdir: Path, config_path: Path, device_line: str) -> tuple:
    """bf16 training, ``configs/base.json`` as shipped (2 epochs), through
    the train CLI on the 64-utterance corpus: DDI (f32, as in JAX), 2 epochs
    of 2 steps, each bf16 kernel's launches, 1 epoch + 1 resumed epoch equal
    to the 2 epochs bit for bit (``resumed_run``), each bf16 kernel against
    its plain bf16 version on the last step's inputs (``bf16_kernels``),
    then the bf16 run against f32 (``bf16_against_f32``) -> (kernel report
    entries, the phase's row)."""
    from glow_tts_train_tpu_torch.config import load_config
    from glow_tts_train_tpu_torch.ops import block_cuda, encoder_cuda, text_cuda

    corpus = workdir / "corpus"
    manifest = json.loads((corpus / "manifest.json").read_text())
    config = load_config([config_path])
    if not config.fp16_run or config.batch_size != 32:
        fail(f"{config_path}: fp16_run {config.fp16_run}, batch {config.batch_size}: "
             "not the shipped config this phase trains")
    n_blocks, n_layers = config.model.n_blocks_dec, config.model.n_layers_enc
    modules = {"block_fwd_save": block_cuda, "block_bwd_store": block_cuda,
               "prenet": text_cuda, "prenet_bwd": text_cuda, "duration_stack": text_cuda,
               "duration_stack_bwd": text_cuda, "encoder_layer": encoder_cuda,
               "encoder_layer_bwd": encoder_cuda}
    recorders = {name: Recorder(module, name) for name, module in modules.items()}
    launches, steps, last, out, seconds = run_train_cli(
        workdir, corpus, manifest, config_path, BF16_OVERRIDE, "bf16", BF16_STEPS, recorders,
        corpus_symbols=False,
    )
    per_step = {"block_fwd_save": n_blocks, "block_bwd_store": n_blocks, "prenet": 1,
                "prenet_bwd": 1, "encoder_layer": n_layers, "encoder_layer_bwd": n_layers,
                "duration_stack": 1, "duration_stack_bwd": 1}
    want = {"wn_forward": n_blocks, "mas": BF16_STEPS,
            **{k + "_bf16": v * BF16_STEPS for k, v in per_step.items()}, **dict.fromkeys(per_step, 0),
            **{k + "_bf16": 0 for k in DECODER_KERNELS if k + "_bf16" not in BF16_DECODER_FS}}
    got = {k: launches[k] for k in want}
    if got != want:
        fail(f"train bf16: launches {got}, expected {want}")
    epochs = [json.loads(line) for line in (workdir / "bf16.jsonl").read_text().splitlines()]
    if len(epochs) != 2 or not (out / f"checkpoint_{1 + BF16_STEPS}.npz").exists():
        fail(f"train bf16: {len(epochs)} epoch lines, no checkpoint_{1 + BF16_STEPS}.npz")
    for i, row in enumerate(steps):
        print(f"train bf16 step {i + 1}: x {row['shape'][0]} y {row['shape'][1]} loss "
              f"{row['loss']:.4f} (mle {row['mle_loss']:.4f}, dur {row['duration_loss']:.4f}) "
              f"grad_norm {row['grad_norm']:.4f}, {row['seconds'] * 1e3:.1f} ms [{device_line}]")
    print(f"train bf16: CLI {seconds:.1f} s ({config_path.name} as shipped, fp16_run true, batch "
          f"{config.batch_size}, epochs cut to 2: DDI, {BF16_STEPS} steps, 2 checkpoints); "
          f"epochs {epochs}; launches {got} [{device_line}]")
    resume = resumed_run(workdir, corpus, manifest, config_path, steps, out,
                         {k: v for k, v in want.items() if v}, device_line,
                         override=BF16_OVERRIDE, n_steps=BF16_STEPS, main_tag="bf16",
                         tag="bf16_", corpus_symbols=False)
    profile = profile_bf16_step(last, device_line, n_blocks, n_layers)
    report = bf16_kernels(recorders, launches, device_line)
    del recorders, last
    against = bf16_against_f32(workdir, config_path, device_line)
    return report, {"steps": steps, "epochs": epochs, "resumed": resume,
                    "profiled_step": profile, "against_f32": against}


def profile_bf16_step(last: dict, device_line: str, n_blocks: int, n_layers: int) -> dict:
    """One more bf16 step on the last batch under torch.profiler: its device
    products (every one on the bf16 kernels but the 12 folded-A products;
    the flow blocks' 10 + 12 conv-GEMMs and 11 weight gradients a block,
    the encoder layers' 4 + 8 and 4 a layer, the prenet's 4 + 8 and 4 and
    the duration stack's 2 + 4 and 2 on the TMA-fed wgmma kernels, none on
    the mma.sync ones), wall, device busy, idle share, device operations,
    top kernels."""
    from glow_tts_train_tpu_torch import kernels

    def step():
        last["step_fn"](last["state"], last["batch"], *last["args"])

    kernels.product_counts(reset=True)
    step()
    products = kernels.product_counts(reset=True)
    unexpected = {k: v for k, v in products.items()
                  if v and k not in BF16_PRODUCT_KEYS + ("core_gemm",)}
    want = {"core_gemm": n_blocks, "bf16_tma_gemm": 22 * n_blocks + 12 * n_layers + 12 + 6,
            "bf16_tma_wgrad": 11 * n_blocks + 4 * n_layers + 4 + 2, "bf16_gemm": 0,
            "bf16_wgrad": 0}
    if unexpected or {k: products.get(k) for k in want} != want:
        fail(f"train bf16 step: device products {products}, expected {want}")
    wall_ms, by_kernel, launches = profiled(step)
    busy_ms = sum(by_kernel.values())
    top = sorted(by_kernel.items(), key=lambda kv: -kv[1])[:8]
    row = {"batch_x": list(last["batch"]["x"].shape), "batch_y": list(last["batch"]["y"].shape),
           "wall_ms": wall_ms, "device_busy_ms": busy_ms,
           "idle_share": 1.0 - busy_ms / wall_ms if busy_ms > 0 else None,
           "device_operations": launches, "device_products": products,
           "bf16_products_ms": sum(v for k, v in by_kernel.items() if "bf16" in k),
           "top_ms": {k[:70]: v for k, v in top}}
    print(f"train bf16 profiled step: x {row['batch_x']} y {row['batch_y']} wall {wall_ms:.1f} ms, "
          f"device busy {busy_ms:.1f} ms, idle share {row['idle_share']}, {launches} device "
          f"operations, products {products}, bf16 product kernels {row['bf16_products_ms']:.1f} ms "
          f"[{device_line}]")
    for k, v in top:
        print(f"  {v:8.2f} ms  {k[:110]}")
    return row


def bf16_against_f32(workdir: Path, config_path: Path, device_line: str) -> dict:
    """The bf16 step against the f32 step in one process, both from the same
    fresh init (DDI, f32, on the first batch) on the corpus's batches with
    the same dropout seeds: BF16_STEPS steps (2 epochs), each pair on the
    f32 step's alignment (the bf16 step's MAS kernel runs, its path is
    replaced by f32's; the cells its own path moves are counted, and its
    log-likelihood under f32's logp held within BF16_PATH_SCORE_RTOL of the
    f32 path's), every loss within BF16_LOSS_RTOL and
    the grad norm within BF16_GRAD_NORM_RTOL of f32's.  Then both go on
    training in turns (f32, bf16, bf16, f32; BF16_TIMED_ROUNDS rounds, one
    step a turn): step ms quartiles and peak device memory of a step
    (``max_memory_allocated``, reset before it), and one profiled step of
    each (device busy, idle share, device operations)."""
    import torch

    from glow_tts_train_tpu_torch import data, training
    from glow_tts_train_tpu_torch.config import load_config
    from glow_tts_train_tpu_torch.ops import mas_cuda

    corpus = workdir / "corpus"
    configs = {}
    for fp16 in (False, True):
        configs[fp16] = load_config([config_path, workdir / "bf16_override.json"])
        configs[fp16].fp16_run = fp16
    dataset = data.build_dataset(
        [data.SpeakerSource(0, corpus / "phonemes.csv", corpus / "mels")], configs[True],
        mels_are_dirs=True, skip_missing_mels=False, multispeaker=False,
    )
    pipeline = data.DataPipeline(dataset, configs[True], batch_size=configs[True].batch_size)
    batches = [training.batch_to(b, PLATFORM) for b in pipeline.batches()]
    runs = {}
    for fp16, cfg in configs.items():
        runs[fp16] = {
            "step": training.make_train_step(cfg),
            "state": training.TrainState(training.initialize_model(cfg, batches[0], PLATFORM)),
            "generator": torch.Generator(device=PLATFORM).manual_seed(cfg.seed),
            "seeds": torch.Generator().manual_seed(cfg.seed), "n": 0,
        }
    kernel_mas = mas_cuda.maximum_path

    def step(fp16, pinned=None):
        r = runs[fp16]
        batch = batches[r["n"] % len(batches)]
        r["n"] += 1
        paths = []

        def mas(logp, mask):
            path = kernel_mas(logp, mask)
            paths.append((logp, path))
            return path if pinned is None else pinned

        mas_cuda.maximum_path = mas
        try:
            torch.cuda.synchronize()
            torch.cuda.reset_peak_memory_stats()
            resident = torch.cuda.memory_allocated()
            start = time.perf_counter()
            metrics = r["step"](r["state"], batch, r["generator"], r["seeds"])
            torch.cuda.synchronize()
            ms = (time.perf_counter() - start) * 1e3
        finally:
            mas_cuda.maximum_path = kernel_mas
        peak = torch.cuda.max_memory_allocated()
        return ({k: float(v) for k, v in metrics.items()}, paths[0], ms, peak, peak - resident,
                list(batch["y"].shape))

    pairs = []
    for i in range(BF16_STEPS):
        m32, (logp32, path32), *_ = step(False)
        m16, (_, path16), *_, shape = step(True, pinned=path32)
        differ, cells = int((path16 != path32).sum().item()), int(path32.sum().item())
        best = torch.sum(logp32 * path32).item()
        deficit = (best - torch.sum(logp32 * path16).item()) / abs(best)
        rel = {k: abs(m16[k] - m32[k]) / abs(m32[k]) for k in m32}
        pairs.append({"f32": m32, "bf16": m16, "rel_diff": rel, "path_cells_differing": differ,
                      "path_cells": cells, "path_score_deficit": deficit, "batch_y": shape})
        print(f"train bf16 vs f32 step {i + 1}: y {shape} f32 {m32} bf16 {m16} relative "
              f"{ {k: f'{v:.2e}' for k, v in rel.items()} }; bf16's own path moves {differ} of "
              f"{cells} cells, its log-likelihood under f32's logp {deficit:.2e} below f32's "
              f"path [{device_line}]")
        if not all(math.isfinite(v) for v in m16.values()):
            fail(f"train bf16 vs f32 step {i + 1}: non-finite {m16}")
        for k in ("loss", "mle_loss", "duration_loss"):
            if not rel[k] <= BF16_LOSS_RTOL:
                fail(f"train bf16 vs f32 step {i + 1}: {k} {m16[k]} against {m32[k]} "
                     f"(bound {BF16_LOSS_RTOL} relative)")
        if not rel["grad_norm"] <= BF16_GRAD_NORM_RTOL:
            fail(f"train bf16 vs f32 step {i + 1}: grad_norm {m16['grad_norm']} against "
                 f"{m32['grad_norm']} (bound {BF16_GRAD_NORM_RTOL} relative)")
        if not -1e-6 <= deficit <= BF16_PATH_SCORE_RTOL:
            fail(f"train bf16 vs f32 step {i + 1}: bf16's alignment scores {deficit} below f32's "
                 f"under f32's logp (bound {BF16_PATH_SCORE_RTOL})")
    timed = {False: [], True: []}
    for fp16 in (False, True, True, False) * BF16_TIMED_ROUNDS:
        _, _, ms, peak, over, shape = step(fp16)
        timed[fp16].append({"ms": ms, "peak_bytes": peak, "over_resident_bytes": over,
                            "batch_y": shape})
    out = {"gpu": device_line, "steps": pairs, "loss_rtol": BF16_LOSS_RTOL,
           "grad_norm_rtol": BF16_GRAD_NORM_RTOL}
    for fp16, name in ((False, "f32"), (True, "bf16")):
        r = runs[fp16]
        wall_ms, by_kernel, operations = profiled(lambda: step(fp16))
        busy = sum(by_kernel.values())
        ms = [t["ms"] for t in timed[fp16]]
        out[name] = {
            "step_ms": ms, "step_ms_quartiles": statistics.quantiles(ms, n=4),
            "peak_bytes": max(t["peak_bytes"] for t in timed[fp16]),
            "over_resident_bytes": max(t["over_resident_bytes"] for t in timed[fp16]),
            "profiled": {"wall_ms": wall_ms, "device_busy_ms": busy,
                         "idle_share": 1.0 - busy / wall_ms if busy > 0 else None,
                         "device_operations": operations},
        }
        print(f"train {name} at batch 32 in turns: step ms {[round(x, 1) for x in ms]} "
              f"(quartiles {[round(q, 1) for q in out[name]['step_ms_quartiles']]}), peak "
              f"{out[name]['peak_bytes'] / 2 ** 30:.2f} GiB ({out[name]['over_resident_bytes'] / 2 ** 30:.2f} "
              f"over resident); profiled step wall {wall_ms:.1f} ms, device busy {busy:.1f} ms, "
              f"{operations} device operations [{device_line}]")
    del runs, batches
    return out


def held_losses(name: str, losses: list, ref: list, exact: bool,
                rtol: float = MODE_LOSS_RTOL, n_steps: int = MODE_LOSS_STEPS) -> float:
    """The per-step losses of one decoder mode against another's from the
    same init, batches and dropout seeds -> the largest relative
    difference.  ``exact``: every step to the bit; else the first
    ``n_steps`` steps within ``rtol``."""
    if len(losses) != len(ref):
        fail(f"{name}: {len(losses)} steps against {len(ref)}")
    n = len(ref) if exact else n_steps
    worst = max(abs(a - b) / abs(b) for a, b in zip(losses[:n], ref[:n]))
    if not worst <= (0.0 if exact else rtol):
        fail(f"{name}: the loss differs by {worst} relative in the first {n} steps "
             f"({'equal bits expected' if exact else rtol}): {losses[:n]} vs {ref[:n]}")
    return worst


def decoder_modes(workdir: Path, config_path: Path, main_steps: list, device_line: str) -> tuple:
    """The decoder's other training modes through the train CLI, each the
    main run's steps again -> (launch counts by mode, recorders of the
    modes' kernels, the per-mode rows).  One of the checkpoints then
    serves."""
    from glow_tts_train_tpu_torch.config import load_config
    from glow_tts_train_tpu_torch.ops import block_cuda, wn_cuda

    corpus = workdir / "corpus"
    manifest = json.loads((corpus / "manifest.json").read_text())
    config = load_config([config_path])
    n_blocks = config.model.n_blocks_dec
    recorded = {
        "fused_recompute": {"block_fwd": (block_cuda, "block_fwd"), "block_bwd": (block_cuda, "block_bwd")},
        "unfused_store": {"wn_fwd_save": (wn_cuda, "wn_fwd_save"),
                          "wn_bwd_store": (wn_cuda, "wn_bwd_store")},
        "unfused_recompute": {"wn_forward_dropout": (wn_cuda, "wn_stack"), "wn_bwd": (wn_cuda, "wn_bwd")},
    }
    main_losses = [r["loss"] for r in main_steps]
    launches_by_mode, recorders, rows = {}, {}, {}
    for mode, keys in DECODER_MODES.items():
        recs = {name: Recorder(module, attr) for name, (module, attr) in recorded[mode].items()}
        launches, steps, _, out, seconds = run_train_cli(
            workdir, corpus, manifest, config_path, dict(TRAIN_OVERRIDE, **keys), mode,
            TRAIN_STEPS, recs,
        )
        for name, rec in recs.items():
            if rec.args is None:
                fail(f"train {mode}: no call of {name} was recorded in the last step")
        want = {k: MODE_LAUNCHES[mode].get(k, 0) * n_blocks * TRAIN_STEPS for k in DECODER_KERNELS}
        want["wn_forward"] += n_blocks  # DDI, before the first step
        got = {k: launches[k] for k in want}
        if got != want:
            fail(f"train {mode}: launches {got}, expected {want}")
        epochs = [json.loads(line) for line in (workdir / f"{mode}.jsonl").read_text().splitlines()]
        ckpt = out / f"checkpoint_{1 + TRAIN_STEPS}.npz"
        if len(epochs) != 2 or not ckpt.exists():
            fail(f"train {mode}: {len(epochs)} epoch lines, checkpoint {ckpt.name} exists: {ckpt.exists()}")
        if not epochs[1]["avg_loss"] < epochs[0]["avg_loss"]:
            fail(f"train {mode}: the loss did not fall over the epochs: {epochs}")
        losses = [r["loss"] for r in steps]
        print(f"train {mode} {keys}: {TRAIN_STEPS} steps in {seconds:.1f} s (DDI and checkpoints "
              f"included), losses {losses} against the main run's {main_losses}, step ms "
              f"{[round(r['seconds'] * 1e3, 1) for r in steps]}, launches {got} [{device_line}]")
        worst = held_losses(f"train {mode} vs the main run", losses, main_losses,
                            exact=keys["flow_block_fuse"])
        launches_by_mode[mode] = launches
        recorders.update(recs)
        rows[mode] = {"config": keys, "steps": steps, "launches": got,
                      "epoch_avg_loss": [e["avg_loss"] for e in epochs],
                      "loss_rel_diff_vs_main_run": worst}

    held_losses("train unfused_recompute vs unfused_store",
                [r["loss"] for r in rows["unfused_recompute"]["steps"]],
                [r["loss"] for r in rows["unfused_store"]["steps"]], exact=True)

    # serving from a checkpoint trained op by op
    out = workdir / "model_unfused_recompute"
    serve_trained(out / f"checkpoint_{1 + TRAIN_STEPS}.npz", out / f"config_{1 + TRAIN_STEPS}.json",
                  config.audio.mel_channels)
    return launches_by_mode, recorders, rows


def decoder_mode_kernels(recorders: dict, launches_by_mode: dict, device_line: str) -> list:
    """The kernels of the decoder's other modes on the inputs their runs
    recorded in the last step: each against its plain version (a backward
    against autograd of the plain forward with the same seed, its cotangent
    scaled to max 1), a recompute backward also against the store backward
    on the same inputs (equal bits), and all timed."""
    import torch

    from glow_tts_train_tpu_torch.ops import block_cuda, wn_cuda

    n_blocks = launches_by_mode["unfused_recompute"]["wn_bwd"] // TRAIN_STEPS
    launches = {
        "block_fwd": launches_by_mode["fused_recompute"]["block_fwd"],
        "block_bwd": launches_by_mode["fused_recompute"]["block_bwd"],
        "wn_fwd_save": launches_by_mode["unfused_store"]["wn_fwd_save"],
        "wn_bwd_store": launches_by_mode["unfused_store"]["wn_bwd_store"],
        "wn_bwd": launches_by_mode["unfused_recompute"]["wn_bwd"],
        # the launches with dropout: all but DDI's one per block
        "wn_forward_dropout": launches_by_mode["unfused_recompute"]["wn_forward"] - n_blocks,
    }
    report: list = []
    entry = entry_writer(report, launches, device_line)

    def unit(t):  # a backward is linear in its cotangent
        return t / t.abs().max().clamp_min(1e-30)

    def dropout_on(name, p_dropout):
        if not p_dropout > 0.0:
            fail(f"{name}: the recorded training call has no dropout")

    # ---- block forward, nothing saved ----
    args, kwargs = recorders["block_fwd"].args
    folded, g_all, x, x_mask, *cfg = args
    dropout_on("block_fwd", cfg[3])
    with torch.no_grad():
        z, ld = block_cuda.block_fwd(*args, **kwargs)
        z_p, ld_p = block_cuda.block_forward_plain(*args, **kwargs)
        err, scale = rel_err("block_fwd z", z, z_p, KERNEL_RTOL)
        ld_err, _ = rel_err("block_fwd ld", ld, ld_p, KERNEL_RTOL)
        z_s, ld_s, _ = block_cuda.block_fwd_save(*args, **kwargs)
        if not (torch.equal(z, z_s) and torch.equal(ld, ld_s)):
            fail("block_fwd: z or ld differ from the forward-save kernel's bits")
        roof = bound("block_fwd", args, kwargs, (z, ld), block_cuda.block_fwd)
        plan = held_forward_plan("block_fwd", lambda: block_cuda.block_fwd(*args, **kwargs), roof,
                                 x.shape[0] * x.shape[1], x.shape[2], folded["W_in"], cfg[0],
                                 cfg[1], False)
        entry("block_fwd", err, scale, time_ms(block_cuda.block_fwd, args, kwargs),
              time_ms(block_cuda.block_forward_plain, args, kwargs), list(x.shape), roof,
              p_dropout=cfg[3], max_abs_err_ld=ld_err, equals_fwd_save=True,
              device_operations_plan=plan["launches"], device_ms_whole_traces=plan["device_ms"])

    # ---- block recompute backward ----
    args, kwargs = recorders["block_bwd"].args
    folded, g_all, x, x_mask, dz, dld, *cfg = args
    dropout_on("block_bwd", cfg[3])
    if g_all is not None:
        fail("block_bwd: the base config has no speaker conditioning")
    scale_by = dz.abs().max().clamp_min(1e-30)
    dz, dld = dz / scale_by, dld / scale_by
    args = (folded, g_all, x, x_mask, dz, dld, *cfg)
    grads = block_cuda.block_bwd(*args, **kwargs)
    fp = {k: v.detach().clone().requires_grad_(True) for k, v in folded.items()}
    xp = x.detach().clone().requires_grad_(True)
    inputs = [xp] + [fp[k] for k in block_cuda.FOLD_KEYS]
    z_p, ld_p = block_cuda.block_forward_plain(fp, None, xp, x_mask, *cfg)
    loss = (z_p * dz).sum() + (ld_p * dld).sum()
    names = ["dx"] + ["d" + k for k in block_cuda.FOLD_KEYS]
    ref = torch.autograd.grad(loss, inputs, retain_graph=True)
    worst = held_gradients("block_bwd", grads, names, ref)
    _, _, saves = block_cuda.block_fwd_save(folded, g_all, x, x_mask, *cfg)
    store = block_cuda.block_bwd_store(folded, False, x, x_mask, saves, dz, dld, *cfg)
    for n in names:
        if not torch.equal(grads[n], store[n]):
            fail(f"block_bwd: {n} differs from the store backward's bits")
    dx_err, dx_scale = rel_err("block_bwd dx", grads["dx"], ref[0], KERNEL_RTOL)
    roof = bound("block_bwd", args, kwargs, grads, block_cuda.block_bwd)
    plan = held_walk_plan("block_bwd", lambda: block_cuda.block_bwd(*args, **kwargs), roof,
                          x.shape[0] * x.shape[1], x.shape[2], folded["W_in"], cfg[0], cfg[1],
                          recompute=True, with_g=False)
    entry("block_bwd", dx_err, dx_scale, time_ms(block_cuda.block_bwd, args, kwargs),
          time_ms(lambda: torch.autograd.grad(loss, inputs, retain_graph=True), (), {}),
          list(x.shape), roof, p_dropout=cfg[3], device_operations_plan=plan["launches"],
          device_ms_whole_traces=plan["device_ms"],
          worst_rel_err_grad=worst, equals_store=True,
          store_ms=time_ms(block_cuda.block_bwd_store,
                           (folded, False, x, x_mask, saves, dz, dld, *cfg), {}))
    del saves, store

    # ---- WN forward-save ----
    args, kwargs = recorders["wn_fwd_save"].args
    wn, g_all, x, x_mask, *cfg = args
    dropout_on("wn_fwd_save", cfg[2])
    with torch.no_grad():
        skip, saves = wn_cuda.wn_fwd_save(*args, **kwargs)
        ref_saves: dict = {}
        skip_p = wn_cuda.wn_stack_plain(*args, saves=ref_saves, **kwargs)
        err, scale = rel_err("wn_fwd_save skip", skip, skip_p, KERNEL_RTOL)
        save_err = max(
            rel_err(f"wn_fwd_save {k}", saves[k], torch.stack(ref_saves[k]), KERNEL_RTOL)[0]
            for k in ("xs", "th", "sg")
        )
        del ref_saves
        roof = bound("wn_fwd_save", args, kwargs, (skip, saves), wn_cuda.wn_fwd_save)
        plan = held_forward_plan("wn_fwd_save", lambda: wn_cuda.wn_fwd_save(*args, **kwargs),
                                 roof, x.shape[0] * x.shape[1], 0, wn[0], cfg[0], cfg[1], True)
        fwd_products = forward_product_lines(lambda: wn_cuda.wn_fwd_save(*args, **kwargs), plan,
                                             wn[0].shape[0], device_line)
        entry("wn_fwd_save", err, scale, time_ms(wn_cuda.wn_fwd_save, args, kwargs),
              time_ms(wn_cuda.wn_stack_plain, args, kwargs), list(x.shape), roof,
              p_dropout=cfg[2], max_abs_err_saves=save_err,
              device_operations_plan=plan["launches"], device_ms_whole_traces=plan["device_ms"],
              forward_products=fwd_products)

    def wn_reference(wn, g_all, x, x_mask, dout, cfg):
        """Autograd of the plain stack -> (loss, inputs, gradient names)."""
        if g_all is not None:
            fail("the base config has no speaker conditioning")
        wp = [w.detach().clone().requires_grad_(True) for w in wn]
        xp = x.detach().clone().requires_grad_(True)
        loss = (wn_cuda.wn_stack_plain(tuple(wp), None, xp, x_mask, *cfg) * dout).sum()
        return loss, [xp, *wp], ["dx", "dW_in", "db_in", "dW_rs", "db_rs"]

    # ---- WN backward-store: the residuals of the recorded forward (the
    # step's first block), the cotangent of the recorded backward (its last) ----
    (w_in, w_rs, with_g, _, _, dout, *bwd_cfg), kwargs = recorders["wn_bwd_store"].args
    if list(bwd_cfg[:3]) != list(cfg[:3]) or dout.shape != x.shape:  # all but the block's seed
        fail(f"wn_bwd_store: recorded with {bwd_cfg} at {list(dout.shape)}, the forward with {cfg}")
    dout = unit(dout)
    args = (wn[0], wn[2], False, x_mask, saves, dout, *cfg)
    grads = wn_cuda.wn_bwd_store(*args, **kwargs)
    loss, inputs, names = wn_reference(wn, g_all, x, x_mask, dout, cfg)
    ref = torch.autograd.grad(loss, inputs, retain_graph=True)
    worst = held_gradients("wn_bwd_store", grads, names, ref)
    again = wn_cuda.wn_bwd_store(*args, **kwargs)
    if not all(torch.equal(grads[n], again[n]) for n in names):
        fail("wn_bwd_store: two runs gave different bits")
    dx_err, dx_scale = rel_err("wn_bwd_store dx", grads["dx"], ref[0], KERNEL_RTOL)
    roof = bound("wn_bwd_store", args, kwargs, grads, wn_cuda.wn_bwd_store)
    plan = held_walk_plan("wn_bwd_store", lambda: wn_cuda.wn_bwd_store(*args, **kwargs), roof,
                          x.shape[0] * x.shape[1], 0, wn[0], cfg[0], cfg[1], recompute=False,
                          with_g=False)
    walk = walk_product_lines(lambda: wn_cuda.wn_bwd_store(*args, **kwargs), plan, wn[0].shape[0],
                              device_line)
    entry("wn_bwd_store", dx_err, dx_scale, time_ms(wn_cuda.wn_bwd_store, args, kwargs),
          time_ms(lambda: torch.autograd.grad(loss, inputs, retain_graph=True), (), {}),
          list(x.shape), roof, p_dropout=cfg[2], device_operations_plan=plan["launches"],
          device_ms_whole_traces=plan["device_ms"],
          walk_products=walk, worst_rel_err_grad=worst, same_bits_twice=True)
    del saves, grads, again, loss, inputs, ref

    # ---- WN forward with dropout (the forward of recompute mode) ----
    args, kwargs = recorders["wn_forward_dropout"].args
    wn, g_all, x, x_mask, *cfg = args
    dropout_on("wn_forward_dropout", cfg[2])
    with torch.no_grad():
        skip = wn_cuda.wn_stack(*args, **kwargs)
        err, scale = rel_err("wn_forward_dropout", skip, wn_cuda.wn_stack_plain(*args, **kwargs),
                             KERNEL_RTOL)
        roof = bound("wn_forward", args, kwargs, skip, wn_cuda.wn_stack)
        plan = held_forward_plan("wn_forward_dropout", lambda: wn_cuda.wn_stack(*args, **kwargs),
                                 roof, x.shape[0] * x.shape[1], 0, wn[0], cfg[0], cfg[1], False)
        entry("wn_forward_dropout", err, scale, time_ms(wn_cuda.wn_stack, args, kwargs),
              time_ms(wn_cuda.wn_stack_plain, args, kwargs), list(x.shape), roof,
              p_dropout=cfg[2], device_operations_plan=plan["launches"],
              device_ms_whole_traces=plan["device_ms"])

    # ---- WN recompute backward ----
    args, kwargs = recorders["wn_bwd"].args
    wn, g_all, x, x_mask, dout, *cfg = args
    dropout_on("wn_bwd", cfg[2])
    dout = unit(dout)
    args = (wn, g_all, x, x_mask, dout, *cfg)
    grads = wn_cuda.wn_bwd(*args, **kwargs)
    loss, inputs, names = wn_reference(wn, g_all, x, x_mask, dout, cfg)
    ref = torch.autograd.grad(loss, inputs, retain_graph=True)
    worst = held_gradients("wn_bwd", grads, names, ref)
    _, saves = wn_cuda.wn_fwd_save(wn, g_all, x, x_mask, *cfg)
    store = wn_cuda.wn_bwd_store(wn[0], wn[2], False, x_mask, saves, dout, *cfg)
    for n in names:
        if not torch.equal(grads[n], store[n]):
            fail(f"wn_bwd: {n} differs from the store backward's bits")
    dx_err, dx_scale = rel_err("wn_bwd dx", grads["dx"], ref[0], KERNEL_RTOL)
    roof = bound("wn_bwd", args, kwargs, grads, wn_cuda.wn_bwd)
    plan = held_walk_plan("wn_bwd", lambda: wn_cuda.wn_bwd(*args, **kwargs), roof,
                          x.shape[0] * x.shape[1], 0, wn[0], cfg[0], cfg[1], recompute=True,
                          with_g=False)
    entry("wn_bwd", dx_err, dx_scale, time_ms(wn_cuda.wn_bwd, args, kwargs),
          time_ms(lambda: torch.autograd.grad(loss, inputs, retain_graph=True), (), {}),
          list(x.shape), roof, p_dropout=cfg[2], device_operations_plan=plan["launches"],
          device_ms_whole_traces=plan["device_ms"],
          worst_rel_err_grad=worst, equals_store=True)
    return report


def bf16_decoder_modes(workdir: Path, config_path: Path, device_line: str) -> tuple:
    """bf16 training in all four decoder modes (``configs/base.json`` as
    shipped, batch 32, dropout on; epochs cut to 2 and the warm-up to 200
    steps, BF16_MODE_OVERRIDE) through the train CLI from one init, on the
    same batches and dropout seeds: only the mode's bf16 decoder kernels
    launched (12 a step each), the MLE loss (the flow decoder's, the
    objective the modes compute) falling over the epochs, every
    step's losses against the fused store run's (recompute to the bit; op
    by op the first step's within MODE_LOSS_RTOL_BF16 and its MLE loss
    within MODE_MLE_RTOL_BF16) and op-by-op recompute's against op-by-op
    store's to the bit; each run's last checkpoint serves one request ->
    (launch counts by mode, recorders of the modes' kernels, the per-mode
    rows)."""
    from glow_tts_train_tpu_torch.config import load_config
    from glow_tts_train_tpu_torch.ops import block_cuda, wn_cuda

    corpus = workdir / "corpus"
    manifest = json.loads((corpus / "manifest.json").read_text())
    config = load_config([config_path])
    n_blocks, n_layers = config.model.n_blocks_dec, config.model.n_layers_enc
    recorded = {
        "fused_store": {},
        "fused_recompute": {"block_fwd_bf16": (block_cuda, "block_fwd"),
                            "block_bwd_bf16": (block_cuda, "block_bwd")},
        "unfused_store": {"wn_fwd_save_bf16": (wn_cuda, "wn_fwd_save"),
                          "wn_bwd_store_bf16": (wn_cuda, "wn_bwd_store")},
        "unfused_recompute": {"wn_forward_bf16": (wn_cuda, "wn_stack"),
                              "wn_bwd_bf16": (wn_cuda, "wn_bwd")},
    }
    # each mode against its reference: (mode, the losses' bound, the MLE
    # loss's); op by op against fused the first step only, the forward's
    # rounding on equal parameters: the updates of this warm-up part the
    # trajectories after it (the 34 steps of decoder_mode_steps, as shipped,
    # hold the first 4)
    against = {"fused_recompute": ("fused_store", 0.0, 0.0),
               "unfused_store": ("fused_store", MODE_LOSS_RTOL_BF16, MODE_MLE_RTOL_BF16),
               "unfused_recompute": ("unfused_store", 0.0, 0.0)}
    text = {"prenet": 1, "prenet_bwd": 1, "encoder_layer": n_layers,
            "encoder_layer_bwd": n_layers, "duration_stack": 1, "duration_stack_bwd": 1}
    modes = {"fused_store": {"flow_block_fuse": True, "wn_residuals": "store"}, **DECODER_MODES}
    launches_by_mode, recorders, rows = {}, {}, {}
    for mode, keys in modes.items():
        recs = {name: Recorder(module, attr) for name, (module, attr) in recorded[mode].items()}
        launches, steps, _, out, seconds = run_train_cli(
            workdir, corpus, manifest, config_path, dict(BF16_MODE_OVERRIDE, **keys),
            "bf16_" + mode, BF16_STEPS, recs, corpus_symbols=False,
        )
        for name, rec in recs.items():
            if rec.args is None:
                fail(f"train bf16 {mode}: no call of {name} was recorded in the last step")
        # DDI's WN forward in f32 (as in JAX), then only bf16 kernels
        want = {"wn_forward": n_blocks, "mas": BF16_STEPS,
                **{k: 0 for k in DECODER_KERNELS[1:] + tuple(text)},
                **{k + "_bf16": v * BF16_STEPS for k, v in text.items()},
                **{k + "_bf16": MODE_LAUNCHES[mode].get(k, 0) * n_blocks * BF16_STEPS
                   for k in DECODER_KERNELS}}
        got = {k: launches[k] for k in want}
        epochs = [json.loads(line) for line in
                  (workdir / f"bf16_{mode}.jsonl").read_text().splitlines()]
        half = BF16_STEPS // 2
        row = {"config": keys, "steps": steps, "launches": got,
               "epoch_avg_loss": [e["avg_loss"] for e in epochs],
               "epoch_mle_loss": [statistics.mean(r["mle_loss"] for r in steps[:half]),
                                  statistics.mean(r["mle_loss"] for r in steps[half:])]}
        line = (f"train bf16 {mode} {keys}: {BF16_STEPS} steps in {seconds:.1f} s (DDI and "
                f"checkpoints included), losses {[r['loss'] for r in steps]}, mle "
                f"{[r['mle_loss'] for r in steps]}, step ms "
                f"{[round(r['seconds'] * 1e3, 1) for r in steps]}, epochs' loss "
                f"{row['epoch_avg_loss']} and MLE loss {row['epoch_mle_loss']}")
        if mode in against:
            ref, rtol, mle_rtol = against[mode]
            rel = [{k: abs(a[k] - b[k]) / abs(b[k]) for k in ("loss", "mle_loss", "duration_loss")}
                   for a, b in zip(steps, rows[ref]["steps"])]
            diff = {k: max(r[k] for r in rel) for k in rel[0]}
            row.update(against=ref, rel_diff_first_step=rel[0], rel_diff=diff, loss_rtol=rtol,
                       mle_rtol=mle_rtol)
            line += (f"; against {ref}, relative difference of the first step {rel[0]} (bounds: "
                     f"the loss {rtol}, MLE {mle_rtol}), largest over the {BF16_STEPS} steps "
                     f"{diff}")
        print(f"{line}; launches {got} [{device_line}]")
        if got != want:
            fail(f"train bf16 {mode}: launches {got}, expected {want}")
        ckpt = out / f"checkpoint_{1 + BF16_STEPS}.npz"
        if len(epochs) != 2 or not ckpt.exists():
            fail(f"train bf16 {mode}: {len(epochs)} epoch lines, checkpoint {ckpt.name} exists: "
                 f"{ckpt.exists()}")
        if not row["epoch_mle_loss"][1] < row["epoch_mle_loss"][0]:
            fail(f"train bf16 {mode}: the MLE loss did not fall over the epochs: "
                 f"{row['epoch_mle_loss']}")
        if mode in against:
            ref, rtol, mle_rtol = against[mode]
            held_losses(f"train bf16 {mode} vs {ref}", [r["loss"] for r in steps],
                        [r["loss"] for r in rows[ref]["steps"]], exact=rtol == 0.0, rtol=rtol,
                        n_steps=1)
            held_losses(f"train bf16 {mode} vs {ref}, MLE", [r["mle_loss"] for r in steps],
                        [r["mle_loss"] for r in rows[ref]["steps"]], exact=rtol == 0.0,
                        rtol=mle_rtol, n_steps=1)
        serve_trained(ckpt, out / f"config_{1 + BF16_STEPS}.json", config.audio.mel_channels)
        launches_by_mode[mode] = launches
        recorders.update(recs)
        rows[mode] = row
    return launches_by_mode, recorders, rows


def unit_bf16(t):
    """A cotangent scaled to max 1 in its own dtype (a backward is linear in
    its cotangent)."""
    return (t / t.abs().max().clamp_min(1e-30)).to(t.dtype).contiguous()


def held_bf16(name: str, port: list, ref: list) -> tuple:
    """Each of ``port`` against ``ref`` within BF16_KERNEL_RTOL of its max
    |ref| (None entries skipped) -> (the worst error over its max, the
    largest max)."""
    worst, scale = 0.0, 0.0
    for i, (a, b) in enumerate(zip(port, ref)):
        if b is None:
            continue
        e, sc = rel_err(f"{name} [{i}]", a.float(), b.float(), BF16_KERNEL_RTOL)
        if i and b.abs().max().item() == 0.0:
            fail(f"{name} [{i}] is zero in the plain version: nothing was compared")
        worst, scale = max(worst, e / max(sc, 1e-6)), max(scale, sc)
    return worst, scale


def bf16_decoder_mode_kernels(recorders: dict, launches_by_mode: dict, device_line: str) -> list:
    """The six bf16 kernels of the decoder's other modes (bf16 rows 5-9 and
    11) on the inputs their runs recorded in the last step, dropout on: each
    against its plain bf16 version (``wn_stack_plain_bf16``,
    ``block_forward_plain_bf16``; a backward against its autograd with the
    cotangent scaled to max 1) within BF16_KERNEL_RTOL, a forward that saves
    nothing against the forward-save's bits and a recompute backward
    against the store backward's on the same inputs; timed with events
    against its plain version, its device time and operations from a trace
    bracketed by spin kernels, its bound at the dense BF16 peak, its device
    operations and products held to ``tc_gemm.bf16_block_products``."""
    import torch

    from glow_tts_train_tpu_torch import kernels
    from glow_tts_train_tpu_torch.ops import block_cuda, tc_gemm, wn_cuda

    sms = torch.cuda.get_device_properties(0).multi_processor_count
    by_mode = {"block_fwd": "fused_recompute", "block_bwd": "fused_recompute",
               "wn_fwd_save": "unfused_store", "wn_bwd_store": "unfused_store",
               "wn_forward": "unfused_recompute", "wn_bwd": "unfused_recompute"}
    launches = {k + "_bf16": launches_by_mode[m][k + "_bf16"] for k, m in by_mode.items()}
    report: list = []
    entry = entry_writer(report, launches, device_line)
    unit = unit_bf16

    def held_plan(name, fn, roof, x, c, folded_in, taps, **kw):
        """The call's products and device operations as the plan says."""
        b, t = x.shape[:2]
        L, _, h2 = folded_in.shape
        plan = tc_gemm.bf16_block_products(b, t, c, h2 // 2, L, taps, 1, sms, **kw)
        kernels.product_counts(reset=True)
        fn()
        torch.cuda.synchronize()
        counts = kernels.product_counts(reset=True)
        if {k: counts.get(k, 0) for k in plan["counts"]} != plan["counts"]:
            fail(f"{name}: device products {counts}, its plan {plan['counts']}")
        if roof["device_operations"] != plan["launches"]:
            fail(f"{name}: {roof['device_operations']} device operations a call, its plan "
                 f"{plan['launches']}")
        return plan["launches"]

    def dropout_on(name, p_dropout):
        if not p_dropout > 0.0:
            fail(f"{name}: the recorded training call has no dropout")

    # ---- row 9: the block forward that saves nothing ----
    args, kwargs = recorders["block_fwd_bf16"].args
    folded, g_all, x, x_mask, *cfg = args
    dropout_on("block_fwd_bf16", cfg[3])
    with torch.no_grad():
        z, ld = block_cuda.block_fwd(*args, **kwargs)
        z_s, ld_s, _ = block_cuda.block_fwd_save(*args, **kwargs)
        if not (torch.equal(z, z_s) and torch.equal(ld, ld_s)):
            fail("block_fwd_bf16: z or ld differ from the forward-save kernel's bits")
        worst, scale = held_bf16("block_fwd_bf16", [z, ld],
                                 block_cuda.block_forward_plain_bf16(*args, **kwargs))
        ms = time_ms(block_cuda.block_fwd, args, kwargs, runs=10, warmup=2)
        plain_ms = time_ms(block_cuda.block_forward_plain_bf16, args, kwargs, runs=3, warmup=1)
        roof = bf16_bound("block_fwd_bf16", args, kwargs, (z, ld), block_cuda.block_fwd)
        ops = held_plan("block_fwd_bf16", lambda: block_cuda.block_fwd(*args, **kwargs), roof, x,
                        x.shape[2], folded["W_in"], cfg[0], saves=False)
    entry("block_fwd_bf16", worst * scale, scale, ms, plain_ms, list(x.shape), roof,
          worst_relative=worst, p_dropout=cfg[3], equals_fwd_save=True,
          device_operations_plan=ops)

    # ---- row 11: the block's recompute backward ----
    args, kwargs = recorders["block_bwd_bf16"].args
    folded, g_all, x, x_mask, dz, dld, *cfg = args
    dropout_on("block_bwd_bf16", cfg[3])
    args = (folded, g_all, x, x_mask, unit(dz), unit(dld), *cfg)
    dz, dld = args[4], args[5]
    grads = block_cuda.block_bwd(*args, **kwargs)
    leaves = {k: v.detach().requires_grad_(True) for k, v in folded.items()}
    xl = x.detach().requires_grad_(True)

    def plain_bwd():  # autograd of the plain forward: the plain backward
        with torch.enable_grad():
            zz, ll = block_cuda.block_forward_plain_bf16(leaves, g_all, xl, x_mask, *cfg)
            return torch.autograd.grad((zz, ll), [xl, *leaves.values()], (dz, dld))

    names = ["dx"] + ["d" + k for k in leaves]
    worst, scale = held_bf16("block_bwd_bf16", [grads[n] for n in names], plain_bwd())
    _, _, saves = block_cuda.block_fwd_save(folded, g_all, x, x_mask, *cfg)
    store = block_cuda.block_bwd_store(folded, g_all is not None, x, x_mask, saves, dz, dld, *cfg)
    for n in names:
        if not torch.equal(grads[n], store[n]):
            fail(f"block_bwd_bf16: {n} differs from the store backward's bits")
    ms = time_ms(block_cuda.block_bwd, args, kwargs, runs=10, warmup=2)
    plain_ms = time_ms(plain_bwd, (), {}, runs=3, warmup=1)
    roof = bf16_bound("block_bwd_bf16", args, kwargs, grads, block_cuda.block_bwd)
    ops = held_plan("block_bwd_bf16", lambda: block_cuda.block_bwd(*args, **kwargs), roof, x,
                    x.shape[2], folded["W_in"], cfg[0], backward=True, recompute=True,
                    with_g=g_all is not None)
    entry("block_bwd_bf16", worst * scale, scale, ms, plain_ms, list(x.shape), roof,
          worst_relative=worst, p_dropout=cfg[3], equals_store=True, device_operations_plan=ops)
    del saves, store, grads, leaves

    # ---- rows 6 and 5: the WN stack's forward-save and forward ----
    def wn_forward_row(name, fn, args, kwargs, saves):
        wn, g_all, x, x_mask, *cfg = args
        dropout_on(name, cfg[2])
        with torch.no_grad():
            got = fn(*args, **kwargs)
            out = got[0] if saves else got
            ref_saves: dict = {}
            ref = wn_cuda.wn_stack_plain_bf16(*args, saves=ref_saves, **kwargs)
            port, plain = [out], [ref]
            if saves:
                port += [got[1][k] for k in ("xs", "th", "sg")]
                plain += [torch.stack(ref_saves[k]) for k in ("xs", "th", "sg")]
            worst, scale = held_bf16(name, port, plain)
            del ref_saves
            ms = time_ms(fn, args, kwargs, runs=10, warmup=2)
            plain_ms = time_ms(wn_cuda.wn_stack_plain_bf16, args, kwargs, runs=3, warmup=1)
            roof = bf16_bound(name, args, kwargs, got, fn)
            ops = held_plan(name, lambda: fn(*args, **kwargs), roof, x, 0, wn[0], cfg[0],
                            saves=saves)
        entry(name, worst * scale, scale, ms, plain_ms, list(x.shape), roof, worst_relative=worst,
              p_dropout=cfg[2], device_operations_plan=ops)
        return out

    fwd_args, fwd_kwargs = recorders["wn_fwd_save_bf16"].args
    out6 = wn_forward_row("wn_fwd_save_bf16", wn_cuda.wn_fwd_save, fwd_args, fwd_kwargs, True)
    args, kwargs = recorders["wn_forward_bf16"].args
    out5 = wn_forward_row("wn_forward_bf16", wn_cuda.wn_stack, args, kwargs, False)
    with torch.no_grad():
        if not torch.equal(out5, wn_cuda.wn_fwd_save(*args, **kwargs)[0]):
            fail("wn_forward_bf16: its output differs from the forward-save kernel's bits")
    del out5, out6

    def wn_plain_bwd(wn, g_all, x, x_mask, dout, cfg):
        """Autograd of the plain bf16 stack -> (its gradients' function, names)."""
        wp = [w.detach().requires_grad_(True) for w in wn]
        xp = x.detach().requires_grad_(True)
        gp = None if g_all is None else g_all.detach().requires_grad_(True)
        inputs = [xp, *wp] + ([] if gp is None else [gp])

        def grads():
            with torch.enable_grad():
                o = wn_cuda.wn_stack_plain_bf16(tuple(wp), gp, xp, x_mask, *cfg)
                return torch.autograd.grad(o, inputs, dout)

        return grads, ["dx", "dW_in", "db_in", "dW_rs", "db_rs"] + ([] if gp is None else ["dg"])

    # ---- row 8: the WN backward-store on the residuals of the recorded
    # forward (the step's first block) with the recorded backward's
    # cotangent (its last), scaled ----
    wn, g_all, x, x_mask, *cfg = fwd_args
    (_, _, with_g, _, _, dout, *bwd_cfg), kwargs = recorders["wn_bwd_store_bf16"].args
    if list(bwd_cfg[:3]) != list(cfg[:3]) or dout.shape != x.shape:
        fail(f"wn_bwd_store_bf16: recorded with {bwd_cfg} at {list(dout.shape)}, the forward "
             f"with {cfg}")
    dout = unit(dout)
    with torch.no_grad():
        _, saves = wn_cuda.wn_fwd_save(wn, g_all, x, x_mask, *cfg)
    args = (wn[0], wn[2], g_all is not None, x_mask, saves, dout, *cfg)
    grads = wn_cuda.wn_bwd_store(*args, **kwargs)
    plain, names = wn_plain_bwd(wn, g_all, x, x_mask, dout, cfg)
    worst, scale = held_bf16("wn_bwd_store_bf16", [grads[n] for n in names], plain())
    again = wn_cuda.wn_bwd_store(*args, **kwargs)
    if not all(torch.equal(grads[n], again[n]) for n in names):
        fail("wn_bwd_store_bf16: two runs gave different bits")
    ms = time_ms(wn_cuda.wn_bwd_store, args, kwargs, runs=10, warmup=2)
    plain_ms = time_ms(plain, (), {}, runs=3, warmup=1)
    roof = bf16_bound("wn_bwd_store_bf16", args, kwargs, grads, wn_cuda.wn_bwd_store)
    ops = held_plan("wn_bwd_store_bf16", lambda: wn_cuda.wn_bwd_store(*args, **kwargs), roof, x,
                    0, wn[0], cfg[0], backward=True, with_g=g_all is not None)
    entry("wn_bwd_store_bf16", worst * scale, scale, ms, plain_ms, list(x.shape), roof,
          worst_relative=worst, p_dropout=cfg[2], same_bits_twice=True,
          device_operations_plan=ops)
    del saves, grads, again

    # ---- row 7: the WN recompute backward ----
    args, kwargs = recorders["wn_bwd_bf16"].args
    wn, g_all, x, x_mask, dout, *cfg = args
    dropout_on("wn_bwd_bf16", cfg[2])
    dout = unit(dout)
    args = (wn, g_all, x, x_mask, dout, *cfg)
    grads = wn_cuda.wn_bwd(*args, **kwargs)
    plain, names = wn_plain_bwd(wn, g_all, x, x_mask, dout, cfg)
    worst, scale = held_bf16("wn_bwd_bf16", [grads[n] for n in names], plain())
    with torch.no_grad():
        _, saves = wn_cuda.wn_fwd_save(wn, g_all, x, x_mask, *cfg)
    store = wn_cuda.wn_bwd_store(wn[0], wn[2], g_all is not None, x_mask, saves, dout, *cfg)
    for n in names:
        if not torch.equal(grads[n], store[n]):
            fail(f"wn_bwd_bf16: {n} differs from the store backward's bits")
    ms = time_ms(wn_cuda.wn_bwd, args, kwargs, runs=10, warmup=2)
    plain_ms = time_ms(plain, (), {}, runs=3, warmup=1)
    roof = bf16_bound("wn_bwd_bf16", args, kwargs, grads, wn_cuda.wn_bwd)
    ops = held_plan("wn_bwd_bf16", lambda: wn_cuda.wn_bwd(*args, **kwargs), roof, x, 0, wn[0],
                    cfg[0], backward=True, recompute=True, with_g=g_all is not None)
    entry("wn_bwd_bf16", worst * scale, scale, ms, plain_ms, list(x.shape), roof,
          worst_relative=worst, p_dropout=cfg[2], equals_store=True, device_operations_plan=ops)
    return report


def decoder_mode_steps(workdir: Path, config_path: Path, device_line: str,
                       fp16: bool = False) -> dict:
    """Train-step wall time and peak device memory of the four decoder
    configurations in one process: each from the same fresh init (DDI on
    the first batch) on the 64-utterance corpus's batch shapes, 2
    warm-up steps, then turns of MODE_TURN_STEPS steps in the order a, b,
    c, d, d, c, b, a, a device sync on each side of a step.  Peak memory is
    ``max_memory_allocated`` of a step (reset before it), also over what
    was allocated when the step began (all four models and their Adam
    moments stay resident).  Every mode takes the same steps (batches,
    dropout seeds), so the loss trajectories are held together
    (``held_losses``): recompute against store in either form, to the bit
    over all 34 steps (for the TMA-fed kernels a second path: a race in
    one shows as a differing bit), and the op-by-op decoder against the
    fused block.  ``fp16``: the bf16 run's config (``configs/base.json`` as
    shipped, batch 32) and its kernels; else the f32 run's (batch 16)."""
    import torch

    from glow_tts_train_tpu_torch import data, kernels, training
    from glow_tts_train_tpu_torch.config import load_config

    corpus = workdir / "corpus"
    tag, suffix = ("bf16 ", "_bf16") if fp16 else ("", "")
    config = load_config([config_path, workdir / f"{'bf16' if fp16 else 'fused'}_override.json"])
    dataset = data.build_dataset(
        [data.SpeakerSource(0, corpus / "phonemes.csv", corpus / "mels")], config,
        mels_are_dirs=True, skip_missing_mels=False, multispeaker=False,
    )
    pipeline = data.DataPipeline(dataset, config, batch_size=config.batch_size)
    batches = [training.batch_to(b, PLATFORM) for b in pipeline.batches()]
    modes = {"fused_store": {"flow_block_fuse": True, "wn_residuals": "store"}, **DECODER_MODES}
    variants = {}
    for name, keys in modes.items():
        cfg = copy.deepcopy(config)
        for key, value in keys.items():
            setattr(cfg, key, value)
        variants[name] = {
            "step": training.make_train_step(cfg),
            "state": training.TrainState(training.initialize_model(cfg, batches[0], PLATFORM)),
            "generator": torch.Generator(device=PLATFORM).manual_seed(cfg.seed),
            "seeds": torch.Generator().manual_seed(cfg.seed),
            "n": 0, "ms": [], "peak": [], "over_resident": [], "loss": [], "mle": [],
        }

    def run_step(v, timed=True):
        batch = batches[v["n"] % len(batches)]
        v["n"] += 1
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        resident = torch.cuda.memory_allocated()
        start = time.perf_counter()
        metrics = v["step"](v["state"], batch, v["generator"], v["seeds"])
        torch.cuda.synchronize()
        if timed:
            v["ms"].append((time.perf_counter() - start) * 1e3)
            v["peak"].append(torch.cuda.max_memory_allocated())
            v["over_resident"].append(torch.cuda.max_memory_allocated() - resident)
        return metrics

    def trajectory_step(v, timed=True):
        metrics = run_step(v, timed)
        v["loss"].append(float(metrics["loss"]))
        v["mle"].append(float(metrics["mle_loss"]))

    for v in variants.values():  # the warm-up steps are the trajectory's first
        trajectory_step(v, timed=False)
        trajectory_step(v, timed=False)
    order = list(variants)
    for _ in range(MODE_ROUNDS):
        for name in order + order[::-1]:
            for _ in range(MODE_TURN_STEPS):
                trajectory_step(variants[name])
    out = {"gpu": device_line, "batch_shapes": [[list(b["x"].shape), list(b["y"].shape)] for b in batches],
           "steps_per_turn": MODE_TURN_STEPS, "turns": 2 * MODE_ROUNDS, "modes": {}}
    largest = max(range(len(batches)), key=lambda i: batches[i]["y"].shape[1])
    for name, v in variants.items():
        if not all(math.isfinite(x) for x in v["loss"]):
            fail(f"decoder mode {name}: non-finite loss {v['loss']}")
    ref = variants["fused_store"]["loss"]
    rtol = MODE_LOSS_RTOL_BF16 if fp16 else MODE_LOSS_RTOL
    loss_rel_diff = {
        "fused_recompute": held_losses(f"decoder mode {tag}fused_recompute vs fused_store",
                                       variants["fused_recompute"]["loss"], ref, exact=True),
        "unfused_recompute": held_losses(f"decoder mode {tag}unfused_recompute vs unfused_store",
                                         variants["unfused_recompute"]["loss"],
                                         variants["unfused_store"]["loss"], exact=True),
        "unfused_store": held_losses(f"decoder mode {tag}unfused_store vs fused_store",
                                     variants["unfused_store"]["loss"], ref, exact=False,
                                     rtol=rtol),
    }
    if fp16:  # and the MLE loss, the flow decoder's own
        loss_rel_diff["unfused_store_mle"] = held_losses(
            f"decoder mode {tag}unfused_store vs fused_store, MLE", variants["unfused_store"]["mle"],
            variants["fused_store"]["mle"], exact=False, rtol=MODE_MLE_RTOL_BF16)
        out["op_by_op_mle_rtol"] = MODE_MLE_RTOL_BF16
    out["loss_rel_diff"] = loss_rel_diff
    out["op_by_op_loss_rtol"] = rtol
    print(f"decoder modes {tag}: {len(ref)} steps each; largest relative loss difference, recompute "
          f"against store over all steps and op by op against fused over the first "
          f"{MODE_LOSS_STEPS} (bound {rtol}"
          f"{f', the MLE loss {MODE_MLE_RTOL_BF16}' if fp16 else ''}): {loss_rel_diff}; "
          f"fused_store losses {ref} [{device_line}]")
    for name, v in variants.items():
        before = kernels.launch_counts()
        v["n"] = largest  # one more step on the largest batch, then the same under the profiler
        run_step(v)
        after = kernels.launch_counts()
        largest_ms, largest_peak = v["ms"].pop(), v["over_resident"].pop()
        v["peak"].pop()
        v["n"] = largest
        wall_ms, by_kernel, operations = profiled(lambda: run_step(v, timed=False))
        turns = [v["ms"][i:i + MODE_TURN_STEPS] for i in range(0, len(v["ms"]), MODE_TURN_STEPS)]
        out["modes"][name] = {
            "config": modes[name], "median_step_ms": statistics.median(v["ms"]),
            "turn_median_ms": [statistics.median(t) for t in turns], "all_steps_ms": v["ms"],
            "max_memory_allocated": max(v["peak"]),
            "max_memory_over_resident": max(v["over_resident"]),
            "largest_batch": [list(batches[largest]["x"].shape), list(batches[largest]["y"].shape)],
            "largest_batch_step_ms": largest_ms,
            "largest_batch_memory_over_resident": largest_peak,
            "profiled_wall_ms": wall_ms, "device_busy_ms": sum(by_kernel.values()),
            "device_operations": operations,
            "decoder_launches_per_step": {k + suffix: after[k + suffix] - before[k + suffix]
                                          for k in DECODER_KERNELS
                                          if after[k + suffix] != before[k + suffix]},
        }
        row = out["modes"][name]
        print(f"decoder mode {tag}{name}: median step {row['median_step_ms']:.1f} ms (turns "
              f"{[round(t, 1) for t in row['turn_median_ms']]}), max_memory_allocated "
              f"{row['max_memory_allocated'] / 2**20:.0f} MiB ({row['max_memory_over_resident'] / 2**20:.0f} "
              f"MiB over what was resident), launches per step {row['decoder_launches_per_step']}; "
              f"largest batch: step {largest_ms:.1f} ms, device busy {row['device_busy_ms']:.1f} ms in "
              f"{operations} device operations [{device_line}]")
    return out


def main() -> int:
    import torch

    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device available", file=sys.stderr)
        return 2
    repo = Path(__file__).resolve().parent
    sys.path.insert(0, str(repo))
    from glow_tts_train_tpu_torch import kernels

    config_path = repo / "configs" / "base.json"
    if not config_path.exists():
        fail(f"{config_path} missing: run from a checkout of the repository")
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    device_line = gpu_line()
    print(device_line)

    start = time.perf_counter()
    lib_path = kernels.build()
    kernels.library()
    print(f"build: {lib_path.name} in {time.perf_counter() - start:.1f} s")
    for line in lib_path.with_suffix(".log").read_text().splitlines():
        if "Used" in line or "Compiling entry" in line:
            print(f"  ptxas: {line.strip()}")

    with tempfile.TemporaryDirectory(prefix="chip_smoke_") as workdir:
        return run(Path(workdir), repo, config_path, device_line)


def run(workdir: Path, repo: Path, config_path: Path, device_line: str) -> int:
    import numpy as np
    import torch

    from glow_tts_train_tpu_torch import kernels
    from glow_tts_train_tpu_torch.checkpoint import load_checkpoint
    from glow_tts_train_tpu_torch.models import encoder_forward, forward_gen, store_inverse
    from glow_tts_train_tpu_torch.ops import block_cuda, encoder_cuda, text_cuda

    products = (bare_products(device_line) + text_products(device_line)
                + bf16_block_products(device_line) + bf16_block_products(device_line, text=True))
    ckpt, config, hp = make_checkpoint(workdir, config_path)
    stdin_text = requests()

    # ---- main path: the CLI at batch 1, then batch 4 ----
    # the serving block's inputs at b=1: the first request's (48 phonemes)
    # and the last one's (250)
    b1_block = Recorder(block_cuda, "block_inverse", keep_last=True)
    b1_block.armed = True
    kernels.reset_launch_counts()
    kernels.product_counts(reset=True)
    kernels.product_splits(reset=True)
    mels_b1, sec_b1 = serve(ckpt, config_path, stdin_text, 1, hp.out_channels)
    after_b1 = kernels.launch_counts()
    products_b1 = kernels.product_counts(reset=True)
    splits_b1 = kernels.product_splits(reset=True)
    b1_block.restore()
    recorders = {
        "prenet": Recorder(text_cuda, "prenet"),
        "encoder_layer": Recorder(encoder_cuda, "encoder_layer"),
        "duration_stack": Recorder(text_cuda, "duration_stack"),
        "block_inverse": Recorder(block_cuda, "block_inverse"),
    }
    for rec in recorders.values():
        rec.armed = True
    mels_b4, sec_b4 = serve(ckpt, config_path, stdin_text, 4, hp.out_channels)
    launches = kernels.launch_counts()
    products_b4 = kernels.product_counts(reset=True)
    splits_b4 = kernels.product_splits(reset=True)
    # which kernel each pass's products took: at b=1 the serving blocks'
    # products by their plan (split-K, 64-row tiles; below that the CUDA
    # cores), the text side's declined to the CUDA cores; and no product
    # split its weights itself (the serving blocks' were split at load, the
    # text chains' once a call)
    print(f"serve: device products at b=1 {products_b1}, at b=4 {products_b4}; weight splits "
          f"launched by products: {splits_b1} (b=1), {splits_b4} (b=4)")
    if not products_b4["tc_gemm"] > 0 or not products_b1["tc_gemm"] > 0:
        fail(f"serve: no product of a pass ran on the tensor cores: {products_b1}, {products_b4}")
    if splits_b1 or splits_b4:
        fail(f"serve: products split their weights during a synthesis: {splits_b1}, {splits_b4}")
    for rec in recorders.values():
        rec.restore()
    n = len(REQUEST_LENGTHS)
    per_synth = {  # launches of each kernel in one synthesis
        "prenet": int(hp.prenet), "encoder_layer": hp.n_layers_enc,
        "duration_stack": 1, "block_inverse": hp.n_blocks_dec,
    }
    for name, per in per_synth.items():
        want_b1, want_b4 = n * per, per
        got_b1, got_b4 = after_b1[name], launches[name] - after_b1[name]
        if (got_b1, got_b4) != (want_b1, want_b4):
            fail(f"{name}: launches {got_b1} (b=1) and {got_b4} (b=4), "
                 f"expected {want_b1} and {want_b4}")
    frames = {u: m.shape[1] for u, m in mels_b4.items()}
    for utt, mel in mels_b1.items():
        if mel.shape != mels_b4[utt].shape:
            fail(f"{utt}: b=1 mel {mel.shape} vs b=4 mel {mels_b4[utt].shape}")
    print(f"serve: frames per request {frames}")
    print(f"serve: first pass b=1 {sec_b1:.3f} s, b=4 {sec_b4:.3f} s (4 requests, "
          f"checkpoint load and fold included)")
    _, warm_b1 = serve(ckpt, config_path, stdin_text, 1, hp.out_channels)
    _, warm_b4 = serve(ckpt, config_path, stdin_text, 4, hp.out_channels)
    print(f"serve: second pass b=1 {warm_b1:.3f} s, b=4 {warm_b4:.3f} s")

    # ---- each kernel against its plain version, at the b=4 pass's inputs ----
    plains = {
        "prenet": text_cuda.prenet_plain,
        "encoder_layer": encoder_cuda.encoder_layer_plain,
        "duration_stack": text_cuda.duration_stack_plain,
        "block_inverse": block_cuda.block_inverse_plain,
    }
    report = []
    for name, rec in recorders.items():
        args, kwargs = rec.args
        kernel_fn = rec.fn
        with torch.inference_mode():
            out_k = kernel_fn(*args, **kwargs)
            out_p = plains[name](*args, **kwargs)
            torch.cuda.synchronize()
            err = (out_k - out_p).abs().max().item()
            scale = out_p.abs().max().item()
            if not math.isfinite(err) or err > KERNEL_RTOL * max(scale, 1.0):
                fail(f"{name}: max abs err {err} vs max |ref| {scale} "
                     f"(tolerance {KERNEL_RTOL} relative)")
            ms = time_ms(kernel_fn, args, kwargs)
            plain_ms = time_ms(plains[name], args, kwargs)
        x = next(a for a in args if isinstance(a, torch.Tensor) and a.dim() == 3)
        source, replaces = KERNEL_META[name]
        with torch.inference_mode():
            roof = bound(name, args, kwargs, out_k, kernel_fn)
        held_to_bound(name, ms, roof)
        extra = {}
        if name in TEXT_TC_KERNELS:  # serving b=4: the convs on the tensor cores
            want = chain_products(name, args[0], x, forward=1, backward=0)
            if roof["products"] != want:
                fail(f"{name} (serving): device products {roof['products']}, expected {want}")
        if name == "block_inverse":
            held_inverse_plan("block_inverse b=4", args, roof)
            held_inverse_splits(args[0])
            extra = {"b1_" + str(n): serving_block_b1(rec_args, n, device_line)
                     for n, rec_args in ((min(REQUEST_LENGTHS), b1_block.args),
                                         (max(REQUEST_LENGTHS), b1_block.last))}
        report.append({
            "name": name, "route": "cuda", "source": source, "replaces": replaces,
            "launches": launches[name], "max_abs_err": err, "ms": ms,
            "plain_ms": plain_ms, **roof, "shape": list(x.shape), "max_abs_ref": scale, **extra,
        })
        print(f"kernel {name}: x {list(x.shape)} err {err:.3e} (max|ref| {scale:.3f}) "
              f"kernel {ms:.4f} ms ({roof.get('device_ms')} on the device, "
              f"{roof.get('device_operations')} device operations a call), plain {plain_ms:.4f} ms, "
              f"bound {roof['bound_ms']:.4f} ms by {roof['bound_by']}, products {roof.get('products')} "
              f"[{device_line}]")

    # ---- the whole mel: kernel path on the card vs plain path on the CPU ----
    rng = np.random.default_rng(SEED + 1)
    t_x = max(REQUEST_LENGTHS)
    x_np = np.zeros((n, t_x), np.int64)
    for i, k in enumerate(REQUEST_LENGTHS):
        x_np[i, :k] = rng.integers(1, 130, size=k)
    model, _ = load_checkpoint(ckpt, hp)
    w_cpu = store_inverse(model, hp)
    runs = []
    y_max = eps = None
    for dev, w in ((PLATFORM, w_cpu.to(PLATFORM)), ("cpu", w_cpu)):
        x = torch.from_numpy(x_np).to(dev)
        xl = torch.tensor(REQUEST_LENGTHS, device=dev)
        with torch.inference_mode():
            enc = encoder_forward(w, hp, x, xl)
            if y_max is None:  # one frame budget and one noise draw for both
                n_frames = torch.sum(torch.ceil(torch.exp(enc[2]) * enc[3]), dim=(1, 2))
                y_max = (int(n_frames.max()) // hp.n_sqz + 1) * hp.n_sqz
                eps = torch.from_numpy(
                    rng.standard_normal((n, y_max, hp.out_channels)).astype(np.float32)
                )
            (y, *_), _, (_, logw, _), y_len = forward_gen(
                w, hp, x, xl, y_max, noise_scale=0.333, eps=eps.to(dev),
                encoder_out=enc,
            )
        runs.append((y.cpu(), y_len.cpu(), logw.cpu()))
    (y_k, len_k, logw_k), (y_p, len_p, logw_p) = runs
    if not torch.equal(len_k, len_p):
        fail(f"y_lengths differ: {len_k.tolist()} vs {len_p.tolist()}")
    mel_err = (y_k - y_p).abs().max().item()
    mel_scale = y_p.abs().max().item()
    logw_err = (logw_k - logw_p).abs().max().item()
    print(f"mel: kernel path (cuda) vs plain path (cpu) b={n}: max abs err {mel_err:.3e}, "
          f"max |mel| {mel_scale:.3f}, logw err {logw_err:.3e}, "
          f"y_lengths {len_p.tolist()}")
    if not math.isfinite(mel_err) or mel_err > MEL_RTOL * max(mel_scale, 1.0):
        fail(f"mel: max abs err {mel_err} (tolerance {MEL_RTOL} relative)")

    serve_rows = serving_times(ckpt, config, hp, device_line)

    # ---- main path 2: training through the train CLI ----
    (train_launches, train_recorders, steps, step_ms, train_profile, trained, trained_config,
     train_phases) = train(workdir, repo, config_path, device_line)
    serve_trained(trained, trained_config, hp.out_channels)
    train_report, forward_rows = training_kernels(train_recorders, train_launches, device_line)
    report += train_report
    for row in forward_rows:  # the text stacks' forward kernels, training shape and dropout
        next(r for r in report if r["name"] == row["name"]).update(row)
    del train_recorders

    # ---- main path 4: bf16 training, configs/base.json as shipped ----
    bf16_report, bf16_row = bf16_train(workdir, config_path, device_line)
    report += bf16_report
    torch.cuda.empty_cache()

    # ---- main path 5: bf16 training in the decoder's other modes ----
    bf16_launches, bf16_recorders, bf16_mode_rows = bf16_decoder_modes(
        workdir, config_path, device_line
    )
    report += bf16_decoder_mode_kernels(bf16_recorders, bf16_launches, device_line)
    del bf16_recorders
    torch.cuda.empty_cache()
    bf16_mode_steps = decoder_mode_steps(workdir, config_path, device_line, fp16=True)
    torch.cuda.empty_cache()

    # ---- main path 3: the decoder's other training modes ----
    launches_by_mode, mode_recorders, mode_rows = decoder_modes(
        workdir, config_path, steps, device_line
    )
    report += decoder_mode_kernels(mode_recorders, launches_by_mode, device_line)
    del mode_recorders
    torch.cuda.empty_cache()
    mode_steps = decoder_mode_steps(workdir, config_path, device_line)
    torch.cuda.empty_cache()

    # ---- main path 6: export, and the exported voices served ----
    export_row = export_phase(workdir, repo, trained, trained_config, device_line)

    print(json.dumps({"products": products}))
    print(json.dumps({"serve": serve_rows}))
    print(json.dumps({"train": {"steps": steps, "median_step_ms_after_first": step_ms,
                                "profiled_step": train_profile, **train_phases}}))
    print(json.dumps({"decoder_modes": {"runs": mode_rows, "steps": mode_steps}}))
    print(json.dumps({"train_bf16": bf16_row}))
    print(json.dumps({"decoder_modes_bf16": {"runs": bf16_mode_rows, "steps": bf16_mode_steps}}))
    print(json.dumps({"export": export_row}))
    print(json.dumps({"kernels": report}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count(),
    }}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
