#!/usr/bin/env python3
"""The default-mode train step, the flow block's two training kernels, the
text encoder layer's and the prenet's two kernels and MAS of one checkout of
glow_tts_train_tpu_torch on one GPU, as one JSON object.

    python scripts/torch-block-step-probe.py [--repo DIR] [--steps 24]

To compare two commits on one card, unpack the other one beside this
checkout (``git archive <commit> | tar -x -C DIR``) and run the script once
per tree in turns, in one shell command: parent, change, change, parent.
``--repo`` names the checkout whose package is imported and whose kernels
are built (default: the one this file lies in).

Base width (``configs/base.json``, ``fp16_run: false``), batch 16, dropout
on, the fused block in store mode (the default), the four batch shapes of a
64-utterance synthetic corpus (``scripts/make-synthetic-corpus.py``), a
fresh init with DDI on the first batch.  After 4 warm-up steps, ``--steps``
steps with a device sync on each side of a step; then the largest batch
once unprofiled and once under ``torch.profiler`` for the device's busy
time, its count of device operations and its time by GEMM kernel.  Then
``block_fwd_save`` and ``block_bwd_store`` alone at [16, 704, 160] on random
non-zero weights (dropout 0.05); then ``encoder_layer`` and
``encoder_layer_bwd`` (layer 1 of the same weights, in the layout the tree's
main path passes: Q/K/V merged where the tree has ``encoder_cuda.merge_qkv``)
at the training shape [16, 192, 192] with dropout 0.1 and ragged lengths, and
``encoder_layer`` at serving b=4 [4, 250, 192] (requests of 48, 96, 160 and
250 phonemes); the prenet's forward and backward at the same training shape
with dropout 0.5, its forward at serving b=4 and b=1 [1, 250, 192]; MAS at
[16, 192, 1408] (the same text lengths, 7 frames a phoneme up to 1408) and
at [2, 400, 2600] (one sample full, one cut).  Each kernel is timed with CUDA events (median of 30 calls
after 5) and by the device's own time under the profiler (mean of 10), with
its device operations a call.  Prints the GPU's name and power limit with the
numbers.
"""

import argparse
import json
import statistics
import subprocess
import sys
import tempfile
import time
from pathlib import Path

HERE = Path(__file__).resolve().parent.parent
GEMM_KERNELS = ("conv_gemm_tc_kernel", "conv_gemm_tap_kernel", "wgrad_tc_kernel",
                "wgrad_tc_split_kernel", "wgrad_reduce_kernel", "split_weights_kernel",
                "conv_gemm_kernel", "wgrad_kernel", "col_sum_kernel")


def event_ms(fn, runs: int = 30) -> float:
    import torch

    for _ in range(5):
        fn()
    times = []
    for _ in range(runs):
        start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
        start.record()
        fn()
        end.record()
        end.synchronize()
        times.append(start.elapsed_time(end))
    return statistics.median(times)


def device_ms(fn, runs: int = 10) -> tuple:
    """(the device's own time for one call of ``fn``: the self time of its
    kernels and copies under torch.profiler, without the host's gaps; its
    device operations a call)."""
    import torch
    from torch.profiler import ProfilerActivity, profile

    fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        for _ in range(runs):
            fn()
        torch.cuda.synchronize()
    events = [e for e in prof.key_averages() if e.device_type.name == "CUDA"]
    return (sum(e.self_device_time_total for e in events) / 1e3 / runs,
            sum(e.count for e in events) / runs)


def main() -> int:
    parser = argparse.ArgumentParser()
    parser.add_argument("--repo", type=Path, default=HERE, help="the checkout to measure")
    parser.add_argument("--steps", type=int, default=24, help="timed steps")
    args = parser.parse_args()
    repo = args.repo.resolve()
    sys.path.insert(0, str(repo))

    import numpy as np
    import torch
    from torch.profiler import ProfilerActivity, profile

    if not torch.cuda.is_available():
        print("no CUDA device available", file=sys.stderr)
        return 2
    from glow_tts_train_tpu_torch import checkpoint, data, kernels, training
    from glow_tts_train_tpu_torch.config import load_config
    from glow_tts_train_tpu_torch.models import hyper_from_config
    from glow_tts_train_tpu_torch.ops import block_cuda, encoder_cuda, mas_cuda, text_cuda
    from glow_tts_train_tpu_torch.tree import tree_index, tree_map

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    gpu = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True,
    ).stdout.strip().splitlines()[0]
    start = time.perf_counter()
    kernels.library()
    build_s = time.perf_counter() - start

    with tempfile.TemporaryDirectory(prefix="block_probe_") as tmp:
        corpus = Path(tmp) / "corpus"
        subprocess.run(
            [sys.executable, str(repo / "scripts" / "make-synthetic-corpus.py"), str(corpus), "64", "0"],
            check=True, capture_output=True,
        )
        manifest = json.loads((corpus / "manifest.json").read_text())
        over = Path(tmp) / "over.json"
        over.write_text(json.dumps({
            "fp16_run": False, "batch_size": 16, "warmup_steps": 50,
            "model": {"num_symbols": manifest["num_symbols"]},
        }))
        config = load_config([repo / "configs" / "base.json", over])
        dataset = data.build_dataset(
            [data.SpeakerSource(0, corpus / "phonemes.csv", corpus / "mels")], config,
            mels_are_dirs=True, skip_missing_mels=False, multispeaker=False,
        )
        pipeline = data.DataPipeline(dataset, config, batch_size=config.batch_size)
        batches = [training.batch_to(b, "cuda") for b in pipeline.batches()]

    state = training.TrainState(training.initialize_model(config, batches[0], "cuda"))
    step = training.make_train_step(config)
    generator = torch.Generator(device="cuda").manual_seed(config.seed)
    seeds = torch.Generator().manual_seed(config.seed)

    def run_step(batch) -> float:
        torch.cuda.synchronize()
        begin = time.perf_counter()
        step(state, batch, generator, seeds)
        torch.cuda.synchronize()
        return (time.perf_counter() - begin) * 1e3

    for i in range(4):
        run_step(batches[i % len(batches)])
    steps_ms = [run_step(batches[i % len(batches)]) for i in range(args.steps)]
    largest = max(batches, key=lambda b: b["y"].shape[1])
    run_step(largest)
    unprofiled = run_step(largest)
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        profiled_wall = run_step(largest)
    busy, ops, by_kernel = 0.0, 0, {name: 0.0 for name in GEMM_KERNELS}
    for e in prof.key_averages():
        if e.device_type.name == "CUDA":
            busy += e.self_device_time_total / 1e3
            ops += e.count
            for name in GEMM_KERNELS:
                if name in e.key:
                    by_kernel[name] += e.self_device_time_total / 1e3

    # the block's two training kernels alone, on random non-zero weights
    hp = hyper_from_config(config)
    tree: dict = {}
    for key, a in checkpoint.random_params(hp, 0).items():
        *parents, leaf = key[len("model/"):].split("/")
        node = tree
        for p in parents:
            node = node.setdefault(p, {})
        node[leaf] = torch.from_numpy(a)
    tree = tree_map(lambda a: a.to("cuda"), tree)
    folded = {
        k: v.detach().contiguous()
        for k, v in block_cuda.fold_block_params(
            tree_index(tree["decoder"]["blocks"], 0), hp.n_block_layers, hp.n_split
        ).items()
    }
    rng = np.random.default_rng(0)
    batch, t, c = 16, 704, 2 * hp.out_channels
    lengths = torch.from_numpy(rng.integers(t // 2, t + 1, size=batch)).to("cuda")
    mask = (torch.arange(t, device="cuda")[None, :] < lengths[:, None]).float()[..., None].contiguous()
    x = (torch.from_numpy(rng.standard_normal((batch, t, c)).astype(np.float32)).to("cuda") * mask).contiguous()
    cfg = (hp.kernel_size_dec, hp.dilation_rate, hp.sigmoid_scale, 0.05, 1234)
    z, ld, saves = block_cuda.block_fwd_save(folded, None, x, mask, *cfg)
    dz = (torch.from_numpy(rng.standard_normal((batch, t, c)).astype(np.float32)).to("cuda") * mask).contiguous()
    dld = torch.ones_like(ld)
    fwd_ms = event_ms(lambda: block_cuda.block_fwd_save(folded, None, x, mask, *cfg))
    bwd_ms = event_ms(lambda: block_cuda.block_bwd_store(folded, False, x, mask, saves, dz, dld, *cfg))
    fwd_device_ms = device_ms(lambda: block_cuda.block_fwd_save(folded, None, x, mask, *cfg))[0]
    bwd_device_ms = device_ms(
        lambda: block_cuda.block_bwd_store(folded, False, x, mask, saves, dz, dld, *cfg))[0]

    # the encoder layer's two kernels
    weights = encoder_cuda.fold_encoder_layer(tree_index(tree["encoder"], 1))
    if hasattr(encoder_cuda, "merge_qkv"):
        weights = encoder_cuda.merge_qkv(weights)

    def text_inputs(lengths, t):
        m = (torch.arange(t)[None, :] < torch.tensor(lengths)[:, None]).float()[..., None]
        xx = torch.from_numpy(rng.standard_normal((len(lengths), t, hp.h_enc)).astype(np.float32))
        return xx.to("cuda").contiguous(), m.to("cuda").contiguous()

    xe, mask_e = text_inputs([192] + rng.integers(64, 193, size=15).tolist(), 192)
    dout = torch.from_numpy(rng.standard_normal(xe.shape).astype(np.float32)).to("cuda")
    xs, mask_s = text_inputs([48, 96, 160, 250], 250)
    ecfg = (hp.n_heads, hp.window_size, 0.1, 1234)
    encoder = {}
    for name, fn in {
        "encoder_layer_train": lambda: encoder_cuda.encoder_layer(weights, xe, mask_e, *ecfg),
        "encoder_layer_bwd_train":
            lambda: encoder_cuda.encoder_layer_bwd(weights, xe, mask_e, dout, *ecfg),
        "encoder_layer_serve_b4":
            lambda: encoder_cuda.encoder_layer(weights, xs, mask_s, hp.n_heads, hp.window_size),
    }.items():
        ms = event_ms(fn)
        dev_ms, dev_ops = device_ms(fn)
        encoder[name] = {"ms": ms, "device_ms": dev_ms, "device_operations": dev_ops}

    # the prenet's two kernels (training, serving b=4 and b=1) and MAS at the
    # training shape and a long one
    pw = text_cuda.prenet_weights(tree["prenet"])
    x1, mask_1 = text_inputs([250], 250)
    t_y = 1408
    x_len = mask_e[:, :, 0].sum(1).long()
    y_len = torch.clamp(x_len * 7, max=t_y)
    y_len[0] = t_y
    mask_m = ((torch.arange(192, device="cuda")[None, :, None] < x_len[:, None, None])
              & (torch.arange(t_y, device="cuda")[None, None, :] < y_len[:, None, None])).float()
    logp = torch.from_numpy(rng.standard_normal((16, 192, t_y)).astype(np.float32)).to("cuda")
    logp_long = torch.from_numpy(rng.standard_normal((2, 400, 2600)).astype(np.float32)).to("cuda")
    mask_long = torch.zeros_like(logp_long)
    mask_long[0] = 1.0
    mask_long[1, :363, :2189] = 1.0
    for name, fn in {
        "prenet_train": lambda: text_cuda.prenet(pw, xe, mask_e, 0.5, 1234),
        "prenet_bwd_train": lambda: text_cuda.prenet_bwd(pw, xe, mask_e, dout, 0.5, 1234),
        "prenet_serve_b4": lambda: text_cuda.prenet(pw, xs, mask_s),
        "prenet_serve_b1": lambda: text_cuda.prenet(pw, x1, mask_1),
        "mas_train": lambda: mas_cuda.maximum_path(logp, mask_m),
        "mas_long": lambda: mas_cuda.maximum_path(logp_long, mask_long),
    }.items():
        ms = event_ms(fn)
        dev_ms, dev_ops = device_ms(fn)
        encoder[name] = {"ms": ms, "device_ms": dev_ms, "device_operations": dev_ops}

    print(json.dumps({
        "repo": str(repo), "gpu": gpu, "build_s": build_s,
        "batch_shapes": [[list(b["x"].shape), list(b["y"].shape)] for b in batches],
        "steps_ms": steps_ms, "median_step_ms": statistics.median(steps_ms),
        "largest_batch": [list(largest["x"].shape), list(largest["y"].shape)],
        "largest_batch_step_ms": unprofiled, "profiled_wall_ms": profiled_wall,
        "device_busy_ms": busy, "device_operations": ops,
        "idle_share_unprofiled": 1.0 - busy / unprofiled,
        "device_ms_by_gemm_kernel": by_kernel,
        "block_fwd_save_ms": fwd_ms, "block_bwd_store_ms": bwd_ms,
        "block_fwd_save_device_ms": fwd_device_ms, "block_bwd_store_device_ms": bwd_device_ms,
        "block_shape": [batch, t, c],
        "encoder_shapes": {"train": list(xe.shape), "serve_b4": list(xs.shape),
                           "serve_b1": list(x1.shape)},
        "mas_shapes": {"train": list(logp.shape), "long": list(logp_long.shape)}, **encoder,
    }))
    return 0


if __name__ == "__main__":
    sys.exit(main())
