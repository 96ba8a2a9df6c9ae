#!/usr/bin/env python3
"""The serving flow block (``block_inverse``), the duration stack's two
kernels (``duration_stack``, ``duration_stack_bwd``) and whole syntheses of
one checkout of glow_tts_train_tpu_torch on one GPU, as one JSON object.

    python scripts/torch-serve-probe.py [--repo DIR]

To compare two commits on one card, unpack the other one beside this
checkout (``git archive <commit> | tar -x -C DIR``) and run the script once
per tree in turns, in one shell command: parent, change, change, parent.
``--repo`` names the checkout whose package is imported and whose kernels
are built (default: the one this file lies in).

Base width (``configs/base.json``), random non-zero weights from a numpy
seed (``checkpoint.random_params``, duration bias log 6 as in
``chip_smoke.py``), every weight folded as the serving path folds it
(``store_inverse``).  Each call is timed with CUDA events (median of 30
calls after 5) and by the device's own time under the profiler (mean of
10), with its device operations a call and the device time by kernel
(products, weight splits, split-K passes, copies and fills):

* ``block_inverse`` (the last block's folds) at [1, 160, 160] (a
  48-phoneme request), [1, 832, 160] (250 phonemes), [4, 832, 160]
  (requests of 48, 96, 160 and 250 phonemes, ragged) and [8, 544, 160];
* ``duration_stack`` at training [16, 192, 192] (ragged lengths, dropout
  0.1), serving b=4 [4, 250, 192] and b=1 [1, 250, 192];
  ``duration_stack_bwd`` at the training shape;
* whole syntheses through ``infer.build_synthesizer`` (median wall ms of
  10 after 3; one profiled: device busy ms and device operations): b=1 of
  48 and 250 phonemes, b=4 of 48, 96, 160 and 250.

Prints the GPU's name and power limit with the numbers.
"""

import argparse
import json
import math
import statistics
import subprocess
import sys
import time
from pathlib import Path

HERE = Path(__file__).resolve().parent.parent
# device time by kernel: a kernel's name holding one of these keys adds to it
KERNEL_GROUPS = ("conv_gemm_tc_kernel", "conv_gemm_kernel", "splitk_reduce_kernel",
                 "split_weights_kernel", "wgrad_tc_kernel", "wgrad_kernel", "col_sum_kernel",
                 "column_sums_kernel", "layer_norm", "mask_rows_kernel", "Memcpy", "Memset")
REQUESTS = (48, 96, 160, 250)


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


def device_profile(fn, runs: int = 10) -> dict:
    """The device's own time for one call of ``fn`` (the self time of its
    kernels, copies and fills under torch.profiler, without the host's
    gaps), its device operations a call and its device ms by kernel group."""
    import torch
    from torch.profiler import ProfilerActivity, profile

    fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        for _ in range(runs):
            fn()
        torch.cuda.synchronize()
    events = [e for e in prof.key_averages() if e.device_type.name == "CUDA"]
    by_group = {}
    for e in events:
        group = next((g for g in KERNEL_GROUPS if g in e.key), "other")
        ms, ops = by_group.get(group, (0.0, 0.0))
        by_group[group] = (ms + e.self_device_time_total / 1e3 / runs, ops + e.count / runs)
    return {
        "device_ms": sum(e.self_device_time_total for e in events) / 1e3 / runs,
        "device_operations": sum(e.count for e in events) / runs,
        "by_kernel": {g: {"ms": ms, "operations": ops} for g, (ms, ops) in by_group.items()},
    }


def timed(fn) -> dict:
    return {"ms": event_ms(fn), **device_profile(fn)}


def main() -> int:
    parser = argparse.ArgumentParser()
    parser.add_argument("--repo", type=Path, default=HERE, help="the checkout to measure")
    args = parser.parse_args()
    repo = args.repo.resolve()
    sys.path.insert(0, str(repo))

    import numpy as np
    import torch
    from torch.profiler import ProfilerActivity, profile

    if not torch.cuda.is_available():
        print("no CUDA device available", file=sys.stderr)
        return 2
    from glow_tts_train_tpu_torch import checkpoint, kernels
    from glow_tts_train_tpu_torch.config import load_config
    from glow_tts_train_tpu_torch.infer import build_synthesizer
    from glow_tts_train_tpu_torch.models import hyper_from_config, store_inverse
    from glow_tts_train_tpu_torch.ops import block_cuda, text_cuda

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    gpu = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True,
    ).stdout.strip().splitlines()[0]
    start = time.perf_counter()
    kernels.library()
    build_s = time.perf_counter() - start

    config = load_config([repo / "configs" / "base.json"])
    hp = hyper_from_config(config)
    flat = checkpoint.random_params(hp, 0)
    flat["model/proj_w/proj/w"] *= np.float32(0.1)
    flat["model/proj_w/proj/b"][:] = math.log(6.0)
    model = checkpoint.params_from_numpy(flat, hp)
    weights = store_inverse(model, hp).to("cuda")
    rng = np.random.default_rng(0)

    def masked_input(lengths, t, c):
        m = (torch.arange(t)[None, :] < torch.tensor(lengths)[:, None]).float()[..., None]
        xx = torch.from_numpy(rng.standard_normal((len(lengths), t, c)).astype(np.float32))
        return (xx * m).to("cuda").contiguous(), m.to("cuda").contiguous()

    out = {"repo": str(repo), "gpu": gpu, "build_s": build_s}

    # the serving flow block: the last block's folds (the first the decoder runs)
    folded, c = weights.blocks[-1], 2 * hp.out_channels
    block_shapes = {
        "b1_48": ([160], 160), "b1_250": ([832], 832),
        "b4_mix": ([160, 304, 496, 832], 832), "b8_160": ([544] * 8, 544),
    }
    for case, (lengths, t) in block_shapes.items():
        x, mask = masked_input(lengths, t, c)
        fn = lambda: block_cuda.block_inverse(  # noqa: E731
            folded, None, x, mask, hp.kernel_size_dec, hp.dilation_rate, hp.sigmoid_scale)
        kernels.product_counts(reset=True)
        fn()
        products = kernels.product_counts(reset=True)
        out[f"block_inverse_{case}"] = {"shape": list(x.shape), "products": products, **timed(fn)}

    # the duration stack: training (ragged, dropout 0.1), serving b=4 and b=1
    dw = weights.dp
    xt, mask_t = masked_input([192] + rng.integers(64, 193, size=15).tolist(), 192, hp.h_enc)
    dout = torch.from_numpy(
        rng.standard_normal((16, 192, dw[0].shape[1])).astype(np.float32)).to("cuda")
    xs, mask_s = masked_input(list(REQUESTS), 250, hp.h_enc)
    x1, mask_1 = masked_input([250], 250, hp.h_enc)
    for name, fn in {
        "duration_stack_train": lambda: text_cuda.duration_stack(dw, xt, mask_t, 0.1, 1234),
        "duration_stack_bwd_train":
            lambda: text_cuda.duration_stack_bwd(dw, xt, mask_t, dout, 0.1, 1234),
        "duration_stack_serve_b4": lambda: text_cuda.duration_stack(dw, xs, mask_s),
        "duration_stack_serve_b1": lambda: text_cuda.duration_stack(dw, x1, mask_1),
    }.items():
        kernels.product_counts(reset=True)
        fn()
        out[name] = {"products": kernels.product_counts(reset=True), **timed(fn)}

    # whole syntheses
    synth = build_synthesizer(weights, hp, config, noise_scale=0.333, length_scale=1.0)
    ids = {n: rng.integers(1, 130, size=n).tolist() for n in REQUESTS}
    for case, lengths in {"b1_48": (48,), "b1_250": (250,), "b4_mix": REQUESTS}.items():
        batch = [ids[n] for n in lengths]
        for _ in range(3):
            synth(batch)
        walls = []
        for _ in range(10):
            begin = time.perf_counter()
            synth(batch)  # ends in the copy of the mels to the host
            walls.append((time.perf_counter() - begin) * 1e3)
        synth(batch)
        with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
            begin = time.perf_counter()
            synth(batch)
            profiled_wall = (time.perf_counter() - begin) * 1e3
        events = [e for e in prof.key_averages() if e.device_type.name == "CUDA"]
        busy = sum(e.self_device_time_total for e in events) / 1e3
        out[f"synth_{case}"] = {
            "wall_ms": walls, "median_wall_ms": statistics.median(walls),
            "profiled_wall_ms": profiled_wall, "device_busy_ms": busy,
            "device_operations": sum(e.count for e in events),
            "split_weights_operations": sum(e.count for e in events
                                            if "split_weights_kernel" in e.key),
        }
    print(json.dumps(out))
    return 0


if __name__ == "__main__":
    sys.exit(main())
