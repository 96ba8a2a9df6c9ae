#!/usr/bin/env python3
"""Rows 5-12 of PERF.md's table (the WN stack's four kernels and the flow
block's four training kernels) of one checkout of glow_tts_train_tpu_torch
on one GPU, as one JSON object.

    python scripts/torch-decoder-rows-probe.py [--repo DIR]

To compare two commits on one card, unpack the other one beside this
checkout (``git archive <commit> | tar -x -C DIR``) and run the script once
per tree in turns, in one shell command: parent, change, change, parent.
``--repo`` names the checkout whose package is imported and whose kernels
are built (default: the one this file lies in).  Only the wrappers' public
signatures are used, so an older tree of the port runs it too.

Base width (``configs/base.json``), block 0 of random non-zero weights
(``checkpoint.random_params``, seed 0), dropout 0.05, ragged lengths: the
WN stack's kernels at [16, 704, 192] (``wn_stack`` with dropout, row 5;
``wn_fwd_save``, 6; ``wn_bwd``, 7; ``wn_bwd_store``, 8), the block's at
[16, 704, 160] (``block_fwd``, 9; ``block_fwd_save``, 10; ``block_bwd``, 11;
``block_bwd_store``, 12).  Each is timed with CUDA events (median of 30
calls after 5) and by the device's own time under torch.profiler (mean of
10 calls: the self time of its kernels, fills and copies), with its device
operations a call.  Prints the GPU's name and power limit with the numbers.
"""

import argparse
import json
import statistics
import subprocess
import sys
import time
from pathlib import Path

HERE = Path(__file__).resolve().parent.parent


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
    """(the device's own time for one call in ms, its device operations a call)."""
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
    args = parser.parse_args()
    repo = args.repo.resolve()
    sys.path.insert(0, str(repo))

    import numpy as np
    import torch

    if not torch.cuda.is_available():
        print("no CUDA device available", file=sys.stderr)
        return 2
    from glow_tts_train_tpu_torch import checkpoint, kernels
    from glow_tts_train_tpu_torch.config import load_config
    from glow_tts_train_tpu_torch.models import hyper_from_config
    from glow_tts_train_tpu_torch.ops import block_cuda, wn_cuda
    from glow_tts_train_tpu_torch.tree import tree_index

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    gpu = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True,
    ).stdout.strip().splitlines()[0]
    start = time.perf_counter()
    kernels.library()
    build_s = time.perf_counter() - start

    hp = hyper_from_config(load_config([repo / "configs" / "base.json"]))
    tree: dict = {}
    for key, a in checkpoint.random_params(hp, 0).items():
        *parents, leaf = key[len("model/"):].split("/")
        node = tree
        for p in parents:
            node = node.setdefault(p, {})
        node[leaf] = torch.from_numpy(a).cuda()
    L, h, c, taps = hp.n_block_layers, hp.h_dec, 2 * hp.out_channels, hp.kernel_size_dec
    folded = {k: v.detach().contiguous() for k, v in block_cuda.fold_block_params(
        tree_index(tree["decoder"]["blocks"], 0), L, hp.n_split).items()}
    wn = tuple(folded[k] for k in ("W_in", "b_in", "W_rs", "b_rs"))

    rng = np.random.default_rng(3)
    batch, t = 16, 704
    lengths = rng.integers(200, t + 1, size=batch)
    lengths[0] = t
    mask = (torch.arange(t)[None, :] < torch.from_numpy(lengths)[:, None]).float()[..., None]
    mask = mask.cuda().contiguous()

    def randn(*shape):
        return torch.from_numpy(rng.standard_normal(shape).astype(np.float32)).cuda()

    xw = (randn(batch, t, h) * mask).contiguous()
    dout = randn(batch, t, h)
    x = (randn(batch, t, c) * mask).contiguous()
    dz, dld = randn(batch, t, c), randn(batch)
    wcfg = (taps, hp.dilation_rate, 0.05, 1234)
    bcfg = (taps, hp.dilation_rate, hp.sigmoid_scale, 0.05, 1234)
    _, wsaves = wn_cuda.wn_fwd_save(wn, None, xw, mask, *wcfg)
    _, _, bsaves = block_cuda.block_fwd_save(folded, None, x, mask, *bcfg)
    rows = {
        "5 wn_forward": lambda: wn_cuda.wn_stack(wn, None, xw, mask, *wcfg),
        "6 wn_fwd_save": lambda: wn_cuda.wn_fwd_save(wn, None, xw, mask, *wcfg),
        "7 wn_bwd": lambda: wn_cuda.wn_bwd(wn, None, xw, mask, dout, *wcfg),
        "8 wn_bwd_store": lambda: wn_cuda.wn_bwd_store(wn[0], wn[2], False, mask, wsaves, dout,
                                                       *wcfg),
        "9 block_fwd": lambda: block_cuda.block_fwd(folded, None, x, mask, *bcfg),
        "10 block_fwd_save": lambda: block_cuda.block_fwd_save(folded, None, x, mask, *bcfg),
        "11 block_bwd": lambda: block_cuda.block_bwd(folded, None, x, mask, dz, dld, *bcfg),
        "12 block_bwd_store": lambda: block_cuda.block_bwd_store(
            folded, False, x, mask, bsaves, dz, dld, *bcfg),
    }
    out = {"repo": str(repo), "gpu": gpu, "build_s": build_s,
           "shapes": {"wn": [batch, t, h], "block": [batch, t, c]}}
    for name, fn in rows.items():
        ms = event_ms(fn)
        dev_ms, ops = device_ms(fn)
        out[name] = {"ms": ms, "device_ms": dev_ms, "device_operations": ops}
    print(json.dumps(out))
    return 0


if __name__ == "__main__":
    sys.exit(main())
