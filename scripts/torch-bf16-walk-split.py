#!/usr/bin/env python3
"""Where the bf16 WN walk's and the bf16 block forward's device time goes,
on one GPU, as one JSON object.

    python scripts/torch-bf16-walk-split.py [--batch 32] [--unit tma,ws] [--repo DIR]

Base width (``configs/base.json``: h 192, 4 WN layers, 5 taps, the
dilations ``hp.dilation_rate`` gives: 1 as shipped), block 0 of random
non-zero weights, [``--batch``, 704], dropout 0.05, ragged lengths, every
operand bf16 as ``fp16_run`` gives them:

* ``chain``: one call of ``wn_bwd_store`` (bf16 row 8), of ``block_fwd``
  (bf16 row 9) and of ``wn_fwd_save`` (bf16 row 6), each from a trace of 3
  calls between spin kernels: every device operation of a call in launch
  order with its device us, and the sums by kind (the walk: gate backward,
  transposed conv, dW_rs, dW_in, their reductions, the cotangent launch
  and the fill; the forward: the folded A, the start conv, in-layer convs,
  res/skip products, the coupling, the rest).
* ``bare_fwd``: the WN forward's two products alone on each unit of
  ``--unit`` with the bias epilogue and f32 out (not on "ws", which takes
  their own epilogues alone): the in-layer conv [rows, 5 x 192 -> 384] and res/skip
  [rows, 192 -> 384]; on a tree that has ``tc_gemm.bf16_wn_product``, also
  with their own epilogues (the gate with saves and dropout; res/skip of a
  middle layer and of the last).
* ``bare``: one product alone on each unit of ``--unit`` that is one of
  ``tc_gemm.BF16_UNITS`` but ``text``, its kernel's device us (mean of 20
  calls under torch.profiler): the gate backward's [rows, 384 -> 192]
  with its bias epilogue at batch 24, 32, 48 and 72 (a sample is 11 tiles
  of 64 rows: 264, 352, 528, 792 tiles, 1, 1.33, 2 and 3 waves of the
  64-row kernel's two blocks an SM on 132 SMs), with a row mask and tile
  sums (a cotangent epilogue's stores and sums) at the batch, at
  K = 64 (one K step: its epilogue, launch and first loads), and the
  transposed conv's [rows, 5 x 384 -> 192] at dilations 1 and 8.

Each number stands beside the GPU's name and power limit.  Compare two
checkouts in one call, in turns (``--repo``).
"""

import argparse
import importlib.util
import json
import subprocess
import sys
from pathlib import Path

HERE = Path(__file__).resolve().parent.parent


def _probe():
    spec = importlib.util.spec_from_file_location(
        "rows_probe", HERE / "scripts" / "torch-decoder-rows-probe.py")
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def kernel_us(fn, match: str, runs: int = 20) -> float:
    """Mean device us a call of the kernels whose name holds ``match``."""
    import torch
    from torch.profiler import ProfilerActivity, profile

    for _ in range(3):
        fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        for _ in range(runs):
            fn()
        torch.cuda.synchronize()
    events = [e for e in prof.key_averages()
              if e.device_type.name == "CUDA" and match in e.key]
    if not events:
        raise RuntimeError(f"no kernel named like {match!r} in the trace")
    return sum(e.self_device_time_total for e in events) / runs


def walk_kind(name: str, gemm_index: int) -> str:
    if "wgrad_bf16_reduce" in name:
        return "reductions"
    if "wgrad_bf16" in name:
        return "wgrad"
    if "conv_gemm_bf16" in name:
        return "gate" if gemm_index % 2 == 0 else "transposed"
    if "walk_cotangent" in name:
        return "cotangent"
    if "emset" in name:
        return "fill"
    return "other"


def chain_split(probe, fn, calls: int, kind_of) -> dict:
    ops = probe.bracketed_ops(fn, calls)
    per_call = len(ops) // calls
    total: dict = {}
    gemm = 0
    for i, (name, us) in enumerate(ops):
        if i % per_call == 0:
            gemm = 0
        kind = kind_of(name, gemm)
        if "conv_gemm" in name:
            gemm += 1
        total[kind] = total.get(kind, 0.0) + us / calls
    first = [[name.split("(")[0].replace("void ", ""), us] for name, us in ops[:per_call]]
    return {"device_operations": per_call, "by_kind_us": total,
            "device_us": sum(total.values()), "first_call": first}


def bare_forward(units, tc_gemm, kernel_us, folded, mask, batch, t, h, taps, gpu) -> dict:
    """The WN forward's two products alone on each unit: the bias
    epilogue with f32 out and, where the tree has them, their own."""
    import torch

    bf = torch.bfloat16
    g = torch.Generator(device="cuda").manual_seed(7)
    x = (torch.randn(batch, t, h, generator=g, device="cuda") * mask).to(bf)
    w_in = folded["W_in"][0].contiguous()      # [taps * h, 2h]
    w_rs = folded["W_rs"][0].contiguous()      # [h, 2h]
    b_in, b_rs = folded["b_in"][0].contiguous(), folded["b_rs"][0].contiguous()
    own = getattr(tc_gemm, "bf16_wn_product", None)
    res: dict = {}
    for unit in units:
        r = {}
        if unit != "ws":  # the warp-specialised unit takes their own epilogues alone
            r["in_conv_bias"] = kernel_us(
                lambda: tc_gemm.bf16_conv_product(x, w_in, taps=taps, unit=unit), "conv_gemm")
            r["res_skip_bias"] = kernel_us(
                lambda: tc_gemm.bf16_conv_product(x, w_rs, unit=unit), "conv_gemm")
        if own is not None:
            skip = torch.randn(batch, t, h, generator=g, device="cuda")
            drop = (0.05, 1234, 0, 4)
            r["in_conv_gate_saves"] = kernel_us(
                lambda: own("gate", x, w_in, b_in, taps=taps, drop=drop, saves=True, unit=unit),
                "conv_gemm")
            r["res_skip_middle"] = kernel_us(
                lambda: own("res_skip", x, w_rs, b_rs, x_l=x, skip=skip, mask=mask, layer=1,
                            n_layers=4, unit=unit), "conv_gemm")
            r["res_skip_last"] = kernel_us(
                lambda: own("res_skip", x, w_rs, b_rs, x_l=x, skip=skip, mask=mask, layer=3,
                            n_layers=4, unit=unit), "conv_gemm")
        res[unit] = r
        print(f"bare forward {unit}: " + ", ".join(f"{k} {v:.1f} us" for k, v in r.items())
              + f" [{gpu}]")
    return res


def main() -> int:
    parser = argparse.ArgumentParser()
    parser.add_argument("--repo", type=Path, default=HERE, help="the checkout to measure")
    parser.add_argument("--batch", type=int, default=32)
    parser.add_argument("--unit", default="tma",
                        help="comma-separated bf16 units of the bare products (mma, tma, ws)")
    args = parser.parse_args()
    repo = args.repo.resolve()
    sys.path.insert(0, str(repo))

    import numpy as np
    import torch

    if not torch.cuda.is_available():
        print("no CUDA device available", file=sys.stderr)
        return 2
    probe = _probe()
    from glow_tts_train_tpu_torch import checkpoint, kernels
    from glow_tts_train_tpu_torch.config import load_config
    from glow_tts_train_tpu_torch.models import hyper_from_config
    from glow_tts_train_tpu_torch.ops import block_cuda, tc_gemm, wn_cuda
    from glow_tts_train_tpu_torch.tree import tree_index

    gpu = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True,
    ).stdout.strip().splitlines()[0]
    kernels.library()
    hp = hyper_from_config(load_config([repo / "configs" / "base.json"]))
    tree: dict = {}
    for key, a in checkpoint.random_params(hp, 0).items():
        *parents, leaf = key[len("model/"):].split("/")
        node = tree
        for p in parents:
            node = node.setdefault(p, {})
        node[leaf] = torch.from_numpy(a).cuda()
    L, h, c, taps = hp.n_block_layers, hp.h_dec, 2 * hp.out_channels, hp.kernel_size_dec
    bf = torch.bfloat16
    folded = {k: v.detach().contiguous().to(bf if k in block_cuda.BF16_OPERANDS else torch.float32)
              for k, v in block_cuda.fold_block_params(
                  tree_index(tree["decoder"]["blocks"], 0), L, hp.n_split).items()}
    wn = (folded["W_in"], folded["b_in"], folded["W_rs"], folded["b_rs"])
    rng = np.random.default_rng(3)
    batch, t = args.batch, 704
    lengths = rng.integers(200, t + 1, size=batch)
    lengths[0] = t
    mask = (torch.arange(t)[None, :] < torch.from_numpy(lengths)[:, None]).float()[..., None]
    mask = mask.cuda().contiguous()

    def randn(*shape):
        return torch.from_numpy(rng.standard_normal(shape).astype(np.float32)).cuda()

    xw = (randn(batch, t, h) * mask).to(bf).contiguous()
    dout = (randn(batch, t, h) * mask).to(bf)
    x = (randn(batch, t, c) * mask).to(bf).contiguous()
    wcfg = (taps, hp.dilation_rate, 0.05, 1234)
    bcfg = (taps, hp.dilation_rate, hp.sigmoid_scale, 0.05, 1234)
    _, wsaves = wn_cuda.wn_fwd_save(wn, None, xw, mask, *wcfg)
    row8 = lambda: wn_cuda.wn_bwd_store(wn[0], wn[2], False, mask, wsaves, dout, *wcfg)  # noqa: E731
    row9 = lambda: block_cuda.block_fwd(folded, None, x, mask, *bcfg)  # noqa: E731

    def fwd_kind(name: str, gemm_index: int) -> str:
        if "conv_gemm" in name:
            if gemm_index == 0:
                return "folded_a"
            if gemm_index == 1:
                return "start"
            if gemm_index == 2 + 2 * L:
                return "coupling"
            return "in_conv" if gemm_index % 2 == 0 else "res_skip"
        return "other"

    row6 = lambda: wn_cuda.wn_fwd_save(wn, None, xw, mask, *wcfg)  # noqa: E731

    def wn_kind(name: str, gemm_index: int) -> str:
        if "conv_gemm" in name:
            return "in_conv" if gemm_index % 2 == 0 else "res_skip"
        return "other"

    out = {"repo": str(repo), "gpu": gpu, "shape": [batch, t, h]}
    out["row8_chain"] = chain_split(probe, row8, 3, walk_kind)
    out["row9_chain"] = chain_split(probe, row9, 3, fwd_kind)
    out["row6_chain"] = chain_split(probe, row6, 3, wn_kind)
    for row in ("row8_chain", "row9_chain", "row6_chain"):
        r = out[row]
        print(f"{row}: {r['device_us']:.1f} us on the device in {r['device_operations']} "
              f"operations: " + ", ".join(f"{k} {v:.1f}" for k, v in r["by_kind_us"].items())
              + f" [{gpu}]")

    units = args.unit.split(",")
    g = torch.Generator(device="cuda").manual_seed(5)
    w_rs = folded["W_rs"][0].contiguous()                # [h, 2h]: B = W_rs^T
    w_in = folded["W_in"][0].contiguous()                # [taps * h, 2h]: the tconv's B
    bare: dict = {}
    for unit in (u for u in units if u in tc_gemm.BF16_UNITS and u != "text"):
        res: dict = {}
        for b in (24, 32, 48, 72):
            a = torch.randn(b, t, 2 * h, generator=g, device="cuda").to(bf)
            res[f"gate_b{b}"] = kernel_us(
                lambda: tc_gemm.bf16_conv_product(a, w_rs, w_t=True, unit=unit), "conv_gemm_bf16")
        a = torch.randn(batch, t, 2 * h, generator=g, device="cuda").to(bf)
        m = mask
        res["gate_mask_sums"] = kernel_us(
            lambda: tc_gemm.bf16_conv_product(a, w_rs, w_t=True, unit=unit, mask=m, sums=True),
            "conv_gemm_bf16")
        a64 = torch.randn(batch, t, 64, generator=g, device="cuda").to(bf)
        w64 = w_rs[:, :64].contiguous()
        res["k64"] = kernel_us(
            lambda: tc_gemm.bf16_conv_product(a64, w64, w_t=True, unit=unit), "conv_gemm_bf16")
        for dil in (1, 8):
            res[f"transposed_d{dil}"] = kernel_us(
                lambda: tc_gemm.bf16_conv_product(a, w_in, taps=taps, dilation=dil, tap_sign=-1,
                                                  w_t=True, unit=unit), "conv_gemm_bf16")
        bare[unit] = res
        print(f"bare {unit}: " + ", ".join(f"{k} {v:.1f} us" for k, v in res.items())
              + f" [{gpu}]")
    out["bare_us"] = bare
    out["bare_fwd_us"] = bare_forward(units, tc_gemm, kernel_us, folded, mask, batch, t, h, taps,
                                      gpu)
    print(json.dumps(out))
    return 0


if __name__ == "__main__":
    sys.exit(main())
