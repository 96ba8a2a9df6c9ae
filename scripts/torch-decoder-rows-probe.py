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
operations a call.  Then the ``product wn_fwd`` lines: one ``wn_fwd_save``
call's device operations by kind, from a trace of 3 calls between spin
kernels (the in-layer conv and the res/skip product a layer, with TFLOP/s
and bound, the weight-split launches and the input copy a call; the
conv-GEMMs of a call alternate in-layer conv, res/skip in either tree).
Prints the GPU's name and power limit with the numbers.

With ``--bf16`` the same eight rows' bf16 entry points (``fp16_run``: x, the
saves and the products' weights bf16) at [``--batch``, 704] (default 32, the
shipped batch), each with its scratch block's bytes; then the gate backward
alone (``--gate``): the bare product [batch * 704, 384 -> 192] on the
TMA-fed kernel by CUDA events, and the gate backward's conv-GEMM inside
``wn_bwd_store``'s chain (its kernel's device time a layer, from a trace of
3 calls between spin kernels: the walk's conv-GEMMs alternate gate
backward, transposed conv), against its byte floor (g_rs's copy, th and sg
in; d_xin's copy and acts out, bf16) at 3.35 TB/s.

    python scripts/torch-decoder-rows-probe.py --bf16 [--batch 32] [--repo DIR]

Each row's outputs (its first call's) are hashed (sha256 of every output
tensor's bytes, in name order) and printed.  ``--save FILE`` writes them,
with the forward-save rows' saves, to FILE; ``--against FILE`` (one tree's
``--save``, taken in the same call) feeds the store rows (8, 12) that
file's saves and holds every row's outputs to its: rows 5-8 and 12 bit for
bit, rows 9-11 (whose forward holds the folded A) within 2e-2 of each
output's max |ref|; a row that misses fails the script.

    python scripts/torch-decoder-rows-probe.py --bf16 --repo PARENT --save P.pt
    python scripts/torch-decoder-rows-probe.py --bf16 --against P.pt
"""

import argparse
import hashlib
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


def bracketed_ops(fn, calls: int) -> list:
    """The device operations of ``calls`` calls of ``fn`` in launch order,
    [(name, device us)], from a trace in which 16 spin kernels stand on
    each side of them (a trace short of records at an edge is taken again,
    up to 4 times)."""
    import torch
    from torch.profiler import ProfilerActivity, profile

    fn()
    for _ in range(4):
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
        if (inner and any(spin[:inner[0]]) and any(spin[inner[-1]:])
                and not any(spin[inner[0]:inner[-1]]) and len(inner) % calls == 0):
            return [(ops[i].name, ops[i].time_range.elapsed_us()) for i in inner]
    raise RuntimeError("no trace of 4 held the calls' operations between spin kernels")


def forward_product_lines(fn, rows: int, h: int, taps: int, n_layers: int, gpu: str) -> dict:
    """A ``wn_fwd_save`` call's device time by kind: per layer the in-layer
    conv [rows, taps * h, 2h] and the res/skip product [rows, h, 2h] (the
    call's conv-GEMM kernels in launch order alternate the two), per call
    the weight-split launches and the input copy."""
    calls = 3
    ops = bracketed_ops(fn, calls)
    per_call = len(ops) // calls
    total = {"in_conv": 0.0, "res_skip": 0.0, "splits": 0.0, "copy": 0.0}
    kernels_by_kind = {"in_conv": set(), "res_skip": set()}
    splits = 0
    for c in range(calls):
        gemm = 0
        for name, us in ops[c * per_call:(c + 1) * per_call]:
            if "split_weights_kernel" in name:
                total["splits"] += us
                splits += 1
            elif "Memcpy" in name or "memcpy" in name:
                total["copy"] += us
            else:
                kind = "in_conv" if gemm % 2 == 0 else "res_skip"
                total[kind] += us
                kernels_by_kind[kind].add(name.split("(")[0].replace("void ", ""))
                gemm += 1
        if gemm != 2 * n_layers:
            raise RuntimeError(f"wn_fwd_save: {gemm} conv-GEMMs in a call, {2 * n_layers} expected")
    out = {"device_operations": per_call, "split_launches": splits // calls}
    for kind, shape in (("in_conv", [rows, taps * h, 2 * h]), ("res_skip", [rows, h, 2 * h])):
        us = total[kind] / (calls * n_layers)
        flops = 2.0 * shape[0] * shape[1] * shape[2]
        out[kind] = {"shape": shape, "device_us": us, "tflops": flops / us / 1e6,
                     "bound_us": flops / (495e12 / 3) * 1e6,
                     "kernels": sorted(kernels_by_kind[kind])}
        print(f"product wn_fwd {kind}: {shape} by {', '.join(out[kind]['kernels'])}: "
              f"{us:.1f} us on the device a layer = {out[kind]['tflops']:.1f} TFLOP/s, bound "
              f"{out[kind]['bound_us']:.1f} us at 165 TFLOP/s [{gpu}]")
    for kind in ("splits", "copy"):
        out[kind + "_us"] = total[kind] / calls
    print(f"product wn_fwd splits: {out['splits_us']:.1f} us a call in {out['split_launches']} "
          f"launches; copy: {out['copy_us']:.1f} us a call; {per_call} device operations a "
          f"call [{gpu}]")
    return out


def gate_lines(folded16: dict, row8, batch: int, t: int, h: int, n_layers: int,
               gpu: str) -> dict:
    """The bf16 gate backward alone and in ``wn_bwd_store``'s chain."""
    import torch

    from glow_tts_train_tpu_torch.ops import tc_gemm

    rng = torch.Generator(device="cuda").manual_seed(5)
    a = torch.randn(batch, t, 2 * h, generator=rng, device="cuda").to(torch.bfloat16)
    w = folded16["W_rs"][0].contiguous()  # [h, 2h]: B = W_rs^T, read through w_t
    bare_ms = event_ms(lambda: tc_gemm.bf16_conv_product(a, w, w_t=True))
    calls = 3

    def in_chain():
        ops = bracketed_ops(row8, calls)
        convs = [us for name, us in ops if "conv_gemm_bf16" in name]
        if len(convs) != calls * 2 * n_layers:
            raise RuntimeError(f"wn_bwd_store: {len(convs)} conv-GEMMs in {calls} calls")
        return sum(convs[0::2]) / len(convs[0::2]), sum(convs[1::2]) / len(convs[1::2])

    gate_us, tconv_us = in_chain()
    rows = batch * t
    floor_bytes = 2 * rows * (2 * h + h + h + 2 * h + h)  # g_rs16, th, sg in; dxin16, acts out
    out = {"shape": [rows, 2 * h, h], "bare_us": 1e3 * bare_ms, "in_chain_us": gate_us,
           "transposed_in_chain_us": tconv_us, "floor_bytes": floor_bytes,
           "floor_us": floor_bytes / 3.35e12 * 1e6}
    print(f"gate backward bf16 {out['shape']}: bare {out['bare_us']:.1f} us (events), in the "
          f"chain {gate_us:.1f} us on the device (transposed conv {tconv_us:.1f}), floor "
          f"{out['floor_us']:.1f} us ({floor_bytes / 1e6:.1f} MB) [{gpu}]")
    return out


# a row's outputs against another tree's on the same inputs where the folded
# A's product moved (rows 9-11): the bf16 kernels' tolerance against their
# plain versions, relative to each output's max |ref|
AGAINST_RTOL = 2e-2
# rows whose outputs do not go through the folded A: the same bits
SAME_BITS_ROWS = ("5", "6", "7", "8", "12")


def flat_outputs(out, prefix: str = "") -> dict:
    """A row's outputs (a tensor, or tuples and dicts of them) -> {name:
    tensor}, None entries left out."""
    import torch

    if isinstance(out, torch.Tensor):
        return {prefix or "out": out.detach()}
    items = (sorted(out.items()) if isinstance(out, dict)
             else [(str(i), v) for i, v in enumerate(out)] if isinstance(out, (tuple, list))
             else [])
    flat = {}
    for k, v in items:
        if v is not None:
            flat.update(flat_outputs(v, f"{prefix}/{k}" if prefix else str(k)))
    return flat


def digest(flat: dict) -> str:
    """sha256 of a row's output names and bytes, in name order (16 hex digits)."""
    import torch

    h = hashlib.sha256()
    for k in sorted(flat):
        h.update(k.encode())
        h.update(flat[k].contiguous().cpu().view(-1).view(torch.uint8).numpy().tobytes())
    return h.hexdigest()[:16]


def held_against(name: str, flat: dict, ref: dict) -> str:
    """Row ``name``'s outputs against another tree's -> a verdict; raises
    where a row misses (SAME_BITS_ROWS not bit for bit, the rest beyond
    AGAINST_RTOL)."""
    import torch

    row = name.split()[0]
    if sorted(flat) != sorted(ref):
        raise RuntimeError(f"row {name}: outputs {sorted(flat)} against {sorted(ref)}")
    same = all(torch.equal(flat[k].cpu(), ref[k]) for k in flat)
    if row in SAME_BITS_ROWS:
        if not same:
            raise RuntimeError(f"row {name}: not the other tree's bits")
        return "the same bits"
    worst = 0.0
    for k in flat:
        r = ref[k].float()
        err = (flat[k].cpu().float() - r).abs().max().item() / max(r.abs().max().item(), 1e-30)
        worst = max(worst, err)
    if not worst <= AGAINST_RTOL:
        raise RuntimeError(f"row {name}: {worst:.3e} of max |ref| from the other tree's")
    return "the same bits" if same else f"within {worst:.2e} of max |ref|"


def main() -> int:
    parser = argparse.ArgumentParser()
    parser.add_argument("--repo", type=Path, default=HERE, help="the checkout to measure")
    parser.add_argument("--bf16", action="store_true", help="the bf16 entry points")
    parser.add_argument("--batch", type=int, default=0, help="samples (default 16, bf16 32)")
    parser.add_argument("--save", type=Path, help="write the rows' outputs and saves here")
    parser.add_argument("--against", type=Path, help="hold the rows to this --save file")
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
    batch, t = args.batch or (32 if args.bf16 else 16), 704
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
    scratch = {}
    if args.bf16:  # x, dout, dz and the products' weights bf16; biases, mask, dld f32
        bf = torch.bfloat16
        folded = {k: v.to(bf if k in block_cuda.BF16_OPERANDS else torch.float32)
                  for k, v in folded.items()}
        wn = (folded["W_in"], folded["b_in"], folded["W_rs"], folded["b_rs"])
        xw, dout, x, dz = (v.to(bf) for v in (xw, dout * mask, x, dz))
        for name, size, recompute in (
                ("7 wn_bwd", lambda r: kernels.wn_bwd_bf16_scratch_floats(
                    batch, t, h, L, taps, r, False), 1),
                ("8 wn_bwd_store", lambda r: kernels.wn_bwd_bf16_scratch_floats(
                    batch, t, h, L, taps, r, False), 0),
                ("11 block_bwd", lambda r: kernels.block_bwd_bf16_scratch_floats(
                    batch, t, c, h, L, taps, r, False), 1),
                ("12 block_bwd_store", lambda r: kernels.block_bwd_bf16_scratch_floats(
                    batch, t, c, h, L, taps, r, False), 0)):
            scratch[name] = 4 * size(recompute)
    _, wsaves = wn_cuda.wn_fwd_save(wn, None, xw, mask, *wcfg)
    _, _, bsaves = block_cuda.block_fwd_save(folded, None, x, mask, *bcfg)
    against = torch.load(args.against) if args.against else None
    if against is not None:  # the store rows on the other tree's saves
        wsaves = {k: v.cuda() for k, v in against["saves"]["wn"].items()}
        bsaves = {k: v.cuda() for k, v in against["saves"]["block"].items()}
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
    out = {"repo": str(repo), "gpu": gpu, "build_s": build_s, "bf16": args.bf16,
           "shapes": {"wn": [batch, t, h], "block": [batch, t, c]}}
    saved = {}
    for name, fn in rows.items():
        flat = {k: v.cpu() for k, v in flat_outputs(fn()).items()}
        torch.cuda.synchronize()
        saved[name] = flat
        verdict = held_against(name, flat, against["outputs"][name]) if against else None
        print(f"row {name}: outputs sha256 {digest(flat)}"
              + (f"; against {args.against.name}: {verdict}" if verdict else ""))
        ms = event_ms(fn)
        dev_ms, ops = device_ms(fn)
        out[name] = {"ms": ms, "device_ms": dev_ms, "device_operations": ops,
                     "outputs_sha256": digest(flat)}
        if verdict:
            out[name]["against"] = verdict
        if name in scratch:
            out[name]["scratch_bytes"] = scratch[name]
        print(f"row {name}{' bf16' if args.bf16 else ''}: {ms:.4f} ms (events), {dev_ms:.4f} ms "
              f"on the device, {ops:.0f} device operations a call"
              f"{f', scratch {scratch[name] / 1e6:.1f} MB' if name in scratch else ''} [{gpu}]")
    if args.save:
        args.save.parent.mkdir(parents=True, exist_ok=True)
        torch.save({"saves": {"wn": {k: v.cpu() for k, v in wsaves.items()},
                              "block": {k: v.cpu() for k, v in bsaves.items()}},
                    "outputs": saved}, args.save)
    if args.bf16:
        out["gate_bwd"] = gate_lines(folded, rows["8 wn_bwd_store"], batch, t, h, L, gpu)
    else:
        out["product wn_fwd"] = forward_product_lines(rows["6 wn_fwd_save"], batch * t, h, taps,
                                                      L, gpu)
    print(json.dumps(out))
    return 0


if __name__ == "__main__":
    sys.exit(main())
