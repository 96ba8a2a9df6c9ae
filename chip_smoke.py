#!/usr/bin/env python3
"""Smoke test of the PyTorch/CUDA port (glow_tts_train_tpu_torch) on one
NVIDIA GPU.

    python3 chip_smoke.py        # from the repository root, one GPU

Phases, each fatal on failure:

1. builds the CUDA kernels from ``glow_tts_train_tpu_torch/csrc`` with
   nvcc for sm_90a;
2. writes a checkpoint at the full width of ``configs/base.json`` in the
   JAX package's ``.npz`` format, with random non-zero weights from a
   numpy seed (duration bias log 6: about 6 frames per phoneme);
3. serves 4 requests (48, 96, 160 and 250 phonemes) through the port's
   inference CLI entry point, ``glow_tts_train_tpu_torch.infer.main``,
   once at ``--batch-size 1`` and once at ``--batch-size 4``; checks the
   mels (finite, [80, t]) and each kernel's launch count;
4. holds each kernel against its plain PyTorch version on the card, on the
   inputs the batch-4 pass gave it, and the whole batch-4 mel of the
   kernel path against the plain path on the CPU;
5. times each kernel against its plain version with CUDA events;
6. times whole syntheses through ``build_synthesizer`` (the CLI's synth
   without stdin or JSON), kernel path against plain path on the card,
   and profiles one to read the device's busy time and idle share;
7. trains at the full width of ``configs/base.json`` (``encoder_fuse:
   false``, ``fp16_run: false``, batch 16, dropout on) through the port's
   train CLI entry point, ``glow_tts_train_tpu_torch.__main__.main``, on a
   64-utterance corpus from ``scripts/make-synthetic-corpus.py``: DDI,
   then 2 epochs of 4 steps; checks every loss and grad norm, each
   training kernel's launch count (WN forward once per block in DDI,
   block forward-save and backward-store once per block and step, MAS
   once per step), and
   serves one request from the last checkpoint through the infer CLI;
8. holds each training kernel against its plain version on inputs that
   run recorded (the backward against autograd of the plain forward with
   the same dropout seed; MAS bit for bit, also at a long shape the TPU
   streams) and times both with CUDA events, and the train step.

Prints the GPU's name and power limit, a ``{"kernels": [...]}`` JSON line,
and last ``{"ok": true, "device": {...}}``.  Exits non-zero without a GPU
or outside a checkout of the repository.
"""

import contextlib
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
PROFILED = ("b1_250", "b4_mix")

# training: 64 utterances, batch 16, 2 epochs -> 8 steps after DDI
TRAIN_UTTERANCES = 64
TRAIN_OVERRIDE = {
    "encoder_fuse": False, "fp16_run": False, "batch_size": 16, "epochs": 2,
    "warmup_steps": 50,
}
TRAIN_STEPS = 8
# a shape the TPU kernel streams through VMEM (mas_pallas.py :254/:264)
MAS_LONG = (2, 400, 2600)

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
    "block_fwd_save": ("glow_tts_train_tpu_torch/csrc/block_train.cu",
                       "glow_tts_train_tpu/ops/block_pallas.py:172"),
    "block_bwd_store": ("glow_tts_train_tpu_torch/csrc/block_train.cu",
                        "glow_tts_train_tpu/ops/block_pallas.py:271"),
    "mas": ("glow_tts_train_tpu_torch/csrc/mas.cu",
            "glow_tts_train_tpu/ops/mas_pallas.py:41"),
}


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


def requests() -> str:
    import numpy as np

    rng = np.random.default_rng(SEED)
    lines = []
    for i, n in enumerate(REQUEST_LENGTHS):
        ids = rng.integers(1, 130, size=n)
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
    """Wraps a kernel wrapper to keep a copy of the arguments of one call
    (copies: a training step later updates the parameters in place, and
    some folded weights are views of them)."""

    def __init__(self, module, name):
        self.module, self.name = module, name
        self.fn = getattr(module, name)
        self.args = None
        self.armed = False
        setattr(module, name, self)

    def __call__(self, *args, **kwargs):
        if self.armed and self.args is None:
            from glow_tts_train_tpu_torch.tree import tree_map

            self.args = tree_map(lambda a: a.detach().clone(), (args, kwargs))
        return self.fn(*args, **kwargs)

    def restore(self):
        setattr(self.module, self.name, self.fn)


def time_ms(fn, args, kwargs, runs: int = TIMED_RUNS) -> float:
    import torch

    for _ in range(5):
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
    """Synthesis wall time per batch, kernel path vs plain path on the
    card, with the real-time factor (synth seconds / audio seconds) of
    each; then the device's busy time and idle share of one profiled
    synthesis on the kernel path."""
    import numpy as np
    import torch
    from torch.profiler import ProfilerActivity, profile

    from glow_tts_train_tpu_torch.checkpoint import load_checkpoint
    from glow_tts_train_tpu_torch.infer import build_synthesizer
    from glow_tts_train_tpu_torch.models import store_inverse

    model, _ = load_checkpoint(ckpt, hp)
    weights = store_inverse(model, hp).to(PLATFORM)
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
            by_kernel = {
                e.key: e.self_device_time_total / 1e3
                for e in prof.key_averages() if e.device_type.name == "CUDA"
            }
            busy_ms = sum(by_kernel.values())
            row["profiled_wall_ms"] = wall_ms
            row["device_busy_ms"] = busy_ms
            row["idle_share"] = 1.0 - busy_ms / wall_ms if busy_ms > 0 else None
            top = sorted(by_kernel.items(), key=lambda kv: -kv[1])[:4]
            row["top_kernels_ms"] = {k[:60]: v for k, v in top}
        rows.append(row)
        print(f"synth {case}: {frames} frames, kernel path {ms['kernel']} ms, "
              f"plain path {ms['plain']} ms, RTF {row['rtf_kernel']:.3e} vs "
              f"{row['rtf_plain']:.3e} [{device_line}]")
        if case in PROFILED:
            print(f"  profiled: wall {row['profiled_wall_ms']:.3f} ms, device busy "
                  f"{busy_ms:.3f} ms, idle share {row['idle_share']}, top {row['top_kernels_ms']}")
    return rows


def rel_err(name: str, port, ref, rtol: float) -> tuple:
    """(max abs err, max |ref|); fails past rtol * max |ref|."""
    err = (port - ref).abs().max().item()
    scale = ref.abs().max().item()
    if not math.isfinite(err) or err > rtol * max(scale, 1e-6):
        fail(f"{name}: max abs err {err} vs max |ref| {scale} (tolerance {rtol} relative)")
    return err, scale


def train(workdir: Path, repo: Path, config_path: Path, device_line: str):
    """The train CLI in-process on a synthetic corpus -> (launch counts of
    the run, recorders of the training kernels, per-step rows, the last
    checkpoint and its config)."""
    import torch

    from glow_tts_train_tpu_torch import __main__ as train_cli
    from glow_tts_train_tpu_torch import kernels, training
    from glow_tts_train_tpu_torch.config import load_config
    from glow_tts_train_tpu_torch.ops import block_cuda, mas_cuda, wn_cuda

    corpus = workdir / "corpus"
    proc = subprocess.run(
        [sys.executable, str(repo / "scripts" / "make-synthetic-corpus.py"), str(corpus),
         str(TRAIN_UTTERANCES), str(SEED)],
        capture_output=True, text=True,
    )
    if proc.returncode != 0:
        fail(f"make-synthetic-corpus.py: {proc.stderr[-2000:]}")
    manifest = json.loads((corpus / "manifest.json").read_text())
    override = workdir / "train_override.json"
    override.write_text(json.dumps(dict(TRAIN_OVERRIDE, model={"num_symbols": manifest["num_symbols"]})))
    n_blocks = load_config([config_path, override]).model.n_blocks_dec
    print(f"train: corpus {manifest['n_utterances']} utterances, phonemes "
          f"{manifest['phonemes_min_max']}, frames {manifest['frames_min_max']}")

    steps = []
    last = {}  # the last step's function, state and batch, for the profile
    make_step = training.make_train_step

    def timed_make_train_step(config):
        step_fn = make_step(config)

        def timed(state, batch, *args):
            # the block and MAS kernels are held to their plain versions on
            # the last step's inputs: by then the zero-initialised end convs
            # have moved, so no gradient of the block is zero by construction
            for name in ("block_fwd_save", "block_bwd_store", "mas"):
                recorders[name].armed = len(steps) == TRAIN_STEPS - 1
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

    recorders = {
        "wn_forward": Recorder(wn_cuda, "wn_stack"),
        "block_fwd_save": Recorder(block_cuda, "block_fwd_save"),
        "block_bwd_store": Recorder(block_cuda, "block_bwd_store"),
        "mas": Recorder(mas_cuda, "maximum_path"),
    }
    recorders["wn_forward"].armed = True  # DDI, before the first step
    training.make_train_step = timed_make_train_step
    out = workdir / "model"
    kernels.reset_launch_counts()
    start = time.perf_counter()
    try:
        train_cli.main([
            "--output", str(out), "--dataset", "0", str(corpus / "phonemes.csv"),
            str(corpus / "mels"), "--mels-dir", "--config", str(config_path),
            "--config", str(override), "--metrics-file", str(workdir / "train.jsonl"),
            "--platform", PLATFORM,
        ])
        torch.cuda.synchronize()
    finally:
        training.make_train_step = make_step
        for rec in recorders.values():
            rec.restore()
    seconds = time.perf_counter() - start
    launches = kernels.launch_counts()

    if len(steps) != TRAIN_STEPS:
        fail(f"train: {len(steps)} steps, expected {TRAIN_STEPS}")
    # DDI runs each block's WN stack once; each step each block once
    want = {"wn_forward": n_blocks, "block_fwd_save": n_blocks * TRAIN_STEPS,
            "block_bwd_store": n_blocks * TRAIN_STEPS, "mas": TRAIN_STEPS}
    got = {k: launches[k] for k in want}
    if got != want:
        fail(f"train: launches {got}, expected {want}")
    for i, row in enumerate(steps):
        if not all(math.isfinite(row[k]) for k in ("loss", "mle_loss", "duration_loss")):
            fail(f"train step {i + 1}: non-finite loss {row}")
        if not (math.isfinite(row["grad_norm"]) and row["grad_norm"] > 0):
            fail(f"train step {i + 1}: grad_norm {row['grad_norm']}")
    epochs = [json.loads(line) for line in (workdir / "train.jsonl").read_text().splitlines()]
    ckpt = out / f"checkpoint_{1 + TRAIN_STEPS}.npz"
    if len(epochs) != 2 or not ckpt.exists():
        fail(f"train: {len(epochs)} epoch lines, checkpoint {ckpt.name} exists: {ckpt.exists()}")
    for i, row in enumerate(steps):
        print(f"train step {i + 1}: x {row['shape'][0]} y {row['shape'][1]} loss {row['loss']:.4f} "
              f"(mle {row['mle_loss']:.4f}, dur {row['duration_loss']:.4f}) grad_norm "
              f"{row['grad_norm']:.4f}, {row['seconds'] * 1e3:.1f} ms [{device_line}]")
    step_ms = statistics.median(r["seconds"] for r in steps[1:]) * 1e3
    print(f"train: CLI {seconds:.1f} s (corpus load, DDI, 8 steps, 2 checkpoints); median "
          f"step after the first {step_ms:.1f} ms; epochs {epochs}; launches {got}")
    profile = profile_step(last, device_line)
    return launches, recorders, steps, step_ms, profile, ckpt, out / f"config_{1 + TRAIN_STEPS}.json"


def profile_step(last: dict, device_line: str) -> dict:
    """One more step on the last batch under torch.profiler: wall time,
    device busy time (the kernels' and copies' self time; one stream, so
    they add up), idle share, kernel launches, and the top kernels."""
    import torch
    from torch.profiler import ProfilerActivity, profile

    def step():
        last["step_fn"](last["state"], last["batch"], *last["args"])

    step()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        start = time.perf_counter()
        step()
        torch.cuda.synchronize()
        wall_ms = (time.perf_counter() - start) * 1e3
    by_kernel, launches = {}, 0
    for e in prof.key_averages():
        if e.device_type.name == "CUDA":
            by_kernel[e.key] = e.self_device_time_total / 1e3
            launches += e.count
    busy_ms = sum(by_kernel.values())
    block = sum(v for k, v in by_kernel.items()
                if any(n in k for n in ("conv_gemm_kernel", "wgrad_kernel", "col_sum_kernel")))
    top = sorted(by_kernel.items(), key=lambda kv: -kv[1])[:8]
    row = {
        "batch_x": list(last["batch"]["x"].shape), "batch_y": list(last["batch"]["y"].shape),
        "wall_ms": wall_ms, "device_busy_ms": busy_ms,
        "idle_share": 1.0 - busy_ms / wall_ms if busy_ms > 0 else None,
        "device_launches": launches, "gemm_wgrad_colsum_ms": block,
        "top_ms": {k[:70]: v for k, v in top},
    }
    print(f"train profiled step: x {row['batch_x']} y {row['batch_y']} wall {wall_ms:.1f} ms, "
          f"device busy {busy_ms:.1f} ms, idle share {row['idle_share']}, {launches} device "
          f"operations, conv_gemm+wgrad+col_sum {block:.1f} ms [{device_line}]")
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
    print(f"train: the trained checkpoint {ckpt.name} serves a 12-phoneme request: mel {list(mel.shape)}")


def training_kernels(recorders: dict, launches: dict, device_line: str) -> list:
    """Each training kernel against its plain version on the recorded
    inputs, and both timed."""
    import numpy as np
    import torch

    from glow_tts_train_tpu_torch.ops import block_cuda, mas_cuda, wn_cuda

    report = []

    def entry(name, err, scale, ms, plain_ms, shape, **extra):
        source, replaces = KERNEL_META[name]
        report.append({
            "name": name, "route": "cuda", "source": source, "replaces": replaces,
            "launches": launches[name], "max_abs_err": err, "ms": ms, "plain_ms": plain_ms,
            "shape": shape, "max_abs_ref": scale, **extra,
        })
        print(f"kernel {name}: {shape} err {err:.3e} (max|ref| {scale:.3e}) kernel {ms:.4f} ms, "
              f"plain {plain_ms:.4f} ms {extra or ''}[{device_line}]")

    # WN forward (DDI)
    args, kwargs = recorders["wn_forward"].args
    with torch.no_grad():
        err, scale = rel_err("wn_forward", recorders["wn_forward"].fn(*args, **kwargs),
                             wn_cuda.wn_stack_plain(*args, **kwargs), KERNEL_RTOL)
        entry("wn_forward", err, scale, time_ms(recorders["wn_forward"].fn, args, kwargs),
              time_ms(wn_cuda.wn_stack_plain, args, kwargs), list(args[2].shape))

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
    entry("block_fwd_save", err, scale, ms, plain_ms, list(x.shape),
          p_dropout=cfg[3], max_abs_err_ld=errs[1][0], max_abs_err_saves=max(e for e, _ in errs[2:]))

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
    worst = (0.0, 1.0)
    for n, r in zip(["dx"] + ["d" + k for k in block_cuda.FOLD_KEYS], ref):
        e, sc = rel_err(f"block_bwd_store {n}", grads[n], r, KERNEL_RTOL)
        if e / max(sc, 1e-6) > worst[0] / max(worst[1], 1e-6):
            worst = (e, sc)
    dx_err, dx_scale = rel_err("block_bwd_store dx", grads["dx"], ref[0], KERNEL_RTOL)
    ms = time_ms(block_cuda.block_bwd_store, args, kwargs)
    plain_ms = time_ms(lambda: torch.autograd.grad(loss, inputs, retain_graph=True), (), {})
    entry("block_bwd_store", dx_err, dx_scale, ms, plain_ms, list(x.shape),
          worst_rel_err_grad=worst[0] / max(worst[1], 1e-6),
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
    entry("mas", err, scale, ms, plain_ms, list(logp.shape), long_shape=list(MAS_LONG),
          long_err=long_err, long_max_abs_ref=long_scale, long_ms=long_ms,
          long_plain_ms=long_plain_ms)
    return report


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

    ckpt, config, hp = make_checkpoint(workdir, config_path)
    stdin_text = requests()

    recorders = {
        "prenet": Recorder(text_cuda, "prenet"),
        "encoder_layer": Recorder(encoder_cuda, "encoder_layer"),
        "duration_stack": Recorder(text_cuda, "duration_stack"),
        "block_inverse": Recorder(block_cuda, "block_inverse"),
    }

    # ---- main path: the CLI at batch 1, then batch 4 ----
    kernels.reset_launch_counts()
    mels_b1, sec_b1 = serve(ckpt, config_path, stdin_text, 1, hp.out_channels)
    after_b1 = kernels.launch_counts()
    for rec in recorders.values():
        rec.armed = True
    mels_b4, sec_b4 = serve(ckpt, config_path, stdin_text, 4, hp.out_channels)
    launches = kernels.launch_counts()
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
        report.append({
            "name": name, "route": "cuda", "source": source, "replaces": replaces,
            "launches": launches[name], "max_abs_err": err, "ms": ms,
            "plain_ms": plain_ms, "shape": list(x.shape), "max_abs_ref": scale,
        })
        print(f"kernel {name}: x {list(x.shape)} err {err:.3e} (max|ref| {scale:.3f}) "
              f"kernel {ms:.4f} ms, plain {plain_ms:.4f} ms [{device_line}]")

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
    train_launches, train_recorders, steps, step_ms, train_profile, trained, trained_config = train(
        workdir, repo, config_path, device_line
    )
    serve_trained(trained, trained_config, hp.out_channels)
    report += training_kernels(train_recorders, train_launches, device_line)

    print(json.dumps({"serve": serve_rows}))
    print(json.dumps({"train": {"steps": steps, "median_step_ms_after_first": step_ms,
                                "profiled_step": train_profile}}))
    print(json.dumps({"kernels": report}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count(),
    }}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
