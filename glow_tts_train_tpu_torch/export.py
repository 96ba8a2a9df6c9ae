#!/usr/bin/env python3
"""Export CLI of the port: a checkpoint to a portable artifact, with the
options of ``python -m glow_tts_train_tpu.export``:

    python -m glow_tts_train_tpu_torch.export CHECKPOINT OUTPUT [--format F]

CHECKPOINT is a ``.npz`` of either package or a reference ``.pth``, loaded
strictly.  Formats:

* ``pt2`` (the default; the JAX package's ``stablehlo``): a
  ``torch.export`` ExportedProgram, ``generator.pt2``, with the weights in
  it and the JAX artifact's signature and static budgets::

      (input [1, max_text_length] int32, input_lengths [1] int32,
       scales [2] f32 = [noise, length], seed [] int32)
          -> (mel [1, n_mel, max_frames] f32, mel_lengths [1] int32)

  The graph is the plain PyTorch one, traced on the host: no hand-written
  kernel is in it, as the JAX package forces its op-by-op path, so the
  artifact needs nothing of this package's compiled library.  It runs on
  the CPU and on a CUDA card: :func:`load_pt2` moves the program to the
  device asked for (its weights, and the one device that its nodes name,
  the host's at the trace).  The noise is drawn inside the graph from
  ``seed`` (:func:`seeded_normal`, a counter hash), so one seed gives one
  mel; a multispeaker model's speaker is baked in.
* ``onnx``: ``generator.onnx``, opset 12 with dynamic axes, built by the
  port's copy of the JAX package's numpy exporter (``onnx/``).  Each
  InvConvNear's inverse is handed to it as ``weight_inv``: the f32
  ``torch.linalg.inv`` of the weight that the live serving path takes
  (``block_cuda.fold_block_params_inverse``), so the artifact inverts as
  the port serves.
* ``torch``: a reference ``generator.pth`` (the raw training weights, not
  folded, and the Adam state where the checkpoint holds one that matches
  the config), loadable by the reference PyTorch Glow-TTS with
  ``strict=True``.
* ``savedmodel`` is TensorFlow's and is refused (exit 2).

Every format writes ``config.json`` beside the artifact; all but
``torch`` also write ``export_meta.json`` (format, budgets, global step,
speaker).  ``--platform cuda`` (the default) loads the written ``.pt2``
back onto the card and runs it once as a check, and exits with an error
without a GPU; ``--platform cpu`` checks it on the host.
"""

import argparse
import json
import logging
import math
import time
import typing
from pathlib import Path

_LOGGER = logging.getLogger("glow_tts_train_tpu_torch.export")

ARTIFACT_NAME = "generator.pt2"
ONNX_NAME = "generator.onnx"
TORCH_NAME = "generator.pth"
META_NAME = "export_meta.json"
FORMATS = ("pt2", "savedmodel", "onnx", "torch")

_M32 = 0xFFFFFFFF


def _mul32(x, c: int):
    """(x * c) mod 2^32 of int64 tensors that hold uint32 values, without
    leaving int64: the product split at bit 16."""
    lo, hi = x & 0xFFFF, x >> 16
    return (lo * c + (((hi * c) & 0xFFFF) << 16)) & _M32


def _mix32(x):
    """MurmurHash3's 32-bit finalizer."""
    x = x ^ (x >> 16)
    x = _mul32(x, 0x85EBCA6B)
    x = x ^ (x >> 13)
    x = _mul32(x, 0xC2B2AE35)
    return x ^ (x >> 16)


def seeded_normal(seed, like):
    """Standard normal noise of ``like``'s shape, dtype and device from an
    integer tensor ``seed``, in tensor ops only (a ``torch.Generator``
    cannot enter an exported program): element i hashes (2i, seed) and
    (2i + 1, seed) to two uniforms in (0, 1), Box-Muller makes the
    normal.  The same seed gives the same noise on every device up to the
    rounding of log, sqrt and cos."""
    import torch

    n = like.numel()
    key = _mix32((seed.to(torch.int64) & _M32) ^ 0x9E3779B9)
    counter = torch.arange(2 * n, device=like.device, dtype=torch.int64)
    bits = _mix32(_mix32(counter ^ key) ^ ((key * 5 + 0x6A09E667) & _M32))
    u = ((bits >> 8).to(torch.float32) + 0.5) * (1.0 / (1 << 24))
    u1, u2 = u[0::2], u[1::2]
    z = torch.sqrt(-2.0 * torch.log(u1)) * torch.cos((2.0 * math.pi) * u2)
    return z.reshape(like.shape).to(like.dtype)


def generator_graph(weights, hp, max_frames: int, speaker: typing.Optional[int] = None):
    """The module that ``pt2`` exports: ``forward_gen`` on ``weights``
    (ServingWeights on the CPU, so every op takes its plain version) into
    the static ``max_frames`` budget."""
    import torch

    from .models.glow_tts import forward_gen

    class Generator(torch.nn.Module):
        def __init__(self):
            super().__init__()
            self.weights = weights
            if speaker is not None:
                self.register_buffer("g_ids", torch.tensor([speaker], dtype=torch.int64))
            else:
                self.g_ids = None

        def forward(self, text, text_lengths, scales, seed):
            t_y = (max_frames // hp.n_sqz) * hp.n_sqz
            eps = seeded_normal(seed, text.new_empty((1, t_y, hp.out_channels), dtype=torch.float32))
            (y, _, _, _), _, _, y_lengths = forward_gen(
                self.weights, hp, text.to(torch.int64), text_lengths, max_frames,
                noise_scale=scales[0], length_scale=scales[1], g_ids=self.g_ids, eps=eps,
            )
            # [1, t, n_mel] -> [1, n_mel, t], the ONNX output layout
            return y.transpose(1, 2), y_lengths

    return Generator()


def export_pt2(weights, hp, max_text_length: int, max_frames: int, path: Path,
               speaker: typing.Optional[int] = None) -> None:
    """Trace :func:`generator_graph` on the host and save it to ``path``.
    Each weight gets a storage of its own first (some are views of a
    stacked leaf, which the archive would save whole)."""
    import dataclasses

    import torch

    from .tree import tree_map

    weights = dataclasses.replace(weights, **{
        f.name: tree_map(lambda a: a.detach().to("cpu").clone(), getattr(weights, f.name))
        for f in dataclasses.fields(weights)
    })
    args = (
        torch.zeros((1, max_text_length), dtype=torch.int32),
        torch.ones((1,), dtype=torch.int32),
        torch.tensor([0.0, 1.0], dtype=torch.float32),
        torch.tensor(0, dtype=torch.int32),
    )
    graph = generator_graph(weights, hp, max_frames, speaker)
    with torch.no_grad():
        program = torch.export.export(graph, args, strict=False)
    torch.export.save(program, str(path))


def graph_devices(program) -> typing.Set[str]:
    """The type of every device that an ExportedProgram names: in its
    nodes' arguments and values, and of its weights."""
    import torch

    found = set()

    def visit(a):
        if isinstance(a, torch.device):
            found.add(a.type)
        elif isinstance(a, torch.Tensor):
            found.add(a.device.type)
        elif isinstance(a, (list, tuple)):
            for b in a:
                visit(b)
        elif isinstance(a, dict):
            for b in a.values():
                visit(b)

    for node in program.graph.nodes:
        visit(node.args)
        visit(node.kwargs)
        if isinstance(node.kwargs.get("device"), str):
            found.add(torch.device(node.kwargs["device"]).type)
        visit(node.meta.get("val"))
    visit(dict(program.state_dict))
    visit(dict(program.constants))
    return found


def load_pt2(path: Path, device):
    """A saved ``generator.pt2`` -> (a callable module on ``device``, the
    program): its weights moved there and every device its nodes name set
    to it (``torch.export.passes.move_to_device_pass``)."""
    import torch
    from torch.export.passes import move_to_device_pass

    program = move_to_device_pass(torch.export.load(str(path)), torch.device(device))
    return program.module(), program


def onnx_params(flat: typing.Mapping[str, typing.Any]) -> dict:
    """``model/<path>`` arrays -> the numpy param tree that
    ``onnx.export.export_generator_onnx`` takes, with ``weight_inv``
    beside each InvConvNear weight: the f32 inverse that the live serving
    path computes (see the module doc)."""
    import numpy as np
    import torch

    from .checkpoint import PREFIX
    from .tree import unflatten

    tree = unflatten({k[len(PREFIX):]: np.asarray(v) for k, v in flat.items()})
    inv = tree["decoder"]["blocks"]["invconv"]
    weight = torch.from_numpy(np.asarray(inv["weight"], np.float32))
    inv["weight_inv"] = torch.stack([torch.linalg.inv(w) for w in weight]).numpy()
    return tree


def main(argv=None):
    parser = argparse.ArgumentParser(prog="glow-tts-export-torch")
    parser.add_argument("checkpoint", help="Path to a model checkpoint (.npz or a reference .pth)")
    parser.add_argument("output", help="Directory to write the exported model to")
    parser.add_argument("--config", action="append", help="Path to JSON configuration file(s)")
    parser.add_argument("--num-symbols", type=int)
    parser.add_argument(
        "--format",
        default="pt2",
        choices=FORMATS,
        help="Artifact format (pt2: torch.export program with static budgets, runs on the "
        "CPU or a CUDA card; onnx: opset-12 .onnx with dynamic axes; torch: reference .pth; "
        "savedmodel: TensorFlow, refused)",
    )
    parser.add_argument("--max-text-length", type=int, default=256, help="Static phoneme budget")
    parser.add_argument("--max-frames", type=int, default=2048, help="Static mel frame budget")
    parser.add_argument(
        "--speaker",
        type=int,
        help="Multispeaker models: speaker id to bake into the artifact "
        "(the exported signature has no speaker input; default 0)",
    )
    parser.add_argument(
        "--platform",
        default="cuda",
        choices=("cuda", "cpu"),
        help="Device on which the written .pt2 is loaded back and run once as a check "
        "('cuda': error without a GPU); the graph is traced on the host and runs on both",
    )
    parser.add_argument("--debug", action="store_true", help="Print DEBUG messages to the console")
    args = parser.parse_args(argv)

    logging.basicConfig(level=logging.DEBUG if args.debug else logging.INFO)
    _LOGGER.debug(args)

    if args.format == "savedmodel":
        parser.error(
            "--format savedmodel: a TensorFlow SavedModel needs TensorFlow and jax2tf, which "
            "this package does not use; export pt2, onnx or torch"
        )

    import torch

    if args.platform == "cuda" and not torch.cuda.is_available():
        parser.error("--platform cuda: no CUDA device is available")

    from .checkpoint import params_from_numpy, read_checkpoint, restore_opt_state
    from .config import load_config
    from .models import hyper_from_config, store_inverse
    from .utils.stdio import validate_speaker

    config = load_config(args.config or ())
    if args.num_symbols is not None:
        config.model.num_symbols = args.num_symbols
    if config.model.num_symbols <= 0:
        parser.error("Number of symbols not set (did you forget --config or --num-symbols?)")
    n_speakers = config.model.n_speakers
    speaker = validate_speaker(parser, n_speakers, args.speaker)
    try:
        hp = hyper_from_config(config)
    except ValueError as err:
        parser.error(str(err))

    checkpoint = Path(args.checkpoint)
    output = Path(args.output)
    saved_opt: dict = {}
    try:
        flat, meta = read_checkpoint(
            checkpoint, config, saved_opt if args.format == "torch" else None
        )
        model = params_from_numpy(flat, hp)
    except ValueError as err:
        parser.error(str(err))
    global_step = int(meta.get("global_step", 1))
    _LOGGER.info("Loaded checkpoint from %s (global step=%s)", checkpoint, global_step)
    output.mkdir(parents=True, exist_ok=True)
    start = time.perf_counter()

    if args.format == "torch":
        from .checkpoint import save_torch_checkpoint

        opt = None
        if saved_opt:
            opt, why = restore_opt_state(saved_opt, meta.get("opt_treedef"), model.flat(),
                                         config.scheduler)
            if opt is None:
                _LOGGER.warning("%s: optimizer state not exported (%s)", checkpoint, why)
        save_torch_checkpoint(
            output / TORCH_NAME, flat, config, global_step,
            float(meta.get("learning_rate", 1.0)), int(meta.get("version", 1)), opt,
        )
    elif args.format == "onnx":
        from .onnx.export import export_generator_onnx

        blob = export_generator_onnx(onnx_params(flat), config, speaker=speaker)
        (output / ONNX_NAME).write_bytes(blob)
    else:
        weights = store_inverse(model, hp)
        export_pt2(
            weights, hp, args.max_text_length, args.max_frames, output / ARTIFACT_NAME,
            speaker=speaker if n_speakers > 1 else None,
        )
    _LOGGER.info("Wrote the %s artifact in %.1f second(s)", args.format, time.perf_counter() - start)

    with open(output / "config.json", "w") as config_file:
        config.save(config_file)
    if args.format != "torch":
        with open(output / META_NAME, "w") as meta_file:
            json.dump(
                {
                    "format": args.format,
                    "max_text_length": args.max_text_length,
                    "max_frames": args.max_frames,
                    "global_step": global_step,
                    "speaker": speaker if n_speakers > 1 else None,
                },
                meta_file,
                indent=2,
            )
    if args.format == "pt2":
        check_pt2(output / ARTIFACT_NAME, args.platform, args.max_text_length)
    _LOGGER.info("Exported model (%s) to %s", args.format, output)


def check_pt2(path: Path, platform: str, max_text_length: int) -> None:
    """Load a written ``.pt2`` onto ``platform`` and run it on an
    8-phoneme text at noise 0: one device, a finite mel."""
    import torch

    module, program = load_pt2(path, platform)
    device = torch.device(platform)
    if graph_devices(program) != {device.type}:
        raise RuntimeError(f"{path}: the program names {graph_devices(program)} on {device}")
    n = min(8, max_text_length)
    text = torch.zeros((1, max_text_length), dtype=torch.int32, device=device)
    text[0, :n] = 1
    with torch.no_grad():
        mel, mel_lengths = module(
            text, torch.full((1,), n, dtype=torch.int32, device=device),
            torch.tensor([0.0, 1.0], device=device), torch.tensor(0, dtype=torch.int32, device=device),
        )
    if not bool(torch.isfinite(mel).all()):
        raise RuntimeError(f"{path}: the check run on {device} gave no finite mel")
    _LOGGER.info("Checked %s on %s: mel %s, %s frame(s)", path.name, device,
                 list(mel.shape), int(mel_lengths[0]))


if __name__ == "__main__":
    main()
