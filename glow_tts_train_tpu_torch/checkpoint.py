"""The JAX package's ``.npz`` checkpoints, read and written with numpy
alone (``glow_tts_train_tpu/checkpoint.py`` imports jax).

Format: one ``.npz`` whose ``model/<path>`` arrays are the param tree's
leaves (conv weights ``[k, c_in, c_out]``, per-layer/per-block leaves
stacked on a leading axis) and whose ``__meta__`` entry is UTF-8 JSON
(``global_step``, ``learning_rate``, ``version``).  Optimizer leaves
(``opt/...``) are neither read nor written: the JAX package guards them
with a jax treedef string, so a checkpoint of the port holds params only,
and both trainers start Adam fresh from it (the port's train CLI warns,
counting the ``opt/`` keys it drops: :func:`read_npz`'s ``dropped``).

Loading is strict: a missing, extra or mis-shaped ``model/`` key raises.
"""

import io
import json
import typing
from pathlib import Path

import numpy as np
import torch

from .models.glow_tts import GlowTTS, GlowTTSHyper

PREFIX = "model/"
META_KEY = "__meta__"

Shapes = typing.Dict[str, typing.Tuple[int, ...]]


def param_shapes(hp: GlowTTSHyper) -> Shapes:
    """``model/<path>`` -> shape of every param leaf, as the JAX
    ``init_model`` lays them out."""
    h, hd = hp.h_enc, hp.h_dec
    L, K = hp.n_layers_enc, hp.kernel_size
    f, fdp, out = hp.filter_channels, hp.filter_channels_dp, hp.out_channels
    nb, nl, kd = hp.n_blocks_dec, hp.n_block_layers, hp.kernel_size_dec
    c = out * hp.n_sqz
    gin = hp.gin_channels
    s: Shapes = {"emb": (hp.n_vocab, h)}

    def conv(path, k, c_in, c_out, lead=()):
        s[f"{path}/w"] = (*lead, k, c_in, c_out)
        s[f"{path}/b"] = (*lead, c_out)

    def wn_conv(path, k, c_in, c_out, lead=()):
        s[f"{path}/v"] = (*lead, k, c_in, c_out)
        s[f"{path}/g"] = (*lead, c_out)
        s[f"{path}/b"] = (*lead, c_out)

    def norm(path, n, lead=()):
        s[f"{path}/gamma"] = (*lead, n)
        s[f"{path}/beta"] = (*lead, n)

    for name in ("q", "k", "v", "o"):
        conv(f"encoder/attn/{name}", 1, h, h, (L,))
    if hp.window_size is not None:
        for name in ("emb_rel_k", "emb_rel_v"):
            s[f"encoder/attn/{name}"] = (L, 1, 2 * hp.window_size + 1, h // hp.n_heads)
    norm("encoder/norm_1", h, (L,))
    conv("encoder/ffn/conv_1", K, h, f, (L,))
    conv("encoder/ffn/conv_2", K, f, h, (L,))
    norm("encoder/norm_2", h, (L,))
    conv("proj_m", 1, h, out)
    conv("proj_w/conv_1", K, h + gin, fdp)
    norm("proj_w/norm_1", fdp)
    conv("proj_w/conv_2", K, fdp, fdp)
    norm("proj_w/norm_2", fdp)
    conv("proj_w/proj", 1, fdp, 1)

    blk = "decoder/blocks"
    s[f"{blk}/actnorm/logs"] = (nb, c)
    s[f"{blk}/actnorm/bias"] = (nb, c)
    s[f"{blk}/invconv/weight"] = (nb, hp.n_split, hp.n_split)
    wn_conv(f"{blk}/coupling/start", 1, c // 2, hd, (nb,))
    conv(f"{blk}/coupling/end", 1, hd, c, (nb,))
    wn_conv(f"{blk}/coupling/wn/in_layers", kd, hd, 2 * hd, (nb, nl))
    if nl > 1:
        wn_conv(f"{blk}/coupling/wn/res_skip", 1, hd, 2 * hd, (nb, nl - 1))
    wn_conv(f"{blk}/coupling/wn/res_skip_last", 1, hd, hd, (nb,))
    if gin:
        wn_conv(f"{blk}/coupling/wn/cond", 1, gin, 2 * hd * nl, (nb,))

    if hp.prenet:
        conv("prenet/layers/conv", 5, h, h, (3,))
        norm("prenet/layers/norm", h, (3,))
        conv("prenet/proj", 1, h, h)
    if not hp.mean_only:
        conv("proj_s", 1, h, out)
    if hp.n_speakers > 1:
        s["emb_g"] = (hp.n_speakers, gin)
    return {PREFIX + k: v for k, v in s.items()}


def random_params(hp: GlowTTSHyper, seed: int) -> typing.Dict[str, np.ndarray]:
    """Random fp32 weights for every key of :func:`param_shapes`, all
    non-zero (a zero coupling ``end`` or prenet ``proj``, as the JAX init
    sets them, would hide the WN stack and the prenet from any output),
    scaled so 12 inverse flow blocks keep a mel O(1) and finite."""
    rng = np.random.default_rng(seed)
    out = {}
    for key, shape in param_shapes(hp).items():
        if key.endswith("invconv/weight"):
            mats = []
            for _ in range(shape[0]):
                q, _ = np.linalg.qr(rng.standard_normal(shape[1:]))
                if np.linalg.det(q) < 0:
                    q[:, 0] *= -1.0
                mats.append(q)
            a = np.stack(mats)
        elif key == PREFIX + "emb" or "emb_rel" in key:
            a = rng.standard_normal(shape) * shape[-1] ** -0.5
        elif key.endswith("emb_g"):
            a = rng.uniform(-0.1, 0.1, shape)
        elif "/actnorm/" in key:
            a = rng.normal(0.0, 0.1, shape)
        elif "/coupling/end/" in key:
            a = rng.normal(0.0, 0.02, shape)
        elif key.endswith("/v"):
            a = rng.standard_normal(shape)
        elif key.endswith("/g"):
            a = rng.uniform(0.5, 1.0, shape)
        elif key.endswith("/gamma"):
            a = 1.0 + rng.normal(0.0, 0.1, shape)
        elif key.endswith("/beta"):
            a = rng.normal(0.0, 0.1, shape)
        elif key.endswith("/w"):
            bound = (shape[-3] * shape[-2]) ** -0.5
            a = rng.uniform(-bound, bound, shape)
        else:  # conv biases
            a = rng.uniform(-0.1, 0.1, shape)
        out[key] = a.astype(np.float32)
    return out


def save_npz(
    path: Path, params: typing.Mapping[str, np.ndarray], meta: typing.Optional[dict] = None
) -> None:
    """Write ``model/...`` arrays and ``__meta__`` as the JAX package does."""
    meta = dict({"global_step": 1, "learning_rate": 1.0, "version": 1}, **(meta or {}))
    arrays = dict(params)
    arrays[META_KEY] = np.frombuffer(json.dumps(meta).encode("utf-8"), dtype=np.uint8)
    buf = io.BytesIO()
    np.savez(buf, **arrays)
    Path(path).write_bytes(buf.getvalue())


OPT_PREFIX = "opt/"


def read_npz(
    path: Path, dropped: typing.Optional[typing.List[str]] = None
) -> typing.Tuple[typing.Dict[str, np.ndarray], dict]:
    """-> (``model/...`` arrays, meta); ``dropped`` receives the names of
    the optimizer-state keys (``opt/...``) that were not read."""
    with np.load(path, allow_pickle=False) as data:
        flat = {k: data[k] for k in data.files if k.startswith(PREFIX)}
        meta = json.loads(bytes(data[META_KEY]).decode("utf-8")) if META_KEY in data.files else {}
        if dropped is not None:
            dropped.extend(k for k in data.files if k.startswith(OPT_PREFIX))
    return flat, meta


def params_from_numpy(flat: typing.Mapping[str, np.ndarray], hp: GlowTTSHyper) -> GlowTTS:
    """The weight bridge: copy ``model/<path>`` arrays key for key into a
    :class:`GlowTTS` whose parameter ``a.b.c`` is the JAX ``a/b/c``."""
    shapes = param_shapes(hp)
    missing = sorted(set(shapes) - set(flat))
    extra = sorted(set(flat) - set(shapes))
    if missing or extra:
        raise ValueError(
            f"checkpoint does not match the config: missing {missing}, "
            f"unexpected {extra}"
        )
    for key, shape in shapes.items():
        if tuple(flat[key].shape) != shape:
            raise ValueError(
                f"{key}: checkpoint shape {tuple(flat[key].shape)}, config expects {shape}"
            )
    model = GlowTTS({k[len(PREFIX):]: v for k, v in shapes.items()})
    params = dict(model.named_parameters())
    with torch.no_grad():
        for key in shapes:
            params[key[len(PREFIX):].replace("/", ".")].copy_(
                torch.from_numpy(np.asarray(flat[key], np.float32))
            )
    return model


def load_checkpoint(path: Path, hp: GlowTTSHyper) -> typing.Tuple[GlowTTS, dict]:
    """Load a JAX ``.npz`` checkpoint -> (model, meta)."""
    path = Path(path)
    if path.suffix != ".npz":
        raise ValueError(f"{path}: only .npz checkpoints load in this package")
    flat, meta = read_npz(path)
    return params_from_numpy(flat, hp), meta


def save_checkpoint(
    params: typing.Mapping[str, torch.Tensor],
    path: Path,
    global_step: int,
    learning_rate: float,
    version: int = 1,
) -> None:
    """Write ``{"a/b/c": tensor}`` params as a JAX ``.npz`` checkpoint
    (``model/<path>`` f32 arrays and the ``__meta__`` JSON), readable by
    the JAX ``load_checkpoint`` and both infer CLIs."""
    flat = {
        PREFIX + k: v.detach().to("cpu", torch.float32).numpy() for k, v in params.items()
    }
    Path(path).parent.mkdir(parents=True, exist_ok=True)
    save_npz(
        path, flat,
        {"global_step": int(global_step), "learning_rate": float(learning_rate),
         "version": int(version)},
    )
