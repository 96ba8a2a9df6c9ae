"""The JAX package's ``.npz`` checkpoints, read and written with numpy
alone (``glow_tts_train_tpu/checkpoint.py`` imports jax).

Format: one ``.npz`` whose ``model/<path>`` arrays are the param tree's
leaves (conv weights ``[k, c_in, c_out]``, per-layer/per-block leaves
stacked on a leading axis) and whose ``__meta__`` entry is UTF-8 JSON
(``global_step``, ``learning_rate``, ``version``, and with optimizer state
``opt_treedef``).  The optimizer state is the JAX chain's (clip, Adam,
schedule): ``opt/1/count`` (int32), ``opt/1/mu/<path>`` and
``opt/1/nu/<path>`` (f32), and ``opt/2/count`` where the schedule is Noam
(a constant lr keeps no count); ``opt_treedef`` is the string the JAX
package's ``_opt_fingerprint`` gives for that chain over the same param
tree (:func:`opt_treedef`, built from the param paths).  Both trainers
read each other's state all or nothing: where keys, shapes or the
fingerprint disagree, Adam starts fresh with a warning
(:func:`restore_opt_state`).

The reference PyTorch Glow-TTS's ``.pth`` goes both ways through numpy
mappers (:func:`read_pth`, :func:`save_torch_checkpoint`): its state dict
to and from the ``model/`` arrays, its ``torch.optim.Adam`` state to and
from the ``opt/`` arrays.  :func:`read_checkpoint` takes either format.

Loading for serving is strict (:func:`load_checkpoint`: a missing, extra
or mis-shaped ``model/`` key raises); the train CLI's ``--checkpoint``
merges tolerantly into a fresh init (:func:`merge_into`).
"""

import io
import json
import logging
import typing
from pathlib import Path

import numpy as np
import torch

from .models.glow_tts import GlowTTS, GlowTTSHyper
from .optimize import AdamState
from .tree import flatten, unflatten

_LOGGER = logging.getLogger("glow_tts_train_tpu_torch.checkpoint")

PREFIX = "model/"
OPT_PREFIX = "opt/"
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


def read_npz(
    path: Path, opt: typing.Optional[typing.Dict[str, np.ndarray]] = None
) -> typing.Tuple[typing.Dict[str, np.ndarray], dict]:
    """-> (``model/...`` arrays, meta); ``opt`` receives the optimizer-state
    arrays (``opt/...`` keys, the prefix taken off)."""
    with np.load(path, allow_pickle=False) as data:
        flat = {k: data[k] for k in data.files if k.startswith(PREFIX)}
        meta = json.loads(bytes(data[META_KEY]).decode("utf-8")) if META_KEY in data.files else {}
        if opt is not None:
            opt.update((k[len(OPT_PREFIX):], data[k]) for k in data.files if k.startswith(OPT_PREFIX))
    return flat, meta


def merge_into(
    fresh: typing.Mapping[str, torch.Tensor], saved: typing.Mapping[str, np.ndarray]
) -> typing.Dict[str, torch.Tensor]:
    """Tolerant merge of ``model/<path>`` arrays into fresh params ({"a/b/c":
    tensor}), as the JAX package's ``_merge_into``: a saved value of the
    right shape wins; a missing key or one of another shape keeps its fresh
    value, and a saved key the model does not use is left out, each with a
    warning."""
    merged = {}
    for key, value in fresh.items():
        name = PREFIX + key
        if name not in saved:
            _LOGGER.warning("%s is not in the checkpoint", name)
            merged[key] = value
        elif tuple(saved[name].shape) != tuple(value.shape):
            _LOGGER.warning(
                "checkpoint key %s has shape %s but the model expects %s; keeping fresh-init values",
                name, tuple(saved[name].shape), tuple(value.shape),
            )
            merged[key] = value
        else:
            merged[key] = torch.from_numpy(np.asarray(saved[name], np.float32))
    for name in saved:
        if name.startswith(PREFIX) and name[len(PREFIX):] not in fresh:
            _LOGGER.warning("checkpoint key %s not used by the model", name)
    return merged


def _tree_repr(paths: typing.Iterable[str]) -> str:
    """The nested dict of ``paths`` ("a/b/c") as a jax treedef spells it:
    keys sorted, leaves ``*``."""
    tree: dict = {}
    for path in paths:
        node = tree
        *parents, leaf = path.split("/")
        for part in parents:
            node = node.setdefault(part, {})
        node[leaf] = None

    def spell(node) -> str:
        if node is None:
            return "*"
        return "{" + ", ".join(f"{k!r}: {spell(node[k])}" for k in sorted(node)) + "}"

    return spell(tree)


def opt_treedef(paths: typing.Iterable[str], scheduler: str) -> str:
    """The JAX package's optimizer fingerprint (``_opt_fingerprint``: the
    treedef string of ``optax.chain(clip, scale_by_adam,
    scale_by_learning_rate)``'s state) over the param paths ("a/b/c"):
    the schedule keeps a count for Noam only."""
    tree = _tree_repr(paths)
    schedule = (
        "CustomNode(namedtuple[ScaleByScheduleState], [*])" if scheduler == "noam"
        else "CustomNode(namedtuple[EmptyState], [])"
    )
    return (
        "PyTreeDef((CustomNode(namedtuple[EmptyState], []), "
        f"CustomNode(namedtuple[ScaleByAdamState], [*, {tree}, {tree}]), {schedule}))"
    )


def opt_state_arrays(opt: AdamState, scheduler: str) -> typing.Dict[str, np.ndarray]:
    """``opt/...`` arrays of an Adam state as the JAX chain's leaves: the
    counts int32, the moments f32."""
    count = np.asarray(opt.count, np.int32)
    arrays = {OPT_PREFIX + "1/count": count}
    for moment, values in (("mu", opt.mu), ("nu", opt.nu)):
        for key, value in values.items():
            arrays[f"{OPT_PREFIX}1/{moment}/{key}"] = value.detach().to("cpu", torch.float32).numpy()
    if scheduler == "noam":
        arrays[OPT_PREFIX + "2/count"] = count.copy()
    return arrays


def restore_opt_state(
    saved: typing.Mapping[str, np.ndarray],
    fingerprint: typing.Optional[str],
    params: typing.Mapping[str, torch.Tensor],
    scheduler: str,
) -> typing.Tuple[typing.Optional[AdamState], str]:
    """Adam state from ``opt/`` arrays (``saved``, prefix taken off) for
    ``params`` ({"a/b/c": tensor}), all or nothing as the JAX package's
    ``_restore_opt_state``: -> (the state on the params' devices, "") or
    (None, why it was not taken) where the fingerprint, the keys, a shape
    or the counts disagree."""
    if fingerprint != opt_treedef(params, scheduler):
        return None, "optimizer structure differs" if fingerprint else "no opt_treedef"
    counts = ["1/count"] + (["2/count"] if scheduler == "noam" else [])
    moments = {f"1/{m}/{k}": (m, k) for m in ("mu", "nu") for k in params}
    if set(saved) != set(counts) | set(moments):
        return None, "optimizer state keys do not match"
    if any(tuple(saved[name].shape) != tuple(params[k].shape) for name, (_, k) in moments.items()):
        return None, "optimizer leaf shape mismatch"
    values = {int(np.asarray(saved[name]).reshape(())) for name in counts}
    if len(values) != 1:
        return None, f"optimizer counts differ: {sorted(values)}"
    state = AdamState({}, {}, values.pop())
    for name, (moment, key) in moments.items():
        getattr(state, moment)[key] = torch.from_numpy(
            np.asarray(saved[name], np.float32).copy()
        ).to(params[key].device)
    return state, ""


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
    """Load a JAX ``.npz`` checkpoint or a reference ``.pth`` -> (model,
    meta), strictly (:func:`params_from_numpy`)."""
    flat, meta = read_checkpoint(path, hp)
    return params_from_numpy(flat, hp), meta


def save_checkpoint(
    params: typing.Mapping[str, torch.Tensor],
    path: Path,
    global_step: int,
    learning_rate: float,
    version: int = 1,
    opt: typing.Optional[AdamState] = None,
    scheduler: str = "noam",
) -> None:
    """Write ``{"a/b/c": tensor}`` params as a JAX ``.npz`` checkpoint
    (``model/<path>`` f32 arrays and the ``__meta__`` JSON), readable by
    the JAX ``load_checkpoint`` and both infer CLIs; with ``opt``, its Adam
    state as the JAX chain's ``opt/`` leaves for ``scheduler``, and the
    chain's ``opt_treedef``."""
    flat = {
        PREFIX + k: v.detach().to("cpu", torch.float32).numpy() for k, v in params.items()
    }
    meta = {"global_step": int(global_step), "learning_rate": float(learning_rate),
            "version": int(version)}
    if opt is not None:
        flat.update(opt_state_arrays(opt, scheduler))
        meta["opt_treedef"] = opt_treedef(params, scheduler)
    Path(path).parent.mkdir(parents=True, exist_ok=True)
    save_npz(path, flat, meta)


# ---------------------------------------------------------------------------
# The reference PyTorch Glow-TTS's ``.pth`` (a torch pickle of ``{model,
# global_step, learning_rate, version, optimizer}``, ``model`` the
# FlowGenerator's state dict), both ways, as numpy mappers over the
# ``model/<path>`` arrays (``glow_tts_train_tpu/checkpoint.py:386-900``):
# conv weights [out, in, k] <-> [k, in, out], weight norm's g [out, 1, 1]
# <-> [out], ActNorm's [1, c, 1] <-> [c], per-layer module lists <->
# leaves stacked on a leading axis.  ``config`` is a TrainingConfig (or,
# for the weights alone, the GlowTTSHyper of one: the same model fields).
# ---------------------------------------------------------------------------


def _model_fields(config):
    return getattr(config, "model", config)


def _t(a) -> np.ndarray:
    """A state-dict tensor as its own numpy copy."""
    return np.array(a.detach().to("cpu").numpy(), copy=True)


def _conv_w(a) -> np.ndarray:
    """torch conv weight [out, in, k] -> ours [k, in, out]."""
    return _t(a).transpose(2, 1, 0)


def _wn_conv(sd, prefix: str) -> dict:
    return {
        "v": _conv_w(sd[prefix + ".weight_v"]),
        "g": _t(sd[prefix + ".weight_g"]).reshape(-1),
        "b": _t(sd[prefix + ".bias"]),
    }


def _plain_conv(sd, prefix: str) -> dict:
    return {"w": _conv_w(sd[prefix + ".weight"]), "b": _t(sd[prefix + ".bias"])}


def _norm(sd, prefix: str) -> dict:
    return {"gamma": _t(sd[prefix + ".gamma"]), "beta": _t(sd[prefix + ".beta"])}


def _stack(dicts: typing.List[dict]) -> dict:
    if isinstance(dicts[0], dict):
        return {k: _stack([d[k] for d in dicts]) for k in dicts[0]}
    return np.stack(dicts)


def import_torch_state_dict(sd: typing.Mapping, config) -> typing.Dict[str, np.ndarray]:
    """A reference FlowGenerator state dict -> ``model/<path>`` arrays."""
    m = _model_fields(config)
    n_wn = m.n_block_layers
    params: dict = {"emb": _t(sd["encoder.emb.weight"])}
    if m.prenet:
        params["prenet"] = {
            "layers": _stack([
                {"conv": _plain_conv(sd, f"encoder.pre.conv_layers.{i}"),
                 "norm": _norm(sd, f"encoder.pre.norm_layers.{i}")}
                for i in range(3)
            ]),
            "proj": _plain_conv(sd, "encoder.pre.proj"),
        }
    layers = []
    for i in range(m.n_layers_enc):
        p = f"encoder.encoder.attn_layers.{i}"
        attn = {name: _plain_conv(sd, f"{p}.conv_{name}") for name in ("q", "k", "v", "o")}
        if m.window_size is not None:  # the reference registers these only then
            attn["emb_rel_k"] = _t(sd[p + ".emb_rel_k"])
            attn["emb_rel_v"] = _t(sd[p + ".emb_rel_v"])
        layers.append({
            "attn": attn,
            "norm_1": _norm(sd, f"encoder.encoder.norm_layers_1.{i}"),
            "ffn": {
                "conv_1": _plain_conv(sd, f"encoder.encoder.ffn_layers.{i}.conv_1"),
                "conv_2": _plain_conv(sd, f"encoder.encoder.ffn_layers.{i}.conv_2"),
            },
            "norm_2": _norm(sd, f"encoder.encoder.norm_layers_2.{i}"),
        })
    params["encoder"] = _stack(layers)
    params["proj_m"] = _plain_conv(sd, "encoder.proj_m")
    if not m.mean_only:
        params["proj_s"] = _plain_conv(sd, "encoder.proj_s")
    params["proj_w"] = {
        "conv_1": _plain_conv(sd, "encoder.proj_w.conv_1"),
        "norm_1": _norm(sd, "encoder.proj_w.norm_1"),
        "conv_2": _plain_conv(sd, "encoder.proj_w.conv_2"),
        "norm_2": _norm(sd, "encoder.proj_w.norm_2"),
        "proj": _plain_conv(sd, "encoder.proj_w.proj"),
    }
    blocks = []
    for b in range(m.n_blocks_dec):
        base, cpl = f"decoder.flows.{3 * b}", f"decoder.flows.{3 * b + 2}"
        wn = {
            "in_layers": _stack([_wn_conv(sd, f"{cpl}.wn.in_layers.{j}") for j in range(n_wn)]),
            "res_skip_last": _wn_conv(sd, f"{cpl}.wn.res_skip_layers.{n_wn - 1}"),
        }
        if n_wn > 1:
            wn["res_skip"] = _stack(
                [_wn_conv(sd, f"{cpl}.wn.res_skip_layers.{j}") for j in range(n_wn - 1)]
            )
        if m.gin_channels != 0 and f"{cpl}.wn.cond_layer.weight_v" in sd:
            wn["cond"] = _wn_conv(sd, f"{cpl}.wn.cond_layer")
        blocks.append({
            "actnorm": {"bias": _t(sd[base + ".bias"]).reshape(-1),
                        "logs": _t(sd[base + ".logs"]).reshape(-1)},
            "invconv": {"weight": _t(sd[f"decoder.flows.{3 * b + 1}.weight"])},
            "coupling": {"start": _wn_conv(sd, f"{cpl}.start"),
                         "end": _plain_conv(sd, f"{cpl}.end"), "wn": wn},
        })
    params["decoder"] = {"blocks": _stack(blocks)}
    if m.n_speakers > 1 and "emb_g.weight" in sd:
        params["emb_g"] = _t(sd["emb_g.weight"])
    return flatten(params, PREFIX)


def import_torch_opt_state(
    opt_sd: typing.Mapping, model_sd: typing.Mapping, config
) -> typing.Dict[str, np.ndarray]:
    """A reference ``torch.optim.Adam`` state dict -> ``opt/`` arrays (the
    prefix taken off) of the JAX chain for ``config.scheduler``, for
    :func:`restore_opt_state`; {} with a warning where it cannot be
    mapped.  Its state is keyed by the parameters' registration order,
    which for the reference model is the state dict's key order, and its
    moments share the weights' layout, so the weights' mapping applies."""
    try:
        state = opt_sd["state"]
        names = list(model_sd.keys())
        if not state or len(state) != len(names):
            raise ValueError(f"optimizer covers {len(state)} of {len(names)} parameters")
        by_name = {names[i]: s for i, s in state.items()}
        for name, s in by_name.items():
            got, want = tuple(s["exp_avg"].shape), tuple(model_sd[name].shape)
            if got != want:
                raise ValueError(
                    f"Adam moment shape {got} does not match parameter {name!r} shape "
                    f"{want}: registration order mismatch"
                )
        steps = {int(s["step"]) for s in by_name.values()}
        if len(steps) != 1:
            raise ValueError(f"per-parameter steps diverge: {sorted(steps)}")
        count = np.asarray(steps.pop(), np.int32)
        arrays = {"1/count": count}
        for moment, key in (("mu", "exp_avg"), ("nu", "exp_avg_sq")):
            mapped = import_torch_state_dict({n: s[key] for n, s in by_name.items()}, config)
            arrays.update((f"1/{moment}/{k[len(PREFIX):]}", v) for k, v in mapped.items())
        if config.scheduler == "noam":
            arrays["2/count"] = count.copy()
        _LOGGER.info("imported torch Adam state (%s parameters, step=%s)", len(names), int(count))
        return arrays
    except (KeyError, ValueError, TypeError, IndexError) as exc:
        _LOGGER.warning(
            "could not import torch optimizer state (%s); Adam restarts fresh", exc
        )
        return {}


def read_pth(
    path: Path, config, opt: typing.Optional[typing.Dict[str, np.ndarray]] = None
) -> typing.Tuple[typing.Dict[str, np.ndarray], dict]:
    """A reference ``.pth`` -> (``model/...`` arrays, meta), as
    :func:`read_npz`; ``opt`` receives its Adam state as ``opt/`` arrays
    and the meta their ``opt_treedef``, where it maps (``config`` a
    TrainingConfig then)."""
    ckpt = torch.load(path, map_location="cpu", weights_only=True)
    sd = ckpt["model"] if "model" in ckpt else ckpt
    flat = import_torch_state_dict(sd, config)
    meta = {
        "global_step": int(ckpt.get("global_step", 1)),
        "learning_rate": float(ckpt.get("learning_rate", 1.0)),
        "version": int(ckpt.get("version", 1)),
    }
    if opt is not None and isinstance(ckpt.get("optimizer"), dict):
        arrays = import_torch_opt_state(ckpt["optimizer"], sd, config)
        if arrays:
            opt.update(arrays)
            meta["opt_treedef"] = opt_treedef(
                (k[len(PREFIX):] for k in flat), config.scheduler
            )
    return flat, meta


def read_checkpoint(
    path: Path, config, opt: typing.Optional[typing.Dict[str, np.ndarray]] = None
) -> typing.Tuple[typing.Dict[str, np.ndarray], dict]:
    """:func:`read_npz` or :func:`read_pth` by the suffix."""
    path = Path(path)
    if path.suffix == ".pth":
        return read_pth(path, config, opt)
    if path.suffix != ".npz":
        raise ValueError(f"{path}: a checkpoint is a .npz or a reference .pth")
    return read_npz(path, opt)


def _np(a) -> np.ndarray:
    if isinstance(a, torch.Tensor):
        a = a.detach().to("cpu").numpy()
    return np.asarray(a, dtype=np.float32)


def _conv_w_inv(a) -> np.ndarray:
    """ours [k, in, out] -> torch conv weight [out, in, k]."""
    return _np(a).transpose(2, 1, 0)


def _emit_plain_conv(out: dict, prefix: str, conv: dict) -> None:
    out[prefix + ".weight"] = _conv_w_inv(conv["w"])
    out[prefix + ".bias"] = _np(conv["b"])


def _emit_wn_conv(out: dict, prefix: str, conv: dict) -> None:
    out[prefix + ".weight_v"] = _conv_w_inv(conv["v"])
    out[prefix + ".weight_g"] = _np(conv["g"]).reshape(-1, 1, 1)
    out[prefix + ".bias"] = _np(conv["b"])


def _emit_norm(out: dict, prefix: str, norm: dict) -> None:
    out[prefix + ".gamma"] = _np(norm["gamma"])
    out[prefix + ".beta"] = _np(norm["beta"])


def _unstack(stacked: dict, i: int) -> dict:
    return {k: _unstack(v, i) if isinstance(v, dict) else v[i] for k, v in stacked.items()}


def export_torch_state_dict(
    params: typing.Mapping[str, typing.Any], config
) -> typing.Dict[str, np.ndarray]:
    """``model/<path>`` arrays (or tensors) -> a reference FlowGenerator
    state dict of f32 numpy arrays in the reference's registration order:
    the exact inverse of :func:`import_torch_state_dict`.  ``weight_inv``,
    a derived cache, is not a reference parameter and is left out."""
    m = _model_fields(config)
    p = unflatten({k[len(PREFIX):]: v for k, v in params.items() if k.startswith(PREFIX)})
    sd: typing.Dict[str, np.ndarray] = {"encoder.emb.weight": _np(p["emb"])}
    if m.prenet and "prenet" in p:
        pre = p["prenet"]
        for i in range(len(pre["layers"]["conv"]["w"])):
            layer = _unstack(pre["layers"], i)
            _emit_plain_conv(sd, f"encoder.pre.conv_layers.{i}", layer["conv"])
            _emit_norm(sd, f"encoder.pre.norm_layers.{i}", layer["norm"])
        _emit_plain_conv(sd, "encoder.pre.proj", pre["proj"])
    for i in range(m.n_layers_enc):
        layer = _unstack(p["encoder"], i)
        at, q = layer["attn"], f"encoder.encoder.attn_layers.{i}"
        for name in ("q", "k", "v", "o"):
            _emit_plain_conv(sd, f"{q}.conv_{name}", at[name])
        if m.window_size is not None:
            sd[q + ".emb_rel_k"] = _np(at["emb_rel_k"])
            sd[q + ".emb_rel_v"] = _np(at["emb_rel_v"])
        _emit_norm(sd, f"encoder.encoder.norm_layers_1.{i}", layer["norm_1"])
        _emit_plain_conv(sd, f"encoder.encoder.ffn_layers.{i}.conv_1", layer["ffn"]["conv_1"])
        _emit_plain_conv(sd, f"encoder.encoder.ffn_layers.{i}.conv_2", layer["ffn"]["conv_2"])
        _emit_norm(sd, f"encoder.encoder.norm_layers_2.{i}", layer["norm_2"])
    _emit_plain_conv(sd, "encoder.proj_m", p["proj_m"])
    if not m.mean_only and "proj_s" in p:
        _emit_plain_conv(sd, "encoder.proj_s", p["proj_s"])
    dp = p["proj_w"]
    _emit_plain_conv(sd, "encoder.proj_w.conv_1", dp["conv_1"])
    _emit_norm(sd, "encoder.proj_w.norm_1", dp["norm_1"])
    _emit_plain_conv(sd, "encoder.proj_w.conv_2", dp["conv_2"])
    _emit_norm(sd, "encoder.proj_w.norm_2", dp["norm_2"])
    _emit_plain_conv(sd, "encoder.proj_w.proj", dp["proj"])
    n_wn = m.n_block_layers
    for b in range(m.n_blocks_dec):
        blk = _unstack(p["decoder"]["blocks"], b)
        base, cpl = f"decoder.flows.{3 * b}", f"decoder.flows.{3 * b + 2}"
        sd[base + ".bias"] = _np(blk["actnorm"]["bias"]).reshape(1, -1, 1)
        sd[base + ".logs"] = _np(blk["actnorm"]["logs"]).reshape(1, -1, 1)
        sd[f"decoder.flows.{3 * b + 1}.weight"] = _np(blk["invconv"]["weight"])
        _emit_wn_conv(sd, f"{cpl}.start", blk["coupling"]["start"])
        _emit_plain_conv(sd, f"{cpl}.end", blk["coupling"]["end"])
        wn = blk["coupling"]["wn"]
        for j in range(n_wn):
            _emit_wn_conv(sd, f"{cpl}.wn.in_layers.{j}", _unstack(wn["in_layers"], j))
        for j in range(n_wn - 1):
            _emit_wn_conv(sd, f"{cpl}.wn.res_skip_layers.{j}", _unstack(wn["res_skip"], j))
        _emit_wn_conv(sd, f"{cpl}.wn.res_skip_layers.{n_wn - 1}", wn["res_skip_last"])
        if "cond" in wn:
            _emit_wn_conv(sd, f"{cpl}.wn.cond_layer", wn["cond"])
    if m.n_speakers > 1 and "emb_g" in p:
        sd["emb_g.weight"] = _np(p["emb_g"])
    # the reference's registration order: torch state dicts keep insertion
    # order, and Adam's state indices refer to it
    order = [n for n in reference_param_order(config) if n in sd]
    if len(order) != len(sd):
        raise ValueError(f"keys outside the reference model: {sorted(set(sd) - set(order))}")
    return {k: sd[k] for k in order}


def reference_param_order(config) -> typing.List[str]:
    """The reference FlowGenerator's parameter names in registration order
    (its state dict's key order and ``model.parameters()``'s, which
    ``torch.optim.Adam``'s state indices refer to): encoder (emb, pre,
    encoder's four module lists in attribute order, each attention's
    emb_rel_k/v before its convs, proj_m, proj_s, proj_w), decoder (per
    block ActNorm logs then bias, the mix, the coupling: a weight-normed
    conv as bias, weight_g, weight_v), emb_g."""
    m = _model_fields(config)
    names: typing.List[str] = ["encoder.emb.weight"]

    def plain(prefix):
        return [prefix + ".weight", prefix + ".bias"]

    def normed(prefix):
        return [prefix + ".gamma", prefix + ".beta"]

    def wn_conv(prefix):
        return [prefix + ".bias", prefix + ".weight_g", prefix + ".weight_v"]

    if m.prenet:
        for i in range(3):
            names += plain(f"encoder.pre.conv_layers.{i}")
        for i in range(3):
            names += normed(f"encoder.pre.norm_layers.{i}")
        names += plain("encoder.pre.proj")
    for i in range(m.n_layers_enc):
        p = f"encoder.encoder.attn_layers.{i}"
        if m.window_size is not None:
            names += [p + ".emb_rel_k", p + ".emb_rel_v"]
        for c in ("conv_q", "conv_k", "conv_v", "conv_o"):
            names += plain(f"{p}.{c}")
    for i in range(m.n_layers_enc):
        names += normed(f"encoder.encoder.norm_layers_1.{i}")
    for i in range(m.n_layers_enc):
        names += plain(f"encoder.encoder.ffn_layers.{i}.conv_1")
        names += plain(f"encoder.encoder.ffn_layers.{i}.conv_2")
    for i in range(m.n_layers_enc):
        names += normed(f"encoder.encoder.norm_layers_2.{i}")
    names += plain("encoder.proj_m")
    if not m.mean_only:
        names += plain("encoder.proj_s")
    names += plain("encoder.proj_w.conv_1")
    names += normed("encoder.proj_w.norm_1")
    names += plain("encoder.proj_w.conv_2")
    names += normed("encoder.proj_w.norm_2")
    names += plain("encoder.proj_w.proj")
    for b in range(m.n_blocks_dec):
        names += [f"decoder.flows.{3 * b}.logs", f"decoder.flows.{3 * b}.bias"]
        names += [f"decoder.flows.{3 * b + 1}.weight"]
        cpl = f"decoder.flows.{3 * b + 2}"
        names += wn_conv(f"{cpl}.start")
        names += plain(f"{cpl}.end")
        for j in range(m.n_block_layers):
            names += wn_conv(f"{cpl}.wn.in_layers.{j}")
        for j in range(m.n_block_layers):
            names += wn_conv(f"{cpl}.wn.res_skip_layers.{j}")
        if m.gin_channels != 0:
            names += wn_conv(f"{cpl}.wn.cond_layer")
    if m.n_speakers > 1:
        names.append("emb_g.weight")
    return names


def export_torch_opt_state(opt: typing.Optional[AdamState], config, learning_rate: float) -> dict:
    """An Adam state -> the ``torch.optim.Adam`` state dict the reference
    resumes from (the inverse of :func:`import_torch_opt_state`).  No state,
    or one at count 0, gives the valid empty state dict of an Adam that
    never stepped (the reference loads the optimizer unconditionally)."""
    order = reference_param_order(config)
    groups = [{
        "lr": float(learning_rate), "betas": tuple(config.betas), "eps": float(config.eps),
        "weight_decay": 0, "amsgrad": False, "maximize": False, "foreach": None,
        "capturable": False, "differentiable": False, "fused": None,
        "params": list(range(len(order))),
    }]
    if opt is None or int(opt.count) == 0:
        return {"state": {}, "param_groups": groups}
    mu = export_torch_state_dict({PREFIX + k: v for k, v in opt.mu.items()}, config)
    nu = export_torch_state_dict({PREFIX + k: v for k, v in opt.nu.items()}, config)
    step = torch.tensor(float(opt.count))
    state = {
        i: {"step": step.clone(),
            "exp_avg": torch.from_numpy(np.ascontiguousarray(mu[name])),
            "exp_avg_sq": torch.from_numpy(np.ascontiguousarray(nu[name]))}
        for i, name in enumerate(order)
    }
    return {"state": state, "param_groups": groups}


def save_torch_checkpoint(
    path: Path,
    params: typing.Mapping[str, typing.Any],
    config,
    global_step: int,
    learning_rate: float,
    version: int = 1,
    opt: typing.Optional[AdamState] = None,
) -> None:
    """Write ``model/<path>`` arrays as a reference ``.pth``: the weights as
    the state dict :func:`export_torch_state_dict` gives, with the Adam
    state of :func:`export_torch_opt_state`."""
    sd = {
        k: torch.from_numpy(np.ascontiguousarray(v))
        for k, v in export_torch_state_dict(params, config).items()
    }
    torch.save(
        {
            "model": sd,
            "global_step": int(global_step),
            "learning_rate": float(learning_rate),
            "version": int(version),
            "optimizer": export_torch_opt_state(opt, config, learning_rate),
        },
        path,
    )
