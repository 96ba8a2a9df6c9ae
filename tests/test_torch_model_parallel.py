"""Tensor parallelism in glow_tts_train_tpu_torch (``--model-parallel M``)
on the CPU, over gloo: four ranks as a (2, 2) grid, each a process of
``tests/torch_parallel_worker.py`` (torch, numpy and the port only;
rendezvous through a ``file://`` in the test's directory), against the
port's 4-rank data-parallel run in the same launch and against the JAX
package's (2, 2) mesh (conftest's virtual CPU devices).

One module-scoped launch runs every job of (b)-(e):

* (a) the partition plan (``parallel.partitioning``) against JAX's
  ``shardable(param_partition_specs(...))`` key by key, on the tiny and
  the base param trees, M 2, 3 and 4 (M 3 downgrades the leaves of width
  80, 160 and 256 at base);
* (b) 3 steps under (W 4, M 2) against 4-rank data-parallel steps from the
  same params, dropout on, ``grad_accum_steps`` 2: params, metrics and
  the gathered moments bit for bit, the launch counts equal;
* (c) 3 steps under (W 4, M 2) against JAX ``make_train_step(config,
  mesh=default_mesh(devices[:4], model_parallel=2), state=)`` within
  ``test_two_rank_trajectory_matches_jax_mesh``'s tolerances;
* (d) each rank's moments: its slice of a sharded leaf, bit for bit, the
  whole leaf elsewhere;
* (e) a checkpoint written under M 2 after step 1 resumes under M 1 and
  M 2 with the bits of the uninterrupted run, and the JAX loader takes
  its Adam state;
* (f) the train CLI under ``torch.distributed.run --nproc-per-node 2
  --model-parallel 2`` against the same launch without the flag, bit for
  bit, its checkpoint resumed by one process, and the refusals (exit 2
  before any rendezvous).
"""

import json
import logging
import subprocess
import sys
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.experimental.compilation_cache import compilation_cache as jax_cache
from jax.sharding import Mesh

from glow_tts_train_tpu import checkpoint as jax_checkpoint
from glow_tts_train_tpu import training as jax_training
from glow_tts_train_tpu.config import TrainingConfig
from glow_tts_train_tpu.models import glow_tts as jax_model
from glow_tts_train_tpu.optimize import make_optimizer
from glow_tts_train_tpu.parallel import default_mesh, shard_batch
from glow_tts_train_tpu.parallel.partitioning import param_partition_specs, shardable
from glow_tts_train_tpu_torch import checkpoint, parallel
from glow_tts_train_tpu_torch import __main__ as train_cli
from glow_tts_train_tpu_torch.config import load_config
from glow_tts_train_tpu_torch.models import glow_tts as model
from glow_tts_train_tpu_torch.optimize import current_lr
from glow_tts_train_tpu_torch.parallel import partitioning

from helpers import random_batch, tiny_config
from test_torch_parallel import (
    LR_TRAJECTORY,
    _cli_args,
    _config,
    _flat,
    _port_params,
    _run,
    _write_batches,
    _write_config,
    _write_params,
)
from test_torch_train import _env, corpus  # noqa: F401  (corpus: a fixture)
from torch_parallel_worker import METRICS, run_ranks

WORLD, M = 4, 2
B = 8  # the global batch; 2 rows a rank
REPO = Path(__file__).resolve().parent.parent


def _nested_flat(tree, prefix=""):
    """{"a/b/c": leaf} of a nested dict."""
    out = {}
    for k, v in tree.items():
        if isinstance(v, dict):
            out.update(_nested_flat(v, f"{prefix}{k}/"))
        else:
            out[f"{prefix}{k}"] = v
    return out


@pytest.mark.parametrize("size", [2, 3, 4])
@pytest.mark.parametrize("tree", ["tiny", "base"])
def test_partition_plan_equals_jax(tree, size):
    """(a): the port's spec of every leaf equals JAX's
    ``shardable(params, Mesh(devices[:M] as (1, M)),
    param_partition_specs(params))`` for that key, the Adam moments'
    follow their leaves and the count is replicated; the keys are JAX's."""
    config = tiny_config() if tree == "tiny" else TrainingConfig.load_and_merge(
        TrainingConfig(), [REPO / "configs" / "base.json"])
    jhp = jax_model.hyper_from_config(config)
    shapes = jax.eval_shape(lambda: jax_model.init_model(jax.random.PRNGKey(0), jhp))
    params = jax.tree_util.tree_map(lambda s: np.broadcast_to(np.float32(0), s.shape), shapes)
    mesh = Mesh(np.asarray(jax.devices()[:size]).reshape(1, size), ("data", "model"))
    jspecs = shardable(params, mesh, param_partition_specs(params))
    want = {k: tuple(v) for k, v in _nested_flat(
        jax.tree_util.tree_map(lambda s: tuple(s), jspecs,
                               is_leaf=lambda x: isinstance(x, jax.sharding.PartitionSpec))).items()}
    port_shapes = {k[len("model/"):]: v for k, v in
                   checkpoint.param_shapes(model.hyper_from_config(config)).items()}
    assert set(port_shapes) == set(want)
    got = partitioning.shardable(port_shapes, partitioning.param_partition_specs(port_shapes),
                                 {"model": size})
    assert got == want
    keys = partitioning.sharded_keys(port_shapes, size)
    assert keys == [k for k in port_shapes if got[k]]  # in the params' order
    assert set(keys) == {k for k, v in want.items() if v}
    assert not all(want.values())
    assert any(want.values()) == (tree == "base" or size != 3)  # tiny: widths 8 to 32
    opt = partitioning.opt_state_partition_specs(got)
    assert opt["count"] == () and all(opt[f"{m}/{k}"] == v for m in ("mu", "nu")
                                      for k, v in got.items())
    if tree == "base" and size == 3:
        downgraded = {k for k, v in partitioning.param_partition_specs(port_shapes).items()
                      if v and not got[k]}
        assert {port_shapes[k][-1] for k in downgraded} == {80, 160, 256}


def test_model_groups_lay_the_model_axis_innermost():
    """Rank r = d * M + m: the model groups are rows of a (W / M, M) grid,
    as JAX's ``reshape(n / M, M)`` of the devices; a world that M does not
    divide, and an M below 1, raise with the JAX assert's words."""
    assert parallel.model_groups(8, 2) == [[0, 1], [2, 3], [4, 5], [6, 7]]
    assert parallel.model_groups(6, 3) == [[0, 1, 2], [3, 4, 5]]
    assert parallel.model_groups(4, 1) == [[0], [1], [2], [3]]
    grid = np.asarray(default_mesh(devices=jax.devices()[:8], model_parallel=2).devices)
    assert [[d.id for d in row] for row in grid] == parallel.model_groups(8, 2)
    with pytest.raises(ValueError, match="6 devices do not split into model_parallel=4"):
        parallel.model_groups(6, 4)
    with pytest.raises(ValueError, match="below 1"):
        parallel.check_model_parallel(4, 0)


@pytest.fixture(scope="module")
def ranks(tmp_path_factory):
    """One launch of 4 ranks, model groups of 2, running every job of
    (b)-(e) -> (its directory, the inputs each test needs)."""
    work = tmp_path_factory.mktemp("mp")
    params = _write_params(_port_params(model.hyper_from_config(_config())), work / "params.npz")
    # (b), (d), (e): dropout on, 2 slices a rank, the params moving
    config = _config(dropout=True, accum=2)
    config.learning_rate = LR_TRAJECTORY
    rng = np.random.default_rng(11)
    batches = [random_batch(config, rng, b=B) for _ in range(3)]
    common = {"kind": "steps", "config": _write_config(config, work / "steps.json"),
              "params": params, "batches": _write_batches(batches, work / "steps.npz"),
              "dropout": True}
    ckpt = str(work / "mp.ckpt.npz")
    jobs = [dict(common, name="dp", steps=3, model_parallel=1),
            dict(common, name="mp", steps=3, model_parallel=M, save_after=1),
            dict(common, name="dp_resumed", steps=2, first=1, resume=ckpt, model_parallel=1),
            dict(common, name="mp_resumed", steps=2, first=1, resume=ckpt, model_parallel=M)]
    # (c): test_torch_parallel.py's trajectory, dropout off
    traj_config = _config()
    traj_config.learning_rate = LR_TRAJECTORY
    rng = np.random.default_rng(4)
    traj_batches = [random_batch(traj_config, rng, b=B) for _ in range(3)]
    jobs.append({"kind": "steps", "name": "jax_trajectory",
                 "config": _write_config(traj_config, work / "trajectory.json"),
                 "params": params, "batches": _write_batches(traj_batches, work / "traj.npz"),
                 "steps": 3, "dropout": False, "model_parallel": M})
    run_ranks(work, jobs, world=WORLD, timeout=240, model_parallel=M)
    inputs = {"params": params, "config": config, "ckpt": ckpt,
              "trajectory": (traj_config, traj_batches)}
    return work, inputs


def _results(work: Path, name: str) -> list:
    out = []
    for r in range(WORLD):
        with np.load(work / f"{name}.rank{r}.npz") as data:
            out.append({k: data[k] for k in data.files})
    return out


def _assert_same_bits(got: dict, want: dict, prefixes) -> None:
    keys = [k for k in want if k.startswith(prefixes)]
    assert keys and set(keys) <= set(got)
    for k in keys:
        assert got[k].dtype == want[k].dtype, k
        np.testing.assert_array_equal(got[k].view(np.uint8), want[k].view(np.uint8), err_msg=k)


def test_sharded_steps_equal_data_parallel_bit_for_bit(ranks):
    """(b): 3 steps under (W 4, M 2), dropout on, ``grad_accum_steps`` 2,
    equal the port's 4-rank data-parallel steps from the same params on
    every rank: the four metrics, every param and both Adam moments
    (gathered whole) bit for bit, the same count and launch counts; the
    params moved."""
    work, inputs = ranks
    dp, mp = _results(work, "dp"), _results(work, "mp")
    for d, m in zip(dp, mp):
        np.testing.assert_array_equal(m["metrics"], d["metrics"])
        _assert_same_bits(m, d, ("param/", "mu/", "nu/"))
        assert int(m["count"]) == int(d["count"]) == 3
        assert {k: int(v) for k, v in m.items() if k.startswith("launches/")} == {
            k: int(v) for k, v in d.items() if k.startswith("launches/")}
    _assert_same_bits(mp[3], mp[0], ("param/", "mu/", "nu/"))
    with np.load(inputs["params"]) as before:
        moved = [k for k in before.files
                 if not np.array_equal(before[k], mp[0][f"param/{k}"])]
    assert len(moved) > 10


def test_each_rank_keeps_its_slice_of_the_moments(ranks):
    """(d): under M 2 rank r keeps slice r % 2 of the last dimension of
    every sharded leaf's moments, equal to that slice of the gathered
    moments bit for bit, and the whole moments of every other leaf."""
    work, inputs = ranks
    shapes = {k[len("model/"):]: v for k, v in
              checkpoint.param_shapes(model.hyper_from_config(inputs["config"])).items()}
    sharded = set(partitioning.sharded_keys(shapes, M))
    assert len(sharded) > 20
    for r, res in enumerate(_results(work, "mp")):
        for key, shape in shapes.items():
            for moment in ("mu", "nu"):
                own, whole = res[f"rank_{moment}/{key}"], res[f"{moment}/{key}"]
                if key in sharded:
                    c = shape[-1] // M
                    assert own.shape == (*shape[:-1], c), key
                    want = whole[..., (r % M) * c:(r % M + 1) * c]
                else:
                    assert own.shape == tuple(shape), key
                    want = whole
                np.testing.assert_array_equal(own.view(np.uint8), want.view(np.uint8), err_msg=key)


@pytest.fixture
def fresh_compile():
    """JAX compiles afresh while the test runs, past the persistent
    compilation cache that conftest sets: an XLA:CPU executable of the (2,
    2) mesh's step loaded from that cache can stall in its collectives
    (two devices of a model group each waiting at a different all-gather
    or all-reduce until XLA aborts the process; about one load in four
    here), and a freshly compiled one has not."""
    before = jax.config.jax_enable_compilation_cache
    jax.config.update("jax_enable_compilation_cache", False)
    jax_cache.reset_cache()
    yield
    jax.config.update("jax_enable_compilation_cache", before)
    jax_cache.reset_cache()


def test_sharded_trajectory_matches_jax_model_parallel_mesh(ranks, monkeypatch, fresh_compile):
    """(c): 3 steps under (W 4, M 2) against JAX ``make_train_step(config,
    mesh=default_mesh(devices[:4], model_parallel=2), state=)`` (weights
    and moments sharded over its model axis) on the concatenated batches,
    from the same params: per step the four metrics within 1e-5
    relative; after the steps both Adam moments within atol 1e-5 and each
    leaf's change within 1e-3 of JAX's largest change of that leaf
    (``test_two_rank_trajectory_matches_jax_mesh``'s tolerances).  JAX
    compiles its step afresh (``fresh_compile``)."""
    work, inputs = ranks
    config, batches = inputs["trajectory"]
    orig_prenet = jax_model.prenet_apply
    monkeypatch.setattr(
        jax_model, "prenet_apply", lambda *a, **k: orig_prenet(*a, **dict(k, p_dropout=0.0))
    )
    with np.load(inputs["params"]) as data:
        before = {k: data[k] for k in data.files}
    jparams = jax_checkpoint._merge_into(
        jax_model.init_model(jax.random.PRNGKey(0), jax_model.hyper_from_config(config)),
        {f"model/{k}": v for k, v in before.items()},
    )
    mesh = default_mesh(devices=jax.devices()[:WORLD], model_parallel=M)
    jstate = jax_training.TrainState(jparams, make_optimizer(config).init(jparams), jnp.int32(1))
    jstep = jax_training.make_train_step(config, mesh=mesh, mas_impl="scan", donate=False,
                                         state=jstate)
    results = _results(work, "jax_trajectory")
    for i, batch in enumerate(batches):
        jstate, jmetrics = jstep(jstate, shard_batch(batch, mesh, config.mesh_axis),
                                 jax.random.PRNGKey(i))
        for res in results:
            for j, key in enumerate(METRICS):
                assert res["metrics"][i, j] == pytest.approx(float(jmetrics[key]), rel=1e-5), (i, key)
    adam = jstate.opt_state[1]
    assert int(results[0]["count"]) == int(adam.count) == 3
    jflat = jax_checkpoint._flatten(jstate.params, "")
    jmu, jnu = jax_checkpoint._flatten(adam.mu, ""), jax_checkpoint._flatten(adam.nu, "")
    lr_sum = sum(current_lr(config, s) for s in (1, 2, 3))
    res = results[0]
    for k, b in before.items():
        delta, jdelta = res[f"param/{k}"] - b, np.asarray(jflat[k]) - b
        if k == "encoder/attn/k/b":  # a zero gradient up to round-off
            assert np.abs(delta).max() <= lr_sum and np.abs(jdelta).max() <= lr_sum, k
        else:
            np.testing.assert_allclose(delta, jdelta, rtol=0, atol=1e-3 * np.abs(jdelta).max(),
                                       err_msg=k)
        np.testing.assert_allclose(res[f"mu/{k}"], np.asarray(jmu[k]), rtol=0, atol=1e-5, err_msg=k)
        np.testing.assert_allclose(res[f"nu/{k}"], np.asarray(jnu[k]), rtol=0, atol=1e-5, err_msg=k)


@pytest.mark.parametrize("resumed", ["dp_resumed", "mp_resumed"])
def test_checkpoint_under_model_parallel_resumes_bit_for_bit(ranks, resumed):
    """(e): the checkpoint the (W 4, M 2) run wrote after step 1 (rank 0
    alone, the moments gathered) holds whole leaves; resumed under M 1
    and under M 2 for steps 2 and 3, it gives the uninterrupted run's
    metrics, params and moments bit for bit."""
    work, inputs = ranks
    flat, meta = checkpoint.read_npz(Path(inputs["ckpt"]))
    assert meta["global_step"] == 2
    mp = _results(work, "mp")
    for key, v in flat.items():
        assert v.shape == mp[0][f"param/{key[len('model/'):]}"].shape, key
    for got, want in zip(_results(work, resumed), mp):
        np.testing.assert_array_equal(got["metrics"], want["metrics"][1:])
        _assert_same_bits(got, want, ("param/", "mu/", "nu/"))
        assert int(got["count"]) == 3


def test_checkpoint_under_model_parallel_loads_in_jax(ranks, caplog):
    """(e): the JAX ``load_checkpoint`` takes the (W 4, M 2) checkpoint
    with its Adam state (no "discarding saved optimizer state"): count 1
    and the moments whole, equal to the port's own reading."""
    work, inputs = ranks
    saved: dict = {}
    _, meta = checkpoint.read_npz(Path(inputs["ckpt"]), saved)
    with caplog.at_level(logging.WARNING):
        loaded = jax_checkpoint.load_checkpoint(Path(inputs["ckpt"]), inputs["config"])
    assert "discarding saved optimizer state" not in caplog.text
    adam = loaded.opt_state[1]
    assert int(adam.count) == 1 and loaded.global_step == meta["global_step"] == 2
    for moment in ("mu", "nu"):
        jflat = jax_checkpoint._flatten(getattr(adam, moment), "")
        assert len(jflat) == len([k for k in saved if k.startswith(f"1/{moment}/")])
        for k, v in jflat.items():
            np.testing.assert_array_equal(np.asarray(v), saved[f"1/{moment}/{k}"], err_msg=k)


def _torchrun(corpus, out, *extra):  # noqa: F811
    _run([sys.executable, "-m", "torch.distributed.run", "--standalone",
          "--nproc-per-node", "2", "-m", "glow_tts_train_tpu_torch",
          *_cli_args(corpus, out, *extra)])


def test_train_cli_model_parallel_under_torchrun(corpus, tmp_path):  # noqa: F811
    """(f): the train CLI on 2 CPU ranks with ``--model-parallel 2``
    (one model group of both), fresh (DDI) for 1 epoch of 3 global
    batches of 8, writes one checkpoint and metrics line (rank 0) equal
    bit for bit to the same launch without the flag: params, both Adam
    moments, count and the epoch's loss; one process resumes from it for
    1 epoch and restores its Adam state whole."""
    over = tmp_path / "one_epoch.json"
    over.write_text(json.dumps({"epochs": 1}))
    _torchrun(corpus, "mp_cli", "--config", str(over), "--model-parallel", "2")
    _torchrun(corpus, "dp_cli", "--config", str(over))
    files = sorted(p.name for p in (corpus / "mp_cli").iterdir())
    assert files == ["checkpoint_4.npz", "config_4.json"]
    saved_mp: dict = {}
    saved_dp: dict = {}
    mp_flat, mp_meta = checkpoint.read_npz(corpus / "mp_cli" / "checkpoint_4.npz", saved_mp)
    dp_flat, _ = checkpoint.read_npz(corpus / "dp_cli" / "checkpoint_4.npz", saved_dp)
    assert set(mp_flat) == set(dp_flat) and set(saved_mp) == set(saved_dp)
    for k in mp_flat:
        np.testing.assert_array_equal(mp_flat[k].view(np.uint8), dp_flat[k].view(np.uint8), k)
    for k in saved_mp:
        np.testing.assert_array_equal(saved_mp[k], saved_dp[k], err_msg=k)
    assert int(saved_mp["1/count"]) == 3
    (mp_line,) = [json.loads(l) for l in open(corpus / "mp_cli.jsonl")]
    (dp_line,) = [json.loads(l) for l in open(corpus / "dp_cli.jsonl")]
    assert mp_line["avg_loss"] == dp_line["avg_loss"] and mp_line["global_step"] == 4
    proc = subprocess.run(
        [sys.executable, "-m", "glow_tts_train_tpu_torch",
         *_cli_args(corpus, "mp_resumed", "--config", str(over), "--checkpoint",
                    str(corpus / "mp_cli" / "checkpoint_4.npz"))],
        capture_output=True, text=True, timeout=300, env=_env())
    assert proc.returncode == 0, proc.stderr[-4000:]
    assert "Restored Adam state (count=3)" in proc.stderr
    assert sorted(p.name for p in (corpus / "mp_resumed").iterdir()) == [
        "checkpoint_7.npz", "config_7.json"]
    assert mp_meta["global_step"] == 4


REFUSALS = {
    # (flags, WORLD_SIZE, the message)
    "indivisible_world": (("--model-parallel", "3"), 2,
                          "2 devices do not split into model_parallel=3"),
    "below_one": (("--model-parallel", "0"), 2, "below 1"),
    "no_mesh": (("--no-mesh", "--model-parallel", "2"), 1, "requires a mesh"),
    "one_process": (("--model-parallel", "2"), 1, "1 devices do not split into model_parallel=2"),
}


@pytest.mark.parametrize("case", sorted(REFUSALS))
def test_train_cli_model_parallel_refusals(corpus, monkeypatch, capsys, case):  # noqa: F811
    """(f): the train CLI exits 2, naming the cause and creating no
    output, for an M that the launch's world does not divide (3 over 2
    ranks, 2 over one process), an M below 1 and ``--no-mesh`` with M 2;
    each before any rendezvous."""
    flags, world, want = REFUSALS[case]
    for key in ("WORLD_SIZE", "RANK", "LOCAL_RANK"):
        monkeypatch.delenv(key, raising=False)
    if world > 1:
        for key, value in (("WORLD_SIZE", str(world)), ("RANK", "0"), ("LOCAL_RANK", "0")):
            monkeypatch.setenv(key, value)
    with pytest.raises(SystemExit) as exc:
        train_cli.main(_cli_args(corpus, f"mp_refused_{case}", *flags))
    assert exc.value.code == 2
    err = capsys.readouterr().err
    assert want in err, err
    assert not (corpus / f"mp_refused_{case}").exists()
    assert not torch.distributed.is_initialized()
