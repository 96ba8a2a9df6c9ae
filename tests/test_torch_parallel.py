"""Data-parallel training in glow_tts_train_tpu_torch on the CPU, over
gloo: two ranks, each a process of ``tests/torch_parallel_worker.py``
(torch, numpy and the port only; rendezvous through a ``file://`` in the
test's directory, a timeout a launch), against the port's one-process
step on the concatenated global batch and against the JAX package's
2-device mesh (conftest's virtual CPU devices).

The ranks of one launch run every case of (a)-(d) in turn; a
module-scoped fixture launches them once.  Batches are ragged and made
from a numpy seed; the global batch is the ranks' local batches in rank
order (rank r holds rows 4r to 4r + 3 of 8).

* (a) one 2-rank step against the one-process full-batch step, the text
  side op by op and through its autograd Functions, at
  ``grad_accum_steps`` 1 and 2, dropout off;
* (b) the same with dropout on: each rank draws its rows' masks of the
  global batch (``attention.RowsGenerator``), so the masks are the
  one-process step's and the tolerances the same;
* (c) DDI on 2 ranks against JAX ``initialize_model(..., mesh=)``;
* (d) a 3-step 2-rank trajectory against JAX ``make_train_step(...,
  mesh=)`` on the concatenated batches;
* (d') the synced steps: before each of 3 steps the ranks load the
  params and Adam state that the port's one process had before that
  step, and take it on the one process's MAS path, dropout on;
* (e) the train CLI under ``torch.distributed.run --standalone
  --nproc-per-node 2``: rank 0 alone writes, the epochs' losses and the
  final params are the one-process CLI's, and a resumed run equals an
  uninterrupted one;
* (f) the CLI's refusals, with exit 2 before any rendezvous, and the
  launch read from the JAX CLI's flags or torchrun's environment.
"""

import json
import os
import signal
import subprocess
import sys
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from glow_tts_train_tpu import checkpoint as jax_checkpoint
from glow_tts_train_tpu import training as jax_training
from glow_tts_train_tpu.models import glow_tts as jax_model
from glow_tts_train_tpu.optimize import make_optimizer
from glow_tts_train_tpu.parallel import default_mesh, shard_batch
from glow_tts_train_tpu_torch import checkpoint, parallel, training
from glow_tts_train_tpu_torch import __main__ as train_cli
from glow_tts_train_tpu_torch.config import load_config
from glow_tts_train_tpu_torch.models import glow_tts as model
from glow_tts_train_tpu_torch.ops import mas_cuda
from glow_tts_train_tpu_torch.ops.attention import rows_of
from glow_tts_train_tpu_torch.optimize import current_lr

from helpers import random_batch, tiny_config
from test_torch_train import _env, corpus  # noqa: F401  (corpus: a fixture)
from torch_parallel_worker import METRICS, run_ranks

# test_torch_accum.py's tolerances for an accumulated step against the
# full batch (the f32 sums go in another order)
PARAM_RTOL, PARAM_ATOL = 3e-4, 2e-6
METRIC_RTOL, METRIC_ATOL = 3e-4, 1e-6
LR_TRAJECTORY = 1e3  # test_torch_accum.py's
# the attention key bias: its gradient is 0 up to round-off (softmax shift
# invariance), so each Adam step moves it by up to lr either way
ZERO_GRADIENT_LEAF = "model/encoder/attn/k/b"
B = 8  # the global batch; 4 rows a rank

STEP_CASES = {
    f"{'fused' if fuse else 'op_by_op'}_accum{accum}_{'dropout' if drop else 'no_dropout'}":
        (fuse, accum, drop)
    for fuse in (False, True) for accum in (1, 2) for drop in (False, True)
}


def _config(encoder_fuse=False, accum=1, dropout=False):
    # dropout on: the decoder's at 0.5, so that its masks show in the metrics
    config = tiny_config(p_dropout_dec=0.5) if dropout else tiny_config(
        p_dropout=0.0, p_dropout_dec=0.0)
    config.encoder_fuse = encoder_fuse
    config.grad_accum_steps = accum
    return config


def _write_config(config, path: Path) -> str:
    with open(path, "w") as f:
        config.save(f)
    return str(path)


def _write_batches(batches, path: Path) -> str:
    np.savez(path, **{f"{i}/{k}": v for i, b in enumerate(batches) for k, v in b.items()})
    return str(path)


def _write_params(flat, path: Path) -> str:
    np.savez(path, **{k: np.asarray(v) for k, v in flat.items()})
    return str(path)


def _port_params(hp, seed=1) -> dict:
    return {k[len("model/"):]: v for k, v in checkpoint.random_params(hp, seed).items()}


def _mesh():
    return default_mesh(devices=jax.devices()[:2])


def _one_process_states(config, params_path: str, batches, work: Path) -> tuple:
    """The port's one process, ``len(batches)`` steps with dropout on from
    the params: before each step its state is written to
    ``work/synced_state<i>.npz`` (a checkpoint of the train CLI's, Adam
    state included) and each step's MAS path to ``work/synced_paths.npz``
    -> (the state paths, the paths' file, metrics [n, 4])."""
    hp = model.hyper_from_config(config)
    with np.load(params_path) as data:
        flat = {k: data[k] for k in data.files}
    state = training.TrainState(training.trainable_model(flat, hp, "cpu"))
    step_fn = training.make_train_step(config)
    states, paths, metrics = [], {}, []
    kernel_mas = mas_cuda.maximum_path

    def recorded(logp, mask):
        path = kernel_mas(logp, mask)
        paths[str(len(paths))] = path.numpy()
        return path

    mas_cuda.maximum_path = recorded
    try:
        for i, batch in enumerate(batches):
            states.append(str(work / f"synced_state{i}.npz"))
            checkpoint.save_checkpoint(state.model.flat(), states[-1], state.step,
                                       current_lr(config, state.step), config.version, state.opt,
                                       config.scheduler)
            seed = training.dropout_seed(config.seed, state.step)
            m = step_fn(state, training.batch_to(batch, "cpu"), torch.Generator().manual_seed(seed),
                        torch.Generator().manual_seed(seed))
            metrics.append([float(m[k]) for k in METRICS])
    finally:
        mas_cuda.maximum_path = kernel_mas
    np.savez(work / "synced_paths.npz", **paths)
    return states, str(work / "synced_paths.npz"), np.asarray(metrics)


@pytest.fixture(scope="module")
def ranks(tmp_path_factory):
    """One 2-rank launch running every job of (a)-(d) -> (its directory,
    the inputs each test needs)."""
    work = tmp_path_factory.mktemp("dp")
    hp = model.hyper_from_config(_config())
    params = _write_params(_port_params(hp), work / "params.npz")
    step_batch = random_batch(_config(), np.random.default_rng(1), b=B)
    assert len(set(step_batch["y_lengths"].tolist())) > 1
    batches = _write_batches([step_batch], work / "step_batch.npz")
    jobs = []
    for name, (fuse, accum, drop) in STEP_CASES.items():
        cfg = _write_config(_config(fuse, accum, drop), work / f"{name}.json")
        jobs.append({"kind": "steps", "name": name, "config": cfg, "params": params,
                     "batches": batches, "steps": 1, "dropout": drop})
    # (c): DDI from the JAX mesh's init, on its global batch
    ddi_config = tiny_config()
    ddi_batch = random_batch(ddi_config, np.random.default_rng(2), b=B)
    jax_ddi = jax_training.initialize_model(ddi_config, ddi_batch, mesh=_mesh())
    jflat = {k: np.asarray(v) for k, v in jax_checkpoint._flatten(jax_ddi, "").items()}
    jobs.append({"kind": "ddi", "name": "ddi",
                 "config": _write_config(ddi_config, work / "ddi.json"),
                 "params": _write_params(jflat, work / "ddi_params.npz"),
                 "batches": _write_batches([ddi_batch], work / "ddi_batch.npz")})
    # (d): 3 steps from the same params on ragged batches of 8
    traj_config = _config()
    traj_config.learning_rate = LR_TRAJECTORY
    rng = np.random.default_rng(4)
    traj_batches = [random_batch(traj_config, rng, b=B) for _ in range(3)]
    jobs.append({"kind": "steps", "name": "trajectory",
                 "config": _write_config(traj_config, work / "trajectory.json"),
                 "params": params, "batches": _write_batches(traj_batches, work / "traj.npz"),
                 "steps": 3, "dropout": False})
    # (d'): 3 synced steps, dropout on, the params moving between them
    synced_config = _config(dropout=True)
    synced_config.learning_rate = LR_TRAJECTORY
    rng = np.random.default_rng(7)
    synced_batches = [random_batch(synced_config, rng, b=B) for _ in range(3)]
    states, paths, synced_metrics = _one_process_states(synced_config, params, synced_batches,
                                                        work)
    jobs.append({"kind": "synced", "name": "synced",
                 "config": _write_config(synced_config, work / "synced.json"), "states": states,
                 "batches": _write_batches(synced_batches, work / "synced_batches.npz"),
                 "paths": paths, "dropout": True})
    run_ranks(work, jobs, timeout=240)
    inputs = {"params": params, "step_batch": step_batch, "ddi": (ddi_config, jflat),
              "trajectory": (traj_config, traj_batches), "synced": (states, synced_metrics)}
    return work, inputs


@pytest.mark.parametrize("encoder_fuse", [False, True], ids=["op_by_op", "fused"])
def test_rows_draw_the_global_batchs_masks(encoder_fuse):
    """``forward_train`` with dropout on (the decoder's at 0.5), run on
    rows 0-3 and 4-7 of a batch of 8 with ``attention.rows_of`` generators,
    equals the whole batch's run row for row (z, z_m, logdet, x_m, logw,
    the path): every dropout site, the text side's op by op or through its
    kernels' plain versions, and the decoder's, draws the masks of its
    rows of the global batch; halves drawn as batches of their own do
    not."""
    config = _config(encoder_fuse, 1, True)
    hp = model.hyper_from_config(config)
    params = training.trainable_model(_port_params(hp), hp, "cpu").tree()
    batch = training.batch_to(random_batch(config, np.random.default_rng(6), b=B), "cpu")

    def run(rows, first=None):
        gens = [torch.Generator().manual_seed(21) for _ in range(2)]
        if first is not None:
            gens = [rows_of(g, first, B) for g in gens]
        part = {k: v[rows] for k, v in batch.items()}
        (z, z_m, _, logdet, _), (x_m, _, _), (attn, logw, _) = model.forward_train(
            params, hp, part["x"], part["x_lengths"], part["y"], part["y_lengths"],
            generator=gens[0], seed_generator=gens[1])
        return z, z_m, logdet, x_m, logw, attn

    whole = run(slice(0, B))
    halves = [run(slice(0, 4), 0), run(slice(4, 8), 4)]
    own = run(slice(4, 8))
    for i, w in enumerate(whole):
        got = torch.cat([h[i] for h in halves])
        np.testing.assert_allclose(got.numpy(), w.numpy(), rtol=1e-5, atol=1e-6, err_msg=str(i))
    assert not torch.allclose(own[0], whole[0][4:], rtol=1e-3, atol=1e-4)


def _rank_results(work: Path, name: str):
    out = []
    for r in range(2):
        with np.load(work / f"{name}.rank{r}.npz") as data:
            out.append({k: data[k] for k in data.files})
    return out


def _params_equal_across_ranks(results) -> None:
    keys = [k for k in results[0] if k.startswith(("param/", "mu/", "nu/"))]
    assert keys
    for k in keys:
        np.testing.assert_array_equal(results[0][k], results[1][k], err_msg=k)


@pytest.mark.parametrize("case", sorted(STEP_CASES))
def test_two_rank_step_matches_one_process_step(ranks, case):
    """(a), (b): one 2-rank step on the global batch of 8 against the
    port's one-process full-batch step from the same params (dropout: both
    generators seeded as ``train`` seeds step 1): loss, mle_loss,
    duration_loss and grad_norm on each rank within 3e-4, every param
    within 3e-4 relative and 2e-6 absolute, and the two ranks' params and
    Adam moments equal bit for bit."""
    work, inputs = ranks
    fuse, accum, drop = STEP_CASES[case]
    config = _config(fuse, 1, drop)
    hp = model.hyper_from_config(config)
    with np.load(inputs["params"]) as data:
        flat = {k: data[k] for k in data.files}
    state = training.TrainState(training.trainable_model(flat, hp, "cpu"))
    gens = (None, None)
    if drop:
        seed = training.dropout_seed(config.seed, 1)
        gens = (torch.Generator().manual_seed(seed), torch.Generator().manual_seed(seed))
    ref = training.make_train_step(config)(state, training.batch_to(inputs["step_batch"], "cpu"),
                                           *gens)
    results = _rank_results(work, case)
    for res in results:
        for j, key in enumerate(METRICS):
            np.testing.assert_allclose(res["metrics"][0, j], float(ref[key]),
                                       rtol=METRIC_RTOL, atol=METRIC_ATOL, err_msg=key)
        assert int(res["count"]) == 1
    for key, p in state.model.flat().items():
        np.testing.assert_allclose(results[0][f"param/{key}"], p.detach().numpy(),
                                   rtol=PARAM_RTOL, atol=PARAM_ATOL, err_msg=key)
    _params_equal_across_ranks(results)


def test_two_rank_ddi_matches_jax_mesh(ranks):
    """(c): DDI on 2 ranks, each on its 4 rows, from the params of JAX
    ``initialize_model(config, batch, mesh=<2 devices>)`` against that
    call's ActNorm (``tests/test_parallel.py``'s rtol 1e-4, atol 1e-5);
    the ranks' equal bit for bit."""
    work, inputs = ranks
    _, jflat = inputs["ddi"]
    results = _rank_results(work, "ddi")
    for name in ("logs", "bias"):
        np.testing.assert_array_equal(results[0][name], results[1][name])
        np.testing.assert_allclose(results[0][name], jflat[f"decoder/blocks/actnorm/{name}"],
                                   rtol=1e-4, atol=1e-5, err_msg=name)


def test_two_rank_trajectory_matches_jax_mesh(ranks, monkeypatch):
    """(d): three 2-rank steps against JAX ``make_train_step(config,
    mesh=<2 devices>, mas_impl="scan")`` on the concatenated batches, from
    the same params: per step the four metrics within 1e-5 relative;
    after the steps both Adam moments within atol 1e-5 and each leaf's
    change within 1e-3 of JAX's largest change of that leaf
    (``test_torch_accum.py``'s trajectory tolerances); the ranks' params
    equal bit for bit."""
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
    mesh = _mesh()
    tx = make_optimizer(config)
    jstate = jax_training.TrainState(jparams, tx.init(jparams), jnp.int32(1))
    jstep = jax_training.make_train_step(config, mesh=mesh, mas_impl="scan", donate=False)
    results = _rank_results(work, "trajectory")
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
    _params_equal_across_ranks(results)


def test_two_rank_synced_steps_match_one_process_at_every_step(ranks):
    """(d'): each of 3 steps taken by 2 ranks from the port's one-process
    state before that step (params, Adam moments and count, step) on its
    MAS path, dropout on: loss, mle_loss, duration_loss and grad_norm
    within 3e-4 of the one process's at every step, the grad norm too
    (the hold the data-parallel phase of ``chip_smoke.py`` keeps on the
    card: a drift of the trajectory is not a fault of the reduction);
    both ranks' metrics equal bit for bit."""
    work, inputs = ranks
    states, ref = inputs["synced"]
    (first, first_meta), (last, last_meta) = (checkpoint.read_npz(Path(p)) for p in
                                              (states[0], states[-1]))
    assert (first_meta["global_step"], last_meta["global_step"]) == (1, len(states))
    assert not np.array_equal(first["model/decoder/blocks/coupling/end/w"],
                              last["model/decoder/blocks/coupling/end/w"])
    results = _rank_results(work, "synced")
    for res in results:
        assert res["metrics"].shape == ref.shape
        np.testing.assert_allclose(res["metrics"], ref, rtol=METRIC_RTOL, atol=METRIC_ATOL)
    np.testing.assert_array_equal(results[0]["metrics"], results[1]["metrics"])


def _cli_args(corpus, out, *extra):  # noqa: F811
    return ["--output", str(corpus / out), "--dataset", "0", str(corpus / "phonemes.csv"),
            str(corpus / "mels"), "--mels-dir", "--config", str(corpus / "config.json"),
            "--metrics-file", str(corpus / f"{out}.jsonl"), "--platform", "cpu", *extra]


def _run(cmd, timeout=300):
    """``cmd`` in a session of its own, killed with every process it started
    (a launcher's ranks) past ``timeout`` seconds; asserts exit 0."""
    proc = subprocess.Popen(cmd, env=_env(), stdout=subprocess.PIPE, stderr=subprocess.PIPE,
                            text=True, start_new_session=True)
    try:
        out, err = proc.communicate(timeout=timeout)
    except subprocess.TimeoutExpired:
        os.killpg(proc.pid, signal.SIGKILL)
        out, err = proc.communicate()
        raise AssertionError(f"{cmd[:6]}: no end within {timeout} s\n{err[-4000:]}")
    assert proc.returncode == 0, out[-2000:] + err[-4000:]


def _torchrun(corpus, out, *extra):  # noqa: F811
    _run([sys.executable, "-m", "torch.distributed.run", "--standalone",
                 "--nproc-per-node", "2", "-m", "glow_tts_train_tpu_torch",
                 *_cli_args(corpus, out, *extra)])


def _flat(path: Path) -> dict:
    flat, _ = checkpoint.read_npz(path)
    return flat


def test_train_cli_under_torchrun(corpus, tmp_path):  # noqa: F811
    """(e): the train CLI on 2 CPU ranks (``torch.distributed.run
    --standalone --nproc-per-node 2``, gloo), fresh (DDI) for 2 epochs of
    3 global batches of 8, dropout off, against the one-process CLI at the
    same global batch: the output holds one checkpoint and config an
    epoch and the metrics file one line an epoch (rank 0 alone writes),
    each epoch's avg_loss within 1e-4 relative of the one-process run's
    and the final params within the accumulation's tolerances (the
    attention key bias, whose gradient is round-off, within 2 x the lrs'
    sum); then 1
    epoch on 2 ranks resumed from the first epoch's checkpoint equals the
    uninterrupted run's last checkpoint within atol 1e-6 (its metrics line
    too)."""
    _torchrun(corpus, "dp")
    _run([sys.executable, "-m", "glow_tts_train_tpu_torch", *_cli_args(corpus, "one")])
    out = corpus / "dp"
    assert sorted(p.name for p in out.iterdir()) == [
        "checkpoint_4.npz", "checkpoint_7.npz", "config_4.json", "config_7.json"]
    assert json.loads((out / "config_7.json").read_text())["batch_size"] == 8
    dp_lines = [json.loads(l) for l in open(corpus / "dp.jsonl")]
    one_lines = [json.loads(l) for l in open(corpus / "one.jsonl")]
    assert [l["global_step"] for l in dp_lines] == [l["global_step"] for l in one_lines] == [4, 7]
    for d, o in zip(dp_lines, one_lines):
        assert d["avg_loss"] == pytest.approx(o["avg_loss"], rel=1e-4)
    dp_flat, one_flat = _flat(out / "checkpoint_7.npz"), _flat(corpus / "one" / "checkpoint_7.npz")
    lr_sum = sum(current_lr(load_config([corpus / "config.json"]), s) for s in range(1, 7))
    for k, v in dp_flat.items():
        if k == ZERO_GRADIENT_LEAF:  # Adam moves it by the sign of round-off
            assert np.abs(v - one_flat[k]).max() <= 2 * lr_sum, k
        else:
            np.testing.assert_allclose(v, one_flat[k], rtol=PARAM_RTOL, atol=PARAM_ATOL, err_msg=k)
    over = tmp_path / "one_epoch.json"
    over.write_text(json.dumps({"epochs": 1}))
    _torchrun(corpus, "dp_resumed", "--checkpoint", str(out / "checkpoint_4.npz"),
              "--config", str(over))
    resumed = _flat(corpus / "dp_resumed" / "checkpoint_7.npz")
    for k, v in dp_flat.items():
        np.testing.assert_allclose(resumed[k], v, rtol=0, atol=1e-6, err_msg=k)
    (line,) = [json.loads(l) for l in open(corpus / "dp_resumed.jsonl")]
    assert line["global_step"] == 7
    assert line["avg_loss"] == pytest.approx(dp_lines[1]["avg_loss"], rel=0, abs=1e-6)


LAUNCHES = {
    # (flags, environment, the Launch or the ValueError's words)
    "coordinator": (("host0:29500", 4, 3), {}, parallel.Launch(3, 4, 3, "tcp://host0:29500")),
    "coordinator_local_rank": (("host0:29500", 16, 9), {"LOCAL_RANK": "1"},
                               parallel.Launch(9, 16, 1, "tcp://host0:29500")),
    "coordinator_without_id": (("host0:29500", 4, None), {}, "needs --num-processes"),
    "process_id_out_of_range": (("host0:29500", 4, 4), {}, "is not in"),
    "id_without_coordinator": ((None, None, 1), {}, "need --coordinator"),
    "torchrun": ((None, None, None), {"WORLD_SIZE": "8", "RANK": "5", "LOCAL_RANK": "1"},
                 parallel.Launch(5, 8, 1, "env://")),
    "world_without_rank": ((None, None, None), {"WORLD_SIZE": "2"}, "RANK is not set"),
    "one_process": ((None, None, None), {"WORLD_SIZE": "1", "RANK": "0"}, parallel.Launch()),
}


@pytest.mark.parametrize("case", sorted(LAUNCHES))
def test_launch_from_flags_and_environment(monkeypatch, case):
    """``parallel.launch_from`` reads the JAX CLI's --coordinator,
    --num-processes and --process-id (the local rank from ``LOCAL_RANK``,
    else the process id) or torchrun's environment without joining
    anything, and raises ``ValueError`` for an incomplete set."""
    flags, environ, want = LAUNCHES[case]
    for key in ("WORLD_SIZE", "RANK", "LOCAL_RANK"):
        monkeypatch.delenv(key, raising=False)
    for key, value in environ.items():
        monkeypatch.setenv(key, value)
    if isinstance(want, str):
        with pytest.raises(ValueError, match=want):
            parallel.launch_from(*flags)
    else:
        assert parallel.launch_from(*flags) == want
    assert not torch.distributed.is_initialized()


REFUSALS = {
    "indivisible_batch": ("--batch-size", "7"),
    "accum_over_local_batch": ("--batch-size", "6", "--config", "ACCUM2"),
    "model_parallel": ("--model-parallel", "3"),
    "no_mesh_under_a_launcher": ("--no-mesh",),
    "virtual_devices": ("--virtual-devices", "4"),
}


@pytest.mark.parametrize("case", sorted(REFUSALS))
def test_train_cli_refusals(corpus, tmp_path, monkeypatch, capsys, case):  # noqa: F811
    """(f): under a launcher's ``WORLD_SIZE`` 2 the train CLI exits 2,
    naming the cause and creating no output, for a global batch that 2
    ranks do not divide, a local batch (6 over 2) that
    ``grad_accum_steps`` 2 does not divide, ``--model-parallel 3`` (model
    groups of 3 do not divide 2 ranks), ``--no-mesh`` and
    ``--virtual-devices``; each before any rendezvous (no process group
    is joined: the run has no peer)."""
    accum = tmp_path / "accum.json"
    accum.write_text(json.dumps({"grad_accum_steps": 2}))
    for key, value in (("WORLD_SIZE", "2"), ("RANK", "0"), ("LOCAL_RANK", "0")):
        monkeypatch.setenv(key, value)
    extra = [str(accum) if a == "ACCUM2" else a for a in REFUSALS[case]]
    with pytest.raises(SystemExit) as exc:
        train_cli.main(_cli_args(corpus, f"refused_{case}", *extra))
    assert exc.value.code == 2
    err = capsys.readouterr().err
    want = {"indivisible_batch": "divide evenly over 2 ranks",
            "accum_over_local_batch": "grad_accum_steps 2",
            "model_parallel": "2 devices do not split into model_parallel=3",
            "no_mesh_under_a_launcher": "--no-mesh", "virtual_devices": "--virtual-devices"}
    assert want[case] in err, err
    assert not (corpus / f"refused_{case}").exists()
    assert not torch.distributed.is_initialized()
