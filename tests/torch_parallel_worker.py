"""One rank of a data- or tensor-parallel run of glow_tts_train_tpu_torch,
for the tests (``tests/test_torch_parallel.py``,
``tests/test_torch_model_parallel.py``, ``tests/test_torch_cuda.py``).
It imports torch, numpy and the port, nothing of jax or of the JAX
package.

    python tests/torch_parallel_worker.py SPEC RANK

SPEC is a JSON file: ``{"init": "file://...", "world": 2, "platform":
"cpu" | "cuda", "backend": null | "gloo", "local_rank": null | int,
"model_parallel": 1 | M, "out": DIR, "jobs": [...]}``.  The rank joins
the process group (``parallel.join``, which makes the model groups of M;
``local_rank`` pins every rank to one card), then
runs each job on its rows of the global batches (rank r holds rows
r * b / world to (r + 1) * b / world, the global batch being the ranks'
local batches in rank order) and writes ``DIR/<name>.rank<R>.npz``:

* ``{"kind": "steps", "name", "config": path, "params": path, "batches":
  path, "steps": n, "dropout": bool}``: the train step n times from the
  params (an ``.npz`` of ``"a/b/c"`` keys) on batches 0..n-1 of the
  ``.npz`` (keys ``<i>/<field>``), both dropout generators seeded before
  each step as ``training.train`` seeds them when ``dropout`` is set ->
  ``metrics`` [n, 4] (loss, mle_loss, duration_loss, grad_norm),
  ``param/<key>``, ``mu/<key>``, ``nu/<key>``, ``count``, and
  ``launches/<kernel>`` of the run; the job's ``"model_parallel"`` (default
  1) is the state's M (``training.TrainState``): ``mu/``, ``nu/`` are
  then the moments gathered whole and ``rank_mu/``, ``rank_nu/`` this
  rank's own; ``"resume": path`` starts from that checkpoint as the train
  CLI resumes (params, Adam state, step) on batches ``first``
  (default 0) onwards; ``"save_after": k`` writes
  a checkpoint of the train CLI's format to ``DIR/<name>.ckpt.npz``
  after step k (every rank gathers the moments, rank 0 writes, then a
  barrier);
* ``{"kind": "ddi", "name", "config", "params", "batches"}``: DDI
  (``training.actnorm_init``) on batch 0 -> ``logs``, ``bias``;
* ``{"kind": "synced", "name", "config", "states": [path, ...],
  "batches", "paths": path, "dropout": bool}``: step i from the state of
  ``states[i]`` (an ``.npz`` of ``param/<key>``, ``mu/<key>``,
  ``nu/<key>``, ``count`` and ``step``: the one-process run's before its
  step i) on batch i, its MAS path replaced by the rank's rows of key
  ``<i>`` of ``paths`` (the one-process run's path at step i) ->
  ``metrics`` [n, 4] and ``launches/<kernel>`` summed over the steps.
"""

import datetime
import json
import sys
from pathlib import Path

import numpy as np
import torch

from glow_tts_train_tpu_torch import checkpoint, kernels, parallel, training
from glow_tts_train_tpu_torch.config import load_config
from glow_tts_train_tpu_torch.models import hyper_from_config
from glow_tts_train_tpu_torch.ops import mas_cuda
from glow_tts_train_tpu_torch.optimize import current_lr

FIELDS = ("x", "x_lengths", "y", "y_lengths", "speaker_ids")
METRICS = ("loss", "mle_loss", "duration_loss", "grad_norm")


def local_batch(batches, i: int, world: int, rank: int) -> dict:
    out = {}
    for field in FIELDS:
        key = f"{i}/{field}"
        if key in batches:
            rows = batches[key].shape[0] // world
            out[field] = batches[key][rank * rows:(rank + 1) * rows]
    return out


def model_from(params_path: str, config, device):
    with np.load(params_path) as data:
        flat = {k: data[k] for k in data.files}
    return training.trainable_model(flat, hyper_from_config(config), device)


def run_steps(job: dict, device, rank: int, world: int) -> dict:
    config = load_config([job["config"]])
    size = job.get("model_parallel", 1)
    if job.get("resume"):
        state = load_state(job["resume"], config, device, size)
    else:
        state = training.TrainState(model_from(job["params"], config, device), model_parallel=size)
    step_fn = training.make_train_step(config)
    generator = torch.Generator(device=device)
    seed_generator = torch.Generator()
    metrics = []
    kernels.reset_launch_counts()
    first = job.get("first", 0)
    with np.load(job["batches"]) as batches:
        for i in range(first, first + job["steps"]):
            batch = training.batch_to(local_batch(batches, i, world, rank), device)
            gens = (None, None)
            if job["dropout"]:
                generator.manual_seed(training.dropout_seed(config.seed, state.step))
                seed_generator.manual_seed(training.dropout_seed(config.seed, state.step))
                gens = (generator, seed_generator)
            m = step_fn(state, batch, *gens)
            metrics.append([float(m[k]) for k in METRICS])
            if job.get("save_after") == i + 1:
                opt = state.whole_opt()
                if rank == 0:
                    checkpoint.save_checkpoint(
                        state.model.flat(), Path(job["out"]) / f"{job['name']}.ckpt.npz",
                        state.step, current_lr(config, state.step), config.version, opt,
                        config.scheduler)
                torch.distributed.barrier()
    out = {"metrics": np.asarray(metrics, np.float64), "count": np.asarray(state.opt.count)}
    whole = state.whole_opt()
    for key, p in state.model.flat().items():
        out[f"param/{key}"] = p.detach().cpu().numpy()
        out[f"mu/{key}"] = whole.mu[key].cpu().numpy()
        out[f"nu/{key}"] = whole.nu[key].cpu().numpy()
        if size > 1:
            out[f"rank_mu/{key}"] = state.opt.mu[key].cpu().numpy()
            out[f"rank_nu/{key}"] = state.opt.nu[key].cpu().numpy()
    for name, n in kernels.launch_counts().items():
        out[f"launches/{name}"] = np.asarray(n)
    return out


def load_state(path: str, config, device, model_parallel: int = 1) -> training.TrainState:
    """The train state of a checkpoint of the train CLI's format (params,
    Adam moments and count, step), its Adam state whole (a rank's slices
    of it under ``model_parallel`` M > 1)."""
    saved_opt: dict = {}
    flat, meta = checkpoint.read_npz(Path(path), saved_opt)
    model = training.trainable_model(
        {k[len(checkpoint.PREFIX):]: v for k, v in flat.items()}, hyper_from_config(config), device
    )
    state = training.TrainState(model, int(meta["global_step"]), model_parallel)
    opt, why = checkpoint.restore_opt_state(
        saved_opt, meta.get("opt_treedef"), model.flat(), config.scheduler
    )
    assert opt is not None, why
    state.take_opt(opt)
    return state


def run_synced(job: dict, device, rank: int, world: int) -> dict:
    config = load_config([job["config"]])
    step_fn = training.make_train_step(config)
    generator = torch.Generator(device=device)
    seed_generator = torch.Generator()
    metrics, launches = [], {}
    kernel_mas = mas_cuda.maximum_path
    with np.load(job["batches"]) as batches, np.load(job["paths"]) as paths:
        for i, state_path in enumerate(job["states"]):
            state = load_state(state_path, config, device)
            batch = training.batch_to(local_batch(batches, i, world, rank), device)
            rows = batch["x"].shape[0]
            pinned = torch.from_numpy(paths[str(i)][rank * rows:(rank + 1) * rows])
            gens = (None, None)
            if job["dropout"]:
                generator.manual_seed(training.dropout_seed(config.seed, state.step))
                seed_generator.manual_seed(training.dropout_seed(config.seed, state.step))
                gens = (generator, seed_generator)
            kernels.reset_launch_counts()
            mas_cuda.maximum_path = lambda logp, mask: pinned.to(logp)
            try:
                m = step_fn(state, batch, *gens)
            finally:
                mas_cuda.maximum_path = kernel_mas
            metrics.append([float(m[k]) for k in METRICS])
            for name, n in kernels.launch_counts().items():
                launches[name] = launches.get(name, 0) + n
    out = {"metrics": np.asarray(metrics, np.float64)}
    for name, n in launches.items():
        out[f"launches/{name}"] = np.asarray(n)
    return out


def run_ddi(job: dict, device, rank: int, world: int) -> dict:
    config = load_config([job["config"]])
    model = model_from(job["params"], config, device)
    with np.load(job["batches"]) as batches:
        batch = training.batch_to(local_batch(batches, 0, world, rank), device)
    model = training.actnorm_init(model, config, batch)
    flat = model.flat()
    return {name: flat[f"decoder/blocks/actnorm/{name}"].detach().cpu().numpy()
            for name in ("logs", "bias")}


def main(spec_path: str, rank: int) -> int:
    spec = json.loads(Path(spec_path).read_text())
    world = spec["world"]
    torch.set_num_threads(2)
    local_rank = rank if spec.get("local_rank") is None else spec["local_rank"]
    launch = parallel.Launch(rank, world, local_rank, spec["init"])
    device = parallel.join(
        launch, spec["platform"], backend=spec.get("backend"),
        timeout=datetime.timedelta(seconds=120), model_parallel=spec.get("model_parallel", 1),
    )
    try:
        if spec["platform"] == "cuda":
            torch.backends.cuda.matmul.allow_tf32 = False
            torch.backends.cudnn.allow_tf32 = False
        assert parallel.world() == world and parallel.rank() == rank
        runs = {"steps": run_steps, "ddi": run_ddi, "synced": run_synced}
        for job in spec["jobs"]:
            job = dict(job, out=spec["out"])
            out = runs[job["kind"]](job, device, rank, world)
            np.savez(Path(spec["out"]) / f"{job['name']}.rank{rank}.npz", **out)
    finally:
        parallel.leave()
    return 0


def run_ranks(workdir: Path, jobs: list, world: int = 2, platform: str = "cpu",
              backend=None, local_rank=None, timeout: float = 300.0,
              model_parallel: int = 1) -> None:
    """Start ``world`` ranks of this module on ``jobs`` (outputs in
    ``workdir``, rendezvous through a ``file://`` there), wait for all of
    them within ``timeout`` seconds, kill them past it, and raise
    ``AssertionError`` with their output if one failed."""
    import os
    import subprocess
    import time

    workdir = Path(workdir)
    spec = {"init": f"file://{workdir / 'rendezvous'}", "world": world, "platform": platform,
            "backend": backend, "local_rank": local_rank, "model_parallel": model_parallel,
            "out": str(workdir), "jobs": jobs}
    spec_path = workdir / "spec.json"
    spec_path.write_text(json.dumps(spec))
    repo = Path(__file__).resolve().parent.parent
    env = dict(os.environ, OMP_NUM_THREADS="2")
    env["PYTHONPATH"] = os.pathsep.join([str(repo), env.get("PYTHONPATH", "")])
    procs, logs = [], []
    for r in range(world):
        log = open(workdir / f"rank{r}.log", "w")
        logs.append(log)
        procs.append(subprocess.Popen(
            [sys.executable, __file__, str(spec_path), str(r)], cwd=repo, env=env,
            stdout=log, stderr=subprocess.STDOUT,
        ))
    deadline = time.monotonic() + timeout
    try:
        for p in procs:
            p.wait(timeout=max(deadline - time.monotonic(), 0.1))
    except subprocess.TimeoutExpired:
        pass
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
                p.wait()
        for log in logs:
            log.close()
    codes = [p.returncode for p in procs]
    if any(codes):
        tails = "\n".join(f"--- rank {r} (exit {c}):\n"
                          + (workdir / f"rank{r}.log").read_text()[-3000:]
                          for r, c in enumerate(codes))
        raise AssertionError(f"ranks exited {codes} (timeout {timeout} s)\n{tails}")


if __name__ == "__main__":
    sys.exit(main(sys.argv[1], int(sys.argv[2])))
