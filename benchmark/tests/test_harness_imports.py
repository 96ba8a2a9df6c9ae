"""What the harness and its reference import: never JAX or the JAX package
(top-level names compared whole), and the reference nothing of the port."""

import ast
import subprocess
import sys

import harness_tiny

BENCH_DIR = harness_tiny.BENCH_DIR
FORBIDDEN = {"jax", "jaxlib", "flax", "glow_tts_train_tpu"}


def _imports(path):
    tree = ast.parse(path.read_text())
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            yield from (a.name.split(".")[0] for a in node.names)
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            yield node.module.split(".")[0]


def test_no_source_of_the_harness_names_jax_or_the_jax_package():
    for path in BENCH_DIR.rglob("*.py"):
        assert not set(_imports(path)) & FORBIDDEN, path


def test_the_reference_imports_nothing_of_the_program():
    for name in ("reference.py", "weights.py", "flops.py", "corpus.py", "checks.py"):
        assert "glow_tts_train_tpu_torch" not in set(_imports(BENCH_DIR / "harness" / name))


def test_a_tiny_run_loads_no_forbidden_module(tmp_path):
    config = harness_tiny.tiny_config(tmp_path)
    script = f"""
import sys, time
sys.path[:0] = [{str(harness_tiny.ROOT)!r}, {str(BENCH_DIR)!r}]
import torch
from harness import launch
for traffic in ({harness_tiny.TRAIN_TRAFFIC!r}, {harness_tiny.SYNTH_TRAFFIC!r}):
    ctx = launch.Context("tiny", {str(config)!r}, traffic, 5, 0.3, False, torch.device("cpu"),
                         t0=time.perf_counter())
    record, probe = launch.drive(ctx)
    launch.check(ctx, record, probe)
import harness.reference
assert "glow_tts_train_tpu_torch" in sys.modules
print(launch.forbidden_modules())
"""
    out = subprocess.run([sys.executable, "-c", script], capture_output=True, text=True,
                         timeout=600, check=True)
    assert out.stdout.strip().splitlines()[-1] == "[]"


def test_the_reference_alone_loads_nothing_of_the_program():
    script = f"""
import sys
sys.path[:0] = [{str(BENCH_DIR)!r}]
import harness.reference, harness.checks, harness.weights, harness.flops, harness.corpus
print(sorted(m for m in sys.modules if m.split(".")[0] in
             ("glow_tts_train_tpu_torch", "glow_tts_train_tpu", "jax")))
"""
    out = subprocess.run([sys.executable, "-c", script], capture_output=True, text=True,
                         timeout=300, check=True)
    assert out.stdout.strip().splitlines()[-1] == "[]"
