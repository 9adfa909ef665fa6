"""Nothing the harness runs imports JAX, flax, optax or the JAX package,
by top-level module name compared whole (the port's name begins with the
JAX package's)."""

import subprocess
import sys

import pbench_tiny
from port_bench.core import registry

SCRIPT = r"""
import sys, time
sys.path.insert(0, {root!r})
sys.path.insert(0, {tests!r})
from port_bench import control  # noqa: F401
from port_bench.core import flops, peaks, report, trace  # noqa: F401
from port_bench.core import registry
from port_bench.tests.pbench_tiny import TinyCell
import json
bench = json.load(open({root!r} + "/BENCHMARK.json"))
for c in bench["configs"]:
    registry.load_program(json.load(open({root!r} + "/" + c["file"]))["family"])
for w in bench["workloads"]:
    registry.load_driver(registry.load_traffic(w["traffic"])["driver"])
for m in bench["per_layer"]:
    registry.load_metric(m["name"])
cell = TinyCell("pm_train_b8", "partial_modality-dn121-f32", "epochs_b8")
registry.load_driver("train_epochs").run(
    cell, seed=5, seconds=0.1, trace=False, t_start=time.perf_counter(),
    device="cpu")
print(registry.forbidden_modules(sys.modules))
"""


def test_forbidden_names_compared_whole():
    mods = ["multimodal_survival_prediction_tpu_torch.train.engine",
            "multimodal_survival_prediction_tpu.ops", "jaxlib", "jax.numpy",
            "flaxen", "optax"]
    assert registry.forbidden_modules(mods) == [
        "jax.numpy", "jaxlib", "multimodal_survival_prediction_tpu.ops",
        "optax"]


def test_a_run_loads_no_jax():
    out = subprocess.run(
        [sys.executable, "-c", SCRIPT.format(
            root=str(pbench_tiny.ROOT),
            tests=str(pbench_tiny.ROOT / "port_bench" / "tests"))],
        capture_output=True, text=True, timeout=600,
        env={"PATH": "/usr/bin:/bin", "HOME": str(pbench_tiny.ROOT)})
    assert out.returncode == 0, out.stderr[-3000:]
    assert out.stdout.strip().splitlines()[-1] == "[]"
