"""The port's import boundary: ``multimodal_survival_prediction_tpu_torch``
and ``chip_smoke.py`` import neither JAX (``jax``, ``flax``, ``optax``) nor
the JAX package ``multimodal_survival_prediction_tpu``, and nothing outside
torch, numpy, scipy and the standard library — the machine with the card
has no pandas, msgpack, matplotlib, flax or nibabel (the fold-checkpoint
codec ``io/msgpack.py`` is the port's own)."""

import ast
import json
import subprocess
import sys
from pathlib import Path

import pytest

ROOT = Path(__file__).resolve().parents[1]
PORT = ROOT / "multimodal_survival_prediction_tpu_torch"
FORBIDDEN = {"jax", "jaxlib", "flax", "optax", "msgpack", "pandas",
             "matplotlib", "multimodal_survival_prediction_tpu"}
ALLOWED = {"torch", "numpy", "scipy",
           "multimodal_survival_prediction_tpu_torch"}
SOURCES = sorted(PORT.rglob("*.py")) + [ROOT / "chip_smoke.py"]


def _top_level_imports(path: Path) -> set:
    names = set()
    for node in ast.walk(ast.parse(path.read_text(), str(path))):
        if isinstance(node, ast.Import):
            names.update(a.name.split(".")[0] for a in node.names)
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            names.add(node.module.split(".")[0])
    return names


@pytest.mark.parametrize("path", SOURCES,
                         ids=[str(p.relative_to(ROOT)) for p in SOURCES])
def test_source_imports_stay_inside_the_boundary(path):
    names = _top_level_imports(path)
    assert not names & FORBIDDEN, f"{path.name} imports {names & FORBIDDEN}"
    outside = {n for n in names - ALLOWED
               if n not in sys.stdlib_module_names}
    assert not outside, f"{path.name} imports {outside}"


def test_whole_port_imports_without_jax():
    """Import every module of the port in a fresh interpreter (no test
    conftest); none of them may pull in JAX or the JAX package."""
    code = (
        "import importlib, json, pkgutil, sys\n"
        "import multimodal_survival_prediction_tpu_torch as p\n"
        "mods = [m.name for m in pkgutil.walk_packages(p.__path__, "
        "p.__name__ + '.')]\n"
        "for m in mods: importlib.import_module(m)\n"
        "bad = sorted(k for k in sys.modules if k.split('.')[0] in "
        f"{tuple(sorted(FORBIDDEN))!r})\n"
        "print(json.dumps({'modules': mods, 'bad': bad}))\n")
    proc = subprocess.run([sys.executable, "-c", code], cwd=ROOT,
                          capture_output=True, text=True, timeout=300,
                          check=False)
    assert proc.returncode == 0, proc.stderr
    out = json.loads(proc.stdout.strip().splitlines()[-1])
    assert out["bad"] == []
    for mod in ("serving", "ops.resample", "ops.fused_dense", "ops.cindex",
                "train.engine", "io.msgpack", "io.torch_import", "ops.km",
                "analysis.evaluate", "analysis.generate_km_curves",
                "analysis.evaluate_model", "tools.convert_torch_checkpoint",
                "tools.export_torch_checkpoint", "tools.calibrate",
                "train.cv_parallel", "train.sweep", "data.pipeline"):
        assert f"multimodal_survival_prediction_tpu_torch.{mod}" in \
            out["modules"]
