"""Finds every piece of a cell by its name: the cell's entry in
``BENCHMARK.json`` names a configuration (``configs[].file``) and a traffic
mix (``traffic/<traffic>.json``, whose ``driver`` names the general
generator in ``drivers/``); the configuration's ``family`` names how the
program is built (``programs/<family>.py``) and its plain reference
(``reference/families/<family>.py``); the per-layer metrics that list the
cell are read by ``metrics/<metric>.py``; the limits of the comparison that
decides ``correct`` are ``limits/<cell>.json``. Adding a cell, a mix, a
configuration, a family or a metric adds files; none of these is edited."""

from __future__ import annotations

import importlib.util
import json
import sys
from pathlib import Path

BENCH = Path(__file__).resolve().parents[1]  # port_bench/
ROOT = BENCH.parent  # the checkout
FORBIDDEN = ("jax", "jaxlib", "flax", "optax",
             "multimodal_survival_prediction_tpu")


class Cell:
    def __init__(self, name: str, root: Path = ROOT):
        bench = json.loads((root / "BENCHMARK.json").read_text())
        cells = {w["name"]: w for w in bench["workloads"]}
        if name not in cells:
            raise KeyError(f"no workload {name!r} in BENCHMARK.json; "
                           f"known: {sorted(cells)}")
        self.name = name
        self.entry = cells[name]
        self.chips = int(self.entry["chips"])
        configs = {c["name"]: c for c in bench["configs"]}
        self.config_entry = configs[self.entry["config"]]
        self.config = json.loads(
            (root / self.config_entry["file"]).read_text())
        self.traffic_name = self.entry["traffic"]
        self.traffic = load_traffic(self.traffic_name)
        self.end_to_end = [m for m in bench["end_to_end"]
                           if name in m.get("workloads", [name])]
        self.per_layer = [m for m in bench["per_layer"]
                          if _reports(m, name, self.end_to_end)]
        self.limits = load_limits(name)


def _reports(metric: dict, cell: str, end_to_end: list) -> bool:
    if "workloads" in metric:
        return cell in metric["workloads"]
    return metric["moves"] in {m["name"] for m in end_to_end}


def load_traffic(name: str) -> dict:
    return json.loads((BENCH / "traffic" / f"{name}.json").read_text())


def load_limits(cell: str) -> dict:
    """``{number: limit}`` of the cell's comparison."""
    raw = json.loads((BENCH / "limits" / f"{cell}.json").read_text())
    return {k: float(v["limit"]) for k, v in raw["numbers"].items()}


def load_driver(name: str):
    return _load(BENCH / "drivers" / f"{name}.py", f"port_bench_driver_{name}")


def load_program(family: str):
    """How the program under test is built for a model family:
    ``programs/<family>.py``'s ``model(cfg, generator)``."""
    return _load(BENCH / "programs" / f"{family}.py",
                 f"port_bench_program_{family}")


def load_metric(name: str):
    """The reader of per-layer metric ``name``: ``metrics/<name>.py``'s
    ``read(run)``, which returns a number or None (nothing to read)."""
    return _load(BENCH / "metrics" / f"{name}.py",
                 "port_bench_metric_" + name.replace(".", "_")).read


def _load(path: Path, module_name: str):
    spec = importlib.util.spec_from_file_location(module_name, path)
    if spec is None or spec.loader is None:
        raise FileNotFoundError(path)
    mod = importlib.util.module_from_spec(spec)
    sys.modules[module_name] = mod
    spec.loader.exec_module(mod)
    return mod


def forbidden_modules(modules) -> list:
    """The loaded modules whose top-level name (the part before the first
    dot, compared whole) is JAX's, flax's, optax's or the JAX package's."""
    return sorted({m for m in modules if m.split(".")[0] in FORBIDDEN})
