"""Tiny cells for the CPU tests: the benchmark's configurations and mixes
with their sizes cut (DenseNet blocks (2, 2), 16^3 CTs, 64 genes, a
cohort of a few dozen, whose fold 0 trains 51 rows, so that the last
set-up step is ragged at batch 8), and a stand-in for ``registry.Cell``."""

from __future__ import annotations

import copy
import json
import sys
from pathlib import Path

ROOT = Path(__file__).resolve().parents[2]
if str(ROOT) not in sys.path:
    sys.path.insert(0, str(ROOT))

from port_bench.core import registry  # noqa: E402

TINY_PATTERNS = [[1, 1, 1, 1, 40], [1, 0, 1, 1, 4], [0, 1, 1, 1, 6],
                 [0, 0, 1, 1, 4], [1, 1, 1, 0, 3], [0, 1, 0, 0, 8],
                 [0, 0, 1, 0, 4]]


def tiny_config(name: str) -> dict:
    cfg = json.loads((registry.BENCH / "configs" / f"{name}.json").read_text())
    cfg = copy.deepcopy(cfg)
    cfg["arch"]["rna_dim"] = 64
    cfg["arch"]["image_shape"] = [16, 16, 16]
    cfg["arch"]["densenet"]["block_config"] = [2, 2]
    cfg["train"]["eval_batch_size"] = 8
    return cfg


def tiny_traffic(name: str, **over) -> dict:
    t = copy.deepcopy(registry.load_traffic(name))
    if "cohort" in t:
        t["cohort"]["patterns"] = TINY_PATTERNS
    t.update(over)
    return t


class TinyCell:
    def __init__(self, cell: str, config: str, traffic: str, limits=None,
                 per_layer=(), **traffic_over):
        self.name = cell
        self.chips = 1
        self.config = tiny_config(config)
        self.traffic = tiny_traffic(traffic, **traffic_over)
        self.limits = (registry.load_limits(cell) if limits is None
                       else limits)
        self.per_layer = list(per_layer)
