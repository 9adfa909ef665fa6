"""The result line and the comparison's numbers.

A driver returns a :class:`Result`; :func:`emit` prints the compared
numbers beside their limits as the last lines of standard error and the
result as the last line of standard output, the numbers again under its
last key, ``checks``."""

from __future__ import annotations

import json
import math
import sys
from dataclasses import dataclass, field


@dataclass
class Result:
    attempted: int
    failed: int
    metrics: dict  # name -> (value, unit)
    device: dict
    checks: dict  # name -> (value, limit)
    breakdown: dict | None = None
    notes: dict = field(default_factory=dict)

    @property
    def correct(self) -> bool:
        return bool(self.checks) and all(
            math.isfinite(v) and v <= lim for v, lim in self.checks.values())


def compare(numbers: dict, limits: dict) -> dict:
    """``{name: (value, limit)}`` for every number that has a limit; a
    number without one is a fault of the benchmark, not of the run."""
    missing = sorted(set(limits) - set(numbers))
    if missing:
        raise KeyError(f"no reading of compared numbers {missing}")
    return {k: (float(numbers[k]), float(limits[k])) for k in limits}


def per_layer(cell, run) -> dict:
    """Each per-layer metric of ``cell`` that its reader finds, by name."""
    from . import registry

    out = {}
    for m in cell.per_layer:
        value = registry.load_metric(m["name"])(run)
        if value is not None:
            out[m["name"]] = (float(value), m["unit"])
    return out


def emit(result: Result):
    for k, (v, lim) in result.checks.items():
        print(f"check {k}: {v!r} (limit {lim!r})", file=sys.stderr)
    print(f"correct: {result.correct}", file=sys.stderr)
    line = {
        "correct": result.correct,
        "attempted": int(result.attempted),
        "failed": int(result.failed),
        "metrics": {k: {"value": v, "unit": u}
                    for k, (v, u) in result.metrics.items()},
        "device": result.device,
    }
    if result.notes:
        line["notes"] = result.notes
    if result.breakdown is not None:
        line["breakdown"] = result.breakdown
    line["checks"] = {k: {"value": v if math.isfinite(v) else str(v),
                          "limit": lim}
                      for k, (v, lim) in result.checks.items()}
    sys.stderr.flush()
    print(json.dumps(line), flush=True)
