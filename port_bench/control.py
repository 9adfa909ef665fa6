"""Readings that the limits of a cell's comparison are set from.

    python3 port_bench/control.py --workload <cell> --seeds 1,2,3 \\
        [--control-seeds 4,5,6] [--out readings.jsonl]

The cell's driver gives the readings (``readings`` in
``drivers/<driver>.py``). For a training cell, for every seed of
``--seeds`` it runs the cell's set-up (the program's own path, as a
benchmark run does) and compares what the program produced with the
reference: the lower readings. For every seed of ``--control-seeds`` it
puts the reference in the program's place, computed one precision below the
configuration's (TF32 on for matmuls and cuDNN, where the configuration
states float32 with TF32 off), and again in float32 with each of the
faults planted: half of every batch left out (the mean taken over the
rest), every step returning its state unchanged, and, read beside them, a
ragged step's padded rows counted in its loss: the upper readings. All in
one process, so the set-up's fixed costs are paid once. Each reading is
one JSON line; the last line summarises, for every number, the largest
program reading and the smallest control and fault readings. Runs only on
a CUDA device.
"""

from __future__ import annotations

import argparse
import json
import sys
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seeds", default="")
    ap.add_argument("--control-seeds", default="")
    ap.add_argument("--out", default=None)
    args = ap.parse_args(argv)
    sys.path.insert(0, str(ROOT))
    from port_bench.core import device, registry

    cell = registry.Cell(args.workload, ROOT)
    device.require_cuda(cell.chips)
    seeds = [int(s) for s in args.seeds.split(",") if s]
    control_seeds = [int(s) for s in args.control_seeds.split(",") if s]
    rows = []
    out = open(args.out, "a") if args.out else None

    def emit(row):
        row["workload"] = cell.name
        rows.append(row)
        line = json.dumps(row)
        print(line, flush=True)
        if out:
            out.write(line + "\n")
            out.flush()

    kernel_cache = ROOT / "port_bench" / ".cache" / "kernels"
    driver = registry.load_driver(cell.traffic["driver"])
    try:
        driver.readings(cell, seeds, control_seeds, kernel_cache, emit)
    finally:
        if out:
            out.close()
    summary = {}
    for row in rows:
        for k, v in row["numbers"].items():
            s = summary.setdefault(k, {})
            key = "lower" if row["kind"] == "program" else row["kind"]
            s[key] = (max if key == "lower" else min)(s.get(key, v), v)
    print(json.dumps({"workload": cell.name, "summary": summary}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
