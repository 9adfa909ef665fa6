"""Run one cell of the port's benchmark once, on the machine it starts on.

    python3 port_bench/run.py --workload <cell> --seed <n> --seconds <s> \\
        --trace <0|1>

from the root of a checkout. The cell's entry in ``BENCHMARK.json`` names
its configuration and traffic mix; the mix names the driver that runs it
(``port_bench/drivers/``). With ``--trace 0`` the result's metrics are the
cell's end-to-end metrics, with ``--trace 1`` its per-layer metrics, read
by ``port_bench/metrics/<metric>.py`` from a profile of the window. The
last line of standard output is one JSON object; the numbers that decide
``correct`` are the last lines of standard error and the last key of that
object. Without a CUDA device, or with fewer than the cell asks for, the
run prints no result and exits 2.
"""

from __future__ import annotations

import time

T_START = time.perf_counter()  # set-up counts from here

import argparse  # noqa: E402
import os  # noqa: E402
import sys  # noqa: E402
from pathlib import Path  # noqa: E402

ROOT = Path(__file__).resolve().parents[1]
CACHE = ROOT / "port_bench" / ".cache"


def _pin_caches():
    """Every build and kernel cache in fixed directories of the checkout,
    so that only a cell's first run there compiles."""
    os.environ["TRITON_CACHE_DIR"] = str(CACHE / "triton")
    os.environ["TORCH_EXTENSIONS_DIR"] = str(CACHE / "torch_extensions")
    os.environ.setdefault("USE_FLAX", "0")


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--trace", type=int, choices=(0, 1), default=0)
    args = ap.parse_args(argv)
    _pin_caches()
    sys.path.insert(0, str(ROOT))
    from port_bench.core import device, registry, report

    cell = registry.Cell(args.workload, ROOT)
    try:
        device.require_cuda(cell.chips)
    except device.NoDevice as e:
        print(f"port_bench: {e}", file=sys.stderr)
        return 2
    driver = registry.load_driver(cell.traffic["driver"])
    result = driver.run(cell, seed=args.seed, seconds=args.seconds,
                        trace=bool(args.trace), t_start=T_START,
                        kernel_cache=CACHE / "kernels")
    found = registry.forbidden_modules(sys.modules)
    if found:
        print("port_bench: the run loaded JAX or the JAX package: "
              + ", ".join(found), file=sys.stderr)
        return 3
    report.emit(result)
    return 0


if __name__ == "__main__":
    sys.exit(main())
