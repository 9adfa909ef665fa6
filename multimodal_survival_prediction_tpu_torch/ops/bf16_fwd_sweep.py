"""Times the design choices of the bf16 ``moments`` and ``apply`` kernels on
the card, the numbers behind their design notes in ``csrc/fused_dense.cu``:

  * ``apply``'s block tile at the 16,384-row stages: the plan's 128x128
    (two warpgroups sharing W's tiles) against 64x64;
  * ``apply``'s channel chunks (one thread-block cluster of them a tile):
    the plan's, and 1, 2, 4 and 8 chunks of whole 64-deep steps;
  * the 64x64 ``apply`` block's ring depth (``kApplyStages``' split value):
    2 (the source's), 3 and 4, each a copy of the source rebuilt under
    ``build/bf16_fwd_sweep/``;
  * ``moments``' row chunk: 256, 512 and 1,024 rows a block, and the plan's
    (``fused_dense.moments_rows_bf16``).

    python -m multimodal_survival_prediction_tpu_torch.ops.bf16_fwd_sweep

Needs one CUDA card and ``nvcc``. Prints the card's name and power limit,
then one line per (depth, stage) for ``apply`` and one per stage for
``moments``: device microseconds a call (``torch.profiler``, the median of
three windows of 20 calls). Each depth runs in a process of its own (a
library is loaded once a process).
"""

from __future__ import annotations

import math
import subprocess
import sys
from pathlib import Path

import torch

from . import _build
from . import fused_dense as fd
from .bf16_bwd_sweep import _device_us, _inputs

DEPTHS = (2, 3, 4)
STAGES = [(16384, 224, 128), (16384, 64, 128), (2048, 480, 128),
          (2048, 288, 128), (2048, 512, 256), (256, 256, 128),
          (256, 992, 128), (256, 1024, 512), (32, 512, 128),
          (32, 992, 128)]
_LINE = "constexpr int kApplyStages = kApplySplits<kWG, kNH> ? 2 : 4;"
_MODULE = "multimodal_survival_prediction_tpu_torch.ops.bf16_fwd_sweep"


def _apply_plans(plan, n, c, f):
    """(label, plan): the plan's, then 64x64 tiles in 1, 2, 4 and 8 channel
    chunks (each a multiple of 64 channels, as many as C has steps)."""
    plans = [(f"plan {plan.apply_tile_rows}x{plan.apply_tile_cols} "
              f"{plan.apply_chunks}x{plan.apply_k_per_chunk}", plan)]
    steps = math.ceil(c / 64)
    for chunks in (1, 2, 4, 8):
        if chunks > steps:
            break
        k = math.ceil(steps / chunks) * 64
        chunks = math.ceil(c / k)
        alt = plan._replace(apply_tile_rows=64, apply_tile_cols=64,
                            apply_chunks=chunks, apply_k_per_chunk=k,
                            apply_cluster=chunks)
        if alt != plan:
            plans.append((f"64x64 {chunks}x{k}", alt))
    return plans


def _run(depth: int):
    """Times apply at every stage with the 64x64 ring at ``depth``, and at
    depth 2 the moments' row chunks too."""
    if depth != 2:
        src = (_build.CSRC / "fused_dense.cu").read_text()
        if _LINE not in src:
            raise RuntimeError(f"fused_dense.cu no longer holds {_LINE!r}")
        out = _build.BUILD_ROOT.parent / "bf16_fwd_sweep" / f"stages{depth}"
        out.mkdir(parents=True, exist_ok=True)
        (out / "fused_dense.cu").write_text(src.replace(
            _LINE, _LINE.replace("? 2 :", f"? {depth} :")))
        _build.CSRC = out
    gen = torch.Generator(device="cuda").manual_seed(0)
    plan_for, rows_for = fd._plan_for, fd.moments_rows_bf16
    for n, c, f in STAGES:
        x, w, _, (mul, add, _, _) = _inputs(n, c, f, gen)
        cells = []
        for label, alt in _apply_plans(plan_for(x, f), n, c, f):
            fd._plan_for = lambda *_, alt=alt: alt
            try:
                us, _ = _device_us(lambda: fd.apply(x, mul, add, w))
            finally:
                fd._plan_for = plan_for
            cells.append(f"{label} {us:.2f}")
        print(f"apply, 64x64 ring {depth}, {n}x{c}->{f}: "
              + "; ".join(cells), flush=True)
        if depth != 2:
            continue
        cells = []
        for rows in (256, 512, 1024):
            fd.moments_rows_bf16 = lambda *_, rows=rows: rows
            try:
                us, _ = _device_us(lambda: fd.moments(x))
            finally:
                fd.moments_rows_bf16 = rows_for
            cells.append(f"{rows} rows {us:.2f}")
        print(f"moments {n}x{c}: plan {rows_for(n, c, fd._sm_count(x.device))}"
              " rows; " + "; ".join(cells), flush=True)


def main(argv=None) -> int:
    argv = sys.argv[1:] if argv is None else argv
    if not torch.cuda.is_available():
        print("bf16_fwd_sweep: needs a CUDA card", file=sys.stderr)
        return 2
    if argv:
        _run(int(argv[0]))
        return 0
    print(subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True).stdout.strip(), flush=True)
    root = Path(__file__).resolve().parents[2]
    for depth in DEPTHS:
        subprocess.run([sys.executable, "-m", _MODULE, str(depth)],
                       cwd=root, check=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
