"""Times the design choices of the bf16 ``bwd_reduce`` and ``bwd_dx`` kernels
on the card, the numbers behind their design notes in
``csrc/fused_dense.cu``:

  * the ``wgmma`` core's ring depth: ``kStagesW`` 2 (the source's), 3 and 4,
    each a copy of the source rebuilt under ``build/bf16_bwd_sweep/``;
  * ``bwd_reduce``'s dW row chunks: the plan's, and other (chunks, cluster
    size) pairs at the same stage.

    python -m multimodal_survival_prediction_tpu_torch.ops.bf16_bwd_sweep

Needs one CUDA card and ``nvcc``. Prints the card's name and power limit,
then one line per (depth, stage): device microseconds a call
(``torch.profiler``, the median of three windows of 20 calls), the kernel
and the fold beside each other. Each depth runs in a process of its own (a
library is loaded once a process).
"""

from __future__ import annotations

import math
import re
import subprocess
import sys
from pathlib import Path

import torch

from . import _build
from . import fused_dense as fd

DEPTHS = (2, 3, 4)
# (n, c, f) -> the dW (chunks, cluster) pairs tried beside the plan's
STAGES = {(16384, 224, 128): [(16, 1), (32, 2), (64, 4)],
          (16384, 64, 128): [(16, 1), (64, 4), (128, 8)],
          (2048, 480, 128): [(2, 1), (8, 4), (16, 8)],
          (256, 992, 128): [(1, 1), (4, 4)],
          (256, 1024, 512): [(1, 1), (4, 4)],
          (32, 992, 128): [(1, 1)]}
_LINE = "constexpr int kStagesW = 2;"
_MODULE = "multimodal_survival_prediction_tpu_torch.ops.bf16_bwd_sweep"


def _device_us(fn, iters=20, windows=3):
    """(median total, {kernel name: us}) of device time a call."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    for _ in range(3):
        fn()
    torch.cuda.synchronize()
    runs = []
    for _ in range(windows):
        with profile(activities=[ProfilerActivity.CUDA]) as prof:
            torch.cuda._sleep(1 << 16)
            for _ in range(iters):
                fn()
            torch.cuda.synchronize()
        run = {}
        for e in prof.key_averages():
            if e.device_type == DeviceType.CUDA and "spin" not in e.key:
                name = re.search(r"(\w+)[<(]", e.key.split("::", 1)[-1])
                key = name.group(1) if name else e.key[:40]
                run[key] = run.get(key, 0.0) + e.self_device_time_total / iters
        runs.append(run)
    runs.sort(key=lambda r: sum(r.values()))
    mid = runs[len(runs) // 2]
    return sum(mid.values()), mid


def _inputs(n, c, f, gen):
    x = (torch.randn((n, c), generator=gen, device="cuda") * 2 + 0.5)
    gamma = torch.randn(c, generator=gen, device="cuda") * 0.3 + 1.0
    beta = torch.randn(c, generator=gen, device="cuda") * 0.1
    w = (torch.randn((f, c), generator=gen, device="cuda")
         * (2.0 / c) ** 0.5).t()
    g = torch.randn((n, f), generator=gen, device="cuda")
    x, w, g = (t.to(torch.bfloat16) for t in (x, w, g))
    mean, _, rstd, mul, add = fd._stats(x, gamma, beta, 1e-5)
    return x, w, g, (mul, add, mean, rstd)


def _run(depth: int):
    """Times every stage with the source at ring depth ``depth``."""
    if depth != 2:
        src = (_build.CSRC / "fused_dense.cu").read_text()
        if _LINE not in src:
            raise RuntimeError(f"fused_dense.cu no longer holds {_LINE!r}")
        out = _build.BUILD_ROOT.parent / "bf16_bwd_sweep" / f"stages{depth}"
        out.mkdir(parents=True, exist_ok=True)
        (out / "fused_dense.cu").write_text(src.replace(
            _LINE, f"constexpr int kStagesW = {depth};"))
        _build.CSRC = out
    gen = torch.Generator(device="cuda").manual_seed(0)
    plan_for = fd._plan_for
    for (n, c, f), tries in STAGES.items():
        x, w, g, (mul, add, mean, rstd) = _inputs(n, c, f, gen)
        vecs = (mul, add, mean, rstd, mean * 0.01, rstd * 0.01)
        plan = plan_for(x, f)
        dx_us, _ = _device_us(lambda: fd.bwd_dx(x, g, w, *vecs))
        cells = []
        for chunks, q in [(plan.dw_chunks, plan.dw_cluster), *tries]:
            rows = math.ceil(math.ceil(n / 64) / chunks) * 64
            chunks = math.ceil(n / rows)
            alt = plan._replace(
                dw_chunks=chunks, dw_rows_per_chunk=rows, dw_cluster=q,
                reduce_scratch=(math.ceil(chunks / q) * c * f
                                + math.ceil(n / 64) * plan.da_chunks * 2 * c))
            fd._plan_for = lambda *_, alt=alt: alt
            try:
                us, parts = _device_us(
                    lambda: fd.bwd_reduce(x, g, w, mul, add, mean, rstd))
            finally:
                fd._plan_for = plan_for
            cells.append(f"{chunks}x{rows} rows/Q{q} {us:.2f} ("
                         + " + ".join(f"{k} {v:.2f}" for k, v in
                                      parts.items()) + ")")
        print(f"kStagesW {depth} {n}x{c}->{f}: bwd_dx {dx_us:.2f} us; "
              f"bwd_reduce, plan first: " + "; ".join(cells), flush=True)


def main(argv=None) -> int:
    argv = sys.argv[1:] if argv is None else argv
    if not torch.cuda.is_available():
        print("bf16_bwd_sweep: needs a CUDA card", file=sys.stderr)
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
