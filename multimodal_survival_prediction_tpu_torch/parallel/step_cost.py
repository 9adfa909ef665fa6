"""Where the host time of a step on the mesh goes, on one card.

    python -m multimodal_survival_prediction_tpu_torch.parallel.step_cost \\
        [--epochs 6] [--json chiprun_out/step_cost.json]

trains the CV driver's ``partial_modality`` model (DenseNet121-3D at
64x64x32, 5,005 genes, batch 8, as phase 9 of ``chip_smoke.py`` trains it)
on 12 seeded synthetic rows: epochs of 2 steps, each followed by an
evaluation as the CV driver runs it. Each variant runs in a process of its
own, in this order:

  ``one``            one device, no process group;
  ``mesh``           the mesh of one (NCCL at world size 1) with the sharded
                     risk set, as ``--mesh 1 --sharded-risk-set`` trains;
  ``mesh_inplace``   the same with every all-reduce in place (no clone);
  ``mesh_skip``      the same with no collective launched at all (each
                     returns its input, which world size 1 allows): the
                     mesh path's other host work;
  ``mesh_norecord``  ``mesh`` under ``TORCH_NCCL_AVOID_RECORD_STREAMS=1``;
  ``mesh_trace``     ``mesh`` with NCCL's flight recorder on
                     (``TORCH_NCCL_TRACE_BUFFER_SIZE=2000``; the port turns
                     it off unless the environment sets it);
  ``mesh_nomonitor`` ``mesh`` under ``TORCH_NCCL_ENABLE_MONITORING=0``;
  ``mesh_switch``    ``mesh`` with Python's thread switch interval at 0.5 ms
                     (5 ms by default): a thread that waits for the GIL
                     waits less;
  ``mesh_nogc``      ``mesh`` with Python's garbage collector off for the
                     timed epochs;

then ``mesh`` and ``one`` again, so that a drift of the host shows. For each
epoch a variant reports ms/step by CUDA events, host ms/step, the host ms a
step spent inside ``torch.distributed`` calls and their number, the
garbage collector's pauses, the caching allocator's ``cudaMalloc`` calls
and the evaluation's wall; then two more epochs under ``torch.profiler``
(CPU activity) and the ops with the most self host time. The medians over
epochs 2 and later are printed, one line a variant, and written to
``--json``. ``--device cpu`` (gloo) with ``--image-shape``/``--rna-dim``
rehearses it at a small size.
"""

from __future__ import annotations

import argparse
import gc
import json
import os
import statistics
import subprocess
import sys
import tempfile
import time

VARIANTS = {  # name: (mesh, extra environment)
    "one": (False, {}),
    "mesh": (True, {}),
    "mesh_inplace": (True, {}),
    "mesh_skip": (True, {}),
    "mesh_norecord": (True, {"TORCH_NCCL_AVOID_RECORD_STREAMS": "1"}),
    "mesh_trace": (True, {"TORCH_NCCL_TRACE_BUFFER_SIZE": "2000"}),
    "mesh_nomonitor": (True, {"TORCH_NCCL_ENABLE_MONITORING": "0"}),
    "mesh_switch": (True, {}),
    "mesh_nogc": (True, {}),
}
ORDER = (*VARIANTS, "mesh", "one")
ROWS = 12


def _patch_collectives(variant: str) -> None:
    """``mesh_inplace``: all-reduces write their input; ``mesh_skip``: no
    collective is launched (world size 1: the result is the input)."""
    import torch

    from ..ops import cox_distributed
    from ..train import engine
    from . import collectives

    users = (collectives, cox_distributed, engine)  # each imports the names

    if variant == "mesh_inplace":
        def all_reduce_tensor(x, group):
            x = x.contiguous()
            torch.distributed.all_reduce(x, group=group)
            collectives.counter.calls += 1
            return x
    elif variant == "mesh_skip":
        def all_reduce_tensor(x, group):
            collectives.counter.calls += 1
            return x.contiguous().clone()

        def all_gather_tensor(x, group, dim=0):
            collectives.counter.calls += 1
            return x.contiguous().clone()

        for m in users:
            m.all_gather_tensor = all_gather_tensor
    else:
        return
    for m in users:
        m.all_reduce_tensor = all_reduce_tensor


class _HostClock:
    """Host seconds inside ``torch.distributed``'s collectives, and their
    number, and the garbage collector's pauses."""

    def __init__(self):
        import torch.distributed as dist

        self.coll_s = self.gc_s = 0.0
        self.coll_n = self.gc_n = 0
        for name in ("all_reduce", "all_gather"):
            setattr(dist, name, self._timed(getattr(dist, name)))
        self._gc_t0 = None
        gc.callbacks.append(self._gc)

    def _timed(self, fn):
        def call(*a, **k):
            t0 = time.perf_counter()
            try:
                return fn(*a, **k)
            finally:
                self.coll_s += time.perf_counter() - t0
                self.coll_n += 1
        return call

    def _gc(self, phase, info):
        if phase == "start":
            self._gc_t0 = time.perf_counter()
        elif self._gc_t0 is not None:
            self.gc_s += time.perf_counter() - self._gc_t0
            self.gc_n += 1

    def reset(self):
        self.coll_s = self.gc_s = 0.0
        self.coll_n = self.gc_n = 0


def _child(args) -> dict:
    """One variant in this process; returns its epochs and host profile."""
    import numpy as np
    import torch

    from ..config import PARTIAL_MODALITY as CFG
    from ..train.cv import make_trainers
    from ..utils.device import pin_fp32_policy, resolve_device
    from .dryrun import example_batch
    from .mesh import make_mesh
    from .multihost import initialize_distributed

    variant = args.child
    if variant == "mesh_switch":
        sys.setswitchinterval(5e-4)
    device = resolve_device(args.device)
    pin_fp32_policy()
    on_mesh = VARIANTS[variant][0]
    clock = _HostClock()
    tmp = tempfile.mkdtemp()
    kw = {}
    if on_mesh:
        initialize_distributed(init_method=f"file://{tmp}/store",
                               num_processes=1, process_id=0,
                               device=str(device))
        _patch_collectives(variant)
        kw = dict(mesh=make_mesh(1, device=str(device)),
                  sharded_risk_set=True)
    shape = tuple(int(x) for x in args.image_shape.split(","))
    data = {k: torch.from_numpy(np.ascontiguousarray(v)).to(device)
            for k, v in example_batch(ROWS, shape, args.rna_dim).items()}
    trainer = make_trainers(CFG, args.rna_dim, args.backbone, None, device,
                            **kw)[0]
    state = trainer.init_state(fold=1)
    rows = np.arange(ROWS)
    cuda = device.type == "cuda"
    sync = torch.cuda.synchronize if cuda else (lambda: None)
    mem = ((lambda: torch.cuda.memory_stats(device).get(
        "num_device_alloc", 0)) if cuda else (lambda: 0))

    def epoch(i):
        rng = np.random.default_rng(i)
        sync()
        clock.reset()
        allocs, t0 = mem(), time.perf_counter()
        if cuda:
            ev = [torch.cuda.Event(enable_timing=True) for _ in range(2)]
            ev[0].record()
        nonlocal state
        state, _ = trainer.train_epoch(state, data, rows, rng,
                                       CFG.learning_rate)
        if cuda:
            ev[1].record()
        sync()
        host = time.perf_counter() - t0
        steps = len(trainer.step_losses)
        row = dict(steps=steps, host_ms_per_step=host * 1e3 / steps,
                   ms_per_step=(ev[0].elapsed_time(ev[1]) / steps
                                if cuda else None),
                   coll_ms_per_step=clock.coll_s * 1e3 / steps,
                   coll_per_step=clock.coll_n / steps,
                   gc_ms=clock.gc_s * 1e3, gc_n=clock.gc_n,
                   cuda_mallocs=mem() - allocs)
        t0 = time.perf_counter()
        trainer.evaluate(state, data, rows)
        sync()
        row["eval_ms"] = (time.perf_counter() - t0) * 1e3
        return row

    if variant == "mesh_nogc":
        epochs = [epoch(0)]
        gc.disable()
        epochs += [epoch(i) for i in range(1, args.epochs)]
        gc.enable()
    else:
        epochs = [epoch(i) for i in range(args.epochs)]
    from torch.profiler import ProfilerActivity, profile

    with profile(activities=[ProfilerActivity.CPU]) as prof:
        for i in range(2):
            epoch(args.epochs + i)
    ops = sorted(prof.key_averages(), key=lambda e: e.self_cpu_time_total,
                 reverse=True)[:args.top]
    top = [(e.key, e.self_cpu_time_total / 1e3 / 4, e.count / 4)
           for e in ops]  # per step: 2 epochs of 2 steps
    if on_mesh:
        torch.distributed.destroy_process_group()
    return dict(variant=variant, epochs=epochs, host_top_per_step=top)


def _median(rows, key):
    vals = [r[key] for r in rows[1:] if r[key] is not None]
    return statistics.median(vals) if vals else None


def main(argv=None) -> int:
    parser = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    parser.add_argument("--device", default="cuda")
    parser.add_argument("--epochs", type=int, default=6)
    parser.add_argument("--image-shape", default="64,64,32")
    parser.add_argument("--rna-dim", type=int, default=5005)
    parser.add_argument("--backbone", default="densenet121")
    parser.add_argument("--top", type=int, default=12)
    parser.add_argument("--variants", default=",".join(ORDER))
    parser.add_argument("--json", default=None)
    parser.add_argument("--child", default=None, help=argparse.SUPPRESS)
    args = parser.parse_args(argv)
    if args.child:
        print("STEP_COST " + json.dumps(_child(args)), flush=True)
        return 0
    runs = []
    for variant in args.variants.split(","):
        env = {**os.environ, **VARIANTS[variant][1]}
        argv_child = [sys.executable, "-m", __spec__.name, "--child",
                      variant, "--device", args.device, "--epochs",
                      str(args.epochs), "--image-shape", args.image_shape,
                      "--rna-dim", str(args.rna_dim), "--backbone",
                      args.backbone, "--top", str(args.top)]
        out = subprocess.run(argv_child, env=env, capture_output=True,
                             text=True, check=False)
        line = [x for x in out.stdout.splitlines()
                if x.startswith("STEP_COST ")]
        if out.returncode or not line:
            print(out.stdout[-4000:], out.stderr[-4000:], file=sys.stderr)
            raise SystemExit(f"variant {variant} failed "
                             f"(rc {out.returncode})")
        run = json.loads(line[-1][len("STEP_COST "):])
        runs.append(run)
        ep = run["epochs"]
        per_epoch = [round(e["ms_per_step"] or e["host_ms_per_step"], 2)
                     for e in ep]
        print(f"{variant}: ms/step {_median(ep, 'ms_per_step')} (CUDA "
              f"events), host {_median(ep, 'host_ms_per_step'):.2f} ms/step,"
              f" collectives {_median(ep, 'coll_per_step'):.0f} a step "
              f"taking {_median(ep, 'coll_ms_per_step'):.2f} ms of host "
              f"time, gc {_median(ep, 'gc_ms'):.2f} ms in "
              f"{_median(ep, 'gc_n'):.0f} pauses an epoch, cudaMalloc "
              f"{_median(ep, 'cuda_mallocs'):.0f} an epoch, eval "
              f"{_median(ep, 'eval_ms'):.1f} ms; epochs' ms/step "
              f"{per_epoch}",
              flush=True)
        print("  host profile a step: " + "; ".join(
            f"{k} {ms:.2f} ms x{n:.0f}"
            for k, ms, n in run["host_top_per_step"]), flush=True)
    if args.json:
        os.makedirs(os.path.dirname(os.path.abspath(args.json)),
                    exist_ok=True)
        with open(args.json, "w") as f:
            json.dump(runs, f, indent=1)
    return 0


if __name__ == "__main__":
    sys.exit(main())
