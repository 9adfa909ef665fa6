"""Shared CLI plumbing of the port's training entry points (the
counterpart of ``scripts/training/common.py``).

Each entry point is a thin wrapper over :func:`run_training`: the same
cohort rules, hyperparameter defaults and artifacts as the JAX scripts
(``results/<model>/cv_results.json`` and ``models/<model>/fold_K_best.pt``
with its ``.meta.json``), with flags instead of edited constants.

The CLI pins the precision policy of the process
(``utils.device.pin_fp32_policy``: TF32 off for cuDNN and for matmuls, so
convolutions and products run in true fp32 as the JAX reference computes
them) and logs both flags. Library functions set no global flags.

``--fold-parallel 1`` trains every fold in one vmapped step
(``train/cv_parallel.py``), ``--streaming`` keeps the cohort on the host
(either driver), ``--remat`` recomputes the DenseNet dense layers in the
backward (either driver) and ``--profile-dir`` traces a sequential run
(``utils/profiling.py``).

Multi-device runs (``parallel/``; one process a device):
  * ``--mesh N [--tp M] [--sharded-risk-set]`` trains on an (N/M, M)
    mesh. Without a process group the CLI starts the N ranks itself
    (``torch.multiprocessing.spawn``, a ``FileStore`` rendezvous under
    ``--results-dir``): one a GPU under NCCL, or gloo ranks with
    ``--device cpu``. With N = 1, or inside a group that already exists, it
    runs in this process.
  * ``--fold-parallel N [--fold-dp M]`` (N > 1) trains the folds on a
    fold mesh of N ranks: N/M fold rows, each training its block of folds
    in one vmapped step, data-parallel over its M ranks
    (``train/cv_parallel.py:make_fold_mesh``). Without a process group the
    CLI starts the N ranks as ``--mesh`` does; inside one it runs in this
    process.
  * ``--multihost`` joins a group from ``--coordinator``/
    ``--num-processes``/``--process-id`` or from torchrun's environment
    (``RANK``, ``WORLD_SIZE``, ``MASTER_ADDR``, ``MASTER_PORT``) and
    trains on one mesh over every rank of every host; run the same command
    in every process.
Every rank builds the same cohort (a ``--synthetic`` one is written once,
by the CLI's process or the coordinator, and read by the ranks); rank 0
writes the artifacts and prints the summary.

``--aot-cache DIR`` routes the run's kernel builds through the
kernel-build cache (``io/aot_cache.py``): the first run compiles its
libraries into DIR, later runs load them; the coordinator prints each
library's provenance. ``--device`` (default ``cuda``) is the port's own.
"""

from __future__ import annotations

import argparse
import contextlib
import dataclasses
import json
import logging
import os
from pathlib import Path

import torch
import torch.distributed as dist

from ..data.matching_table import load_matching_table
from ..io import aot_cache
from ..data.synthetic import SyntheticCohortSpec, generate_synthetic_cohort
from ..parallel.mesh import best_mesh_shape, make_mesh
from ..parallel.multihost import (
    backend_for,
    barrier,
    initialize_distributed,
    is_coordinator,
    local_cuda_device,
    make_global_mesh,
)
from ..utils import parse_hu_window
from ..utils.device import pin_fp32_policy, resolve_device
from .cv import run_cross_validation
from .cv_parallel import make_fold_mesh, run_cross_validation_parallel

log = logging.getLogger(__name__)

def base_parser(desc: str) -> argparse.ArgumentParser:
    p = argparse.ArgumentParser(description=desc)
    p.add_argument("--data-root", default=".",
                   help="root containing data/processed/full_matching_table.csv")
    p.add_argument("--results-dir", default="results")
    p.add_argument("--models-dir", default="models")
    p.add_argument("--epochs", type=int, default=None)
    p.add_argument("--n-folds", type=int, default=None)
    p.add_argument("--batch-size", type=int, default=None)
    p.add_argument("--learning-rate", type=float, default=None)
    p.add_argument("--seed", type=int, default=None)
    p.add_argument("--backbone", default="densenet121",
                   choices=["densenet121", "simple_cnn", "swin_vit"],
                   help="CT encoder: densenet121 (MONAI DenseNet121-3D, the "
                        "reference's), simple_cnn (the reference's "
                        "MONAI-less fallback) or swin_vit (MONAI "
                        "SwinUNETR's Swin-ViT encoder, arXiv:2201.01266, "
                        "float32 only; published for --image-shape "
                        "96,96,96)")
    p.add_argument("--synthetic", action="store_true",
                   help="generate & train on a synthetic cohort under "
                        "--data-root (no TCGA data)")
    p.add_argument("--synthetic-patients", type=int, default=64)
    p.add_argument("--image-shape", default=None,
                   help="D,H,W for the CT training tensor (default 64,64,32)")
    p.add_argument("--pallas-resample", action="store_true",
                   help="resample every CT with the CUDA W-pass kernel (the "
                        "JAX flag's name, kept)")
    p.add_argument("--hu-window", default=None,
                   help="CT Hounsfield window 'lo,hi' (use the = form for "
                        "negative bounds: --hu-window=-150,250) applied "
                        "before normalization")
    p.add_argument("--ties", default=None, choices=["breslow", "efron"],
                   help="Cox ties handling (default breslow = reference "
                        "parity)")
    p.add_argument("--resume", action="store_true",
                   help="checkpoint the full train state periodically and "
                        "resume an interrupted CV run")
    p.add_argument("--checkpoint-every", type=int, default=10)
    p.add_argument("--stage1-epochs", type=int, default=None,
                   help="SimMLM's expert-pretraining epochs (two-stage "
                        "models only)")
    p.add_argument("--bf16", action="store_true",
                   help="bfloat16 compute dtype for every layer of the model "
                        "(parameters, optimizer state and checkpoints stay "
                        "float32)")
    p.add_argument("--device", default="cuda",
                   help="where to train: cuda (default) or cpu")
    p.add_argument("--mesh", type=int, default=0,
                   help="train on an N-device data-parallel mesh (0 = one "
                        "device; N ranks, started here unless a process "
                        "group exists)")
    p.add_argument("--tp", type=int, default=1,
                   help="tensor-parallel factor within the mesh (wide RNA "
                        "layers column-parallel over the 'model' axis)")
    p.add_argument("--sharded-risk-set", action="store_true",
                   help="with --mesh N: the train Cox loss through the "
                        "sharded risk-set prefix scan "
                        "(ops/cox_distributed.py); Breslow and Efron ties")
    p.add_argument("--multihost", action="store_true",
                   help="join a multi-process run (--coordinator/"
                        "--num-processes/--process-id, or torchrun's "
                        "environment) and train on one mesh over every "
                        "rank; run the same command in every process")
    p.add_argument("--coordinator", default=None, metavar="HOST:PORT",
                   help="with --multihost: rank 0's rendezvous address")
    p.add_argument("--num-processes", type=int, default=None,
                   help="with --multihost: the number of processes")
    p.add_argument("--process-id", type=int, default=None,
                   help="with --multihost: this process's rank")
    p.add_argument("--fold-parallel", type=int, default=0,
                   help="train all folds in one vmapped step: on one device "
                        "(1), or spread over a fold mesh of N devices (N "
                        "ranks, started here unless a process group "
                        "exists)")
    p.add_argument("--fold-dp", type=int, default=1,
                   help="data parallelism inside each fold of a "
                        "--fold-parallel N mesh (N/M folds rows x M-way DP)")
    p.add_argument("--remat", action="store_true",
                   help="recompute each DenseNet dense layer in the "
                        "backward instead of keeping its activations")
    p.add_argument("--profile-dir", default=None,
                   help="write a torch.profiler trace of the CV run (ingest "
                        "and folds) into this directory")
    p.add_argument("--streaming", action="store_true",
                   help="keep the cohort on the host and prefetch each "
                        "batch to the device (pinned memory, a side stream)")
    p.add_argument("--aot-cache", default=None, metavar="DIR",
                   help="build and load the kernel libraries through the "
                        "kernel-build cache in DIR (io/aot_cache.py): a "
                        "later run on the same source, toolchain and card "
                        "loads them instead of compiling; results "
                        "unchanged (a failed load rebuilds)")
    return p


def run_training(args, cfg):
    """Train ``cfg`` under K-fold CV as the parsed ``args`` say; returns the
    cv_results payload (rank 0's on a mesh)."""
    logging.basicConfig(level=logging.INFO,
                        format="%(asctime)s %(levelname)s %(message)s")
    _validate(args, cfg)
    if args.multihost:
        initialize_distributed(args.coordinator, args.num_processes,
                               args.process_id, device=args.device)
        table, rnaseq_csv = _load_cohort_once(args, cfg)
        mesh = make_global_mesh(model_parallel=args.tp, device=args.device)
        return _train(args, cfg, table, rnaseq_csv, mesh=mesh)
    ranks = max(args.mesh, args.fold_parallel)
    if ranks > 1 and not dist.is_initialized():
        table, rnaseq_csv = load_cohort(args, _with_overrides(args, cfg))
        return spawn_ranks(ranks, args.device, args.results_dir,
                           _train_on_rank, args, cfg, table, rnaseq_csv)
    with (_group_of_one(args) if args.mesh == 1 and not dist.is_initialized()
          else contextlib.nullcontext()):
        table, rnaseq_csv = _load_cohort_once(args, cfg)
        return _train_on_rank(args.device, args, cfg, table, rnaseq_csv)


def _train_on_rank(device, args, cfg, table, rnaseq_csv):
    """:func:`_train` on this process's ``device`` with the meshes that
    ``--mesh``/``--tp`` or ``--fold-parallel``/``--fold-dp`` ask for
    (module level: the spawned ranks run it)."""
    args = argparse.Namespace(**{**vars(args), "device": str(device)})
    mesh = (make_mesh(args.mesh, args.tp, device=device)
            if args.mesh else None)
    fold_mesh = (make_fold_mesh(args.fold_parallel,
                                data_parallel=args.fold_dp, device=device)
                 if args.fold_parallel > 1 else None)
    return _train(args, cfg, table, rnaseq_csv, mesh=mesh,
                  fold_mesh=fold_mesh)


def _validate(args, cfg):
    """The JAX scripts' usage errors, before anything is built."""
    if args.multihost and (args.mesh or args.fold_parallel):
        raise SystemExit(
            "--multihost builds its own global mesh over every device of "
            "every host; drop --mesh/--fold-parallel (--tp still selects "
            "tensor parallelism inside it)")
    if args.fold_dp > 1 and args.fold_parallel <= 1:
        # the inner 'data' axis only exists on a fold-parallel mesh
        raise SystemExit(
            "--fold-dp needs --fold-parallel N with N > 1 (N total devices "
            "= N/M folds x M-way DP); use --mesh M for plain data "
            "parallelism with the sequential driver")
    if args.fold_parallel and (args.mesh or args.tp > 1 or args.resume
                               or args.profile_dir
                               or args.sharded_risk_set):
        raise SystemExit(
            "--fold-parallel is mutually exclusive with --mesh/--tp/"
            "--resume/--profile-dir/--sharded-risk-set "
            "(use the sequential driver for those). --streaming DOES "
            "compose: host-resident cohort, stacked per-step batches "
            "(train/cv_parallel.py module docstring)")
    if args.backbone == "swin_vit":
        refused = [flag for flag, on in (("--bf16", args.bf16),
                                         ("--remat", args.remat),
                                         ("--tp > 1", args.tp > 1)) if on]
        if refused:
            raise SystemExit(
                f"--backbone swin_vit does not take {', '.join(refused)}: "
                "the Swin-ViT encoder runs in float32 on one device's "
                "weights, without remat (nor fused_bn1, which no CLI sets)")
    if args.stage1_epochs is not None and not cfg.stage1_epochs:
        raise SystemExit(
            f"--stage1-epochs only applies to two-stage models (SimMLM); "
            f"'{cfg.name}' has no stage 1")
    if args.sharded_risk_set and not (args.mesh or args.multihost):
        raise ValueError("sharded_risk_set requires a mesh")
    if args.mesh:
        best_mesh_shape(args.mesh, args.tp)
    if args.fold_parallel > 1 and args.fold_parallel % args.fold_dp:
        raise ValueError(f"{args.fold_parallel} devices not divisible by "
                         f"data={args.fold_dp}")
    for flag, ranks in (("--mesh", args.mesh),
                        ("--fold-parallel", args.fold_parallel)):
        if ranks > 1 and not dist.is_initialized():
            check_ranks_fit(ranks, args.device, flag)


def check_ranks_fit(ranks: int, device, flag: str):
    """``flag N`` starts N local ranks, one a GPU under NCCL: raise where
    this host has fewer GPUs."""
    if (resolve_device(device).type == "cuda"
            and ranks > torch.cuda.device_count()):
        raise ValueError(
            f"{flag} {ranks} needs {ranks} GPUs, one a rank (NCCL puts no "
            f"two ranks on one GPU); this host has "
            f"{torch.cuda.device_count()}")


def _with_overrides(args, cfg):
    return dataclasses.replace(cfg, **{k: v for k, v in dict(
        num_epochs=args.epochs, n_folds=args.n_folds,
        batch_size=args.batch_size, learning_rate=args.learning_rate,
        seed=args.seed, stage1_epochs=args.stage1_epochs, ties=args.ties,
        image_shape=(tuple(int(x) for x in args.image_shape.split(","))
                     if args.image_shape else None),
    ).items() if v is not None})


def _load_cohort_once(args, cfg):
    """:func:`load_cohort` for every rank of a group: a synthetic cohort is
    written by the coordinator alone, and after a barrier every rank reads
    the files it wrote."""
    if not (args.synthetic and dist.is_initialized()
            and dist.get_world_size() > 1):
        return load_cohort(args, _with_overrides(args, cfg))
    if is_coordinator():
        load_cohort(args, _with_overrides(args, cfg))
    barrier("synthetic-cohort")
    return load_cohort(argparse.Namespace(**{**vars(args),
                                             "synthetic": False}),
                       _with_overrides(args, cfg))


@contextlib.contextmanager
def _group_of_one(args):
    """A process group of this process alone (``--mesh 1``), over a
    ``FileStore`` under ``--results-dir``."""
    store = _store_path(args.results_dir)
    initialize_distributed(init_method=f"file://{store}", num_processes=1,
                           process_id=0, device=args.device)
    try:
        yield
    finally:
        dist.destroy_process_group()
        store.unlink(missing_ok=True)


def _store_path(results_dir) -> Path:
    results = Path(results_dir).resolve()
    results.mkdir(parents=True, exist_ok=True)
    store = results / f".rendezvous-{os.getpid()}"
    store.unlink(missing_ok=True)
    return store


def spawn_ranks(nprocs: int, device, results_dir, target, *target_args):
    """``target(rank_device, *target_args)`` on ``nprocs`` local ranks of a
    new process group (``torch.multiprocessing.spawn``, a ``FileStore``
    under ``results_dir``): one a GPU under NCCL, or gloo CPU ranks for
    ``device="cpu"``. ``target`` must be a module-level function (spawn
    pickles it) whose result JSON can hold; returns rank 0's."""
    import torch.multiprocessing as mp

    store = _store_path(results_dir)
    result = store.with_name(store.name + ".payload.json")
    try:
        mp.spawn(_rank_main, nprocs=nprocs, join=True,
                 args=(nprocs, str(device), str(store), str(result), target,
                       target_args))
        return json.loads(result.read_text())
    finally:
        store.unlink(missing_ok=True)
        result.unlink(missing_ok=True)


def _rank_main(rank, nprocs, device, store, result, target, target_args):
    """One rank of :func:`spawn_ranks` (module level: spawn pickles it)."""
    logging.basicConfig(level=logging.INFO,
                        format=f"%(asctime)s rank {rank} %(levelname)s "
                               "%(message)s")
    if backend_for(device) == "gloo":
        # CPU ranks share the host's cores
        torch.set_num_threads(max(1, (os.cpu_count() or 1) // nprocs))
    rank_device = (local_cuda_device(rank) if backend_for(device) == "nccl"
                   else device)
    initialize_distributed(init_method=f"file://{store}",
                           num_processes=nprocs, process_id=rank,
                           device=device)
    try:
        out = target(str(rank_device), *target_args)
        if rank == 0:
            Path(result).write_text(json.dumps(out))
    finally:
        dist.destroy_process_group()


def _train(args, cfg, table, rnaseq_csv, mesh=None, fold_mesh=None):
    """The CV run itself, on one rank (or one device); the coordinator
    prints the summary."""
    log.info(pin_fp32_policy())
    cfg = _with_overrides(args, cfg)
    common = dict(
        rnaseq_csv=rnaseq_csv, results_dir=args.results_dir,
        models_dir=args.models_dir, backbone=args.backbone,
        dtype=torch.bfloat16 if args.bf16 else None,
        use_pallas_resample=args.pallas_resample,
        hu_window=parse_hu_window(args.hu_window), streaming=args.streaming,
        remat=args.remat, aot_cache_dir=args.aot_cache, device=args.device)
    if args.fold_parallel:
        payload, outcomes = run_cross_validation_parallel(
            cfg, table, mesh=fold_mesh, **common)
        title = f"{cfg.display_name} (fold-parallel)"
    else:
        payload, outcomes = run_cross_validation(
            cfg, table, mesh=mesh, tensor_parallel=args.tp > 1,
            sharded_risk_set=args.sharded_risk_set, resume=args.resume,
            checkpoint_every=args.checkpoint_every,
            profile_dir=args.profile_dir, **common)
        title = cfg.display_name
    if is_coordinator():
        print(f"\n{title}: C-index "
              f"{payload['c_index_mean']:.4f} ± {payload['c_index_std']:.4f}")
        for o in outcomes:
            print(f"  fold {o.fold}: best {o.best_c_index:.4f} "
                  f"@ epoch {o.best_epoch} ({o.epochs_run} epochs run)")
        if args.aot_cache:
            print("aot-cache " + (", ".join(
                f"{k}: {v['source']}" for k, v in aot_cache.report().items())
                or "(no kernel library loaded)"))
    return payload


def load_cohort(args, cfg, final_table: bool = True):
    """``(table, rnaseq_csv)`` as the parsed ``args`` say: a synthetic
    cohort written under ``--data-root``, or the matching table and RNA
    matrix under ``<data-root>/data/processed`` (final_multimodal's own
    table when ``final_table`` and it exists)."""
    root = Path(args.data_root)
    if args.synthetic:
        table, paths = generate_synthetic_cohort(
            root, SyntheticCohortSpec(n_patients=args.synthetic_patients))
        rnaseq_csv = paths["rnaseq_csv"]
    else:
        table_csv = root / "data" / "processed" / "full_matching_table.csv"
        if final_table and cfg.name == "final":
            # final_multimodal reads the 109-patient table while every other
            # trainer reads the 608-patient one (reference
            # final_multimodal.py:205, SURVEY §2.13)
            mm = root / "data" / "processed" / "multimodal_matching_table.csv"
            if mm.exists():
                table_csv = mm
        table = load_matching_table(table_csv)
        rnaseq_csv = root / "data" / "processed" / "rnaseq_normalized_mapped.csv"
        if not rnaseq_csv.exists():
            rnaseq_csv = None
    return table, rnaseq_csv
