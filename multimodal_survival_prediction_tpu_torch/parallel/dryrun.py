"""The multi-device dry run (the port's counterpart of
``__graft_entry__.dryrun_multichip``).

    python -m multimodal_survival_prediction_tpu_torch.parallel.dryrun 4
    python -m multimodal_survival_prediction_tpu_torch.parallel.dryrun 4 \
        --device cpu

starts N ranks, one NCCL rank a GPU (the default; fewer than N visible
GPUs raise) or N gloo ranks on the CPU with ``--device cpu``, over a
``FileStore`` rendezvous in a temporary directory, and runs the flagship
``PartialModalityNet`` (DenseNet121-3D backbone at ``block_config=(2, 2)``,
32³ volumes, rna_dim 640 so that the RNA encoder's 640 -> 512 layer is
wide) on a DP x TP mesh of (N/2, 2) for N >= 4, else (N, 1), with 2 rows a
data rank: one Trainer step with the wide layers column-parallel, a check
that the RNA encoder's first weight is a column shard, and the
sharded-risk-set loss against the gathered one from the same weights,
batch and dropout masks. Inside a process group that already exists (of N
ranks) it runs in-process on that group instead.

:func:`dryrun_step` is the step itself, for a process group that already
exists; with ``mesh=None`` it is the single-device Trainer's step on the
same batch.
"""

from __future__ import annotations

import json
import logging
import os
import sys
import tempfile
from pathlib import Path

import numpy as np
import torch
import torch.distributed as dist

from ..config import PARTIAL_MODALITY as CFG
from ..models import PartialModalityNet
from ..train.adapters import make_adapters
from ..train.engine import TrainConfig, Trainer
from .mesh import make_mesh, mesh_shape
from ..utils.device import resolve_device
from .multihost import backend_for, initialize_distributed, local_cuda_device
from .sharding import shard_batch_dim, tp_group

IMAGE_SHAPE = (32, 32, 32)
RNA_DIM = 640
BLOCK_CONFIG = (2, 2)
ROWS_PER_RANK = 2
RNA_WIDE = "rna_encoder.0.weight"  # 640 -> 512: column-parallel under TP
LOSS_TOL = 1e-4  # sharded-risk-set vs gathered loss (JAX's dry run's)


def example_batch(batch: int, image_shape=IMAGE_SHAPE, rna_dim: int = RNA_DIM,
                  seed: int = 0) -> dict:
    """A seeded flagship batch of ``batch`` rows (numpy)."""
    rng = np.random.default_rng(seed)
    return {
        "image": rng.normal(size=(batch, *image_shape, 1)).astype("float32"),
        "rnaseq": rng.normal(size=(batch, rna_dim)).astype("float32"),
        "clinical": rng.uniform(0.3, 0.9, size=(batch, 1)).astype("float32"),
        "mask": (rng.uniform(size=(batch, 3)) < 0.8).astype("float32"),
        "time": rng.exponential(800.0, size=(batch,)).astype("float32"),
        "event": (rng.uniform(size=(batch,)) < 0.6).astype("float32"),
        "svalid": np.ones((batch,), "float32"),
        "valid": np.ones((batch,), "float32"),
    }


def _trainer(batch, device, mesh, sharded_risk_set=False) -> Trainer:
    batch_to_inputs, hazard_and_aux = make_adapters(CFG)
    tcfg = TrainConfig(batch_size=batch, learning_rate=CFG.learning_rate,
                       weight_decay=CFG.weight_decay, optimizer=CFG.optimizer,
                       grad_clip=CFG.grad_clip, seed=0)
    return Trainer(
        lambda g: PartialModalityNet(rna_dim=RNA_DIM,
                                     block_config=BLOCK_CONFIG, generator=g),
        batch_to_inputs, hazard_and_aux, tcfg, device=device, mesh=mesh,
        tensor_parallel=True, sharded_risk_set=sharded_risk_set)


def dryrun_step(mesh=None, device="cuda", batch: int | None = None) -> dict:
    """One Trainer step of the flagship on ``mesh`` (every rank of its
    group calls), and under a mesh the sharded-risk-set loss from the same
    initial state. ``batch`` (global rows) defaults to 2 a data rank.
    Returns ``{"mesh", "global_batch", "loss", "loss_sharded",
    "rna_weight_rows"}``; losses are floats (the whole batch's, equal on
    every rank)."""
    shape = mesh_shape(mesh)
    batch = batch or ROWS_PER_RANK * shape.get("data", 1)
    host = example_batch(batch)
    if mesh is not None:
        host = {k: shard_batch_dim(v, mesh) for k, v in host.items()}
    data = {k: torch.from_numpy(np.ascontiguousarray(v)).to(device)
            for k, v in host.items()}
    tr = _trainer(batch, device, mesh)
    state = tr.init_state(fold=0)
    weight = dict(state.model.named_parameters())[RNA_WIDE]
    if shape.get("model", 1) > 1 and tp_group(weight) is None:
        raise RuntimeError(f"{RNA_WIDE} is not a column shard under "
                           f"{shape}")
    loss_sharded = None
    if mesh is not None:
        sharded = _trainer(batch, device, mesh, sharded_risk_set=True)
        loss_sharded = float(sharded.loss_and_grads(
            sharded.init_state(fold=0), data)[0])
    loss = float(tr.train_step(state, data, CFG.learning_rate))
    if not np.isfinite(loss):
        raise RuntimeError(f"dry-run loss {loss}")
    if loss_sharded is not None and abs(loss_sharded - loss) > LOSS_TOL:
        raise RuntimeError(f"sharded-risk-set loss {loss_sharded} against "
                           f"the gathered loss {loss}")
    return {"mesh": shape, "global_batch": batch, "loss": loss,
            "loss_sharded": loss_sharded,
            "rna_weight_rows": int(weight.shape[0])}


def _model_parallel(n_devices: int) -> int:
    return 2 if n_devices >= 4 and n_devices % 2 == 0 else 1


def _rank(rank, n_devices, device, store, result):
    """One rank of :func:`dryrun_multichip` (module level: spawn pickles
    it)."""
    if backend_for(device) == "gloo":
        torch.set_num_threads(1)  # CPU ranks share the host's cores
    initialize_distributed(init_method=f"file://{store}",
                           num_processes=n_devices, process_id=rank,
                           device=device)
    try:
        out = dryrun_step(
            make_mesh(n_devices, _model_parallel(n_devices), device=device),
            device=(local_cuda_device(rank) if backend_for(device) == "nccl"
                    else device))
        if rank == 0:
            Path(result).write_text(json.dumps(out))
    finally:
        dist.destroy_process_group()


def dryrun_multichip(n_devices: int, device="cuda") -> dict:
    """:func:`dryrun_step` on ``n_devices`` ranks: one NCCL rank a GPU for
    ``device="cuda"`` (the default; raises when fewer GPUs are visible),
    gloo CPU ranks for ``"cpu"``; in-process when a group of
    ``n_devices`` ranks already exists. Returns and prints rank 0's
    result."""
    if dist.is_initialized():
        out = dryrun_step(make_mesh(n_devices, _model_parallel(n_devices),
                                    device=device), device=device)
    else:
        if (resolve_device(device).type == "cuda"
                and n_devices > torch.cuda.device_count()):
            raise ValueError(
                f"dryrun_multichip({n_devices}) needs {n_devices} GPUs, one "
                f"a rank (NCCL puts no two ranks on one GPU); this host has "
                f"{torch.cuda.device_count()}; device='cpu' runs gloo ranks")
        import torch.multiprocessing as mp

        with tempfile.TemporaryDirectory() as tmp:
            store, result = (os.path.join(tmp, "store"),
                             os.path.join(tmp, "out"))
            mp.spawn(_rank, args=(n_devices, str(device), store, result),
                     nprocs=n_devices, join=True)
            out = json.loads(Path(result).read_text())
    if dist.is_initialized() and dist.get_rank() != 0:
        return out
    print(f"dryrun_multichip OK: mesh={out['mesh']} backbone=densenet121"
          f"(block_config={BLOCK_CONFIG}) vol={IMAGE_SHAPE} global_batch="
          f"{out['global_batch']} loss={out['loss']:.4f} "
          f"sharded_risk_set_loss={out['loss_sharded']:.4f}")
    return out


if __name__ == "__main__":
    import argparse

    logging.basicConfig(level=logging.WARNING)
    parser = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    parser.add_argument("n_devices", type=int, nargs="?", default=2)
    parser.add_argument("--device", default="cuda",
                        help="cuda (one NCCL rank a GPU) or cpu (gloo)")
    args = parser.parse_args()
    dryrun_multichip(args.n_devices, device=args.device)
