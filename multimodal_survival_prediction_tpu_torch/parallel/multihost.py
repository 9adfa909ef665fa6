"""Multi-process runs: joining a ``torch.distributed`` group, the global
mesh, and coordinator-only host I/O (port of
``multimodal_survival_prediction_tpu/parallel/multihost.py``).

  * every process calls :func:`initialize_distributed` once before it
    builds a mesh: with ``coordinator``/``num_processes``/``process_id``
    (the JAX flags), with an ``init_method`` (``file://`` for one host), or
    from torchrun's ``RANK``/``WORLD_SIZE``/``MASTER_ADDR`` environment;
  * :func:`make_global_mesh` builds one (data, model) mesh over every rank
    of every host, the model axis inner so that tensor parallelism stays
    inside a host;
  * artifact writes (checkpoints, cv_results.json, resume state) happen on
    the coordinator only (:func:`is_coordinator`), and :func:`fetch_tree`
    gathers tensor-parallel shards to their full tensors first — every rank
    takes part in that gather.

Each process must build the same host-side inputs (cohort arrays, fold
splits, seeds); every cohort builder of the port is deterministic given the
same files and seed, so running the same command on every host does it.
``--resume`` needs the resume directory on a filesystem every process
sees: the coordinator writes it and the barrier after the save orders the
writer before the readers.

A CUDA process uses the GPU ``LOCAL_RANK`` (torchrun) or its rank modulo
the GPUs it sees; NCCL does not put two ranks on one GPU. NCCL's flight
recorder (``TORCH_NCCL_TRACE_BUFFER_SIZE``) is off unless the environment
sets it: it records a Python stack for every collective, and the training
step launches some 260 small ones (PERF.md §6).
"""

from __future__ import annotations

import logging
import os

import torch
import torch.distributed as dist

from .collectives import all_gather_tensor
from .mesh import best_mesh_shape, make_mesh
from .sharding import tp_group

log = logging.getLogger(__name__)

TRACE_BUFFER = "TORCH_NCCL_TRACE_BUFFER_SIZE"


def backend_for(device) -> str:
    """``"nccl"`` for CUDA ranks, ``"gloo"`` for CPU ranks."""
    return "nccl" if torch.device(device).type == "cuda" else "gloo"


def local_cuda_device(rank: int) -> torch.device:
    """The GPU of a rank on its host: ``LOCAL_RANK`` when torchrun set it,
    else the rank modulo the GPUs this process sees."""
    local = int(os.environ.get("LOCAL_RANK", rank))
    return torch.device("cuda", local % torch.cuda.device_count())


def initialize_distributed(coordinator: str | None = None,
                           num_processes: int | None = None,
                           process_id: int | None = None,
                           device="cuda",
                           init_method: str | None = None
                           ) -> tuple[int, int]:
    """Join (or create) the default process group; idempotent.

    ``coordinator="host:port"`` with ``num_processes`` and ``process_id``
    rendezvous over TCP at rank 0's address; ``init_method`` (with the
    same two counts) names any other rendezvous, such as a ``file://``
    store; with neither, torchrun's environment (``RANK``, ``WORLD_SIZE``,
    ``MASTER_ADDR``, ``MASTER_PORT``) is read. NCCL for ``device="cuda"``
    (the default), gloo for ``"cpu"``.

    Returns ``(rank, world_size)``."""
    if dist.is_initialized():
        return dist.get_rank(), dist.get_world_size()
    if coordinator is not None:
        init_method = f"tcp://{coordinator}"
    kw = {}
    if init_method is not None:
        if num_processes is None or process_id is None:
            raise ValueError("a coordinator or init_method needs "
                             "num_processes and process_id")
        kw = dict(init_method=init_method, world_size=num_processes,
                  rank=process_id)
    elif not {"RANK", "WORLD_SIZE", "MASTER_ADDR"} <= set(os.environ):
        raise ValueError(
            "no cluster to join: pass coordinator (or init_method), "
            "num_processes and process_id, or launch under torchrun "
            "(RANK, WORLD_SIZE, MASTER_ADDR, MASTER_PORT)")
    backend = backend_for(device)
    if backend == "nccl":
        os.environ.setdefault(TRACE_BUFFER, "0")  # module docstring
        rank = kw.get("rank", int(os.environ.get("RANK", 0)))
        kw["device_id"] = local_cuda_device(rank)
        torch.cuda.set_device(kw["device_id"])
    dist.init_process_group(backend, **kw)
    rank, world = dist.get_rank(), dist.get_world_size()
    log.info("torch.distributed initialized (%s): rank %d of %d", backend,
             rank, world)
    return rank, world


def is_coordinator() -> bool:
    """True on the process that writes shared artifacts; a process outside
    any group is its own coordinator."""
    return not dist.is_initialized() or dist.get_rank() == 0


def barrier(tag: str = "barrier") -> None:
    """Block until every process reaches this point (no-op outside a group
    of more than one rank). ``tag`` names the point in the debug log."""
    if dist.is_initialized() and dist.get_world_size() > 1:
        log.debug("barrier %s", tag)
        dist.barrier()


def make_global_mesh(model_parallel: int = 1, axis_names=("data", "model"),
                     device="cuda"):
    """A (data, model) mesh over every rank of the default group. torchrun
    numbers a host's ranks consecutively, so the inner model axis stays on
    one host when ``model_parallel`` divides the ranks a host runs
    (``LOCAL_WORLD_SIZE``); a model axis that would span hosts raises, as
    JAX refuses TP across slices."""
    world = dist.get_world_size()
    _, mp = best_mesh_shape(world, model_parallel)
    local = int(os.environ.get("LOCAL_WORLD_SIZE", world))
    if local % mp:
        raise ValueError(
            f"model_parallel={mp} does not fit inside one host of {local} "
            "ranks; TP must not span hosts")
    return make_mesh(world, model_parallel, axis_names, device=device)


def read_back(x) -> torch.Tensor:
    """A tensor's whole value on the CPU, from any rank: a column shard
    (``sharding.tp_group``) is gathered over its group first (every rank
    of the group must call), a replicated tensor is copied."""
    group = tp_group(x)
    x = x.detach()
    if group is not None:
        x = all_gather_tensor(x, group, dim=0)
    return x.to("cpu", copy=True)


def fetch_tree(tree):
    """:func:`read_back` of every tensor of ``tree`` (a dict, list or
    tuple); other leaves pass through."""
    if isinstance(tree, dict):
        return {k: fetch_tree(v) for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        return type(tree)(fetch_tree(v) for v in tree)
    if isinstance(tree, torch.Tensor):
        return read_back(tree)
    return tree
