"""Meshes over the ranks of ``torch.distributed`` (port of
``multimodal_survival_prediction_tpu/parallel/mesh.py``).

JAX runs one process over N devices and lays them out as a ``Mesh``;
PyTorch runs one process a device. The port's mesh is a
``torch.distributed.device_mesh.DeviceMesh`` with dims ``("data",
"model")`` over the ranks of the default group, row-major as JAX's
``reshape(dp, mp)``: rank ``d * mp + m`` sits at ``(d, m)``, so the model
axis is the inner one and a tensor-parallel group holds consecutive ranks
(one host's GPUs, on NVLink).
"""

from __future__ import annotations

import torch
import torch.distributed as dist
from torch.distributed.device_mesh import DeviceMesh


def best_mesh_shape(n_devices: int, model_parallel: int = 1) -> tuple[int, int]:
    """(data, model) factorization of n_devices."""
    if n_devices % model_parallel != 0:
        raise ValueError(
            f"{n_devices} devices not divisible by model={model_parallel}")
    return (n_devices // model_parallel, model_parallel)


def make_mesh(n_devices: int | None = None, model_parallel: int = 1,
              axis_names=("data", "model"), device="cuda") -> DeviceMesh:
    """A (data, model) mesh over the ranks of the current default group.

    The group must exist (``parallel.multihost.initialize_distributed``,
    or the training CLI's ``--mesh``), and its world size must be
    ``n_devices`` (None: the world size). ``device`` names the ranks'
    device type (``"cuda"`` under NCCL, ``"cpu"`` under gloo). Every rank
    calls this together: building the mesh creates its subgroups."""
    if not dist.is_initialized():
        raise RuntimeError(
            "make_mesh needs a torch.distributed process group: call "
            "parallel.multihost.initialize_distributed first")
    world = dist.get_world_size()
    if n_devices is None:
        n_devices = world
    if n_devices != world:
        raise ValueError(f"a mesh of {n_devices} devices over a process "
                         f"group of {world} ranks")
    dp, mp = best_mesh_shape(n_devices, model_parallel)
    device_type = torch.device(device).type
    return DeviceMesh(device_type, torch.arange(n_devices).reshape(dp, mp),
                      mesh_dim_names=tuple(axis_names))


def mesh_shape(mesh: DeviceMesh | None) -> dict:
    """``{axis name: size}`` of ``mesh`` (JAX's ``dict(mesh.shape)``);
    ``{}`` for None."""
    if mesh is None:
        return {}
    return dict(zip(mesh.mesh_dim_names, mesh.mesh.shape))
