"""Sharding rules over a (data, model) mesh (port of
``multimodal_survival_prediction_tpu/parallel/sharding.py``).

  * parameters are replicated on every rank; with tensor parallelism the
    wide dense layers (out-features >= 512: the RNA encoders' ``5005 ->
    1024``, ``1024 -> 512`` and ``5005 -> 512``) are column-parallel over
    the ``model`` axis: rank ``m`` holds rows ``[m*out/M, (m+1)*out/M)`` of
    the torch weight ``(out, in)`` and of the bias;
  * batches are sharded over ``data``: each rank takes the contiguous rows
    ``[d*B/D, (d+1)*B/D)`` of every batch, as a JAX ``NamedSharding`` on the
    batch dim lays them out;
  * BatchNorm's statistics are taken over the global batch and dropout
    masks drawn for the global batch (``models/layers.py``), so a mesh run
    follows the single-device trajectory.

GSPMD inserts the collectives in JAX; here ``ColumnParallelLinear`` and the
layers call ``parallel/collectives.py`` themselves.
"""

from __future__ import annotations

import torch
from torch import nn

from ..models.layers import BatchNorm, Dropout, Linear
from .collectives import copy_to, gather, group_rank_size
from .mesh import mesh_shape

WIDE_FEATURES = 512


def _is_wide_kernel(module: nn.Module) -> bool:
    """TP rule: dense layers with out-features >= 512 are column-parallel
    (JAX: 2-D kernels whose last dim is >= 512)."""
    return (isinstance(module, nn.Linear)
            and module.out_features >= WIDE_FEATURES)


def param_shardings(model: nn.Module, mesh, tensor_parallel: bool = False
                    ) -> dict:
    """``{parameter name: spec}`` of ``model`` (unsharded): ``()`` for a
    replicated parameter, ``("model", None)`` for a column-parallel weight
    (its rows, the output features, over ``model``) and ``("model",)`` for
    its bias. Default: everything replicated; with ``tensor_parallel`` and
    a ``model`` axis of size > 1, the wide dense layers are sharded."""
    model_size = mesh_shape(mesh).get("model", 1)
    specs = {name: () for name, _ in model.named_parameters()}
    if not (tensor_parallel and model_size > 1):
        return specs
    for name, module in model.named_modules():
        if _is_wide_kernel(module):
            prefix = f"{name}." if name else ""
            specs[prefix + "weight"] = ("model", None)
            if module.bias is not None:
                specs[prefix + "bias"] = ("model",)
    return specs


def shard_rows(t: torch.Tensor, rank: int, size: int) -> torch.Tensor:
    """Rows ``[rank*n/size, (rank+1)*n/size)`` of ``t`` (a copy)."""
    n = t.shape[0]
    if n % size:
        raise ValueError(f"{n} rows do not split over {size} ranks")
    k = n // size
    return t[rank * k:(rank + 1) * k].clone()


class ColumnParallelLinear(Linear):
    """A :class:`Linear` whose output features are split over the ``model``
    group: it holds rows ``[m*out/M, (m+1)*out/M)`` of the weight and bias,
    wraps its replicated input in ``copy_to`` and gathers its output over
    the group (``gather``), so its caller sees the whole ``(..., out)``.

    Its parameters carry ``tp_group`` (``multihost.read_back`` gathers
    them), and ``load_state_dict`` takes the full ``(out, in)`` tensors of
    the single-device model and keeps this rank's rows, so the state_dict
    keys and a gathered state are those of the unsharded model."""

    def __init__(self, linear: nn.Linear, group):
        rank, size = group_rank_size(group)
        nn.Module.__init__(self)
        self.in_features = linear.in_features
        self.out_features = linear.out_features // size
        self.full_out_features = linear.out_features
        self.dtype = getattr(linear, "dtype", None)
        self.group, self.rank, self.size = group, rank, size
        self.weight = nn.Parameter(shard_rows(linear.weight.detach(), rank,
                                              size))
        self.weight.tp_group = group
        if linear.bias is None:
            self.register_parameter("bias", None)
        else:
            self.bias = nn.Parameter(shard_rows(linear.bias.detach(), rank,
                                                size))
            self.bias.tp_group = group

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        y = super().forward(copy_to(x, self.group))
        return gather(y, self.group, dim=-1)

    def _load_from_state_dict(self, state_dict, prefix, *args, **kwargs):
        for name in ("weight", "bias"):
            t = state_dict.get(prefix + name)
            if t is not None and t.shape[0] == self.full_out_features:
                state_dict[prefix + name] = shard_rows(t, self.rank,
                                                       self.size)
        super()._load_from_state_dict(state_dict, prefix, *args, **kwargs)

    def extra_repr(self) -> str:
        return (f"in_features={self.in_features}, out_features="
                f"{self.out_features} of {self.full_out_features}, "
                f"rank={self.rank}/{self.size}")


def shard_module(model: nn.Module, mesh, tensor_parallel: bool = False,
                 batch_axis: str = "data") -> nn.Module:
    """Lay ``model`` (replicated on every rank, same weights) out on
    ``mesh`` in place: its BatchNorms and Dropouts take the global batch of
    the ``batch_axis`` group, and with ``tensor_parallel`` (and a ``model``
    axis > 1) every wide dense layer becomes a ``ColumnParallelLinear``.
    Every rank calls it with the same model."""
    data_group = mesh.get_group(batch_axis)
    for m in model.modules():
        if isinstance(m, (BatchNorm, Dropout)):
            m.data_group = data_group
    if not (tensor_parallel and mesh_shape(mesh).get("model", 1) > 1):
        return model
    model_group = mesh.get_group("model")
    for parent in list(model.modules()):
        for child_name, child in list(parent.named_children()):
            if _is_wide_kernel(child):
                setattr(parent, child_name,
                        ColumnParallelLinear(child, model_group))
    return model


def tp_group(t: torch.Tensor):
    """The ``model`` group ``t`` is a column shard over, or None when it is
    replicated."""
    return getattr(t, "tp_group", None)


def local_part(full: torch.Tensor, like: torch.Tensor) -> torch.Tensor:
    """``full`` (a single-device tensor) as ``like`` holds it on this rank:
    its rows when ``like`` is a column shard, else ``full`` itself."""
    group = tp_group(like)
    if group is None:
        return full
    return shard_rows(full, *group_rank_size(group))


def replicate(tree, device):
    """Every tensor of ``tree`` (a dict, list or tuple of tensors or numpy
    arrays) on this rank's ``device``: each rank holds the whole value."""
    if isinstance(tree, dict):
        return {k: replicate(v, device) for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        return type(tree)(replicate(v, device) for v in tree)
    return torch.as_tensor(tree).to(device)


def batch_rows(n: int, mesh, axis_name: str = "data") -> slice:
    """This rank's contiguous rows of a batch of ``n`` over ``axis_name``;
    ``n`` must divide by the axis's size."""
    size = mesh_shape(mesh)[axis_name]
    if n % size:
        raise ValueError(f"a batch of {n} rows does not split over the "
                         f"{size} ranks of the {axis_name!r} axis")
    k = n // size
    rank = mesh.get_local_rank(axis_name)
    return slice(rank * k, (rank + 1) * k)


def shard_batch_dim(x, mesh, axis_name: str = "data", axis: int = 0):
    """This rank's contiguous slice of ``x`` along ``axis`` over
    ``axis_name`` (a tensor or a numpy array)."""
    rows = batch_rows(x.shape[axis], mesh, axis_name)
    index = [slice(None)] * x.ndim
    index[axis] = rows
    return x[tuple(index)]
