"""The collectives that GSPMD inserts implicitly in the JAX package, made
explicit for ``torch.distributed``, with the backward each needs.

Every rank computes the loss of the whole global batch (a replicated
scalar) and back-propagates its own copy of it; gradients of replicated
parameters are then summed over the data group. Which backward a collective
takes depends on what consumes its result:

  * a *replicated* consumer (every rank runs the same computation on it)
    already holds the whole cotangent on every rank: ``gather`` keeps this
    rank's slice of it, ``reduce_from`` passes it through;
  * a consumer that *differs by rank* (this rank's rows, this rank's columns,
    this rank's chunk of a sort) holds only its own part of the cotangent:
    ``all_gather``, ``copy_to`` and ``all_reduce_sum`` sum the parts over the
    group in their backward.

``torch.distributed.nn.functional.all_gather`` sums in its backward; under a
replicated loss that multiplies every gradient by the group's size, which is
why ``gather`` is its own function here.

``gather`` and ``all_reduce_sum`` also run inside ``torch.func.vmap`` (the
fold x data step of ``train/cv_parallel.py``): their Functions carry a
``vmap`` rule that hands the physical stacked tensor, every fold of this
rank at once, to one collective, and ``all_reduce_sum``'s backward calls its
Function again so that the vmapped backward takes the same rule.

``counter.calls`` counts the collectives this process has launched, forward
and backward (one a stacked call under vmap): ``chip_smoke.py`` reads it to
show that a run went through the distributed path.
"""

from __future__ import annotations

import torch
import torch.distributed as dist


class CallCounter:
    """The number of collectives launched (``calls``)."""

    def __init__(self):
        self.calls = 0


counter = CallCounter()


def group_rank_size(group) -> tuple[int, int]:
    """This rank's index in ``group`` and the group's size."""
    return dist.get_rank(group), dist.get_world_size(group)


def all_gather_tensor(x: torch.Tensor, group, dim: int = 0) -> torch.Tensor:
    """The group's tensors concatenated along ``dim`` in rank order (every
    rank's ``x`` has the same shape); no autograd."""
    x = x.contiguous()
    parts = [torch.empty_like(x) for _ in range(dist.get_world_size(group))]
    dist.all_gather(parts, x, group=group)
    counter.calls += 1
    return torch.cat(parts, dim=dim)


def all_reduce_tensor(x: torch.Tensor, group) -> torch.Tensor:
    """The sum of the group's tensors, in a new tensor; no autograd."""
    y = x.contiguous().clone()
    dist.all_reduce(y, op=dist.ReduceOp.SUM, group=group)
    counter.calls += 1
    return y


def _my_slice(g: torch.Tensor, group, dim: int) -> torch.Tensor:
    rank, size = group_rank_size(group)
    n = g.shape[dim] // size
    return g.narrow(dim, rank * n, n)


class _Gather(torch.autograd.Function):
    @staticmethod
    def forward(x, group, dim):
        return all_gather_tensor(x, group, dim)

    @staticmethod
    def setup_context(ctx, inputs, output):
        _, ctx.group, ctx.dim = inputs

    @staticmethod
    def backward(ctx, g):
        return _my_slice(g, ctx.group, ctx.dim).contiguous(), None, None

    @staticmethod
    def vmap(info, in_dims, x, group, dim):
        # the stacked tensor in one collective: its batch dim leads, and the
        # logical dim moves one to the right
        if in_dims[0] is None:
            return all_gather_tensor(x, group, dim), None
        x = x.movedim(in_dims[0], 0)
        return all_gather_tensor(x, group, dim + 1 if dim >= 0 else dim), 0


class _AllGather(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, group, dim):
        ctx.group, ctx.dim = group, dim
        return all_gather_tensor(x, group, dim)

    @staticmethod
    def backward(ctx, g):
        g = all_reduce_tensor(g, ctx.group)
        return _my_slice(g, ctx.group, ctx.dim).contiguous(), None, None


class _CopyTo(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, group):
        ctx.group = group
        return x.view_as(x)

    @staticmethod
    def backward(ctx, g):
        return all_reduce_tensor(g, ctx.group), None


class _AllReduceSum(torch.autograd.Function):
    @staticmethod
    def forward(x, group):
        return all_reduce_tensor(x, group)

    @staticmethod
    def setup_context(ctx, inputs, output):
        ctx.group = inputs[1]

    @staticmethod
    def backward(ctx, g):
        # through the Function again, so that a vmapped backward takes the
        # rule below
        return _AllReduceSum.apply(g, ctx.group), None

    @staticmethod
    def vmap(info, in_dims, x, group):
        # a sum is elementwise: the stacked tensor reduces as it lies
        return all_reduce_tensor(x, group), in_dims[0]


class _ReduceFrom(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, group):
        return all_reduce_tensor(x, group)

    @staticmethod
    def backward(ctx, g):
        return g, None


def gather(x: torch.Tensor, group, dim: int = 0) -> torch.Tensor:
    """All-gather along ``dim`` for a replicated consumer: the backward
    returns this rank's slice of the incoming gradient (not its sum over
    ranks). The (B,) hazards before the global Cox loss; a column-parallel
    layer's output."""
    return _Gather.apply(x, group, dim)


def all_gather(x: torch.Tensor, group, dim: int = 0) -> torch.Tensor:
    """All-gather along ``dim`` for a consumer that differs by rank: the
    backward sums the incoming gradients over the group and keeps this
    rank's slice (the transpose of JAX's ``all_gather``). The shard totals
    of the sharded Cox scan; the hazards before its global sort."""
    return _AllGather.apply(x, group, dim)


def copy_to(x: torch.Tensor, group) -> torch.Tensor:
    """Identity forward, all-reduce (sum) backward (Megatron's *f*): the
    replicated input of a column-parallel layer."""
    return _CopyTo.apply(x, group)


def all_reduce_sum(x: torch.Tensor, group) -> torch.Tensor:
    """All-reduce (sum) forward and backward, for a consumer that differs
    by rank: BatchNorm's Σx, Σx² and count over the global batch."""
    return _AllReduceSum.apply(x, group)


def reduce_from(x: torch.Tensor, group) -> torch.Tensor:
    """All-reduce (sum) forward, identity backward (Megatron's *g*), for a
    replicated consumer: the sharded Cox loss's sum of shard parts."""
    return _ReduceFrom.apply(x, group)
