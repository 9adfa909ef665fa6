"""The Cox partial likelihood with the risk-set scan sharded over ranks
(port of ``multimodal_survival_prediction_tpu/ops/cox_distributed.py``).

With the time-sorted batch split into contiguous shards, one per rank of a
group, the risk-set logcumsumexp is a distributed prefix scan:

  1. each shard takes its LOCAL logcumsumexp and its total,
  2. the totals are all-gathered (one scalar a shard),
  3. each shard folds in the logsumexp of the earlier shards' totals with
     one logaddexp (a Blelloch scan with logsumexp as the operator),

and the loss is the sum over ranks of the shards' partial sums. Efron ties
add per-tie-group statistics: each shard computes its segments' event
count, event logsumexp, all-row logsumexp and within-group event rank, and
8 boundary scalars a shard stitch the groups that straddle shards (equal
times are contiguous in a sorted batch, so a shard reaches a neighbour's
group only through its first or last segment).

The shard-local parts are pure functions of a shard and the gathered
summaries (:func:`shard_summary`, :func:`shard_part`): a loop over
simulated shards computes the same loss in one process. The collectives
are the thin layer of :func:`cox_partial_likelihood_sharded` — one
all-gather of 9 scalars a shard (the totals and Efron's boundary scalars
together) and one all-reduce of the parts; the counts' all-reduce carries
no gradient.

``presorted=False`` (the Trainer's mode) sorts globally first, which GSPMD
does implicitly in JAX: ``(time, event, valid)`` are gathered without
gradient and the hazards with ``parallel.collectives.all_gather``, every
rank sorts the whole batch with the stable sort of ``ops/cox.py`` and keeps
its contiguous chunk. That moves the hazards once, as XLA's sort of a
sharded array does; only the scan itself stays sharded.
"""

from __future__ import annotations

import torch
from torch.distributed.device_mesh import DeviceMesh

from ..parallel.collectives import (
    all_gather,
    all_gather_tensor,
    all_reduce_tensor,
    group_rank_size,
    reduce_from,
)

_NEG = -1.0e30
# columns of a shard's summary (shard_summary)
_TOTAL, _T_FIRST, _T_LAST, _EV_FIRST, _EV_LAST, _D_FIRST, _D_LAST, \
    _ALL_FIRST, _ALL_LAST = range(9)


def _segment_ids(t: torch.Tensor) -> torch.Tensor:
    """The id of each row's run of equal times (contiguous), from 0."""
    start = torch.ones_like(t, dtype=torch.int64)
    start[1:] = (t[1:] != t[:-1]).to(torch.int64)
    return torch.cumsum(start, 0) - 1


def _segment_sum(x, seg, n):
    return torch.zeros(n, dtype=x.dtype, device=x.device).index_add(0, seg, x)


def _segment_reduce(x, seg, n, reduce, init):
    out = torch.full((n,), init, dtype=x.dtype, device=x.device)
    return out.scatter_reduce(0, seg, x, reduce=reduce, include_self=True)


def _segment_lse(x, seg, n):
    """Per-segment logsumexp; an empty segment gives ~``_NEG``."""
    m = _segment_reduce(x.detach(), seg, n, "amax", _NEG)
    s = _segment_sum(torch.exp(x - m[seg]), seg, n)
    return m + torch.log(s.clamp_min(1e-38))


def shard_summary(h: torch.Tensor, e: torch.Tensor, t: torch.Tensor,
                  v: torch.Tensor, ties: str = "breslow"):
    """The local half of a shard's work: ``(stats, summary)``. ``h``,
    ``e``, ``t``, ``v`` are the shard's hazards, events (already masked by
    ``v``), times and validity, in the global descending-time order.
    ``summary`` is the (9,) vector every shard all-gathers: the local
    logcumsumexp's total, then (Efron) the first and last segment's time,
    event logsumexp, event count and all-row logsumexp (zeros under
    Breslow)."""
    h_masked = torch.where(v > 0, h, _NEG)
    local = torch.logcumsumexp(h_masked, 0)
    stats = dict(h=h, e=e, local=local)
    summary = [local[-1]] + [torch.zeros((), dtype=h.dtype,
                                         device=h.device)] * 8
    if ties == "efron":
        n = h.shape[0]
        seg = _segment_ids(t)
        s_last = seg[-1]
        ev = _segment_lse(torch.where(e > 0, h, _NEG), seg, n)
        every = _segment_lse(h_masked, seg, n)
        d = _segment_sum(e, seg, n)
        # 0-based event rank within the segment: the exclusive event
        # cumsum minus its value at the segment's start
        c = torch.cumsum(e, 0) - e
        rank = c - _segment_reduce(c, seg, n, "amin", float("inf"))[seg]
        last = _segment_reduce(torch.arange(n, device=h.device), seg, n,
                               "amax", 0)
        stats.update(seg=seg, s_last=s_last, ev=ev, d=d, rank=rank,
                     last=last)
        summary = [local[-1], t[0], t[-1], ev[0], ev[s_last], d[0],
                   d[s_last], every[0], every[s_last]]
    return stats, torch.stack(summary)


def shard_part(stats: dict, summaries: torch.Tensor, index: int,
               ties: str = "breslow") -> torch.Tensor:
    """The shard's partial sum of (hazard − risk-set denominator) over its
    events, from its :func:`shard_summary` stats, every shard's summary
    ((n_shards, 9), in shard order) and its own index."""
    ids = torch.arange(summaries.shape[0], device=summaries.device)
    prev = torch.where(ids < index, summaries[:, _TOTAL], _NEG)
    pre = torch.logaddexp(stats["local"], torch.logsumexp(prev, 0))
    h, e = stats["h"], stats["e"]
    if ties != "efron":
        return torch.where(e > 0, h - pre, 0.0).mul(e).sum()

    seg, s_last, n = stats["seg"], stats["s_last"], h.shape[0]
    t_first, t_last = summaries[index, _T_FIRST], summaries[index, _T_LAST]
    # earlier shards whose last segment has our first time hold earlier
    # members of our first group; later shards whose first segment has our
    # last time hold later members of our last group
    left = (ids < index) & (summaries[:, _T_LAST] == t_first)
    right = (ids > index) & (summaries[:, _T_FIRST] == t_last)

    def lse(sel, col):
        return torch.logsumexp(torch.where(sel, summaries[:, col], _NEG), 0)

    def total(sel, col):
        return torch.where(sel, summaries[:, col], 0.0).sum()

    ev_left, d_left = lse(left, _EV_LAST), total(left, _D_LAST)
    ev_right, d_right = lse(right, _EV_FIRST), total(right, _D_FIRST)
    all_right = lse(right, _ALL_FIRST)

    seg_ids = torch.arange(n, device=h.device)
    is_first, is_last = seg_ids == 0, seg_ids == s_last
    ev_g = torch.logaddexp(stats["ev"], torch.where(is_first, ev_left, _NEG))
    ev_g = torch.logaddexp(ev_g, torch.where(is_last, ev_right, _NEG))
    d_g = (stats["d"] + torch.where(is_first, d_left, 0.0)
           + torch.where(is_last, d_right, 0.0))
    # the risk set at the group's end (pre is nondecreasing: its value at
    # the segment's last row), plus the continuation's all-row mass when
    # the group runs into later shards
    risk = torch.logaddexp(pre[stats["last"]],
                           torch.where(is_last, all_right, _NEG))
    rank = stats["rank"] + torch.where(seg == 0, d_left, 0.0)
    frac = torch.exp(ev_g - risk)
    adj = torch.log(torch.clamp(
        1.0 - (rank / d_g.clamp_min(1.0)[seg]) * frac[seg], 1e-12, 1.0))
    return torch.where(e > 0, h - (risk[seg] + adj), 0.0).mul(e).sum()


def _group(mesh_or_group, axis_name):
    if isinstance(mesh_or_group, DeviceMesh):
        return mesh_or_group.get_group(axis_name)
    return mesh_or_group


def cox_partial_likelihood_sharded(
    hazard: torch.Tensor, time: torch.Tensor, event: torch.Tensor,
    mesh, axis_name: str = "data", valid: torch.Tensor | None = None,
    eps: float = 1e-8, presorted: bool = True, ties: str = "breslow",
) -> torch.Tensor:
    """Cox NLL with the batch sharded over ``axis_name`` of ``mesh`` (a
    ``DeviceMesh``, or a process group): each rank passes its shard, every
    rank gets the whole batch's loss (a replicated scalar to
    back-propagate on every rank).

    ``presorted=True``: the shards are consecutive pieces of a batch sorted
    by time descending (interleaved invalid rows allowed). ``False``: any
    order; the batch is sorted globally first (module docstring). Semantics
    of ``ops.cox.cox_partial_likelihood``: Breslow or Efron ties, invalid
    rows out of every risk set, and exactly 0 with fewer than 2 valid rows
    or no event."""
    if ties not in ("breslow", "efron"):
        raise ValueError(f"unknown ties rule {ties!r}")
    group = _group(mesh, axis_name)
    index, n_shards = group_rank_size(group)
    hazard = hazard.to(torch.float32)
    time = time.to(torch.float32)
    event = event.to(torch.float32)
    valid = (torch.ones_like(event) if valid is None
             else valid.to(torch.float32))
    if not presorted:
        # ops.cox._sort_desc_by_time's order: descending time, invalid rows
        # last (time -> -inf), stable
        time = torch.where(valid > 0, time, -torch.inf)
        labels = all_gather_tensor(torch.stack([time, event, valid], 1),
                                   group)
        every = all_gather(hazard, group)
        order = torch.argsort(-labels[:, 0], stable=True)
        n = hazard.shape[0]
        mine = order[index * n:(index + 1) * n]
        hazard = every[mine]
        time, event, valid = labels[mine].unbind(1)
    elif ties == "efron":
        # Efron's segments are runs of equal time; an invalid row (no mass)
        # takes the nearest earlier valid time so that it cannot split a
        # run — a global cummin, valid times being descending: this shard's
        # own, then the minimum over the earlier shards
        t = torch.where(valid > 0, time, torch.inf)
        mins = all_gather_tensor(t.min().reshape(1), group)
        before = torch.where(torch.arange(n_shards, device=t.device) < index,
                             mins, torch.inf).min()
        time = torch.minimum(torch.cummin(t, 0).values, before)

    event = event * valid
    stats, summary = shard_summary(hazard, event, time, valid, ties)
    summaries = all_gather(summary.unsqueeze(0), group)
    part = shard_part(stats, summaries, index, ties)
    n_events, n_valid = all_reduce_tensor(
        torch.stack([event.sum(), valid.sum()]).detach(), group).unbind()
    loss = -reduce_from(part, group) / (n_events + eps)
    ok = (n_valid >= 2) & (n_events > 0)
    return torch.where(ok, loss, 0.0)
