"""The port's sharded Cox risk set (``ops/cox_distributed.py``) against
JAX's ``cox_partial_likelihood_sharded`` on a virtual mesh of the same size
and against the port's single-device ``ops/cox.py``.

Most cases run the shard-local parts (``shard_summary``, ``shard_part``)
over simulated shards in this process; one spawn each of 2 and 4 gloo ranks
runs the entry point itself (its collectives, ``presorted=False``'s global
sort and Efron's global cummin) on every case. Loss and gradient within
2e-5, JAX's own tests/test_cox_distributed.py tolerance (looser than 1e-6).

The gloo workers live at module level and import no JAX (the spawned
children import this module); JAX is imported inside the tests."""

import os

import numpy as np
import pytest
import torch
import torch.distributed as dist
import torch.multiprocessing as mp

from multimodal_survival_prediction_tpu_torch.ops import cox
from multimodal_survival_prediction_tpu_torch.ops.cox_distributed import (
    cox_partial_likelihood_sharded,
    shard_part,
    shard_summary,
)

TOL = 2e-5
N = 32
CASES = ("random", "padding", "interleaved", "tie_across_2", "tie_across_3",
         "one_group", "all_censored")


def _case(name, seed=0):
    """``(hazard, time, event, valid)`` of N rows sorted by time
    descending (valid rows first where the case pads)."""
    rng = np.random.default_rng(seed)
    h = rng.normal(size=N).astype(np.float32)
    t = rng.uniform(1, 3000, N).astype(np.float32)
    e = (rng.uniform(size=N) < 0.6).astype(np.float32)
    e[0] = 1.0
    v = np.ones(N, np.float32)
    t = -np.sort(-t)
    if name == "padding":  # 8 padded rows at the end, time 0
        v[-8:] = 0.0
        t[-8:] = 0.0
    elif name == "interleaved":  # invalid rows among the valid ones
        v[[3, 9, 10, 17, 30]] = 0.0
        t = np.round(t / 500.0) * 500.0  # ties, so runs can be split
    elif name == "tie_across_2":  # rows 4..13: shards 0-1 of 4
        t[4:14] = t[4]
    elif name == "tie_across_3":  # rows 6..17: shards 0-2 of 4
        t[6:18] = t[6]
    elif name == "one_group":  # every row tied: one group across all
        t[:] = 100.0
    elif name == "all_censored":
        e[:] = 0.0
    order = np.argsort(-np.where(v > 0, t, -np.inf), kind="stable")
    if name == "interleaved":
        order = np.arange(N)  # keep the invalid rows where they are
    return h[order], t[order], e[order], v[order]


def _simulated(h, t, e, v, n_shards, ties):
    """The entry point's arithmetic over ``n_shards`` simulated shards of a
    presorted batch: each shard's summary, the stacked summaries, each
    shard's part (Efron's global cummin of the times done up front)."""
    if ties == "efron":
        t = torch.cummin(torch.where(v > 0, t, torch.inf), 0).values
    e = e * v
    k = h.shape[0] // n_shards
    parts = [shard_summary(h[i * k:(i + 1) * k], e[i * k:(i + 1) * k],
                           t[i * k:(i + 1) * k], v[i * k:(i + 1) * k], ties)
             for i in range(n_shards)]
    summaries = torch.stack([s for _, s in parts])
    total = sum(shard_part(st, summaries, i, ties)
                for i, (st, _) in enumerate(parts))
    n_events = e.sum()
    loss = -total / (n_events + 1e-8)
    return torch.where((v.sum() >= 2) & (n_events > 0), loss, 0.0)


def _jax_sharded(h, t, e, v, n_shards, ties, presorted):
    import jax

    from multimodal_survival_prediction_tpu.ops.cox_distributed import (
        cox_partial_likelihood_sharded as jsharded,
    )
    from multimodal_survival_prediction_tpu.parallel import make_mesh

    mesh = make_mesh(n_shards)
    loss, grad = jax.value_and_grad(lambda x: jsharded(
        x, t, e, mesh, valid=v, presorted=presorted, ties=ties))(h)
    return float(loss), np.asarray(grad)


def _port_plain(h, t, e, v, ties):
    th = torch.from_numpy(h).requires_grad_(True)
    loss = cox.cox_partial_likelihood(th, torch.from_numpy(t),
                                      torch.from_numpy(e),
                                      valid=torch.from_numpy(v), ties=ties)
    (grad,) = torch.autograd.grad(loss, th)
    return float(loss.detach()), grad.numpy()


@pytest.mark.parametrize("n_shards", [2, 4])
@pytest.mark.parametrize("ties", ["breslow", "efron"])
@pytest.mark.parametrize("case", CASES)
def test_simulated_shards_match_jax_and_plain(case, ties, n_shards):
    h, t, e, v = _case(case)
    th = torch.from_numpy(h).requires_grad_(True)
    loss = _simulated(th, torch.from_numpy(t), torch.from_numpy(e),
                      torch.from_numpy(v), n_shards, ties)
    (grad,) = torch.autograd.grad(loss, th)
    loss, grad = float(loss.detach()), grad.numpy()
    jloss, jgrad = _jax_sharded(h, t, e, v, n_shards, ties, True)
    ploss, pgrad = _port_plain(h, t, e, v, ties)
    assert abs(loss - jloss) <= TOL and abs(loss - ploss) <= TOL, (
        loss, jloss, ploss)
    np.testing.assert_allclose(grad, jgrad, atol=TOL)
    np.testing.assert_allclose(grad, pgrad, atol=TOL)
    assert np.all(np.isfinite(grad))
    if case == "all_censored":
        assert loss == 0.0  # the degenerate guard, exactly


def test_shard_summary_is_local():
    """A shard's summary depends on its own rows only: the total of its
    logcumsumexp and, under Efron, its first and last segment."""
    h, t, e, v = (torch.from_numpy(a) for a in _case("tie_across_3"))
    _, s = shard_summary(h[8:16], e[8:16], t[8:16], v[8:16], "efron")
    assert s.shape == (9,)
    assert float(s[0]) == pytest.approx(float(torch.logsumexp(h[8:16], 0)))
    assert float(s[1]) == float(t[8]) and float(s[2]) == float(t[15])
    _, s = shard_summary(h[:8], e[:8], t[:8], v[:8], "breslow")
    assert torch.count_nonzero(s[1:]) == 0


def test_unknown_ties_rule_raises():
    with pytest.raises(ValueError, match="unknown ties rule"):
        cox_partial_likelihood_sharded(torch.zeros(2), torch.zeros(2),
                                       torch.zeros(2), None, ties="exact")


# ---------------------------------------------------------------------------
# Real gloo ranks: the entry point with its collectives
# ---------------------------------------------------------------------------

def _spawn_cases():
    rng = np.random.default_rng(1)
    out = []
    for case in CASES:
        h, t, e, v = _case(case)
        for ties in ("breslow", "efron"):
            out.append((case, ties, True, h, t, e, v))
            # the Trainer's mode: any order, sorted globally first
            p = rng.permutation(N)
            out.append((case, ties, False, h[p], t[p], e[p], v[p]))
    return out


def _cox_rank(rank, world, store, out_dir):
    """One gloo rank: every case's loss and its gradient w.r.t. this rank's
    contiguous rows, through ``cox_partial_likelihood_sharded``."""
    torch.set_num_threads(1)
    dist.init_process_group("gloo", init_method=f"file://{store}",
                            rank=rank, world_size=world)
    try:
        k = N // world
        rows = slice(rank * k, (rank + 1) * k)
        results = []
        for case, ties, presorted, h, t, e, v in _spawn_cases():
            th = torch.from_numpy(h[rows].copy()).requires_grad_(True)
            loss = cox_partial_likelihood_sharded(
                th, torch.from_numpy(t[rows].copy()),
                torch.from_numpy(e[rows].copy()), dist.group.WORLD,
                valid=torch.from_numpy(v[rows].copy()), presorted=presorted,
                ties=ties)
            (grad,) = torch.autograd.grad(loss, th)
            results.append((float(loss.detach()), grad.numpy()))
        torch.save(results, os.path.join(out_dir, f"rank{rank}.pt"))
    finally:
        dist.destroy_process_group()


@pytest.mark.parametrize("world", [2, 4])
def test_gloo_ranks_match_jax_and_plain(tmp_path, world):
    mp.spawn(_cox_rank, args=(world, str(tmp_path / "store"), str(tmp_path)),
             nprocs=world, join=True)
    per_rank = [torch.load(tmp_path / f"rank{r}.pt", weights_only=False)
                for r in range(world)]
    for i, (case, ties, presorted, h, t, e, v) in enumerate(_spawn_cases()):
        losses = [r[i][0] for r in per_rank]
        assert len(set(losses)) == 1, (case, ties, presorted, losses)
        grad = np.concatenate([r[i][1] for r in per_rank])
        jloss, jgrad = _jax_sharded(h, t, e, v, world, ties, presorted)
        ploss, pgrad = _port_plain(h, t, e, v, ties)
        label = (case, ties, presorted)
        assert abs(losses[0] - jloss) <= TOL, (label, losses[0], jloss)
        assert abs(losses[0] - ploss) <= TOL, (label, losses[0], ploss)
        np.testing.assert_allclose(grad, jgrad, atol=TOL, err_msg=str(label))
        np.testing.assert_allclose(grad, pgrad, atol=TOL, err_msg=str(label))
