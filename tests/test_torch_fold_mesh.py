"""The fold mesh and the sweep mesh (``train/cv_parallel.py:make_fold_mesh``,
``run_cross_validation_parallel(mesh=)``, ``run_hyperparameter_sweep(mesh=)``)
on 2 and 4 gloo CPU ranks, each fold held to the port's one-device
vmapped run; and the collectives' ``vmap`` rule
(``parallel/collectives.py``) held to a loop over the folds.

Each module fixture spawns its ranks once (``torch.multiprocessing``, a
FileStore under tmp_path) and runs every scenario of its mesh size in
them; each rank saves what it saw, and the tests read it. The workers live
at module level and import no JAX (the spawned children import this
module). The one-device references run in the test process.

Tolerances (the fold-parallel driver's, ``tests/test_torch_cv_parallel.py``):
the drivers train in float64 (each fold's model and Adam state made float64 by the
init hook; in float32 a bias that feeds a train-mode BatchNorm has a
gradient of pure rounding noise that Adam turns into steps of about lr, so
a fold on its own rank, whose grouped convolutions and BatchNorm sums run
in another order, parts from the one-device run by up to lr a step):
epoch losses rtol 1e-4, val C-index 1e-6, best epochs and epochs run
exact; parameters, running stats and Adam's moments rtol 2e-5 / atol
2e-6; Adam's count, the step and the dropout generator's state exact. The
vmapped collectives against the per-fold loop: exact (float64). The
streaming fold mesh against the device-resident one: bit for bit.
"""

import dataclasses

import numpy as np
import pytest
import torch
import torch.distributed as dist
import torch.multiprocessing as mp

from multimodal_survival_prediction_tpu_torch.config import ALL_CONFIGS
from multimodal_survival_prediction_tpu_torch.data.matching_table import (
    load_matching_table,
)
from multimodal_survival_prediction_tpu_torch.data.synthetic import (
    SyntheticCohortSpec,
    generate_synthetic_cohort,
)
from multimodal_survival_prediction_tpu_torch.parallel import collectives
from multimodal_survival_prediction_tpu_torch.train import cv, cv_parallel
from multimodal_survival_prediction_tpu_torch.train import engine, sweep

SPEC = dict(n_patients=30, rna_dim=24, seed=4, p_imaging=0.7,
            image_shapes=((12, 20, 20), (10, 18, 16)))
OVER = dict(num_epochs=2, image_shape=(16, 16, 8), batch_size=8)
SEEDS = (42, 43, 44)  # the sweeps' three candidates


# ---------------------------------------------------------------------------
# What every process runs (the ranks and the one-device references)
# ---------------------------------------------------------------------------

def _f64(key, state):
    """Init hook: the fold's model and Adam state in float64."""
    state.model.double()
    ps = list(state.model.parameters())
    state.opt_state = engine.AdamState(mu=[torch.zeros_like(p) for p in ps],
                                       nu=[torch.zeros_like(p) for p in ps])


def _cfg(name, **extra):
    return dataclasses.replace(ALL_CONFIGS[name], **OVER, **extra)


def _prepared(root, cfg):
    table = load_matching_table(root / "data" / "processed"
                                / "full_matching_table.csv")
    return cv.prepare_cv_data(
        cfg, table, rnaseq_csv=root / "data" / "processed"
        / "rnaseq_normalized_mapped.csv", device="cpu")


def _finals(module, into):
    """Wrap ``module.train_stacked`` so that each real state this rank
    holds is kept (``StackedState.fold_train_state``) when it returns."""
    orig = module.train_stacked

    def keep(trainer, s1, state, *a, **k):
        run = orig(trainer, s1, state, *a, **k)
        pl = k["placement"]
        for i in pl.local:
            if i < pl.k:
                into[i] = state.fold_train_state(i - pl.local.start)
        return run

    return orig, keep


def _drive(mesh, root, out, cfg, streaming=False):
    """The fold-parallel driver on ``mesh`` (None: one device), float64,
    writing under ``out``: its outcomes, the kept final states, the files
    written and the collectives launched."""
    finals = {}
    orig, keep = _finals(cv_parallel, finals)
    cv_parallel.train_stacked = keep
    collectives.counter.calls = 0
    try:
        payload, outcomes = cv_parallel.run_cross_validation_parallel(
            cfg, None, results_dir=out, models_dir=out,
            backbone="simple_cnn", prepared=_prepared(root, cfg),
            init_hook=_f64, mesh=mesh, streaming=streaming, device="cpu")
    finally:
        cv_parallel.train_stacked = orig
    files = (sorted(p.name for p in (out / cfg.name).iterdir())
             if (out / cfg.name).exists() else [])
    return dict(payload=payload, finals=finals,
                calls=collectives.counter.calls, files=files,
                outcomes=[dict(fold=o.fold, best_c_index=o.best_c_index,
                               best_epoch=o.best_epoch,
                               epochs_run=o.epochs_run, history=o.history)
                          for o in outcomes])


def _sweep(mesh, root, out):
    cfg = _cfg("partial_modality")
    finals = {}
    orig, keep = _finals(sweep, finals)
    sweep.train_stacked = keep
    try:
        board = sweep.run_hyperparameter_sweep(
            cfg, None, seeds=SEEDS, prepared=_prepared(root, cfg),
            backbone="simple_cnn", init_hook=_f64, mesh=mesh,
            results_dir=out, device="cpu")
    finally:
        sweep.train_stacked = orig
    return dict(board=board, finals=finals,
                written=(out / cfg.name / "sweep_results.json").exists())


def _collective_loss(w, x, group):
    s = collectives.all_reduce_sum(torch.cat([(x * w).sum(0),
                                              (x * x * w).sum(0)]), group)
    h = collectives.gather((x * w).sum(-1) + s[:1], group)
    return (h ** 2).sum() + (w * s[4:]).sum()


def _collectives(rank):
    """``vmap(grad_and_value)`` of a loss through the stacked all-reduce
    and gather, against a loop over the three folds."""
    gen = torch.Generator().manual_seed(0)
    w = torch.randn(3, 4, dtype=torch.float64, generator=gen)
    x = torch.randn(3, 2, 4, dtype=torch.float64, generator=gen) + rank
    collectives.counter.calls = 0
    grads, losses = torch.func.vmap(torch.func.grad_and_value(
        _collective_loss), in_dims=(0, 0, None))(w, x, None)
    stacked_calls = collectives.counter.calls
    loop = []
    for k in range(3):
        wk = w[k].clone().requires_grad_()
        loss = _collective_loss(wk, x[k], None)
        loop.append((torch.autograd.grad(loss, wk)[0], loss.detach()))
    return dict(grads=grads, losses=losses,
                loop_grads=torch.stack([g for g, _ in loop]),
                loop_losses=torch.stack([v for _, v in loop]),
                stacked_calls=stacked_calls,
                loop_calls=collectives.counter.calls - stacked_calls)


def _layout(world, dp):
    mesh = cv_parallel.make_fold_mesh(world, dp, device="cpu")
    return dict(shape=tuple(mesh.mesh.shape), names=mesh.mesh_dim_names,
                at=(mesh.get_local_rank("fold"), mesh.get_local_rank("data")),
                data_peers=dist.get_process_group_ranks(
                    mesh.get_group("data")))


def _worker(rank, world, store, root, tmp):
    torch.set_num_threads(1)
    out = tmp / f"rank{rank}"  # each rank's own results and models dirs
    dist.init_process_group("gloo", init_method=f"file://{store}",
                            rank=rank, world_size=world)
    res = {}
    try:
        if world == 2:
            res["collectives"] = _collectives(rank)
            res["layout"] = {dp: _layout(2, dp) for dp in (1, 2)}
            res["two_folds"] = _drive(cv_parallel.make_fold_mesh(
                2, device="cpu"), root, out / "two_folds",
                _cfg("partial_modality", n_folds=2))
            res["sweep"] = _sweep(cv_parallel.make_fold_mesh(
                2, device="cpu"), root, out / "sweep")
        else:
            res["layout"] = {dp: _layout(4, dp) for dp in (1, 2)}
            fold_mesh = cv_parallel.make_fold_mesh(4, device="cpu")
            fold_data = cv_parallel.make_fold_mesh(4, 2, device="cpu")
            pm = _cfg("partial_modality", n_folds=3)
            res["three_folds"] = _drive(fold_mesh, root, out / "three", pm)
            res["fold_by_data"] = _drive(fold_data, root, out / "fxd", pm)
            res["streaming"] = _drive(fold_data, root, out / "stream", pm,
                                      streaming=True)
            res["simmim"] = _drive(fold_data, root, out / "simmim",
                                   _cfg("simmim", n_folds=3,
                                        stage1_epochs=1))
            res["sweep"] = _sweep(fold_mesh, root, out / "sweep")
            try:
                cv_parallel.run_cross_validation_parallel(
                    dataclasses.replace(pm, batch_size=7), None,
                    mesh=fold_data, prepared=_prepared(root, pm),
                    device="cpu")
                res["batch_error"] = None
            except ValueError as e:
                res["batch_error"] = str(e)
    finally:
        torch.save(res, tmp / f"rank{rank}.pt")
        dist.destroy_process_group()


# ---------------------------------------------------------------------------
# Fixtures: the cohort, the ranks, the one-device references
# ---------------------------------------------------------------------------

@pytest.fixture(scope="module")
def root(tmp_path_factory):
    root = tmp_path_factory.mktemp("fold_mesh_cohort")
    generate_synthetic_cohort(root, SyntheticCohortSpec(**SPEC))
    return root


def _spawn(world, root, tmp):
    store = tmp / "store"
    mp.spawn(_worker, nprocs=world, join=True,
             args=(world, str(store), root, tmp))
    return [torch.load(tmp / f"rank{r}.pt", weights_only=False)
            for r in range(world)]


@pytest.fixture(scope="module")
def two(root, tmp_path_factory):
    return _spawn(2, root, tmp_path_factory.mktemp("two_ranks"))


@pytest.fixture(scope="module")
def four(root, tmp_path_factory):
    return _spawn(4, root, tmp_path_factory.mktemp("four_ranks"))


@pytest.fixture(scope="module")
def one(root, tmp_path_factory):
    """The one-device runs the ranks are held to."""
    threads = torch.get_num_threads()
    torch.set_num_threads(min(threads, 2))
    out = tmp_path_factory.mktemp("one_device")
    try:
        return dict(
            two_folds=_drive(None, root, out / "two",
                             _cfg("partial_modality", n_folds=2)),
            three_folds=_drive(None, root, out / "three",
                               _cfg("partial_modality", n_folds=3)),
            simmim=_drive(None, root, out / "simmim",
                          _cfg("simmim", n_folds=3, stage1_epochs=1)),
            sweep=_sweep(None, root, out / "sweep"))
    finally:
        torch.set_num_threads(threads)


# ---------------------------------------------------------------------------
# Checks
# ---------------------------------------------------------------------------

def _assert_states_close(got, want):
    """Two ``train_state_dict``s: model tensors and moments to the
    fold-parallel driver's limits, count, step and generator exact."""
    assert sorted(got["model"]) == sorted(want["model"])
    for k, v in want["model"].items():
        if v.dtype.is_floating_point:
            np.testing.assert_allclose(got["model"][k].numpy(), v.numpy(),
                                       rtol=2e-5, atol=2e-6, err_msg=k)
        else:
            assert torch.equal(got["model"][k], v), k
    for key in ("opt_mu", "opt_nu"):
        assert len(got[key]) == len(want[key])
        for a, b in zip(got[key], want[key]):
            np.testing.assert_allclose(a.numpy(), b.numpy(), rtol=2e-5,
                                       atol=2e-6)
    for key in ("opt_count", "step"):
        assert got[key] == want[key], key
    assert torch.equal(got["dropout_rng"], want["dropout_rng"])


def _assert_outcomes_close(got, want):
    assert len(got) == len(want)
    for o, w in zip(got, want):
        for key in ("fold", "best_epoch", "epochs_run"):
            assert o[key] == w[key], key
        assert abs(o["best_c_index"] - w["best_c_index"]) <= 1e-6
        for key in ("train_loss", "val_loss"):
            np.testing.assert_allclose([h[key] for h in o["history"]],
                                       [h[key] for h in w["history"]],
                                       rtol=1e-4, err_msg=key)
        for h, hw in zip(o["history"], w["history"]):
            assert abs(h["val_c_index"] - hw["val_c_index"]) <= 1e-6
            assert h["lr"] == hw["lr"] and h["epoch"] == hw["epoch"]


def _assert_run_matches(ranks, key, want, data=1):
    """Every rank's outcomes against the one-device run's; each real
    fold's final state, kept by every rank of its fold row, against the
    one-device state; the coordinator alone wrote."""
    held = {}
    for rank, res in enumerate(ranks):
        run = res[key]
        _assert_outcomes_close(run["outcomes"], want["outcomes"])
        for k, state in run["finals"].items():
            _assert_states_close(state, want["finals"][k])
            held.setdefault(k, []).append(rank)
        assert bool(run["files"]) == (rank == 0)
    assert sorted(held) == sorted(want["finals"])
    assert all(len(r) == data for r in held.values())
    assert ranks[0][key]["files"] == want["files"]
    for got, exp in zip(ranks[0][key]["payload"]["fold_results"],
                        want["payload"]["fold_results"]):
        got, exp = dict(got), dict(exp)
        assert abs(got.pop("best_c_index") - exp.pop("best_c_index")) <= 1e-6
        assert got == exp
    return held


def test_vmapped_collectives_match_a_per_fold_loop(two):
    """On 2 gloo ranks, ``vmap(grad_and_value)`` of a loss through the
    stacked all-reduce (forward and backward) and the hazards' gather
    equals a loop over the 3 folds, and ``counter.calls`` counts one call
    a stacked collective: 3 for all 3 folds (all-reduce forward, gather,
    all-reduce backward) against 9 in the loop."""
    for res in two:
        c = res["collectives"]
        assert torch.equal(c["losses"], c["loop_losses"])
        assert torch.equal(c["grads"], c["loop_grads"])
        assert (c["stacked_calls"], c["loop_calls"]) == (3, 9)


@pytest.mark.parametrize("world,dp", [(2, 1), (2, 2), (4, 1), (4, 2)])
def test_fold_mesh_is_row_major(two, four, world, dp):
    """``make_fold_mesh(n, dp)`` is an (n/dp, dp) ``("fold", "data")`` mesh
    with rank ``f * dp + d`` at ``(f, d)``: a fold's data group is
    consecutive ranks, as JAX's ``reshape(n // dp, dp)``."""
    ranks = two if world == 2 else four
    for rank, res in enumerate(ranks):
        lay = res["layout"][dp]
        assert lay["shape"] == (world // dp, dp)
        assert lay["names"] == ("fold", "data")
        assert lay["at"] == (rank // dp, rank % dp)
        row = rank // dp
        assert lay["data_peers"] == list(range(row * dp, row * dp + dp))


def test_two_folds_on_two_ranks_match_one_device(two, one):
    """2 folds on a 2x1 fold mesh, dropout on: each rank trains its one
    fold; every fold's outcome on every rank and its final state equal the
    one-device vmapped run's; one evaluation gather an epoch is the only
    collective."""
    held = _assert_run_matches(two, "two_folds", one["two_folds"])
    assert held == {0: [0], 1: [1]}
    assert [r["two_folds"]["calls"] for r in two] == [2, 2]


def test_three_folds_on_four_ranks_write_three_folds(four, one):
    """3 folds on a 4x1 fold mesh: padded to 4, the dummy fold computes on
    rank 3 and is never recorded or written: exactly 3 ``.pt`` and 3
    ``.meta.json`` (and cv_results.json), by rank 0 alone; the real folds
    match the one-device run."""
    held = _assert_run_matches(four, "three_folds", one["three_folds"])
    assert held == {0: [0], 1: [1], 2: [2]}
    files = four[0]["three_folds"]["files"]
    assert files == ["cv_results.json"] + [
        f"fold_{k}_best.pt{s}" for k in (1, 2, 3) for s in ("", ".meta.json")]
    assert all(len(r["three_folds"]["outcomes"]) == 3 for r in four)


def test_fold_by_data_matches_one_device(four, one):
    """3 folds on a 2x2 fold x data mesh (k_pad 4), dropout on: each fold's
    batch rows split over its two data ranks, BatchNorm's sums and the
    hazards through the vmapped collectives, each fold's dropout uniforms
    those of the global batch; every rank of a fold row holds the same
    state, which matches the one-device run's."""
    held = _assert_run_matches(four, "fold_by_data", one["three_folds"],
                               data=2)
    assert held == {0: [0, 1], 1: [0, 1], 2: [2, 3]}
    for k, ranks in held.items():
        a, b = (four[r]["fold_by_data"]["finals"][k] for r in ranks)
        assert all(torch.equal(a["model"][n], b["model"][n])
                   for n in a["model"])
    calls = [r["fold_by_data"]["calls"] for r in four]
    assert calls[0] == calls[1] == calls[2] == calls[3] > 2


def test_streaming_on_a_fold_mesh_equals_device_resident(four):
    """``streaming=True`` on the 2x2 mesh (each rank prefetching its own
    folds' stacked batches, its rows of them) lands bit for bit where the
    device-resident run does."""
    for res in four:
        a, b = res["streaming"], res["fold_by_data"]
        assert a["outcomes"] == b["outcomes"]
        assert a["finals"].keys() == b["finals"].keys()
        for k in a["finals"]:
            assert all(torch.equal(a["finals"][k]["model"][n],
                                   b["finals"][k]["model"][n])
                       for n in a["finals"][k]["model"])


def test_simmim_two_stages_on_a_fold_mesh(four, one):
    """SimMLM's two stages (one stage-1 epoch through
    ``train_stacked``'s stage-1 trainer, then the main epochs) on the 2x2
    mesh match the one-device run."""
    _assert_run_matches(four, "simmim", one["simmim"], data=2)


@pytest.mark.parametrize("world", [2, 4])
def test_sweep_on_a_fold_mesh_matches_one_device(two, four, one, world):
    """The sweep's 3 candidates on a fold mesh of 2 and 4 ranks (padded to
    4): all 3 reported, none padded, on every rank; the same leaderboard as
    on one device; sweep_results.json written by rank 0 alone; each
    candidate's final state as on one device."""
    ranks = two if world == 2 else four
    want = one["sweep"]
    for rank, res in enumerate(ranks):
        board = res["sweep"]["board"]
        assert len(board) == 3
        assert [(r["seed"], r["learning_rate"], r["best_epoch"])
                for r in board] == [(r["seed"], r["learning_rate"],
                                     r["best_epoch"]) for r in want["board"]]
        for r, w in zip(board, want["board"]):
            assert abs(r["best_c_index"] - w["best_c_index"]) <= 1e-6
        assert res["sweep"]["written"] == (rank == 0)
        for k, state in res["sweep"]["finals"].items():
            _assert_states_close(state, want["finals"][k])
    assert sorted(k for r in ranks for k in r["sweep"]["finals"]) == \
        [0, 1, 2]


def test_fold_by_data_refuses_a_batch_it_cannot_split(four):
    """JAX's usage error, before anything trains: the batch sizes must
    divide by the data axis."""
    for res in four:
        assert res["batch_error"] == ("batch sizes (7, 64) must divide by "
                                      "the 'data' axis (2)")
