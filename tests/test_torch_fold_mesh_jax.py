"""The port's fold mesh against the JAX package's, and the CLIs' fold and
sweep meshes end to end, on gloo CPU ranks.

JAX: ``run_cross_validation_parallel(mesh=make_fold_mesh(4))`` and
``make_fold_mesh(8, data_parallel=4)`` on the 8 virtual CPU devices
(rnaseq_only, 3 folds x 3 epochs, dropout off on both sides, the port's
folds started from JAX's initial weights through ``io/jax_import.py``);
the port on a 4x1 and a 2x2 fold mesh of 4 spawned ranks (the workers live
at module level and import no JAX). Held at JAX's own limits
(``tests/test_cv_parallel.py``): losses rtol 1e-4, val C-index 1e-4, best
epochs and epochs run exact.

The CLIs: ``--fold-parallel 2``, ``--fold-parallel 4 --fold-dp 2`` and the
sweep's ``--sweep-mesh 2`` start their ranks themselves; each run's
cv_results.json (or leaderboard) equals the one-device run's
(``--fold-parallel 1``, the sweep without a mesh) but for the C-index,
held to 1e-6; JAX's usage errors word for word.
"""

import dataclasses
import json

import numpy as np
import pytest
import torch
import torch.distributed as dist
import torch.multiprocessing as mp

from multimodal_survival_prediction_tpu_torch.config import ALL_CONFIGS
from multimodal_survival_prediction_tpu_torch.data.matching_table import (
    load_matching_table,
)
from multimodal_survival_prediction_tpu_torch.models.layers import Dropout
from multimodal_survival_prediction_tpu_torch.train import cv, cv_parallel
from multimodal_survival_prediction_tpu_torch.train import sweep
from multimodal_survival_prediction_tpu_torch.train import (
    partial_modality_training as pmt,
)
from multimodal_survival_prediction_tpu_torch.train.predict import (
    fold_checkpoints,
)

SPEC = dict(n_patients=30, rna_dim=24, seed=8, p_imaging=0.6,
            image_shapes=((12, 20, 20), (10, 18, 16)))
OVER = dict(n_folds=3, num_epochs=3, image_shape=(16, 16, 8))
MESHES = {"4x1": (4, 1), "2x2": (4, 2)}  # port: (ranks, data)


def _jax_start(inits):
    """Init hook: JAX's initial weights for the fold, dropout off."""
    def hook(fold, state):
        state.model.load_state_dict(inits[fold - 1], strict=True)
        for m in state.model.modules():
            if isinstance(m, Dropout):
                m.p = 0.0
    return hook


def _worker(rank, world, store, root, inits_path, tmp):
    torch.set_num_threads(1)
    dist.init_process_group("gloo", init_method=f"file://{store}",
                            rank=rank, world_size=world)
    res = {}
    try:
        cfg = dataclasses.replace(ALL_CONFIGS["rnaseq_only"], **OVER)
        table = load_matching_table(root / "data" / "processed"
                                    / "full_matching_table.csv")
        prepared = cv.prepare_cv_data(
            cfg, table, rnaseq_csv=root / "data" / "processed"
            / "rnaseq_normalized_mapped.csv", device="cpu")
        hook = _jax_start(torch.load(inits_path))
        for label, (n, dp) in MESHES.items():
            _, outcomes = cv_parallel.run_cross_validation_parallel(
                cfg, None, results_dir=tmp / f"{label}_{rank}",
                models_dir=tmp / f"{label}_{rank}", prepared=prepared,
                init_hook=hook, mesh=cv_parallel.make_fold_mesh(
                    n, dp, device="cpu"), device="cpu")
            res[label] = [dict(fold=o.fold, best_epoch=o.best_epoch,
                               epochs_run=o.epochs_run, history=o.history)
                          for o in outcomes]
    finally:
        torch.save(res, tmp / f"rank{rank}.pt")
        dist.destroy_process_group()


@pytest.fixture(scope="module")
def jax_and_port(tmp_path_factory):
    """JAX's two fold meshes (their initial weights recorded per fold),
    then the port's two on 4 ranks from those weights."""
    import flax.linen as fnn
    import jax

    from multimodal_survival_prediction_tpu import config as jconfig
    from multimodal_survival_prediction_tpu.data.synthetic import (
        SyntheticCohortSpec as JSpec,
    )
    from multimodal_survival_prediction_tpu.data.synthetic import (
        generate_synthetic_cohort as jgen,
    )
    from multimodal_survival_prediction_tpu.train import cv_parallel as jcvp
    from multimodal_survival_prediction_tpu.train import engine as jengine
    from multimodal_survival_prediction_tpu_torch.io import jax_import

    class NoDropout(fnn.Module):
        rate: float = 0.0
        deterministic: bool | None = None

        def __call__(self, x, deterministic=None, rng=None):
            return x

    tmp = tmp_path_factory.mktemp("fold_mesh_jax")
    root = tmp / "cohort"
    jtable, paths = jgen(root, JSpec(**SPEC))
    jcfg = jconfig.RNASEQ_ONLY.with_overrides(**OVER)
    inits, init_state = {}, jengine.Trainer.init_state

    def recorded(self, *a, fold=0, **k):
        state = init_state(self, *a, fold=fold, **k)
        tree = jax.tree_util.tree_map(np.asarray, {
            "params": state.params, "batch_stats": state.batch_stats})
        inits[fold - 1] = {k: torch.from_numpy(np.array(v)) for k, v in
                           jax_import.export_torch_state_dict(
                               "rnaseq_only", tree).items()}
        return state

    runs = {}
    with pytest.MonkeyPatch.context() as patch:
        patch.setattr(fnn, "Dropout", NoDropout)
        patch.setattr(jengine.Trainer, "init_state", recorded)
        for label, mesh in (("4x1", jcvp.make_fold_mesh(4)),
                            ("2x2", jcvp.make_fold_mesh(8,
                                                        data_parallel=4))):
            _, out = jcvp.run_cross_validation_parallel(
                jcfg, jtable, rnaseq_csv=paths["rnaseq_csv"],
                results_dir=tmp / f"jax_{label}",
                models_dir=tmp / f"jax_{label}", mesh=mesh)
            runs[label] = out
    torch.save(inits, tmp / "inits.pt")
    mp.spawn(_worker, nprocs=4, join=True,
             args=(4, str(tmp / "store"), root, tmp / "inits.pt", tmp))
    port = [torch.load(tmp / f"rank{r}.pt", weights_only=False)
            for r in range(4)]
    return runs, port


@pytest.mark.parametrize("label", list(MESHES))
def test_fold_mesh_matches_jax(jax_and_port, label):
    """rnaseq_only's 3 folds on the port's 4x1 fold mesh against JAX's
    ``make_fold_mesh(4)``, and on its 2x2 fold x data mesh against JAX's
    ``make_fold_mesh(8, data_parallel=4)`` (2 fold rows of 4 data devices):
    every rank's record of every fold within JAX's 1e-4."""
    jruns, port = jax_and_port
    want = jruns[label]
    for res in port:
        got = res[label]
        assert len(got) == len(want) == 3
        for o, jo in zip(got, want):
            assert (o["fold"], o["best_epoch"], o["epochs_run"]) == \
                (jo.fold, jo.best_epoch, jo.epochs_run)
            for key in ("train_loss", "val_loss"):
                np.testing.assert_allclose(
                    [h[key] for h in o["history"]],
                    [h[key] for h in jo.history], rtol=1e-4, err_msg=key)
            np.testing.assert_allclose(
                [h["val_c_index"] for h in o["history"]],
                [h["val_c_index"] for h in jo.history], atol=1e-4)


# ---------------------------------------------------------------------------
# The CLIs
# ---------------------------------------------------------------------------

def _argv(root, tag, *extra):
    return ["--data-root", str(root), "--results-dir",
            str(root / tag / "results"), "--models-dir",
            str(root / tag / "models"), "--synthetic",
            "--synthetic-patients", "20", "--backbone", "simple_cnn",
            "--image-shape", "16,16,8", "--epochs", "2", "--n-folds", "2",
            "--device", "cpu", *extra]


def _held(got, want):
    """Two cv_results payloads: equal but for each fold's C-index (1e-6)
    and the mean and spread made of them."""
    got, want = dict(got), dict(want)
    for a, b in zip(got.pop("fold_results"), want.pop("fold_results")):
        a, b = dict(a), dict(b)
        assert abs(a.pop("best_c_index") - b.pop("best_c_index")) <= 1e-6
        assert a == b
    for key in ("c_index_mean", "c_index_std"):
        assert abs(got.pop(key) - want.pop(key)) <= 1e-6
    assert got == want


@pytest.mark.parametrize("flags", [["--fold-parallel", "2"],
                                   ["--fold-parallel", "4", "--fold-dp",
                                    "2"]],
                         ids=["fold_mesh_2", "fold_mesh_4_dp_2"])
def test_cli_fold_mesh_end_to_end(tmp_path, flags):
    """The partial_modality CLI with ``--fold-parallel 2`` (2 ranks, one
    fold each) and ``--fold-parallel 4 --fold-dp 2`` (2 fold rows of 2
    data ranks): the ranks started by the CLI, cv_results.json written
    once and equal to the one-device run's, the two folds written with
    their .meta.json."""
    one = pmt.main(_argv(tmp_path, "one", "--fold-parallel", "1"))
    got = pmt.main(_argv(tmp_path, "mesh", *flags))
    on_disk = json.loads((tmp_path / "mesh" / "results" / "partial_modality"
                          / "cv_results.json").read_text())
    assert on_disk == got
    _held(got, one)
    models = tmp_path / "mesh" / "models" / "partial_modality"
    assert sorted(p.name for p in models.iterdir()) == [
        f"fold_{k}_best.pt{s}" for k in (1, 2) for s in ("", ".meta.json")]
    assert [c.name for c in fold_checkpoints(tmp_path / "mesh" / "models",
                                             "partial_modality")] == \
        ["fold_1_best.pt", "fold_2_best.pt"]
    assert not list((tmp_path / "mesh" / "results").glob(".rendezvous*"))


def test_sweep_cli_on_a_mesh(tmp_path):
    """The sweep CLI with ``--sweep-mesh 2`` (2 ranks, 3 candidates padded
    to 4): every candidate reported once, as without the mesh; the
    coordinator's sweep_results.json holds the 3."""
    base = ["--model", "partial_modality", "--seeds", "42,43,44"]
    one = sweep.main(_argv(tmp_path, "one", *base))
    got = sweep.main(_argv(tmp_path, "mesh", *base, "--sweep-mesh", "2"))
    assert len(got) == 3
    assert [(r["seed"], r["learning_rate"], r["best_epoch"]) for r in got] \
        == [(r["seed"], r["learning_rate"], r["best_epoch"]) for r in one]
    for r, w in zip(got, one):
        assert abs(r["best_c_index"] - w["best_c_index"]) <= 1e-6
    board = json.loads((tmp_path / "mesh" / "results" / "partial_modality"
                        / "sweep_results.json").read_text())
    assert [c["seed"] for c in board["candidates"]] == \
        [r["seed"] for r in got]


@pytest.mark.parametrize("main,flags,raises,match", [
    (pmt.main, ["--multihost", "--fold-parallel", "2"], SystemExit,
     "--multihost builds its own global mesh over every device of every "
     "host; drop --mesh/--fold-parallel"),
    (pmt.main, ["--fold-parallel", "4", "--fold-dp", "3"], ValueError,
     "4 devices not divisible by data=3"),
    (pmt.main, ["--fold-parallel", "2", "--mesh", "2"], SystemExit,
     "--fold-parallel is mutually exclusive with --mesh/--tp/--resume"),
    (sweep.main, ["--sweep-mesh", "2", "--fold-parallel", "2"], SystemExit,
     "--fold-parallel is not supported by the sweep driver \\(candidates "
     "parallelize via --sweep-mesh\\)"),
], ids=["multihost", "fold_dp", "mesh", "sweep_fold_parallel"])
def test_cli_usage_errors(tmp_path, main, flags, raises, match):
    """JAX's usage errors (``scripts/training/common.py``,
    ``scripts/training/sweep.py``), before anything is built."""
    with pytest.raises(raises, match=match):
        main(_argv(tmp_path, "x", *flags))
    assert not (tmp_path / "data").exists()


@pytest.mark.parametrize("main,flags,name", [
    (pmt.main, ["--fold-parallel", "2"], "--fold-parallel"),
    (sweep.main, ["--model", "partial_modality", "--sweep-mesh", "2"],
     "--sweep-mesh")], ids=["fold_parallel", "sweep_mesh"])
def test_cli_mesh_needs_a_gpu_a_rank(tmp_path, monkeypatch, main, flags,
                                     name):
    """On CUDA (the default device) each spawned rank takes a GPU: on a
    host of one GPU (faked), 2 ranks raise before anything is built."""
    monkeypatch.setattr(torch.cuda, "is_available", lambda: True)
    monkeypatch.setattr(torch.cuda, "device_count", lambda: 1)
    argv = [a for a in _argv(tmp_path, "x", *flags)
            if a not in ("--device", "cpu")]
    with pytest.raises(ValueError, match=f"{name} 2 needs 2 GPUs"):
        main(argv)
    assert not (tmp_path / "data").exists()
