"""The port's vmapped hyperparameter sweep (``train/sweep.py``) and its CLI
against the port's sequential driver and the JAX package's
``train/sweep.py``, on the CPU.

Inputs come from numpy seeds. vmap's per-sample fallback is an error
throughout (``tests/test_torch_cv_parallel.py``). Tolerances:
  * the anchor candidate (seed = cfg.seed, lr = cfg.learning_rate,
    dropout on) against the sequential driver's fold 1: train and val loss
    rtol 1e-4, LRs, epochs and the best epoch exact, val C-index 1e-6
    unless a comparable pair whose hazards differ by under 1e-5 explains it
    (the reason for 1e-4 rather than bit equality is in
    ``tests/test_torch_cv_parallel.py``);
  * against JAX's sweep from JAX's initial weights, dropout off on both
    sides: the leaderboard's order, seeds, learning rates and best epochs
    exact, best C-index within the C-index tolerance above, computed from
    every candidate's pooled hazards on the fold's validation rows; train
    losses rtol 1e-4;
  * ``sweep_results.json``: JAX's keys, exactly.
No test here launches a CUDA kernel.
"""

import dataclasses
import json

import flax.linen as fnn
import numpy as np
import pytest
import torch

from multimodal_survival_prediction_tpu import config as jconfig
from multimodal_survival_prediction_tpu.data.synthetic import (
    SyntheticCohortSpec as JSpec,
)
from multimodal_survival_prediction_tpu.data.synthetic import (
    generate_synthetic_cohort as jgen,
)
from multimodal_survival_prediction_tpu.ops import resample as jr
from multimodal_survival_prediction_tpu.train import cv as jcv
from multimodal_survival_prediction_tpu.train import engine as jengine
from multimodal_survival_prediction_tpu.train import sweep as jsweep
from multimodal_survival_prediction_tpu_torch.config import ALL_CONFIGS
from multimodal_survival_prediction_tpu_torch.data.datasets import CohortArrays
from multimodal_survival_prediction_tpu_torch.data.matching_table import (
    load_matching_table,
)
from multimodal_survival_prediction_tpu_torch.io import jax_import
from multimodal_survival_prediction_tpu_torch.models.layers import Dropout
from multimodal_survival_prediction_tpu_torch.train import cv, cv_parallel
from multimodal_survival_prediction_tpu_torch.train import sweep

IMAGE_SHAPE = (16, 16, 8)


@pytest.fixture(autouse=True)
def _vmap_fallback_is_an_error():
    fc = torch._C._functorch
    was, threads = fc._is_vmap_fallback_enabled(), torch.get_num_threads()
    # test workers share the host's cores: more threads only spin
    torch.set_num_threads(min(threads, 2))
    fc._set_vmap_fallback_warning_enabled(True)
    fc._set_vmap_fallback_enabled(False)
    jr._matrices.cache_clear()  # see tests/test_torch_cv.py
    yield
    jr._matrices.cache_clear()
    fc._set_vmap_fallback_enabled(was)
    fc._set_vmap_fallback_warning_enabled(False)
    torch.set_num_threads(threads)


class _NoDropout(fnn.Module):
    """Stand-in for flax ``nn.Dropout``: the identity."""

    rate: float = 0.0
    deterministic: bool | None = None

    def __call__(self, x, deterministic=None, rng=None):
        return x


@pytest.fixture(scope="module")
def cohort(tmp_path_factory):
    root = tmp_path_factory.mktemp("sweep_cohort")
    jtable, paths = jgen(root, JSpec(n_patients=24, rna_dim=24, seed=2,
                                     p_imaging=0.6,
                                     image_shapes=((12, 20, 20),
                                                   (10, 18, 16))))
    return dict(jtable=jtable, rows=load_matching_table(
        paths["matching_table"]), paths=paths, root=root)


def _c_index_tolerance(arrays, rows, hazards, margin=1e-5):
    t = arrays["time"][rows]
    e = arrays["event"][rows] > 0
    v = arrays["svalid"][rows] > 0
    comp = ((t[:, None] < t[None, :]) & e[:, None]) | (
        (t[:, None] == t[None, :]) & e[:, None] & ~e[None, :])
    comp &= v[:, None] & v[None, :]
    near = np.abs(hazards[:, None] - hazards[None, :]) < margin
    return 1e-6 + (comp & near).sum() / max(comp.sum(), 1)


def _record_evaluations(monkeypatch, out):
    evaluate = cv.Trainer.evaluate

    def recorded(self, state, data, indices):
        c, loss, h = evaluate(self, state, data, indices)
        out.append(np.asarray(h, np.float64))
        return c, loss, h

    monkeypatch.setattr(cv.Trainer, "evaluate", recorded)


def test_anchor_candidate_matches_sequential_fold1(cohort, tmp_path,
                                                   monkeypatch):
    """partial_modality (simple_cnn, dropout on): of the candidates (42, 43)
    x (lr, 3 lr), the one with cfg.seed and cfg.learning_rate follows the
    sequential driver's fold 1, and sweep_results.json ranks all four."""
    cfg = dataclasses.replace(ALL_CONFIGS["partial_modality"],
                              image_shape=IMAGE_SHAPE, n_folds=2,
                              num_epochs=3)
    prepared = cv.prepare_cv_data(cfg, cohort["rows"], rnaseq_csv=cohort[
        "paths"]["rnaseq_csv"], device="cpu")
    hazards = []
    _record_evaluations(monkeypatch, hazards)
    _, seq = cv.run_cross_validation(
        cfg, None, results_dir=tmp_path / "s", models_dir=tmp_path / "s",
        backbone="simple_cnn", prepared=prepared, device="cpu")
    lr = cfg.learning_rate
    board = sweep.run_hyperparameter_sweep(
        cfg, None, seeds=(42, 43), learning_rates=(lr, 3 * lr),
        backbone="simple_cnn", results_dir=tmp_path / "r",
        prepared=prepared, device="cpu")
    assert len(board) == 4
    assert sorted((r["seed"], r["learning_rate"]) for r in board) == \
        [(42, lr), (42, 3 * lr), (43, lr), (43, 3 * lr)]
    anchor = next(r for r in board
                  if (r["seed"], r["learning_rate"]) == (42, lr))
    fold1 = seq[0]
    assert anchor["best_epoch"] == fold1.best_epoch
    assert [h["lr"] for h in anchor["history"]] == \
        [h["lr"] for h in fold1.history]
    val_rows = prepared[1][0][1]
    for h, sh, hz in zip(anchor["history"], fold1.history, hazards[:3]):
        assert h["epoch"] == sh["epoch"]
        np.testing.assert_allclose(h["train_loss"], sh["train_loss"],
                                   rtol=1e-4)
        np.testing.assert_allclose(h["val_loss"], sh["val_loss"], rtol=1e-4)
        tol = _c_index_tolerance(prepared[0].arrays, val_rows, hz)
        assert abs(h["val_c_index"] - sh["val_c_index"]) <= tol
    on_disk = json.loads((tmp_path / "r" / "partial_modality"
                          / "sweep_results.json").read_text())
    assert on_disk == {"model": cfg.display_name, "fold": 1, "num_epochs": 3,
                       "candidates": [{k: v for k, v in r.items()
                                       if k != "history"} for r in board]}
    assert [c["best_c_index"] for c in on_disk["candidates"]] == sorted(
        (c["best_c_index"] for c in on_disk["candidates"]), reverse=True)


def test_sweep_matches_jax(cohort, tmp_path, monkeypatch):
    """rnaseq_only, seeds (42, 43) x lrs (1e-4, 3e-4), 3 epochs on fold 2,
    from JAX's initial weights (recorded through ``Trainer.init_state`` in
    candidate order), dropout off on both sides."""
    import jax

    monkeypatch.setattr(fnn, "Dropout", _NoDropout)
    over = dict(n_folds=2, image_shape=IMAGE_SHAPE)
    jcfg = jconfig.RNASEQ_ONLY.with_overrides(**over)
    tcfg = dataclasses.replace(ALL_CONFIGS["rnaseq_only"], **over)
    inits, init_state = [], jengine.Trainer.init_state

    def recorded(self, *a, **k):
        state = init_state(self, *a, **k)
        tree = jax.tree_util.tree_map(np.asarray, {
            "params": state.params, "batch_stats": state.batch_stats})
        inits.append({n: torch.from_numpy(np.array(v)) for n, v in
                      jax_import.export_torch_state_dict(
                          "rnaseq_only", tree).items()})
        return state

    monkeypatch.setattr(jengine.Trainer, "init_state", recorded)
    kw = dict(seeds=(42, 43), learning_rates=(1e-4, 3e-4), fold=2,
              num_epochs=3)
    jboard = jsweep.run_hyperparameter_sweep(
        jcfg, cohort["jtable"], rnaseq_csv=cohort["paths"]["rnaseq_csv"],
        results_dir=tmp_path / "jax", **kw)
    assert len(inits) == 4
    jarr, splits = jcv.prepare_cv_data(
        jcfg, cohort["jtable"], rnaseq_csv=cohort["paths"]["rnaseq_csv"])
    tarr = CohortArrays(patient_ids=list(jarr.patient_ids),
                        arrays={k: v.copy() for k, v in jarr.arrays.items()},
                        ingest_mode=jarr.ingest_mode)

    def start_from_jax(k, state):
        state.model.load_state_dict(inits[k], strict=True)
        for m in state.model.modules():
            if isinstance(m, Dropout):
                m.p = 0.0

    evals, build = [], cv_parallel._build_parallel_eval_step

    def recording(trainer):  # every eval step's (K, B) hazards
        eval_step = build(trainer)

        def recorded(state, batch):
            hazard, loss = eval_step(state, batch)
            evals.append(hazard.double().numpy())
            return hazard, loss

        return recorded

    monkeypatch.setattr(cv_parallel, "_build_parallel_eval_step", recording)
    board = sweep.run_hyperparameter_sweep(
        tcfg, None, results_dir=tmp_path / "port", prepared=(tarr, splits),
        init_hook=start_from_jax, device="cpu", **kw)

    # the C-index tolerance from every candidate's pooled hazards on the
    # fold's validation rows, every epoch
    val_rows = splits[1][1]
    steps = len(evals) // 3
    tol = max(_c_index_tolerance(tarr.arrays, val_rows, h[: len(val_rows)])
              for e in range(3)
              for h in np.concatenate(evals[e * steps:(e + 1) * steps], 1))
    assert [(r["seed"], r["learning_rate"], r["best_epoch"])
            for r in board] == \
        [(r["seed"], r["learning_rate"], r["best_epoch"]) for r in jboard]
    for r, jr_ in zip(board, jboard):
        assert abs(r["best_c_index"] - jr_["best_c_index"]) <= tol
        np.testing.assert_allclose([h["train_loss"] for h in r["history"]],
                                   [h["train_loss"] for h in jr_["history"]],
                                   rtol=1e-4)
        assert [h["lr"] for h in r["history"]] == pytest.approx(
            [h["lr"] for h in jr_["history"]], rel=1e-12)
    got = json.loads((tmp_path / "port" / "rnaseq_only"
                      / "sweep_results.json").read_text())
    want = json.loads((tmp_path / "jax" / "rnaseq_only"
                       / "sweep_results.json").read_text())
    assert list(got) == list(want)
    assert [list(c) for c in got["candidates"]] == \
        [list(c) for c in want["candidates"]]
    assert {k: got[k] for k in ("model", "fold", "num_epochs")} == \
        {k: want[k] for k in ("model", "fold", "num_epochs")}


# ---------------------------------------------------------------------------
# The CLI
# ---------------------------------------------------------------------------

def _argv(tmp_path, *extra):
    return ["--data-root", str(tmp_path), "--results-dir",
            str(tmp_path / "results"), "--synthetic", "--synthetic-patients",
            "16", "--model", "partial_modality", "--backbone", "simple_cnn",
            "--image-shape", "16,16,8", "--epochs", "1", "--n-folds", "2",
            "--device", "cpu", *extra]


def test_sweep_cli_end_to_end_on_cpu(tmp_path, capsys):
    board = sweep.main(_argv(tmp_path, "--seeds", "42,43", "--lrs",
                             "1e-4,3e-4"))
    assert len(board) == 4
    out = capsys.readouterr().out
    assert "Partial Modality (Gated) sweep — top candidates:" in out
    on_disk = json.loads((tmp_path / "results" / "partial_modality"
                          / "sweep_results.json").read_text())
    assert list(on_disk) == ["model", "fold", "num_epochs", "candidates"]
    assert [list(c) for c in on_disk["candidates"]] == \
        [["seed", "learning_rate", "best_c_index", "best_epoch"]] * 4


@pytest.mark.parametrize("flag", [
    ["--mesh", "2"], ["--tp", "2"], ["--fold-parallel", "1"],
    ["--fold-dp", "2"], ["--resume"], ["--profile-dir", "p"],
    ["--streaming"], ["--sharded-risk-set"], ["--multihost"]],
    ids=lambda v: v[0])
def test_sweep_cli_refuses_what_jax_refuses(tmp_path, flag):
    with pytest.raises(SystemExit,
                       match="is not supported by the sweep driver"):
        sweep.main(_argv(tmp_path, *flag))
    assert not (tmp_path / "data").exists()


def test_sweep_cli_takes_the_aot_cache(tmp_path, monkeypatch):
    """``--aot-cache DIR``, which JAX's sweep CLI refuses (it caches the
    sequential drivers' XLA programs there), routes the sweep's kernel
    builds through the kernel-build cache; the leaderboard is unchanged."""
    from multimodal_survival_prediction_tpu_torch.io import aot_cache

    monkeypatch.setattr(aot_cache, "CACHE_DIR", None)  # put back after
    plain = sweep.main(_argv(tmp_path / "a"))
    cached = sweep.main(_argv(tmp_path / "b", "--aot-cache",
                              str(tmp_path / "aot")))
    assert aot_cache.CACHE_DIR == tmp_path / "aot"
    assert [{k: v for k, v in r.items() if k != "history"} for r in cached] \
        == [{k: v for k, v in r.items() if k != "history"} for r in plain]


@pytest.mark.skipif(torch.cuda.is_available(), reason="needs no CUDA")
def test_sweep_defaults_to_cuda(tmp_path):
    cfg = ALL_CONFIGS["rnaseq_only"]
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        sweep.run_hyperparameter_sweep(cfg, [])
    argv = [a for a in _argv(tmp_path) if a not in ("--device", "cpu")]
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        sweep.main(argv)
