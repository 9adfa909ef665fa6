"""The CV driver and every training CLI in bfloat16 on the CPU, against the
JAX driver with ``dtype=jnp.bfloat16``.

A 2-fold run of ``rnaseq_only`` and of ``partial_modality`` (simple CNN,
16x16x8, 24 genes) from the JAX driver's initial weights with dropout off
on both sides; the JAX driver runs the same folds in float32 too, and its
bf16-vs-f32 gap sets each limit (the port's bf16-vs-JAX-bf16 gap is at
most twice it; measured numbers beside each check). C-indices agree but
for the comparable pairs whose hazards lie closer than twice the largest
hazard difference between the two bf16 runs (their order may swap).
Parameters, optimizer state and fold checkpoints stay float32 and the
checkpoints' .meta.json is the float32 run's, with no dtype (as JAX).
Then ``--bf16`` through every family's CLI end to end.
"""

import dataclasses
import importlib

import flax.linen as fnn
import jax.numpy as jnp
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
from multimodal_survival_prediction_tpu_torch.config import ALL_CONFIGS
from multimodal_survival_prediction_tpu_torch.data.datasets import CohortArrays
from multimodal_survival_prediction_tpu_torch.data.matching_table import (
    load_matching_table,
)
from multimodal_survival_prediction_tpu_torch.io import jax_import
from multimodal_survival_prediction_tpu_torch.io.checkpoint import (
    load_checkpoint,
    load_fold_meta,
)
from multimodal_survival_prediction_tpu_torch.io import results as tresults
from multimodal_survival_prediction_tpu_torch.models.layers import Dropout
from multimodal_survival_prediction_tpu_torch.ops import fused_dense as fd
from multimodal_survival_prediction_tpu_torch.ops import resample as rs
from multimodal_survival_prediction_tpu_torch.train import cli, cv, engine
from multimodal_survival_prediction_tpu_torch.train.predict import (
    fold_checkpoints,
    predict_risk,
)

IMAGE_SHAPE = (16, 16, 8)
SPEC = dict(n_patients=32, rna_dim=24, seed=5, p_imaging=0.6,
            image_shapes=((12, 20, 20), (10, 18, 16)))


@pytest.fixture(autouse=True)
def _no_cached_jax_tracers():
    """The JAX resample cache can hold jit tracers (see
    tests/test_torch_cv.py); each test starts and ends with it empty."""
    jr._matrices.cache_clear()
    yield
    jr._matrices.cache_clear()


class _NoDropout(fnn.Module):
    """Stand-in for flax ``nn.Dropout``: the identity."""

    rate: float = 0.0
    deterministic: bool | None = None

    def __call__(self, x, deterministic=None, rng=None):
        return x


def _launches():
    return ([k.launches for k in fd.KERNELS]
            + [k.launches_bf16 for k in fd.KERNELS] + [rs.wpass.launches])


@pytest.fixture(scope="module")
def cohort(tmp_path_factory):
    root = tmp_path_factory.mktemp("bf16_cohort")
    jtable, paths = jgen(root, JSpec(**SPEC))
    return dict(jtable=jtable, paths=paths)


def _sd(state, name):
    import jax

    tree = jax.tree_util.tree_map(np.asarray, {
        "params": state.params, "batch_stats": state.batch_stats})
    return {k: torch.from_numpy(np.array(v)) for k, v in
            jax_import.export_torch_state_dict(name, tree).items()}


def _recorder(monkeypatch, trainer_cls, out):
    """Record every train epoch's mean loss and every evaluation's
    (C-index, hazards as float64, rows) into ``out``."""
    train_epoch, evaluate = trainer_cls.train_epoch, trainer_cls.evaluate

    def epoch(self, *a, **k):
        state, loss = train_epoch(self, *a, **k)
        out["loss"].append(loss)
        return state, loss

    def evaluated(self, state, data, indices):
        c, loss, h = evaluate(self, state, data, indices)
        out["eval"].append((c, np.asarray(h, np.float64),
                            np.asarray(indices)))
        return c, loss, h

    monkeypatch.setattr(trainer_cls, "train_epoch", epoch)
    monkeypatch.setattr(trainer_cls, "evaluate", evaluated)


def _swappable_share(arrays, rows, hazards, margin):
    """The share of comparable pairs among ``rows`` whose hazards lie
    within ``margin`` (their order may differ between two runs), + 1e-6."""
    t = arrays["time"][rows]
    e = arrays["event"][rows] > 0
    v = arrays["svalid"][rows] > 0
    comp = ((t[:, None] < t[None, :]) & e[:, None]) | (
        (t[:, None] == t[None, :]) & e[:, None] & ~e[None, :])
    comp &= v[:, None] & v[None, :]
    near = np.abs(hazards[:, None] - hazards[None, :]) <= margin
    return 1e-6 + (comp & near).sum() / max(comp.sum(), 1)


# name -> the measured gaps (port vs JAX bf16 / JAX bf16 vs f32): the
# largest per-epoch train loss gap (relative to the f32 loss) and the
# largest hazard gap over the four evaluations
MEASURED = {
    "rnaseq_only": "losses 1.35e-3 / 1.14e-3; hazards 1.10e-3 / 1.15e-3",
    "partial_modality": "losses 5.7e-4 / 8.1e-3; hazards 9.8e-4 / 9.0e-4",
}


@pytest.mark.parametrize("name", list(MEASURED))
def test_bf16_driver_matches_jax_bf16(name, cohort, tmp_path, monkeypatch):
    """Two folds of two epochs in bf16 on both sides, from the JAX driver's
    initial weights, dropout off. Every epoch's train loss and every
    evaluation's hazards within twice JAX's own bf16-vs-f32 gap; LR
    histories, best epochs and sizes exact where the C-indices agree."""
    monkeypatch.setattr(fnn, "Dropout", _NoDropout)
    over = dict(n_folds=2, num_epochs=2, image_shape=IMAGE_SHAPE)
    jcfg = jconfig.ALL_CONFIGS[name].with_overrides(**over)
    tcfg = dataclasses.replace(ALL_CONFIGS[name], **over)
    jarr, splits = jcv.prepare_cv_data(
        jcfg, cohort["jtable"], rnaseq_csv=cohort["paths"]["rnaseq_csv"],
        resample="device")
    inits, runs = {}, {}

    def capture(fold, state):
        inits[fold] = _sd(state, name)

    for label, dtype in (("f32", None), ("bf16", jnp.bfloat16)):
        rec = runs[label] = {"loss": [], "eval": []}
        with monkeypatch.context() as m:
            _recorder(m, jengine.Trainer, rec)
            rec["payload"], rec["out"] = jcv.run_cross_validation(
                jcfg, None, results_dir=tmp_path / label,
                models_dir=tmp_path / label, backbone="simple_cnn",
                dtype=dtype, prepared=(jarr, splits), init_hook=capture)

    def start_from_jax(fold, state):
        state.model.load_state_dict(inits[fold], strict=True)
        for m in state.model.modules():
            if isinstance(m, Dropout):
                m.p = 0.0

    port = runs["port"] = {"loss": [], "eval": []}
    _recorder(monkeypatch, engine.Trainer, port)
    tarr = CohortArrays(patient_ids=list(jarr.patient_ids),
                        arrays={k: v.copy() for k, v in jarr.arrays.items()},
                        ingest_mode=jarr.ingest_mode)
    before = _launches()
    port["payload"], port["out"] = cv.run_cross_validation(
        tcfg, None, results_dir=tmp_path / "port",
        models_dir=tmp_path / "port", backbone="simple_cnn",
        dtype=torch.bfloat16, prepared=(tarr, splits),
        init_hook=start_from_jax, device="cpu")
    assert _launches() == before  # plain versions on the CPU

    f32, b16 = runs["f32"], runs["bf16"]
    loss32, loss16 = np.array(f32["loss"]), np.array(b16["loss"])
    jgap = float((np.abs(loss16 - loss32) / np.abs(loss32)).max())
    pgap = float((np.abs(np.array(port["loss"]) - loss16)
                  / np.abs(loss32)).max())
    assert len(port["loss"]) == len(loss16) == 4
    assert pgap <= 2 * jgap, ("losses", pgap, jgap)

    evals = list(zip(port["eval"], b16["eval"], f32["eval"]))
    assert len(evals) == 4
    jgap = max(float(np.abs(b[1] - f[1]).max()) for _, b, f in evals)
    pgap = max(float(np.abs(p[1] - b[1]).max()) for p, b, _ in evals)
    assert pgap <= 2 * jgap, ("hazards", pgap, jgap)
    for (c, h, rows), (jc, jh, jrows), _ in evals:
        assert rows.tolist() == jrows.tolist()
        margin = 2 * float(np.abs(h - jh).max())
        assert abs(c - jc) <= _swappable_share(jarr.arrays, rows, jh, margin)

    for o, jo in zip(port["out"], b16["out"]):
        for field in ("fold", "epochs_run", "train_size", "val_size",
                      "train_survival_size"):
            assert getattr(o, field) == getattr(jo, field), field
    assert port["payload"]["hyperparameters"] == \
        b16["payload"]["hyperparameters"]

    for fold in (1, 2):
        path = tmp_path / "port" / name / f"fold_{fold}_best.pt"
        ckpt = load_checkpoint(path)
        assert set(ckpt) == set(inits[fold])
        assert all(t.dtype == inits[fold][k].dtype for k, t in ckpt.items())
        assert all(t.dtype == torch.float32 for t in ckpt.values()
                   if t.is_floating_point())
        meta = load_fold_meta(path)
        jmeta = load_fold_meta(tmp_path / "bf16" / name
                               / f"fold_{fold}_best.msgpack")
        assert sorted(meta) == sorted(jmeta) and "dtype" not in meta


def test_bf16_trainer_keeps_float32_state():
    """In a bf16 run the parameters, their gradients and Adam's moments are
    float32 and a step moves the parameters."""
    from multimodal_survival_prediction_tpu_torch.train.adapters import (
        make_adapters,
        make_model_and_adapters,
    )

    cfg = ALL_CONFIGS["rnaseq_only"]
    b2i, haa = make_adapters(cfg)
    tr = engine.Trainer(
        lambda g: make_model_and_adapters(cfg, rna_dim=24, generator=g,
                                          dtype=torch.bfloat16)[0],
        b2i, haa, engine.TrainConfig(batch_size=8), device="cpu")
    state = tr.init_state(fold=1)
    rng = np.random.default_rng(0)
    batch = {"rnaseq": torch.from_numpy(rng.normal(size=(8, 24)).astype(
        np.float32)), "time": torch.arange(1.0, 9.0),
        "event": torch.ones(8), "svalid": torch.ones(8),
        "valid": torch.ones(8)}
    before = [p.detach().clone() for p in state.model.parameters()]
    loss = tr.train_step(state, batch, 1e-3)
    assert loss.dtype == torch.float32 and torch.isfinite(loss)
    assert all(p.dtype == torch.float32 for p in state.model.parameters())
    assert all(t.dtype == torch.float32
               for t in state.opt_state.mu + state.opt_state.nu)
    assert any(not torch.equal(a, b) for a, b in
               zip(before, state.model.parameters()))


@pytest.mark.parametrize("dtype", [torch.float16, "float16", torch.float64,
                                   "bfloat16"])
def test_driver_refuses_other_compute_dtypes(tmp_path, dtype):
    with pytest.raises(ValueError, match="unsupported compute dtype"):
        cv.run_cross_validation(ALL_CONFIGS["rnaseq_only"], [],
                                results_dir=tmp_path, models_dir=tmp_path,
                                device="cpu", dtype=dtype)
    assert not any(tmp_path.iterdir())


ENTRIES = {
    "rnaseq_only": "train_rnaseq_only", "image_only": "image_only",
    "simple_fusion": "simple_fusion",
    "flexible_multimodal": "flexible_multimodal",
    "final": "final_multimodal", "partial_modality":
    "partial_modality_training", "simmim": "simmlm", "mmsurv": "mmsurv",
}


@pytest.mark.parametrize("name", list(ENTRIES))
def test_bf16_cli_end_to_end_on_cpu(name, cohort, tmp_path, monkeypatch):
    """``main([..., "--bf16"])`` of every family (simple CNN, 16x16x8, 2
    folds x 1 epoch; simmim with one stage-1 epoch): the driver gets
    ``dtype=torch.bfloat16``; every fold's C-index is finite;
    cv_results.json and both fold checkpoints are written, float32, with a
    .meta.json that names no dtype; predict_risk scores them (float32) to
    finite risks."""
    entry = importlib.import_module(
        f"multimodal_survival_prediction_tpu_torch.train.{ENTRIES[name]}")
    seen = []
    run = cli.run_cross_validation
    monkeypatch.setattr(cli, "run_cross_validation", lambda *a, **k: (
        seen.append(k["dtype"]) or run(*a, **k)))
    paths = cohort["paths"]
    results, models = tmp_path / "results", tmp_path / "models"
    extra = ["--stage1-epochs", "1"] if name == "simmim" else []
    before = _launches()
    payload = entry.main([
        "--data-root", str(paths["root"]), "--results-dir", str(results),
        "--models-dir", str(models), "--backbone", "simple_cnn",
        "--image-shape", "16,16,8", "--epochs", "1", "--n-folds", "2",
        "--device", "cpu", "--bf16", *extra])
    assert seen == [torch.bfloat16]
    assert _launches() == before
    loaded = tresults.load_cv_results(results / name)
    assert loaded["raw"] == payload and len(loaded["fold_scores"]) == 2
    assert all(np.isfinite(c) for c in loaded["fold_scores"])
    ckpts = fold_checkpoints(models, name)
    assert [p.name for p in ckpts] == ["fold_1_best.pt", "fold_2_best.pt"]
    for path in ckpts:
        assert all(t.dtype == torch.float32 for t in
                   load_checkpoint(path).values() if t.is_floating_point())
        assert "dtype" not in load_fold_meta(path)
    table = load_matching_table(paths["matching_table"])
    pred = predict_risk(ALL_CONFIGS[name], ckpts, table,
                        rnaseq_csv=paths["rnaseq_csv"], labeled_only=False,
                        device="cpu")
    assert pred["risk_score"].dtype == np.float32
    assert np.all(np.isfinite(pred["risk_score"]))
