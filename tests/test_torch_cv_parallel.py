"""The port's fold-parallel CV driver (``train/cv_parallel.py``) against
the port's sequential driver and against the JAX package's
``train/cv_parallel.py``, on the CPU, and the training CLI's
``--fold-parallel``.

Inputs come from numpy seeds and go to both sides. Every test runs with
functorch's vmap fallback warning on and the fallback itself off, so an op
without a batching rule raises instead of looping over the folds.
Tolerances:
  * ``_stack_fold_indices``: exact;
  * ``Optimizer.update_stacked`` against ``update`` per state: exact;
  * the vmapped epoch against the port's sequential epochs, per fold, with
    dropout on and unequal step counts, in float64: epoch losses 1e-5,
    parameters, BatchNorm running stats and Adam's moments rtol 2e-5 /
    atol 2e-6 (JAX's own limits, tests/test_cv_parallel.py); Adam's count,
    the step and each fold's dropout generator state exact. float64,
    because in float32 the gradient of a bias that feeds a train-mode
    BatchNorm is 0 in exact arithmetic, i.e. rounding noise, and Adam
    turns noise into steps of about lr whatever its size: the vmapped
    forward sums in another order (a batched matmul, a grouped
    convolution) than the sequential one, so such biases, and a few
    weights whose gradient nearly cancels, part by up to lr a step in
    float32 (measured: mlp.0.bias of rnaseq_only by 1.5e-4 after 6 steps
    at lr 1e-4), while the losses agree to 1e-6;
  * the driver against the port's sequential driver (dropout on) and
    against JAX's parallel driver (JAX's initial weights carried in,
    dropout off on both sides): train and val loss rtol 1e-4, val C-index
    1e-6 unless a comparable pair whose hazards differ by under 1e-5
    explains the difference, LR histories, best epochs, epochs run, sizes
    and the payload's other keys exact; each fold checkpoint's eval
    hazards on its validation rows within 1e-4 x their range + 1e-6 of
    the sequential driver's checkpoint's (not its tensors, for the reason
    above);
  * mmsurv's losses: rtol 5e-4, because its attention's key biases have a
    gradient 0 in exact arithmetic (a softmax ignores a shift common to
    its logits), noise that Adam turns into steps of about lr (the reason
    above; 1.2e-4 measured on the third epoch's val loss);
  * bf16 (``--bf16``) against the sequential bf16 driver: losses rtol 2e-2
    (bf16 rounding of grouped and plain convolutions' float32 sums lands on
    either side of a boundary) and the schedule, best epochs and sizes
    exact.
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
from multimodal_survival_prediction_tpu.train import cv_parallel as jcvp
from multimodal_survival_prediction_tpu.train import engine as jengine
from multimodal_survival_prediction_tpu_torch.config import (
    ALL_CONFIGS,
    PARTIAL_MODALITY,
)
from multimodal_survival_prediction_tpu_torch.data.datasets import CohortArrays
from multimodal_survival_prediction_tpu_torch.data.matching_table import (
    load_matching_table,
)
from multimodal_survival_prediction_tpu_torch.io import jax_import
from multimodal_survival_prediction_tpu_torch.io.checkpoint import (
    load_checkpoint,
    load_fold_meta,
)
from multimodal_survival_prediction_tpu_torch.models.layers import Dropout
from multimodal_survival_prediction_tpu_torch.ops import fused_dense as fd
from multimodal_survival_prediction_tpu_torch.ops import resample as rs
from multimodal_survival_prediction_tpu_torch.ops.cindex import (
    concordance_index,
)
from multimodal_survival_prediction_tpu_torch.train import cv, cv_parallel
from multimodal_survival_prediction_tpu_torch.train import engine
from multimodal_survival_prediction_tpu_torch.train import (
    partial_modality_training as pmt,
)
from multimodal_survival_prediction_tpu_torch.train.adapters import (
    make_adapters,
    make_model_and_adapters,
)
from multimodal_survival_prediction_tpu_torch.train.cv import make_trainers
from multimodal_survival_prediction_tpu_torch.train.predict import (
    fold_checkpoints,
    predict_risk,
)

IMAGE_SHAPE = (16, 16, 8)
SPEC = dict(n_patients=24, rna_dim=24, seed=0, p_imaging=0.6,
            image_shapes=((12, 20, 20), (10, 18, 16)))


@pytest.fixture(autouse=True)
def _vmap_fallback_is_an_error():
    """functorch's fallback warning on and the fallback off: an op without
    a batching rule raises."""
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


def _launches():
    return [k.launches for k in fd.KERNELS] + [rs.wpass.launches]


class _NoDropout(fnn.Module):
    """Stand-in for flax ``nn.Dropout``: the identity."""

    rate: float = 0.0
    deterministic: bool | None = None

    def __call__(self, x, deterministic=None, rng=None):
        return x


def _no_dropout(model):
    for m in model.modules():
        if isinstance(m, Dropout):
            m.p = 0.0


# ---------------------------------------------------------------------------
# _stack_fold_indices and the fallback guard
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("sizes,batch", [
    ((15, 20), 8), ((16, 16), 8), ((9, 30, 17), 4), ((3,), 8),
    ((40, 41, 39), 16), ((1, 12), 5)])
def test_stack_fold_indices_matches_jax(sizes, batch):
    rows = [np.arange(100 * i, 100 * i + n) for i, n in enumerate(sizes)]
    for seeds in ((0, 1, 2), None):
        def rngs():
            return ([np.random.default_rng(s) for s in seeds[:len(sizes)]]
                    if seeds else [None] * len(sizes))

        got = cv_parallel._stack_fold_indices(rows, batch, rngs())
        want = jcvp._stack_fold_indices(rows, batch, rngs())
        for a, b in zip(got, want):
            np.testing.assert_array_equal(a, b)
            assert a.dtype == b.dtype


def test_vmapped_calls_refuse_the_fallback():
    """``no_vmap_fallback`` (around every vmapped call of the driver) turns
    the per-sample fallback into an error, whatever the global setting."""
    torch._C._functorch._set_vmap_fallback_enabled(True)
    x = torch.randn(2, 5)
    torch.func.vmap(torch.histc)(x)  # no batching rule: loops, silently
    with cv_parallel.no_vmap_fallback(), pytest.raises(
            RuntimeError, match="vmap fallback"):
        torch.func.vmap(torch.histc)(x)
    assert torch._C._functorch._is_vmap_fallback_enabled()


@pytest.mark.parametrize("k", [1, 3])
@pytest.mark.parametrize("clip", [None, 1e9, 0.1])
@pytest.mark.parametrize("kind", ["adam", "adamw"])
def test_stacked_update_equals_update_per_state(kind, clip, k):
    """``Optimizer.update_stacked`` on K flat rows against ``update`` on
    each state's tensors, over five steps with per-state learning rates:
    parameters and moments bit-equal (one arithmetic serves both; each
    row's clip norm is reduced over its parameters' norms, as ``update``
    reduces it). clip 1e9 never binds, 0.1 always does."""
    tx = engine.Optimizer(engine.TrainConfig(optimizer=kind, grad_clip=clip,
                                             weight_decay=1e-4))
    shapes = [(16, 7), (16,), (5, 3, 3), (33,), (1,)]
    rng = np.random.default_rng(3)

    def draw():
        return [torch.from_numpy(rng.normal(size=s).astype(np.float32))
                for s in shapes]

    def flat(ts):
        return torch.cat([t.reshape(-1) for t in ts])

    params = [draw() for _ in range(k)]
    opt = [tx.init(p) for p in params]
    stacked = torch.stack([flat(p) for p in params])
    mu, nu = torch.zeros_like(stacked), torch.zeros_like(stacked)
    for step in range(1, 6):
        grads = [[3 * g for g in draw()] for _ in range(k)]
        lrs = [1e-3 * step * (i + 1) for i in range(k)]
        for i in range(k):
            updates, opt[i] = tx.update(grads[i], opt[i], params[i], lrs[i])
            torch._foreach_add_(params[i], updates)
        tx.update_stacked(torch.stack([flat(g) for g in grads]), mu, nu,
                          stacked, np.full(k, step),
                          torch.tensor(lrs)[:, None],
                          [t.numel() for t in params[0]])
        for i in range(k):
            assert opt[i].count == step
            assert torch.equal(stacked[i], flat(params[i]))
            assert torch.equal(mu[i], flat(opt[i].mu))
            assert torch.equal(nu[i], flat(opt[i].nu))


# ---------------------------------------------------------------------------
# The vmapped epoch against the sequential epochs
# ---------------------------------------------------------------------------

def _epoch_data(n=30, rna_dim=24, seed=5):
    rng = np.random.default_rng(seed)
    mask = (rng.uniform(size=(n, 3)) < 0.8).astype(np.float32)
    svalid = (rng.uniform(size=n) < 0.85).astype(np.float32)
    return {
        "image": (rng.normal(size=(n, *IMAGE_SHAPE, 1))
                  * mask[:, 0, None, None, None, None]).astype(np.float32),
        "rnaseq": (rng.normal(size=(n, rna_dim)) * mask[:, 1:2]).astype(
            np.float32),
        "clinical": (rng.uniform(0.3, 0.8, (n, 1)) * mask[:, 2:3]).astype(
            np.float32),
        "mask": mask,
        "time": rng.exponential(300.0, n).astype(np.float32),
        "event": ((rng.uniform(size=n) < 0.7) * svalid).astype(np.float32),
        "svalid": svalid,
    }


def _assert_states_close(got, want):
    """Two ``train_state_dict``s: model tensors and moments to JAX's
    limits, count, step and generator exact."""
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


@pytest.mark.parametrize("name", ["partial_modality", "rnaseq_only"])
def test_parallel_epoch_matches_sequential_per_fold(name):
    """Two folds with unequal step counts (2 vs 3 at batch 8), dropout on,
    two epochs at two learning rates, in float64 (module docstring): the
    vmapped epoch lands where two sequential epochs do, and the padded
    third step leaves the shorter fold's whole state alone."""
    cfg = dataclasses.replace(ALL_CONFIGS[name], batch_size=8,
                              image_shape=IMAGE_SHAPE)
    data = {k: torch.from_numpy(v).double()
            for k, v in _epoch_data().items()}
    rows = [np.arange(15), np.arange(10, 30)]
    lrs = (cfg.learning_rate, 2 * cfg.learning_rate)
    batch_to_inputs, hazard_and_aux = make_adapters(cfg)
    tcfg = engine.TrainConfig(
        batch_size=8, weight_decay=cfg.weight_decay, optimizer=cfg.optimizer,
        grad_clip=cfg.grad_clip, ties=cfg.ties)

    def trainer():
        return engine.Trainer(
            lambda g: make_model_and_adapters(
                cfg, rna_dim=24, backbone="simple_cnn",
                generator=g)[0].double(),
            batch_to_inputs, hazard_and_aux, tcfg, device="cpu")

    seq = []
    for f, r in zip((1, 2), rows):
        tr = trainer()
        state = tr.init_state(fold=f)
        shuffle = np.random.default_rng(100 + f)
        losses = [tr.train_epoch(state, data, r, shuffle, lrs[f - 1])[1]
                  for _ in range(2)]
        # the moments are plain tensors: no autograd history chained from
        # step to step (Adam's L2 term reads the parameters)
        assert not any(t.requires_grad for t in state.opt_state.mu
                       + state.opt_state.nu)
        seq.append((losses, engine.train_state_dict(state)))

    tr = trainer()
    stacked = cv_parallel.StackedState([tr.init_state(fold=1),
                                         tr.init_state(fold=2)])
    epoch = cv_parallel._build_parallel_train_epoch(tr)
    shuffles = [np.random.default_rng(101), np.random.default_rng(102)]
    par_losses = []
    for _ in range(2):
        idx, bv = cv_parallel._stack_fold_indices(rows, 8, shuffles)
        step_valid = bv.max(axis=2) > 0
        par_losses.append(epoch(stacked, cv_parallel.stacked_batches(
            tr, data, idx, bv), step_valid, np.asarray(lrs))[1].numpy())
    assert step_valid.tolist() == [[True, True, False], [True, True, True]]
    for k, (losses, want) in enumerate(seq):
        np.testing.assert_allclose([p[k] for p in par_losses], losses,
                                   rtol=1e-5)
        _assert_states_close(stacked.fold_train_state(k), want)
    assert stacked.count.tolist() == [4, 6]


# ---------------------------------------------------------------------------
# The driver against the sequential driver and against JAX's
# ---------------------------------------------------------------------------

@pytest.fixture(scope="module")
def cohort(tmp_path_factory):
    root = tmp_path_factory.mktemp("cvp_cohort")
    jtable, paths = jgen(root, JSpec(**SPEC))
    rows = load_matching_table(paths["matching_table"])
    return dict(jtable=jtable, rows=rows, paths=paths, root=root)


def _c_index_tolerance(arrays, rows, hazards, margin=1e-5):
    """1e-6 plus the share of comparable pairs among ``rows`` whose two
    hazards differ by under ``margin`` (their order may flip)."""
    t = arrays["time"][rows]
    e = arrays["event"][rows] > 0
    v = arrays["svalid"][rows] > 0
    comp = ((t[:, None] < t[None, :]) & e[:, None]) | (
        (t[:, None] == t[None, :]) & e[:, None] & ~e[None, :])
    comp &= v[:, None] & v[None, :]
    near = np.abs(hazards[:, None] - hazards[None, :]) < margin
    return 1e-6 + (comp & near).sum() / max(comp.sum(), 1)


def _fold_hazards(model_sd, cfg, arrays, rows, dtype=None):
    """A fold checkpoint's eval hazards on ``rows`` (the sequential
    Trainer's pooled evaluation)."""
    tr = make_trainers(cfg, arrays.arrays["rnaseq"].shape[1], "simple_cnn",
                       dtype, "cpu")[0]
    state = tr.init_state(fold=1)
    state.model.load_state_dict(model_sd, strict=True)
    return tr.evaluate(state, arrays.to_device("cpu"), rows)[2]


def _compare_runs(par, seq, arrays, splits, cfg, models=None, rtol=1e-4,
                  dtype=None):
    (payload, out), (spayload, sout) = par, seq
    assert len(out) == len(sout) == len(splits)
    for o, so, (_, val, _) in zip(out, sout, splits):
        for field in ("fold", "best_epoch", "epochs_run", "train_size",
                      "val_size", "train_survival_size"):
            assert getattr(o, field) == getattr(so, field), field
        assert [h["lr"] for h in o.history] == [h["lr"] for h in so.history]
        assert [h["epoch"] for h in o.history] == \
            [h["epoch"] for h in so.history]
        for key in ("train_loss", "val_loss"):
            np.testing.assert_allclose([h[key] for h in o.history],
                                       [h[key] for h in so.history],
                                       rtol=rtol, err_msg=key)
        if models is None:
            continue
        got = load_checkpoint(models[0] / cfg.name / f"fold_{o.fold}_best.pt")
        want = load_checkpoint(models[1] / cfg.name
                               / f"fold_{o.fold}_best.pt")
        assert list(got) == list(want)
        hz = _fold_hazards(want, cfg, arrays, val, dtype)
        if dtype is None:
            d = np.abs(_fold_hazards(got, cfg, arrays, val) - hz).max()
            assert d <= 1e-4 * np.ptp(hz) + 1e-6, (o.fold, d)
        tol = _c_index_tolerance(arrays.arrays, val, hz, margin=(
            1e-5 if dtype is None else 2e-2))
        for h, sh in zip(o.history, so.history):
            assert abs(h["val_c_index"] - sh["val_c_index"]) <= tol
        meta, smeta = (load_fold_meta(m / cfg.name / f"fold_{o.fold}_best.pt")
                       for m in models)
        assert meta.keys() == smeta.keys()
        assert {k: v for k, v in meta.items() if k != "best_c_index"} == \
            {k: v for k, v in smeta.items() if k != "best_c_index"}
    assert {k: v for k, v in payload.items() if not k.startswith("c_index")
            and k != "fold_results"} == \
        {k: v for k, v in spayload.items() if not k.startswith("c_index")
         and k != "fold_results"}


# the losses' limit where it is not 1e-4 (module docstring)
RTOL = {"mmsurv": 5e-4, "bf16": 2e-2}


@pytest.mark.parametrize("case", ["partial_modality", "early_stop", "simmim",
                                  "mmsurv", "bf16"])
def test_driver_matches_sequential_driver(case, cohort, tmp_path):
    """partial_modality through simple_cnn (dropout on, 2 folds x 3
    epochs), per-fold early stopping (patience 1 over 5 epochs: the folds
    stop at different epochs), SimMLM's two stages (1 stage-1 epoch), the
    MMsurv count-sketch buffers and ``--bf16``, each against the port's
    sequential driver on the same prepared cohort."""
    name = {"simmim": "simmim", "mmsurv": "mmsurv"}.get(case,
                                                        "partial_modality")
    over = dict(n_folds=2, num_epochs=3, image_shape=IMAGE_SHAPE)
    if case == "early_stop":
        over.update(num_epochs=5, patience=1)
    if case == "simmim":
        over["stage1_epochs"] = 1
    cfg = dataclasses.replace(ALL_CONFIGS[name], **over)
    dtype = torch.bfloat16 if case == "bf16" else None
    arrays, splits = cv.prepare_cv_data(
        cfg, cohort["rows"], rnaseq_csv=cohort["paths"]["rnaseq_csv"],
        device="cpu")
    kw = dict(backbone="simple_cnn", prepared=(arrays, splits), dtype=dtype,
              device="cpu", results_dir=tmp_path / "r")
    before = _launches()
    seq = cv.run_cross_validation(cfg, None, models_dir=tmp_path / "s", **kw)
    par = cv_parallel.run_cross_validation_parallel(
        cfg, None, models_dir=tmp_path / "p", **kw)
    assert _launches() == before
    _compare_runs(par, seq, arrays, splits, cfg,
                  models=(tmp_path / "p", tmp_path / "s"),
                  rtol=RTOL.get(case, 1e-4), dtype=dtype)
    if case == "early_stop":
        runs = [o.epochs_run for o in par[1]]
        assert min(runs) < 5, runs  # a fold stopped early


def test_driver_matches_jax(cohort, tmp_path, monkeypatch):
    """rnaseq_only (AdamW, cosine, batch 16), 3 folds x 3 epochs, against
    JAX's ``run_cross_validation_parallel`` from JAX's stacked initial
    states (recorded through ``Trainer.init_state``, one per fold, mapped
    with ``io/jax_import.py``'s export map and passed in through
    ``init_hook``), dropout off on both sides."""
    import jax

    monkeypatch.setattr(fnn, "Dropout", _NoDropout)
    over = dict(n_folds=3, num_epochs=3, image_shape=IMAGE_SHAPE)
    jcfg = jconfig.RNASEQ_ONLY.with_overrides(**over)
    tcfg = dataclasses.replace(ALL_CONFIGS["rnaseq_only"], **over)
    inits, init_state = [], jengine.Trainer.init_state

    def recorded(self, *a, **k):
        state = init_state(self, *a, **k)
        tree = jax.tree_util.tree_map(np.asarray, {
            "params": state.params, "batch_stats": state.batch_stats})
        inits.append({k: torch.from_numpy(np.array(v)) for k, v in
                      jax_import.export_torch_state_dict(
                          "rnaseq_only", tree).items()})
        return state

    monkeypatch.setattr(jengine.Trainer, "init_state", recorded)
    jpayload, jout = jcvp.run_cross_validation_parallel(
        jcfg, cohort["jtable"], rnaseq_csv=cohort["paths"]["rnaseq_csv"],
        results_dir=tmp_path / "jax", models_dir=tmp_path / "jax")
    assert len(inits) == 3
    jarr, splits = jcv.prepare_cv_data(
        jcfg, cohort["jtable"], rnaseq_csv=cohort["paths"]["rnaseq_csv"])
    tarr = CohortArrays(patient_ids=list(jarr.patient_ids),
                        arrays={k: v.copy() for k, v in jarr.arrays.items()},
                        ingest_mode=jarr.ingest_mode)

    def start_from_jax(fold, state):
        state.model.load_state_dict(inits[fold - 1], strict=True)
        _no_dropout(state.model)

    payload, out = cv_parallel.run_cross_validation_parallel(
        tcfg, None, results_dir=tmp_path / "port",
        models_dir=tmp_path / "port", prepared=(tarr, splits),
        init_hook=start_from_jax, device="cpu")

    tols = []
    for o, jo, (_, val, _) in zip(out, jout, splits):
        for field in ("fold", "best_epoch", "epochs_run", "train_size",
                      "val_size", "train_survival_size"):
            assert getattr(o, field) == getattr(jo, field), field
        assert [h["lr"] for h in o.history] == \
            pytest.approx([h["lr"] for h in jo.history], rel=1e-12)
        for key in ("train_loss", "val_loss"):
            np.testing.assert_allclose([h[key] for h in o.history],
                                       [h[key] for h in jo.history],
                                       rtol=1e-4, err_msg=key)
        sd = load_checkpoint(tmp_path / "port" / "rnaseq_only"
                             / f"fold_{o.fold}_best.pt")
        tol = _c_index_tolerance(tarr.arrays, val,
                                 _fold_hazards(sd, tcfg, tarr, val))
        tols.append(tol)
        for h, jh in zip(o.history, jo.history):
            assert abs(h["val_c_index"] - jh["val_c_index"]) <= tol
        meta = load_fold_meta(tmp_path / "port" / "rnaseq_only"
                              / f"fold_{o.fold}_best.pt")
        jmeta = load_fold_meta(tmp_path / "jax" / "rnaseq_only"
                               / f"fold_{o.fold}_best.msgpack")
        assert sorted(meta) == sorted(jmeta)
        for k in meta:
            if k != "best_c_index":
                assert meta[k] == jmeta[k], k
    assert {k: v for k, v in payload.items() if not k.startswith("c_index")
            and k != "fold_results"} == \
        {k: v for k, v in jpayload.items() if not k.startswith("c_index")
         and k != "fold_results"}
    for fr, jfr, tol in zip(payload["fold_results"],
                            jpayload["fold_results"], tols):
        fr, jfr = dict(fr), dict(jfr)
        assert abs(fr.pop("best_c_index") - jfr.pop("best_c_index")) <= tol
        assert fr == jfr


# ---------------------------------------------------------------------------
# Refusals and the default device
# ---------------------------------------------------------------------------

CFG = dataclasses.replace(PARTIAL_MODALITY, image_shape=IMAGE_SHAPE,
                          n_folds=2, num_epochs=2)


@pytest.mark.parametrize("option,item", [
    (dict(aot_cache_dir="aot"), "aot_cache_dir"),
])
def test_driver_refuses_what_is_not_ported(cohort, tmp_path, monkeypatch,
                                           option, item):
    """Nothing is refused any more: the fold mesh and remat run
    (tests/test_torch_fold_mesh.py, tests/test_torch_remat.py), and
    ``aot_cache_dir`` routes the process's kernel builds through the cache
    while one vmapped epoch writes the same fold checkpoints as without
    it."""
    from multimodal_survival_prediction_tpu_torch.io.checkpoint import (
        load_checkpoint,
    )
    from multimodal_survival_prediction_tpu_torch.io import aot_cache

    monkeypatch.setattr(aot_cache, "CACHE_DIR", None)  # put back after
    cfg = dataclasses.replace(CFG, num_epochs=1)
    prepared = cv.prepare_cv_data(
        cfg, cohort["rows"], rnaseq_csv=cohort["paths"]["rnaseq_csv"],
        device="cpu")
    for sub, kw in (("plain", {}),
                    ("cached", {item: str(tmp_path / option[item])})):
        cv_parallel.run_cross_validation_parallel(
            cfg, None, results_dir=tmp_path / sub, models_dir=tmp_path / sub,
            backbone="simple_cnn", prepared=prepared, device="cpu", **kw)
    assert aot_cache.CACHE_DIR == tmp_path / option[item]
    for fold in (1, 2):
        name = f"partial_modality/fold_{fold}_best.pt"
        got = load_checkpoint(tmp_path / "cached" / name)
        want = load_checkpoint(tmp_path / "plain" / name)
        assert all(torch.equal(got[k], want[k]) for k in want)


@pytest.mark.parametrize("n,dp", [(2, 1), (4, 2), (None, 2)])
def test_fold_mesh_is_one_device(n, dp):
    """Without a process group the fold mesh is the one device (None);
    more devices need the ranks' group (tests/test_torch_fold_mesh.py
    builds meshes on gloo ranks)."""
    assert cv_parallel.make_fold_mesh() is None
    assert cv_parallel.make_fold_mesh(1) is None
    with pytest.raises(RuntimeError, match="process group"):
        cv_parallel.make_fold_mesh(n, data_parallel=dp)


@pytest.mark.skipif(torch.cuda.is_available(), reason="needs no CUDA")
def test_driver_defaults_to_cuda(tmp_path):
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        cv_parallel.run_cross_validation_parallel(
            CFG, [], results_dir=tmp_path, models_dir=tmp_path)


# ---------------------------------------------------------------------------
# The CLI
# ---------------------------------------------------------------------------

def _argv(tmp_path, *extra):
    return ["--data-root", str(tmp_path), "--results-dir",
            str(tmp_path / "results"), "--models-dir",
            str(tmp_path / "models"), "--synthetic", "--synthetic-patients",
            "16", "--backbone", "simple_cnn", "--image-shape", "16,16,8",
            "--epochs", "2", "--n-folds", "2", "--device", "cpu", *extra]


def test_cli_fold_parallel_end_to_end_on_cpu(tmp_path, capsys):
    """``--fold-parallel 1`` writes cv_results.json and both .pt folds with
    their .meta.json; predict_risk on each reproduces its best_c_index on
    its validation patients; the summary names the fold-parallel run."""
    payload = pmt.main(_argv(tmp_path, "--fold-parallel", "1"))
    out = capsys.readouterr().out
    assert "Partial Modality (Gated) (fold-parallel): C-index" in out
    assert "  fold 2: best " in out
    on_disk = json.loads((tmp_path / "results" / "partial_modality"
                          / "cv_results.json").read_text())
    assert on_disk == payload and len(payload["fold_results"]) == 2
    ckpts = fold_checkpoints(tmp_path / "models", "partial_modality")
    assert [c.name for c in ckpts] == ["fold_1_best.pt", "fold_2_best.pt"]
    table = load_matching_table(tmp_path / "data" / "processed"
                                / "full_matching_table.csv")
    cfg = dataclasses.replace(CFG, n_folds=2)
    arrays, splits = cv.prepare_cv_data(
        cfg, table, rnaseq_csv=tmp_path / "data" / "processed"
        / "rnaseq_normalized_mapped.csv", device="cpu")
    for ckpt, fr, (_, val, _) in zip(ckpts, payload["fold_results"],
                                     splits):
        meta = load_fold_meta(ckpt)
        assert meta["best_c_index"] == fr["best_c_index"]
        pred = predict_risk(cfg, ckpt, table, rnaseq_csv=tmp_path / "data"
                            / "processed" / "rnaseq_normalized_mapped.csv",
                            labeled_only=False, device="cpu")
        h = pred["risk_score"][val]
        c = float(concordance_index(
            torch.from_numpy(h).float(), arrays.arrays["time"][val],
            arrays.arrays["event"][val], valid=arrays.arrays["svalid"][val]))
        tol = _c_index_tolerance(arrays.arrays, val, h.astype(np.float64))
        assert abs(c - fr["best_c_index"]) <= tol


@pytest.mark.parametrize("flags,raises,match", [
    (["--fold-parallel", "3", "--fold-dp", "2"], ValueError,
     "3 devices not divisible by data=2"),
    (["--fold-parallel", "1", "--fold-dp", "2"], SystemExit,
     "--fold-dp needs --fold-parallel N with N > 1"),
    (["--fold-parallel", "1", "--mesh", "2"], SystemExit,
     "mutually exclusive"),
    (["--fold-parallel", "1", "--tp", "2"], SystemExit,
     "mutually exclusive"),
    (["--fold-parallel", "1", "--resume"], SystemExit, "mutually exclusive"),
    (["--fold-parallel", "1", "--profile-dir", "p"], SystemExit,
     "mutually exclusive"),
    (["--fold-parallel", "1", "--sharded-risk-set"], SystemExit,
     "mutually exclusive"),
], ids=lambda v: "_".join(v) if isinstance(v, list) else None)
def test_cli_fold_parallel_refusals(tmp_path, flags, raises, match):
    with pytest.raises(raises, match=match):
        pmt.main(_argv(tmp_path, *flags))
    assert not (tmp_path / "data").exists()
