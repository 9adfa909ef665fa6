"""Remat on the CPU: ``models/layers.py:remat`` and
``DenseNet121_3D(remat=True)`` (each dense layer a recompute region)
against the plain model, against the JAX package's
``DenseNet121_3D(remat=True)``, and through the drivers and the CLIs.

Tolerances:
  * remat against the plain port model: bit for bit (loss, every
    gradient, running stats, ``num_batches_tracked``, the dropout
    generator's state, the states after an epoch and the artifacts of a
    CV run), in the Trainer's eager ``torch.autograd.grad`` and under the
    fold-parallel step's ``vmap(grad_and_value)``: the region's forward
    runs the same ops, and its recompute reuses the forward's dropout
    uniforms and leaves the running stats to the forward;
  * the port's gradients against JAX's (remat and plain, from the same
    weights and input, train mode): 1e-4 absolute, the tolerance of
    ``tests/test_torch_models.py``;
  * the fused stages' kernels (their plain versions here): the calls
    counted exactly, against the ``pallas_call`` equations of the JAX
    jaxpr of ``jax.grad`` of the same model.
"""

import dataclasses
import functools
import json

import numpy as np
import pytest
import torch

from multimodal_survival_prediction_tpu_torch.config import ALL_CONFIGS
from multimodal_survival_prediction_tpu_torch.data.matching_table import (
    load_matching_table,
)
from multimodal_survival_prediction_tpu_torch.io import jax_import
from multimodal_survival_prediction_tpu_torch.io.checkpoint import (
    load_checkpoint,
)
from multimodal_survival_prediction_tpu_torch.models import (
    DenseNet121_3D,
    PartialModalityNet,
)
from multimodal_survival_prediction_tpu_torch.models import encoders, layers
from multimodal_survival_prediction_tpu_torch.models.layers import BatchNorm
from multimodal_survival_prediction_tpu_torch.ops import fused_dense as fd
from multimodal_survival_prediction_tpu_torch.train import cv, cv_parallel
from multimodal_survival_prediction_tpu_torch.train import engine, sweep
from multimodal_survival_prediction_tpu_torch.train import (
    partial_modality_training as pmt,
)
from multimodal_survival_prediction_tpu_torch.train.predict import (
    fold_checkpoints,
)

ATOL = 1e-4  # tests/test_torch_models.py's
SMALL = (2, 2)  # DenseNet block_config at test size (inputs >= 8)


@pytest.fixture(autouse=True)
def _few_threads():
    threads = torch.get_num_threads()
    torch.set_num_threads(min(threads, 2))  # workers share the host
    yield
    torch.set_num_threads(threads)


@pytest.fixture
def regions(monkeypatch):
    """Counts the recompute regions entered (``layers.remat`` calls) and
    the recomputes run (``_Recompute.backward``)."""
    seen = {"regions": 0, "recomputes": 0}
    remat, backward = layers.remat, layers._Recompute.backward

    def counted(*a, **k):
        seen["regions"] += 1
        return remat(*a, **k)

    def recounted(ctx, *g):
        seen["recomputes"] += 1
        return backward(ctx, *g)

    monkeypatch.setattr(layers, "remat", counted)
    import multimodal_survival_prediction_tpu_torch.models.densenet3d as dn

    monkeypatch.setattr(dn, "remat", counted)
    monkeypatch.setattr(layers._Recompute, "backward",
                        staticmethod(recounted))
    return seen


def _data(n=10, shape=(16, 16, 8), seed=3):
    rng = np.random.default_rng(seed)
    svalid = np.ones(n, np.float32)
    svalid[-2:] = 0.0
    return {
        "image": torch.from_numpy(
            rng.normal(size=(n, *shape, 1)).astype(np.float32)),
        "time": torch.from_numpy(rng.exponential(300.0, n).astype(
            np.float32)),
        "event": torch.from_numpy(((rng.uniform(size=n) < 0.7) * svalid)
                                  .astype(np.float32)),
        "svalid": torch.from_numpy(svalid),
    }


def _trainer(remat, dropout, fused=False, block_config=SMALL):
    """A Trainer on DenseNet121-3D's first output as the hazard."""
    cfg = engine.TrainConfig(batch_size=4, learning_rate=1e-3,
                             weight_decay=1e-4, optimizer="adam",
                             grad_clip=1.0)
    return engine.Trainer(
        lambda g: DenseNet121_3D(out_features=2, block_config=block_config,
                                 dropout=dropout, fused_bn1=fused,
                                 remat=remat, generator=g),
        lambda b: (b["image"],), lambda out, b: (out[:, 0], 0.0), cfg,
        device="cpu")


def _bn_counts(model):
    return {n: int(m.num_batches_tracked) for n, m in model.named_modules()
            if isinstance(m, BatchNorm)}


@pytest.mark.parametrize("dropout", [0.0, 0.3], ids=["p0", "p03"])
def test_trainer_step_and_epoch_are_bit_equal(dropout, regions):
    """One ``loss_and_grads`` (loss, gradients, running stats, each
    BatchNorm's ``num_batches_tracked`` up by exactly one, the dropout
    generator advanced alike), then two epochs (step losses, the states):
    remat equal to plain bit for bit. Every dense layer is a region, and
    each region is recomputed once in its backward."""
    data = _data()
    runs = []
    for remat in (False, True):
        tr = _trainer(remat, dropout)
        state = tr.init_state(fold=1)
        idx, bv = tr._pad_indices(np.arange(10), 4,
                                  np.random.default_rng(0))
        (batch, *_) = tr._device_batches(data, idx, bv)
        before = dict(regions)
        loss, grads = tr.loss_and_grads(state, batch)
        entered = regions["regions"] - before["regions"]
        recomputed = regions["recomputes"] - before["recomputes"]
        step1 = (loss, grads, {k: v.clone() for k, v in
                               state.model.state_dict().items()},
                 _bn_counts(state.model),
                 state.dropout_generator.get_state())
        for _ in range(2):
            tr.train_epoch(state, data, np.arange(10),
                           np.random.default_rng(1), 1e-3)
        runs.append((step1, tr.step_losses.clone(),
                     engine.train_state_dict(state), entered, recomputed))
    (a, la, sa, ea, ra), (b, lb, sb, eb, rb) = runs
    assert (ea, ra) == (0, 0)
    assert eb == rb == sum(SMALL)
    assert torch.equal(a[0], b[0])
    assert all(torch.equal(x, y) for x, y in zip(a[1], b[1]))
    assert a[2].keys() == b[2].keys()
    assert all(torch.equal(a[2][k], b[2][k]) for k in a[2])
    assert a[3] == b[3] and set(a[3].values()) == {1}
    assert torch.equal(a[4], b[4])
    assert torch.equal(la, lb)
    assert all(torch.equal(sa["model"][n], sb["model"][n])
               for n in sa["model"])
    for k in ("opt_mu", "opt_nu"):
        assert all(torch.equal(x, y) for x, y in zip(sa[k], sb[k]))
    assert torch.equal(sa["dropout_rng"], sb["dropout_rng"])
    assert set(_bn_counts_from(sb["model"]).values()) == {1 + 2 * 3}


def _bn_counts_from(sd):
    return {k: int(v) for k, v in sd.items()
            if k.endswith("num_batches_tracked")}


def test_stacked_step_is_bit_equal(regions):
    """Two folds with unequal step counts in the fold-parallel driver's
    vmapped epoch, dropout on: losses and each fold's state (parameters,
    running stats, ``num_batches_tracked`` at the fold's own steps, Adam's
    moments, the generator) bit-equal with and without remat; the regions
    ran under ``vmap(grad_and_value)``, each recomputed."""
    data = _data(n=14)
    rows = [np.arange(7), np.arange(3, 14)]
    out = []
    for remat in (False, True):
        tr = _trainer(remat, 0.3)
        state = cv_parallel.StackedState([tr.init_state(fold=1),
                                          tr.init_state(fold=2)])
        epoch = cv_parallel._build_parallel_train_epoch(tr)
        rngs = [np.random.default_rng(5), np.random.default_rng(6)]
        before = dict(regions)
        losses = []
        for _ in range(2):
            idx, bv = cv_parallel._stack_fold_indices(rows, 4, rngs)
            step_valid = bv.max(axis=2) > 0
            losses.append(epoch(state, cv_parallel.stacked_batches(
                tr, data, idx, bv), step_valid, np.asarray([1e-3, 2e-3]))[0])
        out.append((torch.cat(losses), [state.fold_train_state(k)
                                        for k in range(2)],
                    regions["regions"] - before["regions"],
                    regions["recomputes"] - before["recomputes"]))
    (la, sa, ea, ra), (lb, sb, eb, rb) = out
    assert step_valid.tolist() == [[True, True, False], [True, True, True]]
    assert (ea, ra) == (0, 0)
    # one vmapped call a step, and one forward that finds the dropout
    # shapes (no backward)
    assert rb == 2 * 3 * sum(SMALL) and eb == rb + sum(SMALL)
    assert torch.equal(la, lb)
    for k, (x, y) in enumerate(zip(sa, sb)):
        assert all(torch.equal(x["model"][n], y["model"][n])
                   for n in x["model"])
        for key in ("opt_mu", "opt_nu"):
            assert all(torch.equal(p, q) for p, q in zip(x[key], y[key]))
        assert torch.equal(x["dropout_rng"], y["dropout_rng"])
        assert x["opt_count"] == y["opt_count"]
        assert set(_bn_counts_from(y["model"]).values()) == \
            {x["opt_count"]}
    assert [s["opt_count"] for s in sb] == [4, 6]


def _count_plain(monkeypatch):
    """Counts the fused op's plain kernel versions called on the CPU, in
    ``fd.KERNELS`` order."""
    calls = [0, 0, 0, 0]
    for i, name in enumerate(("moments_plain", "apply_plain",
                              "bwd_reduce_plain", "bwd_dx_plain")):
        fn = getattr(fd, name)

        def counted(*a, _fn=fn, _i=i, **k):
            calls[_i] += 1
            return _fn(*a, **k)

        monkeypatch.setattr(fd, name, counted)
    return calls


def _stages(block_config):
    return sum(block_config) + len(block_config) - 1


@pytest.mark.parametrize("block_config,shape", [
    (SMALL, (16, 16, 8)), ((6, 12, 24, 16), (32, 32, 32))],
    ids=["small", "densenet121"])
def test_fused_stages_are_bit_equal_and_counted(block_config, shape,
                                                monkeypatch):
    """``fused_bn1`` on the CPU (the fused op's plain versions behind the
    same autograd Function): a train-mode step with remat is bit-equal to
    the plain one (loss, gradients, running stats), and the kernels run
    as the JAX jaxpr counts them (``test_jaxpr_counts_the_port_launches``):
    ``moments`` and ``apply`` once a stage in the forward and again in each
    dense layer's recompute, ``bwd_reduce`` and ``bwd_dx`` once a stage."""
    x = torch.from_numpy(np.random.default_rng(2).normal(
        size=(2, *shape, 1)).astype(np.float32))
    calls = _count_plain(monkeypatch)
    runs = []
    for remat in (False, True):
        model = DenseNet121_3D(out_features=4, block_config=block_config,
                               fused_bn1=True, remat=remat,
                               generator=torch.Generator().manual_seed(0))
        calls[:] = [0, 0, 0, 0]
        loss = (model.train()(x) ** 2).sum()
        grads = torch.autograd.grad(loss, list(model.parameters()))
        runs.append((loss, grads, model.state_dict(), list(calls)))
    (la, ga, sa, ca), (lb, gb, sb, cb) = runs
    assert torch.equal(la, lb)
    assert all(torch.equal(p, q) for p, q in zip(ga, gb))
    assert all(torch.equal(sa[k], sb[k]) for k in sa)
    s, n = _stages(block_config), sum(block_config)
    assert ca == [s] * 4
    assert cb == [s + n, s + n, s, s]


def _pallas_calls(jaxpr) -> dict:
    """``pallas_call`` equations of a jaxpr and its sub-jaxprs, by kernel
    function."""
    import jax.extend as jex

    counts: dict = {}

    def walk(jp):
        for eqn in jp.eqns:
            if eqn.primitive.name == "pallas_call":
                name = eqn.params["jaxpr"].debug_info.func_name
                counts[name] = counts.get(name, 0) + 1
            for v in eqn.params.values():
                for sub in v if isinstance(v, (list, tuple)) else (v,):
                    if isinstance(sub, jex.core.ClosedJaxpr):
                        walk(sub.jaxpr)
                    elif isinstance(sub, jex.core.Jaxpr):
                        walk(sub)

    walk(jaxpr.jaxpr)
    return counts


@pytest.mark.parametrize("remat", [False, True], ids=["plain", "remat"])
def test_jaxpr_counts_the_port_launches(remat):
    """The JAX jaxpr of ``jax.grad`` of a ``DenseNet121_3D(remat,
    fused_bn1=True)`` loss (DenseNet121's 58 dense layers and 3
    transitions: 61 stages) holds ``moments`` and ``apply`` 61 times
    without remat and 61 + 58 = 119 with it, ``bwd_reduce`` and ``bwd_dx``
    61 either way: the counts the port launches a step (above, and
    ``chip_smoke.py`` phase 14 on the card)."""
    import jax
    import jax.numpy as jnp

    from multimodal_survival_prediction_tpu.models.densenet3d import (
        DenseNet121_3D as JDenseNet,
    )

    x = jnp.zeros((2, 32, 32, 32, 1), jnp.float32)
    m = JDenseNet(out_features=8, fused_bn1=True, remat=remat)
    v = jax.eval_shape(lambda: m.init(jax.random.PRNGKey(0), x))
    v = jax.tree_util.tree_map(lambda a: jnp.zeros(a.shape, a.dtype), v)

    def loss(p):
        out, _ = m.apply({"params": p, "batch_stats": v["batch_stats"]}, x,
                         train=True, mutable=["batch_stats"])
        return (out ** 2).sum()

    counts = _pallas_calls(jax.make_jaxpr(jax.grad(loss))(v["params"]))
    s, n = _stages((6, 12, 24, 16)), 58
    fwd = s + n if remat else s
    assert counts == {"_moments_kernel": fwd, "_apply_kernel": fwd,
                      "_bwd_reduce_kernel": s, "_bwd_dx_kernel": s}


def _jax_densenet(remat, x, seed=0):
    import jax

    from multimodal_survival_prediction_tpu.models.densenet3d import (
        DenseNet121_3D as JDenseNet,
    )

    m = JDenseNet(out_features=8, block_config=SMALL, remat=remat)
    v = jax.tree_util.tree_map(np.asarray, dict(
        m.init(jax.random.PRNGKey(seed), x)))
    rng = np.random.default_rng(seed)
    v["batch_stats"] = jax.tree_util.tree_map(
        lambda a: rng.uniform(0.5, 1.5, a.shape).astype(np.float32),
        v["batch_stats"])
    return m, v


def _as_torch(params, batch_stats):
    out: dict = {}
    jax_import._exp_densenet121(out, "m", params, batch_stats)
    return {k[2:]: torch.from_numpy(np.array(v)) for k, v in out.items()}


@pytest.mark.parametrize("remat", [False, True], ids=["plain", "remat"])
def test_gradients_match_jax(remat):
    """Train-mode gradients of ``sum(out²)`` from the same weights and
    input: the port's DenseNet121-3D (``block_config=(2, 2)``) against
    JAX's ``DenseNet121_3D(remat=...)`` element by element, 1e-4 absolute
    (the JAX gradients mapped to the port's names by the export map, which
    is linear), and the updated running stats likewise."""
    import jax

    x = np.random.default_rng(1).normal(size=(2, 16, 16, 8, 1)).astype(
        np.float32)
    jm, v = _jax_densenet(remat, x)

    def loss(p):
        out, upd = jm.apply({"params": p, "batch_stats": v["batch_stats"]},
                            x, train=True, mutable=["batch_stats"])
        return (out ** 2).sum(), upd

    (jloss, upd), jgrads = jax.value_and_grad(loss, has_aux=True)(
        v["params"])
    want = _as_torch(jax.tree_util.tree_map(np.asarray, jgrads),
                     v["batch_stats"])
    stats = _as_torch(v["params"], jax.tree_util.tree_map(
        np.asarray, upd["batch_stats"]))
    port = DenseNet121_3D(out_features=8, block_config=SMALL, remat=remat)
    port.load_state_dict(_as_torch(v["params"], v["batch_stats"]),
                         strict=True)
    got_loss = (port.train()(torch.from_numpy(x)) ** 2).sum()
    names = [n for n, _ in port.named_parameters()]
    grads = torch.autograd.grad(got_loss, list(port.parameters()))
    np.testing.assert_allclose(float(got_loss), float(jloss), rtol=1e-5)
    for n, g in zip(names, grads):
        np.testing.assert_allclose(g.numpy(), want[n].numpy(), atol=ATOL,
                                   err_msg=n)
    for k, t in port.state_dict().items():
        if k.endswith(("running_mean", "running_var")):
            np.testing.assert_allclose(t.numpy(), stats[k].numpy(),
                                       atol=ATOL, err_msg=k)


@pytest.mark.parametrize("model", ["densenet", "partial_modality"])
def test_jax_remat_weights_load_strictly(model):
    """A JAX model built with ``remat=True`` (``nn.remat`` changes no
    parameter path) exports through ``io/jax_import.py`` and loads
    strictly into the port's ``remat=True`` model, whose state_dict keys
    are the plain model's."""
    import jax

    if model == "densenet":
        x = np.zeros((1, 16, 16, 8, 1), np.float32)
        _, v = _jax_densenet(True, x)
        sd = _as_torch(v["params"], v["batch_stats"])
        port = DenseNet121_3D(out_features=8, block_config=SMALL, remat=True)
        plain = DenseNet121_3D(out_features=8, block_config=SMALL)
    else:
        from multimodal_survival_prediction_tpu.models.gated import (
            PartialModalityNet as JGated,
        )

        inputs = (np.zeros((2, 16, 16, 8, 1), np.float32),
                  np.zeros((2, 24), np.float32),
                  np.zeros((2, 1), np.float32), np.ones((2, 3), np.float32))
        jm = JGated(block_config=SMALL, remat=True)
        v = jax.tree_util.tree_map(np.asarray, dict(jm.init(
            {"params": jax.random.PRNGKey(0),
             "dropout": jax.random.PRNGKey(1)}, *inputs)))
        sd = {k: torch.from_numpy(np.array(t)) for k, t in
              jax_import.export_torch_state_dict("partial_modality",
                                                 v).items()}
        port = PartialModalityNet(rna_dim=24, block_config=SMALL,
                                  remat=True)
        plain = PartialModalityNet(rna_dim=24, block_config=SMALL)
    port.load_state_dict(sd, strict=True)
    assert list(port.state_dict()) == list(plain.state_dict())
    assert all(torch.equal(port.state_dict()[k], t) for k, t in sd.items())


# ---------------------------------------------------------------------------
# The drivers and the CLIs
# ---------------------------------------------------------------------------

@pytest.fixture
def small_densenet(monkeypatch):
    """The image encoders' DenseNet121-3D at ``block_config=(2, 2)``."""
    monkeypatch.setattr(encoders, "DenseNet121_3D", functools.partial(
        DenseNet121_3D, block_config=SMALL))


@pytest.fixture(scope="module")
def cohort(tmp_path_factory):
    from multimodal_survival_prediction_tpu_torch.data.synthetic import (
        SyntheticCohortSpec,
        generate_synthetic_cohort,
    )

    root = tmp_path_factory.mktemp("remat_cohort")
    _, paths = generate_synthetic_cohort(root, SyntheticCohortSpec(
        n_patients=28, rna_dim=24, seed=2, p_imaging=0.7,
        image_shapes=((12, 20, 20), (10, 18, 16))))
    return load_matching_table(paths["matching_table"]), paths


FAMILIES = ["image_only", "simple_fusion", "flexible_multimodal", "final",
            "partial_modality", "simmim", "mmsurv"]


@pytest.mark.parametrize("name", FAMILIES)
def test_each_image_family_trains_bit_equal_with_remat(name, cohort,
                                                       small_densenet,
                                                       regions, tmp_path):
    """One epoch of 2 folds through the CV driver (``run_cross_validation``,
    DenseNet at ``block_config=(2, 2)``; SimMLM with one stage-1 epoch)
    with ``remat=True`` and without: the histories and every fold
    checkpoint bit-equal; the dense layers ran as regions except in
    image_only, whose own small CNN ignores remat (as in JAX)."""
    table, paths = cohort
    cfg = dataclasses.replace(ALL_CONFIGS[name], n_folds=2, num_epochs=1,
                              image_shape=(16, 16, 8),
                              **({"stage1_epochs": 1} if name == "simmim"
                                 else {}))
    prepared = cv.prepare_cv_data(cfg, table,
                                  rnaseq_csv=paths["rnaseq_csv"],
                                  device="cpu")
    runs = []
    for remat in (False, True):
        before = regions["regions"]
        _, out = cv.run_cross_validation(
            cfg, None, results_dir=tmp_path / str(remat),
            models_dir=tmp_path / str(remat), prepared=prepared,
            remat=remat, device="cpu")
        runs.append((out, regions["regions"] - before))
    (oa, na), (ob, nb) = runs
    assert na == 0
    assert (nb == 0) if name == "image_only" else (nb > 0)
    assert [o.history for o in oa] == [o.history for o in ob]
    for f in (1, 2):
        a, b = (load_checkpoint(tmp_path / str(r) / name
                                / f"fold_{f}_best.pt") for r in (False, True))
        assert a.keys() == b.keys()
        assert all(torch.equal(a[k], b[k]) for k in a)


def _argv(root, tag, *extra):
    return ["--data-root", str(root), "--results-dir",
            str(root / tag / "results"), "--models-dir",
            str(root / tag / "models"), "--synthetic",
            "--synthetic-patients", "14", "--image-shape", "32,32,32",
            "--epochs", "1", "--n-folds", "2", "--device", "cpu", *extra]


def _results(root, tag):
    return json.loads((root / tag / "results" / "partial_modality"
                       / "cv_results.json").read_text())


@pytest.mark.parametrize("flags", [[], ["--fold-parallel", "1"]],
                         ids=["sequential", "fold_parallel_1"])
def test_cli_remat_equals_the_plain_run(flags, tmp_path, regions):
    """``--remat`` through the partial_modality CLI (full DenseNet121-3D
    at 32³), sequential and ``--fold-parallel 1``: cv_results.json and the
    fold checkpoints equal the run without it; the dense layers ran as
    regions (58 a forward)."""
    pmt.main(_argv(tmp_path, "plain", *flags))
    before = regions["regions"]
    pmt.main(_argv(tmp_path, "remat", *flags, "--remat"))
    assert regions["regions"] - before >= 58
    assert _results(tmp_path, "remat") == _results(tmp_path, "plain")
    for a, b in zip(*(fold_checkpoints(tmp_path / t / "models",
                                       "partial_modality")
                      for t in ("plain", "remat"))):
        sa, sb = load_checkpoint(a), load_checkpoint(b)
        assert all(torch.equal(sa[k], sb[k]) for k in sa)


def test_cli_remat_on_a_fold_mesh(tmp_path):
    """``--fold-parallel 2 --remat`` (two gloo ranks the CLI spawns, one
    fold each, full DenseNet121-3D at 32³) against ``--fold-parallel 1
    --remat`` on one device: the same cv_results.json and two fold
    checkpoints with the same keys (their float32 tensors part by Adam's
    lr-sized steps on noise gradients, a fold alone on its rank running
    other grouped convolutions: tests/test_torch_fold_mesh.py holds the
    states in float64)."""
    one = pmt.main(_argv(tmp_path, "one", "--fold-parallel", "1",
                         "--remat"))
    two = pmt.main(_argv(tmp_path, "two", "--fold-parallel", "2",
                         "--remat"))
    assert two == one == _results(tmp_path, "two")
    for a, b in zip(*(fold_checkpoints(tmp_path / t / "models",
                                       "partial_modality")
                      for t in ("one", "two"))):
        assert load_checkpoint(a).keys() == load_checkpoint(b).keys()


def test_sweep_cli_remat_equals_the_plain_run(tmp_path, regions):
    """The sweep CLI with ``--remat`` (2 seeds x 1 lr, full
    DenseNet121-3D): the same leaderboard as without, regions entered."""
    base = ["--model", "partial_modality", "--seeds", "42,43"]
    plain = sweep.main(_argv(tmp_path, "plain", *base))
    before = regions["regions"]
    remat = sweep.main(_argv(tmp_path, "remat", *base, "--remat"))
    assert regions["regions"] > before
    assert remat == plain
