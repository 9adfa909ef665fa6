"""Batch data parallelism on 2 gloo ranks: the flagship
``PartialModalityNet`` (DenseNet121-3D at ``block_config=(2, 2)``, 32³
volumes) takes one Trainer step from the same weights and batch against
the port's single device and against JAX's ``Trainer(mesh=make_mesh(2))``
(weights carried across by ``io/jax_import.py``). The refusals that need a
process group (``fused_bn1`` under a mesh, a batch that does not split over
the data axis) are checked on the same ranks.

JAX's step runs in float64 (``jax.enable_x64``, from the same float32
weights and batch): its float32 CPU gradients of the 32³ DenseNet lie up
to ~1.5e-4 from float64, too far to hold the port's to, while the float64
ones are the yardstick (within 9e-8 of the port's own float64 gradients).

Tolerances: loss within 1e-4, as JAX's own
``test_densenet_flagship_under_dp_mesh`` allows; gradients rtol 1e-4 with
atol 1e-6 against the port's single device and atol 2e-6 against JAX's
float64 (the port's float32 gradients lie up to ~1.4e-6 beyond rtol 1e-4
from float64: BatchNorm's backward cancels over the 16,384 rows of conv0's
output); BatchNorm running stats rtol 1e-4 / atol 1e-5; updated parameters
1e-5 but for the few elements whose step is noise: Adam's first step is
``lr · g'/(|g'| + 1e-8)`` of the clipped gradient plus the L2 term, ``g' =
g·clip + wd·p``, so where ``|g'| < 1e-7`` on either side a last-bit
difference in the gradient moves it by up to 2·lr (at most 1 % of the
elements). Against JAX, dropout is off on both sides (JAX's masks come
from its own PRNG); against the port's single device, dropout is on as
well, so each rank's mask must be its rows of the single-device mask.

The gloo workers live at module level and import no JAX (the spawned
children import this module); JAX is imported inside the tests."""

import copy
import os

import numpy as np
import pytest
import torch
import torch.distributed as dist
import torch.multiprocessing as mp

from multimodal_survival_prediction_tpu_torch.config import PARTIAL_MODALITY
from multimodal_survival_prediction_tpu_torch.models import PartialModalityNet
from multimodal_survival_prediction_tpu_torch.parallel.mesh import make_mesh
from multimodal_survival_prediction_tpu_torch.parallel.sharding import (
    batch_rows,
    shard_batch_dim,
)
from multimodal_survival_prediction_tpu_torch.train import engine
from multimodal_survival_prediction_tpu_torch.train.adapters import (
    make_adapters,
)

RNA_DIM = 40
IMAGE_SHAPE = (32, 32, 32)
ROWS = 4  # one batch of 4: 2 rows a rank
LR = PARTIAL_MODALITY.learning_rate
CFG_KW = dict(batch_size=ROWS, learning_rate=LR,
              weight_decay=PARTIAL_MODALITY.weight_decay,
              optimizer=PARTIAL_MODALITY.optimizer,
              grad_clip=PARTIAL_MODALITY.grad_clip,
              ties=PARTIAL_MODALITY.ties, seed=PARTIAL_MODALITY.seed)
DROPOUTS = (0.0, 0.3)


def _cohort(seed=17):
    rng = np.random.default_rng(seed)
    mask = (rng.uniform(size=(ROWS, 3)) < 0.8).astype(np.float32)
    mask[0] = 1.0
    event = (rng.uniform(size=ROWS) < 0.6).astype(np.float32)
    event[:2] = 1.0
    return {
        "image": rng.normal(size=(ROWS, *IMAGE_SHAPE, 1)).astype(np.float32),
        "rnaseq": rng.normal(size=(ROWS, RNA_DIM)).astype(np.float32),
        "clinical": rng.uniform(0.3, 0.9, (ROWS, 1)).astype(np.float32),
        "mask": mask,
        "time": rng.exponential(800.0, ROWS).astype(np.float32),
        "event": event,
        "svalid": np.ones(ROWS, np.float32),
    }


def _port_step(mesh, init_sd, dropout):
    """The port's first-batch loss, gradients and BatchNorm running stats,
    then one epoch (one step) from the same state: its loss and the
    updated state_dict (gathered)."""
    b2i, haa = make_adapters(PARTIAL_MODALITY)
    tr = engine.Trainer(
        lambda g: PartialModalityNet(rna_dim=RNA_DIM, block_config=(2, 2),
                                     dropout=dropout, generator=g),
        b2i, haa, engine.TrainConfig(**CFG_KW), device="cpu", mesh=mesh)
    state = tr.init_state(fold=1)
    state.model.load_state_dict(init_sd, strict=True)
    data = {k: torch.from_numpy(v) for k, v in _cohort().items()}
    rows = np.arange(ROWS)
    perm, bvalid = tr._pad_indices(rows, ROWS, np.random.default_rng(11))
    (batch,) = tr._device_batches(data, perm, bvalid)
    saved = copy.deepcopy(state.model.state_dict())
    gen = state.dropout_generator.get_state()
    loss0, grads = tr.loss_and_grads(state, batch)
    names = [n for n, _ in state.model.named_parameters()]
    after = engine.best_weights(state)
    running = {k: v for k, v in after.items() if "running" in k}
    state.model.load_state_dict(saved)
    state.dropout_generator.set_state(gen)
    state, epoch_loss = tr.train_epoch(state, data, rows,
                                       np.random.default_rng(11), LR)
    return dict(loss0=float(loss0),
                grads={n: g.numpy() for n, g in zip(names, grads)},
                running={k: v.numpy() for k, v in running.items()},
                epoch_loss=epoch_loss,
                final={k: v.numpy() for k, v in
                       engine.best_weights(state).items()})


def _refusals(mesh):
    """The messages of what a 2-rank data axis refuses."""
    out = {}
    b2i, haa = make_adapters(PARTIAL_MODALITY)
    tr = engine.Trainer(
        lambda g: PartialModalityNet(rna_dim=RNA_DIM, block_config=(2, 2),
                                     fused_bn1=True, generator=g),
        b2i, haa, engine.TrainConfig(**CFG_KW), device="cpu", mesh=mesh)
    for name, fn in (("fused", lambda: tr.init_state(fold=1)),
                     ("rows", lambda: batch_rows(3, mesh)),
                     ("shard", lambda: shard_batch_dim(np.zeros((5, 2)),
                                                       mesh))):
        try:
            fn()
            out[name] = None
        except ValueError as e:
            out[name] = str(e)
    return out


def _dp_rank(rank, world, store, init_path, out_dir):
    torch.set_num_threads(1)
    dist.init_process_group("gloo", init_method=f"file://{store}",
                            rank=rank, world_size=world)
    try:
        mesh = make_mesh(world, device="cpu")
        init_sd = torch.load(init_path)
        out = {d: _port_step(mesh, init_sd, d) for d in DROPOUTS}
        out["refusals"] = _refusals(mesh)
        torch.save(out, os.path.join(out_dir, f"rank{rank}.pt"))
    finally:
        dist.destroy_process_group()


def _jax_step(monkeypatch):
    """JAX's Trainer on make_mesh(2), dropout off, in float64: the initial
    (float32) weights as a torch state_dict, then, under
    ``jax.enable_x64`` with those weights, the batch and the Adam state in
    float64, the first batch's loss, gradients and new running stats, and
    one epoch's loss and updated state_dict."""
    import flax.linen as fnn
    import jax
    import jax.numpy as jnp

    from multimodal_survival_prediction_tpu import config as jconfig
    from multimodal_survival_prediction_tpu.models.gated import (
        PartialModalityNet as JGated,
    )
    from multimodal_survival_prediction_tpu.parallel import make_mesh as jmesh
    from multimodal_survival_prediction_tpu.parallel.sharding import (
        replicate as jreplicate,
    )
    from multimodal_survival_prediction_tpu.parallel.sharding import (
        shard_batch_dim as jshard,
    )
    from multimodal_survival_prediction_tpu.train import adapters as jadapters
    from multimodal_survival_prediction_tpu.train import engine as jengine
    from multimodal_survival_prediction_tpu_torch.io import jax_import

    class _NoDropout(fnn.Module):
        rate: float = 0.0
        deterministic: bool | None = None

        def __call__(self, x, deterministic=None, rng=None):
            return x

    monkeypatch.setattr(fnn, "Dropout", _NoDropout)

    def torch_sd(params, batch_stats):
        tree = jax.tree_util.tree_map(np.asarray, {
            "params": params, "batch_stats": batch_stats})
        return {k: torch.from_numpy(np.array(v)) for k, v in
                jax_import.export_torch_state_dict("partial_modality",
                                                   tree).items()}

    mesh = jmesh(2)
    _, jb2i, jhaa = jadapters.make_model_and_adapters(
        jconfig.PARTIAL_MODALITY, rna_dim=RNA_DIM)
    jtr = jengine.Trainer(
        JGated(backbone="densenet121", block_config=(2, 2)), jb2i, jhaa,
        jengine.TrainConfig(**CFG_KW), mesh=mesh)
    cohort = _cohort()
    example = {k: jnp.asarray(v) for k, v in cohort.items()}
    example["valid"] = example["svalid"]
    jstate = jtr.init_state(example, fold=1)
    init_sd = torch_sd(jstate.params, jstate.batch_stats)
    perm, bvalid = jengine.Trainer._pad_indices(np.arange(ROWS), ROWS,
                                                np.random.default_rng(11))
    with jax.enable_x64(True):
        f64 = jax.tree_util.tree_map(
            lambda a: jnp.asarray(np.asarray(a, np.float64)),
            {"params": jstate.params, "batch_stats": jstate.batch_stats})
        jstate = jreplicate(jengine.TrainState(
            params=f64["params"], batch_stats=f64["batch_stats"],
            opt_state=jtr.tx.init(f64["params"]),
            step=jnp.zeros((), jnp.int32)), mesh)
        jdata = {k: jnp.asarray(v.astype(np.float64))
                 for k, v in cohort.items()}
        jbatch = jtr._gather_batch(jdata, jnp.asarray(perm[0]),
                                   jnp.asarray(bvalid[0]))
        jbatch = {k: jshard(v, mesh) for k, v in jbatch.items()}
        with mesh:
            (loss0, new_bs), grads = jax.jit(jax.value_and_grad(
                jtr._loss_fn, has_aux=True))(jstate.params,
                                             jstate.batch_stats, jbatch,
                                             jax.random.PRNGKey(0))
        assert all(g.dtype == jnp.float64
                   for g in jax.tree_util.tree_leaves(grads))
        grad_sd = torch_sd(grads, new_bs)
        jstate, epoch_loss = jtr.train_epoch(
            jstate, jdata, np.arange(ROWS), np.random.default_rng(11), LR,
            jax.random.PRNGKey(1))
        final = torch_sd(jstate.params, jstate.batch_stats)
    return dict(init=init_sd, loss0=float(loss0),
                grads={k: v.numpy() for k, v in grad_sd.items()},
                running={k: v.numpy() for k, v in grad_sd.items()
                         if "running" in k},
                epoch_loss=epoch_loss,
                final={k: v.numpy() for k, v in final.items()})


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    """JAX's mesh step, the port's single-device step and the port's step
    on 2 gloo ranks (both dropout settings), from JAX's initial weights."""
    tmp = tmp_path_factory.mktemp("dp")
    monkeypatch = pytest.MonkeyPatch()
    try:
        jax_run = _jax_step(monkeypatch)
    finally:
        monkeypatch.undo()
    torch.save(jax_run["init"], tmp / "init.pt")
    mp.spawn(_dp_rank, args=(2, str(tmp / "store"), str(tmp / "init.pt"),
                             str(tmp)), nprocs=2, join=True)
    ranks = [torch.load(tmp / f"rank{r}.pt", weights_only=False)
             for r in range(2)]
    single = {d: _port_step(None, jax_run["init"], d) for d in DROPOUTS}
    return dict(jax=jax_run, ranks=ranks, single=single)


def _noise(grads, init):
    """Elements whose Adam input ``g·clip + wd·p`` is under 1e-7 (module
    docstring)."""
    norm = np.sqrt(sum(float(np.sum(g.astype(np.float64) ** 2))
                       for g in grads.values()))
    scale = min(1.0, CFG_KW["grad_clip"] / norm)
    return {n: np.abs(g * scale + CFG_KW["weight_decay"] * init[n].numpy())
            < 1e-7 for n, g in grads.items()}


def _held(got, want, init, grad_atol=1e-6):
    """``got``'s step against ``want``'s by the module docstring's rule;
    returns the share of elements whose update is noise."""
    assert abs(got["loss0"] - want["loss0"]) <= 1e-4, (got["loss0"],
                                                      want["loss0"])
    assert abs(got["epoch_loss"] - want["epoch_loss"]) <= 1e-4
    names = list(got["grads"])
    for name in names:
        w = want["grads"][name]
        tol = grad_atol + 1e-4 * np.abs(w)
        assert np.all(np.abs(got["grads"][name] - w) <= tol), (
            name, float(np.max(np.abs(got["grads"][name] - w) - tol)))
    for name, r in want["running"].items():
        np.testing.assert_allclose(got["running"][name], r, rtol=1e-4,
                                   atol=1e-5, err_msg=name)
    noise_got = _noise(got["grads"], init)
    noise_want = _noise({n: want["grads"][n] for n in names}, init)
    n_noise = n_all = 0
    for name, w in want["final"].items():
        if name.endswith("num_batches_tracked"):
            continue
        if name not in got["grads"]:  # running stats
            np.testing.assert_allclose(got["final"][name], w, rtol=1e-4,
                                       atol=1e-5, err_msg=name)
            continue
        noise = noise_got[name] | noise_want[name]
        tol = np.where(noise, 2 * LR, 1e-5)
        assert np.all(np.abs(got["final"][name] - w) <= tol), name
        n_noise += int(noise.sum())
        n_all += noise.size
    return n_noise / n_all


@pytest.mark.parametrize("dropout", DROPOUTS)
def test_dp_step_matches_single_device(runs, dropout):
    for rank in runs["ranks"]:
        noise = _held(rank[dropout], runs["single"][dropout],
                      runs["jax"]["init"])
        assert noise <= 1e-2, noise  # a small share


def test_dp_step_matches_jax_mesh(runs):
    """Against JAX's mesh step in float64 (module docstring): the port's
    float32 DP gradients within rtol 1e-4 / atol 2e-6 of JAX's."""
    got, want = runs["ranks"][0][0.0], runs["jax"]
    assert set(got["grads"]) <= set(want["grads"])
    noise = _held(got, want, want["init"], grad_atol=2e-6)
    assert noise <= 1e-2, noise


def test_ranks_hold_the_same_state(runs):
    """Replicated state stays replicated: both ranks' updated weights and
    running stats are bit-equal."""
    a, b = (r[0.3]["final"] for r in runs["ranks"])
    assert sorted(a) == sorted(b)
    assert all(np.array_equal(a[k], b[k]) for k in a)


def test_dp_refusals(runs):
    refusals = runs["ranks"][0]["refusals"]
    assert "fused_bn1 under a data or model axis larger than 1" in \
        refusals["fused"]
    assert "a batch of 3 rows does not split over the 2 ranks" in \
        refusals["rows"]
    assert "a batch of 5 rows does not split" in refusals["shard"]

