"""Tensor parallelism on a (2, 2) mesh of 4 gloo ranks: ``rnaseq_only``
(64 -> 1024 -> 512 -> 256 -> 1, the two wide layers column-parallel over
``model``, batches split over ``data``) trains one epoch of 2 steps against
the port's single device from the same weights, batches and dropout masks;
then the dry run (``parallel/dryrun.py``) on 4 ranks.

Tolerances: per-step losses within 1e-5 relative; updated parameters
within 1e-6 (absolute) but for the elements whose step is noise (below),
running stats rtol 1e-4 / atol 1e-5 (the DP rule); the clip's global norm
within 1e-4 relative of the norm of the same gradients gathered and of the
single device's (float32 norms of 500K-element tensors round at ~1e-5; a
shard or replica counted twice would be off by far more). A step is noise
where the Adam input ``g'`` (the clipped gradient; this is AdamW, so no L2
term) of the first batch is under 1e-7 or its two runs differ by more than
1e-2 relative (a gradient made of rounding: the Linear biases before
BatchNorm, whose true gradient is 0, and sums that cancel); there Adam's
normalized step may differ by up to 2·lr, on at most 1 % of the
elements (not counting exact zeros on both sides: units off for the whole
batch).

The gloo workers live at module level and import no JAX."""

import os

import numpy as np
import pytest
import torch
import torch.distributed as dist
import torch.multiprocessing as mp

from multimodal_survival_prediction_tpu_torch.config import RNASEQ_ONLY
from multimodal_survival_prediction_tpu_torch.models import (
    RNASeqSurvivalModel,
)
from multimodal_survival_prediction_tpu_torch.parallel import (
    dryrun,
    multihost,
)
from multimodal_survival_prediction_tpu_torch.parallel.mesh import (
    best_mesh_shape,
    make_mesh,
    mesh_shape,
)
from multimodal_survival_prediction_tpu_torch.parallel.multihost import (
    fetch_tree,
)
from multimodal_survival_prediction_tpu_torch.parallel.sharding import (
    ColumnParallelLinear,
    param_shardings,
    tp_group,
)
from multimodal_survival_prediction_tpu_torch.train import engine

RNA_DIM = 64
ROWS = 16
BATCH = 8
LR = 1e-4
CFG = engine.TrainConfig(batch_size=BATCH, learning_rate=LR,
                         weight_decay=RNASEQ_ONLY.weight_decay,
                         optimizer=RNASEQ_ONLY.optimizer, grad_clip=1.0,
                         seed=RNASEQ_ONLY.seed)
WIDE = {"mlp.0.weight": ("model", None), "mlp.0.bias": ("model",),
        "mlp.4.weight": ("model", None), "mlp.4.bias": ("model",)}


def _data():
    rng = np.random.default_rng(5)
    event = (rng.uniform(size=ROWS) < 0.6).astype(np.float32)
    event[:3] = 1.0
    return {"rnaseq": rng.normal(size=(ROWS, RNA_DIM)).astype(np.float32),
            "time": rng.uniform(1, 100, ROWS).astype(np.float32),
            "event": event, "svalid": np.ones(ROWS, np.float32)}


def _run(mesh):
    """One epoch (2 steps), with the first batch's gradient norm and each
    parameter's Adam input ``g'`` on that batch (from the initial
    state)."""
    tr = engine.Trainer(
        lambda g: RNASeqSurvivalModel(rna_dim=RNA_DIM, generator=g),
        lambda b: (b["rnaseq"],), cfg=CFG, device="cpu", mesh=mesh,
        tensor_parallel=True)
    state = tr.init_state(fold=1)
    data = {k: torch.from_numpy(v) for k, v in _data().items()}
    rows = np.arange(ROWS)
    init = engine.best_weights(state)
    perm, bvalid = tr._pad_indices(rows, BATCH, np.random.default_rng(3))
    batch = next(tr._device_batches(data, perm, bvalid))
    gen = state.dropout_generator.get_state()
    params = list(state.model.parameters())
    _, grads = tr.loss_and_grads(state, batch)
    norm = float(tr.grad_norm(grads, params))
    scale = min(1.0, CFG.grad_clip / norm)
    names = [n for n, _ in state.model.named_parameters()]
    g_full = fetch_tree(
        {n: g for n, g in zip(names, grads)} if mesh is None else
        {n: _like(g, p) for n, g, p in zip(names, grads, params)})
    assert CFG.optimizer == "adamw"  # no L2 term in the Adam input
    adam_in = {n: g_full[n] * scale for n in names}
    norm_of_full = float(torch.linalg.vector_norm(torch.stack(
        [torch.linalg.vector_norm(g.double()) for g in g_full.values()])))
    state.model.load_state_dict(init, strict=True)  # undo the BN update
    state.dropout_generator.set_state(gen)
    state, loss = tr.train_epoch(state, data, rows, np.random.default_rng(3),
                                 LR)
    losses = tr.step_losses.tolist()
    evaluation = tr.evaluate(state, data, rows)
    # the streaming twins from a fresh state: each rank's rows prefetched
    host = _data()
    fresh = tr.init_state(fold=1)
    tr.train_epoch_streaming(fresh, host, rows, np.random.default_rng(3), LR)
    streaming = dict(losses=tr.step_losses.tolist(),
                     evaluation=tr.evaluate_streaming(fresh, host, rows))
    return dict(losses=losses, norm=norm, evaluation=evaluation,
                streaming=streaming,
                norm_of_full=norm_of_full,
                adam_in={k: v.numpy() for k, v in adam_in.items()},
                final={k: v.numpy() for k, v in
                       engine.best_weights(state).items()},
                sharded={n: tp_group(p) is not None
                         for n, p in state.model.named_parameters()},
                plan=param_shardings(
                    RNASeqSurvivalModel(rna_dim=RNA_DIM), mesh, True)
                if mesh is not None else None,
                column_parallel=sum(isinstance(m, ColumnParallelLinear)
                                    for m in state.model.modules()))


def _like(g, p):
    """A gradient tensor carrying its parameter's shard group."""
    if tp_group(p) is not None:
        g = g.clone()
        g.tp_group = tp_group(p)
    return g


def _tp_rank(rank, world, store, out_dir):
    torch.set_num_threads(1)
    dist.init_process_group("gloo", init_method=f"file://{store}",
                            rank=rank, world_size=world)
    try:
        out = _run(make_mesh(world, model_parallel=2, device="cpu"))
        torch.save(out, os.path.join(out_dir, f"rank{rank}.pt"))
    finally:
        dist.destroy_process_group()


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    tmp = tmp_path_factory.mktemp("tp")
    mp.spawn(_tp_rank, args=(4, str(tmp / "store"), str(tmp)), nprocs=4,
             join=True)
    ranks = [torch.load(tmp / f"rank{r}.pt", weights_only=False)
             for r in range(4)]
    return dict(ranks=ranks, single=_run(None))


def test_tp_losses_match_single_device(runs):
    want = runs["single"]["losses"]
    assert len(want) == 2
    for rank in runs["ranks"]:
        np.testing.assert_allclose(rank["losses"], want, rtol=1e-5)


def test_tp_evaluation_is_the_whole_batch_on_every_rank(runs):
    """Evaluation gathers the hazards: every rank's pooled C-index is the
    single device's, and so are the hazards (to 1e-5)."""
    c, loss, h = runs["single"]["evaluation"]
    for rank in runs["ranks"]:
        rc, rloss, rh = rank["evaluation"]
        assert rc == c and rh.shape == h.shape == (ROWS,)
        assert rloss == pytest.approx(loss, rel=1e-5)
        np.testing.assert_allclose(rh, h, atol=1e-5)


def test_tp_streaming_equals_device_resident(runs):
    """The streaming epoch prefetches each rank's rows of every batch and
    follows the device-resident epoch bit for bit; so does its
    evaluation."""
    for run in (*runs["ranks"], runs["single"]):
        assert run["streaming"]["losses"] == run["losses"]
        c, loss, h = run["evaluation"]
        sc, sloss, sh = run["streaming"]["evaluation"]
        assert (sc, sloss) == (c, loss) and np.array_equal(sh, h)


def test_tp_clip_norm_matches_single_device(runs):
    """The clip reads the global norm: each shard's squared norm summed
    over ``model``, each replicated gradient once."""
    want = runs["single"]["norm"]
    for rank in runs["ranks"]:
        assert rank["norm"] == pytest.approx(rank["norm_of_full"], rel=1e-4)
        assert rank["norm"] == pytest.approx(want, rel=1e-4)
    assert want > CFG.grad_clip  # the clip does scale this step


def test_tp_updated_state_matches_single_device(runs):
    single = runs["single"]
    for rank in runs["ranks"]:
        n_noise = n_all = 0
        for name, want in single["final"].items():
            if name.endswith("num_batches_tracked"):
                continue
            got = rank["final"][name]
            assert got.shape == want.shape, name  # gathered to full size
            if name not in single["adam_in"]:  # running stats
                np.testing.assert_allclose(got, want, rtol=1e-4, atol=1e-5,
                                           err_msg=name)
                continue
            a, b = single["adam_in"][name], rank["adam_in"][name]
            noise = ((np.abs(a) < 1e-7) | (np.abs(b) < 1e-7)
                     | (np.abs(a - b) > 1e-2 * np.abs(a)))
            tol = np.where(noise, 2 * LR, 1e-6)
            assert np.all(np.abs(got - want) <= tol), name
            # the share leaves out exact zeros on both sides (units that
            # are off for the whole batch: no gradient at all)
            dead = (a == 0) & (b == 0)
            n_noise += int((noise & ~dead).sum())
            n_all += noise.size
        assert n_noise <= 1e-2 * n_all, (n_noise, n_all)


def test_tp_gathered_state_loads_strictly(runs):
    model = RNASeqSurvivalModel(rna_dim=RNA_DIM)
    model.load_state_dict({k: torch.from_numpy(v) for k, v in
                           runs["ranks"][0]["final"].items()}, strict=True)


def test_tp_shards_the_wide_layers_only(runs):
    for rank in runs["ranks"]:
        assert rank["column_parallel"] == 2
        assert {n for n, s in rank["sharded"].items() if s} == set(WIDE)
        assert {n: s for n, s in rank["plan"].items() if s} == WIDE


def test_best_mesh_shape_matches_jax():
    from multimodal_survival_prediction_tpu.parallel.mesh import (
        best_mesh_shape as jbest,
    )

    for n, mp_ in [(1, 1), (4, 1), (4, 2), (8, 4), (6, 3)]:
        assert best_mesh_shape(n, mp_) == jbest(n, mp_)
    with pytest.raises(ValueError, match="not divisible by model=2"):
        best_mesh_shape(3, 2)
    with pytest.raises(ValueError, match="not divisible by model=2"):
        jbest(3, 2)
    assert mesh_shape(None) == {}


def test_make_mesh_needs_a_group():
    with pytest.raises(RuntimeError, match="needs a torch.distributed"):
        make_mesh(1, device="cpu")


def test_dryrun_multichip_on_4_ranks(capsys):
    out = dryrun.dryrun_multichip(4, device="cpu")
    assert out["mesh"] == {"data": 2, "model": 2}
    assert out["global_batch"] == 4
    assert out["rna_weight_rows"] == 256  # 512 over 2 model ranks
    assert abs(out["loss_sharded"] - out["loss"]) <= dryrun.LOSS_TOL
    single = dryrun.dryrun_step(None, device="cpu", batch=4)
    assert out["loss"] == pytest.approx(single["loss"], rel=1e-5)
    assert "dryrun_multichip OK: mesh={'data': 2, 'model': 2}" in \
        capsys.readouterr().out


@pytest.mark.skipif(torch.cuda.device_count() >= 2,
                    reason="a host with 2 GPUs runs the dry run on them")
def test_dryrun_multichip_defaults_to_the_card():
    """Without device='cpu' the dry run asks for one GPU a rank and never
    falls back to gloo CPU ranks."""
    with pytest.raises((ValueError, RuntimeError),
                       match="needs 2 GPUs|CUDA is not available"):
        dryrun.dryrun_multichip(2)


class _Joined(Exception):
    pass


@pytest.mark.parametrize("preset", [None, "2000"])
def test_nccl_flight_recorder_off_unless_set(monkeypatch, preset):
    """An NCCL group is made with TORCH_NCCL_TRACE_BUFFER_SIZE=0 unless the
    environment already sets it (the call stops at init_process_group:
    there is no GPU here)."""
    seen = {}
    monkeypatch.setenv(multihost.TRACE_BUFFER, preset or "")
    if preset is None:
        monkeypatch.delenv(multihost.TRACE_BUFFER)

    def init_process_group(backend, **kw):
        seen.update(backend=backend,
                    trace=os.environ.get(multihost.TRACE_BUFFER))
        raise _Joined

    monkeypatch.setattr(multihost.dist, "init_process_group",
                        init_process_group)
    monkeypatch.setattr(multihost, "local_cuda_device",
                        lambda rank: torch.device("cuda", 0))
    monkeypatch.setattr(multihost.torch.cuda, "set_device", lambda d: None)
    with pytest.raises(_Joined):
        multihost.initialize_distributed(init_method="file:///nowhere",
                                         num_processes=1, process_id=0,
                                         device="cuda")
    assert seen == {"backend": "nccl", "trace": preset or "0"}
