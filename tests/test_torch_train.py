"""The port's training slice against the JAX package, on the CPU: the Cox
loss, the C-index, the LR schedules, the optimizer, the batch order and one
Trainer epoch of partial_modality with fused_bn1 from the same weights.

Inputs come from numpy seeds and go to both sides. Tolerances:
  * Cox loss and its gradient w.r.t. the hazards: 1e-5;
  * C-index, schedules and batch order: exact;
  * optimizer steps: rtol 1e-6 (one f32 update computed in another order);
  * Trainer: first-step gradients rtol 1e-4 / atol 1e-6, epoch mean loss
    1e-5 relative, updated parameters 1e-5 absolute (an Adam step moves a
    parameter by about lr = 1e-4) except the few whose gradient is zero up
    to rounding (see ``test_trainer_epoch_matches_jax``), running stats
    1e-4, pooled C-index 1e-6 and hazards 1e-4.
"""

import flax.linen as fnn
import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

from multimodal_survival_prediction_tpu import config as jconfig
from multimodal_survival_prediction_tpu.models.gated import (
    PartialModalityNet as JGated,
)
from multimodal_survival_prediction_tpu.ops import cindex as jci
from multimodal_survival_prediction_tpu.ops import cox as jcox
from multimodal_survival_prediction_tpu.train import adapters as jadapters
from multimodal_survival_prediction_tpu.train import engine as jengine
from multimodal_survival_prediction_tpu.train import schedules as jsched
from multimodal_survival_prediction_tpu_torch.config import PARTIAL_MODALITY
from multimodal_survival_prediction_tpu_torch.io import jax_import
from multimodal_survival_prediction_tpu_torch.models import PartialModalityNet
from multimodal_survival_prediction_tpu_torch.ops import cindex, cox
from multimodal_survival_prediction_tpu_torch.ops import fused_dense as fd
from multimodal_survival_prediction_tpu_torch.train import engine, schedules
from multimodal_survival_prediction_tpu_torch.train.adapters import (
    make_model_and_adapters,
)


class _NoDropout(fnn.Module):
    """Stand-in for flax ``nn.Dropout``: the identity (train-mode parity
    with dropout off; the JAX models hard-code a 0.3 rate)."""

    rate: float = 0.0
    deterministic: bool | None = None

    def __call__(self, x, deterministic=None, rng=None):
        return x


# ---------------------------------------------------------------------------
# Cox partial likelihood
# ---------------------------------------------------------------------------

def _survival(case, n=16, seed=0):
    rng = np.random.default_rng(seed)
    h = rng.normal(size=n).astype(np.float32)
    t = rng.uniform(1.0, 100.0, n).astype(np.float32)
    e = (rng.uniform(size=n) < 0.6).astype(np.float32)
    v = None
    if case == "tied":
        t = rng.integers(1, 5, n).astype(np.float32)
        e[:4] = 1.0
    elif case == "masked":
        v = (rng.uniform(size=n) < 0.7).astype(np.float32)
    elif case == "one_valid":
        v = np.zeros(n, np.float32)
        v[3] = 1.0
        e[3] = 1.0
    elif case == "no_event":
        e[:] = 0.0
    elif case == "none_valid":
        v = np.zeros(n, np.float32)
    return h, t, e, v


@pytest.mark.parametrize("ties", ["breslow", "efron"])
@pytest.mark.parametrize("case", ["random", "tied", "masked", "one_valid",
                                  "no_event", "none_valid"])
def test_cox_matches_jax(case, ties):
    h, t, e, v = _survival(case)
    th = torch.from_numpy(h).requires_grad_(True)
    tv = None if v is None else torch.from_numpy(v)
    loss = cox.cox_partial_likelihood(th, torch.from_numpy(t),
                                      torch.from_numpy(e), valid=tv,
                                      ties=ties)
    (grad,) = torch.autograd.grad(loss, th)

    def jloss(hh):
        return jcox.cox_partial_likelihood(hh, t, e, valid=v, ties=ties)

    want, jgrad = jax.value_and_grad(jloss)(jnp.asarray(h))
    np.testing.assert_allclose(float(loss.detach()), float(want),
                               rtol=1e-5, atol=1e-5)
    np.testing.assert_allclose(grad.numpy(), np.asarray(jgrad), rtol=1e-5,
                               atol=1e-5)
    assert np.all(np.isfinite(grad.numpy()))
    if case in ("one_valid", "no_event", "none_valid"):
        assert float(loss.detach()) == 0.0  # the degenerate guard, exactly


def test_cox_breslow_equals_efron_without_ties():
    h, t, e, _ = _survival("random", seed=3)
    args = [torch.from_numpy(a) for a in (h, t, e)]
    torch.testing.assert_close(cox.cox_partial_likelihood(*args),
                               cox.cox_partial_likelihood(*args, ties="efron"))


def test_gate_entropy_matches_jax():
    rng = np.random.default_rng(4)
    g = rng.dirichlet(np.ones(3), size=8).astype(np.float32)
    v = (rng.uniform(size=8) < 0.5).astype(np.float32)
    for valid in (None, v):
        got = cox.gate_entropy_loss(
            torch.from_numpy(g),
            None if valid is None else torch.from_numpy(valid))
        want = jcox.gate_entropy_loss(g, valid)
        np.testing.assert_allclose(float(got), float(want), rtol=1e-6)


# ---------------------------------------------------------------------------
# C-index
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("variant", ["harrell", "naive"])
@pytest.mark.parametrize("case", ["random", "ties", "masked", "none"])
def test_concordance_index_matches_jax(case, variant):
    rng = np.random.default_rng(5)
    n = 40
    h = rng.normal(size=n).astype(np.float32)
    t = rng.uniform(1, 50, n).astype(np.float32)
    e = (rng.uniform(size=n) < 0.5).astype(np.float32)
    v = None
    if case == "ties":
        h = np.round(h, 0)
        t = np.round(t / 10.0).astype(np.float32)
    elif case == "masked":
        v = (rng.uniform(size=n) < 0.6).astype(np.float32)
    elif case == "none":  # no comparable pair -> 0.5
        e[:] = 0.0
    got = float(cindex.concordance_index(torch.from_numpy(h), t, e, valid=v,
                                         variant=variant))
    want = float(jci.concordance_index(h, t, e, valid=v, variant=variant))
    assert got == want
    if case != "masked":
        assert cindex.concordance_index_np(h, t, e, variant) == \
            jci.concordance_index_np(h, t, e, variant)


# ---------------------------------------------------------------------------
# Schedules, optimizer, batch order
# ---------------------------------------------------------------------------

def test_schedules_match_jax():
    metrics = [0.5, 0.6, 0.6, 0.59, 0.6, 0.61, 0.61, 0.6, 0.6, 0.6, 0.6,
               0.6, 0.6, 0.7, 0.7, 0.69, 0.69, 0.69, 0.69, 0.69, 0.69]
    a = schedules.ReduceLROnPlateau(lr=1e-3, patience=2)
    b = jsched.ReduceLROnPlateau(lr=1e-3, patience=2)
    assert [a.step(m) for m in metrics] == [b.step(m) for m in metrics]
    assert (a.best, a.num_bad) == (b.best, b.num_bad)
    assert [schedules.cosine_annealing(1e-4, ep, 50, 1e-6)
            for ep in range(60)] == \
        [jsched.cosine_annealing(1e-4, ep, 50, 1e-6) for ep in range(60)]


@pytest.mark.parametrize("kind,clip", [("adam", 1.0), ("adam", 100.0),
                                       ("adamw", 1.0), ("adam", None)])
def test_optimizer_matches_optax(kind, clip):
    """Three steps of the port's optimizer against the JAX engine's optax
    chain, with the global-norm clip triggering (1.0) and not (100.0)."""
    rng = np.random.default_rng(6)
    shapes = [(5, 3), (7,), (2, 2, 2)]
    params = [rng.normal(size=s).astype(np.float32) for s in shapes]
    cfg = dict(optimizer=kind, grad_clip=clip, weight_decay=1e-2)
    tx = jengine.make_optimizer(jengine.TrainConfig(**cfg))
    opt = engine.make_optimizer(engine.TrainConfig(**cfg))
    jp = [jnp.asarray(p) for p in params]
    tp = [torch.from_numpy(p.copy()) for p in params]
    jstate, tstate = tx.init(jp), opt.init(tp)
    for step, lr in enumerate((1e-2, 5e-3, 1e-3)):
        grads = [rng.normal(size=s).astype(np.float32) * (step + 1)
                 for s in shapes]
        upd, jstate = tx.update([jnp.asarray(g) for g in grads], jstate, jp,
                                jnp.float32(lr))
        jp = optax.apply_updates(jp, upd)
        tupd, tstate = opt.update([torch.from_numpy(g) for g in grads],
                                  tstate, tp, lr)
        torch._foreach_add_(tp, tupd)
        for a, b in zip(tp, jp):
            np.testing.assert_allclose(a.numpy(), np.asarray(b), rtol=1e-6,
                                       atol=1e-7)


@pytest.mark.parametrize("n,batch", [(12, 4), (13, 4), (3, 8), (40, 16)])
def test_pad_indices_matches_jax(n, batch):
    rows = np.arange(100, 100 + n)
    for seed in (0, 42):
        got = engine.Trainer._pad_indices(rows, batch,
                                          np.random.default_rng(seed))
        want = jengine.Trainer._pad_indices(rows, batch,
                                            np.random.default_rng(seed))
        for a, b in zip(got, want):
            np.testing.assert_array_equal(a, b)
            assert a.dtype == b.dtype
    for a, b in zip(engine.Trainer._pad_indices(rows, batch, None),
                    jengine.Trainer._pad_indices(rows, batch, None)):
        np.testing.assert_array_equal(a, b)


def test_trainer_refuses_what_is_not_ported():
    # meshes are ported (tests/test_torch_parallel.py); the sharded risk
    # set still needs one, as JAX's Trainer says
    with pytest.raises(ValueError, match="sharded_risk_set requires a mesh"):
        engine.Trainer(lambda g: None, None, sharded_risk_set=True,
                       device="cpu")
    # aot_cache_dir (refused until io/aot_cache.py was ported) routes the
    # process's kernel builds through the cache; aot_info reports them
    from multimodal_survival_prediction_tpu_torch.io import aot_cache

    saved = aot_cache.CACHE_DIR
    try:
        tr = engine.Trainer(lambda g: None, None, aot_cache_dir="x",
                            device="cpu")
        assert str(aot_cache.CACHE_DIR) == "x"
    finally:
        aot_cache.CACHE_DIR = saved
    assert tr.aot_info == aot_cache.report()
    assert engine.Trainer(lambda g: None, None, device="cpu").aot_info == {}
    # the streaming epochs are ported: they run (tests/test_torch_streaming.py
    # holds them bit-equal to the device-resident ones)
    from multimodal_survival_prediction_tpu_torch.models import (
        RNASeqSurvivalModel,
    )

    tr = engine.Trainer(lambda g: RNASeqSurvivalModel(rna_dim=8, generator=g),
                        lambda b: (b["rnaseq"],), device="cpu")
    rng = np.random.default_rng(0)
    host = {"rnaseq": rng.normal(size=(20, 8)).astype(np.float32),
            "time": rng.uniform(1, 100, 20).astype(np.float32),
            "event": (rng.uniform(size=20) < 0.6).astype(np.float32),
            "svalid": np.ones(20, np.float32)}
    state = tr.init_state(fold=1)
    state, loss = tr.train_epoch_streaming(state, host, np.arange(20),
                                           np.random.default_rng(1), 1e-3)
    assert np.isfinite(loss) and tuple(tr.step_losses.shape) == (2,)
    c, loss, hazards = tr.evaluate_streaming(state, host, np.arange(20))
    assert 0.0 <= c <= 1.0 and np.isfinite(loss) and hazards.shape == (20,)


# ---------------------------------------------------------------------------
# One Trainer epoch of partial_modality (fused_bn1) from the same weights
# ---------------------------------------------------------------------------

RNA_DIM = 40


def _cohort(n=12, seed=7):
    rng = np.random.default_rng(seed)
    mask = np.ones((n, 3), np.float32)
    mask[[1, 5], 0] = 0.0   # no CT
    mask[[2, 9], 1] = 0.0   # no RNA
    mask[[4], 2] = 0.0      # no age
    svalid = np.ones(n, np.float32)
    svalid[[3, 8]] = 0.0    # unlabeled
    time = rng.integers(5, 60, n).astype(np.float32) * svalid
    time[6] = time[0]       # a tied time
    event = (rng.uniform(size=n) < 0.6).astype(np.float32) * svalid
    event[0] = event[6] = 1.0
    return {
        "image": (rng.normal(size=(n, 16, 16, 8, 1))
                  * mask[:, 0, None, None, None, None]).astype(np.float32),
        "rnaseq": (rng.normal(size=(n, RNA_DIM)) * mask[:, 1:2]
                   ).astype(np.float32),
        "clinical": (rng.uniform(0.3, 0.8, (n, 1)) * mask[:, 2:3]
                     ).astype(np.float32),
        "mask": mask, "time": time, "event": event, "svalid": svalid,
    }


def _torch_sd(params, batch_stats):
    tree = jax.tree_util.tree_map(np.asarray, {"params": params,
                                               "batch_stats": batch_stats})
    return {k: torch.from_numpy(np.array(v)) for k, v in
            jax_import.export_torch_state_dict("partial_modality",
                                               tree).items()}


def test_trainer_epoch_matches_jax(monkeypatch):
    """From the JAX init carried across, with dropout off on both sides:
    the first step's gradients, one epoch (3 steps of 4 over 12 rows, the
    fused kernels' plain versions on the port side, Pallas interpret on the
    JAX side), the updated parameters and running stats, then the pooled
    evaluation."""
    monkeypatch.setattr(fnn, "Dropout", _NoDropout)
    arrays = _cohort()
    rows = np.arange(12)
    lr = PARTIAL_MODALITY.learning_rate
    cfg_kw = dict(batch_size=4, learning_rate=lr,
                  weight_decay=PARTIAL_MODALITY.weight_decay,
                  optimizer=PARTIAL_MODALITY.optimizer,
                  grad_clip=PARTIAL_MODALITY.grad_clip,
                  ties=PARTIAL_MODALITY.ties, seed=PARTIAL_MODALITY.seed)

    # --- JAX side
    jcfg = jconfig.PARTIAL_MODALITY
    _, jb2i, jhaa = jadapters.make_model_and_adapters(jcfg, rna_dim=RNA_DIM)
    jm = JGated(backbone="densenet121", block_config=(2, 2), fused_bn1=True)
    jtr = jengine.Trainer(jm, jb2i, jhaa, jengine.TrainConfig(**cfg_kw))
    jdata = {k: jnp.asarray(v) for k, v in arrays.items()}
    example = {k: v[:4] for k, v in jdata.items()}
    example["valid"] = example["svalid"]
    jstate = jtr.init_state(example, fold=1)
    init_sd = _torch_sd(jstate.params, jstate.batch_stats)

    perm, bvalid = jengine.Trainer._pad_indices(rows, 4,
                                                np.random.default_rng(11))
    jbatch = jtr._gather_batch(jdata, jnp.asarray(perm[0]),
                               jnp.asarray(bvalid[0]))
    (jloss0, _), jgrads = jax.jit(jax.value_and_grad(
        jtr._loss_fn, has_aux=True))(jstate.params, jstate.batch_stats,
                                     jbatch, jax.random.PRNGKey(0))
    jgrad_sd = _torch_sd(jgrads, jstate.batch_stats)
    jstate, jepoch_loss = jtr.train_epoch(
        jstate, jdata, rows, np.random.default_rng(11), lr,
        jax.random.PRNGKey(1))
    jfinal_sd = _torch_sd(jstate.params, jstate.batch_stats)
    jc, jeval_loss, jh = jtr.evaluate(jstate, jdata, rows)

    # --- port side, from the same weights
    _, b2i, haa = make_model_and_adapters(PARTIAL_MODALITY, rna_dim=RNA_DIM)
    tr = engine.Trainer(
        lambda g: PartialModalityNet(rna_dim=RNA_DIM, block_config=(2, 2),
                                     fused_bn1=True, dropout=0.0,
                                     generator=g),
        b2i, haa, engine.TrainConfig(**cfg_kw), device="cpu")
    state = tr.init_state(fold=1)
    state.model.load_state_dict(init_sd, strict=True)
    data = {k: torch.from_numpy(v) for k, v in arrays.items()}

    saved = {k: v.clone() for k, v in state.model.state_dict().items()}
    batch = tr._gather_batch(data, torch.from_numpy(perm[0]).long(),
                             torch.from_numpy(bvalid[0]))
    loss0, grads = tr.loss_and_grads(state, batch)
    state.model.load_state_dict(saved)  # undo the running-stat update
    np.testing.assert_allclose(float(loss0), float(jloss0), rtol=1e-5)
    names = [n for n, _ in state.model.named_parameters()]
    assert len(names) == len(grads)
    port_grads = {n: g.numpy() for n, g in zip(names, grads)}
    for name, g in zip(names, grads):
        want = jgrad_sd[name].numpy()
        np.testing.assert_allclose(
            g.numpy(), want, rtol=1e-4,
            atol=1e-6, err_msg=name)

    fd.reset_launches()
    state, epoch_loss = tr.train_epoch(state, data, rows,
                                       np.random.default_rng(11), lr)
    assert state.step == 3
    assert [k.launches for k in fd.KERNELS] == [0, 0, 0, 0]  # plain on CPU
    np.testing.assert_allclose(epoch_loss, jepoch_loss, rtol=1e-5)
    final = state.model.state_dict()
    n_noise = n_params = 0
    for k, want in jfinal_sd.items():
        if k.endswith("num_batches_tracked"):
            continue
        if k.endswith(("running_mean", "running_var")):
            tol = np.float32(1e-4)
        else:
            # Adam divides by sqrt(v) + 1e-8, so an element whose gradient
            # is zero up to rounding (0 < |g| < 1e-9 on either side; e.g.
            # norm0's β, whose shift the max-pool passes almost uniformly
            # into the next train-mode BN, which cancels it) steps by noise
            # of either sign: it is held to the 3 steps' reach, 3·lr each
            noise = np.zeros(want.shape, bool)
            for g in (jgrad_sd[k].numpy(), port_grads[k]):
                noise |= (g != 0) & (np.abs(g) < 1e-9)
            tol = np.where(noise, 9 * lr, 1e-5)
            n_noise += int(noise.sum())
            n_params += noise.size
        diff = np.abs(final[k].numpy() - want.numpy())
        assert np.all(diff <= tol), (k, float(diff.max()))
    # a small share (0.23 % of the parameters with this seed)
    assert n_noise <= 1e-2 * n_params, (n_noise, n_params)
    moved = max(float((final[k] - init_sd[k]).abs().max())
                for k in names)
    assert moved > 5e-5  # the parameters did take Adam steps

    c, eval_loss, h = tr.evaluate(state, data, rows)
    assert abs(c - jc) <= 1e-6
    np.testing.assert_allclose(h, np.asarray(jh), atol=1e-4)
    np.testing.assert_allclose(eval_loss, jeval_loss, rtol=1e-4, atol=1e-5)
