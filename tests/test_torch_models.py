"""Port models (multimodal_survival_prediction_tpu_torch/models) against the
JAX modules, on the CPU.

Weights: a seeded JAX init with seeded non-trivial BatchNorm running stats,
carried to the port through its ``io/jax_import.py``. Inputs: seeded numpy,
the same arrays for both. Compared in eval mode, and in train mode with
dropout off (the JAX dropout replaced by the identity for the test; the port
built with dropout=0), including the updated running stats.
Tolerance: 1e-4 absolute — fp32 convolutions and reductions in different
orders on both sides.
"""

import flax.linen as fnn
import jax
import numpy as np
import pytest
import torch

from multimodal_survival_prediction_tpu.models.densenet3d import (
    DenseNet121_3D as JDenseNet,
)
from multimodal_survival_prediction_tpu.models.gated import (
    PartialModalityNet as JGated,
)
from multimodal_survival_prediction_tpu_torch.io import jax_import
from multimodal_survival_prediction_tpu_torch.models import (
    DenseNet121_3D,
    PartialModalityNet,
)
from multimodal_survival_prediction_tpu_torch.models.layers import BatchNorm

ATOL = 1e-4


class _NoDropout(fnn.Module):
    """Stand-in for flax ``nn.Dropout``: the identity (train-mode parity
    with dropout off; the JAX models hard-code a 0.3 rate)."""

    rate: float = 0.0
    deterministic: bool | None = None

    def __call__(self, x, deterministic=None, rng=None):
        return x


def _randomize_stats(tree, rng):
    """Non-trivial running stats: mean ~ N(0, 0.1), var ~ U(0.5, 1.5)."""
    def fill(path, leaf):
        name = path[-1].key
        shape = np.shape(leaf)
        if name == "mean":
            return rng.normal(0, 0.1, size=shape).astype(np.float32)
        return rng.uniform(0.5, 1.5, size=shape).astype(np.float32)
    return jax.tree_util.tree_map_with_path(fill, tree)


def _jax_variables(model, inputs, seed):
    v = model.init({"params": jax.random.PRNGKey(seed),
                    "dropout": jax.random.PRNGKey(seed + 1)}, *inputs)
    v = jax.tree_util.tree_map(np.asarray, dict(v))
    v["batch_stats"] = _randomize_stats(v["batch_stats"],
                                        np.random.default_rng(seed))
    return v


def _densenet_state_dict(variables):
    out = {}
    jax_import._exp_densenet121(out, "m", variables["params"],
                                variables["batch_stats"])
    return {k[2:]: torch.from_numpy(np.array(v)) for k, v in out.items()}


def _gated_state_dict(variables):
    return {k: torch.from_numpy(np.array(v)) for k, v in
            jax_import.export_torch_state_dict("partial_modality",
                                               variables).items()}


def _running_stats(sd):
    return {k: v for k, v in sd.items()
            if k.endswith(("running_mean", "running_var"))}


def _assert_stats_close(port_model, jax_sd):
    want = _running_stats(jax_sd)
    got = _running_stats(port_model.state_dict())
    assert set(got) == set(want)
    for k in want:
        np.testing.assert_allclose(got[k].numpy(), want[k].numpy(),
                                   atol=ATOL, err_msg=k)


def _ct(rng, b, shape):
    return rng.normal(size=(b, *shape, 1)).astype(np.float32)


@pytest.mark.parametrize("train", [False, True], ids=["eval", "train"])
def test_densenet_small_matches_jax(train):
    rng = np.random.default_rng(0)
    x = _ct(rng, 3, (16, 16, 8))
    jm = JDenseNet(block_config=(2, 2))
    v = _jax_variables(jm, (x,), seed=0)
    port = DenseNet121_3D(block_config=(2, 2))
    port.load_state_dict(_densenet_state_dict(v), strict=True)
    port.train(train)
    got = port(torch.from_numpy(x))
    if train:
        want, upd = jm.apply(v, x, train=True, mutable=["batch_stats"])
        _assert_stats_close(port, _densenet_state_dict(
            {"params": v["params"], "batch_stats": upd["batch_stats"]}))
    else:
        want = jm.apply(v, x)
    np.testing.assert_allclose(got.detach().numpy(), np.asarray(want),
                               atol=ATOL)


def _gated_inputs(rng, b, shape, rna_dim):
    mask = np.ones((b, 3), np.float32)
    mask[0, 0] = 0.0  # no CT
    mask[1, 1] = 0.0  # no RNA
    mask[2, 2] = 0.0  # no age
    ct = _ct(rng, b, shape) * mask[:, 0, None, None, None, None]
    rna = rng.normal(size=(b, rna_dim)).astype(np.float32) * mask[:, 1:2]
    clin = rng.uniform(0.3, 0.8, size=(b, 1)).astype(np.float32) * mask[:, 2:3]
    return ct, rna, clin, mask


@pytest.mark.parametrize("backbone,train", [
    ("densenet121", False), ("densenet121", True),
    ("simple_cnn", False), ("simple_cnn", True)])
def test_partial_modality_matches_jax(backbone, train, monkeypatch):
    rng = np.random.default_rng(1)
    inputs = _gated_inputs(rng, 4, (16, 16, 8), 40)
    block_config = (2, 2) if backbone == "densenet121" else None
    jm = JGated(backbone=backbone, block_config=block_config)
    v = _jax_variables(jm, inputs, seed=2)
    port = PartialModalityNet(rna_dim=40, backbone=backbone,
                              block_config=block_config, dropout=0.0)
    port.load_state_dict(_gated_state_dict(v), strict=True)
    port.train(train)
    hazard, gates = port(*(torch.from_numpy(a) for a in inputs))
    if train:
        monkeypatch.setattr(fnn, "Dropout", _NoDropout)
        (jh, jg), upd = jm.apply(v, *inputs, train=True,
                                 mutable=["batch_stats"])
        _assert_stats_close(port, _gated_state_dict(
            {"params": v["params"], "batch_stats": upd["batch_stats"]}))
    else:
        jh, jg = jm.apply(v, *inputs)
    np.testing.assert_allclose(hazard.detach().numpy(), np.asarray(jh),
                               atol=ATOL)
    np.testing.assert_allclose(gates.detach().numpy(), np.asarray(jg),
                               atol=ATOL)
    np.testing.assert_allclose(gates.sum(-1).detach().numpy(), 1.0,
                               atol=1e-6)


def test_densenet121_full_blocks_eval_matches_jax():
    """The one full-block DenseNet121 case: 32^3, B=1, eval."""
    rng = np.random.default_rng(3)
    x = _ct(rng, 1, (32, 32, 32))
    jm = JDenseNet()
    v = _jax_variables(jm, (x,), seed=4)
    port = DenseNet121_3D().eval()
    port.load_state_dict(_densenet_state_dict(v), strict=True)
    with torch.inference_mode():
        got = port(torch.from_numpy(x))
    np.testing.assert_allclose(got.numpy(), np.asarray(jm.apply(v, x)),
                               atol=ATOL)


@pytest.mark.parametrize("train", [False, True], ids=["eval", "train"])
def test_batchnorm_follows_flax(train):
    """Fast variance clipped at 0, BIASED running-var update, momentum 0.9,
    on (N, C) and (N, C, D, H, W) inputs."""
    rng = np.random.default_rng(6)
    for shape in ((8, 5), (2, 5, 3, 4, 2)):
        x = rng.normal(2.0, 3.0, size=shape).astype(np.float32)
        gamma = rng.uniform(0.5, 1.5, size=5).astype(np.float32)
        beta = rng.normal(size=5).astype(np.float32)
        ra_m = rng.normal(size=5).astype(np.float32)
        ra_v = rng.uniform(0.5, 2.0, size=5).astype(np.float32)
        x_cl = np.moveaxis(x, 1, -1)  # flax normalizes the last axis
        fbn = fnn.BatchNorm(use_running_average=not train, momentum=0.9,
                            epsilon=1e-5)
        fv = {"params": {"scale": gamma, "bias": beta},
              "batch_stats": {"mean": ra_m, "var": ra_v}}
        bn = BatchNorm(5)
        bn.load_state_dict({"weight": torch.from_numpy(gamma),
                            "bias": torch.from_numpy(beta),
                            "running_mean": torch.from_numpy(ra_m),
                            "running_var": torch.from_numpy(ra_v),
                            "num_batches_tracked": torch.tensor(0)})
        bn.train(train)
        got = bn(torch.from_numpy(x)).detach().numpy()
        if train:
            want, upd = fbn.apply(fv, x_cl, mutable=["batch_stats"])
            np.testing.assert_allclose(bn.running_mean.numpy(),
                                       upd["batch_stats"]["mean"], atol=1e-5)
            np.testing.assert_allclose(bn.running_var.numpy(),
                                       upd["batch_stats"]["var"], atol=1e-5)
        else:
            want = fbn.apply(fv, x_cl)
        np.testing.assert_allclose(got, np.moveaxis(np.asarray(want), -1, 1),
                                   atol=1e-5)


def test_densenet_guards(monkeypatch):
    from multimodal_survival_prediction_tpu_torch.models import densenet3d

    port = DenseNet121_3D(block_config=(2, 2))
    with pytest.raises(ValueError, match="spatial dims >= 8"):
        port(torch.zeros(1, 4, 16, 16, 1))
    with pytest.raises(ValueError, match="unknown trunk"):
        DenseNet121_3D(block_config=(2, 2), trunk="other")
    calls = []
    real = densenet3d.fused_bn_relu_conv1x1
    monkeypatch.setattr(densenet3d, "fused_bn_relu_conv1x1",
                        lambda *a: calls.append(a[0].shape) or real(*a))
    x = torch.from_numpy(_ct(np.random.default_rng(7), 2, (16, 16, 8)))
    plain = DenseNet121_3D(block_config=(2, 2))
    want_eval = plain.eval()(x)
    want_train = plain.train()(x)
    fused = DenseNet121_3D(block_config=(2, 2), fused_bn1=True)
    # eval ignores fused_bn1, as in JAX
    torch.testing.assert_close(fused.eval()(x), want_eval, rtol=0, atol=0)
    assert calls == []
    # train mode runs the fused stage: 2 + 2 dense layers, one transition
    torch.testing.assert_close(fused.train()(x), want_train, rtol=1e-5,
                               atol=1e-5)
    assert len(calls) == 5
    # an int threshold fuses only stages with at most that many rows
    # (block 0 here: 2 * 4*4*2 = 64 rows; block 1: 2 * 2*2*1 = 8 rows)
    calls.clear()
    DenseNet121_3D(block_config=(2, 2), fused_bn1=4).train()(x)
    assert calls == []
    DenseNet121_3D(block_config=(2, 2), fused_bn1=8).train()(x)
    assert calls == [(8, 64), (8, 96)]


def test_dropout_draws_from_an_explicit_generator():
    """Two runs seeded alike draw equal masks, whatever torch.manual_seed
    says; another seed draws others; eval mode is the identity; Dropout has
    no state, so state_dict keys are unchanged."""
    from torch import nn

    from multimodal_survival_prediction_tpu_torch.models.layers import (
        Dropout,
        set_dropout_generator,
    )

    inputs = [torch.from_numpy(a) for a in
              _gated_inputs(np.random.default_rng(8), 4, (16, 16, 8), 40)]

    def hazard(seed, global_seed, train=True):
        torch.manual_seed(global_seed)
        m = PartialModalityNet(rna_dim=40, backbone="simple_cnn",
                               generator=torch.Generator().manual_seed(0))
        set_dropout_generator(m, torch.Generator().manual_seed(seed))
        return m.train(train)(*inputs)[0].detach()

    a, b, c = hazard(1, 0), hazard(1, 123), hazard(2, 0)
    torch.testing.assert_close(a, b, rtol=0, atol=0)
    assert not torch.equal(a, c)
    torch.testing.assert_close(hazard(1, 0, train=False),
                               hazard(2, 5, train=False), rtol=0, atol=0)

    drop = Dropout(0.5, torch.Generator().manual_seed(3)).train()
    y = drop(torch.ones(1000))
    assert set(y.unique().tolist()) == {0.0, 2.0}
    assert 400 < int((y == 0).sum()) < 600
    assert drop.state_dict() == {} and nn.Dropout(0.5).state_dict() == {}
    assert torch.equal(Dropout(0.5).eval()(y), y)
    with pytest.raises(RuntimeError, match="generator"):
        Dropout(0.5).train()(y)


def test_same_generator_seed_same_weights():
    a = PartialModalityNet(rna_dim=40, backbone="simple_cnn",
                           generator=torch.Generator().manual_seed(7))
    b = PartialModalityNet(rna_dim=40, backbone="simple_cnn",
                           generator=torch.Generator().manual_seed(7))
    c = PartialModalityNet(rna_dim=40, backbone="simple_cnn",
                           generator=torch.Generator().manual_seed(8))
    for k, v in a.state_dict().items():
        torch.testing.assert_close(v, b.state_dict()[k], rtol=0, atol=0)
    assert not torch.equal(a.state_dict()["gate.0.weight"],
                           c.state_dict()["gate.0.weight"])
    # DenseNet head bias is zero (MONAI), conv weights kaiming-normal
    d = DenseNet121_3D(block_config=(2, 2))
    assert torch.all(d.class_layers["out"].bias == 0)
    w = d.features["conv0"].weight.detach()
    assert abs(float(w.std()) - (2.0 / (1 * 7 ** 3)) ** 0.5) < 0.01
