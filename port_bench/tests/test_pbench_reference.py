"""The plain reference against the port on the CPU, given the same
weights: the model (train and eval mode, BatchNorm statistics, dropout
masks from a generator seeded alike), the losses, the optimizer and the
C-index. At full width only the state_dict keys and shapes are compared."""

import numpy as np
import pytest
import torch

import pbench_tiny
from port_bench.core import registry, synth
from port_bench.reference import compare
from port_bench.reference import model as ref_model
from port_bench.reference import survival

CONFIGS = ["partial_modality-dn121-f32", "simple_fusion-dn121-f32"]


def _port_model(cfg, fused=False):
    return registry.load_program(cfg["family"]).model(
        {**cfg, "fused_bn1": fused})


def _batch(cfg, n, seed):
    a = cfg["arch"]
    g = torch.Generator().manual_seed(seed)
    mask = (torch.rand((n, 3), generator=g) < 0.7).float()
    mask[:, 2] = 1
    return {
        "image": torch.rand((n, *a["image_shape"], 1), generator=g),
        "rnaseq": torch.randn((n, a["rna_dim"]), generator=g),
        "clinical": torch.rand((n, 1), generator=g),
        "mask": mask,
        "time": torch.rand(n, generator=g) * 1000,
        "event": (torch.rand(n, generator=g) < 0.6).float(),
        "svalid": torch.ones(n), "valid": torch.ones(n)}


def _inputs(cfg, b):
    if cfg["family"] == "partial_modality":
        return b["image"], b["rnaseq"], b["clinical"], b["mask"]
    return b["image"], b["rnaseq"]


@pytest.mark.parametrize("name", CONFIGS)
def test_keys_and_shapes_at_full_width(name):
    cfg = pbench_tiny.tiny_config(name)
    cfg["arch"] = __import__("json").loads(
        (registry.BENCH / "configs" / f"{name}.json"
         ).read_text())["arch"]
    with torch.device("meta"):
        port = _port_model(cfg)
    spec = {k: tuple(s) for k, s, _ in ref_model.param_spec(cfg)}
    assert {k: tuple(v.shape) for k, v in port.state_dict().items()} == spec


@pytest.mark.parametrize("name,fused", [(CONFIGS[0], False),
                                        (CONFIGS[0], True),
                                        (CONFIGS[1], False)])
def test_forward_train_and_eval(name, fused):
    cfg = pbench_tiny.tiny_config(name)
    from multimodal_survival_prediction_tpu_torch.models.layers import (
        set_dropout_generator,
    )

    w = synth.make_weights(ref_model.param_spec(cfg), 7, "cpu")
    port = _port_model(cfg, fused)
    port.load_state_dict(w, strict=True)
    set_dropout_generator(port, torch.Generator().manual_seed(3))
    b = _batch(cfg, 6, 1)
    out = port.train()(*_inputs(cfg, b))
    ctx = ref_model.Context(True, torch.Generator().manual_seed(3))
    h, gates = ref_model.forward(cfg, ctx, w, b)
    h_port = out[0] if isinstance(out, tuple) else out
    torch.testing.assert_close(h_port, h, rtol=1e-4, atol=1e-5)
    if gates is not None:
        torch.testing.assert_close(out[1], gates, rtol=1e-4, atol=1e-6)
    after = ref_model.new_buffers(w, ctx.stats)
    sd = port.state_dict()
    for k, v in after.items():
        torch.testing.assert_close(sd[k].to(v.dtype), v, rtol=1e-4,
                                   atol=1e-6)
    w2 = {**w, **after}
    out = port.eval()(*_inputs(cfg, b))
    h, _ = ref_model.forward(cfg, ref_model.Context(False), w2, b)
    torch.testing.assert_close(out[0] if isinstance(out, tuple) else out,
                               h, rtol=1e-4, atol=1e-5)


def test_losses_optimizer_and_cindex():
    from multimodal_survival_prediction_tpu_torch.ops.cindex import (
        concordance_index,
    )
    from multimodal_survival_prediction_tpu_torch.ops.cox import (
        cox_partial_likelihood,
        gate_entropy_loss,
    )
    from multimodal_survival_prediction_tpu_torch.train.engine import (
        Optimizer,
        TrainConfig,
    )

    g = torch.Generator().manual_seed(0)
    h = torch.randn(16, generator=g)
    t = torch.rand(16, generator=g) * 100
    e = (torch.rand(16, generator=g) < 0.5).float()
    v = (torch.rand(16, generator=g) < 0.8).float()
    torch.testing.assert_close(survival.cox_loss(h, t, e, v),
                               cox_partial_likelihood(h, t, e, valid=v))
    gates = torch.softmax(torch.randn(16, 3, generator=g), -1)
    torch.testing.assert_close(survival.gate_entropy(gates, v),
                               gate_entropy_loss(gates, valid=v))
    assert survival.concordance(h, t, e, v) == pytest.approx(
        float(concordance_index(h, t, e, valid=v)), abs=1e-6)
    for kind, wd in (("adam", 1e-4), ("adamw", 1e-3)):
        params = {"a": torch.randn(5, 4, generator=g),
                  "b": torch.randn(3, generator=g)}
        mine = [p.clone() for p in params.values()]
        opt = Optimizer(TrainConfig(optimizer=kind, weight_decay=wd,
                                    grad_clip=1.0))
        state = opt.init(mine)
        ref_state = {"mu": {}, "nu": {}, "count": 0}
        for _ in range(3):
            grads = {k: torch.randn(p.shape, generator=g) * 2
                     for k, p in params.items()}
            upd, state = opt.update(list(grads.values()), state, mine, 1e-2)
            torch._foreach_add_(mine, upd)
            survival.adam_step(params, grads, ref_state,
                               {"kind": kind, "weight_decay": wd,
                                "grad_clip": 1.0}, 1e-2)
        for p, q in zip(mine, params.values()):
            torch.testing.assert_close(p, q, rtol=1e-6, atol=1e-7)


def test_cohort_counts_every_seed():
    cfg = pbench_tiny.tiny_config("partial_modality-dn121-f32")
    mix = pbench_tiny.registry.load_traffic("epochs_b8")
    for seed in (1, 2 ** 33 + 5):
        data = synth.make_cohort(mix["cohort"], [4, 4, 4], 8, seed, "cpu")
        m = data["mask"].numpy().sum(0)
        assert list(m) == [142, 427, 587]
        assert data["svalid"].sum() == 348
        assert len(synth.select_rows(data, ["ct", "rna", "labelled"])) == 68
        tr, va = synth.fold_rows(data["svalid"].numpy(), 3, 0, seed, True)
        assert (len(tr), len(va)) == (492, 116)
        assert np.intersect1d(tr, va).size == 0


def test_setup_batches_pad_as_the_trainer():
    """A ragged set-up step is padded and masked by the reference as the
    program's Trainer pads and masks it: the same rows in the same order
    (the padding cycles the step's own permutation), ``valid`` and
    ``svalid`` 0 on the padded rows."""
    from multimodal_survival_prediction_tpu_torch.train.engine import Trainer

    g = torch.Generator().manual_seed(4)
    data = {"time": torch.rand(30, generator=g),
            "svalid": (torch.rand(30, generator=g) < 0.7).float(),
            "x": torch.arange(30.0)}
    rows = [np.arange(0, 8), np.arange(10, 15), np.arange(20, 22)]
    inp = compare.Inputs(weights={}, data=data, setup_rows=rows,
                         batch_size=8, shuffle_seed=9, dropout_seed=0,
                         val_rows=np.arange(25, 30))
    rng = np.random.default_rng(9)
    for r, want in zip(rows, compare.setup_batches(inp)):
        idx, bvalid = Trainer._pad_indices(r, 8, rng)
        got = Trainer._gather_batch(
            data, torch.from_numpy(idx[0].astype(np.int64)),
            torch.from_numpy(bvalid[0]))
        assert set(got) == set(want)
        for k in got:
            torch.testing.assert_close(got[k], want[k])
        assert float(want["valid"].sum()) == len(r)


def test_setup_rows_end_with_the_windows_ragged_batch():
    from port_bench.core import registry as reg

    drv = reg.load_driver("train_epochs")
    assert drv.setup_sizes(492, 3, 8) == [8, 8, 4]
    assert drv.setup_sizes(492, 3, 64) == [64, 64, 44]
    assert drv.setup_sizes(48, 3, 8) == [8, 8, 8]
    n = 60
    data = {"event": torch.tensor([i % 3 == 0 for i in range(n)]).float(),
            "svalid": torch.ones(n)}
    rows = drv.pick_setup_rows(data, np.arange(n), [8, 8, 5], 2 ** 33 + 1)
    assert [len(r) for r in rows] == [8, 8, 5]
    every = np.concatenate(rows)
    assert len(np.unique(every)) == len(every)
    assert all((data["event"].numpy()[r] > 0).sum() >= 2 for r in rows)
