"""``DenseNet121_3D(fused_bn1=True, dropout=p)`` in train mode on the CPU:
the dense layer's dropout keeps the trunk in ``channels_last_3d`` memory,
so the next fused stage views it as (rows, C) without a copy (JAX
``models/densenet3d.py`` trains the fused model at any dropout).

Fused against unfused from the same weights, input and dropout uniforms
(``models/layers.py:dropout_uniforms``), on the plain layer, under remat
and under the fold-parallel step's ``vmap(grad_and_value)``, at the limits
``chip_smoke.py`` holds fused against unfused training with (phase 8's
first-step loss, 1e-5 relative; phase 7's gradient rtol, 1e-4, here on the
whole gradient's ||fused - unfused|| / ||unfused||: batch-statistics
BatchNorm makes conv0's and norm0's own gradients cancel, and they move by
a few percent between any two orders of the same sums). Dropout 0 stays
bit-equal to the dense layer before the repair.
"""

import numpy as np
import pytest
import torch
from torch.func import functional_call, grad_and_value, vmap

from multimodal_survival_prediction_tpu_torch.models import DenseNet121_3D
from multimodal_survival_prediction_tpu_torch.models import densenet3d
from multimodal_survival_prediction_tpu_torch.models.layers import (
    BatchNorm,
    Dropout,
    dropout_uniforms,
)
from multimodal_survival_prediction_tpu_torch.ops import fused_dense as fd
from multimodal_survival_prediction_tpu_torch.train.cv_parallel import (
    no_vmap_fallback,
)

LOSS_RTOL = 1e-5  # chip_smoke.FIRST_LOSS_RTOL
GRAD_RTOL = 1e-4  # chip_smoke.FUSED_GRAD_RTOL
SMALL = (2, 2)
STAGES = sum(SMALL) + len(SMALL) - 1
P = 0.2


@pytest.fixture(autouse=True)
def _few_threads():
    threads = torch.get_num_threads()
    torch.set_num_threads(min(threads, 2))
    yield
    torch.set_num_threads(threads)


def _inputs(batch=4, seed=0):
    rng = np.random.default_rng(seed)
    x = torch.from_numpy(rng.normal(size=(batch, 16, 16, 16, 1))
                         .astype(np.float32))
    head = torch.from_numpy(rng.normal(size=(batch, 8)).astype(np.float32))
    # the dense layers' dropout shapes at 16^3: (B, growth, 4^3) twice,
    # then (B, growth, 2^3) twice
    uniforms = [torch.from_numpy(rng.uniform(size=(batch, 32, s, s, s))
                                 .astype(np.float32)) for s in (4, 4, 2, 2)]
    return x, head, uniforms


def _model(fused, dropout=P, remat=False, seed=0):
    return DenseNet121_3D(out_features=8, block_config=SMALL,
                          fused_bn1=fused, dropout=dropout, remat=remat,
                          generator=torch.Generator().manual_seed(seed)
                          ).train()


def _step(model, x, head, uniforms):
    """Loss, gradients by name and BatchNorm buffers after one train-mode
    forward and backward, every dropout fed ``uniforms`` in order."""
    feed = iter(uniforms)
    with dropout_uniforms(lambda t: next(feed)):
        loss = (model(x) * head).sum()
    names = [n for n, _ in model.named_parameters()]
    grads = torch.autograd.grad(loss, list(model.parameters()))
    return loss.detach(), dict(zip(names, grads)), {
        n: b.clone() for n, b in model.named_buffers()}


def _whole_gap(a: dict, b: dict) -> float:
    num = sum(float((a[n] - b[n]).norm()) ** 2 for n in b)
    return (num / sum(float(g.norm()) ** 2 for g in b.values())) ** 0.5


def _counted(monkeypatch):
    calls = [0]
    plain = fd.apply_plain

    def counted(*a, **k):
        calls[0] += 1
        return plain(*a, **k)

    monkeypatch.setattr(fd, "apply_plain", counted)
    return calls


def _held(fused, unfused):
    (lf, gf, bf), (lu, gu, bu) = fused, unfused
    assert torch.all((lf - lu).abs() <= LOSS_RTOL * lu.abs())
    assert _whole_gap(gf, gu) <= GRAD_RTOL
    for n in bu:
        if n.endswith("num_batches_tracked"):
            assert torch.equal(bf[n], bu[n])
        else:
            torch.testing.assert_close(bf[n], bu[n], rtol=LOSS_RTOL,
                                       atol=1e-6)


@pytest.mark.parametrize("remat", [False, True], ids=["plain", "remat"])
def test_fused_trains_with_dropout_as_unfused(remat, monkeypatch):
    """Each fused stage runs (``apply`` once a stage, and again in each
    dense layer's recompute) on a trunk that stayed channels_last_3d, and
    the step equals the unfused one at the limits above."""
    x, head, uniforms = _inputs()
    calls = _counted(monkeypatch)
    fused = _step(_model(True, remat=remat), x, head, uniforms)
    assert calls[0] == STAGES + (sum(SMALL) if remat else 0)
    unfused = _step(_model(False, remat=remat), x, head, uniforms)
    assert calls[0] == STAGES + (sum(SMALL) if remat else 0)
    _held(fused, unfused)
    # the mask really dropped: another draw gives another loss
    other = _step(_model(True, remat=remat), x, head,
                  [u.flip(0) for u in uniforms])
    assert not torch.equal(other[0], fused[0])


def _stacked_step(fused, remat, x, head, uniforms):
    """Two folds (weights seeded 0 and 1, fold 2 on the flipped batch and
    uniforms) through ``vmap(grad_and_value)`` over stacked parameters, as
    ``train/cv_parallel.py`` steps them."""
    models = [_model(fused, remat=remat, seed=s) for s in (0, 1)]
    template = models[0]
    params = {n: torch.stack([dict(m.named_parameters())[n].detach()
                              for m in models])
              for n, _ in template.named_parameters()}
    buffers = {n: torch.stack([dict(m.named_buffers())[n] for m in models])
               for n, _ in template.named_buffers()}

    def fold_loss(p, b, xx, us):
        feed = iter(us)
        with dropout_uniforms(lambda t: next(feed)):
            return (functional_call(template, (p, b), (xx,)) * head).sum()

    with no_vmap_fallback():
        grads, loss = vmap(grad_and_value(fold_loss))(
            params, buffers, torch.stack([x, x.flip(0)]),
            [torch.stack([u, u.flip(0)]) for u in uniforms])
    return loss, grads, buffers


@pytest.mark.parametrize("remat", [False, True], ids=["plain", "remat"])
def test_fused_trains_with_dropout_under_vmap(remat, monkeypatch):
    """The stacked step: the fused op's vmap rule runs each fold's (rows,
    C) slice on its own (one ``apply`` a fold and a stage), the trunk's
    layout read from the unwrapped fold, and each fold's loss, gradients
    and running stats equal the unfused stacked step's."""
    x, head, uniforms = _inputs()
    calls = _counted(monkeypatch)
    fused = _stacked_step(True, remat, x, head, uniforms)
    assert calls[0] == 2 * (STAGES + (sum(SMALL) if remat else 0))
    unfused = _stacked_step(False, remat, x, head, uniforms)
    for k in range(2):
        _held(*[(loss[k], {n: g[k] for n, g in grads.items()},
                 {n: b[k] for n, b in bufs.items()})
                for loss, grads, bufs in (fused, unfused)])


def _forward_before(self, x, fused: bool = False):
    """``_DenseLayer.forward`` before the repair, without remat: the
    dropout's output concatenated along dim 1."""
    m = self.layers
    if fused:
        y = densenet3d._fused_stage(m["norm1"], m["conv1"], x)
    else:
        y = m["conv1"](torch.nn.functional.relu(m["norm1"](x)))
    y = m["conv2"](torch.nn.functional.relu(m["norm2"](y)))
    return torch.cat([x, self.dropout(y)], dim=1)


def _layout_before(x):
    return x.contiguous(memory_format=torch.channels_last_3d)


@pytest.mark.parametrize("fused", [True, False], ids=["fused", "unfused"])
def test_dropout_zero_is_bit_equal_to_before(fused, monkeypatch):
    x, head, _ = _inputs()
    now = _step(_model(fused, dropout=0.0), x, head, [])
    monkeypatch.setattr(densenet3d._DenseLayer, "forward", _forward_before)
    monkeypatch.setattr(densenet3d, "_channels_last", _layout_before)
    before = _step(_model(fused, dropout=0.0), x, head, [])
    assert torch.equal(now[0], before[0])
    assert all(torch.equal(now[1][n], before[1][n]) for n in before[1])
    assert all(torch.equal(now[2][n], before[2][n]) for n in before[2])


@pytest.mark.parametrize("layout", [torch.contiguous_format,
                                    torch.channels_last_3d],
                         ids=["standard", "channels_last_3d"])
def test_dropout_keeps_the_layout_and_the_mask(layout):
    """Dropout's output has its input's strides and, bit for bit, the
    values of ``torch.where(u >= p, x / (1 - p), 0.0)``, gradient
    included; under vmap too."""
    rng = np.random.default_rng(4)
    x = torch.from_numpy(rng.normal(size=(3, 5, 4, 3, 2)).astype(
        np.float32)).contiguous(memory_format=layout).requires_grad_()
    u = torch.from_numpy(rng.uniform(size=(3, 5, 4, 3, 2)).astype(
        np.float32))
    drop = Dropout(P).train()
    with dropout_uniforms(lambda t: u):
        y = drop(x)
    want = torch.where(u >= P, x / (1 - P), 0.0)
    assert y.stride() == x.stride()
    assert torch.equal(y, want)
    g = torch.from_numpy(rng.normal(size=y.shape).astype(np.float32))
    assert torch.equal(torch.autograd.grad(y, x, g)[0],
                       torch.autograd.grad(want, x, g)[0])
    xs = torch.stack([x.detach(), -x.detach()])
    us = torch.stack([u, u.flip(0)])

    def one(xx, uu):
        with dropout_uniforms(lambda t: uu):
            return drop(xx)

    with no_vmap_fallback():
        ys = vmap(one)(xs, us)
    assert torch.equal(ys, torch.where(us >= P, xs / (1 - P), 0.0))


def test_the_fused_stage_still_refuses_a_standard_trunk():
    """The layout check reads the unwrapped trunk and still raises on a
    trunk that is not channels_last_3d, under vmap too."""
    layer = _model(True).features["denseblock1"]["denselayer1"]
    x = torch.randn(2, 64, 4, 4, 4)
    with pytest.raises(RuntimeError, match="not channels_last_3d"):
        layer(x, True)
    m = layer.layers
    with pytest.raises(RuntimeError, match="not channels_last_3d"):
        vmap(lambda t: densenet3d._fused_stage(m["norm1"], m["conv1"], t))(
            torch.randn(2, 2, 64, 4, 4, 4))
    assert isinstance(m["norm1"], BatchNorm)
