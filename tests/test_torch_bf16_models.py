"""Every model family in bfloat16 against the JAX package, on the CPU: the
gated flagship and the seven other families, with both CT backbones, in
eval mode and in train mode with gradients.

Weights: a seeded JAX init with non-trivial BatchNorm running stats,
carried to the port by ``export_torch_state_dict``; the same weights run
the JAX model in float32 and in bf16 (``dtype=jnp.bfloat16``) and the port
model in bf16 (``dtype=torch.bfloat16``). Inputs: seeded numpy, the rows
of tests/test_torch_families.py (no CT, no RNA, no age, no modality at
all). Train mode has dropout off on both sides, as there. The JAX DenseNet
is cut to ``block_config=(2, 2)`` at 16x16x8 as there.

bf16 rounding is not bit-equal across frameworks, so every limit is JAX's
own bf16-vs-f32 gap on the same inputs: the port's bf16-vs-JAX-bf16 gap is
at most twice it, for each output (max |d|) and for the gradients (max
|d| over every parameter, in units of the largest float32 |gradient|). A
bf16 output may also sit one bf16 ulp (2^-7 |value|) away beyond that:
two roundings of nearly equal sums can land on neighbouring bf16 values
whatever the paths' gap (without it the gated DenseNet's eval hazard
failed at one ulp, 4.9e-4 against twice JAX's 2.3e-4). Measured on these
seeds: outputs at most 0.69 x JAX's gap beyond the ulp (partial_modality,
simple_cnn, train), gradients at most 1.74 x (simple_fusion,
densenet121; JAX's own gap there is 0.25 of the largest gradient).
The dtypes at the named points equal JAX's: each encoder's output,
MMsurv's tokens (its first transformer block's output) and every output of
the model (the hazard first).
"""

import flax.linen as fnn
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from multimodal_survival_prediction_tpu import config as jconfig
from multimodal_survival_prediction_tpu.models import fusion as jfusion
from multimodal_survival_prediction_tpu.models import gated as jgated
from multimodal_survival_prediction_tpu.models import mmsurv as jmmsurv
from multimodal_survival_prediction_tpu.models import moe as jmoe
from multimodal_survival_prediction_tpu.models.encoders import (
    ImageEncoder as JImageEncoder,
)
from multimodal_survival_prediction_tpu.train import adapters as jadapters
from multimodal_survival_prediction_tpu_torch.config import ALL_CONFIGS
from multimodal_survival_prediction_tpu_torch.io.jax_import import (
    export_torch_state_dict,
)
from multimodal_survival_prediction_tpu_torch.models import (
    FlexibleMultimodalModel,
    ImageOnlyModel,
    MMsurvNet,
    MultiModalSurvivalNet,
    PartialModalityNet,
    RNASeqSurvivalModel,
    SimMLMSurvivalNet,
    SimpleFusionModel,
)
from multimodal_survival_prediction_tpu_torch.models.layers import Dropout
from multimodal_survival_prediction_tpu_torch.train.adapters import (
    make_adapters,
    make_model_and_adapters,
)

BF16 = torch.bfloat16
ULP = 2.0 ** -7  # one bf16 ulp of v is at most 2^-7 |v|
RNA_DIM = 40
IMAGE = (16, 16, 8)

PORT = {
    "rnaseq_only": RNASeqSurvivalModel,
    "image_only": ImageOnlyModel,
    "simple_fusion": SimpleFusionModel,
    "flexible_multimodal": FlexibleMultimodalModel,
    "final": MultiModalSurvivalNet,
    "partial_modality": PartialModalityNet,
    "simmim": SimMLMSurvivalNet,
    "mmsurv": MMsurvNet,
}
BACKBONED = ("simple_fusion", "flexible_multimodal", "final",
             "partial_modality", "simmim", "mmsurv")
CASES = ([(name, None, train) for name in ("rnaseq_only", "image_only")
          for train in (False, True)]
         + [(name, backbone, train) for name in BACKBONED
            for backbone in ("densenet121", "simple_cnn")
            for train in (False, True)])

# (JAX module path, port module path) of each output whose dtype is held
POINTS = {
    "rnaseq_only": [],
    "image_only": [("encoder", "encoder")],
    "simple_fusion": [("rna_encoder", "rna_encoder"),
                      ("image_encoder", "image_encoder")],
    "flexible_multimodal": [("image_encoder", "image_encoder"),
                            ("rna_encoder", "rna_encoder")],
    "final": [("ct_encoder", "ct_encoder"), ("rna_encoder", "rna_encoder"),
              ("clinical_encoder", "clinical_encoder")],
    "partial_modality": [("ct_encoder", "ct_encoder"),
                         ("rna_encoder", "rna_encoder"),
                         ("clinical_encoder", "clinical_encoder")],
    "simmim": [("expert_image", "expert_image.encoder"),
               ("expert_rnaseq", "expert_rnaseq.encoder"),
               ("expert_clinical", "expert_clinical.encoder")],
    "mmsurv": [("image_encoder", "image_encoder"),
               ("rna_encoder", "rna_encoder"),
               ("clinical_encoder", "clinical_encoder"),
               ("layer0", "layer0")],
}


class _NoDropout(fnn.Module):
    """Stand-in for flax ``nn.Dropout``: the identity."""

    rate: float = 0.0
    deterministic: bool | None = None

    def __call__(self, x, deterministic=None, rng=None):
        return x


class _SmallImageEncoder(JImageEncoder):
    """JAX ``ImageEncoder`` whose DenseNet defaults to two blocks."""

    block_config: tuple | None = (2, 2)


@pytest.fixture
def small_jax_densenet(monkeypatch):
    for mod in (jfusion, jgated, jmoe, jmmsurv):
        monkeypatch.setattr(mod, "ImageEncoder", _SmallImageEncoder)


def _batch(seed=1, b=5):
    """Rows: 0 no CT, 1 no RNA, 2 no age, 3 no modality at all, 4 all
    three; missing inputs zero-filled."""
    rng = np.random.default_rng(seed)
    mask = np.ones((b, 3), np.float32)
    mask[0, 0] = mask[1, 1] = mask[2, 2] = 0.0
    mask[3] = 0.0
    return {
        "image": (rng.normal(size=(b, *IMAGE, 1)).astype(np.float32)
                  * mask[:, 0, None, None, None, None]),
        "rnaseq": rng.normal(size=(b, RNA_DIM)).astype(np.float32)
        * mask[:, 1:2],
        "clinical": rng.uniform(0.3, 0.8, size=(b, 1)).astype(np.float32)
        * mask[:, 2:3],
        "mask": mask,
    }


def _jax_model(name, backbone, dtype):
    kw = {"backbone": backbone} if backbone else {}
    model, b2i, _ = jadapters.make_model_and_adapters(
        jconfig.ALL_CONFIGS[name], rna_dim=RNA_DIM, dtype=dtype, **kw)
    if name == "mmsurv":
        model = model.clone(dropout=0.0)
    if name == "partial_modality" and backbone == "densenet121":
        model = model.clone(block_config=(2, 2))  # it passes its own on
    return model, b2i


def _jax_variables(model, inputs, seed):
    v = model.init({"params": jax.random.PRNGKey(seed),
                    "dropout": jax.random.PRNGKey(seed + 1)}, *inputs)
    v = jax.tree_util.tree_map(np.asarray, dict(v))
    rng = np.random.default_rng(seed)

    def fill(path, leaf):
        if path[-1].key == "mean":
            return rng.normal(0, 0.1, size=np.shape(leaf)).astype(np.float32)
        return rng.uniform(0.5, 1.5, size=np.shape(leaf)).astype(np.float32)

    if "batch_stats" in v:
        v["batch_stats"] = jax.tree_util.tree_map_with_path(
            fill, v["batch_stats"])
    return v


def _port_model(name, backbone):
    if backbone is None:
        kw = {"rna_dim": RNA_DIM} if name == "rnaseq_only" else {}
    else:
        kw = dict(rna_dim=RNA_DIM, backbone=backbone,
                  block_config=(2, 2) if backbone == "densenet121" else None)
        if name == "mmsurv":
            kw["dropout"] = 0.0
    model = PORT[name](dtype=BF16, **kw)
    for m in model.modules():
        if isinstance(m, Dropout):
            m.p = 0.0
    return model


def _sd(name, variables):
    return {k: torch.from_numpy(np.array(v)) for k, v in
            export_torch_state_dict(name, variables).items()}


def _outputs(out):
    return list(out) if isinstance(out, tuple) else [out]


def _jax_run(jm, v, jinputs, train, cot, points):
    """(outputs as float32 numpy, their dtypes, the dtypes at the points,
    the gradient tree or None)."""
    mutable = ["intermediates"] + (["batch_stats"] if train else [])

    def run(params):
        out, upd = jm.apply({**v, "params": params}, *jinputs, train=train,
                            capture_intermediates=True, mutable=mutable)
        h = _outputs(out)[0]
        return (h.astype(jnp.float32) * cot).sum(), (out, upd)

    if train:
        (_, (out, upd)), grads = jax.value_and_grad(run, has_aux=True)(
            v["params"])
    else:
        _, (out, upd) = run(v["params"])
        grads = None
    inter = upd["intermediates"]
    dtypes = [str(inter[j]["__call__"][0].dtype) for j, _ in points]
    return ([np.asarray(o, np.float32) for o in _outputs(out)],
            [str(o.dtype) for o in _outputs(out)], dtypes, grads)


@pytest.mark.parametrize("name,backbone,train", CASES, ids=[
    f"{n}-{b or 'own'}-{'train' if t else 'eval'}" for n, b, t in CASES])
def test_family_bf16_matches_jax_bf16(name, backbone, train,
                                      small_jax_densenet, monkeypatch):
    if train:
        monkeypatch.setattr(fnn, "Dropout", _NoDropout)
    batch = _batch()
    points = POINTS[name]
    jm32, jb2i = _jax_model(name, backbone, None)
    jm16, _ = _jax_model(name, backbone, jnp.bfloat16)
    jinputs = tuple(np.asarray(x) for x in jb2i(batch))
    v = _jax_variables(jm32, jinputs, seed=3)
    cot = np.random.default_rng(9).normal(size=5).astype(np.float32)
    j32, _, _, g32 = _jax_run(jm32, v, jinputs, train, cot, points)
    j16, jout_dtypes, jdtypes, g16 = _jax_run(jm16, v, jinputs, train, cot,
                                              points)

    port = _port_model(name, backbone)
    port.load_state_dict(_sd(name, v), strict=True)
    port.train(train)
    seen = []
    for _, path in points:
        port.get_submodule(path).register_forward_hook(
            lambda m, a, out: seen.append(
                str(_outputs(out)[0].dtype).split(".")[-1]))
    b2i, _ = make_adapters(ALL_CONFIGS[name])
    out = _outputs(port(*b2i({k: torch.from_numpy(x)
                              for k, x in batch.items()})))
    assert seen == jdtypes, (seen, jdtypes)
    assert [str(o.dtype).split(".")[-1] for o in out] == jout_dtypes
    for i, (o, a32, a16) in enumerate(zip(out, j32, j16)):
        got = o.detach().float().numpy()
        assert got.shape == a16.shape and np.all(np.isfinite(got))
        jgap = float(np.abs(a16 - a32).max())
        # a bf16 output is two roundings of nearly equal sums: they may land
        # on neighbouring bf16 values whatever the paths' gap
        ulp = ULP * np.abs(a16) if o.dtype == BF16 else 0.0
        pgap = float((np.abs(got - a16) - ulp).max())
        assert pgap <= 2 * jgap, (f"output {i}", pgap, jgap)
    if not train:
        return

    h = out[0].float()
    params = dict(port.named_parameters())
    grads = torch.autograd.grad((h * torch.from_numpy(cot)).sum(),
                                list(params.values()), allow_unused=True,
                                materialize_grads=True)
    assert all(g.dtype == torch.float32 for g in grads)
    w32 = _sd(name, {**v, "params": jax.tree_util.tree_map(np.asarray, g32)})
    w16 = _sd(name, {**v, "params": jax.tree_util.tree_map(np.asarray, g16)})
    top = max(float(w32[n].abs().max()) for n in params)
    jgap = max(float((w16[n] - w32[n]).abs().max()) for n in params) / top
    pgap = max(float((g - w16[n]).abs().max())
               for n, g in zip(params, grads)) / top
    assert pgap <= 2 * jgap, ("gradients", pgap, jgap)


@pytest.mark.parametrize("name", list(ALL_CONFIGS))
def test_bf16_models_keep_float32_state(name):
    """A bf16 model's parameters and buffers are float32, with the float32
    model's state_dict keys, so a float32 checkpoint loads into it
    strictly and back."""
    kw = dict(rna_dim=RNA_DIM, backbone="simple_cnn")
    f32 = make_model_and_adapters(
        ALL_CONFIGS[name], generator=torch.Generator().manual_seed(0),
        **kw)[0]
    b16 = make_model_and_adapters(
        ALL_CONFIGS[name], generator=torch.Generator().manual_seed(1),
        dtype=BF16, **kw)[0]
    sd = f32.state_dict()
    assert list(b16.state_dict()) == list(sd)
    b16.load_state_dict(sd, strict=True)
    for k, t in b16.state_dict().items():
        assert t.dtype == sd[k].dtype and torch.equal(t, sd[k]), k
        if t.is_floating_point():
            assert t.dtype == torch.float32, k
