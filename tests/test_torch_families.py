"""The port's seven other model families against the JAX modules, on the
CPU: RNA-only, image-only, simple / flexible / final fusion, SimMLM and
MMsurv (``multimodal_survival_prediction_tpu_torch/models``), their weight
carry-over (``io/jax_import.py``) and their adapters' inputs.

Weights: a seeded JAX init with seeded non-trivial BatchNorm running stats,
carried to the port by ``export_torch_state_dict``. Inputs: seeded numpy,
the same arrays for both, fed through each side's own adapter; the rows
cover no CT, no RNA, no age and no modality at all. Compared in eval mode,
and in train mode with dropout off (flax ``nn.Dropout`` replaced by the
identity; every port ``Dropout`` at p = 0; MMsurv built with dropout 0.0 on
both sides), with both CT backbones. The JAX DenseNet is cut to
``block_config=(2, 2)`` at 16x16x8 by a subclass of JAX ``ImageEncoder``
put into the JAX model modules' namespaces for the test (no JAX file
changes). Tolerances: outputs 1e-4 absolute (``test_torch_models.ATOL``),
updated BatchNorm running stats 1e-5; weight maps exact.
"""

import flax.linen as fnn
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from benchmarks import torch_reference_named as named
from multimodal_survival_prediction_tpu import config as jconfig
from multimodal_survival_prediction_tpu.io.torch_import import (
    export_torch_state_dict as jax_export,
)
from multimodal_survival_prediction_tpu.models import fusion as jfusion
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
    RNASeqSurvivalModel,
    SimMLMSurvivalNet,
    SimpleFusionModel,
)
from multimodal_survival_prediction_tpu_torch.models.layers import Dropout
from multimodal_survival_prediction_tpu_torch.models.mmsurv import (
    MultiHeadAttention,
    count_sketch_matrix,
)
from multimodal_survival_prediction_tpu_torch.train.adapters import (
    make_adapters,
    make_model_and_adapters,
)

ATOL = 1e-4  # test_torch_models.ATOL
STATS_ATOL = 1e-5
RNA_DIM = 40
IMAGE = (16, 16, 8)
FULL_IMAGE = (64, 64, 32)

# family -> the port model's class (None: no CT backbone choice)
PORT = {
    "rnaseq_only": RNASeqSurvivalModel,
    "image_only": ImageOnlyModel,
    "simple_fusion": SimpleFusionModel,
    "flexible_multimodal": FlexibleMultimodalModel,
    "final": MultiModalSurvivalNet,
    "simmim": SimMLMSurvivalNet,
    "mmsurv": MMsurvNet,
}
BACKBONED = ("simple_fusion", "flexible_multimodal", "final", "simmim",
             "mmsurv")
CASES = ([(name, None, train) for name in ("rnaseq_only", "image_only")
          for train in (False, True)]
         + [(name, backbone, train) for name in BACKBONED
            for backbone in ("densenet121", "simple_cnn")
            for train in (False, True)])


class _NoDropout(fnn.Module):
    """Stand-in for flax ``nn.Dropout``: the identity (the JAX models
    hard-code their rates)."""

    rate: float = 0.0
    deterministic: bool | None = None

    def __call__(self, x, deterministic=None, rng=None):
        return x


def _jax_variables(model, inputs, seed):
    """A seeded JAX init whose running stats are non-trivial: mean ~
    N(0, 0.1), var ~ U(0.5, 1.5)."""
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


class _SmallImageEncoder(JImageEncoder):
    """JAX ``ImageEncoder`` whose DenseNet defaults to two blocks."""

    block_config: tuple | None = (2, 2)


@pytest.fixture
def small_jax_densenet(monkeypatch):
    for mod in (jfusion, jmoe, jmmsurv):
        monkeypatch.setattr(mod, "ImageEncoder", _SmallImageEncoder)


def _batch(seed=1, b=5, rna_dim=RNA_DIM, shape=IMAGE):
    """Rows: 0 no CT, 1 no RNA, 2 no age, 3 no modality at all, 4 all three;
    missing inputs zero-filled, as the cohort arrays hold them."""
    rng = np.random.default_rng(seed)
    mask = np.ones((b, 3), np.float32)
    mask[0, 0] = mask[1, 1] = mask[2, 2] = 0.0
    mask[3] = 0.0
    return {
        "image": (rng.normal(size=(b, *shape, 1)).astype(np.float32)
                  * mask[:, 0, None, None, None, None]),
        "rnaseq": rng.normal(size=(b, rna_dim)).astype(np.float32)
        * mask[:, 1:2],
        "clinical": rng.uniform(0.3, 0.8, size=(b, 1)).astype(np.float32)
        * mask[:, 2:3],
        "mask": mask,
    }


def _jax_model(name, backbone):
    """The JAX model and batch_to_inputs, from the JAX adapters."""
    kw = {"backbone": backbone} if backbone else {}
    model, b2i, _ = jadapters.make_model_and_adapters(
        jconfig.ALL_CONFIGS[name], rna_dim=RNA_DIM, **kw)
    if name == "mmsurv":
        model = model.clone(dropout=0.0)
    return model, b2i


def _port_model(name, backbone):
    if backbone is None:
        kw = {"rna_dim": RNA_DIM} if name == "rnaseq_only" else {}
    else:
        kw = dict(rna_dim=RNA_DIM, backbone=backbone,
                  block_config=(2, 2) if backbone == "densenet121" else None)
        if name == "mmsurv":
            kw["dropout"] = 0.0
    model = PORT[name](**kw)
    for m in model.modules():
        if isinstance(m, Dropout):
            m.p = 0.0
    return model


def _state_dict(name, variables):
    return {k: torch.from_numpy(np.array(v)) for k, v in
            export_torch_state_dict(name, variables).items()}


def _stats(sd):
    return {k: v for k, v in sd.items()
            if k.endswith(("running_mean", "running_var"))}


def _outputs(out):
    return [np.asarray(o) for o in (out if isinstance(out, tuple) else (out,))]


@pytest.mark.parametrize("name,backbone,train", CASES, ids=[
    f"{n}-{b or 'own'}-{'train' if t else 'eval'}" for n, b, t in CASES])
def test_family_matches_jax(name, backbone, train, small_jax_densenet,
                            monkeypatch):
    batch = _batch()
    jm, jb2i = _jax_model(name, backbone)
    jinputs = tuple(np.asarray(x) for x in jb2i(batch))
    v = _jax_variables(jm, jinputs, seed=3)
    port = _port_model(name, backbone)
    port.load_state_dict(_state_dict(name, v), strict=True)
    port.train(train)
    b2i, _ = make_adapters(ALL_CONFIGS[name])
    got = port(*b2i({k: torch.from_numpy(x) for k, x in batch.items()}))
    got = _outputs(tuple(g.detach() for g in got) if isinstance(got, tuple)
                   else got.detach())
    if train:
        monkeypatch.setattr(fnn, "Dropout", _NoDropout)
        out, upd = jm.apply(v, *jinputs, train=True, mutable=["batch_stats"])
        want_stats = _stats(_state_dict(name, {**v, **upd}))
        got_stats = _stats(port.state_dict())
        assert set(got_stats) == set(want_stats) and want_stats
        for k, w in want_stats.items():
            np.testing.assert_allclose(got_stats[k].numpy(), w.numpy(),
                                       atol=STATS_ATOL, err_msg=k)
    else:
        out = jm.apply(v, *jinputs)
    want = _outputs(out)
    assert len(got) == len(want)
    for g, w in zip(got, want):
        assert g.shape == w.shape
        np.testing.assert_allclose(g, w, atol=ATOL)
        assert np.all(np.isfinite(g))
    if name == "simmim":
        gates = got[2]
        assert np.all(gates[3] == 0.0)  # the all-missing row
        np.testing.assert_allclose(gates[[0, 1, 2, 4]].sum(-1), 1.0,
                                   atol=1e-6)
        assert gates[0, 0] == gates[1, 1] == gates[2, 2] == 0.0


@pytest.mark.parametrize("backbone", ["densenet121", "simple_cnn"])
def test_mmsurv_masked_tokens(backbone):
    """Eval mode: a row without CT (no image token, no CBP token) and a row
    with no modality at all score the same whatever their zero-masked
    inputs would have held; the CBP token changes the others."""
    port = _port_model("mmsurv", backbone).eval()
    batch = {k: torch.from_numpy(x) for k, x in _batch().items()}
    b2i, _ = make_adapters(ALL_CONFIGS["mmsurv"])
    with torch.inference_mode():
        base = port(*b2i(batch))
        noisy = dict(batch, image=batch["image"] + 1.0,
                     rnaseq=batch["rnaseq"].clone())
        noisy["rnaseq"][3] += 1.0
        moved = port(*b2i(noisy))
        port.cbp_proj.bias.add_(1.0)
        cbp_moved = port(*b2i(batch))
    torch.testing.assert_close(moved[[0, 3]], base[[0, 3]], rtol=0, atol=0)
    assert not torch.allclose(moved[[2, 4]], base[[2, 4]])
    # the CBP token counts only where CT and RNA are both present
    torch.testing.assert_close(cbp_moved[[0, 1, 3]], base[[0, 1, 3]],
                               rtol=0, atol=0)
    assert not torch.allclose(cbp_moved[[2, 4]], base[[2, 4]])


def test_attention_matches_flax_with_an_all_masked_row():
    """The hand-written attention against flax's MultiHeadDotProductAttention
    (4 heads, 128 wide, 4 tokens): a row whose keys are all masked gets a
    uniform softmax (flax fills with finfo.min), so its output is the
    output projection of the values' mean; equal to flax at 1e-5."""
    rng = np.random.default_rng(4)
    x = rng.normal(size=(3, 4, 128)).astype(np.float32)
    pad = np.array([[1, 1, 0, 1], [0, 0, 0, 0], [1, 0, 0, 0]], np.float32)
    fm = fnn.MultiHeadDotProductAttention(num_heads=4, dropout_rate=0.0,
                                          deterministic=True)
    mask = pad[:, None, None, :] > 0
    v = fm.init(jax.random.PRNGKey(0), x, x, mask=mask)
    want, inter = fm.apply(v, x, x, mask=mask, sow_weights=True,
                           mutable=["intermediates"])
    weights = np.asarray(inter["intermediates"]["attention_weights"][0])
    np.testing.assert_allclose(weights[1], 0.25, atol=1e-7)

    from multimodal_survival_prediction_tpu_torch.io.jax_import import (
        _exp_attention,
    )

    sd = {}
    _exp_attention(sd, "attn", jax.tree_util.tree_map(np.asarray,
                                                      v["params"]))
    attn = MultiHeadAttention(128, 4, 0.0, generator=torch.Generator())
    attn.load_state_dict(
        {k[5:]: torch.from_numpy(np.array(a)) for k, a in sd.items()},
        strict=True)
    xt, pt = torch.from_numpy(x), torch.from_numpy(pad)
    with torch.inference_mode():
        got = attn(xt, pt)
        uniform = attn.out(attn.value(xt[1]).mean(0))
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=1e-5)
    torch.testing.assert_close(got[1], uniform.expand(4, -1), rtol=1e-6,
                               atol=1e-6)


def test_layer_norm_follows_flax():
    """flax's LayerNorm (fast variance, epsilon 1e-6) on tokens with and
    without an offset, and all-zero (masked) tokens: 1e-5."""
    from multimodal_survival_prediction_tpu_torch.models.mmsurv import (
        LayerNorm,
    )

    rng = np.random.default_rng(5)
    x = np.concatenate([rng.normal(size=(3, 4, 128)),
                        rng.normal(5.0, 1.0, size=(1, 4, 128)),
                        np.zeros((1, 4, 128))]).astype(np.float32)
    scale = rng.uniform(0.5, 1.5, 128).astype(np.float32)
    bias = rng.normal(size=128).astype(np.float32)
    want = fnn.LayerNorm().apply({"params": {"scale": scale, "bias": bias}},
                                 x)
    ln = LayerNorm(128)
    ln.load_state_dict({"weight": torch.from_numpy(scale),
                        "bias": torch.from_numpy(bias)})
    with torch.inference_mode():
        got = ln(torch.from_numpy(x))
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=1e-5)


@pytest.mark.parametrize("offset", [5.0, 30.0, 100.0, 300.0, 1000.0])
def test_layer_norm_is_as_close_to_float64_as_flax(offset):
    """Where a token's mean dwarfs its spread (mean ``offset``, std 1), the
    fast variance E[x²] − E[x]² cancels in float32 in both frameworks, and
    the port and flax part by more than 1e-5 (their sums round in other
    orders): neither is the better. Held: the port's RMS error against the
    float64 LayerNorm at most twice flax's + 1e-7 (measured: at most 1.4x
    over six seeds)."""
    from multimodal_survival_prediction_tpu_torch.models.mmsurv import (
        LayerNorm,
    )

    rng = np.random.default_rng(int(offset))
    x = rng.normal(offset, 1.0, size=(4, 8, 128)).astype(np.float32)
    scale = rng.uniform(0.5, 1.5, 128).astype(np.float32)
    bias = rng.normal(size=128).astype(np.float32)
    want = np.asarray(fnn.LayerNorm().apply(
        {"params": {"scale": scale, "bias": bias}}, x))
    ln = LayerNorm(128)
    ln.load_state_dict({"weight": torch.from_numpy(scale),
                        "bias": torch.from_numpy(bias)})
    with torch.inference_mode():
        got = ln(torch.from_numpy(x)).numpy()
    x64 = x.astype(np.float64)
    mean = x64.mean(-1, keepdims=True)
    exact = ((x64 - mean) / np.sqrt(x64.var(-1, keepdims=True) + 1e-6)
             * scale + bias)

    def rms(a):
        return float(np.sqrt(((a - exact) ** 2).mean()))

    assert rms(got) <= 2.0 * rms(want) + 1e-7, (rms(got), rms(want))


def test_attention_dropout_mask_is_shared_across_batch_and_heads():
    """Train mode: one (1, 1, T, T) keep mask scales every row and head,
    drawn from the model's dropout generator."""
    from multimodal_survival_prediction_tpu_torch.models.layers import (
        set_dropout_generator,
    )

    attn = MultiHeadAttention(8, 2, 0.5, generator=torch.Generator())
    set_dropout_generator(attn, torch.Generator().manual_seed(0))
    seen = []
    real = attn.dropout.forward
    attn.dropout.forward = lambda t: seen.append(t.shape) or real(t)
    x = torch.randn(3, 4, 8, generator=torch.Generator().manual_seed(1))
    attn.train()(x, torch.ones(3, 4))
    assert seen == [(1, 1, 4, 4)]


def test_count_sketch_matches_jax():
    for dims, seed in (((128, 256), 1), ((128, 256), 2), ((7, 5), 3)):
        np.testing.assert_array_equal(count_sketch_matrix(*dims, seed),
                                      jmmsurv._count_sketch_matrix(*dims,
                                                                   seed))
    m = MMsurvNet(rna_dim=RNA_DIM, backbone="simple_cnn")
    assert not any(k.startswith("cbp.") for k in m.state_dict())
    np.testing.assert_array_equal(m.cbp.sketch_y.numpy(),
                                  jmmsurv._count_sketch_matrix(128, 256, 2))


# ---------------------------------------------------------------------------
# Weight maps at full width (DenseNet121-3D at 64x64x32, 5,005 genes)
# ---------------------------------------------------------------------------

def _full_width_tree(name, backbone, seed):
    kw = {"backbone": backbone} if backbone else {}
    model, b2i, _ = jadapters.make_model_and_adapters(
        jconfig.ALL_CONFIGS[name], rna_dim=5005, **kw)
    batch = {"image": jnp.zeros((1, *FULL_IMAGE, 1)),
             "rnaseq": jnp.zeros((1, 5005)), "clinical": jnp.zeros((1, 1)),
             "mask": jnp.zeros((1, 3))}
    shapes = jax.eval_shape(lambda: model.init(
        {"params": jax.random.PRNGKey(0), "dropout": jax.random.PRNGKey(0)},
        *b2i(batch)))
    rng = np.random.default_rng(seed)
    return jax.tree_util.tree_map(
        lambda s: rng.normal(size=s.shape).astype(s.dtype), dict(shapes))


FULL_CASES = ([(n, None) for n in ("rnaseq_only", "image_only")]
              + [(n, b) for n in BACKBONED
                 for b in ("densenet121", "simple_cnn")])


@pytest.mark.parametrize("name,backbone", FULL_CASES,
                         ids=[f"{n}-{b or 'own'}" for n, b in FULL_CASES])
def test_full_width_export_loads_strictly(name, backbone):
    """The port's map equals the JAX export key for key (mmsurv: the JAX
    export has no branch, so the port's own map), and the full-width port
    model from ``make_model_and_adapters`` takes it strictly."""
    tree = _full_width_tree(name, backbone, seed=12)
    got = export_torch_state_dict(name, tree)
    if name != "mmsurv":
        want = jax_export(name, tree)
        assert list(got) == list(want)
        for k in want:
            np.testing.assert_array_equal(got[k], want[k], err_msg=k)
            assert got[k].dtype == want[k].dtype
    model = make_model_and_adapters(
        ALL_CONFIGS[name], rna_dim=5005,
        backbone=backbone or "densenet121")[0]
    sd = {k: torch.from_numpy(np.array(v)) for k, v in got.items()}
    model.load_state_dict(sd, strict=True)
    loaded = model.state_dict()
    assert set(loaded) == set(got)
    for k, v in sd.items():
        torch.testing.assert_close(loaded[k], v, rtol=0, atol=0)


NAMED = {
    "rnaseq_only": lambda monai: named.build_reference_named_rnaseq(5005),
    "image_only": lambda monai: named.build_reference_named_image_only(),
    "simple_fusion": lambda monai: named.build_reference_named_simple_fusion(
        5005, use_monai=monai),
    "flexible_multimodal": lambda monai: named.build_reference_named_flexible(
        5005, use_monai=monai),
    "final": lambda monai: named.build_reference_named_final(
        5005, use_monai=monai),
    "simmim": lambda monai: named.build_reference_named_simmlm(
        5005, use_monai=monai),
}
NAMED_CASES = [(n, b) for n, b in FULL_CASES if n in NAMED]


@pytest.mark.parametrize("name,backbone", NAMED_CASES,
                         ids=[f"{n}-{b or 'own'}" for n, b in NAMED_CASES])
def test_keys_match_the_reference_layout(name, backbone):
    """Key set and shapes of the port model's state_dict equal those of the
    reference-named torch twin (MONAI DenseNet or the fallback CNN)."""
    want = NAMED[name](backbone != "simple_cnn").state_dict()
    got = make_model_and_adapters(ALL_CONFIGS[name], rna_dim=5005,
                                  backbone=backbone or "densenet121")[0]
    got = got.state_dict()
    assert set(got) == set(want)
    for k, v in want.items():
        assert tuple(got[k].shape) == tuple(v.shape), k
