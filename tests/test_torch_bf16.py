"""bfloat16 compute in the port against the JAX package, on the CPU: the
fused BN->ReLU->1x1-conv op and its four kernels' plain versions in bf16,
flax's dtype semantics of the layers (``models/layers.py``), the dropout
mask drawn in float32, and one Trainer step of the gated model with
``fused_bn1=True`` in bf16.

On CPU tensors the port's wrappers take their plain versions; the JAX op
runs its Pallas kernels in interpret mode, as tests/test_fused_dense.py
runs them. Inputs come from numpy seeds. Tolerances:
  * bf16 outputs (``out``, ``dx``, dW in W's dtype): one bf16 ulp of the
    JAX value (at most 2^-7 of its magnitude) + 1e-5 x the largest
    |value|: both round one float32 sum once, whose last bits differ with
    the order of the sums;
  * float32 results (moments, mean, var, dgamma, dbeta, the plain dW):
    the float32 tests' rtol 1e-5 (statistics) / 1e-4 (gradients) + 1e-5 x
    the largest |value|;
  * the gated model's Trainer step: JAX's own bf16-vs-f32 gap on the same
    inputs sets each limit; the port's bf16-vs-JAX-bf16 gap is at most
    twice it (the measured numbers are written beside each check).
"""

import flax.linen as fnn
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from multimodal_survival_prediction_tpu import config as jconfig
from multimodal_survival_prediction_tpu.models import layers as jlayers
from multimodal_survival_prediction_tpu.models.gated import (
    PartialModalityNet as JGated,
)
from multimodal_survival_prediction_tpu.ops import fused_dense as jfd
from multimodal_survival_prediction_tpu.train import adapters as jadapters
from multimodal_survival_prediction_tpu.train import engine as jengine
from multimodal_survival_prediction_tpu_torch.config import PARTIAL_MODALITY
from multimodal_survival_prediction_tpu_torch.io import jax_import
from multimodal_survival_prediction_tpu_torch.models import PartialModalityNet
from multimodal_survival_prediction_tpu_torch.models import layers
from multimodal_survival_prediction_tpu_torch.ops import fused_dense as fd
from multimodal_survival_prediction_tpu_torch.train import engine
from multimodal_survival_prediction_tpu_torch.train.adapters import (
    make_model_and_adapters,
)

BF16 = torch.bfloat16
ULP = 2.0 ** -7  # one bf16 ulp of v is at most 2^-7 |v|

# (N, C, F): ragged N with C in {64, 96, 224} and F in {64, 128}, and one
# row (BN then cancels: xhat = 0, dx = 0 in exact arithmetic)
SHAPES = [(97, 64, 64), (130, 96, 128), (75, 224, 64), (1, 96, 64)]


class _NoDropout(fnn.Module):
    """Stand-in for flax ``nn.Dropout``: the identity."""

    rate: float = 0.0
    deterministic: bool | None = None

    def __call__(self, x, deterministic=None, rng=None):
        return x


def _data(n, c, f, seed=0):
    """x, W and the cotangent rounded to bf16 (as float32 numpy arrays, so
    both sides start from the same bf16 values); gamma and beta float32."""
    rng = np.random.default_rng(seed)

    def bf(a):
        return torch.from_numpy(a.astype(np.float32)).to(BF16).float().numpy()

    x = bf(rng.normal(size=(n, c)) * 2.0 + 0.5)
    scale = (rng.normal(size=(c,)) * 0.3 + 1.0).astype(np.float32)
    bias = (rng.normal(size=(c,)) * 0.1).astype(np.float32)
    w = bf(rng.normal(size=(c, f)) / np.sqrt(c))
    cot = bf(rng.normal(size=(n, f)))
    return x, scale, bias, w, cot


def _t16(a):
    return torch.from_numpy(a).to(BF16)


def _j16(a):
    return jnp.asarray(a, jnp.bfloat16)


def _within_ulp(got, want, name, extra=0.0):
    """|got - want| <= 2^-7 |want| + 1e-5 max|want| (one bf16 ulp), +
    ``extra``."""
    got = np.asarray(torch.as_tensor(got).float() if isinstance(
        got, torch.Tensor) else np.asarray(got, np.float32), np.float64)
    want = np.asarray(np.asarray(want, np.float32), np.float64)
    lim = (ULP * np.abs(want) + extra
           + 1e-5 * max(1.0, float(np.abs(want).max())))
    bad = np.abs(got - want) > lim
    assert not bad.any(), (name, int(bad.sum()),
                           float(np.abs(got - want).max()))


def _one_row_slack(n, x, mul, add, w=None, g=None):
    """The extra limit at N = 1 on ``out`` (given W) or on dW (given the
    cotangent g): there xhat = 0 and z = x·mul + add is β plus the rounding
    left by cancelling x·mul against mean·mul (rstd = 1/sqrt(eps)); the two
    frameworks evaluate z with other roundings, so each a = relu(z) may
    round to a neighbouring bf16 value: 2^-7 Σ_c |a_c| |W_cf|, or 2^-7
    |a_c| |g_f| for dW. 0 for N > 1."""
    if n != 1:
        return 0.0
    a = np.abs(np.maximum(
        x.astype(np.float64) * mul.numpy() + add.numpy(), 0.0))
    if g is not None:
        return ULP * a.T @ np.abs(g.astype(np.float64))
    return ULP * a @ np.abs(w.astype(np.float64))


def _one_row_dx_slack(n, mul, g, w):
    """The extra limit on dx at N = 1 when c1 comes from the other side's
    sum: dx = mul·(dz − c1) cancels to 0 in exact arithmetic, and what is
    left is mul times the two float32 sums' difference, at most
    F·2^-23·Σ_f |g_f W_cf| each. 0 for N > 1."""
    if n != 1:
        return 0.0
    f = w.shape[1]
    return (np.abs(mul.numpy()) * f * 2.0 ** -23
            * (np.abs(g.astype(np.float64)) @ np.abs(w.astype(np.float64)).T))


def _close_f32(got, want, rtol, name, extra=0.0):
    """|got - want| <= rtol |want| + 1e-5 max(1, max|want|), + ``extra``."""
    got, want = np.asarray(got, np.float64), np.asarray(want, np.float64)
    lim = (rtol * np.abs(want) + extra
           + 1e-5 * max(1.0, float(np.abs(want).max())))
    bad = np.abs(got - want) > lim
    assert not bad.any(), (name, int(bad.sum()),
                           float(np.abs(got - want).max()))


@pytest.mark.parametrize("n,c,f", SHAPES)
def test_plain_versions_match_jax_kernels_bf16(n, c, f):
    """Each kernel's plain version in bf16 against the JAX kernel it
    replaces (Pallas interpret), on the same bf16 inputs; the output types
    are JAX's: moments, dW, dgamma, dbeta float32; out and dx bf16."""
    x, scale, bias, w, cot = _data(n, c, f, seed=2)
    tx, tw, tg = _t16(x), _t16(w), _t16(cot)
    jx, jw, jg = _j16(x), _j16(w), _j16(cot)
    s, sq = fd.moments_plain(tx)
    js, jsq = jfd._moments(jx)
    assert s.dtype == sq.dtype == torch.float32 and js.dtype == jnp.float32
    _close_f32(s.numpy(), js[0], 1e-5, "sum")
    _close_f32(sq.numpy(), jsq[0], 1e-5, "sumsq")

    mean, var, rstd, mul, add = fd._stats(tx, torch.from_numpy(scale),
                                          torch.from_numpy(bias), 1e-5)
    vec = [jnp.asarray(v.numpy())[None, :] for v in (mul, add, mean, rstd)]
    out = fd.apply_plain(tx, mul, add, tw)
    jout = jfd._apply(jx, vec[0], vec[1], jw)
    assert out.dtype == BF16 and jout.dtype == jnp.bfloat16
    _within_ulp(out, jout, "out", _one_row_slack(n, x, mul, add, w))

    got = fd.bwd_reduce_plain(tx, tg, tw, mul, add, mean, rstd)
    want = jfd._bwd_reduce(jx, jg, jw, *vec)
    for name, a, b in zip(("dW", "dgamma", "dbeta"), got, want):
        assert a.dtype == torch.float32 and b.dtype == jnp.float32, name
        _close_f32(a.numpy(), np.asarray(b).reshape(a.shape), 1e-4, name,
                   _one_row_slack(n, x, mul, add, g=cot) if name == "dW"
                   else 0.0)
    c1, c2 = got[2] / n, got[1] / n
    dx = fd.bwd_dx_plain(tx, tg, tw, mul, add, mean, rstd, c1, c2)
    jdx = jfd._bwd_dx(jx, jg, jw, *vec, jnp.asarray(c1.numpy())[None, :],
                      jnp.asarray(c2.numpy())[None, :])
    assert dx.dtype == BF16 and jdx.dtype == jnp.bfloat16
    _within_ulp(dx, jdx, "dx", _one_row_dx_slack(n, mul, cot, w))


@pytest.mark.parametrize("n,c,f", SHAPES)
def test_fused_op_forward_and_grads_match_jax_bf16(n, c, f):
    """The autograd op in bf16 against JAX's custom VJP in bf16: out (bf16),
    mean and var (float32); dx (bf16), dgamma and dbeta (float32), dW in
    W's dtype (bf16, rounded from the float32 sum as JAX rounds it)."""
    x, scale, bias, w, cot = _data(n, c, f, seed=1)
    args = [_t16(x).requires_grad_(True),
            torch.from_numpy(scale).requires_grad_(True),
            torch.from_numpy(bias).requires_grad_(True),
            _t16(w).requires_grad_(True)]
    out, mean, var = fd.fused_bn_relu_conv1x1(*args)
    got = torch.autograd.grad(out, args, _t16(cot))
    jargs = (_j16(x), jnp.asarray(scale), jnp.asarray(bias), _j16(w))
    jout, jmean, jvar = jfd.fused_bn_relu_conv1x1(*jargs)

    def loss(*a):
        return (jfd.fused_bn_relu_conv1x1(*a)[0].astype(jnp.float32)
                * jnp.asarray(cot)).sum()

    want = jax.grad(loss, argnums=(0, 1, 2, 3))(*jargs)
    assert out.dtype == BF16 and jout.dtype == jnp.bfloat16
    _, _, _, mul, add = fd._stats(args[0].detach(), args[1].detach(),
                                  args[2].detach(), 1e-5)
    _within_ulp(out.detach(), jout, "out", _one_row_slack(n, x, mul, add, w))
    for name, a, b in (("mean", mean, jmean), ("var", var, jvar)):
        assert a.dtype == torch.float32 and not a.requires_grad
        _close_f32(a.numpy(), b, 1e-5, name)
    for name, a, b in zip(("dx", "dgamma", "dbeta", "dW"), got, want):
        assert str(a.dtype).split(".")[-1] == str(b.dtype), name
        if a.dtype == BF16:
            _within_ulp(a, b, name, _one_row_slack(n, x, mul, add, g=cot)
                        if name == "dW" else 0.0)
        else:
            _close_f32(a.numpy(), b, 1e-4, name)
    if n == 1:  # one row: the batch statistics cancel dx exactly
        assert float(got[0].abs().max()) == 0.0


def test_reference_oracle_matches_jax_in_bf16():
    """The plain oracle in bf16 (float32 statistics, bf16 product operands,
    float32 accumulation, one rounding) against JAX's."""
    x, scale, bias, w, _ = _data(64, 96, 64, seed=3)
    got = fd.bn_relu_conv1x1_reference(_t16(x), torch.from_numpy(scale),
                                       torch.from_numpy(bias), _t16(w))
    want = jfd.bn_relu_conv1x1_reference(_j16(x), jnp.asarray(scale),
                                         jnp.asarray(bias), _j16(w))
    assert got[0].dtype == BF16
    _within_ulp(got[0], want[0], "out")
    for a, b in zip(got[1:], want[1:]):
        _close_f32(a.numpy(), b, 1e-5, "stats")


def test_wrappers_take_bf16_and_count_nothing_on_the_cpu():
    """bf16 CPU tensors run the plain versions: no launch is counted in
    either dtype's count; the op still refuses mixed compute dtypes."""
    x, scale, bias, w, _ = _data(8, 64, 64)
    fd.reset_launches()
    out, _, _ = fd.fused_bn_relu_conv1x1(_t16(x), torch.from_numpy(scale),
                                         torch.from_numpy(bias), _t16(w))
    assert out.dtype == BF16
    assert [k.launches for k in fd.KERNELS] == [0, 0, 0, 0]
    assert [k.launches_bf16 for k in fd.KERNELS] == [0, 0, 0, 0]
    with pytest.raises(TypeError, match="same compute dtype"):
        fd.fused_bn_relu_conv1x1(_t16(x), torch.from_numpy(scale),
                                 torch.from_numpy(bias), torch.from_numpy(w))


@pytest.mark.parametrize("c,f", [(64, 128), (96, 64), (224, 128),
                                 (1000, 512)])
def test_bf16_launch_plan_takes_whole_32_deep_steps(c, f):
    """apply's bf16 K step is 32 elements (64 bytes, as a float32 step's
    16), the backward's (the wgmma core's) 64 (128 bytes): every chunk is a
    multiple of its step and the chunks cover K; bwd_dx in bf16 splits F
    into at most 8 chunks (one thread-block cluster)."""
    for n in (1, 32, 97, 2048, 16384):
        p = fd.launch_plan(n, c, f, 132, 2)
        assert p.apply_k_per_chunk % 32 == 0 and p.apply_k_per_chunk <= 1024
        assert p.apply_chunks == -(-c // p.apply_k_per_chunk)
        assert p.dw_rows_per_chunk % 64 == 0
        assert p.dw_chunks == -(-n // p.dw_rows_per_chunk)
        assert p.da_k_per_chunk % 64 == 0
        assert 1 <= p.dx_chunks <= 8
        assert p.dx_chunks == -(-f // p.dx_k_per_chunk)
        assert p.dx_k_per_chunk % 64 == 0
    with pytest.raises(ValueError, match="no kernels"):
        fd.launch_plan(64, c, f, 132, 8)


# (n, c, f) and bf16 bwd_dx's F chunks on a 132-SM card (an H100 SXM): the
# row counts of the train step that split, the widest transition, a short
# last chunk
BF16_DX_SPLITS = [((32, 992, 128), 2), ((256, 992, 128), 2),
                  ((256, 1024, 512), 2), ((2048, 128, 128), 2),
                  ((33, 1000, 130), 3)]


@pytest.mark.parametrize("shape,chunks", BF16_DX_SPLITS)
def test_bf16_dx_split_over_f_matches_jax(shape, chunks):
    """The sum the bf16 cluster kernel of bwd_dx computes, in plain torch:
    P_k = g[:, chunk k] W[:, chunk k]ᵀ of the bf16 operands in float32 at
    the plan's F chunks, summed in ascending k, then the mask [z > 0] and
    the BN backward once, rounded to bf16. Held against JAX's bf16
    ``_bwd_dx`` (Pallas interpret) on the same bf16 inputs to one bf16 ulp
    + 1e-5 x max|dx| (phase 7b's limit: both round one float32 sum whose
    last bits differ with its order). (The kernel itself is held against
    the plain version on the card, tests/test_torch_cuda.py.)"""
    n, c, f = shape
    plan = fd.launch_plan(n, c, f, 132, 2)
    assert plan.dx_chunks == chunks and plan.dx_tile_cols == 64
    x, scale, bias, w, cot = _data(n, c, f, seed=5)
    tx, tw, tg = _t16(x), _t16(w), _t16(cot)
    mean, var, rstd, mul, add = fd._stats(tx, torch.from_numpy(scale),
                                          torch.from_numpy(bias), 1e-5)
    _, dgamma, dbeta = fd.bwd_reduce_plain(tx, tg, tw, mul, add, mean, rstd)
    c1, c2 = dbeta / n, dgamma / n
    da = None
    for lo in range(0, f, plan.dx_k_per_chunk):
        hi = min(f, lo + plan.dx_k_per_chunk)
        part = tg[:, lo:hi].float() @ tw[:, lo:hi].float().T
        da = part if da is None else da + part
    xf = tx.float()
    dz = torch.where(xf * mul + add > 0, da, 0.0)
    dx = (mul * (dz - c1 - (xf - mean) * rstd * c2)).to(BF16)
    vec = [jnp.asarray(v.numpy())[None, :]
           for v in (mul, add, mean, rstd, c1, c2)]
    want = jfd._bwd_dx(_j16(x), _j16(cot), _j16(w), *vec)
    assert want.dtype == jnp.bfloat16
    _within_ulp(dx, want, "dx")


# ---------------------------------------------------------------------------
# flax's dtype semantics of the layers, and the dropout mask
# ---------------------------------------------------------------------------

def _bias_slack(dtype, want, bias):
    """In bf16 a Dense or Conv rounds twice, the product and then the sum
    with the bias: one more ulp of the product, whose magnitude is at most
    |y| + |b|. 0 in float32."""
    if not dtype:
        return 0.0
    return ULP * (np.abs(np.asarray(want, np.float64))
                  + np.abs(np.asarray(bias, np.float64)))


@pytest.mark.parametrize("dtype", [None, "bf16"])
@pytest.mark.parametrize("x_dtype", ["f32", "bf16"])
def test_layers_follow_flax_dtype_semantics(dtype, x_dtype):
    """Dense, Conv and BatchNorm (train and eval): with ``dtype`` set the
    result is in it; with None it is the promotion of input and float32
    params (a bf16 input gives float32), as flax; values within one bf16
    ulp + 1e-5 x max of flax's (bf16 roundings are not bit-equal across
    frameworks). Parameters stay float32."""
    rng = np.random.default_rng(0)
    jdt = jnp.bfloat16 if dtype else None
    tdt = BF16 if dtype else None
    x = rng.normal(size=(6, 10)).astype(np.float32)
    if x_dtype == "bf16":
        x = torch.from_numpy(x).to(BF16).float().numpy()
    jx = jnp.asarray(x, jnp.bfloat16 if x_dtype == "bf16" else jnp.float32)
    tx = torch.from_numpy(x).to(BF16 if x_dtype == "bf16" else torch.float32)

    dense = jlayers.TorchLinear(7, dtype=jdt)
    v = dense.init(jax.random.PRNGKey(0), jx)
    lin = layers.torch_linear(10, 7, generator=torch.Generator(), dtype=tdt)
    lin.load_state_dict({
        "weight": torch.from_numpy(np.array(v["params"]["dense"]["kernel"]).T),
        "bias": torch.from_numpy(np.array(v["params"]["dense"]["bias"]))})
    want, got = dense.apply(v, jx), lin(tx)
    assert str(got.dtype).split(".")[-1] == str(want.dtype)
    _within_ulp(got.detach(), want, "dense",
                _bias_slack(dtype, want, v["params"]["dense"]["bias"]))
    assert lin.weight.dtype == torch.float32

    xc = rng.normal(size=(2, 6, 6, 4, 3)).astype(np.float32)
    jxc = jnp.asarray(xc, jx.dtype)
    txc = torch.from_numpy(xc).to(tx.dtype)
    conv = jlayers.TorchConv(5, (3, 3, 3), padding=[(1, 1)] * 3, dtype=jdt)
    vc = conv.init(jax.random.PRNGKey(1), jxc)
    tconv = layers.conv3d(3, 5, 3, bias=True, kaiming=False,
                          generator=torch.Generator(), dtype=tdt)
    tconv.load_state_dict({
        "weight": torch.from_numpy(np.array(
            vc["params"]["conv"]["kernel"]).transpose(4, 3, 0, 1, 2).copy()),
        "bias": torch.from_numpy(np.array(vc["params"]["conv"]["bias"]))})
    want = conv.apply(vc, jxc)
    got = layers.to_ncdhw(txc)
    got = tconv(got).permute(0, 2, 3, 4, 1)
    assert str(got.dtype).split(".")[-1] == str(want.dtype)
    _within_ulp(got.detach(), want, "conv",
                _bias_slack(dtype, want, vc["params"]["conv"]["bias"]))

    for train in (True, False):
        bn = jlayers.BatchNorm(use_running_average=not train, dtype=jdt)
        vb = bn.init(jax.random.PRNGKey(2), jxc)
        vb = {"params": {"bn": {"scale": rng.uniform(0.5, 1.5, 3).astype(
            np.float32), "bias": rng.normal(size=3).astype(np.float32)}},
              "batch_stats": {"bn": {"mean": rng.normal(size=3).astype(
                  np.float32), "var": rng.uniform(0.5, 1.5, 3).astype(
                      np.float32)}}}
        want, upd = bn.apply(vb, jxc, mutable=["batch_stats"])
        tbn = layers.BatchNorm(3, dtype=tdt)
        tbn.load_state_dict({
            "weight": torch.from_numpy(vb["params"]["bn"]["scale"]),
            "bias": torch.from_numpy(vb["params"]["bn"]["bias"]),
            "running_mean": torch.from_numpy(vb["batch_stats"]["bn"]["mean"]),
            "running_var": torch.from_numpy(vb["batch_stats"]["bn"]["var"]),
            "num_batches_tracked": torch.tensor(0)})
        tbn.train(train)
        got = tbn(txc.permute(0, 4, 1, 2, 3)).permute(0, 2, 3, 4, 1)
        assert str(got.dtype).split(".")[-1] == str(want.dtype), train
        _within_ulp(got.detach(), want, f"bn train={train}")
        assert tbn.running_mean.dtype == torch.float32
        if train:  # statistics in float32 whatever x's type
            np.testing.assert_allclose(
                tbn.running_var.numpy(), upd["batch_stats"]["bn"]["var"],
                rtol=1e-5, atol=1e-6)


def test_dropout_mask_is_drawn_in_float32():
    """A bf16 input gets the float32 input's mask from the same generator
    state (flax draws its bernoulli in float32 whatever the input); the
    keep rate at p = 0.3 is 0.7 within 4 sigma; and the float32 path is
    bit-unchanged: the mask of ``rand(float32) >= p`` and ``x / (1 - p)``."""
    n = 400_000
    x = torch.from_numpy(np.random.default_rng(0).normal(size=n).astype(
        np.float32))
    drop = layers.Dropout(0.3).train()
    outs = {}
    for dt in (torch.float32, BF16):
        drop.generator = torch.Generator().manual_seed(5)
        outs[dt] = drop(x.to(dt))
        assert outs[dt].dtype == dt
    keep32, keep16 = outs[torch.float32] != 0, outs[BF16] != 0
    assert torch.equal(keep32, keep16)
    rate = float(keep16.float().mean())
    assert abs(rate - 0.7) <= 4 * (0.21 / n) ** 0.5, rate
    u = torch.rand(n, generator=torch.Generator().manual_seed(5))
    assert torch.equal(outs[torch.float32],
                       torch.where(u >= 0.3, x / 0.7, 0.0))
    torch.testing.assert_close(outs[BF16], (x.to(BF16) / 0.7) * keep16,
                               rtol=0, atol=0)


# ---------------------------------------------------------------------------
# The fused path in a bf16 model: one Trainer step of the gated model
# ---------------------------------------------------------------------------

RNA_DIM = 40


def _cohort(n=8, seed=7):
    rng = np.random.default_rng(seed)
    mask = np.ones((n, 3), np.float32)
    mask[1, 0] = mask[2, 1] = mask[4, 2] = 0.0
    svalid = np.ones(n, np.float32)
    svalid[3] = 0.0
    time = rng.integers(5, 60, n).astype(np.float32) * svalid
    event = (rng.uniform(size=n) < 0.6).astype(np.float32) * svalid
    event[0] = 1.0
    return {
        "image": (rng.normal(size=(n, 16, 16, 8, 1))
                  * mask[:, 0, None, None, None, None]).astype(np.float32),
        "rnaseq": (rng.normal(size=(n, RNA_DIM)) * mask[:, 1:2]
                   ).astype(np.float32),
        "clinical": (rng.uniform(0.3, 0.8, (n, 1)) * mask[:, 2:3]
                     ).astype(np.float32),
        "mask": mask, "time": time, "event": event, "svalid": svalid,
        "valid": np.ones(n, np.float32),
    }


def _sd(tree):
    tree = jax.tree_util.tree_map(np.asarray, tree)
    return {k: torch.from_numpy(np.array(v)) for k, v in
            jax_import.export_torch_state_dict("partial_modality",
                                               tree).items()}


def test_fused_bf16_trainer_step_matches_jax(monkeypatch):
    """PartialModalityNet(fused_bn1=True, dtype=bf16) with block_config (2,
    2) at 16x16x8, dropout off, from the JAX init: one Trainer step's loss,
    every gradient and the updated BatchNorm running stats against the JAX
    model with fused_bn1=True, dtype=bf16 (Pallas interpret), each within
    twice JAX's own bf16-vs-f32 gap on the same inputs. Measured on this
    seed (port gap / JAX gap): loss 3.1e-4 / 2.2e-4 relative; gradients
    0.213 / 0.122 of the largest float32 |gradient|; running stats 7.7e-4
    / 1.3e-3."""
    monkeypatch.setattr(fnn, "Dropout", _NoDropout)
    arrays = _cohort()
    cfg = jconfig.PARTIAL_MODALITY
    _, jb2i, jhaa = jadapters.make_model_and_adapters(cfg, rna_dim=RNA_DIM)
    jdata = {k: jnp.asarray(v) for k, v in arrays.items()}
    kw = dict(batch_size=8, learning_rate=cfg.learning_rate,
              weight_decay=cfg.weight_decay, optimizer=cfg.optimizer,
              grad_clip=cfg.grad_clip, ties=cfg.ties, seed=cfg.seed)
    jax_runs = {}
    for label, dt in (("f32", None), ("bf16", jnp.bfloat16)):
        jm = JGated(block_config=(2, 2), fused_bn1=True, dtype=dt)
        jtr = jengine.Trainer(jm, jb2i, jhaa, jengine.TrainConfig(**kw))
        jstate = jtr.init_state(jdata, fold=1)
        (loss, stats), grads = jax.value_and_grad(jtr._loss_fn, has_aux=True)(
            jstate.params, jstate.batch_stats, jdata, jax.random.PRNGKey(0))
        jax_runs[label] = dict(
            loss=float(loss), grads=_sd({"params": grads,
                                         "batch_stats": stats}),
            stats=_sd({"params": jstate.params, "batch_stats": stats}))
        init = _sd({"params": jstate.params,
                    "batch_stats": jstate.batch_stats})

    _, b2i, haa = make_model_and_adapters(PARTIAL_MODALITY, rna_dim=RNA_DIM)
    tr = engine.Trainer(
        lambda g: PartialModalityNet(rna_dim=RNA_DIM, block_config=(2, 2),
                                     fused_bn1=True, dropout=0.0,
                                     generator=g, dtype=BF16),
        b2i, haa, engine.TrainConfig(**kw), device="cpu")
    state = tr.init_state(fold=1)
    state.model.load_state_dict(init, strict=True)
    fd.reset_launches()
    seen = []
    real = fd.fused_bn_relu_conv1x1

    def spy(x2, *a):
        seen.append(x2.dtype)
        return real(x2, *a)

    from multimodal_survival_prediction_tpu_torch.models import densenet3d
    monkeypatch.setattr(densenet3d, "fused_bn_relu_conv1x1", spy)
    loss, grads = tr.loss_and_grads(
        state, {k: torch.from_numpy(v) for k, v in arrays.items()})
    assert seen == [BF16] * 5  # 2 + 2 dense layers and one transition
    assert [k.launches_bf16 for k in fd.KERNELS] == [0, 0, 0, 0]
    assert all(p.dtype == torch.float32 for p in state.model.parameters())
    names = [n for n, _ in state.model.named_parameters()]
    assert all(g.dtype == torch.float32 for g in grads)

    f32, b16 = jax_runs["f32"], jax_runs["bf16"]
    jgap = abs(b16["loss"] - f32["loss"]) / abs(f32["loss"])
    pgap = abs(float(loss) - b16["loss"]) / abs(f32["loss"])
    assert pgap <= 2 * jgap, (pgap, jgap)

    top = max(float(f32["grads"][n].abs().max()) for n in names)
    jgap = max(float((b16["grads"][n] - f32["grads"][n]).abs().max())
               for n in names) / top
    pgap = max(float((g - b16["grads"][n]).abs().max())
               for n, g in zip(names, grads)) / top
    assert pgap <= 2 * jgap, (pgap, jgap)

    stats = {k: v for k, v in state.model.state_dict().items()
             if k.endswith(("running_mean", "running_var"))}
    jgap = max(float((b16["stats"][k] - f32["stats"][k]).abs().max())
               for k in stats)
    pgap = max(float((v - b16["stats"][k]).abs().max())
               for k, v in stats.items())
    assert pgap <= 2 * jgap, (pgap, jgap)

