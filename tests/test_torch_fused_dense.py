"""The port's fused BN->ReLU->1x1-conv op (ops/fused_dense.py) and the
DenseNet's fused train mode against the JAX package, on the CPU.

On CPU tensors the port's wrappers take their plain torch versions; the JAX
op runs its Pallas kernels in interpret mode, as tests/test_fused_dense.py
runs them. Inputs come from numpy seeds. Tolerances are those of
tests/test_fused_dense.py: forward rtol/atol 1e-5, gradients rtol 1e-4 /
atol 1e-5 (f32 sums in different orders). The DenseNet comparisons use the
1e-4 of tests/test_torch_models.py.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from multimodal_survival_prediction_tpu.models.densenet3d import (
    DenseNet121_3D as JDenseNet,
)
from multimodal_survival_prediction_tpu.ops import fused_dense as jfd
from multimodal_survival_prediction_tpu_torch.io import jax_import
from multimodal_survival_prediction_tpu_torch.models import DenseNet121_3D
from multimodal_survival_prediction_tpu_torch.ops import fused_dense as fd

# (N, C, F): the JAX test's shape, a ragged N with C and F that are not
# multiples of 32, and a tiny batch (one row would make BN cancel to
# rounding noise: var = 0, rstd = 1/sqrt(eps))
SHAPES = [(96, 24, 16), (97, 40, 24), (3, 5, 3)]


def _data(n, c, f, seed=0):
    rng = np.random.default_rng(seed)
    x = (rng.normal(size=(n, c)) * 2.0 + 0.5).astype(np.float32)
    scale = (rng.normal(size=(c,)) * 0.3 + 1.0).astype(np.float32)
    bias = (rng.normal(size=(c,)) * 0.1).astype(np.float32)
    w = (rng.normal(size=(c, f)) / np.sqrt(c)).astype(np.float32)
    cot = rng.normal(size=(n, f)).astype(np.float32)
    return x, scale, bias, w, cot


def _t(*arrays):
    return [torch.from_numpy(a) for a in arrays]


@pytest.mark.parametrize("n,c,f", SHAPES)
def test_fused_forward_matches_jax(n, c, f):
    x, scale, bias, w, _ = _data(n, c, f)
    out, mean, var = fd.fused_bn_relu_conv1x1(*_t(x, scale, bias, w))
    jout, jmean, jvar = jfd.fused_bn_relu_conv1x1(
        *(jnp.asarray(a) for a in (x, scale, bias, w)))
    np.testing.assert_allclose(out.detach().numpy(), jout, rtol=1e-5,
                               atol=1e-5)
    np.testing.assert_allclose(mean.numpy(), jmean, rtol=1e-5, atol=1e-5)
    np.testing.assert_allclose(var.numpy(), jvar, rtol=1e-5, atol=1e-5)
    assert not mean.requires_grad and not var.requires_grad


@pytest.mark.parametrize("n,c,f", SHAPES)
def test_fused_grads_match_jax(n, c, f):
    """dx, dγ, dβ, dW through torch.autograd against jax.grad of the JAX
    custom VJP (the Pallas backward kernels)."""
    x, scale, bias, w, cot = _data(n, c, f, seed=1)
    args = [a.requires_grad_(True) for a in _t(x, scale, bias, w)]
    out, _, _ = fd.fused_bn_relu_conv1x1(*args)
    got = torch.autograd.grad(out, args, torch.from_numpy(cot))

    def loss(*a):
        return (jfd.fused_bn_relu_conv1x1(*a)[0] * cot).sum()

    want = jax.grad(loss, argnums=(0, 1, 2, 3))(
        *(jnp.asarray(a) for a in (x, scale, bias, w)))
    for name, a, b in zip(("dx", "dgamma", "dbeta", "dW"), got, want):
        np.testing.assert_allclose(a.numpy(), np.asarray(b), rtol=1e-4,
                                   atol=1e-5, err_msg=name)


@pytest.mark.parametrize("n,c,f", SHAPES)
def test_plain_versions_match_jax_kernels(n, c, f):
    """Each kernel's plain version against the JAX kernel it replaces, on
    the same inputs (the JAX wrappers take (1, C) vectors)."""
    x, scale, bias, w, cot = _data(n, c, f, seed=2)
    tx, tw, tg = _t(x, w, cot)
    jx, jw, jg = jnp.asarray(x), jnp.asarray(w), jnp.asarray(cot)
    s, sq = fd.moments_plain(tx)
    js, jsq = jfd._moments(jx)
    np.testing.assert_allclose(s.numpy(), js[0], rtol=1e-5, atol=1e-5)
    np.testing.assert_allclose(sq.numpy(), jsq[0], rtol=1e-5, atol=1e-5)

    mean, var, rstd, mul, add = fd._stats(tx, *_t(scale, bias), 1e-5)
    vec = [jnp.asarray(v.numpy())[None, :] for v in (mul, add, mean, rstd)]
    np.testing.assert_allclose(
        fd.apply_plain(tx, mul, add, tw).numpy(),
        jfd._apply(jx, vec[0], vec[1], jw), rtol=1e-5, atol=1e-5)
    got = fd.bwd_reduce_plain(tx, tg, tw, mul, add, mean, rstd)
    want = jfd._bwd_reduce(jx, jg, jw, *vec)
    for name, a, b in zip(("dW", "dgamma", "dbeta"), got, want):
        np.testing.assert_allclose(a.numpy(), np.asarray(b).reshape(a.shape),
                                   rtol=1e-4, atol=1e-5, err_msg=name)
    c1, c2 = got[2] / n, got[1] / n
    np.testing.assert_allclose(
        fd.bwd_dx_plain(tx, tg, tw, mul, add, mean, rstd, c1, c2).numpy(),
        jfd._bwd_dx(jx, jg, jw, *vec, jnp.asarray(c1.numpy())[None, :],
                    jnp.asarray(c2.numpy())[None, :]),
        rtol=1e-4, atol=1e-5)


# (n, c, f) and bwd_dx's F chunks on a 132-SM card (an H100 SXM): every row
# count of the train step that splits, the widest transition, and a short
# last chunk
DX_SPLITS = [((32, 992, 128), 8), ((256, 512, 128), 4), ((256, 992, 128), 2),
             ((256, 1024, 512), 2), ((2048, 128, 128), 2),
             ((33, 1000, 130), 5), ((97, 40, 24), 2)]


@pytest.mark.parametrize("shape,chunks", DX_SPLITS)
def test_dx_split_over_f_is_exact(shape, chunks):
    """The sum the cluster kernel of bwd_dx computes, in plain torch: dx =
    mul·([z>0]·Σₖ Pₖ − c1 − x̂·c2) with Pₖ the 3xTF32 product of F chunk k
    at the plan's chunking, summed in ascending k, and the mask and the BN
    backward applied once after. Equal to the unsplit plain version and to
    the JAX kernel within rtol 1e-4 + 1e-5·max|dx|. (The kernel itself is
    held against the plain version on the card, tests/test_torch_cuda.py.)"""
    n, c, f = shape
    plan = fd.launch_plan(n, c, f, 132)
    assert plan.dx_chunks == chunks
    x, scale, bias, w, cot = _data(n, c, f, seed=4)
    tx, tw, tg = _t(x, w, cot)
    mean, var, rstd, mul, add = fd._stats(tx, *_t(scale, bias), 1e-5)
    _, dgamma, dbeta = fd.bwd_reduce_plain(tx, tg, tw, mul, add, mean, rstd)
    c1, c2 = dbeta / n, dgamma / n
    da = None
    for lo in range(0, f, plan.dx_k_per_chunk):
        hi = min(f, lo + plan.dx_k_per_chunk)
        part = fd.matmul_3xtf32_plain(tg[:, lo:hi].contiguous(),
                                      tw[:, lo:hi].T.contiguous())
        da = part if da is None else da + part
    dz = torch.where(tx * mul + add > 0, da, 0.0)
    dx = mul * (dz - c1 - (tx - mean) * rstd * c2)
    plain = fd.bwd_dx_plain(tx, tg, tw, mul, add, mean, rstd, c1, c2)
    vec = [jnp.asarray(v.numpy())[None, :]
           for v in (mul, add, mean, rstd, c1, c2)]
    want = torch.from_numpy(np.array(jfd._bwd_dx(
        jnp.asarray(x), jnp.asarray(cot), jnp.asarray(w), *vec)))
    for ref in (plain, want):
        torch.testing.assert_close(dx, ref, rtol=1e-4,
                                   atol=1e-5 * float(ref.abs().max()))


def test_reference_matches_jax_reference():
    x, scale, bias, w, _ = _data(64, 20, 12, seed=3)
    got = fd.bn_relu_conv1x1_reference(*_t(x, scale, bias, w))
    want = jfd.bn_relu_conv1x1_reference(
        *(jnp.asarray(a) for a in (x, scale, bias, w)))
    for a, b in zip(got, want):
        np.testing.assert_allclose(a.numpy(), np.asarray(b), rtol=1e-5,
                                   atol=1e-5)


def test_wrappers_on_cpu_take_the_plain_path_and_check_inputs():
    """CPU tensors run the plain versions (no launch is counted); a device
    other than CPU or CUDA raises; the op refuses mixed compute dtypes."""
    x, scale, bias, w, _ = _data(8, 4, 3)
    fd.reset_launches()
    fd.fused_bn_relu_conv1x1(*_t(x, scale, bias, w))
    assert [k.launches for k in fd.KERNELS] == [0, 0, 0, 0]
    with pytest.raises(ValueError, match="unsupported device"):
        fd.moments(torch.zeros(4, 3, device="meta"))
    with pytest.raises(TypeError, match="same compute dtype"):
        fd.fused_bn_relu_conv1x1(*_t(x, scale, bias), torch.from_numpy(w).double())


# ---------------------------------------------------------------------------
# DenseNet train mode with fused_bn1
# ---------------------------------------------------------------------------

def _densenet_state_dict(params, batch_stats):
    out = {}
    jax_import._exp_densenet121(out, "m", params, batch_stats)
    return {k[2:]: torch.from_numpy(np.array(v)) for k, v in out.items()}


def _running_stats(sd):
    return {k: v for k, v in sd.items()
            if k.endswith(("running_mean", "running_var"))}


def test_densenet_fused_train_matches_jax():
    """Port DenseNet(fused_bn1=True) in train mode against the JAX one:
    features, updated running stats and every parameter gradient."""
    x = np.random.default_rng(4).normal(
        size=(2, 16, 16, 8, 1)).astype(np.float32)
    jm = JDenseNet(block_config=(2, 2), fused_bn1=True)
    v = jm.init({"params": jax.random.PRNGKey(5)}, x)
    v = jax.tree_util.tree_map(np.asarray, dict(v))

    def loss(p):
        out, upd = jm.apply({"params": p, "batch_stats": v["batch_stats"]},
                            x, train=True, mutable=["batch_stats"])
        return (out ** 2).sum(), (out, upd["batch_stats"])

    (_, (jout, jstats)), jgrads = jax.value_and_grad(loss, has_aux=True)(
        v["params"])

    port = DenseNet121_3D(block_config=(2, 2), fused_bn1=True)
    port.load_state_dict(_densenet_state_dict(v["params"], v["batch_stats"]),
                         strict=True)
    port.train()
    fd.reset_launches()
    out = port(torch.from_numpy(x))
    names = [n for n, _ in port.named_parameters()]
    grads = torch.autograd.grad((out ** 2).sum(), list(port.parameters()))

    np.testing.assert_allclose(out.detach().numpy(), np.asarray(jout),
                               atol=1e-4)
    want_stats = _running_stats(_densenet_state_dict(v["params"], jstats))
    got_stats = _running_stats(port.state_dict())
    assert set(got_stats) == set(want_stats)
    for k in want_stats:
        np.testing.assert_allclose(got_stats[k].numpy(),
                                   want_stats[k].numpy(), atol=1e-4,
                                   err_msg=k)
    want_grads = _densenet_state_dict(jax.tree_util.tree_map(np.asarray,
                                                             jgrads),
                                      v["batch_stats"])
    # atol relative to each tensor's largest |gradient|: XLA's and torch's
    # conv backward sum in other orders, which leaves up to about 1e-5 of
    # the largest value (conv0, whose gradient crosses every layer)
    for name, g in zip(names, grads):
        want = want_grads[name].numpy()
        scale = max(1.0, float(np.abs(want).max()))
        np.testing.assert_allclose(g.numpy(), want, rtol=1e-4,
                                   atol=5e-5 * scale, err_msg=name)
    # the plain path on the CPU counts no kernel launch
    assert [k.launches for k in fd.KERNELS] == [0, 0, 0, 0]


@pytest.mark.parametrize("fused", [True, 8], ids=["all", "rows<=8"])
def test_densenet_fused_matches_unfused(fused):
    """The port's fused and unfused train modes are the same function
    (outputs, running stats, num_batches_tracked, gradients), for fusing
    everywhere and for the int rows threshold (block 1 only here), as
    tests/test_fused_dense.py:71-135 pins it for JAX. The weights and the
    state_dict keys are the same either way."""
    x = torch.from_numpy(np.random.default_rng(6).normal(
        size=(2, 16, 16, 8, 1)).astype(np.float32))
    runs = []
    for mode in (False, fused):
        m = DenseNet121_3D(out_features=8, block_config=(2, 3),
                           init_features=8, growth_rate=4, dropout=0.0,
                           fused_bn1=mode,
                           generator=torch.Generator().manual_seed(0))
        sd0 = {k: v.clone() for k, v in m.state_dict().items()}
        m.train()
        out = m(x)
        grads = torch.autograd.grad((out ** 2).sum(), list(m.parameters()))
        runs.append((sd0, out.detach(), m.state_dict(), grads))
    (sd_a, out_a, st_a, g_a), (sd_b, out_b, st_b, g_b) = runs
    assert list(sd_a) == list(sd_b)
    for k in sd_a:
        torch.testing.assert_close(sd_a[k], sd_b[k], rtol=0, atol=0)
    torch.testing.assert_close(out_a, out_b, rtol=1e-5, atol=1e-6)
    for k in st_a:
        torch.testing.assert_close(st_a[k], st_b[k], rtol=1e-5, atol=1e-6)
    for a, b in zip(g_a, g_b):
        torch.testing.assert_close(a, b, rtol=1e-4, atol=1e-5)


def test_fused_stage_views_the_trunk_without_copy(monkeypatch):
    """In fused train mode every fused stage gets a channels_last_3d trunk
    whose (rows, C) view shares its storage."""
    from multimodal_survival_prediction_tpu_torch.models import densenet3d

    seen = []
    real = fd.fused_bn_relu_conv1x1

    def spy(x2, scale, bias, w2, eps):
        seen.append((x2.is_contiguous(), tuple(x2.shape), w2.stride()))
        return real(x2, scale, bias, w2, eps)

    monkeypatch.setattr(densenet3d, "fused_bn_relu_conv1x1", spy)
    m = DenseNet121_3D(block_config=(2, 2), fused_bn1=True).train()
    m(torch.zeros(2, 16, 16, 8, 1))
    assert len(seen) == 2 + 2 + 1  # dense layers + one transition
    assert all(contig for contig, _, _ in seen)
    assert seen[0][1] == (2 * 4 * 4 * 2, 64) and seen[0][2] == (1, 64)
    with pytest.raises(RuntimeError, match="channels_last_3d"):
        densenet3d._fused_stage(m.features["transition1"].norm,
                                m.features["transition1"].conv,
                                torch.zeros(2, 128, 4, 4, 2))

