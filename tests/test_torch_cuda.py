"""The port's CUDA kernels against their plain torch versions, on the card.

Every test here is marked ``cuda`` and skips on a machine without an NVIDIA
GPU (a CUDA kernel has no CPU mode). This file imports neither JAX nor the
JAX package, so it also runs where only the port is installed:

    python -m pytest --noconftest -p no:cacheprovider tests/test_torch_cuda.py

(``--noconftest`` skips tests/conftest.py, which sets up JAX.)
Tolerances: min/max exact; the W-pass rows to 2e-7 of the largest |voxel|
(f32 rounding of a two-term sum); the normalized volume to 2e-6. The fused
BN->ReLU->1x1-conv kernels: fp32 products summed in another order than
cuBLAS, so outputs to rtol 1e-5 and gradients to rtol 1e-4, each with an
atol of 1e-5 times the largest |value| of the tensor (the CPU tests'
tolerances, scaled to the size of the sums). Their bf16 variants: the
same for float32 results (moments, dW, dgamma, dbeta), one bf16 ulp
(2^-7 of the value) + that atol for bf16 ones (out, dx); bwd_reduce's also
against float64 over the same bf16 operands, its relative error at most
twice the float32 plain version's + 1e-6. The bf16 wgmma core alone: each
output within K·2^-23 of the sum of its |products| (fp32 sums of exact
bf16 products). The families' bf16 forward on the card: within twice the
CPU's own bf16-vs-f32 gap + one bf16 ulp of the CPU's bf16 value.
"""

import numpy as np
import pytest
import torch

from multimodal_survival_prediction_tpu_torch.ops import fused_dense as fd
from multimodal_survival_prediction_tpu_torch.ops import resample as tr


@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU (the CUDA kernel has no CPU mode)")
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    return torch.device("cuda")


def _volume(shape, dtype, seed=1):
    rng = np.random.default_rng(seed)
    if dtype == np.float32:
        return rng.normal(100, 50, size=shape).astype(np.float32)
    info = np.iinfo(dtype)
    return rng.integers(max(info.min, -1024), min(info.max, 3072),
                        size=shape, endpoint=True).astype(dtype)


@pytest.mark.cuda
@pytest.mark.parametrize("shape,dtype,hu", [
    ((24, 32, 16), np.int16, None),
    ((7, 13, 40), np.int16, (-150, 250)),
    ((9, 50, 60), np.float32, None),
    ((9, 50, 60), np.uint8, None),
    ((9, 50, 60), np.int8, (-20, 20)),
    ((9, 50, 60), np.int32, None),
    ((3, 5, 2000), np.int16, None),  # > 48 KB of shared memory per block
])
def test_kernel_matches_plain_on_card(cuda_device, shape, dtype, hu):
    vol = _volume(shape, dtype)
    d, h, w = shape
    rows = torch.from_numpy(vol.reshape(d * h, w)).to(cuda_device)
    before = tr.wpass.launches
    out, mn, mx = tr.wpass(rows, 32, hu)
    torch.cuda.synchronize()
    assert tr.wpass.launches == before + 1
    ref, rmn, rmx = tr.wpass_plain(rows, 32, hu)
    assert mn.item() == rmn.item() and mx.item() == rmx.item()
    scale = max(1.0, float(rows.float().abs().max()))
    torch.testing.assert_close(out, ref, rtol=0, atol=2e-7 * scale)
    full = tr.resample_normalize_cuda(vol, (8, 8, 8), hu_window=hu,
                                      device=cuda_device)
    plain = tr.resample_normalize(vol, (8, 8, 8), hu_window=hu,
                                  device=cuda_device)
    torch.testing.assert_close(full, plain, rtol=0, atol=2e-6)


@pytest.mark.cuda
def test_kernel_converts_other_dtypes_on_card(cuda_device):
    """float64 / int64 reach the kernel as float32, converted on the card."""
    vol = _volume((6, 10, 12), np.int16).astype(np.float64)
    want = tr.resample_normalize(vol, (4, 4, 4), device=cuda_device)
    for v in (vol, vol.astype(np.int64)):
        got = tr.resample_normalize_cuda(v, (4, 4, 4), device=cuda_device)
        torch.testing.assert_close(got, want, rtol=0, atol=2e-6)


@pytest.mark.cuda
def test_kernel_in_the_pipeline_on_card(cuda_device, tmp_path):
    """The ingest pipeline launches the kernel once per volume when asked
    for the fused path, never otherwise."""
    from multimodal_survival_prediction_tpu_torch.data.nifti import write_nifti
    from multimodal_survival_prediction_tpu_torch.data.pipeline import (
        VolumePrefetcher,
    )

    jobs = []
    for i in range(3):
        p = tmp_path / f"v{i}.nii"
        write_nifti(p, _volume((10 + i, 20, 24), np.int16, seed=i))
        jobs.append((i, str(p)))
    pf = VolumePrefetcher(device=cuda_device)
    before = tr.wpass.launches
    fused = dict(pf.run(jobs, (8, 8, 8), use_pallas=True))
    assert tr.wpass.launches == before + 3
    plain = dict(pf.run(jobs, (8, 8, 8), use_pallas=False))
    assert tr.wpass.launches == before + 3
    for i in fused:
        np.testing.assert_allclose(fused[i], plain[i], atol=2e-6)


# ---------------------------------------------------------------------------
# fused BN -> ReLU -> 1x1x1 conv kernels (ops/csrc/fused_dense.cu)
# ---------------------------------------------------------------------------

def _close(got, want, rtol):
    got, want = got.detach().double(), want.detach().double()
    scale = max(1.0, float(want.abs().max()))
    torch.testing.assert_close(got, want, rtol=rtol, atol=1e-5 * scale)


def _fused_inputs(n, c, f, device, seed=0):
    """x, gamma, beta, W, output cotangent from a seed; x is moved 1e-3
    (in normalized units) away from each channel's ReLU kink, so that the
    kernel and the plain version, whose batch statistics differ in the
    last bits, take the same ReLU branch everywhere."""
    rng = np.random.default_rng(seed)
    x = torch.from_numpy(rng.normal(0.5, 2.0, (n, c))).double()
    gamma = torch.from_numpy(rng.normal(1.0, 0.3, c)).double()
    beta = torch.from_numpy(rng.normal(0.0, 0.1, c)).double()
    mean = x.mean(0)
    rstd = torch.rsqrt((x * x).mean(0) - mean * mean + 1e-5)
    z = (x - mean) * rstd * gamma + beta
    step = 2e-3 / (rstd * gamma.abs().clamp_min(0.1))
    sign = torch.where(z >= 0, 1.0, -1.0) * torch.sign(gamma)
    x = torch.where(z.abs() < 1e-3, x + sign * step, x)
    w = rng.normal(0.0, 1.0 / np.sqrt(c), (c, f))
    g = rng.normal(size=(n, f))
    return tuple(torch.as_tensor(a, dtype=torch.float32, device=device)
                 for a in (x, gamma, beta, w, g))


# (n, c, f) and bwd_dx's F chunks on a 132-SM card (an H100 SXM): above 1
# the cluster kernel runs
FUSED_CASES = {
    (1, 5, 3): 1, (97, 40, 24): 2, (256, 96, 128): 8, (300, 200, 72): 5,
    (2048, 160, 128): 1, (2048, 128, 128): 2,
    # split-K plans: channels in 62 chunks, 8 chunks at F = 512, and ragged
    # N, C and F with rows that are not 16-byte aligned (bwd_dx: a short
    # last F chunk); bwd_dx's F in 2 chunks at the widest dense layer
    (32, 992, 128): 8, (256, 1024, 512): 2, (33, 1000, 130): 5,
    (256, 992, 128): 2}


@pytest.mark.cuda
@pytest.mark.parametrize("n,c,f", list(FUSED_CASES))
def test_fused_kernels_match_plain_on_card(cuda_device, n, c, f):
    """Each kernel against its plain version on the same inputs, with
    ragged N, C and F; one launch each."""
    x, gamma, beta, w, g = _fused_inputs(n, c, f, cuda_device)
    assert fd.launch_plan(n, c, f, 132).dx_chunks == FUSED_CASES[(n, c, f)]
    if torch.cuda.get_device_properties(x.device).multi_processor_count \
            == 132:  # this card's plan is the table's
        assert fd._plan_for(x, f).dx_chunks == FUSED_CASES[(n, c, f)]
    if fd._plan_for(x, f).dx_chunks > 1:
        assert fd.bwd_dx_max_clusters(x, w) >= 1
    before = [k.launches for k in fd.KERNELS]
    s, sq = fd.moments(x)
    ps, psq = fd.moments_plain(x)
    _close(s, ps, 1e-5)
    _close(sq, psq, 1e-5)
    mean, var, rstd, mul, add = fd._stats(x, gamma, beta, 1e-5)
    w_t = w.t().contiguous().t()  # the conv-kernel layout: strides (1, C)
    for wv in (w, w_t):
        _close(fd.apply(x, mul, add, wv), fd.apply_plain(x, mul, add, w), 1e-5)
        got = fd.bwd_reduce(x, g, wv, mul, add, mean, rstd)
        want = fd.bwd_reduce_plain(x, g, w, mul, add, mean, rstd)
        for a, b in zip(got, want):
            _close(a, b, 1e-4)
        c1, c2 = want[2] / n, want[1] / n
        if n == 1:
            # the plain pair's dx = mul·(dz − c1 − xhat·c2) is exactly 0
            # (c1 = dz, xhat = 0), so hold the product that is left when
            # nothing cancels; the kernels' own cancellation is
            # test_fused_op_cancels_at_one_row_on_card's
            c1, c2 = torch.zeros_like(c1), torch.zeros_like(c2)
        _close(fd.bwd_dx(x, g, wv, mul, add, mean, rstd, c1, c2),
               fd.bwd_dx_plain(x, g, w, mul, add, mean, rstd, c1, c2), 1e-4)
    torch.cuda.synchronize()
    assert [k.launches - b for k, b in zip(fd.KERNELS, before)] == \
        [1 + 1, 2, 2, 2]  # moments: once directly, once inside _stats


@pytest.mark.cuda
@pytest.mark.parametrize("c,f", [(5, 3), (224, 128)])
def test_fused_op_cancels_at_one_row_on_card(cuda_device, c, f):
    """At N = 1, xhat = 0 and c1 = Σ dz = dz, so the reference's dx is
    exactly 0. The op's backward takes c1 and c2 from the bwd_reduce kernel
    and dz from the bwd_dx kernel, each at launch_plan's own plan: their two
    products must agree to the bit for dx to cancel. Held to 1e-5 over 20
    draws and both W layouts, through the wrappers and through the
    autograd op."""
    for seed in range(20):
        x, gamma, beta, w, g = _fused_inputs(1, c, f, cuda_device, seed=seed)
        mean, var, rstd, mul, add = fd._stats(x, gamma, beta, 1e-5)
        for wv in (w, w.t().contiguous().t()):
            _, dgamma, dbeta = fd.bwd_reduce(x, g, wv, mul, add, mean, rstd)
            dx = fd.bwd_dx(x, g, wv, mul, add, mean, rstd, dbeta, dgamma)
            assert float(dx.abs().max()) <= 1e-5, (seed, dx)
            args = [t.clone().requires_grad_(True) for t in (x, gamma, beta)]
            out, _, _ = fd.fused_bn_relu_conv1x1(*args, wv)
            dx_op = torch.autograd.grad(out, args[0], g)[0]
            assert float(dx_op.abs().max()) <= 1e-5, (seed, dx_op)


@pytest.mark.cuda
@pytest.mark.parametrize("n,c,f", [
    (16384, 224, 128), (32, 992, 128), (256, 1024, 512), (33, 1000, 130)])
def test_fused_kernels_repeat_bit_equal_on_card(cuda_device, n, c, f):
    """Two calls on the same inputs give the same bits: every cross-block
    sum (split-K chunks, dW row chunks, dbeta/dgamma row tiles, bwd_dx's F
    chunks inside a cluster) is folded in a fixed order, with no atomics."""
    x, gamma, beta, w, g = _fused_inputs(n, c, f, cuda_device, seed=3)
    mean, var, rstd, mul, add = fd._stats(x, gamma, beta, 1e-5)
    w_t = w.t().contiguous().t()

    def calls():
        dw, dgamma, dbeta = fd.bwd_reduce(x, g, w_t, mul, add, mean, rstd)
        return (fd.apply(x, mul, add, w_t), dw, dgamma, dbeta,
                fd.bwd_dx(x, g, w_t, mul, add, mean, rstd, dbeta / n,
                          dgamma / n))

    first = calls()
    # other work in between, so the second call finds other scratch memory
    torch.randn(1 << 20, device=cuda_device).sum().item()
    again = calls()
    for a, b in zip(first, again):
        assert torch.equal(a, b)


@pytest.mark.cuda
@pytest.mark.parametrize("n,c,f", [(97, 40, 24), (2048, 224, 128)])
def test_fused_op_grads_match_reference_on_card(cuda_device, n, c, f):
    """The autograd.Function against torch autograd through
    bn_relu_conv1x1_reference: out, mean, var and dx, dgamma, dbeta, dW."""
    x, gamma, beta, w, g = _fused_inputs(n, c, f, cuda_device, seed=1)
    results = []
    for fn in (fd.fused_bn_relu_conv1x1, fd.bn_relu_conv1x1_reference):
        args = [t.clone().requires_grad_(True) for t in (x, gamma, beta, w)]
        out, mean, var = fn(*args)
        grads = torch.autograd.grad(out, args, g)
        results.append((out.detach(), mean, var, *grads))
    for i, (a, b) in enumerate(zip(*results)):
        _close(a, b, 1e-5 if i < 3 else 1e-4)


@pytest.mark.cuda
def test_fused_densenet_train_step_on_card(cuda_device):
    """A train step of a small DenseNet with fused_bn1=True launches each
    kernel once per fused stage and matches the unfused model (cuDNN 1x1
    conv) in output, running stats and gradients."""
    from multimodal_survival_prediction_tpu_torch.models import DenseNet121_3D

    x = torch.from_numpy(np.random.default_rng(2).normal(
        size=(4, 32, 32, 16, 1)).astype(np.float32)).to(cuda_device)
    runs = []
    for fused in (True, False):
        m = DenseNet121_3D(block_config=(2, 3), fused_bn1=fused,
                           generator=torch.Generator().manual_seed(0))
        m = m.to(cuda_device).train()
        fd.reset_launches()
        out = m(x)
        grads = torch.autograd.grad((out ** 2).sum(), list(m.parameters()))
        torch.cuda.synchronize()
        runs.append((out.detach(), [b.clone() for b in m.buffers()], grads,
                     [k.launches for k in fd.KERNELS]))
    stages = 2 + 3 + 1  # dense layers + one transition
    assert runs[0][3] == [stages] * 4
    assert runs[1][3] == [0] * 4
    _close(runs[0][0], runs[1][0], 1e-4)
    for a, b in zip(runs[0][1], runs[1][1]):
        _close(a, b, 1e-4)
    for a, b in zip(runs[0][2], runs[1][2]):
        _close(a, b, 1e-3)


@pytest.mark.cuda
@pytest.mark.parametrize("name", [
    "rnaseq_only", "image_only", "simple_fusion", "flexible_multimodal",
    "final", "partial_modality", "simmim", "mmsurv"])
def test_family_forward_on_card_matches_cpu(cuda_device, name):
    """Each family at full width (DenseNet121-3D at 64x64x32, 5,005 genes),
    eval mode, TF32 off: the card's outputs equal the CPU's within 1e-4, on
    rows without CT, without RNA, without age and with nothing at all."""
    from multimodal_survival_prediction_tpu_torch.config import ALL_CONFIGS
    from multimodal_survival_prediction_tpu_torch.models.layers import (
        BatchNorm,
    )
    from multimodal_survival_prediction_tpu_torch.train.adapters import (
        make_model_and_adapters,
    )

    gen = torch.Generator().manual_seed(3)
    model, b2i, _ = make_model_and_adapters(ALL_CONFIGS[name], rna_dim=5005,
                                            generator=gen)
    with torch.no_grad():
        for m in model.modules():
            if isinstance(m, BatchNorm):
                m.running_mean.normal_(0.0, 0.1, generator=gen)
                m.running_var.uniform_(0.5, 1.5, generator=gen)
    rng = np.random.default_rng(4)
    mask = np.ones((5, 3), np.float32)
    mask[0, 0] = mask[1, 1] = mask[2, 2] = 0.0
    mask[3] = 0.0
    batch = {
        "image": rng.normal(size=(5, 64, 64, 32, 1)).astype(np.float32)
        * mask[:, 0, None, None, None, None],
        "rnaseq": rng.normal(size=(5, 5005)).astype(np.float32) * mask[:, 1:2],
        "clinical": rng.uniform(0.3, 0.8, (5, 1)).astype(np.float32)
        * mask[:, 2:3],
        "mask": mask}
    outs = []
    for dev in ("cpu", cuda_device):
        m = model.to(dev).eval()
        with torch.inference_mode():
            out = m(*b2i({k: torch.from_numpy(v).to(dev)
                          for k, v in batch.items()}))
        outs.append([o.cpu() for o in
                     (out if isinstance(out, tuple) else (out,))])
    for cpu, card in zip(*outs):
        assert torch.all(torch.isfinite(card))
        torch.testing.assert_close(card, cpu, rtol=0, atol=1e-4)


# ---------------------------------------------------------------------------
# bf16: the four kernels in bfloat16, and the families' bf16 forward
# ---------------------------------------------------------------------------

BF16_ULP = 2.0 ** -7  # one bf16 ulp of v is at most 2^-7 |v|


def _close_bf16(got, want):
    """bf16 results: one bf16 ulp of the plain value + 1e-5 x its largest
    |value| (both round one float32 sum once, whose last bits differ with
    the order of the sums)."""
    assert got.dtype == want.dtype == torch.bfloat16
    got, want = got.double(), want.double()
    lim = (BF16_ULP * want.abs()
           + 1e-5 * max(1.0, float(want.abs().max())))
    assert bool(((got - want).abs() <= lim).all()), \
        float((got - want).abs().max())


@pytest.mark.cuda
@pytest.mark.parametrize("a_mn", [False, True], ids=["a_k", "a_mn"])
@pytest.mark.parametrize("b_mn", [False, True], ids=["b_k", "b_mn"])
@pytest.mark.parametrize("k", [8, 64, 200, 256])
def test_wgmma_bf16_core_matches_float64_on_card(cuda_device, a_mn, b_mn, k):
    """The bf16 wgmma core of bwd_reduce and bwd_dx alone, on one 64x64 tile:
    A and B each K-major or MN-major (read through wgmma's transpose bits
    or, for an MN-major A, ldmatrix.trans as dW's prologue does; every
    major combination the kernels use), K in one step, several (the ring
    wraps) and ragged (zero-filled), against the float64 product of the
    same bf16 operands."""
    gen = torch.Generator(device=cuda_device).manual_seed(k)
    a = torch.randn((64, k), generator=gen, device=cuda_device).bfloat16()
    b = torch.randn((64, k), generator=gen, device=cuda_device).bfloat16()
    got = fd.wgmma_bf16_tile(a, b, a_mn, b_mn)
    torch.cuda.synchronize()
    exact = a.double() @ b.double().T
    bound = k * 2.0 ** -23 * (a.double().abs() @ b.double().abs().T)
    assert got.dtype == torch.float32 and got.shape == (64, 64)
    assert bool(((got.double() - exact).abs() <= bound).all()), \
        float((got.double() - exact).abs().max())


@pytest.mark.cuda
@pytest.mark.parametrize("a_mn", [False, True], ids=["a_k", "a_mn"])
@pytest.mark.parametrize("b_mn", [False, True], ids=["b_k", "b_mn"])
@pytest.mark.parametrize("k", [8, 64, 200])
def test_wgmma_bf16_register_a_matches_float64_on_card(cuda_device, a_mn,
                                                       b_mn, k):
    """The core with A read into registers, the fragment loads of apply's
    prologue (K-major x: ldmatrix.x4 inside the 128-byte swizzle) and of
    dW's (MN-major: ldmatrix.x4.trans), then wgmma with A from registers,
    against float64 as test_wgmma_bf16_core_matches_float64_on_card."""
    gen = torch.Generator(device=cuda_device).manual_seed(100 + k)
    a = torch.randn((64, k), generator=gen, device=cuda_device).bfloat16()
    b = torch.randn((64, k), generator=gen, device=cuda_device).bfloat16()
    got = fd.wgmma_bf16_tile(a, b, a_mn, b_mn, a_regs=True)
    torch.cuda.synchronize()
    exact = a.double() @ b.double().T
    bound = k * 2.0 ** -23 * (a.double().abs() @ b.double().abs().T)
    assert bool(((got.double() - exact).abs() <= bound).all()), \
        float((got.double() - exact).abs().max())


def _f64_reduce(x, g, w, mul, add, mean, rstd):
    """bwd_reduce in float64 over the kernels' bf16 operands: z = x·mul +
    add in float32 (the kernels' mask), a = relu(z) rounded to bf16, the
    products and sums in float64."""
    z = x.float() * mul + add
    a = torch.relu(z).to(x.dtype).double()
    dz = torch.where(z > 0, g.double() @ w.double().T, 0.0)
    xhat = (x.double() - mean.double()) * rstd.double()
    return a.T @ g.double(), (dz * xhat).sum(0), dz.sum(0)


@pytest.mark.cuda
@pytest.mark.parametrize("n,c,f", [(16384, 224, 128), (16384, 64, 128),
                                   (2048, 480, 128), (256, 1024, 512),
                                   (5003, 200, 72), (32, 992, 128)])
def test_fused_bf16_reduce_holds_float64_yardstick_on_card(cuda_device, n, c,
                                                           f):
    """bwd_reduce's bf16 kernel (dW in row chunks, clustered or not, dgamma,
    dbeta) no further from float64 over the same bf16 operands than twice
    the float32 plain version + 1e-6, each as ||d|| / ||float64||."""
    x, gamma, beta, w, g = _fused_inputs(n, c, f, cuda_device, seed=5)
    x, w, g = (t.to(torch.bfloat16) for t in (x, w, g))
    mean, var, rstd, mul, add = fd._stats(x, gamma, beta, 1e-5)
    got = fd.bwd_reduce(x, g, w, mul, add, mean, rstd)
    plain = fd.bwd_reduce_plain(x, g, w, mul, add, mean, rstd)
    for name, a, b, e in zip(("dW", "dgamma", "dbeta"), got, plain,
                             _f64_reduce(x, g, w, mul, add, mean, rstd)):
        norm = float(e.norm())
        kernel = float((a.double() - e).norm()) / norm
        ref = float((b.double() - e).norm()) / norm
        assert kernel <= 2 * ref + 1e-6, (name, kernel, ref)


@pytest.mark.cuda
@pytest.mark.parametrize("n,c,f", [
    (16384, 224, 128), (2048, 480, 128), (32, 992, 128), (256, 1024, 512)])
def test_fused_bf16_kernels_repeat_bit_equal_on_card(cuda_device, n, c, f):
    """The four bf16 kernels give the same bits twice: moments in clusters
    whose partials the last to finish folds (16,384 rows), in one cluster
    (2,048) and in one block a slab (32, 256); apply unsplit in 64x128
    tiles (16,384 rows) and with its channel chunks folded in a cluster
    (2,048, 256, 32); dW's row chunks unclustered (16,384 rows) and folded
    in a cluster (2,048 rows), bwd_dx unsplit (16,384, 2,048 rows) and
    split over F in a cluster (32, 256 rows); every sum in a fixed
    order."""
    x, gamma, beta, w, g = _fused_inputs(n, c, f, cuda_device, seed=3)
    x, w, g = (t.to(torch.bfloat16) for t in (x, w, g))
    mean, var, rstd, mul, add = fd._stats(x, gamma, beta, 1e-5)
    w_t = w.t().contiguous().t()

    def calls():
        dw, dgamma, dbeta = fd.bwd_reduce(x, g, w_t, mul, add, mean, rstd)
        return (*fd.moments(x), fd.apply(x, mul, add, w_t),
                fd.apply(x, mul, add, w), dw, dgamma, dbeta,
                fd.bwd_dx(x, g, w_t, mul, add, mean, rstd, dbeta / n,
                          dgamma / n))

    first = calls()
    torch.randn(1 << 20, device=cuda_device).sum().item()
    again = calls()
    for a, b in zip(first, again):
        assert torch.equal(a, b)


@pytest.mark.cuda
@pytest.mark.parametrize("n,c,f", [(97, 40, 24), (300, 200, 72),
                                   (2048, 160, 128), (32, 992, 128),
                                   (256, 1024, 512), (33, 1000, 130),
                                   (2048, 128, 128), (5003, 200, 72),
                                   (61, 37, 24)])
def test_fused_bf16_kernels_match_plain_on_card(cuda_device, n, c, f):
    """Each bf16 kernel against its plain version on the same bf16 inputs,
    both W layouts; out and dx come back in bf16, the rest in float32;
    the launches are counted as bf16 ones, none as float32. Where apply
    folds channel chunks or bwd_dx splits F in a cluster, its clusters fit
    on the card. C = 37 takes every copy's element-by-element path."""
    x, gamma, beta, w, g = _fused_inputs(n, c, f, cuda_device)
    x, w, g = (t.to(torch.bfloat16) for t in (x, w, g))
    if fd._plan_for(x, f).dx_chunks > 1:
        assert fd.bwd_dx_max_clusters(x, w) >= 1
    if fd._plan_for(x, f).apply_cluster > 1:
        assert fd.apply_max_clusters(x, w) >= 1
    before = [k.launches for k in fd.KERNELS]
    before16 = [k.launches_bf16 for k in fd.KERNELS]
    s, sq = fd.moments(x)
    ps, psq = fd.moments_plain(x)
    _close(s, ps, 1e-5)
    _close(sq, psq, 1e-5)
    mean, var, rstd, mul, add = fd._stats(x, gamma, beta, 1e-5)
    w_t = w.t().contiguous().t()  # the conv-kernel layout: strides (1, C)
    for wv in (w, w_t):
        _close_bf16(fd.apply(x, mul, add, wv), fd.apply_plain(x, mul, add, w))
        got = fd.bwd_reduce(x, g, wv, mul, add, mean, rstd)
        want = fd.bwd_reduce_plain(x, g, w, mul, add, mean, rstd)
        for a, b in zip(got, want):
            assert a.dtype == torch.float32
            _close(a, b, 1e-4)
        c1, c2 = want[2] / n, want[1] / n
        _close_bf16(fd.bwd_dx(x, g, wv, mul, add, mean, rstd, c1, c2),
                    fd.bwd_dx_plain(x, g, w, mul, add, mean, rstd, c1, c2))
    torch.cuda.synchronize()
    assert [k.launches_bf16 - b for k, b in zip(fd.KERNELS, before16)] == \
        [1 + 1, 2, 2, 2]  # moments: once directly, once inside _stats
    assert [k.launches for k in fd.KERNELS] == before


@pytest.mark.cuda
@pytest.mark.parametrize("name", [
    "rnaseq_only", "image_only", "simple_fusion", "flexible_multimodal",
    "final", "partial_modality", "simmim", "mmsurv"])
def test_family_bf16_forward_on_card_matches_cpu(cuda_device, name):
    """Each family at full width in bf16, eval mode: the card's outputs
    against the CPU's bf16 ones, within twice the CPU's own bf16-vs-f32
    gap on the same weights and rows + one bf16 ulp of a bf16 output (the
    two devices sum in other orders and round to bf16 on either side of a
    boundary)."""
    from multimodal_survival_prediction_tpu_torch.config import ALL_CONFIGS
    from multimodal_survival_prediction_tpu_torch.models.layers import (
        BatchNorm,
    )
    from multimodal_survival_prediction_tpu_torch.train.adapters import (
        make_model_and_adapters,
    )

    models = {}
    for dtype in (None, torch.bfloat16):
        gen = torch.Generator().manual_seed(3)
        model, b2i, _ = make_model_and_adapters(
            ALL_CONFIGS[name], rna_dim=5005, generator=gen, dtype=dtype)
        with torch.no_grad():
            for m in model.modules():
                if isinstance(m, BatchNorm):
                    m.running_mean.normal_(0.0, 0.1, generator=gen)
                    m.running_var.uniform_(0.5, 1.5, generator=gen)
        models[dtype] = model.eval()
    rng = np.random.default_rng(4)
    mask = np.ones((5, 3), np.float32)
    mask[0, 0] = mask[1, 1] = mask[2, 2] = 0.0
    mask[3] = 0.0
    batch = {
        "image": rng.normal(size=(5, 64, 64, 32, 1)).astype(np.float32)
        * mask[:, 0, None, None, None, None],
        "rnaseq": rng.normal(size=(5, 5005)).astype(np.float32) * mask[:, 1:2],
        "clinical": rng.uniform(0.3, 0.8, (5, 1)).astype(np.float32)
        * mask[:, 2:3],
        "mask": mask}
    outs = {}
    for key, dtype, dev in (("f32", None, "cpu"), ("cpu", torch.bfloat16,
                                                   "cpu"),
                            ("card", torch.bfloat16, cuda_device)):
        m = models[dtype].to(dev)
        with torch.inference_mode():
            out = m(*b2i({k: torch.from_numpy(v).to(dev)
                          for k, v in batch.items()}))
        outs[key] = [o.cpu() for o in
                     (out if isinstance(out, tuple) else (out,))]
    for f32, cpu, card in zip(outs["f32"], outs["cpu"], outs["card"]):
        assert card.dtype == cpu.dtype and torch.all(torch.isfinite(card))
        gap = float((cpu.float() - f32).abs().max())
        ulp = (BF16_ULP * cpu.float().abs() if cpu.dtype == torch.bfloat16
               else 0.0)
        excess = float(((card.float() - cpu.float()).abs() - ulp).max())
        assert excess <= 2 * gap, (excess, gap)
