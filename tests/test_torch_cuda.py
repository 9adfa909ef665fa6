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
CPU's own bf16-vs-f32 gap + one bf16 ulp of the CPU's bf16 value. The host
C++ engine against the W-pass kernel: 2e-5 (JAX's host-vs-device limit).
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


@pytest.mark.cuda
def test_host_engine_matches_the_kernel_on_card(cuda_device, tmp_path):
    """The host C++ engine (resample='host') against the W-pass kernel
    (resample='device', use_pallas) on a 128x512x512 int16 CT and a ragged
    one: within 2e-5 (JAX's host-vs-device limit), no kernel launch on the
    host path, one a volume on the kernel's."""
    from multimodal_survival_prediction_tpu_torch.data import native
    from multimodal_survival_prediction_tpu_torch.data.nifti import write_nifti
    from multimodal_survival_prediction_tpu_torch.data.pipeline import (
        VolumePrefetcher,
    )

    native.build_native()  # a failed build raises with g++'s stderr
    jobs = []
    for i, shape in enumerate(((128, 512, 512), (97, 500, 500))):
        p = tmp_path / f"ct{i}.nii"
        write_nifti(p, _volume(shape, np.int16, seed=10 + i))
        jobs.append((i, str(p)))
    pf = VolumePrefetcher(device=cuda_device)
    before = tr.wpass.launches
    host = dict(pf.run(jobs, (64, 64, 32), resample="host"))
    assert pf.last_mode == "host" and tr.wpass.launches == before
    dev = dict(pf.run(jobs, (64, 64, 32), use_pallas=True,
                      resample="device"))
    assert pf.last_mode == "device"
    assert tr.wpass.launches == before + len(jobs)
    for i in host:
        np.testing.assert_allclose(host[i], dev[i], rtol=0, atol=2e-5)


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


# ---------------------------------------------------------------------------
# fold checkpoints in every format (io/checkpoint.py) scored on the card
# ---------------------------------------------------------------------------

@pytest.mark.cuda
def test_fold_formats_score_alike_on_card(cuda_device, tmp_path):
    """A partial_modality fold (simple_cnn, 16x16x8) written as .pt, as
    .msgpack and exported to .pth: predict_risk on the card, through the
    W-pass kernel that the meta pins (one launch per imaging patient a
    call), gives each format's log-hazards within 1e-6 of the .pt's."""
    from multimodal_survival_prediction_tpu_torch.config import ALL_CONFIGS
    from multimodal_survival_prediction_tpu_torch.data.synthetic import (
        SyntheticCohortSpec,
        generate_synthetic_cohort,
    )
    from multimodal_survival_prediction_tpu_torch.io.checkpoint import (
        load_checkpoint,
        save_checkpoint,
        save_fold_meta,
    )
    from multimodal_survival_prediction_tpu_torch.tools import (
        export_torch_checkpoint,
    )
    from multimodal_survival_prediction_tpu_torch.train.adapters import (
        make_model_and_adapters,
    )
    from multimodal_survival_prediction_tpu_torch.train.predict import (
        predict_risk,
    )

    table, paths = generate_synthetic_cohort(tmp_path / "c", SyntheticCohortSpec(
        n_patients=10, rna_dim=40, seed=3, p_imaging=0.7,
        image_shapes=((24, 40, 40),), image_dtype="int16"))
    cfg = ALL_CONFIGS["partial_modality"]
    model = make_model_and_adapters(
        cfg, rna_dim=40, backbone="simple_cnn",
        generator=torch.Generator().manual_seed(2))[0]
    meta = dict(model=cfg.name, backbone="simple_cnn", image_shape=[16, 16, 8],
                rna_dim=40, use_pallas_resample=True, resample_mode="device")
    pt = tmp_path / "a" / "fold_1_best.pt"
    save_checkpoint(pt, model.state_dict())
    save_fold_meta(pt, **meta)
    mpk = tmp_path / "b" / "fold_1_best.msgpack"
    save_checkpoint(mpk, load_checkpoint(pt), model_name=cfg.name)
    save_fold_meta(mpk, **meta)
    pth = tmp_path / "c2" / "fold_1_best.pth"
    assert export_torch_checkpoint.main(["--checkpoint", str(mpk),
                                         "--out", str(pth)]) == 0
    n_img = sum(bool(r["has_imaging"]) for r in table)
    assert n_img > 0
    risks = []
    for ckpt in (pt, mpk, pth):
        before = tr.wpass.launches
        pred = predict_risk(cfg, ckpt, table, rnaseq_csv=paths["rnaseq_csv"],
                            labeled_only=False, device=cuda_device)
        assert tr.wpass.launches - before == n_img
        risks.append(pred["risk_score"])
    assert np.all(np.isfinite(risks[0]))
    for r in risks[1:]:
        np.testing.assert_allclose(r, risks[0], rtol=0, atol=1e-6)


# ---------------------------------------------------------------------------
# Fold-parallel training and the batch prefetcher on the card
# ---------------------------------------------------------------------------

def _pm_data(n=30, rna_dim=24, seed=5, shape=(16, 16, 8)):
    rng = np.random.default_rng(seed)
    mask = (rng.uniform(size=(n, 3)) < 0.8).astype(np.float32)
    svalid = (rng.uniform(size=n) < 0.85).astype(np.float32)
    return {
        "image": (rng.normal(size=(n, *shape, 1))
                  * mask[:, 0, None, None, None, None]).astype(np.float32),
        "rnaseq": (rng.normal(size=(n, rna_dim)) * mask[:, 1:2]).astype(
            np.float32),
        "clinical": (rng.uniform(0.3, 0.8, (n, 1)) * mask[:, 2:3]).astype(
            np.float32),
        "mask": mask,
        "time": rng.exponential(300.0, n).astype(np.float32),
        "event": ((rng.uniform(size=n) < 0.7) * svalid).astype(np.float32),
        "svalid": svalid,
    }


@pytest.mark.cuda
def test_vmapped_epoch_matches_sequential_on_card(cuda_device):
    """Two folds of partial_modality (simple_cnn, 16x16x8, dropout on) with
    unequal step counts (2 vs 3 at batch 8): one vmapped epoch against two
    sequential epochs on the card. Losses rtol 1e-5 (the first epoch's
    steps differ only by the order of float32 sums: grouped vs plain
    cuDNN convolutions); Adam's count, the step and each fold's generator
    state exact; BatchNorm running means 1e-4 of their largest |value|."""
    import dataclasses

    from multimodal_survival_prediction_tpu_torch.config import (
        PARTIAL_MODALITY,
    )
    from multimodal_survival_prediction_tpu_torch.train import cv_parallel
    from multimodal_survival_prediction_tpu_torch.train.cv import (
        make_trainers,
    )

    cfg = dataclasses.replace(PARTIAL_MODALITY, batch_size=8,
                              image_shape=(16, 16, 8))
    data = {k: torch.from_numpy(v).to(cuda_device)
            for k, v in _pm_data().items()}
    rows = [np.arange(15), np.arange(10, 30)]
    seq = []
    for f, r in zip((1, 2), rows):
        tr = make_trainers(cfg, 24, "simple_cnn", None, cuda_device)[0]
        state = tr.init_state(fold=f)
        tr.train_epoch(state, data, r, np.random.default_rng(100 + f),
                       cfg.learning_rate)
        seq.append((tr.step_losses.cpu(), state))
    tr = make_trainers(cfg, 24, "simple_cnn", None, cuda_device)[0]
    stacked = cv_parallel.StackedState([tr.init_state(fold=1),
                                         tr.init_state(fold=2)])
    idx, bv = cv_parallel._stack_fold_indices(
        rows, 8, [np.random.default_rng(101), np.random.default_rng(102)])
    step_valid = bv.max(axis=2) > 0
    losses = cv_parallel._build_parallel_train_epoch(tr)(
        stacked, cv_parallel.stacked_batches(tr, data, idx, bv), step_valid,
        np.full(2, cfg.learning_rate))[0].cpu()
    assert step_valid.tolist() == [[True, True, False], [True, True, True]]
    for k, (want, state) in enumerate(seq):
        got = losses[: len(want), k]
        torch.testing.assert_close(got, want, rtol=1e-5, atol=0)
        assert float(losses[len(want):, k].abs().sum()) == 0.0
        saved = stacked.fold_train_state(k)
        assert saved["opt_count"] == state.opt_state.count
        assert saved["step"] == state.step
        assert torch.equal(saved["dropout_rng"],
                           state.dropout_generator.get_state())
        for name, v in state.model.state_dict().items():
            if name.endswith("running_mean"):
                scale = float(v.abs().max()) or 1.0
                assert float((saved["model"][name] - v.cpu()).abs().max()) \
                    <= 1e-4 * scale, name


@pytest.mark.cuda
def test_prefetcher_on_pinned_memory_and_a_side_stream(cuda_device):
    """BatchPrefetcher copies each host batch from pinned memory on its own
    stream; the consumer's batches equal the host gather, bit for bit."""
    from multimodal_survival_prediction_tpu_torch.data.pipeline import (
        BatchPrefetcher,
    )

    rng = np.random.default_rng(3)
    host = {"x": rng.normal(size=(64, 4, 8, 8)).astype(np.float32),
            "t": rng.integers(0, 9, 64).astype(np.int64)}
    idx = rng.permutation(64).reshape(8, 8)
    before = BatchPrefetcher.side_stream_copies
    it = BatchPrefetcher(({k: v[i] for k, v in host.items()} for i in idx),
                         depth=2, device=cuda_device)
    assert it.stream is not None
    assert it.stream != torch.cuda.current_stream(cuda_device)
    got = list(it)
    assert BatchPrefetcher.side_stream_copies - before == len(idx)
    for i, batch in zip(idx, got):
        for k, v in host.items():
            assert batch[k].device.type == "cuda"
            assert torch.equal(batch[k].cpu(), torch.from_numpy(v[i]))


@pytest.mark.cuda
@pytest.mark.parametrize("dropout", [0.0, 0.2], ids=["no_dropout",
                                                     "dropout"])
def test_remat_fused_step_matches_plain_on_card(cuda_device, dropout):
    """One train-mode step of DenseNet121-3D (fused_bn1, 2 x 64x64x32)
    recomputing its dense layers (``remat=True``) against the same step
    without: the loss and the running stats bit-equal (the forward is the
    same launches); the whole gradient no further from the plain step's
    (``||d|| / ||g||`` over every parameter) than twice the plain step's
    own repeat (cuDNN's backward does not repeat bit for bit, and a
    gradient that cancels, norm0's, moves by 5-7 % of itself between two
    plain steps on an H100); and the kernels launched as the JAX jaxpr of
    ``jax.grad`` of
    ``DenseNet121_3D(remat=True, fused_bn1=True)`` holds ``pallas_call``s
    (``tests/test_torch_remat.py`` counts them): ``moments`` and ``apply``
    61 + 58 times (every stage, then each dense layer's recompute),
    ``bwd_reduce`` and ``bwd_dx`` 61. The dense layers' dropout keeps the
    trunk in standard layout, so the fused stages run with it off."""
    from multimodal_survival_prediction_tpu_torch.models import (
        DenseNet121_3D,
    )
    from multimodal_survival_prediction_tpu_torch.models.layers import (
        set_dropout_generator,
    )

    x = torch.from_numpy(np.random.default_rng(4).normal(
        size=(2, 64, 64, 32, 1)).astype(np.float32)).to(cuda_device)
    runs = {}
    for remat in (False, True, False):
        model = DenseNet121_3D(
            out_features=8, fused_bn1=dropout == 0.0, dropout=dropout,
            remat=remat,
            generator=torch.Generator().manual_seed(0)).to(cuda_device)
        set_dropout_generator(model, torch.Generator(
            device=cuda_device).manual_seed(5))
        fd.reset_launches()
        loss = (model.train()(x) ** 2).sum()
        grads = torch.autograd.grad(loss, list(model.parameters()))
        torch.cuda.synchronize()
        runs.setdefault(remat, []).append(
            (loss, grads, model.state_dict(),
             [k.launches for k in fd.KERNELS]))
    (loss0, g0, sd0, n0), (_, g2, _, _) = runs[False]
    ((loss1, g1, sd1, n1),) = runs[True]

    def gap(a, b):
        return float(torch.stack([(x - y).norm() for x, y in zip(a, b)])
                     .norm() / torch.stack([y.norm() for y in b]).norm())

    assert torch.equal(loss1, loss0)
    assert gap(g1, g0) <= 2 * gap(g2, g0)
    for k, v in sd0.items():
        assert torch.equal(sd1[k], v), k
    stages = sum(model.block_config) + len(model.block_config) - 1
    layers = sum(model.block_config)
    if dropout == 0.0:
        assert n0 == [stages] * 4
        assert n1 == [stages + layers, stages + layers, stages, stages]
    else:
        assert n0 == n1 == [0] * 4


# ---------------------------------------------------------------------------
# train_epoch's step replayed as a CUDA graph
# ---------------------------------------------------------------------------

def _pm_trainer(device, remat=False, batch_size=8, dtype=None):
    """partial_modality with ``fused_bn1`` (DenseNet blocks (2, 3) on
    16x16x8 CTs, dropout 0.3 in the RNA and fusion MLPs) in compute
    ``dtype``."""
    from multimodal_survival_prediction_tpu_torch.config import (
        PARTIAL_MODALITY,
    )
    from multimodal_survival_prediction_tpu_torch.models import (
        PartialModalityNet,
    )
    from multimodal_survival_prediction_tpu_torch.train import engine
    from multimodal_survival_prediction_tpu_torch.train.adapters import (
        make_adapters,
    )

    b2i, haa = make_adapters(PARTIAL_MODALITY)
    cfg = engine.TrainConfig(batch_size=batch_size, learning_rate=1e-3,
                             weight_decay=1e-4, grad_clip=1.0)
    return engine.Trainer(
        lambda g: PartialModalityNet(rna_dim=24, block_config=(2, 3),
                                     fused_bn1=True, dropout=0.3,
                                     remat=remat, generator=g, dtype=dtype),
        b2i, haa, cfg, device=device)


# the device kernels each fused wrapper launches (ops/csrc/fused_dense.cu),
# by a part of their names, in fd.KERNELS' order; float32 and bf16
FUSED_DEVICE_KERNELS = {
    False: (("::moments_partial_kernel",), ("::apply_kernel<",),
            ("::bwd_reduce_kernel<",),
            ("::bwd_dx_kernel<", "::bwd_dx_cluster_kernel<")),
    True: (("::moments_bf16_kernel",), ("::apply_bf16_kernel<",),
           ("::bwd_reduce_bf16_kernel<",),
           ("::bwd_dx_bf16_kernel<", "::bwd_dx_cluster_bf16_kernel<")),
}


def _counts(bf16=False):
    """The fused wrappers' launch counters of one dtype, in KERNELS'
    order."""
    return [k.launches_bf16 if bf16 else k.launches for k in fd.KERNELS]


def _counted(fn, bf16=False):
    """``fn()``, then ``(what it returned, the wrappers' calls of each
    fused kernel in it, those of the other dtype's)``."""
    before, other = _counts(bf16), _counts(not bf16)
    out = fn()
    return (out, [a - b for a, b in zip(_counts(bf16), before)],
            [a - b for a, b in zip(_counts(not bf16), other)])


def _replayed_epoch_kernels(tr, state, data, rows, want, bf16=False,
                            attempts=3):
    """One more ``train_epoch`` of ``tr`` over ``rows``, every step a replay
    (no wrapper call), under torch.profiler: the fused kernels of each
    wrapper in its trace. The window opens with a spin kernel, as a
    window's first launch can be missing from its trace; a trace that
    holds fewer than ``want`` has lost events (a replay that dropped a
    kernel reads short in every window), and another epoch is traced, up
    to ``attempts``."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    for _ in range(attempts):
        with profile(activities=[ProfilerActivity.CUDA]) as prof:
            torch.cuda._sleep(1 << 16)
            torch.cuda.synchronize()
            _, calls, other = _counted(lambda: tr.train_epoch(
                state, data, rows, np.random.default_rng(1), 1e-3), bf16)
            torch.cuda.synchronize()
        assert calls == other == [0] * 4
        events = [e for e in prof.key_averages()
                  if e.device_type == DeviceType.CUDA]
        traced = [sum(e.count for e in events if any(p in e.key
                                                     for p in parts))
                  for parts in FUSED_DEVICE_KERNELS[bf16]]
        if all(t >= w for t, w in zip(traced, want)):
            break
    return traced


def _change_gap(after, ref, before):
    """``||(after - before) - (ref - before)|| / ||ref - before||`` over
    every parameter: how far a step's change of the parameters lies from
    the reference step's."""
    num = torch.stack([(a - r).norm() for a, r in zip(after, ref)]).norm()
    den = torch.stack([(r - b).norm() for r, b in zip(ref, before)]).norm()
    return float(num / den)


def _stepwise(make, data, steps, bf16=False):
    """``steps`` steps of one train state on the card, each a one-step
    ``train_epoch`` (the first eager, the second captured and replayed,
    then replays; the fourth 5 rows padded to 8), and beside each, from
    copies of the state just before it, ``train_step`` on the same batch
    twice (eager, eager again). Per step: the three losses, the change
    gaps of the replay and of eager again from eager, whether the dropout
    generators and counts agree with eager's, and the wrappers' calls of
    each fused kernel (of ``bf16``'s dtype; those of the other dtype in
    ``other``) in the ``train_epoch`` and in eager. Returns the rows and
    the ``train_epoch`` Trainer and state."""
    from multimodal_survival_prediction_tpu_torch.train import engine

    trainers = [make() for _ in range(3)]
    states = [tr.init_state(fold=1) for tr in trainers]
    n = len(next(iter(data.values())))
    out = []
    for k in range(steps):
        saved = engine.train_state_dict(states[0])
        for st in states[1:]:
            engine.load_train_state_dict(st, saved)
        before = [p.detach().clone() for p in states[0].model.parameters()]
        rows = (np.arange(5 if k == 3 else 8) + 7 * k) % n
        losses, launches, other = [], [], []
        for j, (tr, st) in enumerate(zip(trainers, states)):
            if j == 0:
                def epoch(tr=tr, st=st):
                    tr.train_epoch(st, data, rows, np.random.default_rng(k),
                                   1e-3)
                    return tr.step_losses[0]

                loss, calls, others = _counted(epoch, bf16)
            else:
                perm, bvalid = tr._pad_indices(rows, 8,
                                               np.random.default_rng(k))
                idx, bv = tr._device_indices(perm, bvalid)
                loss, calls, others = _counted(lambda: tr.train_step(
                    st, tr._gather_batch(data, idx[0], bv[0]), 1e-3), bf16)
            losses.append(float(loss))
            launches.append(calls)
            other.append(others)
        params = [[p.detach() for p in st.model.parameters()]
                  for st in states]
        out.append(dict(
            losses=losses,
            gap=_change_gap(params[0], params[1], before),
            gap_again=_change_gap(params[2], params[1], before),
            same=all(torch.equal(states[0].dropout_generator.get_state(),
                                 st.dropout_generator.get_state())
                     and (st.step, st.opt_state.count)
                     == (states[0].step, states[0].opt_state.count)
                     for st in states[1:]),
            launches=launches[:2], other=other))
    assert trainers[0]._captured.graph is not None
    return out, trainers[0], states[0]


def _assert_steps_match(rows):
    """Each step from the same state: the loss within 1e-5 of eager's; the
    parameters' change no further from eager's than twice the largest
    gap of eager again from eager over the run's steps, plus 1e-5 (cuDNN's
    backward does not repeat bit for bit on the card, and a step that
    happened to repeat says nothing of the rounding of the next: an H100
    read replay gaps of 1.0e-5 where eager repeated that step exactly, and
    2.2e-3 in bf16 beside an eager repeat of 9.8e-4 there and 4.2e-3 a step
    earlier); the dropout generator, the step and Adam's count equal; no
    launch of the other dtype's fused kernels. The wrappers are called
    in the warm-up and the capture (``train_epoch``'s steps 1 and 2) as
    often as eagerly, and never in a replay."""
    spread = max(r["gap_again"] for r in rows)
    for k, r in enumerate(rows):
        lg, le, la = r["losses"]
        assert abs(lg - le) <= 1e-5 and abs(la - le) <= 1e-5, (k, r)
        assert r["gap"] <= 2 * spread + 1e-5, (k, r, spread)
        assert r["same"], k
        assert r["other"] == [[0] * 4] * 3, (k, r)
        graph, eager = r["launches"]
        assert graph == (eager if k < 2 else [0] * 4), (k, r)


@pytest.mark.cuda
@pytest.mark.parametrize("remat, dtype", [
    (False, None), (True, None), (False, torch.bfloat16)],
    ids=["plain", "remat", "bf16"])
def test_captured_steps_match_eager_on_card(cuda_device, remat, dtype):
    """partial_modality with ``fused_bn1``, batch 8, in float32, with remat
    and in bf16 compute (the bf16 kernels, and the bf16 ``moments``
    counters of the capture stream): five steps of ``train_epoch`` (the
    warm-up, the capture and its replay, three replays, one of them
    ragged), each against eager ``train_step`` from the same state
    (``_assert_steps_match``). Training amplifies rounding (eager against
    eager again drifts by 3e-3 of the loss within ten steps on an H100),
    so each step is compared from a shared state. Then one more epoch of
    replays under torch.profiler holds each fused kernel as often in the
    device trace as eager calls it."""
    bf16 = dtype is not None
    data = {k: torch.from_numpy(v).to(cuda_device)
            for k, v in _pm_data().items()}
    rows, tr, state = _stepwise(
        lambda: _pm_trainer(cuda_device, remat, dtype=dtype), data, 5, bf16)
    _assert_steps_match(rows)
    stages, layers = 2 + 3 + 1, 2 + 3
    per_step = [stages + layers * remat] * 2 + [stages] * 2
    assert all(r["launches"][1] == per_step for r in rows)
    want = [3 * n for n in per_step]  # 3 steps of 8 over 20 rows
    assert _replayed_epoch_kernels(tr, state, data, np.arange(20), want,
                                   bf16) == want


@pytest.mark.cuda
def test_captured_epochs_on_card(cuda_device):
    """Two epochs of ``train_epoch`` (4 steps of 8 over 30 rows) against a
    loop of ``train_step`` over the same batches from the same state: the
    first replayed step's loss within 1e-5, the step, Adam's count and the
    dropout generator's state equal at the end; the fused wrappers called
    6 times a step eagerly, and in the captured epochs only in the warm-up
    and the capture; a third epoch of replays holds 4 x 6 of each fused
    kernel in its device trace. Each replayed step records ``train.step``
    around ``train.replay``, the capture ``setup.capture`` once. A new
    batch size, a new cohort dict and a new ``init_state`` each capture
    anew."""
    from multimodal_survival_prediction_tpu_torch.train import engine
    from multimodal_survival_prediction_tpu_torch.utils import profiling

    data = {k: torch.from_numpy(v).to(cuda_device)
            for k, v in _pm_data().items()}
    rows = np.arange(30)
    runs = []
    for eager in (True, False):
        tr = _pm_trainer(cuda_device)
        state = tr.init_state(fold=1)
        profiling.reset_spans()
        rng = np.random.default_rng(9)
        counts, losses = _counts(), []
        for _ in range(2):
            if eager:
                perm, bvalid = tr._pad_indices(rows, 8, rng)
                idx, bv = tr._device_indices(perm, bvalid)
                losses += [tr.train_step(state, tr._gather_batch(data, i, v),
                                         1e-3) for i, v in zip(idx, bv)]
            else:
                tr.train_epoch(state, data, rows, rng, 1e-3)
                losses += list(tr.step_losses)
        torch.cuda.synchronize()
        runs.append((torch.stack(losses).cpu(),
                     [a - b for a, b in zip(_counts(), counts)], state))
    (want, n_eager, ref), (got, n_graph, state) = runs
    assert got.shape == want.shape == (8,)
    assert abs(float(got[0] - want[0])) <= 1e-5  # eager in both
    assert abs(float(got[1] - want[1])) <= 1e-5  # the first replay
    assert (state.step, state.opt_state.count) == (ref.step,
                                                   ref.opt_state.count) \
        == (8, 8)
    assert torch.equal(state.dropout_generator.get_state(),
                       ref.dropout_generator.get_state())
    assert n_eager == [8 * 6] * 4 and n_graph == [2 * 6] * 4

    recs = profiling.spans()
    epochs = [r for r in recs if r.name == "train.epoch"]
    assert len(epochs) == 2
    assert sum(r.name == "setup.capture" for r in recs) == 1
    for epoch, replays in zip(epochs, (3, 4)):
        steps = [r for r in recs if r.parent == epoch.index
                 and r.name == "train.step"]
        assert len(steps) == 4
        assert sum(any(c.parent == s.index and c.name == "train.replay"
                       for c in recs) for s in steps) == replays
    assert _replayed_epoch_kernels(tr, state, data, rows,
                                   [4 * 6] * 4) == [4 * 6] * 4

    assert tr._captured.graph is not None
    for change in ("batch", "cohort", "state"):
        if change == "batch":
            tr.cfg = engine.TrainConfig(batch_size=4, learning_rate=1e-3,
                                        weight_decay=1e-4, grad_clip=1.0)
        elif change == "cohort":
            data = {k: v.clone() for k, v in data.items()}
        else:
            state = tr.init_state(fold=2)
        before = tr._captured
        tr.train_epoch(state, data, rows, np.random.default_rng(3), 1e-3)
        assert tr._captured is not before and tr._captured.graph is not None
    torch.cuda.synchronize()


@pytest.mark.cuda
@pytest.mark.parametrize("name", [
    "rnaseq_only", "image_only", "simple_fusion", "flexible_multimodal",
    "final", "partial_modality", "simmim", "simmim_stage1", "mmsurv"])
def test_every_family_captures_on_card(cuda_device, name):
    """Each family's Trainer as the CV driver makes it (SimMLM's stage-1
    Trainer too; the simple CNN at 16x16x8): four steps of
    ``train_epoch``, each against eager ``train_step`` from the same state
    (``_assert_steps_match``)."""
    import dataclasses

    from multimodal_survival_prediction_tpu_torch.config import ALL_CONFIGS
    from multimodal_survival_prediction_tpu_torch.train.cv import (
        make_trainers,
    )

    family = name.removesuffix("_stage1")
    cfg = dataclasses.replace(ALL_CONFIGS[family], batch_size=8,
                              image_shape=(16, 16, 8))
    data = {k: torch.from_numpy(v).to(cuda_device)
            for k, v in _pm_data().items()}

    def make():
        trainers = make_trainers(cfg, 24, "simple_cnn", None, cuda_device)
        return trainers[1] if name.endswith("_stage1") else trainers[0]

    rows, _, _ = _stepwise(make, data, 4)
    _assert_steps_match(rows)


# ---------------------------------------------------------------------------
# The fold-parallel step replayed as a CUDA graph
# ---------------------------------------------------------------------------

def _stacked(make, folds):
    """A Trainer from ``make`` and the stacked state of ``folds``."""
    from multimodal_survival_prediction_tpu_torch.train import cv_parallel

    tr = make()
    return tr, cv_parallel.StackedState([tr.init_state(fold=f)
                                         for f in folds])


def _copy_stacked(dst, src):
    """``src``'s tensors, counts and generators into ``dst``, in place."""
    for a, b in zip(dst._tensors(), src._tensors()):
        a.copy_(b)
    dst.count, dst.step = src.count.copy(), src.step.copy()
    for a, b in zip(dst.generators, src.generators):
        a.set_state(b.get_state())


def _eager_stacked(step, tr, state, batch, lr, valid):
    """One call of the stacked body ``step`` from the host counts, as the
    epoch runs a step it does not capture: the bias corrections of the
    counts each fold reaches, then the valid folds' counts advanced."""
    bc = torch.from_numpy(tr.tx.bias_corrections(
        np.maximum(state.count + valid, 1))).to(state.device, state.mu.dtype)
    loss = step(state, batch, lr, bc, valid)
    state.count = state.count + valid
    state.step = state.step + valid
    return loss


def _fold_snapshot(state, k):
    return ([t[k].clone() for t in state._tensors()],
            state.generators[k].get_state())


@pytest.mark.cuda
@pytest.mark.parametrize("case", ["simple_cnn", "fused", "unequal"])
def test_replayed_stacked_steps_match_eager_on_card(cuda_device, case):
    """The stacked epoch of ``train/cv_parallel.py`` on the card, one step
    an epoch call (the warm-up, the capture and its replay, then replays),
    each step against the body (``_build_parallel_train_step``) run
    eagerly from the same stacked state, twice: partial_modality with
    dropout on, two folds of ``simple_cnn`` at 16x16x8, three of the
    DenseNet with ``fused_bn1`` (what the fold cell runs), and two folds
    of unequal length, whose tail step masks one fold. Held as
    ``_assert_steps_match`` holds the single step: each fold's loss within
    1e-5 of eager's, each fold's change of the parameters no further from
    eager's than twice the largest gap of eager again + 1e-5, and every
    fold's generator state, step and Adam count equal. A masked step runs
    eagerly and leaves the masked fold's parameters, moments, buffers and
    generator as they were. Replays record ``train.replay`` in their
    ``train.step`` and call no fused wrapper."""
    import dataclasses

    from multimodal_survival_prediction_tpu_torch.config import (
        PARTIAL_MODALITY,
    )
    from multimodal_survival_prediction_tpu_torch.train import cv_parallel
    from multimodal_survival_prediction_tpu_torch.train.cv import (
        make_trainers,
    )
    from multimodal_survival_prediction_tpu_torch.utils import profiling

    cfg = dataclasses.replace(PARTIAL_MODALITY, batch_size=8,
                              image_shape=(16, 16, 8))
    if case == "fused":
        folds = (1, 2, 3)

        def make():
            return _pm_trainer(cuda_device)
    else:
        folds = (1, 2)

        def make():
            return make_trainers(cfg, 24, "simple_cnn", None, cuda_device)[0]
    data = {k: torch.from_numpy(v).to(cuda_device)
            for k, v in _pm_data().items()}
    rows = ([np.arange(30), np.arange(6, 30)] if case == "unequal"
            else [((np.arange(30) + 7 * f) % 30)[:29] for f in folds])
    idx, bv = cv_parallel._stack_fold_indices(
        rows, 8, [np.random.default_rng(50 + f) for f in folds])
    step_valid = bv.max(axis=2) > 0
    if case == "unequal":
        assert step_valid.tolist() == [[True] * 4, [True] * 3 + [False]]
    lrs = np.full(len(folds), 1e-3) * np.arange(1, len(folds) + 1)
    runs = [_stacked(make, folds) for _ in range(3)]
    (tr, graph), (_, eager), (_, again) = runs
    epoch = cv_parallel._build_parallel_train_epoch(tr)
    steps = {id(t): cv_parallel._build_parallel_train_step(t)
             for t, _ in runs[1:]}
    batches = list(cv_parallel.stacked_batches(tr, data, idx, bv))
    lr = torch.tensor(lrs[:, None], dtype=torch.float32,
                      device=cuda_device)
    profiling.reset_spans()
    out = []
    for s, batch in enumerate(batches):
        valid = step_valid[:, s]
        for _, st in runs[1:]:
            _copy_stacked(st, graph)
        before = graph.params.clone()
        masked = [_fold_snapshot(graph, k) for k in range(len(folds))
                  if not valid[k]]
        got, calls, _ = _counted(lambda: epoch(graph, [batch], valid[:, None],
                                               lrs)[0][0])
        losses = [got]
        for t, st in runs[1:]:
            loss, eager_calls, _ = _counted(lambda: _eager_stacked(
                steps[id(t)], t, st, batch, lr, valid))
            losses.append(loss)
        torch.cuda.synchronize()
        fold_rows = []
        for k in range(len(folds)):
            if not valid[k]:
                continue
            fold_rows.append(dict(
                losses=[float(x[k]) for x in losses],
                gap=_change_gap([graph.params[k]], [eager.params[k]],
                                [before[k]]),
                gap_again=_change_gap([again.params[k]], [eager.params[k]],
                                      [before[k]])))
        same = all(
            torch.equal(a.get_state(), b.get_state())
            for _, st in runs[1:] for a, b in zip(graph.generators,
                                                  st.generators)) and all(
            graph.count.tolist() == st.count.tolist()
            and graph.step.tolist() == st.step.tolist()
            for _, st in runs[1:])
        out.append(dict(step=s, folds=fold_rows, same=same, calls=calls,
                        eager_calls=eager_calls, masked=not valid.all()))
        for k, (tensors, gen) in zip(
                [k for k in range(len(folds)) if not valid[k]], masked):
            assert all(torch.equal(a[k], b) for a, b in
                       zip(graph._tensors(), tensors)), (s, k)
            assert torch.equal(graph.generators[k].get_state(), gen), (s, k)
            assert float(got[k]) == 0.0
    spread = max(r["gap_again"] for row in out for r in row["folds"])
    for row in out:
        assert row["same"], row
        for r in row["folds"]:
            lg, le, la = r["losses"]
            assert abs(lg - le) <= 1e-5 and abs(la - le) <= 1e-5, (row, r)
            assert r["gap"] <= 2 * spread + 1e-5, (row, r, spread)
    all_valid = [row["step"] for row in out if not row["masked"]]
    assert len(all_valid) >= 3
    recs = profiling.spans()
    assert sum(r.name == "setup.capture" for r in recs) == 1
    epochs = [r for r in recs if r.name == "train.epoch"]
    assert len(epochs) == len(batches)
    replayed = []
    for e in epochs:
        (st,) = [r for r in recs if r.parent == e.index
                 and r.name == "train.step"]
        replayed.append(any(r.parent == st.index and r.name == "train.replay"
                            for r in recs))
    # the first all-valid step warms up, every later one replays
    assert replayed == [s in all_valid[1:] for s in range(len(batches))]
    for row in out:
        if row["step"] in all_valid[2:]:
            assert row["calls"] == [0] * 4, row
        elif row["step"] == all_valid[0]:
            assert row["calls"] == row["eager_calls"], row
    if case == "fused":  # 6 stages a fold (the first step's eager calls
        # also hold the forward that finds the dropout shapes)
        assert out[1]["eager_calls"] == [6 * len(folds)] * 4


@pytest.mark.cuda
def test_replayed_stacked_epoch_streams_on_card(cuda_device):
    """A whole stacked epoch (two folds of 30 rows, 4 steps of 8, the last
    ragged) with its batches streamed by ``BatchPrefetcher``, whose thread
    pins and copies on its own stream while the second step is captured:
    the first two steps' losses within 1e-5 of the eager body's on the
    device-gathered batches from the same start, every loss finite, three
    replays, and the state advanced by four steps."""
    import dataclasses

    from multimodal_survival_prediction_tpu_torch.config import (
        PARTIAL_MODALITY,
    )
    from multimodal_survival_prediction_tpu_torch.train import cv_parallel
    from multimodal_survival_prediction_tpu_torch.train.cv import (
        make_trainers,
    )
    from multimodal_survival_prediction_tpu_torch.utils import profiling

    cfg = dataclasses.replace(PARTIAL_MODALITY, batch_size=8,
                              image_shape=(16, 16, 8))

    def make():
        return make_trainers(cfg, 24, "simple_cnn", None, cuda_device)[0]

    host = _pm_data()
    data = {k: torch.from_numpy(v).to(cuda_device) for k, v in host.items()}
    rows = [np.arange(30), np.arange(30)[::-1]]
    idx, bv = cv_parallel._stack_fold_indices(
        rows, 8, [np.random.default_rng(7), np.random.default_rng(8)])
    step_valid = bv.max(axis=2) > 0
    lrs = np.array([1e-3, 2e-3])
    (tr, graph), (tr_e, eager) = _stacked(make, (1, 2)), _stacked(make,
                                                                  (1, 2))
    profiling.reset_spans()
    got = cv_parallel._build_parallel_train_epoch(tr)(
        graph, cv_parallel.stacked_batches(tr, host, idx, bv,
                                           streaming=True),
        step_valid, lrs)[0]
    step = cv_parallel._build_parallel_train_step(tr_e)
    lr = torch.tensor(lrs[:, None], dtype=torch.float32, device=cuda_device)
    want = torch.stack([_eager_stacked(step, tr_e, eager, b, lr,
                                       step_valid[:, s]) for s, b in
                        enumerate(cv_parallel.stacked_batches(
                            tr_e, data, idx, bv))])
    got, want = got.cpu(), want.cpu()
    assert step_valid.all() and got.shape == (4, 2)
    assert torch.isfinite(got).all()
    assert float((got[:2] - want[:2]).abs().max()) <= 1e-5
    assert sum(r.name == "train.replay" for r in profiling.spans()) == 3
    assert graph.count.tolist() == graph.step.tolist() == [4, 4]
    assert all(torch.equal(a.get_state(), b.get_state())
               for a, b in zip(graph.generators, eager.generators))
