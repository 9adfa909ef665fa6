"""Port CT resample (multimodal_survival_prediction_tpu_torch/ops/resample.py)
against the JAX module, on the CPU.

Inputs come from numpy with fixed seeds and go through both frameworks.
The kernel-vs-plain tests on the card are in tests/test_torch_cuda.py.
Tolerance: atol 1e-5 on the normalized [0, 1] output — both sides contract
in fp32 (JAX at precision HIGHEST), in different summation orders.
The JAX Pallas path runs in interpret mode on the CPU, as in
tests/test_resample.py.
"""

import numpy as np
import pytest
import torch

from multimodal_survival_prediction_tpu.ops import resample as jr
from multimodal_survival_prediction_tpu_torch.ops import resample as tr

ATOL = 1e-5


def _case(name):
    rng = np.random.default_rng(CASES.index(name))
    if name == "int16":
        return rng.integers(-1024, 3072, size=(24, 32, 16),
                            dtype=np.int16), (8, 8, 8), None
    if name == "float32":
        return rng.normal(size=(24, 40, 56)).astype(np.float32), \
            (64, 64, 32), None
    if name == "hu_window":
        return rng.normal(0, 500, size=(20, 24, 18)).astype(np.float32), \
            (8, 8, 8), (-150, 250)
    if name == "ragged":  # D*H = 91 rows: not a multiple of the JAX tile
        return rng.integers(-1024, 3072, size=(7, 13, 40),
                            dtype=np.int16), (8, 8, 8), (-150, 250)
    raise KeyError(name)


CASES = ["int16", "float32", "hu_window", "ragged"]


@pytest.mark.parametrize("in_size,out_size", [
    (5, 3), (4, 7), (3, 1), (1, 3), (100, 64), (17, 32), (512, 32),
    (500, 32), (97, 32), (128, 64)])
def test_interp_matrix_and_taps_exact(in_size, out_size):
    m = tr.linear_interp_matrix(in_size, out_size)
    np.testing.assert_array_equal(m, jr.linear_interp_matrix(in_size,
                                                             out_size))
    # the kernel's two-tap form carries the matrix's entries exactly
    t0, t1, w0, w1 = tr.two_taps(in_size, out_size)
    dense = np.zeros_like(m)
    np.add.at(dense, (np.arange(out_size), t0), w0)
    np.add.at(dense, (np.arange(out_size), t1), w1)
    np.testing.assert_array_equal(dense, m)


@pytest.mark.parametrize("name", CASES)
def test_plain_matches_jax(name):
    vol, out_shape, hu = _case(name)
    want = np.asarray(jr.resample_normalize(vol, out_shape, hu_window=hu))
    got = tr.resample_normalize(vol, out_shape, hu_window=hu, device="cpu")
    assert got.dtype == torch.float32 and tuple(got.shape) == out_shape
    np.testing.assert_allclose(got.numpy(), want, atol=ATOL)


@pytest.mark.parametrize("name", CASES)
def test_fused_path_matches_jax_pallas(name):
    """The port's fused entry (W-pass = its plain version on the CPU) vs
    the JAX Pallas kernel in interpret mode; rows=32 makes the JAX grid
    several tiles with a padded ragged tail."""
    vol, out_shape, hu = _case(name)
    want = np.asarray(jr.resample_normalize_pallas(vol, out_shape, rows=32,
                                                   hu_window=hu))
    got = tr.resample_normalize_cuda(vol, out_shape, hu_window=hu,
                                     device="cpu")
    np.testing.assert_allclose(got.numpy(), want, atol=ATOL)


@pytest.mark.parametrize("name", CASES)
def test_bucketed_matches_jax_bucketed(name):
    vol, out_shape, hu = _case(name)
    want = np.asarray(jr.resample_normalize_bucketed(vol, out_shape,
                                                     hu_window=hu))
    got = tr.resample_normalize_bucketed(vol, out_shape, hu_window=hu,
                                         device="cpu")
    np.testing.assert_allclose(got.numpy(), want, atol=ATOL)


@pytest.mark.parametrize("name", CASES)
def test_wpass_minmax_exact_and_two_tap_arithmetic(name):
    """The plain W-pass gives the exact min/max; the kernel's arithmetic
    (two taps, each product rounded, then one rounded add), emulated in
    numpy f32, agrees with the dense contraction to f32 rounding."""
    vol, out_shape, hu = _case(name)
    d, h, w = vol.shape
    rows = torch.from_numpy(vol.reshape(d * h, w))
    tmp, mn, mx = tr.wpass_plain(rows, out_shape[2], hu)
    v = vol.reshape(d * h, w).astype(np.float32)
    if hu is not None:
        v = np.clip(v, hu[0], hu[1])
    assert mn.item() == v.min() and mx.item() == v.max()
    t0, t1, w0, w1 = tr.two_taps(w, out_shape[2])
    gather = (v[:, t0] * w0).astype(np.float32) + (v[:, t1] * w1)
    scale = max(1.0, float(np.abs(v).max()))
    np.testing.assert_allclose(tmp.numpy(), gather, atol=2e-7 * scale,
                               rtol=0)


def test_non_kernel_dtypes_match_float32():
    """uint16 / float64 / big-endian volumes give the float32 result
    (lossless host widening / byte swap, or a float32 cast)."""
    rng = np.random.default_rng(5)
    base = rng.integers(0, 4000, size=(9, 11, 13)).astype(np.uint16)
    want = tr.resample_normalize_cuda(base.astype(np.float32), (8, 8, 8),
                                      device="cpu")
    for vol in (base, base.astype(np.float64), base.astype(">i2")):
        got = tr.resample_normalize_cuda(vol, (8, 8, 8), device="cpu")
        np.testing.assert_allclose(got.numpy(), want.numpy(), atol=1e-7)


def test_entry_points_need_cuda_unless_cpu(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    vol = np.zeros((4, 4, 4), np.float32)
    for fn in (tr.resample_normalize, tr.resample_normalize_cuda,
               tr.resample_normalize_bucketed):
        with pytest.raises(RuntimeError, match="device='cpu'"):
            fn(vol, (2, 2, 2))
        fn(vol, (2, 2, 2), device="cpu")  # explicit CPU is fine


def test_wpass_routes_by_tensor_device():
    rows = torch.arange(24, dtype=torch.int16).reshape(4, 6)
    before = tr.wpass.launches
    out, mn, mx = tr.wpass(rows, 3)
    assert tr.wpass.launches == before  # CPU tensor: plain version
    ref, _, _ = tr.wpass_plain(rows, 3)
    torch.testing.assert_close(out, ref, rtol=0, atol=0)
    assert (mn.item(), mx.item()) == (0.0, 23.0)
    with pytest.raises(ValueError, match="unsupported device"):
        tr.wpass(torch.empty((4, 6), device="meta"), 3)
