"""The port's CUDA kernels against their plain torch versions, on the card.

Every test here is marked ``cuda`` and skips on a machine without an NVIDIA
GPU (a CUDA kernel has no CPU mode). This file imports neither JAX nor the
JAX package, so it also runs where only the port is installed:

    python -m pytest --noconftest -p no:cacheprovider tests/test_torch_cuda.py

(``--noconftest`` skips tests/conftest.py, which sets up JAX.)
Tolerances: min/max exact; the W-pass rows to 2e-7 of the largest |voxel|
(f32 rounding of a two-term sum); the normalized volume to 2e-6.
"""

import numpy as np
import pytest
import torch

from multimodal_survival_prediction_tpu_torch.ops import resample as tr


@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU (the CUDA kernel has no CPU mode)")
    torch.backends.cuda.matmul.allow_tf32 = False
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
