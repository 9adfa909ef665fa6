"""The port's host C++ engine (``csrc/msp_native.cpp`` via
``data/native.py``), the link probe and ``VolumePrefetcher``'s modes
against the JAX package's, on the CPU.

Tolerances:
  * NIfTI decode: bit-equal to JAX's ``read_nifti`` (dtype included);
  * the engine's resample: 2e-5 against JAX's XLA ``resample_normalize``
    and the port's plain torch one (JAX pins its engine against XLA at
    2e-5), bit-equal to JAX's ``resample_normalize_host`` (the same source
    and flags);
  * prefetcher runs: each mode and fallback as JAX's prefetcher takes it,
    host volumes bit-equal to JAX's host volumes, device volumes within
    1e-6 of JAX's (both resample plain on the CPU), host vs device 2e-5.

The engine is built once per session (its library is cached under
``build/kernels/`` by source hash, compiler and CPU).
"""

import ctypes
import dataclasses
import gzip
import logging
import struct
import threading
import time

import numpy as np
import pytest

from multimodal_survival_prediction_tpu.data import native as jnative
from multimodal_survival_prediction_tpu.data import pipeline as jpipeline
from multimodal_survival_prediction_tpu.data.nifti import (
    read_nifti as jread_nifti,
)
from multimodal_survival_prediction_tpu.ops import resample as jr
from multimodal_survival_prediction_tpu.ops.resample import (
    resample_normalize as jresample,
)
from multimodal_survival_prediction_tpu_torch.data import native, pipeline
from multimodal_survival_prediction_tpu_torch.data.datasets import (
    build_cohort_arrays,
)
from multimodal_survival_prediction_tpu_torch.data.nifti import write_nifti
from multimodal_survival_prediction_tpu_torch.data.pipeline import (
    VolumePrefetcher,
)
from multimodal_survival_prediction_tpu_torch.ops import _build
from multimodal_survival_prediction_tpu_torch.ops.resample import (
    resample_normalize as tresample,
)

HOST_TOL = 2e-5
DEVICE_TOL = 1e-6
OUT = (8, 8, 8)


@pytest.fixture(autouse=True)
def _no_cached_jax_tracers():
    """The JAX package's ``ops/resample.py:_matrices`` (an ``lru_cache``
    filled inside a jit trace) can hold tracers that a later trace of the
    same shapes with another dtype or ``hu_window`` trips over: each test
    starts and ends with it empty (as tests/test_torch_data.py does)."""
    jr._matrices.cache_clear()
    yield
    jr._matrices.cache_clear()


@pytest.fixture(scope="module")
def engine():
    lib, info = native.build_native()
    return info


@pytest.fixture(scope="module")
def jax_engine():
    if not jnative.native_available():
        pytest.skip("the JAX package's native library did not build")
    return jnative


def _volume(rng, dtype, shape=(14, 22, 18)):
    if dtype == "int16":
        return rng.integers(-1024, 3072, size=shape, dtype=np.int16)
    if dtype == "uint8":
        return rng.integers(0, 256, size=shape, dtype=np.uint8)
    return rng.normal(0, 100, size=shape).astype(np.float32)


# ---------------------------------------------------------------------------
# build
# ---------------------------------------------------------------------------

def test_build_records_the_toolchain(engine):
    assert engine["zlib"] is True  # this machine has zlib
    assert engine["compiler"].startswith("g++")
    assert engine["march"] and engine["machine"]
    assert engine["library"].endswith("libmsp_native_port.so")
    assert "/build/kernels/" in engine["library"]
    assert native.native_available()


def test_failed_build_raises_with_the_compilers_stderr(tmp_path, monkeypatch,
                                                       caplog):
    bad = tmp_path / "broken.cpp"
    bad.write_text('extern "C" int msp_broken() { return undeclared_x; }\n')
    with pytest.raises(RuntimeError, match="undeclared_x"):
        _build.build_host(bad, "msp_broken_test")
    # native_available keeps JAX's contract (False), after a WARNING that
    # carries the compiler's stderr; the host resample then raises
    monkeypatch.setattr(native, "SOURCE", bad)
    monkeypatch.setattr(native, "LIB_NAME", "msp_broken_test")
    monkeypatch.setattr(native, "_lib", None)
    monkeypatch.setattr(native, "_error", None)
    with caplog.at_level(logging.WARNING, logger=native.__name__):
        assert native.native_available() is False
    assert any(r.levelno == logging.WARNING and "undeclared_x" in r.message
               for r in caplog.records)
    with pytest.raises(RuntimeError, match="did not build"):
        native.resample_normalize_host(np.zeros((4, 4, 4), np.float32), OUT)


def test_build_without_zlib_refuses_gz_and_reads_through_python(
        tmp_path, rng, monkeypatch):
    """A machine without zlib builds with -DMSP_NO_ZLIB: the engine refuses
    .gz paths, read_nifti_fast reads them through the pure-Python reader,
    and the resample is unchanged."""
    real = _build.host_toolchain
    monkeypatch.setattr(_build, "host_toolchain",
                        lambda cxx, scratch: dict(real(cxx, scratch),
                                                  zlib=False))
    lib, info = _build.build_host(native.SOURCE, "msp_native_nozlib_test")
    assert info["zlib"] is False
    native._bind(lib)
    vol = _volume(rng, "int16")
    for suffix in (".nii", ".nii.gz"):
        write_nifti(tmp_path / f"v{suffix}", vol)
    f3 = ctypes.c_float * 3
    code = ctypes.c_int32(0)
    assert not lib.msp_nifti_open_any(str(tmp_path / "v.nii.gz").encode(),
                                      (ctypes.c_int64 * 3)(), f3(), f3(),
                                      ctypes.byref(code))
    monkeypatch.setattr(native, "_lib", lib)
    monkeypatch.setenv("MSP_NATIVE_IO", "1")
    for suffix in (".nii", ".nii.gz"):
        got = native.read_nifti_fast(tmp_path / f"v{suffix}").data
        assert got.dtype == np.int16
        np.testing.assert_array_equal(got, vol)
    a = native.resample_normalize_host(vol, OUT)
    np.testing.assert_allclose(a, jresample(vol, OUT), atol=HOST_TOL)


# ---------------------------------------------------------------------------
# decode and resample against JAX
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("suffix", [".nii", ".nii.gz"])
@pytest.mark.parametrize("dtype", ["int16", "uint8", "float32"])
def test_native_read_matches_jax(engine, tmp_path, rng, monkeypatch, dtype,
                                 suffix):
    monkeypatch.setenv("MSP_NATIVE_IO", "1")
    vol = _volume(rng, dtype)
    p = tmp_path / f"v{suffix}"
    write_nifti(p, vol, spacing=(0.7, 0.7, 2.5), origin=(1.0, -2.0, 3.0))
    got, ref = native.read_nifti_fast(p), jread_nifti(p)
    assert got.data.dtype == ref.data.dtype == vol.dtype
    np.testing.assert_array_equal(got.data, ref.data)
    np.testing.assert_array_equal(got.data, vol)
    assert got.spacing == pytest.approx(ref.spacing)
    assert got.origin == pytest.approx(ref.origin)


def test_native_read_scaled_and_big_endian_fall_back(engine, tmp_path, rng,
                                                     monkeypatch):
    """A non-trivial scl slope comes back converted to float32 (the engine's
    converting path); a big-endian file, which the engine refuses, through
    the pure-Python reader."""
    monkeypatch.setenv("MSP_NATIVE_IO", "1")
    vol = _volume(rng, "int16")
    p = tmp_path / "s.nii"
    write_nifti(p, vol)
    raw = bytearray(p.read_bytes())
    struct.pack_into("<2f", raw, 112, 2.0, -5.0)
    p.write_bytes(bytes(raw))
    got, ref = native.read_nifti_fast(p), jread_nifti(p)
    assert got.data.dtype == np.float32
    np.testing.assert_array_equal(got.data, ref.data)

    be = tmp_path / "be.nii"
    hdr = bytearray(348)
    struct.pack_into(">i", hdr, 0, 348)
    struct.pack_into(">8h", hdr, 40, 3, 6, 5, 4, 1, 1, 1, 1)
    struct.pack_into(">h", hdr, 70, 4)
    struct.pack_into(">8f", hdr, 76, 1, 1, 1, 1, 1, 1, 1, 1)
    struct.pack_into(">f", hdr, 108, 352.0)
    struct.pack_into(">2f", hdr, 112, 1.0, 0.0)
    hdr[344:348] = b"n+1\x00"
    data = rng.integers(-9, 9, size=(4, 5, 6)).astype(">i2")
    be.write_bytes(bytes(hdr) + b"\0" * 4
                   + np.asfortranarray(data.transpose(2, 1, 0)).tobytes("F"))
    got = native.read_nifti_fast(be)
    np.testing.assert_array_equal(got.data, data.astype(np.int16))


@pytest.mark.parametrize("hu", [None, (-150.0, 250.0)],
                         ids=["no-window", "hu-window"])
@pytest.mark.parametrize("dtype", ["int16", "uint8", "float32"])
def test_native_resample_matches_jax_and_plain(engine, jax_engine, rng,
                                               dtype, hu):
    vol = _volume(rng, dtype, shape=(20, 24, 22))
    out_shape = (12, 12, 8)
    host = native.resample_normalize_host(vol, out_shape, hu_window=hu)
    assert host.dtype == np.float32 and host.shape == out_shape
    np.testing.assert_allclose(
        host, np.asarray(jresample(vol, out_shape, hu_window=hu)),
        atol=HOST_TOL, rtol=0)
    np.testing.assert_allclose(
        host, tresample(vol, out_shape, hu_window=hu, device="cpu").numpy(),
        atol=HOST_TOL, rtol=0)
    np.testing.assert_array_equal(
        host, jax_engine.resample_normalize_host(vol, out_shape,
                                                 hu_window=hu))


def test_native_resample_refuses_a_degenerate_shape(engine):
    with pytest.raises(ValueError, match="resample failed"):
        native.resample_normalize_host(np.zeros((3, 3, 3), np.int16),
                                       (0, 4, 4))


# ---------------------------------------------------------------------------
# fuzz (tests/test_native_fuzz.py's four cases on the port's reader)
# ---------------------------------------------------------------------------

def _decode_no_crash(path):
    """Decode returns or raises — anything but a crash or a hang; a volume
    that comes back is of a sane size."""
    try:
        vol = native.read_nifti_fast(path)
    except Exception:
        return
    assert vol.data.size < 10_000_000


@pytest.fixture()
def valid_nii(tmp_path, engine, monkeypatch):
    monkeypatch.setenv("MSP_NATIVE_IO", "1")
    vol = np.random.default_rng(0).integers(-500, 500, size=(6, 8, 10))
    p = tmp_path / "v.nii"
    write_nifti(p, vol.astype(np.int16), spacing=(0.7, 0.7, 2.5))
    return p


def test_fuzz_header_byte_corruption(valid_nii, tmp_path):
    raw = valid_nii.read_bytes()
    rng = np.random.default_rng(1)
    p = tmp_path / "fuzz.nii"
    for _ in range(150):
        buf = bytearray(raw)
        for _ in range(int(rng.integers(1, 9))):
            buf[int(rng.integers(0, min(400, len(buf))))] = int(
                rng.integers(0, 256))
        p.write_bytes(bytes(buf))
        _decode_no_crash(p)


def test_fuzz_truncation(valid_nii, tmp_path):
    raw = valid_nii.read_bytes()
    rng = np.random.default_rng(2)
    p = tmp_path / "trunc.nii"
    cuts = sorted({int(rng.integers(0, len(raw))) for _ in range(40)}
                  | {0, 1, 4, 347, 348, 352, 356, len(raw) - 1})
    for cut in cuts:
        p.write_bytes(raw[:cut])
        _decode_no_crash(p)


def test_fuzz_adversarial_header_fields(valid_nii, tmp_path):
    raw = bytearray(valid_nii.read_bytes())
    p = tmp_path / "adv.nii"
    cases = []
    for v in (-1, 0, -32768, 32767, 1, 7):
        for off in (40, 42, 44, 46):
            cases.append((off, struct.pack("<h", v)))
    for v in (-1, 0, 2, 4, 8, 16, 64, 256, 512, 1024, 32767):
        cases.append((70, struct.pack("<h", v)))
        cases.append((72, struct.pack("<h", v)))
    for v in (float("nan"), float("inf"), -float("inf"), -1.0, 0.0, 1e30,
              -1e30, 3.5, 352.0, 1e9):
        for off in (108, 112, 116):
            cases.append((off, struct.pack("<f", v)))
    for off, payload in cases:
        buf = bytearray(raw)
        buf[off:off + len(payload)] = payload
        p.write_bytes(bytes(buf))
        _decode_no_crash(p)


def test_fuzz_gzip_container(valid_nii, tmp_path):
    raw = valid_nii.read_bytes()
    rng = np.random.default_rng(3)
    p = tmp_path / "fuzz.nii.gz"
    for i in range(40):
        buf = bytearray(raw)
        for _ in range(int(rng.integers(1, 6))):
            buf[int(rng.integers(0, min(400, len(buf))))] = int(
                rng.integers(0, 256))
        gz = bytearray(gzip.compress(bytes(buf)))
        if i % 3 == 0 and len(gz) > 20:
            gz[int(rng.integers(10, len(gz)))] = int(rng.integers(0, 256))
        p.write_bytes(bytes(gz))
        _decode_no_crash(p)
    for n in (0, 1, 10, 352, 1000):
        p.write_bytes(bytes(rng.integers(0, 256, size=n, dtype=np.uint8)))
        _decode_no_crash(p)


# ---------------------------------------------------------------------------
# VolumePrefetcher's modes against JAX's (tests/test_native_pipeline.py)
# ---------------------------------------------------------------------------

def _jobs(tmp_path, rng, n=3, tag="v", shape=(12, 14, 16)):
    jobs, vols = [], []
    for i in range(n):
        vol = rng.integers(-500, 2000, size=shape, dtype=np.int16)
        p = tmp_path / f"{tag}{i}.nii.gz"
        write_nifti(p, vol)
        jobs.append((i, str(p)))
        vols.append(vol)
    return jobs, vols


def _both(jobs, monkeypatch=None, **kw):
    """(port volumes, port mode, JAX volumes, JAX mode) of one run."""
    pre = VolumePrefetcher(num_workers=2, device="cpu")
    mine = dict(pre.run(jobs, OUT, **kw))
    jpre = jpipeline.VolumePrefetcher(num_workers=2)
    ref = dict(jpre.run(jobs, OUT, **kw))
    return mine, pre.last_mode, ref, jpre.last_mode


def test_host_mode_matches_jax(engine, jax_engine, tmp_path, rng):
    jobs, _ = _jobs(tmp_path, rng, n=4)
    mine, mode, ref, jmode = _both(jobs, resample="host")
    assert mode == jmode == "host"
    dev, dmode, jdev, _ = _both(jobs, resample="device")
    assert dmode == "device"
    for i in range(4):
        np.testing.assert_array_equal(mine[i], ref[i])
        np.testing.assert_allclose(mine[i], dev[i], atol=HOST_TOL, rtol=0)
        np.testing.assert_allclose(dev[i], jdev[i], atol=DEVICE_TOL, rtol=0)


def test_auto_picks_host_on_slow_link(engine, jax_engine, tmp_path, rng,
                                      monkeypatch):
    monkeypatch.setattr(pipeline, "probe_link_bandwidth",
                        lambda nbytes=0, device=None: 1.0)
    monkeypatch.setattr(jpipeline, "probe_link_bandwidth",
                        lambda nbytes=0: 1.0)
    bad = tmp_path / "bad.nii.gz"
    bad.write_bytes(b"not a nifti")
    jobs, vols = _jobs(tmp_path, rng)
    jobs = [(9, str(bad)), *jobs]
    pre = VolumePrefetcher(num_workers=2, device="cpu")
    order = [i for i, _ in pre.run(jobs, OUT, resample="auto")]
    assert order == [9, 0, 1, 2]  # the failed decode before the probe's
    assert pre.last_probe["mode"] == "host"
    mine, mode, ref, jmode = _both(jobs, resample="auto")
    assert mode == jmode == "host"
    assert mine[9] is None and ref[9] is None
    for i, v in enumerate(vols):
        np.testing.assert_array_equal(mine[i], ref[i])
        np.testing.assert_allclose(mine[i], jresample(v, OUT), atol=HOST_TOL)


def test_auto_device_is_single_path(engine, tmp_path, rng, monkeypatch):
    """A fast link: the device path, the probe volume resampled again on
    the device (bit-equal to an explicit 'device' run)."""
    monkeypatch.setattr(pipeline, "probe_link_bandwidth",
                        lambda nbytes=0, device=None: 1e12)
    monkeypatch.setattr(jpipeline, "probe_link_bandwidth",
                        lambda nbytes=0: 1e12)
    jobs, _ = _jobs(tmp_path, rng)
    dev, _, jdev, _ = _both(jobs, resample="device")
    mine, mode, ref, jmode = _both(jobs, resample="auto")
    assert mode == jmode == "device"
    for i in range(3):
        np.testing.assert_array_equal(mine[i], dev[i])
        np.testing.assert_allclose(mine[i], ref[i], atol=DEVICE_TOL, rtol=0)


def test_auto_probe_resample_failure_keeps_the_volume(engine, tmp_path, rng,
                                                      monkeypatch):
    def boom(vol, out_shape, hu_window=None):
        raise ValueError("degenerate volume")

    for mod in (pipeline, jpipeline):
        monkeypatch.setattr(mod, "probe_link_bandwidth",
                            lambda nbytes=0, device=None: 1.0)
    monkeypatch.setattr(native, "resample_normalize_host", boom)
    monkeypatch.setattr(jnative, "resample_normalize_host", boom)
    jobs, _ = _jobs(tmp_path, rng)
    mine, mode, ref, jmode = _both(jobs, resample="auto")
    assert mode == jmode == "device"
    for i in range(3):  # the probe volume (0) kept through the device path
        assert mine[i] is not None and mine[i].shape == OUT
        np.testing.assert_allclose(mine[i], ref[i], atol=DEVICE_TOL, rtol=0)


def test_host_pin_without_engine_uses_device(tmp_path, rng, monkeypatch,
                                             caplog):
    def boom(*a, **kw):
        raise AssertionError("host path entered without the engine")

    for mod in (native, jnative):
        monkeypatch.setattr(mod, "native_available", lambda: False)
        monkeypatch.setattr(mod, "resample_normalize_host", boom)
    jobs, _ = _jobs(tmp_path, rng, n=2)
    with caplog.at_level(logging.WARNING):
        mine, mode, ref, jmode = _both(jobs, resample="host")
    assert mode == jmode == "device"
    assert any("resample='host'" in r.message and r.name == pipeline.__name__
               for r in caplog.records)
    for i in range(2):
        np.testing.assert_allclose(mine[i], ref[i], atol=DEVICE_TOL, rtol=0)


def test_auto_probe_bandwidth_failure_uses_device(engine, tmp_path, rng,
                                                  monkeypatch):
    def boom(nbytes=0, device=None):
        raise TimeoutError("link wedged")

    monkeypatch.setattr(pipeline, "probe_link_bandwidth", boom)
    monkeypatch.setattr(jpipeline, "probe_link_bandwidth", boom)
    jobs, _ = _jobs(tmp_path, rng)
    mine, mode, ref, jmode = _both(jobs, resample="auto")
    assert mode == jmode == "device"
    for i in range(3):
        np.testing.assert_allclose(mine[i], ref[i], atol=DEVICE_TOL, rtol=0)


def test_auto_pallas_request_forces_device(engine, tmp_path, rng,
                                           monkeypatch):
    def fail_probe(nbytes=0, device=None):
        raise AssertionError("probe must not run when use_pallas pins device")

    monkeypatch.setattr(pipeline, "probe_link_bandwidth", fail_probe)
    jobs, vols = _jobs(tmp_path, rng, n=2)
    pre = VolumePrefetcher(num_workers=2, device="cpu")
    got = dict(pre.run(jobs, OUT, use_pallas=True, resample="auto"))
    assert pre.last_mode == "device"
    for i, v in enumerate(vols):  # the W-pass's plain version on the CPU
        np.testing.assert_allclose(got[i], jresample(v, OUT),
                                   atol=DEVICE_TOL, rtol=0)


def test_cohort_ingest_mode_recorded(engine, tmp_path, rng):
    vol = rng.integers(-500, 2000, size=(12, 14, 16), dtype=np.int16)
    p = tmp_path / "m0.nii.gz"
    write_nifti(p, vol)
    table = [{"patient_id": "P0", "age": 60.0, "survival_time": 100.0,
              "survival_status": 1.0, "has_survival": True,
              "has_imaging": True, "nifti_path": str(p)}]
    modes = {}
    for resample in ("host", "device", None):
        a = build_cohort_arrays(table, None, with_image=True,
                                image_shape=OUT, resample=resample,
                                device="cpu")
        modes[resample] = (a.ingest_mode, a.arrays["image"][0, ..., 0])
    assert modes["host"][0] == "host"
    assert modes["device"][0] == modes[None][0] == "device"  # no link on CPU
    np.testing.assert_allclose(modes["host"][1], modes["device"][1],
                               atol=HOST_TOL, rtol=0)
    assert build_cohort_arrays(table, None, with_image=False,
                               device="cpu").ingest_mode is None


# ---------------------------------------------------------------------------
# the link probe
# ---------------------------------------------------------------------------

def test_probe_link_bandwidth_watchdog(monkeypatch):
    """A stalled round trip returns the pessimistic 2 * nbytes / timeout
    within the timeout, again while it stalls, and the late measurement
    repairs the cache on the next call — JAX's contract, on both."""
    results = {}
    for mod, patch in ((pipeline, "_round_trip"), (jpipeline.jax,
                                                   "device_get")):
        release = threading.Event()
        real = getattr(mod, patch)

        def slow(*a, _real=real, _release=release):
            _release.wait(30)
            return _real(*a)

        monkeypatch.setattr(mod, patch, slow)
        owner = pipeline if mod is pipeline else jpipeline
        monkeypatch.setattr(owner, "_BW_CACHE", {})
        monkeypatch.setattr(owner, "_BW_PENDING", {})
        kw = {"device": "cpu"} if owner is pipeline else {}
        nbytes, timeout = 1 << 20, 0.2
        t0 = time.perf_counter()
        bw = owner.probe_link_bandwidth(nbytes=nbytes, timeout_sec=timeout,
                                        **kw)
        assert time.perf_counter() - t0 < 5
        assert bw == pytest.approx(2 * nbytes / timeout)
        assert owner.probe_link_bandwidth(
            nbytes=nbytes, timeout_sec=timeout, **kw) == pytest.approx(bw)
        assert not owner._BW_CACHE
        release.set()
        done = next(iter(owner._BW_PENDING.values()))[0]
        assert done.wait(10)
        late = owner.probe_link_bandwidth(nbytes=nbytes, timeout_sec=timeout,
                                          **kw)
        assert owner._BW_CACHE and late > bw
        results[owner.__name__] = (bw, list(owner._BW_CACHE))
    assert results[pipeline.__name__][0] == results[jpipeline.__name__][0]
    assert results[pipeline.__name__][1] == ["cpu"]  # cached per device


def test_probe_caches_per_device_and_reraises(monkeypatch):
    monkeypatch.setattr(pipeline, "_BW_CACHE", {})
    monkeypatch.setattr(pipeline, "_BW_PENDING", {})
    bw = pipeline.probe_link_bandwidth(nbytes=1 << 16, device="cpu")
    assert bw > 0 and pipeline._BW_CACHE == {"cpu": bw}
    assert pipeline.probe_link_bandwidth(device="cpu") == bw

    def broken(buf, dev):
        raise RuntimeError("copy failed")

    monkeypatch.setattr(pipeline, "_BW_CACHE", {})
    monkeypatch.setattr(pipeline, "_round_trip", broken)
    with pytest.raises(RuntimeError, match="copy failed"):
        pipeline.probe_link_bandwidth(nbytes=1 << 16, device="cpu")


# ---------------------------------------------------------------------------
# folds pinned to the host engine
# ---------------------------------------------------------------------------

def test_predict_risk_on_host_pinned_folds(engine, jax_engine, tmp_path,
                                           monkeypatch):
    """A slow link makes 'auto' choose the host engine in both CV drivers
    (partial_modality, simple_cnn at 16x16x8, 2 folds x 1 epoch), so each
    writes resample_mode "host" into its folds' .meta.json. The port's
    predict_risk scores both drivers' fold 1 through the host engine (no
    W-pass launch), as JAX's predict_risk scores them (log-hazards 1e-4:
    the models' float32 sums differ in order)."""
    from multimodal_survival_prediction_tpu import config as jconfig
    from multimodal_survival_prediction_tpu.data.synthetic import (
        SyntheticCohortSpec as JSpec,
    )
    from multimodal_survival_prediction_tpu.data.synthetic import (
        generate_synthetic_cohort as jgen,
    )
    from multimodal_survival_prediction_tpu.train import cv as jcv
    from multimodal_survival_prediction_tpu.train.predict import (
        predict_risk as jax_predict,
    )
    from multimodal_survival_prediction_tpu_torch.config import (
        PARTIAL_MODALITY,
    )
    from multimodal_survival_prediction_tpu_torch.data.matching_table import (
        load_matching_table,
    )
    from multimodal_survival_prediction_tpu_torch.io.checkpoint import (
        load_checkpoint,
        load_fold_meta,
        save_checkpoint,
        save_fold_meta,
    )
    from multimodal_survival_prediction_tpu_torch.ops import resample as rs
    from multimodal_survival_prediction_tpu_torch.train import cv
    from multimodal_survival_prediction_tpu_torch.train.predict import (
        fold_checkpoints,
        predict_risk,
    )

    monkeypatch.setattr(pipeline, "probe_link_bandwidth",
                        lambda nbytes=0, device=None: 1.0)
    monkeypatch.setattr(jpipeline, "probe_link_bandwidth",
                        lambda nbytes=0: 1.0)
    jtable, paths = jgen(tmp_path / "cohort", JSpec(
        n_patients=14, rna_dim=24, seed=2, p_imaging=0.6,
        image_shapes=((12, 20, 20), (10, 18, 16))))
    jcfg = jconfig.PARTIAL_MODALITY.with_overrides(
        image_shape=(16, 16, 8), n_folds=2, num_epochs=1)
    jcv.run_cross_validation(jcfg, jtable, rnaseq_csv=paths["rnaseq_csv"],
                             results_dir=tmp_path / "jres",
                             models_dir=tmp_path / "jax",
                             backbone="simple_cnn")
    rows = load_matching_table(paths["matching_table"])
    cfg = dataclasses.replace(PARTIAL_MODALITY, image_shape=(16, 16, 8),
                              n_folds=2)
    cv.run_cross_validation(cfg, rows, rnaseq_csv=paths["rnaseq_csv"],
                            results_dir=tmp_path / "tres",
                            models_dir=tmp_path / "port",
                            backbone="simple_cnn", num_epochs=1,
                            device="cpu")

    host_calls = []
    real = native.resample_normalize_host

    def counted(*a, **kw):
        host_calls.append(1)
        return real(*a, **kw)

    monkeypatch.setattr(native, "resample_normalize_host", counted)
    n_img = sum(bool(r["has_imaging"]) for r in rows)
    for models in ("jax", "port"):
        fold = fold_checkpoints(tmp_path / models, "partial_modality")[0]
        meta = load_fold_meta(fold)
        assert meta["resample_mode"] == "host", (models, meta)
        assert meta["use_pallas_resample"] is False
        host_calls.clear()
        rs.wpass.launches = 0
        got = predict_risk(PARTIAL_MODALITY, fold, rows,
                           rnaseq_csv=paths["rnaseq_csv"],
                           labeled_only=False, device="cpu")
        assert rs.wpass.launches == 0
        assert len(host_calls) == n_img  # every CT through the host engine
        if fold.suffix == ".pt":  # JAX reads the port's fold as .msgpack
            copy = tmp_path / "msgpack" / "fold_1_best.msgpack"
            save_checkpoint(copy, load_checkpoint(fold),
                            model_name="partial_modality")
            save_fold_meta(copy, **meta)
            fold = copy
        want = jax_predict(jcfg, fold, jtable,
                           rnaseq_csv=paths["rnaseq_csv"], labeled_only=False)
        assert list(got["patient_id"]) == list(want.patient_id)
        np.testing.assert_allclose(got["risk_score"],
                                   want.risk_score.values, atol=1e-4)
