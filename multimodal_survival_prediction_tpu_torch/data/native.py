"""ctypes bindings for the host C++ engine (``csrc/msp_native.cpp``): the
port of ``multimodal_survival_prediction_tpu/data/native.py``.

The engine decodes NIfTI (gzip through zlib) and runs the fused
min/max-normalize + trilinear resample on the host, with the GIL released
for the whole call, so ``VolumePrefetcher``'s thread pool runs it on every
core. It is the port's own copy of the JAX package's source, built on first
use with the host compiler into ``build/kernels/`` (``ops/_build.py:
build_host``) under its own library name, so the JAX package's library and
this one load side by side in one process.

Where the JAX module falls back to the XLA resample when its library is
missing, this one raises: its callers check :func:`native_available` first.
:func:`read_nifti_fast` keeps JAX's per-file fallback to the pure-Python
reader for what the engine refuses (big-endian files, unsupported dtypes,
``.gz`` in a build without zlib).
"""

from __future__ import annotations

import ctypes
import logging
import os
from pathlib import Path

import numpy as np

from ..ops import _build

log = logging.getLogger(__name__)

SOURCE = Path(__file__).resolve().parents[1] / "csrc" / "msp_native.cpp"
LIB_NAME = "msp_native_port"

_lib = None  # the bound library, once built
_error: Exception | None = None  # the first failed build of this process


def build_native():
    """Build (once per source hash, compiler and CPU) and load the engine.

    Returns ``(lib, info)`` (``ops/_build.py:build_host``'s info: compiler,
    machine, ``-march=native`` CPU, ``zlib``, build seconds). A failed
    compile raises ``RuntimeError`` with the compiler's stderr."""
    global _lib
    lib, info = _build.build_host(SOURCE, LIB_NAME)
    if _lib is None:
        _bind(lib)
        _lib = lib
    return lib, info


def _load():
    """The engine, or None when it does not build here (the compiler's
    stderr logged once at WARNING)."""
    global _error
    if _lib is not None:
        return _lib
    if _error is not None:
        return None
    try:
        return build_native()[0]
    except (RuntimeError, OSError) as e:
        _error = e
        log.warning("host C++ engine unavailable: %s", e)
        return None


def _bind(lib):
    """Declare the ctypes signatures of the C ABI."""
    lib.msp_nifti_open.restype = ctypes.c_void_p
    lib.msp_nifti_open.argtypes = [
        ctypes.c_char_p, ctypes.POINTER(ctypes.c_int64),
        ctypes.POINTER(ctypes.c_float), ctypes.POINTER(ctypes.c_float)]
    lib.msp_nifti_copy.restype = ctypes.c_int
    lib.msp_nifti_copy.argtypes = [ctypes.c_void_p,
                                   ctypes.POINTER(ctypes.c_float)]
    lib.msp_nifti_open_any.restype = ctypes.c_void_p
    lib.msp_nifti_open_any.argtypes = [
        ctypes.c_char_p, ctypes.POINTER(ctypes.c_int64),
        ctypes.POINTER(ctypes.c_float), ctypes.POINTER(ctypes.c_float),
        ctypes.POINTER(ctypes.c_int32)]
    lib.msp_nifti_copy_raw.restype = ctypes.c_int
    lib.msp_nifti_copy_raw.argtypes = [
        ctypes.c_void_p, ctypes.POINTER(ctypes.c_uint8), ctypes.c_int64]
    lib.msp_nifti_close.restype = None
    lib.msp_nifti_close.argtypes = [ctypes.c_void_p]
    lib.msp_resample_normalize.restype = ctypes.c_int
    lib.msp_resample_normalize.argtypes = [
        ctypes.POINTER(ctypes.c_float),
        ctypes.c_int64, ctypes.c_int64, ctypes.c_int64,
        ctypes.POINTER(ctypes.c_float),
        ctypes.c_int64, ctypes.c_int64, ctypes.c_int64]
    lib.msp_resample_normalize_any.restype = ctypes.c_int
    lib.msp_resample_normalize_any.argtypes = [
        ctypes.c_void_p, ctypes.c_int32,
        ctypes.c_int64, ctypes.c_int64, ctypes.c_int64,
        ctypes.POINTER(ctypes.c_float),
        ctypes.c_int64, ctypes.c_int64, ctypes.c_int64,
        ctypes.c_int32, ctypes.c_float, ctypes.c_float]


def native_available() -> bool:
    """Whether the engine builds and loads here (the first call builds
    it; a failure is logged at WARNING with the compiler's stderr)."""
    return _load() is not None


# NIfTI datatype code -> numpy dtype (raw/native-dtype path)
_NIFTI_DTYPES = {2: np.uint8, 4: np.int16, 8: np.int32, 16: np.float32,
                 64: np.float64, 256: np.int8, 512: np.uint16}
# numpy dtype -> NIfTI datatype code (the native-dtype resample)
_DTYPE_CODES = {np.dtype(v): k for k, v in _NIFTI_DTYPES.items()}


def read_nifti_fast(path):
    """NIfTI -> ``NiftiImage``, through the engine when ``MSP_NATIVE_IO=1``.

    The engine decodes gzip and copies the payload with the GIL released.
    It keeps the on-disk dtype (an int16 CT: no conversion; NIfTI's
    x-fastest layout is byte-for-byte C-order (D, H, W)) when scl
    slope/inter are trivial, as the pure-Python reader does; other volumes
    come back converted to float32. A file the engine refuses is read by
    ``data.nifti.read_nifti``, which is also the default without the
    variable (as in the JAX package)."""
    from .nifti import NiftiImage, read_nifti

    lib = _load() if os.environ.get("MSP_NATIVE_IO") == "1" else None
    if lib is None:
        return read_nifti(path)
    dims = (ctypes.c_int64 * 3)()
    spacing = (ctypes.c_float * 3)()
    origin = (ctypes.c_float * 3)()
    dtype_code = ctypes.c_int32(0)
    handle = lib.msp_nifti_open_any(str(path).encode(), dims, spacing,
                                    origin, ctypes.byref(dtype_code))
    if not handle:
        return read_nifti(path)  # e.g. big-endian files
    try:
        if dtype_code.value:
            out = np.empty((dims[0], dims[1], dims[2]),
                           _NIFTI_DTYPES[dtype_code.value])
            rc = lib.msp_nifti_copy_raw(
                ctypes.c_void_p(handle),
                out.ctypes.data_as(ctypes.POINTER(ctypes.c_uint8)),
                out.nbytes)
        else:
            out = np.empty((dims[0], dims[1], dims[2]), np.float32)
            rc = lib.msp_nifti_copy(
                ctypes.c_void_p(handle),
                out.ctypes.data_as(ctypes.POINTER(ctypes.c_float)))
        if rc != 0:
            return read_nifti(path)
    finally:
        lib.msp_nifti_close(ctypes.c_void_p(handle))
    affine = np.eye(4)
    affine[0, 0], affine[1, 1], affine[2, 2] = spacing[:]
    affine[:3, 3] = origin[:]
    return NiftiImage(data=out, spacing=tuple(spacing[:]),
                      origin=tuple(origin[:]), affine=affine)


def resample_normalize_host(vol: np.ndarray, out_shape,
                            hu_window=None) -> np.ndarray:
    """The engine's fused min/max-normalize + trilinear resample, GIL-free.

    Reads the volume in its native dtype (an int16 CT never becomes a
    float32 copy) with the same optional CT Hounsfield window as the device
    path (``ops/resample.py``); the two agree within 2e-5
    (``tests/test_torch_native.py``). On a slow host-to-device link,
    resampling here and shipping the 512 KB result beats shipping the raw
    volume (``data/pipeline.py`` chooses by the measured link). Raises
    ``RuntimeError`` when the engine did not build (check
    :func:`native_available` first) and ``ValueError`` when it refuses the
    shape."""
    lib = _load()
    if lib is None:
        raise RuntimeError(f"the host C++ engine did not build: {_error}")
    vol = np.ascontiguousarray(vol)
    if vol.dtype not in _DTYPE_CODES:
        vol = vol.astype(np.float32)
    out = np.empty(tuple(out_shape), np.float32)
    lo, hi = (float(hu_window[0]), float(hu_window[1])) if hu_window else (
        0.0, 0.0)
    rc = lib.msp_resample_normalize_any(
        vol.ctypes.data_as(ctypes.c_void_p),
        _DTYPE_CODES[vol.dtype],
        *vol.shape,
        out.ctypes.data_as(ctypes.POINTER(ctypes.c_float)),
        *out.shape,
        1 if hu_window else 0, lo, hi)
    if rc != 0:
        raise ValueError(f"resample failed for shape {vol.shape} "
                         f"dtype {vol.dtype}")
    return out
