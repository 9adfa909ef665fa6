"""CT preprocessing: (optional HU clip,) min-max normalize + trilinear
resample to the fixed training shape — the port of
``multimodal_survival_prediction_tpu/ops/resample.py``.

scipy's order-1 zoom (align-corners) is three small dense contractions with
interpolation matrices R_axis (out, in), two non-zeros per row; the min-max
normalize commutes with them (rows of R sum to 1), so it is a scale/shift
epilogue ``v*scale - mn*scale`` with ``scale = 1/(mx-mn+1e-8)`` — kept in
exactly that form, as in the reference.

Three entry points, each with ``device="cuda"`` by default:
  * ``resample_normalize``: plain torch, the counterpart of the XLA einsum
    chain (``_resample_normalize_xla``).
  * ``resample_normalize_cuda``: the counterpart of
    ``resample_normalize_pallas``. Its expensive pass — one read of the
    volume computing min/max and the W contraction — is the hand-written
    kernel ``csrc/resample_wpass.cu`` behind :func:`wpass`; the H and D
    contractions and the epilogue stay torch, as they stay XLA there.
  * ``resample_normalize_bucketed``: the shape-bucketed path the ingest
    pipeline and the server use without the kernel (padded volume, matrices
    zero beyond the true extent, masked min/max).

All contractions run in true fp32 (the reference contracts at
``precision="highest"``); on the card that needs
``torch.backends.cuda.matmul.allow_tf32 = False``, PyTorch's default.
"""

from __future__ import annotations

import ctypes
import math
import threading
from functools import lru_cache

import numpy as np
import torch

from ..utils.device import resolve_device
from . import _build

# dtypes the kernel reads natively (csrc/resample_wpass.cu `dtype` codes)
_KERNEL_DTYPES = {torch.int8: 0, torch.uint8: 1, torch.int16: 2,
                  torch.int32: 3, torch.float32: 4}
_WARPS = 8  # rows in flight per block; must equal kWarps in the source
_SMEM_LIMIT = 232448  # bytes of shared memory one block may use on sm_90


def linear_interp_matrix(in_size: int, out_size: int) -> np.ndarray:
    """(out, in) matrix M with M @ x == scipy.ndimage.zoom(x, out/in, order=1)."""
    m = np.zeros((out_size, in_size), np.float32)
    if in_size == 1:
        m[:, 0] = 1.0
        return m
    if out_size == 1:
        m[0, 0] = 1.0
        return m
    coords = np.arange(out_size) * (in_size - 1) / (out_size - 1)
    lo = np.floor(coords).astype(np.int64)
    lo = np.clip(lo, 0, in_size - 2)
    frac = (coords - lo).astype(np.float32)
    m[np.arange(out_size), lo] = 1.0 - frac
    m[np.arange(out_size), lo + 1] = frac
    return m


@lru_cache(maxsize=64)
def two_taps(in_size: int, out_size: int):
    """The W contraction as a two-tap gather: ``(tap0, tap1, w0, w1)`` with
    ``M[o] == w0[o]*e[tap0[o]] + w1[o]*e[tap1[o]]`` exactly, for
    ``M = linear_interp_matrix(in_size, out_size)``. The weights are the
    matrix's own entries, so the gather drops only exact-zero terms.
    Read-only arrays (they are cached)."""
    m = linear_interp_matrix(in_size, out_size)
    rows = np.arange(out_size)
    tap0 = (m != 0).argmax(axis=1).astype(np.int32)
    tap1 = np.minimum(tap0 + 1, in_size - 1).astype(np.int32)
    w0 = m[rows, tap0]
    w1 = np.where(tap1 != tap0, m[rows, tap1], 0.0).astype(np.float32)
    dense = np.zeros_like(m)
    dense[rows, tap0] += w0
    dense[rows, tap1] += w1
    if not np.array_equal(dense, m):  # interpolation rows have <= 2 taps
        raise AssertionError("interpolation matrix is not two-tap")
    out = (tap0, tap1, w0, w1)
    for a in out:
        a.setflags(write=False)
    return out


def _as_tensor(vol, device: torch.device) -> torch.Tensor:
    """A volume (numpy or torch) as a tensor on ``device`` in its native
    dtype where torch has one: numpy uint16/uint32 widen losslessly to
    int32/int64, non-native byte order is swapped, on the host."""
    if isinstance(vol, torch.Tensor):
        return vol.to(device)
    a = np.asarray(vol)
    if a.dtype == np.uint16:
        a = a.astype(np.int32)
    elif a.dtype == np.uint32:
        a = a.astype(np.int64)
    a = np.ascontiguousarray(a, dtype=a.dtype.newbyteorder("="))
    return torch.from_numpy(a).to(device)


@lru_cache(maxsize=128)
def _matrix(in_size: int, out_size: int, device: torch.device) -> torch.Tensor:
    """``linear_interp_matrix`` as a read-only tensor on ``device``, made
    once per shape and device (a copy from pageable host memory to the card
    would wait for the stream on every call)."""
    return torch.from_numpy(linear_interp_matrix(in_size, out_size)).to(device)


@lru_cache(maxsize=128)
def _taps(in_size: int, out_size: int, device: torch.device):
    """The kernel's read-only ``(tap0, tap1, w0, w1)`` tensors on
    ``device``, made once per shape and device."""
    return tuple(torch.from_numpy(a.copy()).to(device)
                 for a in two_taps(in_size, out_size))


def resample_normalize(vol, out_shape=(64, 64, 32), hu_window=None,
                       device="cuda") -> torch.Tensor:
    """(D,H,W) volume -> ``out_shape`` float32 tensor on ``device``:
    (optionally HU-windowed,) min-max normalized, trilinearly resampled.
    Plain torch; the counterpart of the JAX ``resample_normalize``."""
    dev = resolve_device(device)
    v = _as_tensor(vol, dev).to(torch.float32)
    d, h, w = v.shape
    do, ho, wo = out_shape
    if hu_window is not None:
        v = v.clamp(hu_window[0], hu_window[1])
    mn = v.amin()
    mx = v.amax()
    scale = 1.0 / (mx - mn + 1e-8)
    # contract W first (largest shrink comes earliest)
    v = torch.einsum("zhw,ow->zho", v, _matrix(w, wo, dev))
    v = torch.einsum("zho,ph->zpo", v, _matrix(h, ho, dev))
    v = torch.einsum("zpo,qz->qpo", v, _matrix(d, do, dev))
    return v * scale - mn * scale


# ---------------------------------------------------------------------------
# The W-pass: kernel on the card, plain torch on the CPU
# ---------------------------------------------------------------------------

def wpass_plain(rows: torch.Tensor, out_w: int, hu_window=None):
    """Plain version of the W-pass: ``rows`` (R, W) in any real dtype ->
    ``((R, out_w) f32, min, max)``, the rows converted to f32, HU-clipped if
    asked, contracted with ``linear_interp_matrix(W, out_w)ᵀ``."""
    v = rows.to(torch.float32)
    if hu_window is not None:
        v = v.clamp(hu_window[0], hu_window[1])
    rx_t = _matrix(rows.shape[1], out_w, rows.device).T
    return v @ rx_t, v.amin(), v.amax()


_wpass_lock = threading.Lock()
_argtypes_set = False


def _wpass_lib():
    global _argtypes_set
    lib, _ = _build.build("resample_wpass.cu")
    with _wpass_lock:
        if not _argtypes_set:
            p, i, f = ctypes.c_void_p, ctypes.c_int, ctypes.c_float
            lib.msp_resample_wpass.argtypes = [
                p, i, ctypes.c_longlong, i, p, p, p, p, i, i, f, f,
                p, p, p, i, p, p, p]
            lib.msp_resample_wpass.restype = i
            lib.msp_cuda_error_string.argtypes = [i]
            lib.msp_cuda_error_string.restype = ctypes.c_char_p
            _argtypes_set = True
    return lib


def wpass(rows: torch.Tensor, out_w: int, hu_window=None):
    """The W-pass of the fused resample: ``rows`` (R, W) -> ``((R, out_w)
    f32, min, max)`` — see :func:`wpass_plain` for the function.

    A CUDA tensor launches ``csrc/resample_wpass.cu`` (built on first use)
    and counts one in ``wpass.launches``; a CPU tensor takes
    :func:`wpass_plain`; any other device raises. The kernel reads int8,
    uint8, int16, int32 and float32 natively; any other dtype is converted
    to float32 on the device first, as the JAX wrapper does for float64.
    No fallback: a failed build or launch raises."""
    if rows.device.type == "cpu":
        return wpass_plain(rows, out_w, hu_window)
    if rows.device.type != "cuda":
        raise ValueError(f"wpass: unsupported device {rows.device}")
    if rows.dim() != 2 or rows.shape[0] == 0 or rows.shape[1] == 0:
        raise ValueError(f"wpass: expected non-empty (R, W), got "
                         f"{tuple(rows.shape)}")
    if rows.dtype not in _KERNEL_DTYPES:
        rows = rows.to(torch.float32)
    rows = rows.contiguous()
    n_rows, w = rows.shape
    smem = _WARPS * w * 4 + out_w * 16
    if smem > _SMEM_LIMIT:
        raise ValueError(f"wpass: W={w} needs {smem} bytes of shared memory "
                         f"(limit {_SMEM_LIMIT})")
    lib = _wpass_lib()
    dev = rows.device
    tap0, tap1, w0, w1 = _taps(w, out_w, dev)
    out = torch.empty((n_rows, out_w), dtype=torch.float32, device=dev)
    sms = torch.cuda.get_device_properties(dev).multi_processor_count
    grid = max(1, min(math.ceil(n_rows / _WARPS), sms * 8))
    part = torch.empty((2, grid), dtype=torch.float32, device=dev)
    mnmx = torch.empty(2, dtype=torch.float32, device=dev)
    clip = hu_window is not None
    lo, hi = (float(hu_window[0]), float(hu_window[1])) if clip else (0.0, 0.0)
    with torch.cuda.device(dev):
        stream = torch.cuda.current_stream(dev).cuda_stream
        rc = lib.msp_resample_wpass(
            rows.data_ptr(), _KERNEL_DTYPES[rows.dtype], n_rows, w,
            tap0.data_ptr(), tap1.data_ptr(), w0.data_ptr(), w1.data_ptr(),
            out_w, int(clip), lo, hi, out.data_ptr(), part[0].data_ptr(),
            part[1].data_ptr(), grid, mnmx[0].data_ptr(), mnmx[1].data_ptr(),
            stream)
    if rc != 0:
        msg = lib.msp_cuda_error_string(rc).decode()
        raise RuntimeError(f"resample_wpass launch failed: {msg} ({rc})")
    with _wpass_lock:
        wpass.launches += 1
    return out, mnmx[0], mnmx[1]


wpass.launches = 0


def resample_normalize_cuda(vol, out_shape=(64, 64, 32), hu_window=None,
                            device="cuda") -> torch.Tensor:
    """Fused version of :func:`resample_normalize` — the counterpart of the
    JAX ``resample_normalize_pallas``. The volume goes to ``device`` in its
    native dtype (an int16 CT moves half the bytes of a float32 one) and
    the W-pass kernel converts it in registers; the H and D contractions and
    the epilogue follow in torch, as at ops/resample.py:175-179 there. On
    ``device="cpu"`` the W-pass is its plain version."""
    dev = resolve_device(device)
    t = _as_tensor(vol, dev)
    d, h, w = t.shape
    do, ho, wo = out_shape
    tmp, mn, mx = wpass(t.reshape(d * h, w), wo, hu_window)
    v = tmp.view(d, h, wo)
    v = torch.einsum("zho,ph->zpo", v, _matrix(h, ho, dev))
    v = torch.einsum("zpo,qz->qpo", v, _matrix(d, do, dev))
    scale = 1.0 / (mx - mn + 1e-8)
    return v * scale - mn * scale


# ---------------------------------------------------------------------------
# Shape-bucketed resample (plain torch)
# ---------------------------------------------------------------------------

def bucket_shape(shape, granularity=(32, 64, 64)):
    """Round each dim up to its granularity multiple."""
    return tuple(-(-s // g) * g for s, g in zip(shape, granularity))


def resample_normalize_bucketed(vol, out_shape=(64, 64, 32),
                                granularity=(32, 64, 64), hu_window=None,
                                device="cuda") -> torch.Tensor:
    """Shape-bucketed resample+normalize, equal to the exact-shape path.

    The volume is zero-padded into its shape bucket; the interpolation
    matrices are zero beyond the true extent, so the contraction ignores the
    padding exactly, and min/max are masked to the valid region (clipping
    the padding for ``hu_window`` is harmless for the same reason). Eager
    torch compiles nothing per shape; the bucketing is kept so this path
    computes what the JAX bucketed path computes."""
    dev = resolve_device(device)
    t = _as_tensor(vol, dev)
    d, h, w = t.shape
    pd_, ph, pw = bucket_shape(t.shape, granularity)
    mats = []
    for size, padded_size, out in ((d, pd_, out_shape[0]),
                                   (h, ph, out_shape[1]),
                                   (w, pw, out_shape[2])):
        m = np.zeros((out, padded_size), np.float32)
        m[:, :size] = linear_interp_matrix(size, out)
        mats.append(torch.from_numpy(m).to(dev))
    rz, ry, rx = mats
    v = torch.zeros((pd_, ph, pw), dtype=torch.float32, device=dev)
    v[:d, :h, :w] = t.to(torch.float32)
    if hu_window is not None:
        v = v.clamp(hu_window[0], hu_window[1])
    valid = torch.zeros((pd_, ph, pw), dtype=torch.bool, device=dev)
    valid[:d, :h, :w] = True
    mn = torch.where(valid, v, math.inf).amin()
    mx = torch.where(valid, v, -math.inf).amax()
    scale = 1.0 / (mx - mn + 1e-8)
    v = torch.einsum("zhw,ow->zho", v, rx)
    v = torch.einsum("zho,ph->zpo", v, ry)
    v = torch.einsum("zpo,qz->qpo", v, rz)
    return v * scale - mn * scale
