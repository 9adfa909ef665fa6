"""Fused train-mode BatchNorm -> ReLU -> 1x1x1 conv (port of
``multimodal_survival_prediction_tpu/ops/fused_dense.py``).

The DenseNet dense-layer stage 1 (``norm1 -> relu -> conv1``) and the
transition (``norm -> relu -> conv``) over the concat trunk, as two passes
over ``x`` forward and two backward, the normalized trunk never written to
device memory:

  forward   ``moments``     per-channel sum x, sum x^2 (f32)
            ``apply``       relu(x*mul + add) @ W
  backward  ``bwd_reduce``  dW = a^T g, dbeta = sum dz, dgamma = sum dz*xhat
            ``bwd_dx``      dx = mul*(dz - dbeta/N - xhat*dgamma/N)

Each of the four is a hand-written CUDA kernel (``csrc/fused_dense.cu``,
built on first use) behind a wrapper that counts its launches in
``<wrapper>.launches``. A CUDA tensor launches the kernel or raises; a CPU
tensor takes the plain torch version beside it (``moments_plain``, ...); no
build or launch is wrapped in a fallback. The kernels are float32; other
dtypes raise on the card (the bf16 variant is ROADMAP Queue 2 item 7).

Semantics are flax's ``BatchNorm(momentum=0.9, epsilon=1e-5,
use_fast_variance=True)`` in train mode followed by ReLU and a bias-free
1x1x1 conv: statistics in float32, fast variance clipped at 0, the
normalized value cast to W's dtype before the product.
:func:`bn_relu_conv1x1_reference` is the plain oracle.
:func:`fused_bn_relu_conv1x1` returns ``(out, mean, var)``; ``mean`` and
``var`` feed the running-average update only and are non-differentiable,
as the JAX VJP ignores their cotangents.

Unlike the JAX wrappers, which tile only by exact divisors of N
(``_pick_tile``), the kernels mask the ragged last tile: any N >= 1 works.
"""

from __future__ import annotations

import ctypes
import math
import threading

import torch

from . import _build

_SOURCE = "fused_dense.cu"
_GEMM_TILE = 64   # kBM = kBN in the source
_GEMM_DEPTH = 16  # kBK in the source
_MOMENT_ROWS = 256  # rows per moments block

_lock = threading.Lock()
_argtypes_set = False


# ---------------------------------------------------------------------------
# Plain torch versions (the CPU path, and the kernels' yardstick on the card)
# ---------------------------------------------------------------------------

def moments_plain(x2d: torch.Tensor):
    """``(sum x, sum x^2)`` over rows of ``x2d`` (N, C), each (C,) float32."""
    xf = x2d.to(torch.float32)
    return xf.sum(0), (xf * xf).sum(0)


def apply_plain(x2d, mul, add, w2d):
    """``relu(x*mul + add)`` cast to W's dtype, ``@ W`` -> (N, F) x.dtype."""
    a = torch.relu(x2d.to(torch.float32) * mul + add)
    return (a.to(w2d.dtype) @ w2d).to(x2d.dtype)


def bwd_reduce_plain(x2d, g, w2d, mul, add, mean, rstd):
    """``(dW (C, F), dgamma (C,), dbeta (C,))``, all float32: with z =
    x*mul + add, a = relu(z), dz = [z > 0]·(g Wᵀ), xhat = (x-mean)·rstd:
    dW = aᵀg, dbeta = Σ dz, dgamma = Σ dz·xhat."""
    xf = x2d.to(torch.float32)
    z = xf * mul + add
    a = torch.relu(z)
    dw = a.to(w2d.dtype).T.to(torch.float32) @ g.to(torch.float32)
    da = g.to(torch.float32) @ w2d.to(torch.float32).T
    dz = torch.where(z > 0, da, 0.0)
    xhat = (xf - mean) * rstd
    return dw, (dz * xhat).sum(0), dz.sum(0)


def bwd_dx_plain(x2d, g, w2d, mul, add, mean, rstd, c1, c2):
    """Train-mode BN backward ``dx = mul·(dz − c1 − xhat·c2)`` in x.dtype."""
    xf = x2d.to(torch.float32)
    z = xf * mul + add
    da = g.to(torch.float32) @ w2d.to(torch.float32).T
    dz = torch.where(z > 0, da, 0.0)
    xhat = (xf - mean) * rstd
    return (mul * (dz - c1 - xhat * c2)).to(x2d.dtype)


def bn_relu_conv1x1_reference(x2d, scale, bias, w2d, eps: float = 1e-5):
    """Plain oracle with the op's semantics (train-mode BN in float32 ->
    ReLU -> cast -> product); differentiable by torch autograd. Returns
    ``(out, mean, var)``."""
    xf = x2d.to(torch.float32)
    mean = xf.mean(0)
    var = ((xf * xf).mean(0) - mean * mean).clamp_min(0.0)
    rstd = torch.rsqrt(var + eps)
    mul = rstd * scale.to(torch.float32)
    a = torch.relu(xf * mul + (bias.to(torch.float32) - mean * mul))
    out = (a.to(x2d.dtype) @ w2d).to(x2d.dtype)
    return out, mean, var


# ---------------------------------------------------------------------------
# Kernel wrappers
# ---------------------------------------------------------------------------

def _lib():
    global _argtypes_set
    lib, _ = _build.build(_SOURCE)
    with _lock:
        if not _argtypes_set:
            p, i, ll = ctypes.c_void_p, ctypes.c_int, ctypes.c_longlong
            lib.msp_fused_moments.argtypes = [p, ll, i, ll, p, p, p]
            lib.msp_fused_apply.argtypes = [p, p, p, p, ll, ll, ll, i, i, p, p]
            lib.msp_fused_bwd_reduce.argtypes = [
                p, p, p, ll, ll, p, p, p, p, ll, i, i, ll, p, p, p, p, p]
            lib.msp_fused_bwd_dx.argtypes = [
                p, p, p, ll, ll, p, p, p, p, p, p, ll, i, i, p, p]
            for fn in (lib.msp_fused_moments, lib.msp_fused_apply,
                       lib.msp_fused_bwd_reduce, lib.msp_fused_bwd_dx):
                fn.restype = i
            lib.msp_cuda_error_string.argtypes = [i]
            lib.msp_cuda_error_string.restype = ctypes.c_char_p
            _argtypes_set = True
    return lib


def _on_card(name: str, x2d: torch.Tensor, *others) -> bool:
    """True for CUDA tensors the kernels take, False for CPU tensors (the
    plain path); raises for anything else."""
    if x2d.device.type == "cpu":
        return False
    if x2d.device.type != "cuda":
        raise ValueError(f"{name}: unsupported device {x2d.device}")
    if x2d.dim() != 2 or x2d.shape[0] == 0 or x2d.shape[1] == 0:
        raise ValueError(f"{name}: expected non-empty (N, C), got "
                         f"{tuple(x2d.shape)}")
    for t in (x2d, *others):
        if t.device != x2d.device:
            raise ValueError(f"{name}: tensors on {t.device} and {x2d.device}")
        if t.dtype != torch.float32:
            raise TypeError(f"{name}: the CUDA kernels are float32, got "
                            f"{t.dtype} (bf16: ROADMAP Queue 2 item 7)")
    if not x2d.is_contiguous():
        raise ValueError(f"{name}: x must be row-major (N, C) with C "
                         f"contiguous, got strides {x2d.stride()}")
    return True


def _check_operands(name, x2d, g, w2d):
    n, c = x2d.shape
    if w2d.dim() != 2 or w2d.shape[0] != c:
        raise ValueError(f"{name}: W must be ({c}, F), got {tuple(w2d.shape)}")
    if g is not None and tuple(g.shape) != (n, w2d.shape[1]):
        raise ValueError(f"{name}: g must be ({n}, {w2d.shape[1]}), got "
                         f"{tuple(g.shape)}")


def _vec(t: torch.Tensor, c: int) -> torch.Tensor:
    """A per-channel vector as a contiguous (C,) float32 tensor."""
    t = t.reshape(-1)
    if t.numel() != c:
        raise ValueError(f"expected a ({c},) vector, got {t.numel()} values")
    return t.contiguous()


def _check(lib, rc: int, what: str):
    if rc != 0:
        msg = lib.msp_cuda_error_string(rc).decode()
        raise RuntimeError(f"fused_dense {what} launch failed: {msg} ({rc})")


def _count(wrapper):
    with _lock:
        wrapper.launches += 1


def _stream(dev: torch.device) -> int:
    return torch.cuda.current_stream(dev).cuda_stream


def moments(x2d: torch.Tensor):
    """Per-channel ``(sum x, sum x^2)`` of ``x2d`` (N, C), each (C,) f32 —
    see :func:`moments_plain`. Kernel: one block per (256-row chunk, 32
    channels) writes partials, a second kernel folds them in a fixed
    order."""
    if not _on_card("moments", x2d):
        return moments_plain(x2d)
    n, c = x2d.shape
    chunks = math.ceil(n / _MOMENT_ROWS)
    part = torch.empty((chunks, 2 * c), dtype=torch.float32,
                       device=x2d.device)
    out = torch.empty(2 * c, dtype=torch.float32, device=x2d.device)
    lib = _lib()
    with torch.cuda.device(x2d.device):
        rc = lib.msp_fused_moments(x2d.data_ptr(), n, c, _MOMENT_ROWS,
                                   part.data_ptr(), out.data_ptr(),
                                   _stream(x2d.device))
    _check(lib, rc, "moments")
    _count(moments)
    return out[:c], out[c:]


def apply(x2d, mul, add, w2d):
    """``relu(x*mul + add) @ W`` -> (N, F) — see :func:`apply_plain`.
    ``w2d`` (C, F) may be any strided view (the conv kernel's transpose)."""
    if not _on_card("apply", x2d, mul, add, w2d):
        return apply_plain(x2d, mul, add, w2d)
    _check_operands("apply", x2d, None, w2d)
    n, c = x2d.shape
    f = w2d.shape[1]
    mul, add = _vec(mul, c), _vec(add, c)
    out = torch.empty((n, f), dtype=torch.float32, device=x2d.device)
    lib = _lib()
    with torch.cuda.device(x2d.device):
        rc = lib.msp_fused_apply(
            x2d.data_ptr(), mul.data_ptr(), add.data_ptr(), w2d.data_ptr(),
            w2d.stride(0), w2d.stride(1), n, c, f, out.data_ptr(),
            _stream(x2d.device))
    _check(lib, rc, "apply")
    _count(apply)
    return out


def _dw_rows_per_chunk(n: int, c: int, f: int, device) -> int:
    """Rows per dW partial: enough chunks for about two blocks per SM, each
    a multiple of the kernel's K step."""
    tiles = math.ceil(c / _GEMM_TILE) * math.ceil(f / _GEMM_TILE)
    sms = torch.cuda.get_device_properties(device).multi_processor_count
    chunks = max(1, math.ceil(2 * sms / tiles))
    rows = math.ceil(n / chunks)
    return math.ceil(rows / _GEMM_DEPTH) * _GEMM_DEPTH


def bwd_reduce(x2d, g, w2d, mul, add, mean, rstd):
    """``(dW (C, F), dgamma (C,), dbeta (C,))`` — see
    :func:`bwd_reduce_plain`. Kernels: dW partials per row chunk, dbeta /
    dgamma partials per 64-row tile from the product g Wᵀ, both folded in a
    fixed order (no atomics)."""
    if not _on_card("bwd_reduce", x2d, g, w2d, mul, add, mean, rstd):
        return bwd_reduce_plain(x2d, g, w2d, mul, add, mean, rstd)
    _check_operands("bwd_reduce", x2d, g, w2d)
    n, c = x2d.shape
    f = w2d.shape[1]
    g = g.contiguous()
    mul, add, mean, rstd = (_vec(t, c) for t in (mul, add, mean, rstd))
    dev = x2d.device
    rows = _dw_rows_per_chunk(n, c, f, dev)
    chunks = math.ceil(n / rows)
    part_dw = torch.empty((chunks, c, f), dtype=torch.float32, device=dev)
    part_bg = torch.empty((math.ceil(n / _GEMM_TILE), 2 * c),
                          dtype=torch.float32, device=dev)
    dw = torch.empty((c, f), dtype=torch.float32, device=dev)
    dbg = torch.empty(2 * c, dtype=torch.float32, device=dev)
    lib = _lib()
    with torch.cuda.device(dev):
        rc = lib.msp_fused_bwd_reduce(
            x2d.data_ptr(), g.data_ptr(), w2d.data_ptr(), w2d.stride(0),
            w2d.stride(1), mul.data_ptr(), add.data_ptr(), mean.data_ptr(),
            rstd.data_ptr(), n, c, f, rows, part_dw.data_ptr(),
            part_bg.data_ptr(), dw.data_ptr(), dbg.data_ptr(), _stream(dev))
    _check(lib, rc, "bwd_reduce")
    _count(bwd_reduce)
    return dw, dbg[c:], dbg[:c]


def bwd_dx(x2d, g, w2d, mul, add, mean, rstd, c1, c2):
    """``dx (N, C) = mul·(dz − c1 − xhat·c2)`` — see :func:`bwd_dx_plain`.
    Kernel: the product g Wᵀ with the BN backward as its epilogue."""
    if not _on_card("bwd_dx", x2d, g, w2d, mul, add, mean, rstd, c1, c2):
        return bwd_dx_plain(x2d, g, w2d, mul, add, mean, rstd, c1, c2)
    _check_operands("bwd_dx", x2d, g, w2d)
    n, c = x2d.shape
    f = w2d.shape[1]
    g = g.contiguous()
    mul, add, mean, rstd, c1, c2 = (
        _vec(t, c) for t in (mul, add, mean, rstd, c1, c2))
    dx = torch.empty((n, c), dtype=torch.float32, device=x2d.device)
    lib = _lib()
    with torch.cuda.device(x2d.device):
        rc = lib.msp_fused_bwd_dx(
            x2d.data_ptr(), g.data_ptr(), w2d.data_ptr(), w2d.stride(0),
            w2d.stride(1), mul.data_ptr(), add.data_ptr(), mean.data_ptr(),
            rstd.data_ptr(), c1.data_ptr(), c2.data_ptr(), n, c, f,
            dx.data_ptr(), _stream(x2d.device))
    _check(lib, rc, "bwd_dx")
    _count(bwd_dx)
    return dx


moments.launches = 0
apply.launches = 0
bwd_reduce.launches = 0
bwd_dx.launches = 0
KERNELS = (moments, apply, bwd_reduce, bwd_dx)


def reset_launches():
    """Set every kernel's launch count to 0."""
    with _lock:
        for k in KERNELS:
            k.launches = 0


# ---------------------------------------------------------------------------
# The fused op
# ---------------------------------------------------------------------------

def _check_dtypes(x2d, w2d):
    # apply casts the normalized activations to W's dtype while the oracle
    # casts to x's: one compute dtype keeps the two equivalent
    if x2d.dtype != w2d.dtype:
        raise TypeError(
            f"fused_bn_relu_conv1x1 requires x and W in the same compute "
            f"dtype, got x={x2d.dtype} W={w2d.dtype}; cast both at the call "
            "site")


def _stats(x2d, scale, bias, eps):
    """``(mean, var, rstd, mul, add)`` (C,) float32 from the moments: fast
    variance clipped at 0, ``mul = rstd·γ``, ``add = β − mean·mul``."""
    n = x2d.shape[0]
    s, sq = moments(x2d)
    mean = s / n
    var = (sq / n - mean * mean).clamp_min(0.0)
    rstd = torch.rsqrt(var + eps)
    mul = rstd * scale.to(torch.float32)
    add = bias.to(torch.float32) - mean * mul
    return mean, var, rstd, mul, add


class _FusedBnReluConv1x1(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x2d, scale, bias, w2d, eps):
        _check_dtypes(x2d, w2d)
        mean, var, rstd, mul, add = _stats(x2d, scale, bias, eps)
        out = apply(x2d, mul, add, w2d)
        ctx.save_for_backward(x2d, w2d, mul, add, mean, rstd)
        ctx.mark_non_differentiable(mean, var)
        return out, mean, var

    @staticmethod
    def backward(ctx, g_out, _g_mean, _g_var):
        # mean/var feed the running-average update only: their cotangents
        # are ignored (the JAX VJP at ops/fused_dense.py:309)
        x2d, w2d, mul, add, mean, rstd = ctx.saved_tensors
        n = x2d.shape[0]
        g = g_out.to(x2d.dtype)
        dw, dg, db = bwd_reduce(x2d, g, w2d, mul, add, mean, rstd)
        dx = None
        if ctx.needs_input_grad[0]:
            # dx = r·γ·(dz − Σdz/N − xhat·Σdz·xhat/N)
            dx = bwd_dx(x2d, g, w2d, mul, add, mean, rstd, db / n, dg / n)
        return dx, dg, db, dw.to(w2d.dtype), None


def fused_bn_relu_conv1x1(x2d, scale, bias, w2d, eps: float = 1e-5):
    """Train-mode ``relu(batch_norm(x)) @ W`` in two passes over ``x``.

    Args:
      x2d: (N, C) activations, C contiguous (the channels-last trunk viewed
        as rows).
      scale, bias: (C,) BN γ and β.
      w2d: (C, F) conv kernel in x's dtype; any strides.
      eps: BN epsilon.

    Returns ``(out (N, F) in x.dtype, mean (C,), var (C,))``; mean/var are
    float32 and non-differentiable."""
    return _FusedBnReluConv1x1.apply(x2d, scale, bias, w2d, eps)
