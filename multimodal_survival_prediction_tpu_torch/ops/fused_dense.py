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

The three products (``apply``, and the two of the backward) run on the
tensor cores as 3xTF32 splits, which keep fp32 accuracy
(:func:`matmul_3xtf32_plain` emulates the split in plain torch). Their
launch plan — 64x128 or 64x64 block tiles, how many K chunks share a
contraction — is plain Python, :func:`launch_plan`, a function of
``(n, c, f)`` and the card's SM count only.

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
import functools
import math
import threading
from typing import NamedTuple

import torch

from . import _build

_SOURCE = "fused_dense.cu"
_TILE_ROWS = 64   # kBM in the source: rows of a GEMM block tile
_TILE_COLS = (128, 64)  # 32 NT in the source: the wide and the narrow tile
_K_STEP = 16      # kBK in the source
_MAX_K = 1024     # kMaxK in the source: most channels one apply block takes
_MOMENT_ROWS = 256  # rows per moments block
_MAX_CLUSTER = 8  # kMaxCluster in the source: bwd_dx's most F chunks

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


def round_tf32_plain(v: torch.Tensor) -> torch.Tensor:
    """float32 rounded to TF32 (10 mantissa bits), to nearest with ties away
    from zero, as ``cvt.rna.tf32.f32`` rounds."""
    bits = v.contiguous().view(torch.int32)
    return ((bits + 0x1000) & ~0x1FFF).view(torch.float32)


def matmul_3xtf32_plain(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """``a @ b`` as the kernels' tensor-core product computes it: each fp32
    operand split into ``big = tf32(v)`` and ``small = tf32(v - big)`` (the
    tensor core reads the remainder's leading 10 mantissa bits; here it is
    rounded), the three products big·big + big·small + small·big (each exact
    in fp32: two 11-bit significands) summed in float32."""
    a_big = round_tf32_plain(a)
    a_small = round_tf32_plain(a - a_big)
    b_big = round_tf32_plain(b)
    b_small = round_tf32_plain(b - b_big)
    return a_big @ b_big + a_big @ b_small + a_small @ b_big


# ---------------------------------------------------------------------------
# The launch plan
# ---------------------------------------------------------------------------

class LaunchPlan(NamedTuple):
    """How the three products of one (n, c, f) stage are launched.

    ``*_tile_cols`` is the block tile's width (its height is 64).
    ``apply`` contracts the channels in ``apply_chunks`` chunks of
    ``apply_k_per_chunk`` (the last may be short); with more than one chunk
    it writes ``apply_scratch`` floats of partial outputs, folded in
    ascending order. The dW product splits the rows the same way. The
    product g Wᵀ takes 64x64 tiles in ``bwd_reduce`` and is split over F
    there (``da_chunks`` of ``da_k_per_chunk``). ``bwd_dx`` takes tiles
    ``dx_tile_cols`` wide and splits F too (``dx_chunks`` of
    ``dx_k_per_chunk``, at most 8): its epilogue is affine in g Wᵀ (the
    mask [z > 0] depends on x alone), so the F chunks of a tile are the
    blocks of one thread-block cluster, which sum their partial products in
    ascending order before the mask and the BN backward run once; one chunk
    is the unsplit launch. ``reduce_scratch`` holds the dW partials and then
    the dbeta/dgamma partials of every (64-row tile, F chunk)."""
    apply_tile_cols: int
    apply_chunks: int
    apply_k_per_chunk: int
    apply_scratch: int
    dw_tile_cols: int
    dw_chunks: int
    dw_rows_per_chunk: int
    dx_tile_cols: int
    dx_chunks: int
    dx_k_per_chunk: int
    da_chunks: int
    da_k_per_chunk: int
    reduce_scratch: int


def _split(steps: int, tiles: int, sm_count: int, max_steps=None,
           max_chunks=None, blocks_per_sm=2):
    """``(chunks, steps per chunk)``: a contraction of ``steps`` K steps
    whose ``tiles`` output tiles leave SMs idle is split until there are
    about ``blocks_per_sm`` blocks per SM, and no more, so that all of them
    are resident at once (into at most ``max_chunks``); one that fills the
    card is not split."""
    want = 1 if tiles >= sm_count else max(
        1, blocks_per_sm * sm_count // tiles)
    if max_chunks is not None:
        want = min(want, max_chunks)
    per_chunk = math.ceil(steps / want)
    if max_steps is not None:
        per_chunk = min(per_chunk, max_steps)
    return math.ceil(steps / per_chunk), per_chunk


@functools.lru_cache(maxsize=None)
def launch_plan(n: int, c: int, f: int, sm_count: int) -> LaunchPlan:
    """The launch plan of a stage with ``n`` rows, ``c`` channels in and
    ``f`` out on a card with ``sm_count`` SMs. A product takes the wide
    64x128 tile (one column tile at F = 128) when that alone puts a block
    on every SM; otherwise the narrow 64x64 tile, and if that still leaves
    SMs idle its contraction is split into chunks of whole K steps until
    there are about two blocks per SM (``apply`` over the channels, dW over
    the rows). ``bwd_reduce`` runs dW and g Wᵀ in one launch, g Wᵀ always in
    narrow tiles, split over F while they leave SMs idle. ``bwd_dx`` splits
    F into at most one cluster's 8 blocks, up to one block per SM: its
    clusters must sit whole inside one group of SMs, so fewer of them than
    two blocks per SM would suggest are resident at once, and a launch of
    two blocks per SM ran part of its clusters in a second wave."""
    wide, narrow = _TILE_COLS
    row_tiles = math.ceil(n / _TILE_ROWS)
    c_steps, n_steps = math.ceil(c / _K_STEP), math.ceil(n / _K_STEP)

    tiles = row_tiles * math.ceil(f / wide)
    apply_cols = wide
    if tiles < sm_count:
        apply_cols, tiles = narrow, row_tiles * math.ceil(f / narrow)
    apply_chunks, k_steps = _split(c_steps, tiles, sm_count,
                                   _MAX_K // _K_STEP)

    tiles = math.ceil(c / _TILE_ROWS) * math.ceil(f / wide)
    dw_cols = wide
    if tiles * n_steps < 2 * sm_count:
        dw_cols = narrow
        tiles = math.ceil(c / _TILE_ROWS) * math.ceil(f / narrow)
    dw_chunks, row_steps = _split(n_steps, tiles, sm_count)

    dx_cols = wide if row_tiles * math.ceil(c / wide) >= sm_count else narrow
    dx_chunks, dx_steps = _split(math.ceil(f / _K_STEP),
                                 row_tiles * math.ceil(c / dx_cols), sm_count,
                                 max_chunks=_MAX_CLUSTER, blocks_per_sm=1)
    da_chunks, f_steps = _split(math.ceil(f / _K_STEP),
                                row_tiles * math.ceil(c / narrow), sm_count)
    return LaunchPlan(
        apply_tile_cols=apply_cols, apply_chunks=apply_chunks,
        apply_k_per_chunk=k_steps * _K_STEP,
        apply_scratch=apply_chunks * n * f if apply_chunks > 1 else 0,
        dw_tile_cols=dw_cols, dw_chunks=dw_chunks,
        dw_rows_per_chunk=row_steps * _K_STEP, dx_tile_cols=dx_cols,
        dx_chunks=dx_chunks, dx_k_per_chunk=dx_steps * _K_STEP,
        da_chunks=da_chunks, da_k_per_chunk=f_steps * _K_STEP,
        reduce_scratch=(dw_chunks * c * f
                        + row_tiles * da_chunks * 2 * c))


@functools.lru_cache(maxsize=None)
def _sm_count(device: torch.device) -> int:
    return torch.cuda.get_device_properties(device).multi_processor_count


def _plan_for(x2d: torch.Tensor, f: int) -> LaunchPlan:
    return launch_plan(x2d.shape[0], x2d.shape[1], f, _sm_count(x2d.device))


def _apply_buffers(plan: LaunchPlan, n: int, f: int, device):
    """``(out (n, f), scratch)`` for one ``apply`` launch."""
    out = torch.empty((n, f), dtype=torch.float32, device=device)
    part = torch.empty(plan.apply_scratch, dtype=torch.float32, device=device)
    return out, part


def _reduce_buffers(plan: LaunchPlan, c: int, f: int, device):
    """``(out, scratch)`` for one ``bwd_reduce`` launch; ``out`` holds dW
    (c, f), then dbeta (c), then dgamma (c)."""
    out = torch.empty(c * f + 2 * c, dtype=torch.float32, device=device)
    part = torch.empty(plan.reduce_scratch, dtype=torch.float32,
                       device=device)
    return out, part


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
            lib.msp_fused_apply.argtypes = [
                p, p, p, p, ll, ll, ll, i, i, i, i, p, p, p]
            lib.msp_fused_bwd_reduce.argtypes = [
                p, p, p, ll, ll, p, p, p, p, ll, i, i, i, ll, i, p, p, p]
            lib.msp_fused_bwd_dx.argtypes = [
                p, p, p, ll, ll, p, p, p, p, p, p, ll, i, i, i, i, p, p]
            lib.msp_fused_bwd_dx_max_clusters.argtypes = [
                ll, i, i, i, i, ctypes.POINTER(i)]
            for fn in (lib.msp_fused_moments, lib.msp_fused_apply,
                       lib.msp_fused_bwd_reduce, lib.msp_fused_bwd_dx,
                       lib.msp_fused_bwd_dx_max_clusters):
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
    ``w2d`` (C, F) may be any strided view (the conv kernel's transpose).
    Kernel: a pipelined 3xTF32 tensor-core product with the BN + ReLU as
    its prologue; a small grid splits the channels into chunks whose partial
    outputs a second kernel folds in ascending order (no atomics)."""
    if not _on_card("apply", x2d, mul, add, w2d):
        return apply_plain(x2d, mul, add, w2d)
    _check_operands("apply", x2d, None, w2d)
    n, c = x2d.shape
    f = w2d.shape[1]
    mul, add = _vec(mul, c), _vec(add, c)
    dev = x2d.device
    plan = _plan_for(x2d, f)
    out, part = _apply_buffers(plan, n, f, dev)
    lib = _lib()
    with torch.cuda.device(dev):
        rc = lib.msp_fused_apply(
            x2d.data_ptr(), mul.data_ptr(), add.data_ptr(), w2d.data_ptr(),
            w2d.stride(0), w2d.stride(1), n, c, f, plan.apply_tile_cols,
            plan.apply_k_per_chunk, part.data_ptr(), out.data_ptr(),
            _stream(dev))
    _check(lib, rc, "apply")
    _count(apply)
    return out


def bwd_reduce(x2d, g, w2d, mul, add, mean, rstd):
    """``(dW (C, F), dgamma (C,), dbeta (C,))`` — see
    :func:`bwd_reduce_plain`. Kernels: one launch writes dW partials per
    row chunk and dbeta / dgamma partials per 64-row tile from the product
    g Wᵀ into one scratch buffer, a second folds it in a fixed order (no
    atomics)."""
    if not _on_card("bwd_reduce", x2d, g, w2d, mul, add, mean, rstd):
        return bwd_reduce_plain(x2d, g, w2d, mul, add, mean, rstd)
    _check_operands("bwd_reduce", x2d, g, w2d)
    n, c = x2d.shape
    f = w2d.shape[1]
    g = g.contiguous()
    mul, add, mean, rstd = (_vec(t, c) for t in (mul, add, mean, rstd))
    dev = x2d.device
    plan = _plan_for(x2d, f)
    out, part = _reduce_buffers(plan, c, f, dev)
    lib = _lib()
    with torch.cuda.device(dev):
        rc = lib.msp_fused_bwd_reduce(
            x2d.data_ptr(), g.data_ptr(), w2d.data_ptr(), w2d.stride(0),
            w2d.stride(1), mul.data_ptr(), add.data_ptr(), mean.data_ptr(),
            rstd.data_ptr(), n, c, f, plan.dw_tile_cols,
            plan.dw_rows_per_chunk, plan.da_k_per_chunk, part.data_ptr(),
            out.data_ptr(), _stream(dev))
    _check(lib, rc, "bwd_reduce")
    _count(bwd_reduce)
    dbeta, dgamma = out[c * f:c * f + c], out[c * f + c:]
    return out[:c * f].view(c, f), dgamma, dbeta


def bwd_dx(x2d, g, w2d, mul, add, mean, rstd, c1, c2):
    """``dx (N, C) = mul·(dz − c1 − xhat·c2)`` — see :func:`bwd_dx_plain`.
    Kernel: the product g Wᵀ (the mainloop it shares with ``bwd_reduce``)
    with the BN backward as its epilogue, one launch; where the grid leaves
    SMs idle, F is split across the blocks of a thread-block cluster whose
    partial products are summed in a fixed order in shared memory."""
    if not _on_card("bwd_dx", x2d, g, w2d, mul, add, mean, rstd, c1, c2):
        return bwd_dx_plain(x2d, g, w2d, mul, add, mean, rstd, c1, c2)
    _check_operands("bwd_dx", x2d, g, w2d)
    plan = _plan_for(x2d, w2d.shape[1])
    dx = _launch_bwd_dx(x2d, g, w2d, (mul, add, mean, rstd, c1, c2),
                        plan.dx_tile_cols, plan.dx_k_per_chunk)
    _count(bwd_dx)
    return dx


def _launch_bwd_dx(x2d, g, w2d, vecs, tile_cols: int, k_per_chunk: int):
    """One launch of the ``bwd_dx`` kernel on CUDA tensors at the given tile
    width and F chunk (``k_per_chunk`` >= F: the unsplit launch), without
    counting it; :func:`bwd_dx` passes its plan's. ``vecs`` is ``(mul, add,
    mean, rstd, c1, c2)``."""
    n, c = x2d.shape
    f = w2d.shape[1]
    g = g.contiguous()
    vecs = [_vec(t, c) for t in vecs]
    dx = torch.empty((n, c), dtype=torch.float32, device=x2d.device)
    lib = _lib()
    with torch.cuda.device(x2d.device):
        rc = lib.msp_fused_bwd_dx(
            x2d.data_ptr(), g.data_ptr(), w2d.data_ptr(), w2d.stride(0),
            w2d.stride(1), *(v.data_ptr() for v in vecs), n, c, f, tile_cols,
            k_per_chunk, dx.data_ptr(), _stream(x2d.device))
    _check(lib, rc, "bwd_dx")
    return dx


def bwd_dx_max_clusters(x2d: torch.Tensor, w2d: torch.Tensor):
    """How many clusters of :func:`bwd_dx`'s planned launch for ``x2d`` (N,
    C) and ``w2d`` (C, F) the card keeps resident at once
    (``cudaOccupancyMaxActiveClusters``), or None where the plan does not
    split F."""
    plan = _plan_for(x2d, w2d.shape[1])
    if plan.dx_chunks == 1:
        return None
    lib = _lib()
    out = ctypes.c_int(0)
    with torch.cuda.device(x2d.device):
        rc = lib.msp_fused_bwd_dx_max_clusters(
            x2d.shape[0], x2d.shape[1], w2d.shape[1], plan.dx_k_per_chunk,
            int(w2d.stride(1) == 1), ctypes.byref(out))
    _check(lib, rc, "bwd_dx occupancy")
    return out.value


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
