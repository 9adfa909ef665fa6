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
built on first use into six libraries, the float32 and the bf16 kernels of
three parts, ``BUILDS``) behind a wrapper that counts its launches, float32
ones in ``<wrapper>.launches`` and bfloat16 ones in
``<wrapper>.launches_bf16``: its calls on the card, each a launch, or under
CUDA graph capture the recording of one (a graph's replays launch the
recorded kernels without the wrapper: a device trace counts those).
A CUDA tensor launches the kernel or raises; a CPU tensor takes the plain
torch version beside it (``moments_plain``, ...); no build or launch is
wrapped in a fallback. x, g and W share one compute dtype, float32 or
bfloat16, with a kernel of each; any other dtype raises on the card. In
bfloat16 the products take bf16 operands with float32 accumulation, ``out``
and ``dx`` come back in bf16, the statistics, dW, dgamma and dbeta in
float32 (the op casts dW to W's dtype, as JAX does).

The three products (``apply``, and the two of the backward) run on the
tensor cores: in float32 as 3xTF32 splits, which keep fp32 accuracy
(:func:`matmul_3xtf32_plain` emulates the split in plain torch), in bf16 as
one bf16 product (exact in fp32) on a ``wgmma`` core fed by a ring of
``cp.async`` stages (:func:`wgmma_bf16_tile` runs that core alone); bf16
``apply`` makes its A operand relu(x*mul + add) in registers and folds its
channel chunks inside a thread-block cluster, and bf16 ``moments`` is one
launch of 16-byte loads. Their launch plan — block tiles of 64x64 to
128x128, how many K chunks share a contraction, which chunks form a
cluster — is plain Python, :func:`launch_plan`, a function of ``(n, c,
f)``, the card's SM count and the element size only.

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
# its six libraries, one nvcc each (built side by side, so the longest
# sets the build's time): each wrapper's part, float32 then bf16
_PARTS = {"moments": "MSP_FUSED_FWD", "apply": "MSP_FUSED_FWD",
          "bwd_reduce": "MSP_FUSED_BWD_REDUCE", "bwd_dx": "MSP_FUSED_BWD_DX"}
BUILDS = tuple((_SOURCE, (part, *(("MSP_FUSED_BF16",) if bf16 else ())))
               for bf16 in (False, True)
               for part in dict.fromkeys(_PARTS.values()))
_TILE_ROWS = 64   # kBM in the source: rows of a GEMM block tile
_TILE_COLS = (128, 64)  # 32 NT in the source: the wide and the narrow tile
_STEP_BYTES = 64  # a float32 K step is 64 bytes of a row: kBK (16)
# the bf16 products' (the wgmma core's) is 128: kBKW (64) bf16
_WGMMA_STEP_BYTES = 128
_MAX_K = 1024     # kMaxK in the source: most channels an f32 apply block takes
_DTYPES = (torch.float32, torch.bfloat16)  # the kernels' compute dtypes
_MOMENT_ROWS = 256  # rows per float32 moments block
_MAX_CLUSTER = 8  # kMaxCluster in the source: the most blocks a cluster

_lock = threading.Lock()
_typed: set = set()  # the (part, bf16) libraries whose argtypes are set


# ---------------------------------------------------------------------------
# Plain torch versions (the CPU path, and the kernels' yardstick on the card)
# ---------------------------------------------------------------------------

def moments_plain(x2d: torch.Tensor):
    """``(sum x, sum x^2)`` over rows of ``x2d`` (N, C), each (C,) float32."""
    xf = x2d.to(torch.float32)
    return xf.sum(0), (xf * xf).sum(0)


def apply_plain(x2d, mul, add, w2d):
    """``relu(x*mul + add)`` cast to W's dtype, ``@ W`` with float32
    accumulation -> (N, F) x.dtype (rounded once)."""
    a = torch.relu(x2d.to(torch.float32) * mul + add)
    return (a.to(w2d.dtype).to(torch.float32)
            @ w2d.to(torch.float32)).to(x2d.dtype)


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
    out = (a.to(x2d.dtype).to(torch.float32)
           @ w2d.to(torch.float32)).to(x2d.dtype)
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

    ``*_tile_cols`` is the block tile's width (its height is 64, but
    ``apply``'s, ``apply_tile_rows``, is 128 for bf16's 128x128 tile).
    ``apply`` contracts the channels in ``apply_chunks`` chunks of
    ``apply_k_per_chunk`` (the last may be short). In float32, with more
    than one chunk, it writes ``apply_scratch`` floats of partial outputs,
    folded in ascending order by a second kernel (``apply_cluster`` 1); in
    bf16 the chunks of a tile are the ``apply_cluster`` (= chunks, at most
    8) blocks of one thread-block cluster, which sum their partials in rank
    order in shared memory (``apply_scratch`` 0). The dW product splits
    the rows the same way; in bf16 the row chunks of a tile form
    thread-block clusters of ``dw_cluster`` blocks, which sum their
    partials in rank order in shared memory and write one partial a
    cluster (float32: ``dw_cluster`` 1). The product g Wᵀ takes 64x64 tiles in ``bwd_reduce`` and is split over F
    there (``da_chunks`` of ``da_k_per_chunk``). ``bwd_dx`` takes tiles
    ``dx_tile_cols`` wide and splits F too (``dx_chunks`` of
    ``dx_k_per_chunk``, at most 8): its epilogue is affine in g Wᵀ (the
    mask [z > 0] depends on x alone), so the F chunks of a tile are the
    blocks of one thread-block cluster, which sum their partial products in
    ascending order before the mask and the BN backward run once; one chunk
    is the unsplit launch. ``reduce_scratch`` holds the dW partials (one a
    cluster of row chunks; in bf16 none where there would be one, as dW
    goes straight to the output) and then the dbeta/dgamma partials of
    every (64-row tile, F chunk)."""
    apply_tile_rows: int
    apply_tile_cols: int
    apply_chunks: int
    apply_k_per_chunk: int
    apply_cluster: int
    apply_scratch: int
    dw_tile_cols: int
    dw_chunks: int
    dw_rows_per_chunk: int
    dw_cluster: int
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


def _dw_partials(chunks: int, cluster: int, elem_bytes: int) -> int:
    """dW partials in bwd_reduce's scratch: one a cluster of row chunks; in
    bf16 a single one is dW itself, written straight into the output."""
    partials = math.ceil(chunks / cluster)
    return 0 if elem_bytes == 2 and partials == 1 else partials


@functools.lru_cache(maxsize=None)
def launch_plan(n: int, c: int, f: int, sm_count: int,
                elem_bytes: int = 4) -> LaunchPlan:
    """The launch plan of a stage with ``n`` rows, ``c`` channels in and
    ``f`` out on a card with ``sm_count`` SMs, for elements of
    ``elem_bytes`` (4: float32, 2: bfloat16). A K step is 64 bytes of a
    row, 16 fp32 elements, and in bf16 (the ``wgmma`` core) 128 bytes, 64
    elements; chunks are multiples of their step. In bf16 ``apply``'s
    channel chunks are at most 8, one thread-block cluster a tile, and take
    any number of channels (mul/add arrive with each step); every backward
    tile is 64x64 there, and dW's float32 partials hold at
    most a quarter of x's bytes (n·2/4 ≥ partials·f·4 a channel), so its
    row chunks are few and long; where that leaves fewer than one dW block
    for two SMs, each longer than 4 steps, the rows are split to fill the
    card as in float32 and the chunks of a tile form thread-block clusters
    (2 to 8) that write one partial each. A cluster launch costs the whole
    grid (the g Wᵀ blocks too) some microseconds on an H100, so it is
    taken only there.

    A product takes the wide 64x128 tile (one column tile at F = 128) when
    that alone puts a block on every SM (bf16 ``apply``: a 128x128 tile,
    where those take 7/8 of the SMs); otherwise the narrow 64x64 tile, and
    if that still leaves
    SMs idle its contraction is split into chunks of whole K steps until
    there are about two blocks per SM (``apply`` over the channels, dW over
    the rows). ``bwd_reduce`` runs dW and g Wᵀ in one launch, g Wᵀ always in
    narrow tiles, split over F while they leave SMs idle. ``bwd_dx`` splits
    F into at most one cluster's 8 blocks, up to one block per SM: its
    clusters must sit whole inside one group of SMs, so fewer of them than
    two blocks per SM would suggest are resident at once, and a launch of
    two blocks per SM ran part of its clusters in a second wave."""
    if elem_bytes not in (2, 4):
        raise ValueError(f"no kernels for {elem_bytes}-byte elements")
    bf16 = elem_bytes == 2
    k_step = _WGMMA_STEP_BYTES // 2 if bf16 else _STEP_BYTES // elem_bytes
    wide, narrow = _TILE_COLS
    row_tiles = math.ceil(n / _TILE_ROWS)
    c_steps, n_steps = math.ceil(c / k_step), math.ceil(n / k_step)
    f_steps = math.ceil(f / k_step)

    apply_rows = _TILE_ROWS
    if bf16:
        # 128x128 blocks (two warpgroups sharing W's tiles), unsplit, where
        # they take 7/8 of the SMs or more (the 16,384-row stages); else
        # 64x64 blocks, split over C into one cluster a tile
        tiles = math.ceil(n / wide) * math.ceil(f / wide)
        if 8 * tiles >= 7 * sm_count:
            apply_rows = apply_cols = wide
            apply_chunks, k_steps = 1, c_steps
        else:
            apply_cols, tiles = narrow, row_tiles * math.ceil(f / narrow)
            apply_chunks, k_steps = _split(c_steps, tiles, sm_count,
                                           max_chunks=_MAX_CLUSTER)
    else:
        tiles = row_tiles * math.ceil(f / wide)
        apply_cols = wide
        if tiles < sm_count:
            apply_cols, tiles = narrow, row_tiles * math.ceil(f / narrow)
        apply_chunks, k_steps = _split(c_steps, tiles, sm_count,
                                       _MAX_K // k_step)

    tiles = math.ceil(c / _TILE_ROWS) * math.ceil(f / wide)
    dw_cols = wide
    if tiles * n_steps < 2 * sm_count or elem_bytes == 2:
        dw_cols = narrow
        tiles = math.ceil(c / _TILE_ROWS) * math.ceil(f / narrow)
    dw_cluster = 1
    if bf16:
        partials = max(1, n * elem_bytes // (16 * f))
        dw_chunks, row_steps = _split(n_steps, tiles, sm_count,
                                      max_chunks=partials)
        if tiles * dw_chunks < sm_count // 2 and row_steps > 4:
            # chunks of 4 steps, as many clusters as partials
            dw_chunks = min(math.ceil(n_steps / 4), _MAX_CLUSTER * partials)
            row_steps = math.ceil(n_steps / dw_chunks)
            dw_chunks = math.ceil(n_steps / row_steps)
            while math.ceil(dw_chunks / dw_cluster) > partials:
                dw_cluster *= 2
    else:
        dw_chunks, row_steps = _split(n_steps, tiles, sm_count)

    dx_cols = wide if row_tiles * math.ceil(c / wide) >= sm_count else narrow
    if bf16:
        dx_cols = narrow
    dx_chunks, dx_steps = _split(f_steps, row_tiles * math.ceil(c / dx_cols),
                                 sm_count, max_chunks=_MAX_CLUSTER,
                                 blocks_per_sm=1)
    da_chunks, da_steps = _split(f_steps, row_tiles * math.ceil(c / narrow),
                                 sm_count)
    return LaunchPlan(
        apply_tile_rows=apply_rows, apply_tile_cols=apply_cols,
        apply_chunks=apply_chunks,
        apply_k_per_chunk=k_steps * k_step,
        apply_cluster=apply_chunks if bf16 else 1,
        apply_scratch=apply_chunks * n * f if apply_chunks > 1 and not bf16
        else 0,
        dw_tile_cols=dw_cols, dw_chunks=dw_chunks,
        dw_rows_per_chunk=row_steps * k_step, dw_cluster=dw_cluster,
        dx_tile_cols=dx_cols,
        dx_chunks=dx_chunks, dx_k_per_chunk=dx_steps * k_step,
        da_chunks=da_chunks, da_k_per_chunk=da_steps * k_step,
        reduce_scratch=(_dw_partials(dw_chunks, dw_cluster, elem_bytes)
                        * c * f + row_tiles * da_chunks * 2 * c))


@functools.lru_cache(maxsize=None)
def _sm_count(device: torch.device) -> int:
    return torch.cuda.get_device_properties(device).multi_processor_count


def _plan_for(x2d: torch.Tensor, f: int) -> LaunchPlan:
    return launch_plan(x2d.shape[0], x2d.shape[1], f, _sm_count(x2d.device),
                       x2d.element_size())


def _apply_buffers(plan: LaunchPlan, n: int, f: int, device,
                   dtype=torch.float32):
    """``(out (n, f) in dtype, float32 scratch)`` for one ``apply``
    launch."""
    out = torch.empty((n, f), dtype=dtype, device=device)
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

def _lib(wrapper: str, bf16: bool = False):
    """The library of ``wrapper``'s part, float32 or (``bf16``) bf16, built
    on first use."""
    part = _PARTS[wrapper]
    lib, _ = _build.build(_SOURCE,
                          (part, *(("MSP_FUSED_BF16",) if bf16 else ())))
    with _lock:
        if (part, bf16) not in _typed:
            p, i, ll = ctypes.c_void_p, ctypes.c_int, ctypes.c_longlong
            sfx = "_bf16" if bf16 else ""
            dx = [p, p, p, ll, ll, p, p, p, p, p, p, ll, i, i, i, i, p, p]
            fwd = ({"moments": [p, ll, i, ll, p, p, p, p],
                    "apply": [p, p, p, p, ll, ll, ll, i, i, i, i, i, p, p],
                    "apply_max_clusters": [ll, i, i, i, i, i, i,
                                           ctypes.POINTER(i)]} if bf16 else
                   {"moments": [p, ll, i, ll, p, p, p],
                    "apply": [p, p, p, p, ll, ll, ll, i, i, i, i, p, p, p]})
            entries = {
                "MSP_FUSED_FWD": fwd,
                "MSP_FUSED_BWD_REDUCE": {
                    "bwd_reduce": [p, p, p, ll, ll, p, p, p, p, ll, i, i, i,
                                   ll, *([i] if bf16 else []), i, p, p, p]},
                "MSP_FUSED_BWD_DX": {
                    "bwd_dx": dx,
                    "bwd_dx_max_clusters": [ll, i, i, i, i,
                                            ctypes.POINTER(i)]},
            }[part]
            for name, types in entries.items():
                fn = getattr(lib, f"msp_fused_{name}{sfx}")
                fn.argtypes, fn.restype = types, i
            if part == "MSP_FUSED_BWD_DX" and bf16:
                lib.msp_wgmma_bf16_tile.argtypes = [p, p, i, i, i, i, p, p]
                lib.msp_wgmma_bf16_tile.restype = i
            lib.msp_cuda_error_string.argtypes = [i]
            lib.msp_cuda_error_string.restype = ctypes.c_char_p
            _typed.add((part, bf16))
    return lib


def _on_card(name: str, x2d: torch.Tensor, operands=(), vecs=()) -> bool:
    """True for CUDA tensors the kernels take, False for CPU tensors (the
    plain path); raises for anything else. ``x2d`` and ``operands`` (g, W)
    share one compute dtype, float32 or bfloat16; ``vecs`` are float32."""
    if x2d.device.type == "cpu":
        return False
    if x2d.device.type != "cuda":
        raise ValueError(f"{name}: unsupported device {x2d.device}")
    if x2d.dim() != 2 or x2d.shape[0] == 0 or x2d.shape[1] == 0:
        raise ValueError(f"{name}: expected non-empty (N, C), got "
                         f"{tuple(x2d.shape)}")
    for t in (x2d, *operands, *vecs):
        if t.device != x2d.device:
            raise ValueError(f"{name}: tensors on {t.device} and {x2d.device}")
    if x2d.dtype not in _DTYPES:
        raise TypeError(f"{name}: the CUDA kernels take float32 or bfloat16, "
                        f"got {x2d.dtype}")
    for t in operands:
        if t.dtype != x2d.dtype:
            raise TypeError(f"{name}: operands in {t.dtype} and {x2d.dtype}; "
                            "the kernels take one compute dtype")
    for t in vecs:
        if t.dtype != torch.float32:
            raise TypeError(f"{name}: per-channel vectors must be float32, "
                            f"got {t.dtype}")
    if not x2d.is_contiguous():
        raise ValueError(f"{name}: x must be row-major (N, C) with C "
                         f"contiguous, got strides {x2d.stride()}")
    return True


def _bf16(t: torch.Tensor) -> bool:
    return t.dtype == torch.bfloat16


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


def _count(wrapper, bf16: bool):
    with _lock:
        if bf16:
            wrapper.launches_bf16 += 1
        else:
            wrapper.launches += 1


def _stream(dev: torch.device) -> int:
    return torch.cuda.current_stream(dev).cuda_stream


@functools.lru_cache(maxsize=None)
def moments_rows_bf16(n: int, c: int, sm_count: int) -> int:
    """Rows of a bf16 ``moments`` block (a 256-thread block keeps a quarter
    of them in flight at once): 1,024 or 512, the longer that still gives
    a block for every third SM (slabs of 32 channels x row chunks), else
    256. On an H100 this picked the fastest of the three, or one within
    0.03 us of it, at every stage ``ops/bf16_fwd_sweep.py`` times."""
    slabs = math.ceil(c / 32)
    for rows in (1024, 512):
        if slabs * math.ceil(n / rows) >= sm_count // 3:
            return rows
    return 256


def _moments_bf16_partials(n: int, rows: int) -> int:
    """The bf16 ``moments`` launch's partials a 32-channel slab in device
    memory: one a chunk of ``rows`` where there are two chunks or more,
    else 0 (the one block writes the output)."""
    chunks = math.ceil(n / rows)
    return chunks if chunks > 1 else 0


_done: dict = {}  # (device, stream) -> moments' zeroed counters, one a slab


def _done_counters(dev: torch.device, slabs: int) -> torch.Tensor:
    """The bf16 ``moments`` kernel's counters (at least ``slabs``) for
    ``dev``'s current stream: 0 at every launch (the launch that uses one
    leaves it at 0); one set a stream, so launches on two streams never
    share them."""
    key = (dev, _stream(dev))
    with _lock:
        if key not in _done or _done[key].numel() < slabs:
            _done[key] = torch.zeros(max(slabs, 64), dtype=torch.int32,
                                     device=dev)
        return _done[key]


def moments(x2d: torch.Tensor):
    """Per-channel ``(sum x, sum x^2)`` of ``x2d`` (N, C), each (C,) f32 —
    see :func:`moments_plain`. Kernel: float32, one block per (256-row
    chunk, 32 channels) writes partials, a second kernel folds them in a
    fixed order; bf16, one launch: 16-byte loads, and the row chunks of a
    32-channel slab folded in a fixed order by the last of its blocks to
    finish."""
    if not _on_card("moments", x2d):
        return moments_plain(x2d)
    n, c = x2d.shape
    bf16 = _bf16(x2d)
    dev = x2d.device
    out = torch.empty(2 * c, dtype=torch.float32, device=dev)
    lib = _lib("moments", bf16)
    with torch.cuda.device(dev):
        if bf16:
            rows = moments_rows_bf16(n, c, _sm_count(dev))
            part = torch.empty(_moments_bf16_partials(n, rows) * 2 * c,
                               dtype=torch.float32, device=dev)
            done = _done_counters(dev, math.ceil(c / 32))
            rc = lib.msp_fused_moments_bf16(
                x2d.data_ptr(), n, c, rows, part.data_ptr(),
                done.data_ptr(), out.data_ptr(), _stream(dev))
        else:
            part = torch.empty((math.ceil(n / _MOMENT_ROWS), 2 * c),
                               dtype=torch.float32, device=dev)
            rc = lib.msp_fused_moments(x2d.data_ptr(), n, c, _MOMENT_ROWS,
                                       part.data_ptr(), out.data_ptr(),
                                       _stream(dev))
    _check(lib, rc, "moments")
    _count(moments, bf16)
    return out[:c], out[c:]


def apply(x2d, mul, add, w2d):
    """``relu(x*mul + add) @ W`` -> (N, F) in x's dtype — see
    :func:`apply_plain`. ``w2d`` (C, F) may be any strided view (the conv
    kernel's transpose). Kernel: a tensor-core product with the BN + ReLU
    as its prologue (pipelined 3xTF32 in float32, one bf16 product on the
    ``wgmma`` core in bfloat16); a small grid splits the channels into
    chunks whose partial outputs are folded in ascending order, by a second
    kernel in float32, inside a thread-block cluster in bf16 (no
    atomics)."""
    if not _on_card("apply", x2d, (w2d,), (mul, add)):
        return apply_plain(x2d, mul, add, w2d)
    _check_operands("apply", x2d, None, w2d)
    n, c = x2d.shape
    f = w2d.shape[1]
    bf16 = _bf16(x2d)
    mul, add = _vec(mul, c), _vec(add, c)
    dev = x2d.device
    plan = _plan_for(x2d, f)
    out, part = _apply_buffers(plan, n, f, dev, x2d.dtype)
    lib = _lib("apply", bf16)
    fn = lib.msp_fused_apply_bf16 if bf16 else lib.msp_fused_apply
    with torch.cuda.device(dev):
        rc = fn(x2d.data_ptr(), mul.data_ptr(), add.data_ptr(),
                w2d.data_ptr(), w2d.stride(0), w2d.stride(1), n, c, f,
                *((plan.apply_tile_rows,) if bf16 else ()),
                plan.apply_tile_cols,
                plan.apply_k_per_chunk,
                *(() if bf16 else (part.data_ptr(),)), out.data_ptr(),
                _stream(dev))
    _check(lib, rc, "apply")
    _count(apply, bf16)
    return out


def bwd_reduce(x2d, g, w2d, mul, add, mean, rstd):
    """``(dW (C, F), dgamma (C,), dbeta (C,))``, all float32 — see
    :func:`bwd_reduce_plain`. Kernels: one launch writes dW partials per
    row chunk and dbeta / dgamma partials per 64-row tile from the product
    g Wᵀ into one scratch buffer, a second folds it in a fixed order (no
    atomics). In bf16 both products run on the ``wgmma`` core, dW's operand
    a = relu(x·mul + add) made from the raw x tile in shared memory; dW's
    row chunks are few and long, or fold inside a thread-block cluster
    where its tiles are few."""
    if not _on_card("bwd_reduce", x2d, (g, w2d), (mul, add, mean, rstd)):
        return bwd_reduce_plain(x2d, g, w2d, mul, add, mean, rstd)
    _check_operands("bwd_reduce", x2d, g, w2d)
    n, c = x2d.shape
    f = w2d.shape[1]
    bf16 = _bf16(x2d)
    g = g.contiguous()
    mul, add, mean, rstd = (_vec(t, c) for t in (mul, add, mean, rstd))
    dev = x2d.device
    plan = _plan_for(x2d, f)
    out, part = _reduce_buffers(plan, c, f, dev)
    lib = _lib("bwd_reduce", bf16)
    fn = lib.msp_fused_bwd_reduce_bf16 if bf16 else lib.msp_fused_bwd_reduce
    with torch.cuda.device(dev):
        rc = fn(x2d.data_ptr(), g.data_ptr(), w2d.data_ptr(), w2d.stride(0),
                w2d.stride(1), mul.data_ptr(), add.data_ptr(),
                mean.data_ptr(), rstd.data_ptr(), n, c, f,
                plan.dw_tile_cols, plan.dw_rows_per_chunk,
                *((plan.dw_cluster,) if bf16 else ()), plan.da_k_per_chunk,
                part.data_ptr(), out.data_ptr(), _stream(dev))
    _check(lib, rc, "bwd_reduce")
    _count(bwd_reduce, bf16)
    dbeta, dgamma = out[c * f:c * f + c], out[c * f + c:]
    return out[:c * f].view(c, f), dgamma, dbeta


def bwd_dx(x2d, g, w2d, mul, add, mean, rstd, c1, c2):
    """``dx (N, C) = mul·(dz − c1 − xhat·c2)`` in x's dtype — see
    :func:`bwd_dx_plain`. Kernel: the product g Wᵀ (the mainloop it shares
    with ``bwd_reduce``) with the BN backward as its epilogue, one launch;
    where the grid leaves SMs idle, F is split across the blocks of a
    thread-block cluster whose partial products are summed in a fixed
    order in shared memory. In bf16 the product runs on the ``wgmma``
    core, the epilogue reads x from shared memory and dx leaves as
    16-byte stores."""
    if not _on_card("bwd_dx", x2d, (g, w2d),
                    (mul, add, mean, rstd, c1, c2)):
        return bwd_dx_plain(x2d, g, w2d, mul, add, mean, rstd, c1, c2)
    _check_operands("bwd_dx", x2d, g, w2d)
    plan = _plan_for(x2d, w2d.shape[1])
    dx = _launch_bwd_dx(x2d, g, w2d, (mul, add, mean, rstd, c1, c2),
                        plan.dx_tile_cols, plan.dx_k_per_chunk)
    _count(bwd_dx, _bf16(x2d))
    return dx


def _launch_bwd_dx(x2d, g, w2d, vecs, tile_cols: int, k_per_chunk: int):
    """One launch of the ``bwd_dx`` kernel on CUDA tensors at the given tile
    width and F chunk (``k_per_chunk`` >= F: the unsplit launch; a multiple
    of the dtype's backward step, 16 fp32 or 64 bf16), without counting it;
    :func:`bwd_dx` passes its plan's. ``vecs`` is ``(mul, add, mean, rstd,
    c1, c2)``."""
    n, c = x2d.shape
    f = w2d.shape[1]
    g = g.contiguous()
    vecs = [_vec(t, c) for t in vecs]
    dx = torch.empty((n, c), dtype=x2d.dtype, device=x2d.device)
    lib = _lib("bwd_dx", _bf16(x2d))
    head = (x2d.data_ptr(), g.data_ptr(), w2d.data_ptr(), w2d.stride(0),
            w2d.stride(1), *(v.data_ptr() for v in vecs), n, c, f, tile_cols)
    fn = lib.msp_fused_bwd_dx_bf16 if _bf16(x2d) else lib.msp_fused_bwd_dx
    with torch.cuda.device(x2d.device):
        rc = fn(*head, k_per_chunk, dx.data_ptr(), _stream(x2d.device))
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
    bf16 = _bf16(x2d)
    lib = _lib("bwd_dx", bf16)
    fn = (lib.msp_fused_bwd_dx_max_clusters_bf16 if bf16
          else lib.msp_fused_bwd_dx_max_clusters)
    out = ctypes.c_int(0)
    with torch.cuda.device(x2d.device):
        rc = fn(
            x2d.shape[0], x2d.shape[1], w2d.shape[1], plan.dx_k_per_chunk,
            int(w2d.stride(1) == 1), ctypes.byref(out))
    _check(lib, rc, "bwd_dx occupancy")
    return out.value


def apply_max_clusters(x2d: torch.Tensor, w2d: torch.Tensor):
    """How many clusters of :func:`apply`'s planned bf16 launch for ``x2d``
    (N, C) and ``w2d`` (C, F) the card keeps resident at once
    (``cudaOccupancyMaxActiveClusters``), or None where the plan does not
    cluster (one channel chunk, or float32)."""
    plan = _plan_for(x2d, w2d.shape[1])
    if plan.apply_cluster == 1:
        return None
    lib = _lib("apply", True)
    out = ctypes.c_int(0)
    with torch.cuda.device(x2d.device):
        rc = lib.msp_fused_apply_max_clusters_bf16(
            x2d.shape[0], x2d.shape[1], w2d.shape[1], plan.apply_tile_rows,
            plan.apply_tile_cols, plan.apply_k_per_chunk,
            int(w2d.stride(0) == 1),
            ctypes.byref(out))
    _check(lib, rc, "apply occupancy")
    return out.value


def wgmma_bf16_tile(a: torch.Tensor, b: torch.Tensor, a_mn_major=False,
                    b_mn_major=False, a_regs=False) -> torch.Tensor:
    """The bf16 ``wgmma`` core of ``apply``, ``bwd_reduce`` and ``bwd_dx``
    alone, on one 64x64 tile, for its tests: ``a`` and ``b`` (64, K) bf16,
    K a multiple of 8 -> ``a @ bᵀ`` (64, 64) float32. ``*_mn_major`` hands
    the kernel that operand's transpose, contiguous ([K][64]), to
    be read MN-major as the kernels read x and g; else the operand itself
    (K-major). ``a_regs``: A reaches ``wgmma`` from registers, by the
    fragment loads of ``apply``'s prologue (K-major) and dW's (MN-major),
    else through its descriptor. A CPU tensor takes the plain product; not
    counted."""
    if a.device.type == "cpu":
        return a.float() @ b.float().T
    if (a.dtype != torch.bfloat16 or b.dtype != torch.bfloat16
            or a.shape[0] != _TILE_ROWS or b.shape[0] != _TILE_ROWS
            or a.shape[1] != b.shape[1] or a.shape[1] % 8):
        raise ValueError(f"wgmma_bf16_tile: expected bf16 (64, K) and (64, "
                         f"K), K % 8 == 0, got {tuple(a.shape)} {a.dtype}, "
                         f"{tuple(b.shape)} {b.dtype}")
    a_in = (a.T if a_mn_major else a).contiguous()
    b_in = (b.T if b_mn_major else b).contiguous()
    out = torch.empty((_TILE_ROWS, _TILE_ROWS), dtype=torch.float32,
                      device=a.device)
    lib = _lib("bwd_dx", True)
    with torch.cuda.device(a.device):
        rc = lib.msp_wgmma_bf16_tile(a_in.data_ptr(), b_in.data_ptr(),
                                     int(a_mn_major), int(b_mn_major),
                                     int(a_regs), a.shape[1], out.data_ptr(),
                                     _stream(a.device))
    _check(lib, rc, "wgmma_bf16_tile")
    return out


moments.launches = apply.launches = bwd_reduce.launches = 0  # float32
bwd_dx.launches = 0
moments.launches_bf16 = apply.launches_bf16 = 0  # bfloat16
bwd_reduce.launches_bf16 = bwd_dx.launches_bf16 = 0
KERNELS = (moments, apply, bwd_reduce, bwd_dx)


def reset_launches():
    """Set every kernel's launch counts (both dtypes) to 0."""
    with _lock:
        for k in KERNELS:
            k.launches = 0
            k.launches_bf16 = 0


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


def _storage(t: torch.Tensor) -> torch.Tensor:
    """``t``, or the tensor under its ``torch.func`` grad wrappers: the
    backward of a remat region's recompute (``torch.func.vjp``) runs this
    op's backward on wrapped tensors, which have no storage for the
    kernels to read."""
    fc = torch._C._functorch
    while fc.is_gradtrackingtensor(t):
        t = fc.get_unwrapped(t)
    return t


def _per_fold(info, in_dims, args, fn):
    """A ``vmap`` rule that loops: ``fn`` on each of the ``info.batch_size``
    slices of the batched ``args`` (those with an ``in_dims`` entry), its
    outputs stacked on dim 0. The kernels read storage, which a vmapped
    tensor lacks, so under ``torch.func.vmap`` (the fold-parallel step)
    each fold's (rows, C) slice, contiguous where the trunk's physical
    layout puts the folds outermost, goes to them on its own."""
    moved = [a if d is None else a.movedim(d, 0)
             for a, d in zip(args, in_dims)]
    outs = [fn(*(a if d is None else a[k] for a, d in zip(moved, in_dims)))
            for k in range(info.batch_size)]
    return (tuple(torch.stack(o) for o in zip(*outs)),
            (0,) * len(outs[0]))


def _backward(x2d, g, w2d, mul, add, mean, rstd, with_dx: bool):
    """``(dW, dgamma, dbeta, dx or None)`` of the fused op."""
    n = x2d.shape[0]
    dw, dg, db = bwd_reduce(x2d, g, w2d, mul, add, mean, rstd)
    dx = None
    if with_dx:
        # dx = r·γ·(dz − Σdz/N − xhat·Σdz·xhat/N)
        dx = bwd_dx(x2d, g, w2d, mul, add, mean, rstd, db / n, dg / n)
    return dw, dg, db, dx


class _FusedBackward(torch.autograd.Function):
    """:func:`_backward` with dx, as a Function for its ``vmap`` rule (the
    op's backward under the fold-parallel ``vmap(grad)``). Not
    differentiable."""

    @staticmethod
    def forward(x2d, g, w2d, mul, add, mean, rstd):
        return _backward(x2d, g, w2d, mul, add, mean, rstd, True)

    @staticmethod
    def setup_context(ctx, inputs, output):
        pass

    @staticmethod
    def vmap(info, in_dims, *args):
        return _per_fold(info, in_dims, args, _FusedBackward.forward)


class _FusedBnReluConv1x1(torch.autograd.Function):
    # the setup_context form, so that torch.func.vjp can run it (the
    # recompute of a remat region); the saved statistics are outputs
    # because that form saves inputs and outputs only

    @staticmethod
    def forward(x2d, scale, bias, w2d, eps):
        _check_dtypes(x2d, w2d)
        mean, var, rstd, mul, add = _stats(x2d, scale, bias, eps)
        out = apply(x2d, mul, add, w2d)
        return out, mean, var, mul, add, rstd

    @staticmethod
    def setup_context(ctx, inputs, output):
        x2d, w2d = inputs[0], inputs[3]
        _, mean, var, mul, add, rstd = output
        ctx.save_for_backward(x2d, w2d, mul, add, mean, rstd)
        ctx.mark_non_differentiable(mean, var, mul, add, rstd)

    @staticmethod
    def vmap(info, in_dims, x2d, scale, bias, w2d, eps):
        return _per_fold(info, in_dims[:4], (x2d, scale, bias, w2d),
                         lambda *a: _FusedBnReluConv1x1.forward(*a, eps))

    @staticmethod
    def backward(ctx, g_out, *_g_stats):
        # mean/var feed the running-average update only: their cotangents
        # are ignored (the JAX VJP at ops/fused_dense.py:309)
        x2d, w2d, mul, add, mean, rstd = map(_storage, ctx.saved_tensors)
        g = _storage(g_out).to(x2d.dtype)
        args = (x2d, g, w2d, mul, add, mean, rstd)
        if torch._C._functorch.is_batchedtensor(x2d):  # vmap(grad): folds
            dw, dg, db, dx = _FusedBackward.apply(*args)
        else:
            dw, dg, db, dx = _backward(*args, ctx.needs_input_grad[0])
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
    return _FusedBnReluConv1x1.apply(x2d, scale, bias, w2d, eps)[:3]
