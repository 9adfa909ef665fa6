"""The Swin-ViT 3D CT encoder: the ``swinViT`` encoder of Swin UNETR
(Hatamizadeh et al., arXiv:2201.01266) as MONAI implements it in
``monai/networks/nets/swin_unetr.py`` (``SwinTransformer``, ``BasicLayer``,
``SwinTransformerBlock``, ``WindowAttention``, ``PatchMerging``,
``compute_mask``, ``get_window_size``; v1, ``use_v2=False``), at its
published settings by default (:data:`PUBLISHED`), with a survival head.

The equations, in MONAI's order:

* patch embedding: ``Conv3d(1 -> C, kernel 2, stride 2, bias)`` on the
  channels-first CT (each axis zero-padded at its end to a multiple of the
  patch first), no norm;
* four stages of width ``C * 2^i``, each two blocks, then patch merging.
  ``window_and_shift``: along an axis no longer than the window, the window
  becomes the axis and the shift 0; otherwise the window is 7 and the
  shift 3 in odd blocks;
* a block: ``x + attn_part(norm1(x))``, then ``x + linear2(GELU(linear1(
  norm2(x))))``. ``attn_part`` zero-pads each axis at its end to whole
  windows after ``norm1`` (the padded tokens are keys in unshifted windows,
  as in MONAI), rolls by ``-shift`` where a shift is not 0 and masks pairs
  of tokens from different roll regions with -100 (:func:`shift_mask`),
  partitions into windows of ``n`` tokens, computes
  ``softmax(q k^T / sqrt(hd) + B + mask) v`` and ``proj``, then reverses
  the partition, rolls back and crops. ``B`` is
  ``relative_position_bias_table[index[:n, :n]]`` with ``index`` the
  3-D relative index of the full 7^3 window: a smaller window takes the
  first ``n`` rows and columns of it, as MONAI slices it;
* patch merging (v1): odd axes padded, eight strided slices concatenated in
  MONAI v1's order (:data:`MERGE_ORDER`, which repeats the (0,1,0) and
  (0,0,1) slices in places 6 and 7 instead of taking (1,1,0) and (0,1,1)),
  ``LayerNorm(8C)``, ``Linear(8C -> 2C, no bias)``;
* the output: stage 4's merged features, MONAI's ``proj_out`` (LayerNorm
  over channels without affine), the mean over space and
  ``class_layers.out`` (``Linear(16C -> out_features)``). The pooling and
  the head are this repository's construction; the rest is MONAI's.

Window attention runs through ``F.scaled_dot_product_attention`` with
``B + mask`` as its additive mask, so the bias table's gradient flows
through the mask. An unshifted block broadcasts ``B`` (1, heads, n, n) over
every window; a shifted one folds the windows into the head axis,
``(batch, windows * heads, n, hd)``, so that ``B + mask`` (1, windows *
heads, n, n) broadcasts over the batch alone.

The state_dict keys are MONAI's under ``swinViT.`` (``patch_embed.proj``,
``layers{1..4}.0.blocks.{0,1}.{norm1, attn.relative_position_bias_table,
attn.qkv, attn.proj, norm2, mlp.linear1, mlp.linear2}``,
``layers{1..4}.0.downsample.{reduction, norm}``), and the head's is
``class_layers.out`` as the DenseNet's. ``relative_position_index`` is a
non-persistent buffer: a state_dict holds trained leaves only.

Init as in MONAI: torch's default uniform init of the convolution and the
linears, LayerNorm 1 and 0, and the bias tables ``trunc_normal_(std=0.02)``
(truncated at +-2, about 100 sigma: drawn here as a plain normal).

Float32 only: no compute ``dtype``, no remat and no fused stages. Shapes
and padding are Python arithmetic on the input's shape and the masks are
built with device operations, so a step stays capturable as a CUDA graph.
Each stage and the patch embedding record a span (``swin.patch_embed``,
``swin.stage1`` .. ``swin.stage4``), and each attention call counts its
real and attended tokens (``utils/profiling.py``).
"""

from __future__ import annotations

import torch
import torch.nn.functional as F
from torch import nn
from torch.nn.attention import SDPBackend, sdpa_kernel

from ..utils.profiling import count, span
from .layers import conv3d, default_generator, to_ncdhw, torch_linear

# MONAI SwinUNETR's published encoder (feature_size, depths, num_heads,
# window, patch, MLP ratio; qkv bias on, drop rates 0, no patch norm)
PUBLISHED = {
    "feature_size": 48,
    "depths": (2, 2, 2, 2),
    "num_heads": (3, 6, 12, 24),
    "window_size": 7,
    "patch_size": 2,
    "mlp_ratio": 4.0,
}
LN_EPS = 1e-5
MASK_FILL = -100.0
# MONAI v1 PatchMerging's slices (d, h, w offsets), in concatenation order
MERGE_ORDER = ((0, 0, 0), (1, 0, 0), (0, 1, 0), (0, 0, 1),
               (1, 0, 1), (0, 1, 0), (0, 0, 1), (1, 1, 1))
REAL_TOKENS = "swin.window_tokens.real"
ATTENDED_TOKENS = "swin.window_tokens.attended"


def window_and_shift(dims, window: int, shift: int):
    """MONAI ``get_window_size``: ``(window, shift)`` per axis of ``dims``,
    the window clamped to an axis no longer than it and the shift there 0."""
    ws = tuple(d if d <= window else window for d in dims)
    sh = tuple(0 if d <= window else shift for d in dims)
    return ws, sh


def relative_position_index(window: int) -> torch.Tensor:
    """(window^3, window^3) index into the ((2w-1)^3, heads) bias table."""
    coords = torch.stack(torch.meshgrid(
        *[torch.arange(window)] * 3, indexing="ij")).flatten(1)
    rel = (coords[:, :, None] - coords[:, None, :]).permute(1, 2, 0) \
        + (window - 1)
    side = 2 * window - 1
    return rel[..., 0] * side * side + rel[..., 1] * side + rel[..., 2]


def window_partition(x: torch.Tensor, ws) -> torch.Tensor:
    """(B, D, H, W, C) -> (B * windows, n, C), windows in (d, h, w) order."""
    b, d, h, w, c = x.shape
    x = x.view(b, d // ws[0], ws[0], h // ws[1], ws[1], w // ws[2], ws[2], c)
    return x.permute(0, 1, 3, 5, 2, 4, 6, 7).reshape(
        -1, ws[0] * ws[1] * ws[2], c)


def window_reverse(windows: torch.Tensor, ws, b: int, d: int, h: int,
                   w: int) -> torch.Tensor:
    """The inverse of :func:`window_partition`."""
    x = windows.view(b, d // ws[0], h // ws[1], w // ws[2], ws[0], ws[1],
                     ws[2], -1)
    return x.permute(0, 1, 4, 2, 5, 3, 6, 7).reshape(b, d, h, w, -1)


def shift_mask(dims, ws, shift, device) -> torch.Tensor:
    """MONAI ``compute_mask`` over the padded ``dims``: (windows, n, n),
    -100 between tokens of different roll regions and 0 elsewhere. Along
    each axis of padded size P the regions are ``[0, P - ws)``, ``[P - ws,
    P - shift)`` and ``[P - shift, P)``."""
    labels = []
    for size, w, s in zip(dims, ws, shift):
        i = torch.arange(size, device=device)
        labels.append((i >= size - w).long() + (i >= size - s).long())
    region = (labels[0].view(-1, 1, 1) * 9 + labels[1].view(1, -1, 1) * 3
              + labels[2].view(1, 1, -1))
    win = window_partition(region.view(1, *dims, 1), ws).squeeze(-1)
    diff = win.unsqueeze(1) != win.unsqueeze(2)
    return torch.where(diff, MASK_FILL, 0.0).float()


def attend(q, k, v, mask) -> torch.Tensor:
    """``scaled_dot_product_attention(q, k, v, attn_mask=mask)``. On a card
    the backend is pinned to memory-efficient attention (CUTLASS's kernels,
    whose additive mask takes a gradient): the eager, captured and replayed
    steps and every evaluation take the same kernels, and a call they
    cannot serve raises instead of falling back to the math path, which
    materializes the logits (29 GiB in an evaluation of 64 patients at
    96^3). A 16^3 CT, whose last stage is one token, is such a call."""
    if not q.is_cuda:
        return F.scaled_dot_product_attention(q, k, v, attn_mask=mask)
    with sdpa_kernel(SDPBackend.EFFICIENT_ATTENTION):
        return F.scaled_dot_product_attention(q, k, v, attn_mask=mask)


class WindowAttention(nn.Module):
    """MONAI ``WindowAttention`` (qkv bias on, no dropout)."""

    def __init__(self, dim: int, heads: int, window: int, *,
                 generator: torch.Generator):
        super().__init__()
        self.heads = heads
        table = torch.empty(((2 * window - 1) ** 3, heads))
        table.normal_(0.0, 0.02, generator=generator)
        self.relative_position_bias_table = nn.Parameter(table)
        self.register_buffer("relative_position_index",
                             relative_position_index(window),
                             persistent=False)
        self.qkv = torch_linear(dim, 3 * dim, generator=generator)
        self.proj = torch_linear(dim, dim, generator=generator)

    def bias(self, n: int) -> torch.Tensor:
        """B: (heads, n, n), from the first ``n`` rows and columns of the
        full window's index (MONAI's slice); contiguous, as
        memory-efficient attention takes no mask whose last stride is not
        1."""
        idx = self.relative_position_index[:n, :n].reshape(-1)
        return self.relative_position_bias_table[idx].view(
            n, n, self.heads).permute(2, 0, 1).contiguous()

    def forward(self, x: torch.Tensor, n_windows: int,
                mask: torch.Tensor | None) -> torch.Tensor:
        """``x`` (B * n_windows, n, C) -> the same; ``mask`` (n_windows, n,
        n) or None."""
        bw, n, c = x.shape
        h, hd = self.heads, c // self.heads
        q, k, v = self.qkv(x).view(bw, n, 3, h, hd).permute(
            2, 0, 3, 1, 4).unbind(0)
        bias = self.bias(n)
        if mask is None:
            out = attend(q, k, v, bias.unsqueeze(0))
        else:
            folded = (bw // n_windows, n_windows * h, n, hd)
            full = (bias.unsqueeze(0) + mask.unsqueeze(1)).reshape(
                1, n_windows * h, n, n)
            out = attend(q.reshape(folded), k.reshape(folded),
                         v.reshape(folded), full).reshape(bw, h, n, hd)
        return self.proj(out.transpose(1, 2).reshape(bw, n, c))


class Mlp(nn.Module):
    """MONAI ``MLPBlock``: ``linear2(GELU(linear1(x)))`` (erf GELU)."""

    def __init__(self, dim: int, hidden: int, *,
                 generator: torch.Generator):
        super().__init__()
        self.linear1 = torch_linear(dim, hidden, generator=generator)
        self.linear2 = torch_linear(hidden, dim, generator=generator)

    def forward(self, x):
        return self.linear2(F.gelu(self.linear1(x)))


class SwinTransformerBlock(nn.Module):
    """MONAI ``SwinTransformerBlock`` (pre-norm, no drop path)."""

    def __init__(self, dim: int, heads: int, window: int, shift: int,
                 mlp_ratio: float, *, generator: torch.Generator):
        super().__init__()
        self.window, self.shift = window, shift
        self.norm1 = nn.LayerNorm(dim, eps=LN_EPS)
        self.attn = WindowAttention(dim, heads, window, generator=generator)
        self.norm2 = nn.LayerNorm(dim, eps=LN_EPS)
        self.mlp = Mlp(dim, int(dim * mlp_ratio), generator=generator)

    def attn_part(self, x: torch.Tensor, mask) -> torch.Tensor:
        b, d, h, w, c = x.shape
        ws, shift = window_and_shift((d, h, w), self.window, self.shift)
        pads = [(-size) % win for size, win in zip((d, h, w), ws)]
        x = F.pad(self.norm1(x), (0, 0, 0, pads[2], 0, pads[1], 0, pads[0]))
        dp, hp, wp = d + pads[0], h + pads[1], w + pads[2]
        shifted = any(shift)
        if shifted:
            x = torch.roll(x, shifts=tuple(-s for s in shift), dims=(1, 2, 3))
        n_windows = (dp // ws[0]) * (hp // ws[1]) * (wp // ws[2])
        count(REAL_TOKENS, b * d * h * w)
        count(ATTENDED_TOKENS, b * dp * hp * wp)
        out = self.attn(window_partition(x, ws), n_windows,
                        mask if shifted else None)
        x = window_reverse(out, ws, b, dp, hp, wp)
        if shifted:
            x = torch.roll(x, shifts=shift, dims=(1, 2, 3))
        return x[:, :d, :h, :w, :]

    def forward(self, x: torch.Tensor, mask) -> torch.Tensor:
        x = x + self.attn_part(x, mask)
        return x + self.mlp(self.norm2(x))


class PatchMerging(nn.Module):
    """MONAI v1 ``PatchMerging`` (module docstring; its slice order is
    :data:`MERGE_ORDER`)."""

    def __init__(self, dim: int, *, generator: torch.Generator):
        super().__init__()
        self.reduction = torch_linear(8 * dim, 2 * dim, bias=False,
                                      generator=generator)
        self.norm = nn.LayerNorm(8 * dim, eps=LN_EPS)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        _, d, h, w, _ = x.shape
        x = F.pad(x, (0, 0, 0, w % 2, 0, h % 2, 0, d % 2))
        x = torch.cat([x[:, i::2, j::2, k::2, :] for i, j, k in MERGE_ORDER],
                      dim=-1)
        return self.reduction(self.norm(x))


class BasicLayer(nn.Module):
    """MONAI ``BasicLayer``: ``depth`` blocks (odd ones shifted by half a
    window), then patch merging; channels-last in and out."""

    def __init__(self, dim: int, depth: int, heads: int, window: int,
                 mlp_ratio: float, *, generator: torch.Generator):
        super().__init__()
        self.window = window
        self.blocks = nn.ModuleList([
            SwinTransformerBlock(dim, heads, window,
                                 0 if i % 2 == 0 else window // 2, mlp_ratio,
                                 generator=generator)
            for i in range(depth)])
        self.downsample = PatchMerging(dim, generator=generator)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        dims = x.shape[1:4]
        ws, shift = window_and_shift(dims, self.window, self.window // 2)
        mask = None
        if any(shift):
            padded = [-(-size // win) * win for size, win in zip(dims, ws)]
            mask = shift_mask(padded, ws, shift, x.device)
        for blk in self.blocks:
            x = blk(x, mask)
        return self.downsample(x)


class PatchEmbed(nn.Module):
    """MONAI ``PatchEmbed`` without norm: pad each axis at its end to a
    multiple of the patch, then the strided convolution."""

    def __init__(self, patch: int, embed_dim: int, *,
                 generator: torch.Generator):
        super().__init__()
        self.patch = patch
        self.proj = conv3d(1, embed_dim, patch, stride=patch, bias=True,
                           kaiming=False, generator=generator)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        d, h, w = x.shape[2:]
        p = self.patch
        x = F.pad(x, (0, (-w) % p, 0, (-h) % p, 0, (-d) % p))
        return self.proj(x)


class SwinTransformer(nn.Module):
    """MONAI ``SwinTransformer`` (``swinViT``): the patch embedding and the
    four stages, ``layers1`` .. ``layers4`` (one ``BasicLayer`` each)."""

    def __init__(self, feature_size: int, depths, num_heads, window_size: int,
                 patch_size: int, mlp_ratio: float, *,
                 generator: torch.Generator):
        super().__init__()
        self.patch_embed = PatchEmbed(patch_size, feature_size,
                                      generator=generator)
        for i, (depth, heads) in enumerate(zip(depths, num_heads)):
            setattr(self, f"layers{i + 1}", nn.ModuleList([BasicLayer(
                feature_size * 2 ** i, depth, heads, window_size, mlp_ratio,
                generator=generator)]))
        self.num_layers = len(depths)

    def forward(self, image: torch.Tensor) -> torch.Tensor:
        """(B, 1, D, H, W) -> stage 4's merged features, channels-last."""
        with span("swin.patch_embed"):
            x = self.patch_embed(image).permute(0, 2, 3, 4, 1)
        for i in range(self.num_layers):
            with span(f"swin.stage{i + 1}"):
                x = getattr(self, f"layers{i + 1}")[0](x)
        return x


class SwinViT3D(nn.Module):
    """Channels-last CT (B, D, H, W, 1) -> (B, out_features): ``swinViT``,
    ``proj_out``, the spatial mean and ``class_layers.out`` (module
    docstring)."""

    def __init__(self, out_features: int = 128,
                 generator: torch.Generator | None = None,
                 feature_size: int = PUBLISHED["feature_size"],
                 depths=PUBLISHED["depths"],
                 num_heads=PUBLISHED["num_heads"],
                 window_size: int = PUBLISHED["window_size"],
                 patch_size: int = PUBLISHED["patch_size"],
                 mlp_ratio: float = PUBLISHED["mlp_ratio"]):
        super().__init__()
        gen = default_generator(generator)
        self.swinViT = SwinTransformer(feature_size, depths, num_heads,
                                       window_size, patch_size, mlp_ratio,
                                       generator=gen)
        width = feature_size * 2 ** len(depths)
        self.class_layers = nn.ModuleDict({"out": torch_linear(
            width, out_features, generator=gen)})

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        x = self.swinViT(to_ncdhw(x))
        x = F.layer_norm(x, x.shape[-1:], eps=LN_EPS)
        return self.class_layers["out"](x.mean(dim=(1, 2, 3)))

