"""Plain reference of MONAI SwinUNETR's Swin-ViT encoder (``swinViT``,
Hatamizadeh et al., arXiv:2201.01266), written from
``monai/networks/nets/swin_unetr.py`` (v1: ``SwinTransformer``,
``BasicLayer``, ``SwinTransformerBlock``, ``WindowAttention``,
``PatchMerging``, ``compute_mask``, ``get_window_size``), with the
survival head the configuration file states under ``assumed``: MONAI's
``proj_out`` (LayerNorm over channels, no affine) of stage 4's merged
features, the mean over space and ``class_layers.out``.

Functions of a flat ``{key: tensor}`` dict with MONAI's keys under
``<prefix>.swinViT.``. Plain ``torch`` only: the attention is an explicit
``q @ k^T``, softmax and ``@ v`` (no ``scaled_dot_product_attention``), the
relative index and the shift mask are built anew at every call (no cache),
and the logits are formed one patient at a time, so that an evaluation of
many rows needs one patient's logits at once. It imports nothing of the
measured program.

MONAI v1's two quirks are kept, as the source has them: a window smaller
than 7^3 (stage 4 at 96^3, 6^3 tokens) takes the first ``n`` rows and
columns of the 7^3 window's relative index, and patch merging
concatenates the (0,1,0) and (0,0,1) slices twice, in places 6 and 7,
where (1,1,0) and (0,1,1) would complete the eight.
"""

from __future__ import annotations

import math

import torch
import torch.nn.functional as F

LN_EPS = 1e-5


# ---------------------------------------------------------------------------
# parameter specification
# ---------------------------------------------------------------------------

def _ln_spec(spec, key, c):
    spec.append((f"{key}.weight", (c,), ("ones",)))
    spec.append((f"{key}.bias", (c,), ("zeros",)))


def _linear_spec(spec, key, n_in, n_out, bias=True):
    bound = 1.0 / math.sqrt(n_in)  # torch's default init
    spec.append((f"{key}.weight", (n_out, n_in), ("uniform", bound)))
    if bias:
        spec.append((f"{key}.bias", (n_out,), ("uniform", bound)))


def swin_spec(spec, prefix: str, arch: dict):
    """The encoder's keys under ``prefix`` in state_dict order (MONAI's
    registration order: a module's own parameters, then its children)."""
    c, p, win = arch["feature_size"], arch["patch_size"], arch["window_size"]
    sv = f"{prefix}.swinViT"
    bound = 1.0 / math.sqrt(p ** 3)
    spec.append((f"{sv}.patch_embed.proj.weight", (c, 1, p, p, p),
                 ("uniform", bound)))
    spec.append((f"{sv}.patch_embed.proj.bias", (c,), ("uniform", bound)))
    for i, (depth, heads) in enumerate(zip(arch["depths"],
                                           arch["num_heads"])):
        dim = c * 2 ** i
        hidden = int(dim * arch["mlp_ratio"])
        layer = f"{sv}.layers{i + 1}.0"
        for b in range(depth):
            blk = f"{layer}.blocks.{b}"
            _ln_spec(spec, f"{blk}.norm1", dim)
            # trunc_normal_(std=0.02), truncated at +-2: a normal in effect
            spec.append((f"{blk}.attn.relative_position_bias_table",
                         ((2 * win - 1) ** 3, heads), ("normal", 0.02)))
            _linear_spec(spec, f"{blk}.attn.qkv", dim, 3 * dim)
            _linear_spec(spec, f"{blk}.attn.proj", dim, dim)
            _ln_spec(spec, f"{blk}.norm2", dim)
            _linear_spec(spec, f"{blk}.mlp.linear1", dim, hidden)
            _linear_spec(spec, f"{blk}.mlp.linear2", hidden, dim)
        _linear_spec(spec, f"{layer}.downsample.reduction", 8 * dim, 2 * dim,
                     bias=False)
        _ln_spec(spec, f"{layer}.downsample.norm", 8 * dim)
    _linear_spec(spec, f"{prefix}.class_layers.out",
                 c * 2 ** len(arch["depths"]), arch["out_features"])


# ---------------------------------------------------------------------------
# MONAI's helpers
# ---------------------------------------------------------------------------

def get_window_size(x_size, window_size, shift_size):
    use_window_size = list(window_size)
    use_shift_size = list(shift_size)
    for i in range(len(x_size)):
        if x_size[i] <= window_size[i]:
            use_window_size[i] = x_size[i]
            use_shift_size[i] = 0
    return tuple(use_window_size), tuple(use_shift_size)


def window_partition(x, window_size):
    b, d, h, w, c = x.shape
    x = x.view(b, d // window_size[0], window_size[0], h // window_size[1],
               window_size[1], w // window_size[2], window_size[2], c)
    return x.permute(0, 1, 3, 5, 2, 4, 6, 7).contiguous().view(
        -1, window_size[0] * window_size[1] * window_size[2], c)


def window_reverse(windows, window_size, dims):
    b, d, h, w = dims
    x = windows.view(b, d // window_size[0], h // window_size[1],
                     w // window_size[2], window_size[0], window_size[1],
                     window_size[2], -1)
    return x.permute(0, 1, 4, 2, 5, 3, 6, 7).contiguous().view(b, d, h, w, -1)


def compute_mask(dims, window_size, shift_size, device):
    cnt = 0
    d, h, w = dims
    img_mask = torch.zeros((1, d, h, w, 1), device=device)
    for d in (slice(-window_size[0]), slice(-window_size[0], -shift_size[0]),
              slice(-shift_size[0], None)):
        for h in (slice(-window_size[1]),
                  slice(-window_size[1], -shift_size[1]),
                  slice(-shift_size[1], None)):
            for w in (slice(-window_size[2]),
                      slice(-window_size[2], -shift_size[2]),
                      slice(-shift_size[2], None)):
                img_mask[:, d, h, w, :] = cnt
                cnt += 1
    mask_windows = window_partition(img_mask, window_size).squeeze(-1)
    attn_mask = mask_windows.unsqueeze(1) - mask_windows.unsqueeze(2)
    return attn_mask.masked_fill(attn_mask != 0, -100.0).masked_fill(
        attn_mask == 0, 0.0)


def relative_position_index(window_size, device):
    coords = torch.stack(torch.meshgrid(
        torch.arange(window_size[0], device=device),
        torch.arange(window_size[1], device=device),
        torch.arange(window_size[2], device=device), indexing="ij"))
    coords_flatten = torch.flatten(coords, 1)
    relative = coords_flatten[:, :, None] - coords_flatten[:, None, :]
    relative = relative.permute(1, 2, 0).contiguous()
    relative[:, :, 0] += window_size[0] - 1
    relative[:, :, 1] += window_size[1] - 1
    relative[:, :, 2] += window_size[2] - 1
    relative[:, :, 0] *= (2 * window_size[1] - 1) * (2 * window_size[2] - 1)
    relative[:, :, 1] *= 2 * window_size[2] - 1
    return relative.sum(-1)


# ---------------------------------------------------------------------------
# layers
# ---------------------------------------------------------------------------

def layer_norm(w, key, x):
    return F.layer_norm(x, (x.shape[-1],), w[f"{key}.weight"],
                        w[f"{key}.bias"], eps=LN_EPS)


def linear(w, key, x):
    return F.linear(x, w[f"{key}.weight"], w.get(f"{key}.bias"))


def window_attention(w, key, x, heads, window, n_windows, mask):
    """``x`` (patients * n_windows, n, C); ``mask`` (n_windows, n, n) or
    None. ``softmax(q k^T * hd^-1/2 + B + mask) v`` and ``proj``, one
    patient's windows at a time."""
    bw, n, c = x.shape
    qkv = linear(w, f"{key}.qkv", x).reshape(bw, n, 3, heads, c // heads)
    qkv = qkv.permute(2, 0, 3, 1, 4)
    q, k, v = qkv[0], qkv[1], qkv[2]
    q = q * (c // heads) ** -0.5
    index = relative_position_index((window,) * 3, x.device)
    bias = w[f"{key}.relative_position_bias_table"][
        index[:n, :n].reshape(-1)].reshape(n, n, -1).permute(2, 0, 1)
    outs = []
    for s in range(0, bw, n_windows):
        attn = q[s:s + n_windows] @ k[s:s + n_windows].transpose(-2, -1)
        attn = attn + bias.unsqueeze(0)
        if mask is not None:
            attn = attn + mask.unsqueeze(1)
        attn = torch.softmax(attn, dim=-1)
        outs.append(attn @ v[s:s + n_windows])
    out = torch.cat(outs).transpose(1, 2).reshape(bw, n, c)
    return linear(w, f"{key}.proj", out)


def block(w, key, x, heads, window, shift, mlp_ratio, mask_matrix):
    """MONAI ``SwinTransformerBlock.forward`` (``forward_part1`` and
    ``forward_part2``; no drop path)."""
    shortcut = x
    b, d, h, wd, c = x.shape
    window_size, shift_size = get_window_size((d, h, wd), (window,) * 3,
                                              (shift,) * 3)
    x = layer_norm(w, f"{key}.norm1", x)
    pad_d1 = (window_size[0] - d % window_size[0]) % window_size[0]
    pad_b = (window_size[1] - h % window_size[1]) % window_size[1]
    pad_r = (window_size[2] - wd % window_size[2]) % window_size[2]
    x = F.pad(x, (0, 0, 0, pad_r, 0, pad_b, 0, pad_d1))
    _, dp, hp, wp, _ = x.shape
    if any(i > 0 for i in shift_size):
        x = torch.roll(x, shifts=tuple(-s for s in shift_size),
                       dims=(1, 2, 3))
        attn_mask = mask_matrix
    else:
        attn_mask = None
    n_windows = (dp // window_size[0]) * (hp // window_size[1]) * \
        (wp // window_size[2])
    windows = window_attention(w, f"{key}.attn",
                               window_partition(x, window_size), heads,
                               window, n_windows, attn_mask)
    windows = windows.view(-1, *(window_size + (c,)))
    x = window_reverse(windows, window_size, (b, dp, hp, wp))
    if any(i > 0 for i in shift_size):
        x = torch.roll(x, shifts=shift_size, dims=(1, 2, 3))
    x = shortcut + x[:, :d, :h, :wd, :]
    y = layer_norm(w, f"{key}.norm2", x)
    y = linear(w, f"{key}.mlp.linear2",
               F.gelu(linear(w, f"{key}.mlp.linear1", y)))
    return x + y


def patch_merging(w, key, x):
    """MONAI v1 ``PatchMerging.forward``, slices as the source takes
    them."""
    b, d, h, wd, c = x.shape
    if (h % 2 == 1) or (wd % 2 == 1) or (d % 2 == 1):
        x = F.pad(x, (0, 0, 0, wd % 2, 0, h % 2, 0, d % 2))
    x0 = x[:, 0::2, 0::2, 0::2, :]
    x1 = x[:, 1::2, 0::2, 0::2, :]
    x2 = x[:, 0::2, 1::2, 0::2, :]
    x3 = x[:, 0::2, 0::2, 1::2, :]
    x4 = x[:, 1::2, 0::2, 1::2, :]
    x5 = x[:, 0::2, 1::2, 0::2, :]
    x6 = x[:, 0::2, 0::2, 1::2, :]
    x7 = x[:, 1::2, 1::2, 1::2, :]
    x = torch.cat([x0, x1, x2, x3, x4, x5, x6, x7], -1)
    x = layer_norm(w, f"{key}.norm", x)
    return linear(w, f"{key}.reduction", x)


def basic_layer(w, key, x, depth, heads, window, mlp_ratio):
    """MONAI ``BasicLayer.forward`` on channels-last ``x``."""
    _, d, h, wd, _ = x.shape
    window_size, shift_size = get_window_size(
        (d, h, wd), (window,) * 3, (window // 2,) * 3)
    dp = int(math.ceil(d / window_size[0])) * window_size[0]
    hp = int(math.ceil(h / window_size[1])) * window_size[1]
    wp = int(math.ceil(wd / window_size[2])) * window_size[2]
    attn_mask = compute_mask([dp, hp, wp], window_size, shift_size, x.device)
    for i in range(depth):
        x = block(w, f"{key}.blocks.{i}", x, heads, window,
                  0 if i % 2 == 0 else window // 2, mlp_ratio, attn_mask)
    return patch_merging(w, f"{key}.downsample", x)


def swin(w: dict, prefix: str, arch: dict, image):
    """(B, D, H, W, 1) channels-last CT -> (B, out_features)."""
    p = arch["patch_size"]
    x = image.permute(0, 4, 1, 2, 3)
    _, _, d, h, wd = x.shape
    if wd % p != 0:
        x = F.pad(x, (0, p - wd % p))
    if h % p != 0:
        x = F.pad(x, (0, 0, 0, p - h % p))
    if d % p != 0:
        x = F.pad(x, (0, 0, 0, 0, 0, p - d % p))
    sv = f"{prefix}.swinViT"
    x = F.conv3d(x, w[f"{sv}.patch_embed.proj.weight"],
                 w[f"{sv}.patch_embed.proj.bias"], stride=p)
    x = x.permute(0, 2, 3, 4, 1)
    for i, (depth, heads) in enumerate(zip(arch["depths"],
                                           arch["num_heads"])):
        x = basic_layer(w, f"{sv}.layers{i + 1}.0", x, depth, heads,
                        arch["window_size"], arch["mlp_ratio"])
    x = F.layer_norm(x, (x.shape[-1],), eps=LN_EPS)  # proj_out
    return linear(w, f"{prefix}.class_layers.out", x.mean(dim=(1, 2, 3)))
