"""MMsurv: Compact Bilinear Pooling + transformer fusion (port of
``multimodal_survival_prediction_tpu/models/mmsurv.py``).

The reference ships no code for this model (it exists as metadata only,
results/mmsurv/cv_results.json), so the JAX module is the definition:
  * modality encoders -> image / RNA / clinical tokens (128 each),
  * Compact Bilinear Pooling of the image and RNA features (count sketch +
    FFT) -> a fourth token, valid only when both modalities are present,
  * two pre-norm transformer blocks over the four tokens, masked by
    modality availability, then the masked mean of the tokens -> Cox head.

flax semantics kept by hand (``nn.MultiheadAttention`` and SDPA differ):
the query is scaled by 1/sqrt(head_dim); masked logits are filled with
``finfo(float32).min``, so a row whose keys are all masked gets a uniform
softmax, not NaN; attention-weight dropout draws ONE keep mask of shape
(1, 1, T, T), shared across the batch and the heads (flax
``broadcast_dropout``); LayerNorm uses the fast variance and epsilon 1e-6. The count-sketch
matrices are fixed numpy draws (seeds 1 and 2), registered as
non-persistent buffers: they are not in a checkpoint. The reference has no
torch layout for this model; the port's keys are in ``io/jax_import.py``.

``dtype`` reaches the three encoders alone, as in JAX: the CBP casts to
float32, ``cbp_proj``, the attention blocks and the head have no compute
dtype, so the token stack promotes to float32 and stays there.
"""

from __future__ import annotations

import math

import numpy as np
import torch
from torch import nn

from .encoders import ClinicalEncoder, RNAEncoderCompact, image_encoder
from .layers import Dropout, default_generator, torch_linear

TOKEN_DIM = 128
CBP_DIM = 256


def count_sketch_matrix(dim_in: int, dim_out: int, seed: int) -> np.ndarray:
    """The sparse count sketch as a dense (dim_in, dim_out) matrix (JAX
    ``models/mmsurv.py:_count_sketch_matrix``, the same draws)."""
    rng = np.random.default_rng(seed)
    h = rng.integers(0, dim_out, size=dim_in)
    s = rng.choice([-1.0, 1.0], size=dim_in)
    m = np.zeros((dim_in, dim_out), np.float32)
    m[np.arange(dim_in), h] = s
    return m


class CompactBilinearPooling(nn.Module):
    """CBP(x, y) = IFFT(FFT(x·Sx) * FFT(y·Sy)), then signed sqrt and l2
    normalization."""

    def __init__(self, dim_x: int, dim_y: int, dim_out: int = 256):
        super().__init__()
        self.dim_out = dim_out
        self.register_buffer(
            "sketch_x", torch.from_numpy(count_sketch_matrix(dim_x, dim_out, 1)),
            persistent=False)
        self.register_buffer(
            "sketch_y", torch.from_numpy(count_sketch_matrix(dim_y, dim_out, 2)),
            persistent=False)

    def forward(self, x, y):
        fx = torch.fft.rfft(x.float() @ self.sketch_x, dim=-1)
        fy = torch.fft.rfft(y.float() @ self.sketch_y, dim=-1)
        out = torch.fft.irfft(fx * fy, n=self.dim_out, dim=-1)
        out = torch.sign(out) * torch.sqrt(out.abs() + 1e-8)
        return out / (torch.linalg.vector_norm(out, dim=-1, keepdim=True)
                      + 1e-8)


class LayerNorm(nn.Module):
    """flax ``nn.LayerNorm()`` over the last dim: the fast variance
    ``max(E[x²]−E[x]², 0)``, epsilon 1e-6; torch's parameter names."""

    def __init__(self, dim: int, eps: float = 1e-6):
        super().__init__()
        self.eps = eps
        self.weight = nn.Parameter(torch.ones(dim))
        self.bias = nn.Parameter(torch.zeros(dim))

    def forward(self, x):
        mean = x.mean(-1, keepdim=True)
        var = ((x * x).mean(-1, keepdim=True) - mean * mean).clamp_min(0.0)
        return (x - mean) * (torch.rsqrt(var + self.eps) * self.weight) \
            + self.bias


def _lecun_linear(dim: int, generator: torch.Generator) -> nn.Linear:
    """``nn.Linear(dim, dim)`` with flax's attention init: lecun-normal
    kernel (truncated at 2 sigma, fan_in = dim), zero bias."""
    lin = nn.Linear(dim, dim, device="meta").to_empty(device="cpu")
    std = math.sqrt(1.0 / dim) / 0.87962566103423978
    with torch.no_grad():
        nn.init.trunc_normal_(lin.weight, 0.0, std, -2 * std, 2 * std,
                              generator=generator)
        lin.bias.zero_()
    return lin


class MultiHeadAttention(nn.Module):
    """flax ``MultiHeadDotProductAttention`` (self-attention) with torch
    Linear layouts ``query``, ``key``, ``value``, ``out``; ``mask`` (B, T)
    marks the valid keys."""

    def __init__(self, dim: int, heads: int, dropout: float, *,
                 generator: torch.Generator):
        super().__init__()
        self.heads = heads
        self.query = _lecun_linear(dim, generator)
        self.key = _lecun_linear(dim, generator)
        self.value = _lecun_linear(dim, generator)
        self.out = _lecun_linear(dim, generator)
        self.dropout = Dropout(dropout)

    def forward(self, x, mask):
        b, t, d = x.shape
        hd = d // self.heads

        def split(lin):  # (B, T, D) -> (B, H, T, hd)
            return lin(x).view(b, t, self.heads, hd).transpose(1, 2)

        q = split(self.query) / math.sqrt(hd)
        logits = q @ split(self.key).transpose(-1, -2)  # (B, H, T, T)
        logits = torch.where(mask[:, None, None, :] > 0, logits,
                             torch.finfo(logits.dtype).min)
        weights = torch.softmax(logits, dim=-1)
        # one keep mask for every batch row and head (broadcast_dropout)
        weights = weights * self.dropout(weights.new_ones(1, 1, t, t))
        y = (weights @ split(self.value)).transpose(1, 2).reshape(b, t, d)
        return self.out(y)


class TransformerBlock(nn.Module):
    """Pre-norm block: x + attn(ln1(x)); x + ff1(drop(relu(ff0(ln2(x)))))."""

    def __init__(self, dim: int, heads: int = 4, dropout: float = 0.5, *,
                 generator: torch.Generator):
        super().__init__()
        self.ln1 = LayerNorm(dim)
        self.attn = MultiHeadAttention(dim, heads, dropout,
                                       generator=generator)
        self.ln2 = LayerNorm(dim)
        self.ff0 = torch_linear(dim, dim * 2, generator=generator)
        self.ff_dropout = Dropout(dropout)
        self.ff1 = torch_linear(dim * 2, dim, generator=generator)

    def forward(self, tokens, pad_mask):
        tokens = tokens + self.attn(self.ln1(tokens), pad_mask)
        y = self.ff_dropout(torch.relu(self.ff0(self.ln2(tokens))))
        return tokens + self.ff1(y)


class MMsurvNet(nn.Module):
    """``forward(image, rnaseq, clinical, mask (B, 3)) -> log-hazard (B,)``:
    128-wide tokens, a 256-wide CBP sketch, two transformer blocks
    (``layer0``, ``layer1``). ``dropout`` is the rate of the attention-weight,
    feed-forward and pooled dropouts (0.5, results/mmsurv); the RNA encoder
    keeps its own 0.3. ``dtype``: the encoders' compute dtype."""

    def __init__(self, rna_dim: int = 5005, backbone: str = "densenet121",
                 block_config: tuple | None = None, dropout: float = 0.5,
                 generator: torch.Generator | None = None,
                 dtype: torch.dtype | None = None):
        super().__init__()
        gen = default_generator(generator)
        self.image_encoder = image_encoder(TOKEN_DIM, backbone=backbone,
                                           block_config=block_config,
                                           generator=gen, dtype=dtype)
        self.rna_encoder = RNAEncoderCompact(rna_dim, TOKEN_DIM,
                                             generator=gen, dtype=dtype)
        self.clinical_encoder = ClinicalEncoder(1, TOKEN_DIM, generator=gen,
                                                dtype=dtype)
        self.cbp = CompactBilinearPooling(TOKEN_DIM, TOKEN_DIM, CBP_DIM)
        self.cbp_proj = torch_linear(CBP_DIM, TOKEN_DIM, generator=gen)
        self.pos_embed = nn.Parameter(
            torch.randn(1, 4, TOKEN_DIM, generator=gen) * 0.02)
        self.layer0 = TransformerBlock(TOKEN_DIM, dropout=dropout,
                                       generator=gen)
        self.layer1 = TransformerBlock(TOKEN_DIM, dropout=dropout,
                                       generator=gen)
        self.pool_dropout = Dropout(dropout)
        self.cox_head = torch_linear(TOKEN_DIM, 1, generator=gen)

    def forward(self, image, rnaseq, clinical, mask):
        img = self.image_encoder(image)
        rna = self.rna_encoder(rnaseq)
        clin = self.clinical_encoder(clinical)
        cbp_tok = self.cbp_proj(self.cbp(img, rna))

        tokens = torch.stack([img, rna, clin, cbp_tok], dim=1) + self.pos_embed
        # the CBP token needs both image and RNA
        pad_mask = torch.cat([mask, mask[:, 0:1] * mask[:, 1:2]], dim=-1)
        tokens = tokens * pad_mask[..., None]
        tokens = self.layer1(self.layer0(tokens, pad_mask), pad_mask)

        denom = pad_mask.sum(-1, keepdim=True).clamp_min(1.0)
        pooled = (tokens * pad_mask[..., None]).sum(1) / denom
        return self.cox_head(self.pool_dropout(pooled)).squeeze(-1)
