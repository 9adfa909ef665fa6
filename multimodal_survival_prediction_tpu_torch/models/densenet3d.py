"""DenseNet121 with 3D convolutions — the CT encoder.

Port of ``multimodal_survival_prediction_tpu/models/densenet3d.py``: the
architecture of MONAI's ``DenseNet121(spatial_dims=3, in_channels=1,
out_channels=128)``, with MONAI's state_dict key names
(``features.denseblock1.denselayer1.layers.norm1.weight``, ...,
``class_layers.out.weight``) so exported weights load strictly:

  conv0 7^3/s2 (64ch, no bias) -> BN -> ReLU -> maxpool 3^3/s2 pad 1 (-inf)
  dense blocks (6, 12, 24, 16), growth 32, bottleneck 4*growth 1x1x1
  transitions: BN -> ReLU -> 1x1x1 conv (channels/2) -> avgpool 2^3/s2
  final BN -> ReLU -> global avg pool -> Linear(1024 -> out_features)

Init matches MONAI: kaiming-normal conv weights, BN gamma=1/beta=0, head
Linear bias=0 (weight keeps torch Linear default).

Input is channels-last (B, D, H, W, 1), the JAX layout; it is permuted to
NCDHW inside.

``fused_bn1`` runs each dense layer's ``norm1 -> relu -> conv1`` and each
transition's ``norm -> relu -> conv`` in train mode through the fused op of
``ops/fused_dense.py`` (hand-written CUDA kernels on the card). Those
blocks keep the trunk in ``torch.channels_last_3d`` memory, so the op's
(rows, C) operand is a free view of it.
"""

from __future__ import annotations

from typing import Sequence

import torch
import torch.nn.functional as F
from torch import nn

from ..ops.fused_dense import fused_bn_relu_conv1x1
from .layers import (
    BatchNorm,
    Dropout,
    conv3d,
    default_generator,
    to_ncdhw,
    torch_linear,
)


def _fused_stage(norm: BatchNorm, conv: nn.Conv3d,
                 x: torch.Tensor) -> torch.Tensor:
    """Train-mode ``conv(relu(norm(x)))`` for a 1x1x1 bias-free ``conv``
    through ``fused_bn_relu_conv1x1`` — the counterpart of the JAX
    ``_fused_stage`` (dense-layer stage 1 AND transition). Updates
    ``norm``'s running stats as ``BatchNorm.forward`` does (momentum 0.9,
    biased variance, ``num_batches_tracked``).

    ``x`` (B, C, D, H, W) must be in ``channels_last_3d`` memory: its
    (B·D·H·W, C) view then shares storage, as does the output's way back."""
    b, c, d, h, w = x.shape
    if not x.is_contiguous(memory_format=torch.channels_last_3d):
        raise RuntimeError(
            "fused stage: the trunk is not channels_last_3d (strides "
            f"{x.stride()}); viewing it as (rows, C) would copy it")
    x2 = x.permute(0, 2, 3, 4, 1).reshape(-1, c)
    if x2.data_ptr() != x.data_ptr() or not x2.is_contiguous():
        raise RuntimeError("fused stage: the (rows, C) view copied the trunk")
    f = conv.out_channels
    w2 = conv.weight.view(f, c).t()  # (C, F) view of the conv kernel
    out2, mean, var = fused_bn_relu_conv1x1(x2, norm.weight, norm.bias, w2,
                                            norm.eps)
    norm.update_running_stats(mean, var)
    return out2.view(b, d, h, w, f).permute(0, 4, 1, 2, 3)


class _DenseLayer(nn.Module):
    def __init__(self, in_ch, growth_rate, bn_size, dropout, gen):
        super().__init__()
        mid = bn_size * growth_rate
        # MONAI nests the layer's modules under `.layers.`
        self.layers = nn.ModuleDict({
            "norm1": BatchNorm(in_ch),
            "conv1": conv3d(in_ch, mid, 1, bias=False, kaiming=True,
                            generator=gen),
            "norm2": BatchNorm(mid),
            "conv2": conv3d(mid, growth_rate, 3, bias=False, kaiming=True,
                            generator=gen),
        })
        self.dropout = Dropout(dropout)

    def forward(self, x, fused: bool = False):
        m = self.layers
        if fused:
            y = _fused_stage(m["norm1"], m["conv1"], x)
        else:
            y = m["conv1"](F.relu(m["norm1"](x)))
        y = m["conv2"](F.relu(m["norm2"](y)))
        return torch.cat([x, self.dropout(y)], dim=1)


class _Transition(nn.Module):
    def __init__(self, in_ch, out_ch, gen):
        super().__init__()
        self.norm = BatchNorm(in_ch)
        self.conv = conv3d(in_ch, out_ch, 1, bias=False, kaiming=True,
                           generator=gen)

    def forward(self, x, fused: bool = False):
        if fused:
            y = _fused_stage(self.norm, self.conv, x)
        else:
            y = self.conv(F.relu(self.norm(x)))
        return F.avg_pool3d(y, 2, 2)


class DenseNet121_3D(nn.Module):
    """Input (B, D, H, W, 1) -> features (B, out_features).

    ``trunk`` ('concat' | 'dus') is kept for checkpoint and CLI parity; both
    compute the same concatenated trunk here (the JAX 'dus' variant only
    changes XLA's buffer plan, densenet3d.py:233-235 there).
    ``fused_bn1`` (bool, or an int rows threshold B*D*H*W decided once per
    block and reused by its transition) selects the fused BN->ReLU->1x1-conv
    stage in TRAIN mode. In eval mode it is ignored, as in JAX.
    """

    def __init__(self, out_features: int = 128, init_features: int = 64,
                 growth_rate: int = 32,
                 block_config: Sequence[int] = (6, 12, 24, 16),
                 bn_size: int = 4, dropout: float = 0.0,
                 trunk: str = "concat", fused_bn1: bool | int = False,
                 generator: torch.Generator | None = None):
        super().__init__()
        if trunk not in ("concat", "dus"):
            raise ValueError(f"unknown trunk {trunk!r}")
        gen = default_generator(generator)
        self.block_config = tuple(block_config)
        self.trunk = trunk
        self.fused_bn1 = fused_bn1
        feats = {
            "conv0": conv3d(1, init_features, 7, stride=2, bias=False,
                            kaiming=True, generator=gen),
            "norm0": BatchNorm(init_features),
        }
        channels = init_features
        for bi, num_layers in enumerate(self.block_config):
            block = nn.ModuleDict()
            for li in range(num_layers):
                block[f"denselayer{li + 1}"] = _DenseLayer(
                    channels + li * growth_rate, growth_rate, bn_size,
                    dropout, gen)
            feats[f"denseblock{bi + 1}"] = block
            channels += num_layers * growth_rate
            if bi != len(self.block_config) - 1:
                feats[f"transition{bi + 1}"] = _Transition(
                    channels, channels // 2, gen)
                channels //= 2
        feats["norm5"] = BatchNorm(channels)
        self.features = nn.ModuleDict(feats)
        self.class_layers = nn.ModuleDict({"out": torch_linear(
            channels, out_features, generator=gen, zero_bias=True)})

    def _fuse_rows(self, rows: int) -> bool:
        if isinstance(self.fused_bn1, bool):
            return self.fused_bn1
        return rows <= int(self.fused_bn1)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        # Each spatial dim is halved by conv0, the pool, and every transition;
        # dims that bottom out at zero would give silent NaNs (empty mean).
        min_dim = 2 ** (2 + len(self.block_config) - 1)
        if any(s < min_dim for s in x.shape[1:4]):
            raise ValueError(
                f"DenseNet121_3D needs spatial dims >= {min_dim}, got "
                f"{tuple(x.shape[1:4])} (use backbone='simple_cnn' for tiny "
                "inputs)")
        f = self.features
        x = F.relu(f["norm0"](f["conv0"](to_ncdhw(x))))
        x = F.max_pool3d(x, 3, 2, padding=1)  # torch pads max-pool with -inf
        for bi in range(len(self.block_config)):
            fuse = self.training and self._fuse_rows(
                x.shape[0] * x[0, 0].numel())
            if fuse:  # one re-layout per block at most (avg-pool drops it)
                x = x.contiguous(memory_format=torch.channels_last_3d)
            for layer in f[f"denseblock{bi + 1}"].values():
                x = layer(x, fuse)
            if bi != len(self.block_config) - 1:
                x = f[f"transition{bi + 1}"](x, fuse)
        x = F.relu(f["norm5"](x))
        return self.class_layers["out"](x.mean(dim=(2, 3, 4)))
