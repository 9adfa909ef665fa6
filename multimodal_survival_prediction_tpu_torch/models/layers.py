"""Shared building blocks with the reference's init and flax's BatchNorm.

Port of ``multimodal_survival_prediction_tpu/models/layers.py``.

Initialization matches PyTorch's defaults, drawn from an explicit
``torch.Generator`` (never the global RNG):
  * Linear: W, b ~ U(-1/sqrt(fan_in), 1/sqrt(fan_in))
  * ConvNd: the same with fan_in = in_ch * prod(kernel), or kaiming-normal
    (fan_in, ReLU gain) where MONAI uses it
  * BatchNorm: gamma=1, beta=0, running stats (0, 1), eps=1e-5.

``BatchNorm`` follows flax's ``nn.BatchNorm(momentum=0.9)``, not
``torch.nn.BatchNorm``: the batch variance is the fast ``E[x²]−E[x]²``
clipped at 0, and the running variance is updated with that BIASED
variance (torch would use the unbiased one, which moves eval outputs).

``Dropout`` draws its masks from a generator the caller owns (the trainer
owns one per fold), so two seeded runs draw the same masks whatever the
global RNG holds.

Compute dtype (flax's ``dtype`` of ``Dense``, ``Conv`` and ``BatchNorm``):
the layers built here take ``dtype``. When it is set, input, weight and
bias are cast to it at use and the result is in it (flax
``promote_dtype``); when it is None the result type is the promotion of
the input's and the parameters' (a bf16 input into a float32 layer gives
float32, as in JAX). ``BatchNorm`` keeps its statistics and normalization
in float32 and casts its output once. Parameters and buffers stay float32
whatever ``dtype`` is, so state_dict keys and values are those of the
float32 model. ``torch.autocast`` is not used: its op lists are not flax's
casting points.
"""

from __future__ import annotations

import math

import torch
import torch.nn.functional as F
from torch import nn


def default_generator(generator: torch.Generator | None) -> torch.Generator:
    """``generator``, or a fresh one seeded 0 so that init never reads the
    global RNG."""
    return generator if generator is not None else torch.Generator().manual_seed(0)


def compute_dtype(dtype: torch.dtype | None, x: torch.Tensor,
                  param: torch.Tensor) -> torch.dtype:
    """``dtype``, or the promotion of the input's and the parameter's types
    (flax ``canonicalize_dtype``)."""
    return dtype or torch.promote_types(x.dtype, param.dtype)


class Linear(nn.Linear):
    """``nn.Linear`` in flax ``Dense``'s compute dtype (module docstring):
    the product, rounded to the compute dtype, then the bias added in it,
    as flax adds it (in bf16 that is two roundings, as in JAX)."""

    dtype: torch.dtype | None = None

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        dt = compute_dtype(self.dtype, x, self.weight)
        y = F.linear(x.to(dt), self.weight.to(dt))
        return y if self.bias is None else y + self.bias.to(dt)


class Conv3d(nn.Conv3d):
    """``nn.Conv3d`` in flax ``Conv``'s compute dtype (module docstring),
    the bias added after the convolution as :class:`Linear` adds it."""

    dtype: torch.dtype | None = None

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        dt = compute_dtype(self.dtype, x, self.weight)
        x, w = x.to(dt), self.weight.to(dt)
        if dt == torch.bfloat16 and x.device.type == "cpu":
            # torch's CPU bf16 conv3d returned non-finite values at some
            # shapes (batch 8, 64 -> 128 channels over 4x4x2); the float32
            # convolution of the bf16 operands, rounded once, is the same
            # function (bf16 products are exact in float32)
            y = self._conv_forward(x.float(), w.float(), None).to(dt)
        else:
            y = self._conv_forward(x, w, None)
        if self.bias is None:
            return y
        return y + self.bias.to(dt).view(1, -1, *([1] * (y.dim() - 2)))


def torch_linear(in_features: int, out_features: int, *,
                 generator: torch.Generator, bias: bool = True,
                 zero_bias: bool = False,
                 dtype: torch.dtype | None = None) -> Linear:
    """:class:`Linear` in compute ``dtype`` with torch's default init drawn
    from ``generator`` (``zero_bias``: MONAI's DenseNet head)."""
    lin = Linear(in_features, out_features, bias=bias,
                 device="meta").to_empty(device="cpu")
    lin.dtype = dtype
    bound = 1.0 / math.sqrt(in_features)
    with torch.no_grad():
        lin.weight.uniform_(-bound, bound, generator=generator)
        if bias:
            if zero_bias:
                lin.bias.zero_()
            else:
                lin.bias.uniform_(-bound, bound, generator=generator)
    return lin


def conv3d(in_ch: int, out_ch: int, kernel: int, *, stride: int = 1,
           bias: bool, kaiming: bool, generator: torch.Generator,
           dtype: torch.dtype | None = None) -> Conv3d:
    """:class:`Conv3d` in compute ``dtype`` with padding ``(kernel-1)//2``
    and either torch's default uniform init or kaiming-normal
    (``kaiming``), from ``generator``."""
    conv = Conv3d(in_ch, out_ch, kernel, stride=stride,
                  padding=(kernel - 1) // 2, bias=bias,
                  device="meta").to_empty(device="cpu")
    conv.dtype = dtype
    fan_in = in_ch * kernel ** 3
    with torch.no_grad():
        if kaiming:
            conv.weight.normal_(0.0, math.sqrt(2.0 / fan_in),
                                generator=generator)
        else:
            bound = 1.0 / math.sqrt(fan_in)
            conv.weight.uniform_(-bound, bound, generator=generator)
        if bias:
            bound = 1.0 / math.sqrt(fan_in)
            conv.bias.uniform_(-bound, bound, generator=generator)
    return conv


class BatchNorm(nn.Module):
    """flax ``nn.BatchNorm(momentum=0.9, epsilon=1e-5)`` over dim 1 of
    (N, C) or (N, C, D, H, W), with torch's parameter and buffer names
    (``weight``/``bias``, ``running_mean``/``running_var``,
    ``num_batches_tracked``) so the reference's state_dicts load strictly.

    Train mode (``module.train()``): batch mean and fast variance
    ``max(E[x²]−E[x]², 0)``; running stats become ``0.9*ra + 0.1*batch``
    with the biased variance. Eval mode: ``(x−ra_mean)·rsqrt(ra_var+eps)·γ+β``.
    Statistics and normalization run in float32 whatever x's type
    (flax ``force_float32_reductions``); the output is cast once to
    ``dtype``, or to the promotion of x's type and float32.
    """

    def __init__(self, num_features: int, momentum: float = 0.9,
                 eps: float = 1e-5, dtype: torch.dtype | None = None):
        super().__init__()
        self.momentum = momentum
        self.eps = eps
        self.dtype = dtype
        self.weight = nn.Parameter(torch.ones(num_features))
        self.bias = nn.Parameter(torch.zeros(num_features))
        self.register_buffer("running_mean", torch.zeros(num_features))
        self.register_buffer("running_var", torch.ones(num_features))
        self.register_buffer("num_batches_tracked",
                             torch.tensor(0, dtype=torch.long))

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        shape = (1, -1) + (1,) * (x.dim() - 2)
        if self.training:
            axes = [0, *range(2, x.dim())]
            xf = x.to(torch.promote_types(x.dtype, torch.float32))
            mean = xf.mean(axes)
            var = ((xf * xf).mean(axes) - mean * mean).clamp_min(0.0)
            self.update_running_stats(mean, var)
        else:
            mean, var = self.running_mean, self.running_var
        mul = torch.rsqrt(var + self.eps) * self.weight
        y = (x - mean.view(shape)) * mul.view(shape) + self.bias.view(shape)
        return y.to(compute_dtype(self.dtype, x, self.weight))

    @torch.no_grad()
    def update_running_stats(self, mean: torch.Tensor, var: torch.Tensor):
        """``ra = m·ra + (1−m)·batch`` for the batch mean and BIASED
        variance, and one more ``num_batches_tracked`` — the train-mode
        update, shared with the fused stage of ``densenet3d.py``."""
        m = self.momentum
        self.running_mean.copy_(m * self.running_mean + (1 - m) * mean)
        self.running_var.copy_(m * self.running_var + (1 - m) * var)
        self.num_batches_tracked += 1


class Dropout(nn.Module):
    """Dropout whose mask comes from an explicit ``torch.Generator``, never
    the global RNG: in train mode each element is kept with probability
    ``1 − p`` and scaled by ``1/(1 − p)`` (flax ``nn.Dropout``, torch
    ``nn.Dropout``); eval mode, and ``p == 0``, are the identity.

    The generator is an attribute, not state: ``state_dict`` keys are those
    of ``nn.Dropout`` (none). It must live on the input's device; a model's
    dropouts get theirs from :func:`set_dropout_generator`. Train mode with
    ``p > 0`` and no generator raises."""

    def __init__(self, p: float, generator: torch.Generator | None = None):
        super().__init__()
        self.p = p
        self.generator = generator

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        if not self.training or self.p == 0:
            return x
        if self.generator is None:
            raise RuntimeError(
                "Dropout in train mode needs a generator: call "
                "set_dropout_generator(model, generator)")
        # the uniforms in float32 whatever x's type (flax draws its
        # bernoulli mask in float32): bf16 uniforms take ~1,700 values and
        # would move the keep rate
        u = torch.rand(x.shape, generator=self.generator, device=x.device,
                       dtype=torch.float32)
        return torch.where(u >= self.p, x / (1 - self.p), 0.0)

    def extra_repr(self) -> str:
        return f"p={self.p}"


def set_dropout_generator(model: nn.Module, generator: torch.Generator):
    """Make every :class:`Dropout` of ``model`` draw from ``generator``."""
    for m in model.modules():
        if isinstance(m, Dropout):
            m.generator = generator


def MLPBlock(in_features: int, features: int, *, dropout: float = 0.3,
             use_bn: bool = True, generator: torch.Generator,
             dtype: torch.dtype | None = None) -> list:
    """Linear -> BatchNorm1d -> ReLU -> Dropout in compute ``dtype``, the
    reference's repeated cell, as a module LIST to splice into the parent
    ``nn.Sequential``: the reference's keys number the cell's modules in
    the parent (``fusion.0``, ``fusion.1``, ...), so the cell must not
    nest."""
    mods = [torch_linear(in_features, features, generator=generator,
                         dtype=dtype)]
    if use_bn:
        mods.append(BatchNorm(features, dtype=dtype))
    mods.append(nn.ReLU())
    mods.append(Dropout(dropout))
    return mods


def mean_f32(x: torch.Tensor, dims) -> torch.Tensor:
    """Mean over ``dims`` accumulated in float32, returned in x's type (as
    ``jnp.mean`` of a bf16 array)."""
    return x.mean(dim=dims, dtype=torch.promote_types(x.dtype, torch.float32)
                  ).to(x.dtype)


def to_ncdhw(x: torch.Tensor) -> torch.Tensor:
    """Channels-last (B, D, H, W, C) — the JAX layout kept at the public
    boundary — to the (B, C, D, H, W) layout ``conv3d`` takes."""
    return x.permute(0, 4, 1, 2, 3)
