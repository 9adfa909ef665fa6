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
global RNG holds. Inside :func:`dropout_uniforms` it takes its uniforms
from the caller instead (the fold-parallel step draws each fold's from that
fold's generator outside ``torch.func.vmap``, which cannot vmap a
generator).

Under a data-parallel mesh (``parallel/sharding.py:shard_module`` sets
``data_group`` on both layers) each rank holds its rows of the global
batch: ``BatchNorm`` takes Σx, Σx² and the row count over the group
(``parallel.collectives.all_reduce_sum``) and ``Dropout`` draws the global
batch's uniforms from its generator, seeded alike on every rank, and keeps
its rows — statistics, running stats and masks are the single-device ones.

:func:`remat` runs a module as a recompute region (JAX's ``nn.remat``) in
which both layers stay right: BatchNorm updates once, dropout reuses its
mask.

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

import contextlib
import contextvars
import math

import torch
import torch.nn.functional as F
from torch import nn

from ..parallel.collectives import all_reduce_sum, group_rank_size


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

    data_group = None  # the data-parallel group (module docstring)

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
            if self.data_group is None:
                mean = xf.mean(axes)
                var = ((xf * xf).mean(axes) - mean * mean).clamp_min(0.0)
            else:
                c = xf.shape[1]
                sums = all_reduce_sum(torch.cat([
                    xf.sum(axes), (xf * xf).sum(axes),
                    xf.new_full((1,), xf.numel() // c)]), self.data_group)
                n = sums[-1]
                mean = sums[:c] / n
                var = (sums[c:2 * c] / n - mean * mean).clamp_min(0.0)
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
        update, shared with the fused stage of ``densenet3d.py``. Inside a
        :func:`remat` region the update is handed to the region instead,
        which makes it once, after its forward."""
        region = _REGION.get()
        if region is not None:
            region[self] = (mean, var)
            return
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

    data_group = None  # the data-parallel group (module docstring)

    def __init__(self, p: float, generator: torch.Generator | None = None):
        super().__init__()
        self.p = p
        self.generator = generator

    def uniforms(self, shape, device) -> torch.Tensor | None:
        """The float32 uniforms this layer draws for an input of ``shape``
        on ``device`` (this rank's rows): those of the global batch, from
        the :func:`dropout_uniforms` source or the generator; None where
        the layer is the identity (eval mode, ``p == 0``)."""
        if not self.training or self.p == 0:
            return None
        size = 1 if self.data_group is None else \
            group_rank_size(self.data_group)[1]
        shape = (shape[0] * size, *shape[1:])  # the global batch's
        source = _UNIFORMS.get()
        if source is not None:
            # the source reads the shape and device of its argument only
            u = source(torch.empty((), device=device).expand(shape))
            if u.shape != shape:
                raise RuntimeError(
                    f"dropout uniforms of shape {tuple(u.shape)} for an "
                    f"input of shape {shape}")
            return u
        if self.generator is None:
            raise RuntimeError(
                "Dropout in train mode needs a generator: call "
                "set_dropout_generator(model, generator)")
        # the uniforms in float32 whatever x's type (flax draws its
        # bernoulli mask in float32): bf16 uniforms take ~1,700 values and
        # would move the keep rate
        return torch.rand(shape, generator=self.generator, device=device,
                          dtype=torch.float32)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        u = self.uniforms(x.shape, x.device)
        if u is None:
            return x
        if self.data_group is not None:
            rank, size = group_rank_size(self.data_group)
            b = x.shape[0]
            if size > 1:
                u = u[rank * b:(rank + 1) * b]
        return torch.where(u >= self.p, x / (1 - self.p), 0.0)

    def extra_repr(self) -> str:
        return f"p={self.p}"


_UNIFORMS: contextvars.ContextVar = contextvars.ContextVar(
    "dropout_uniforms", default=None)


@contextlib.contextmanager
def dropout_uniforms(source):
    """Within the block, every train-mode :class:`Dropout` with ``p > 0``
    takes its float32 uniforms from ``source(x)`` (a tensor of ``x``'s
    shape), in forward order, instead of drawing them from its generator."""
    token = _UNIFORMS.set(source)
    try:
        yield
    finally:
        _UNIFORMS.reset(token)


_REGION: contextvars.ContextVar = contextvars.ContextVar(
    "remat_region", default=None)


def in_remat_region() -> bool:
    """True while a :func:`remat` region runs its module (its forward or
    its recompute): the module then takes its plain path."""
    return _REGION.get() is not None


class _Recompute(torch.autograd.Function):
    """``run(*tensors) -> (out, *stats)`` without saving its intermediates:
    the forward keeps only its inputs, and the backward runs ``run`` again
    under ``torch.func.vjp`` (the recompute) and takes the vector-Jacobian
    product of ``out`` with respect to the first ``n_diff`` tensors. The
    ``stats`` outputs are not differentiable. The setup_context form and
    the generated vmap rule let it run under ``torch.func`` transforms
    (``torch.utils.checkpoint`` does not: its saved-tensor hooks and its
    reentrant Function are refused by ``grad``)."""

    generate_vmap_rule = True

    @staticmethod
    def forward(run, n_diff, *tensors):
        return run(*tensors)

    @staticmethod
    def setup_context(ctx, inputs, output):
        run, n_diff, *tensors = inputs
        ctx.run, ctx.n_diff = run, n_diff
        ctx.save_for_backward(*tensors)
        ctx.mark_non_differentiable(*output[1:])

    @staticmethod
    def backward(ctx, g, *_stats):
        tensors = ctx.saved_tensors
        diff, rest = tensors[:ctx.n_diff], tensors[ctx.n_diff:]
        _, vjp = torch.func.vjp(lambda *d: ctx.run(*d, *rest)[0], *diff)
        return (None, None, *vjp(g), *(None for _ in rest))


def remat(module: nn.Module, *inputs: torch.Tensor, uniforms=(),
          **kwargs) -> torch.Tensor:
    """``module(*inputs, **kwargs)`` as a recompute region (JAX
    ``nn.remat``): its activations are not kept for the backward, which
    runs the module again. Safe for this package's layers:

      * :class:`BatchNorm` updates its running stats once, after the
        forward (the region returns the batch statistics; the recompute's
        are dropped), so ``num_batches_tracked`` moves by one;
      * :class:`Dropout` inside the region takes ``uniforms`` (one tensor
        a dropout layer of the region, in forward order, drawn by the
        caller with :meth:`Dropout.uniforms` before the region), both in
        the forward and in the recompute: the mask is drawn once;
      * a :class:`BatchNorm` with a ``data_group`` all-reduces again in
        the recompute, as JAX's remat recomputes its ``psum``.

    Serves the Trainer's eager ``torch.autograd.grad`` and the stacked
    ``vmap(grad_and_value)`` of ``train/cv_parallel.py``. ``module``'s
    forward must call this only when :func:`in_remat_region` is False."""
    named = list(module.named_parameters())
    names, params = [n for n, _ in named], [p for _, p in named]
    norms = [m for m in module.modules() if isinstance(m, BatchNorm)]
    n_in, n_p = len(inputs), len(params)

    def run(*tensors):
        feed = iter(tensors[n_in + n_p:])
        stats: dict = {}
        token = _REGION.set(stats)
        try:
            with dropout_uniforms(lambda _: next(feed)):
                out = torch.func.functional_call(
                    module, dict(zip(names, tensors[n_in:n_in + n_p])),
                    tensors[:n_in], kwargs)
        finally:
            _REGION.reset(token)
        return (out, *(t for m in norms for t in stats[m]))

    out = _Recompute.apply(run, n_in + n_p, *inputs, *params, *uniforms)
    for i, m in enumerate(norms):
        m.update_running_stats(out[1 + 2 * i], out[2 + 2 * i])
    return out[0]


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
