"""Plain PyTorch reference of the benchmarked model families: the layers
they share, and each family's model in ``families/<family>.py``.

Written from the published model definitions (baek0203/
multimodal_survival_prediction, MONAI ``DenseNet121(spatial_dims=3)``), as
functions of a flat ``{key: tensor}`` dict with the reference's state_dict
keys. Plain ``torch`` operations only: no kernel, no cache, no batching
trick. It imports nothing of the measured program.

One departure from the published PyTorch models, stated by the
configuration file: BatchNorm keeps flax's semantics (momentum 0.9 on the
running average, the BIASED batch variance in the running variance), which
is what the measured program implements.

A forward returns ``(outputs, bn_stats)``: ``bn_stats`` maps each BatchNorm
prefix to its train-mode batch ``(mean, biased var)``; :func:`new_buffers`
turns them into the running stats after the step.
"""

from __future__ import annotations

import importlib
import math

import torch
import torch.nn.functional as F

BN_EPS = 1e-5
BN_MOMENTUM = 0.9


# ---------------------------------------------------------------------------
# parameter specification
# ---------------------------------------------------------------------------

def linear_spec(spec, key, n_in, n_out, zero_bias=False):
    bound = 1.0 / math.sqrt(n_in)
    spec.append((f"{key}.weight", (n_out, n_in), ("uniform", bound)))
    spec.append((f"{key}.bias", (n_out,),
                 ("zeros",) if zero_bias else ("uniform", bound)))


def bn_spec(spec, key, c):
    spec.append((f"{key}.weight", (c,), ("ones",)))
    spec.append((f"{key}.bias", (c,), ("zeros",)))
    spec.append((f"{key}.running_mean", (c,), ("buffer_zeros",)))
    spec.append((f"{key}.running_var", (c,), ("buffer_ones",)))
    spec.append((f"{key}.num_batches_tracked", (), ("count",)))


def conv_spec(spec, key, c_in, c_out, k):
    fan_in = c_in * k ** 3
    spec.append((f"{key}.weight", (c_out, c_in, k, k, k),
                 ("normal", math.sqrt(2.0 / fan_in))))  # kaiming, MONAI


def densenet_spec(spec, prefix, arch):
    """MONAI DenseNet121 3D's keys under ``prefix``."""
    c = arch["init_features"]
    g, bn_size = arch["growth_rate"], arch["bn_size"]
    f = f"{prefix}.features"
    conv_spec(spec, f"{f}.conv0", arch["in_channels"], c, 7)
    bn_spec(spec, f"{f}.norm0", c)
    blocks = arch["block_config"]
    for bi, n_layers in enumerate(blocks):
        for li in range(n_layers):
            k = f"{f}.denseblock{bi + 1}.denselayer{li + 1}.layers"
            c_in = c + li * g
            bn_spec(spec, f"{k}.norm1", c_in)
            conv_spec(spec, f"{k}.conv1", c_in, bn_size * g, 1)
            bn_spec(spec, f"{k}.norm2", bn_size * g)
            conv_spec(spec, f"{k}.conv2", bn_size * g, g, 3)
        c += n_layers * g
        if bi != len(blocks) - 1:
            bn_spec(spec, f"{f}.transition{bi + 1}.norm", c)
            conv_spec(spec, f"{f}.transition{bi + 1}.conv", c, c // 2, 1)
            c //= 2
    bn_spec(spec, f"{f}.norm5", c)
    linear_spec(spec, f"{prefix}.class_layers.out", c, arch["out_features"],
            zero_bias=True)


def family(cfg: dict):
    """The reference of ``cfg``'s family: ``reference/families/<family>.py``,
    which gives ``param_spec(arch)`` and ``forward(ctx, w, arch, batch)``.
    A new family is a new file there."""
    return importlib.import_module(f"{__package__}.families.{cfg['family']}")


def param_spec(cfg: dict) -> list:
    """``[(key, shape, init)]`` of ``cfg``'s family in state_dict order.
    ``init`` is ``("uniform", bound)``, ``("normal", std)``, ``("ones",)``,
    ``("zeros",)``, ``("buffer_zeros",)``, ``("buffer_ones",)`` or
    ``("count",)`` (the int64 ``num_batches_tracked``)."""
    return family(cfg).param_spec(cfg["arch"])


def is_trained(key: str) -> bool:
    """A parameter the optimizer updates (not a BatchNorm buffer)."""
    return not key.endswith(("running_mean", "running_var",
                             "num_batches_tracked"))


# ---------------------------------------------------------------------------
# layers
# ---------------------------------------------------------------------------

class Context:
    """What a forward needs besides the weights: train or eval mode, where
    dropout uniforms come from, and where train-mode batch statistics go."""

    def __init__(self, train: bool, dropout_generator=None):
        self.train = train
        self.generator = dropout_generator
        self.stats: dict = {}

    def dropout(self, x, p):
        if not self.train or p == 0:
            return x
        u = torch.rand(x.shape, generator=self.generator, device=x.device,
                       dtype=torch.float32)
        return torch.where(u < p, torch.zeros_like(x), x / (1 - p))


def batch_norm(ctx: Context, w: dict, key: str, x):
    shape = (1, -1) + (1,) * (x.dim() - 2)
    if ctx.train:
        dims = [0, *range(2, x.dim())]
        var, mean = torch.var_mean(x, dim=dims, correction=0)
        ctx.stats[key] = (mean.detach(), var.detach())
    else:
        mean, var = w[f"{key}.running_mean"], w[f"{key}.running_var"]
    scale = torch.rsqrt(var + BN_EPS) * w[f"{key}.weight"]
    return (x - mean.view(shape)) * scale.view(shape) + \
        w[f"{key}.bias"].view(shape)


def linear(w, key, x):
    return F.linear(x, w[f"{key}.weight"], w[f"{key}.bias"])


def densenet(ctx: Context, w: dict, prefix: str, arch: dict, image):
    """(B, D, H, W, 1) channels-last CT -> (B, out_features)."""
    f = f"{prefix}.features"
    x = image.permute(0, 4, 1, 2, 3)
    x = F.conv3d(x, w[f"{f}.conv0.weight"], stride=2, padding=3)
    x = F.relu(batch_norm(ctx, w, f"{f}.norm0", x))
    x = F.max_pool3d(x, 3, 2, padding=1)
    blocks = arch["block_config"]
    for bi, n_layers in enumerate(blocks):
        for li in range(n_layers):
            k = f"{f}.denseblock{bi + 1}.denselayer{li + 1}.layers"
            y = F.relu(batch_norm(ctx, w, f"{k}.norm1", x))
            y = F.conv3d(y, w[f"{k}.conv1.weight"])
            y = F.relu(batch_norm(ctx, w, f"{k}.norm2", y))
            y = F.conv3d(y, w[f"{k}.conv2.weight"], padding=1)
            x = torch.cat([x, y], dim=1)  # DenseNet dropout rate is 0
        if bi != len(blocks) - 1:
            t = f"{f}.transition{bi + 1}"
            y = F.relu(batch_norm(ctx, w, f"{t}.norm", x))
            x = F.avg_pool3d(F.conv3d(y, w[f"{t}.conv.weight"]), 2, 2)
    x = F.relu(batch_norm(ctx, w, f"{f}.norm5", x))
    return linear(w, f"{prefix}.class_layers.out", x.mean(dim=(2, 3, 4)))


def mlp_cell(ctx, w, lin, bn, x, p):
    """Linear -> BatchNorm -> ReLU -> Dropout (the published cell)."""
    return ctx.dropout(F.relu(batch_norm(ctx, w, bn, linear(w, lin, x))), p)


def forward(cfg: dict, ctx: Context, w: dict, batch: dict):
    """``(hazard, gates or None)`` of ``cfg``'s family."""
    return family(cfg).forward(ctx, w, cfg["arch"], batch)


def new_buffers(w: dict, stats: dict) -> dict:
    """The BatchNorm buffers after one train-mode forward with ``stats``."""
    out = {}
    m = BN_MOMENTUM
    for key, (mean, var) in stats.items():
        out[f"{key}.running_mean"] = m * w[f"{key}.running_mean"] + \
            (1 - m) * mean
        out[f"{key}.running_var"] = m * w[f"{key}.running_var"] + \
            (1 - m) * var
        out[f"{key}.num_batches_tracked"] = \
            w[f"{key}.num_batches_tracked"] + 1
    return out
