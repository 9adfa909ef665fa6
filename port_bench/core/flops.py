"""Floating-point operations of one training step and one eval forward,
counted by ``torch.utils.flop_counter.FlopCounterMode`` over the plain
reference model on the meta device (shapes only, no data): the same work
whatever implements it. The fused stages of the program run through
``ctypes`` and are no aten ops, so a count over the program would miss
them. Every count is linear in the batch, so the configuration file keeps
it per patient."""

from __future__ import annotations

import torch
from torch.utils.flop_counter import FlopCounterMode

from port_bench.reference import model as ref_model
from port_bench.reference import train as ref_train


def _meta_inputs(cfg: dict, batch: int) -> tuple:
    arch = cfg["arch"]
    d, h, w = arch["image_shape"]
    meta = torch.device("meta")
    weights = {}
    for key, shape, init in ref_model.param_spec(cfg):
        dtype = torch.long if init[0] == "count" else torch.float32
        weights[key] = torch.empty(shape, dtype=dtype, device=meta)
    data = {
        "image": torch.empty((batch, d, h, w, 1), device=meta),
        "rnaseq": torch.empty((batch, arch["rna_dim"]), device=meta),
        "clinical": torch.empty((batch, 1), device=meta),
        "mask": torch.empty((batch, 3), device=meta),
        "time": torch.empty((batch,), device=meta),
        "event": torch.empty((batch,), device=meta),
        "svalid": torch.empty((batch,), device=meta),
        "valid": torch.empty((batch,), device=meta),
    }
    return weights, data


class _MetaContext(ref_model.Context):
    """Dropout as a mask multiply of the same shape (no generator on the
    meta device); elementwise work is not counted either way."""

    def dropout(self, x, p):
        if not self.train or p == 0:
            return x
        return x * torch.empty_like(x)


def count(cfg: dict, batch: int, train: bool) -> int:
    """FLOPs of one step (forward and backward, ``train``) or one eval
    forward at ``batch`` patients."""
    weights, data = _meta_inputs(cfg, batch)
    trained = {k: v.requires_grad_(True) for k, v in weights.items()
               if ref_model.is_trained(k)}
    with FlopCounterMode(display=False) as fc:
        if train:
            loss = ref_train.train_loss(cfg, _MetaContext(train=True),
                                        {**weights, **trained}, data)
            torch.autograd.grad(loss, list(trained.values()))
        else:
            with torch.no_grad():
                ref_model.forward(cfg, _MetaContext(train=False), weights,
                                  data)
    return int(fc.get_total_flops())


def per_patient(cfg: dict) -> dict:
    """``{"train_per_patient", "eval_per_patient"}`` (counted at batch 2
    and halved, so that BatchNorm sees more than one row)."""
    return {"train_per_patient": count(cfg, 2, True) // 2,
            "eval_per_patient": count(cfg, 2, False) // 2}
