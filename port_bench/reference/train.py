"""The reference's training steps and evaluation, for the comparison that
decides a training cell's ``correct``.

Given the benchmark's initial weights, the same batches the program was
fed (rows of the benchmark's cohort, in the order the benchmark's shuffle
seed puts them) and the seed of the program's dropout generator, it works
out again what the program should have done: the dropout uniforms drawn
from a generator seeded alike, in forward order, the loss, the gradients,
the clip and the Adam or AdamW update, the BatchNorm running stats, and
then the eval-mode hazards and the C-index over the validation rows.
"""

from __future__ import annotations

import torch

from . import model as ref_model
from . import survival


def train_loss(cfg: dict, ctx, w: dict, batch: dict):
    hazard, gates = ref_model.forward(cfg, ctx, w, batch)
    loss = survival.cox_loss(hazard, batch["time"], batch["event"],
                             batch["svalid"] * batch["valid"])
    if gates is not None:
        loss = loss + cfg["train"]["gate_entropy_weight"] * \
            survival.gate_entropy(gates, batch["valid"])
    return loss


def run_steps(cfg: dict, weights: dict, batches: list, dropout_seed: int,
              lr: float, frozen: bool = False):
    """The reference's steps over ``batches`` (dicts of device tensors)
    from ``weights`` (not modified). Returns ``(losses, first_grads,
    states)``: each step's loss, the first step's gradient as the optimizer
    takes it, and the weights and buffers after each step. ``frozen`` (a
    planted fault of the control) leaves weights, buffers and moments as
    they were at every step: the first gradient reads as zeros."""
    dev = next(iter(weights.values())).device
    gen = torch.Generator(device=dev).manual_seed(dropout_seed)
    w = {k: v.clone() for k, v in weights.items()}
    params = {k: v for k, v in w.items() if ref_model.is_trained(k)}
    opt = {"kind": cfg["train"]["optimizer"],
           "weight_decay": cfg["train"]["weight_decay"],
           "grad_clip": cfg["train"]["grad_clip"]}
    state = {"mu": {}, "nu": {}, "count": 0}
    losses, first, states = [], None, []
    for batch in batches:
        ctx = ref_model.Context(train=True, dropout_generator=gen)
        leaves = {k: v.requires_grad_(True) for k, v in params.items()}
        loss = train_loss(cfg, ctx, {**w, **leaves}, batch)
        grads = torch.autograd.grad(loss, list(leaves.values()))
        for v in leaves.values():
            v.requires_grad_(False)
        if frozen:
            took = {k: torch.zeros_like(v) for k, v in params.items()}
        else:
            took = survival.adam_step(params, dict(zip(leaves, grads)),
                                      state, opt, lr)
            with torch.no_grad():
                w.update(ref_model.new_buffers(w, ctx.stats))
        losses.append(float(loss.detach()))
        states.append({k: v.clone() for k, v in w.items()})
        if first is None:
            first = took
    return losses, first, states


@torch.no_grad()
def follow_losses(cfg: dict, states: list, batches: list,
                  dropout_seed: int) -> list:
    """Each step's train-mode loss at the state it started from:
    ``states[k]`` is the state before step ``k + 1`` (the first, the
    benchmark's weights); the dropout uniforms are drawn in the same order
    as in the steps, so each step sees its own masks."""
    dev = batches[0]["time"].device
    gen = torch.Generator(device=dev).manual_seed(dropout_seed)
    return [float(train_loss(cfg, ref_model.Context(True, gen), w, batch))
            for w, batch in zip(states, batches)]


@torch.no_grad()
def eval_hazards(cfg: dict, w: dict, data: dict, rows, block: int = 64):
    """Eval-mode hazards of ``rows`` of ``data``, ``block`` rows at a time."""
    ctx = ref_model.Context(train=False)
    out = []
    for i in range(0, len(rows), block):
        idx = rows[i:i + block]
        batch = {k: v[idx] for k, v in data.items()}
        out.append(ref_model.forward(cfg, ctx, w, batch)[0].float())
    return torch.cat(out)
