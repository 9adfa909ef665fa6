"""Device-resident training engine (port of
``multimodal_survival_prediction_tpu/train/engine.py``).

The whole cohort lives on the device as fixed-shape tensors; an epoch is a
Python loop over shuffled, padded batch indices with one host read-back
(the epoch's mean loss) at its end. Semantics kept from the JAX engine:
  * Cox loss on the survival-labeled subset of each batch (masked; exactly 0
    for batches with <2 labeled rows or no event),
  * a ragged last batch padded by cycling the epoch's own permutation
    (padded rows are masked out of the loss but seen by BatchNorm),
  * optax's ``clip_by_global_norm`` (``g·max/‖g‖`` when ``‖g‖ > max``),
    then torch Adam's L2 (added to the gradient before the moments) or
    AdamW's decoupled decay, with a learning rate fed per epoch by the host,
  * pooled evaluation: hazards of all eval batches, one C-index.

The parameters and BatchNorm buffers live in the model module; the
optimizer's moments are updated in place (``torch._foreach_*``).

Not ported yet (each raises ``NotImplementedError`` naming its ROADMAP
item): streaming epochs, meshes / tensor parallelism / the sharded risk
set, and the compiled-executable cache.
"""

from __future__ import annotations

import dataclasses
from typing import Callable

import numpy as np
import torch
from torch import nn

from ..models.layers import set_dropout_generator
from ..ops.cindex import concordance_index
from ..ops.cox import cox_partial_likelihood
from ..utils.device import resolve_device

_MULTI_DEVICE_TODO = ("meshes, tensor parallelism and the sharded risk set "
                      "are not ported yet: ROADMAP.md Queue 1 item 10")
_STREAMING_TODO = ("streaming epochs (host-resident cohort, BatchPrefetcher) "
                   "are not ported yet: ROADMAP.md Queue 1 item 11")
_AOT_TODO = ("aot_cache_dir is not ported yet: ROADMAP.md Queue 1 item 12")


@dataclasses.dataclass(frozen=True)
class TrainConfig:
    batch_size: int = 16
    eval_batch_size: int = 64
    learning_rate: float = 1e-4
    weight_decay: float = 1e-4
    optimizer: str = "adam"  # 'adam' (torch Adam + L2) or 'adamw' (decoupled)
    grad_clip: float | None = 1.0
    ties: str = "breslow"
    seed: int = 42


@dataclasses.dataclass
class AdamState:
    mu: list  # first moments, one per parameter
    nu: list  # second moments
    count: int = 0


class Optimizer:
    """optax's ``chain(clip_by_global_norm(clip), add_decayed_weights(wd),
    scale_by_adam(0.9, 0.999, 1e-8), scale(-1))`` (``'adam'``) or with the
    decay after Adam (``'adamw'``), the update scaled by a host-fed LR —
    over lists of tensors in parameter order."""

    def __init__(self, cfg: TrainConfig, b1: float = 0.9, b2: float = 0.999,
                 eps: float = 1e-8):
        if cfg.optimizer not in ("adam", "adamw"):
            raise ValueError(f"unknown optimizer {cfg.optimizer!r}")
        self.kind = cfg.optimizer
        self.grad_clip = cfg.grad_clip
        self.weight_decay = cfg.weight_decay
        self.b1, self.b2, self.eps = b1, b2, eps

    def init(self, params: list) -> AdamState:
        return AdamState(mu=[torch.zeros_like(p) for p in params],
                         nu=[torch.zeros_like(p) for p in params])

    def update(self, grads: list, state: AdamState, params: list,
               lr: float):
        """``(updates, state)``; ``state``'s moments are updated in place."""
        g = list(grads)
        if self.grad_clip is not None:
            # optax: where(‖g‖ < max, g, (g / ‖g‖) · max), without a host
            # sync (dividing and multiplying by 1 is exact)
            norm = torch.linalg.vector_norm(torch.stack(torch._foreach_norm(g)))
            under = norm < self.grad_clip
            g = torch._foreach_div(g, torch.where(under, 1.0, norm))
            torch._foreach_mul_(g, torch.where(under, 1.0, self.grad_clip))
        if self.kind == "adam" and self.weight_decay:
            g = torch._foreach_add(g, params, alpha=self.weight_decay)
        b1, b2 = self.b1, self.b2
        torch._foreach_mul_(state.mu, b1)
        torch._foreach_add_(state.mu, g, alpha=1 - b1)
        torch._foreach_mul_(state.nu, b2)
        torch._foreach_addcmul_(state.nu, g, g, value=1 - b2)
        state.count += 1
        mu_hat = torch._foreach_div(state.mu, 1 - b1 ** state.count)
        nu_hat = torch._foreach_div(state.nu, 1 - b2 ** state.count)
        denom = torch._foreach_sqrt(nu_hat)
        torch._foreach_add_(denom, self.eps)
        updates = torch._foreach_div(mu_hat, denom)
        if self.kind == "adamw" and self.weight_decay:
            torch._foreach_add_(updates, params, alpha=self.weight_decay)
        torch._foreach_mul_(updates, -lr)
        return updates, state


def make_optimizer(cfg: TrainConfig) -> Optimizer:
    """clip -> (adam | adamw) with unit LR; the LR is applied per step."""
    return Optimizer(cfg)


@dataclasses.dataclass
class TrainState:
    model: nn.Module  # parameters and BatchNorm running stats
    opt_state: AdamState
    step: int
    dropout_generator: torch.Generator


def _init_seed(seed: int, fold: int) -> int:
    """A fold-varying init seed (the counterpart of ``fold_in``)."""
    return int(np.random.SeedSequence([seed, fold]).generate_state(1)[0])


class Trainer:
    """Drives one model through epochs on device-resident data.

    Args:
      model_fn: ``generator -> nn.Module``: builds the model with its
          weights drawn from ``generator`` (the counterpart of the flax
          module definition the JAX trainer initializes).
      batch_to_inputs: fn(batch_dict) -> tuple of positional model args.
      hazard_and_aux: fn(model_outputs, batch) -> (hazard (B,), aux_loss)
          or (hazard, aux, main_scale); defaults to identity hazard.
      cfg: TrainConfig.
      device: where the model and the data live ("cuda" unless asked).
    """

    def __init__(self, model_fn: Callable[[torch.Generator], nn.Module],
                 batch_to_inputs: Callable,
                 hazard_and_aux: Callable | None = None,
                 cfg: TrainConfig = TrainConfig(), device="cuda", mesh=None,
                 tensor_parallel: bool = False,
                 sharded_risk_set: bool = False, aot_cache_dir=None):
        if mesh is not None or tensor_parallel or sharded_risk_set:
            raise NotImplementedError(_MULTI_DEVICE_TODO)
        if aot_cache_dir:
            raise NotImplementedError(_AOT_TODO)
        self.model_fn = model_fn
        self.batch_to_inputs = batch_to_inputs
        self.hazard_and_aux = hazard_and_aux or (lambda out, batch: (out, 0.0))
        self.cfg = cfg
        self.device = resolve_device(device)
        self.tx = make_optimizer(cfg)
        self.step_losses = None  # the last epoch's per-step losses (device)

    # ---------------- init ----------------

    def init_state(self, fold: int = 0, seed: int | None = None) -> TrainState:
        """A fresh model for ``fold``: weights from a generator seeded by
        ``(seed, fold)`` (``seed`` defaults to ``cfg.seed``), dropout masks
        from a generator on the device seeded ``seed*1000 + fold`` (the JAX
        CV driver's per-fold dropout key)."""
        seed = self.cfg.seed if seed is None else seed
        gen = torch.Generator().manual_seed(_init_seed(seed, fold))
        model = self.model_fn(gen).to(self.device)
        drop = torch.Generator(device=self.device).manual_seed(
            seed * 1000 + fold)
        set_dropout_generator(model, drop)
        params = list(model.parameters())
        return TrainState(model=model, opt_state=self.tx.init(params), step=0,
                          dropout_generator=drop)

    # ---------------- loss ----------------

    def _loss_fn(self, model: nn.Module, batch: dict) -> torch.Tensor:
        out = model(*self.batch_to_inputs(batch))
        # the adapter returns (hazard, aux) or (hazard, aux, main_scale);
        # main_scale=0 turns off the Cox term (SimMLM stage 1)
        res = self.hazard_and_aux(out, batch)
        hazard, aux = res[0], res[1]
        main_scale = res[2] if len(res) > 2 else 1.0
        cox = cox_partial_likelihood(hazard, batch["time"], batch["event"],
                                     valid=batch["svalid"],
                                     ties=self.cfg.ties)
        return main_scale * cox + aux

    def loss_and_grads(self, state: TrainState, batch: dict):
        """Train-mode loss on ``batch`` and its gradient per parameter (in
        ``model.parameters()`` order; zeros where a parameter is unused).
        Updates the BatchNorm running stats, as the forward does."""
        model = state.model.train()
        loss = self._loss_fn(model, batch)
        grads = torch.autograd.grad(loss, list(model.parameters()),
                                    allow_unused=True, materialize_grads=True)
        return loss.detach(), grads

    def train_step(self, state: TrainState, batch: dict, lr: float):
        """One optimizer step on ``batch``; returns the loss (a device
        scalar) and updates ``state`` in place."""
        loss, grads = self.loss_and_grads(state, batch)
        params = list(state.model.parameters())
        updates, state.opt_state = self.tx.update(grads, state.opt_state,
                                                  params, lr)
        with torch.no_grad():
            torch._foreach_add_(params, updates)
        state.step += 1
        return loss

    # ---------------- batches ----------------

    @staticmethod
    def _gather_batch(data: dict, idx: torch.Tensor, bvalid: torch.Tensor):
        batch = {k: v[idx] for k, v in data.items()}
        batch["valid"] = bvalid
        batch["svalid"] = batch["svalid"] * bvalid
        return batch

    @staticmethod
    def _pad_indices(indices, batch_size: int,
                     rng: np.random.Generator | None):
        """Pad a fold's global row indices to (steps, batch) + validity mask.

        Fixed shapes keep the epoch jit-stable; the padded tail stands in for
        the reference DataLoader's ragged final batch (no drop_last). Padded
        rows cycle the epoch's own permutation (not a constant row) so the
        duplicates feeding BatchNorm statistics are spread across the cohort;
        their loss contribution is masked to 0 via ``bvalid`` (see module
        docstring for the BN deviation)."""
        indices = np.asarray(indices, np.int32)
        order = rng.permutation(indices) if rng is not None else indices
        n = len(indices)
        steps = max(1, -(-n // batch_size))
        padded = steps * batch_size
        idx = np.empty(padded, np.int32)
        idx[:n] = order
        if padded > n:
            idx[n:] = np.resize(order, padded - n)
        bvalid = np.zeros(padded, np.float32)
        bvalid[:n] = 1.0
        return (idx.reshape(steps, batch_size),
                bvalid.reshape(steps, batch_size))

    def _device_indices(self, idx: np.ndarray, bvalid: np.ndarray):
        return (torch.from_numpy(idx.astype(np.int64)).to(self.device),
                torch.from_numpy(bvalid).to(self.device))

    # ---------------- host-side API ----------------

    def train_epoch(self, state: TrainState, data: dict, indices,
                    shuffle_rng: np.random.Generator, lr: float):
        """One epoch over ``indices`` (global row ids into ``data``, a dict
        of tensors on the device). Returns ``(state, mean loss)``."""
        perm, bvalid = self._pad_indices(indices, self.cfg.batch_size,
                                         shuffle_rng)
        perm, bvalid = self._device_indices(perm, bvalid)
        self.step_losses = torch.stack([
            self.train_step(state, self._gather_batch(data, i, bv), lr)
            for i, bv in zip(perm, bvalid)])
        return state, float(self.step_losses.mean())

    def evaluate(self, state: TrainState, data: dict, indices):
        """Pooled C-index, mean loss and per-sample hazards over
        ``indices`` (reference final_multimodal.py:268-305): eval batches of
        ``cfg.eval_batch_size`` in index order, their hazards pooled into
        one C-index."""
        idx, bvalid = self._pad_indices(indices, self.cfg.eval_batch_size,
                                        None)
        idx, bvalid = self._device_indices(idx, bvalid)
        model = state.model.eval()
        hs, ts, es, svs, losses = [], [], [], [], []
        with torch.inference_mode():
            for bidx, bv in zip(idx, bvalid):
                batch = self._gather_batch(data, bidx, bv)
                out = model(*self.batch_to_inputs(batch))
                hazard = self.hazard_and_aux(out, batch)[0]
                losses.append(cox_partial_likelihood(
                    hazard, batch["time"], batch["event"],
                    valid=batch["svalid"], ties=self.cfg.ties))
                hs.append(hazard)
                ts.append(batch["time"])
                es.append(batch["event"])
                svs.append(batch["svalid"])
            h = torch.cat(hs)
            cindex = concordance_index(h, torch.cat(ts), torch.cat(es),
                                       valid=torch.cat(svs))
            loss = torch.stack(losses).mean()
        return (float(cindex), float(loss),
                h[: len(indices)].float().cpu().numpy())

    def train_epoch_streaming(self, *args, **kwargs):
        raise NotImplementedError(_STREAMING_TODO)

    def evaluate_streaming(self, *args, **kwargs):
        raise NotImplementedError(_STREAMING_TODO)
