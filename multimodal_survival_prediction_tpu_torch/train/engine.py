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

On a card, ``train_epoch`` without a mesh replays each step as one CUDA
graph (``train/graphs.py:CapturedStep``), the counterpart of JAX's jitted
epoch: the step (batch gather, forward, Cox loss, backward, clip, Adam, the
update) reads its batch's rows and validity, the learning rate and Adam's
bias corrections from static device buffers, is captured once per train
state, cohort and batch shape, and is replayed for every later step. On the
CPU the same static-input step runs eagerly. The streaming epochs, the
mesh's steps and evaluation run eagerly; the fold-parallel step
(``train/cv_parallel.py``) is captured by the same ``CapturedStep``.

Streaming epochs (``train_epoch_streaming``, ``evaluate_streaming``) keep
the cohort on the host as numpy arrays: each batch is gathered there and
copied to the device by ``data.pipeline.BatchPrefetcher`` while the previous
step runs. Batch order, dropout draws and arithmetic are those of the
device-resident methods, so both give the same trajectory.

Under a ``mesh`` (a ``DeviceMesh`` with dims ``("data", "model")``,
``parallel/mesh.py``; one process a device) every rank holds the whole
cohort and the same weights, and takes its contiguous rows of each batch
(``parallel/sharding.py``). A step: the model on the local rows, its
outputs and the loss's labels gathered over ``data`` (every rank computes
the whole batch's loss, as GSPMD's gathered hazards give JAX's global risk
set), the backward, then one all-reduce (a SUM: each rank's gradient holds
only its rows' part) of the gradients over ``data``. BatchNorm statistics
and dropout masks are the global batch's (``models/layers.py``), so the run
follows the single-device trajectory. ``sharded_risk_set`` computes the
train Cox loss with ``ops/cox_distributed.py``; ``tensor_parallel`` makes
the wide dense layers column-parallel over ``model`` when that axis is
larger than 1, and the global-norm clip then counts each shard once
(squared norms summed over ``model``). The fused DenseNet stages hold
single-shard arrays (JAX ``ops/fused_dense.py``), so ``fused_bn1`` under a
data or model axis larger than 1 raises. DDP is not used: it averages.

Each epoch, step and phase of a step (forward, backward, optimizer, the
epoch's read-back; a replayed step's copies and replay), each capture and
``init_state`` record a span on the host clock (``utils/profiling.py``).

``aot_cache_dir`` routes the kernels' builds through the kernel-build
cache (``io/aot_cache.py``): the libraries this process builds on first
launch go into that directory, and a later process loads them instead of
compiling; ``Trainer.aot_info`` reports each one's provenance.
"""

from __future__ import annotations

import dataclasses
import itertools
from typing import Callable

import numpy as np
import torch
from torch import nn

from ..data.pipeline import BatchPrefetcher
from ..io import aot_cache
from ..models.layers import set_dropout_generator
from ..ops.cindex import concordance_index
from ..ops.cox import cox_partial_likelihood
from ..ops.cox_distributed import cox_partial_likelihood_sharded
from ..parallel.collectives import all_reduce_tensor, gather
from ..parallel.mesh import mesh_shape
from ..parallel.multihost import fetch_tree
from ..parallel.sharding import batch_rows, local_part, shard_module, tp_group
from ..utils.device import resolve_device
from ..utils.profiling import span
from .graphs import CapturedStep, backend_flags

# the batch keys the loss and the adapters read; under a mesh they are
# gathered to the global batch (the model inputs stay local)
LABEL_KEYS = ("time", "event", "svalid", "valid", "mask")


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
               lr: float, norm: torch.Tensor | None = None):
        """``(updates, state)``; ``state``'s moments are updated in place.
        ``norm``: the gradient's global norm when the caller computed it
        (tensor parallelism); by default it is taken over ``grads``."""
        bc1, bc2 = self.bias_corrections(state.count + 1)
        return self._update(grads, state, params, lr, float(bc1), float(bc2),
                            norm)

    def update_static(self, grads: list, state: AdamState, params: list,
                      scalars: torch.Tensor,
                      norm: torch.Tensor | None = None):
        """:meth:`update` with the learning rate and the two bias
        corrections read from ``scalars``, a (3,) tensor on the device (a
        row of :meth:`step_scalars` in the moments' dtype: for float32 and
        float64 moments, the rounding that :meth:`update`'s host floats
        get), so that a CUDA graph of the step bakes in no host value."""
        return self._update(grads, state, params, *scalars.unbind(), norm)

    def bias_corrections(self, counts) -> np.ndarray:
        """``(*counts.shape, 2)`` float64 ``1 - b1**c`` and ``1 - b2**c``
        for each Adam count ``c`` of ``counts`` (host ints): the one place
        :meth:`update`, :meth:`step_scalars` and the stacked epoch's table
        of :meth:`update_stacked` rows compute them."""
        counts = np.asarray(counts, np.int64)
        return np.array([(1 - self.b1 ** int(c), 1 - self.b2 ** int(c))
                         for c in counts.reshape(-1)],
                        np.float64).reshape(*counts.shape, 2)

    def step_scalars(self, lr: float, count: int, steps: int) -> np.ndarray:
        """``(steps, 3)`` float64 rows of ``lr``, ``1 - b1**c`` and
        ``1 - b2**c`` for the Adam counts ``c`` of the next ``steps``
        steps after ``count``, as :meth:`update` computes them."""
        return np.concatenate([
            np.full((steps, 1), lr, np.float64),
            self.bias_corrections(np.arange(count + 1, count + steps + 1))],
            axis=1)

    @torch.no_grad()
    def _update(self, grads: list, state: AdamState, params: list, lr,
                bc1, bc2, norm):
        """:meth:`update` and :meth:`update_static`: ``lr``, ``bc1`` and
        ``bc2`` host floats or 0-dim tensors. Under ``no_grad``: the decay
        term reads the parameters, and autograd would otherwise chain every
        step's moments to the last."""
        g = list(grads)
        if self.grad_clip is None:
            norm = None
        elif norm is None:
            norm = torch.linalg.vector_norm(
                torch.stack(torch._foreach_norm(g)))
        state.count += 1
        updates = self._adam(g, state.mu, state.nu, params, norm, bc1, bc2)
        torch._foreach_mul_(updates, -lr)
        return updates, state

    @torch.no_grad()
    def update_stacked(self, grads: torch.Tensor, mu: torch.Tensor,
                       nu: torch.Tensor, params: torch.Tensor,
                       bc: torch.Tensor, lr: torch.Tensor, sizes: list):
        """:meth:`update` of K states stacked on dim 0 of flat (K, P)
        tensors, each with its own global-norm clip, Adam count and
        learning rate: ``bc`` holds each state's two bias corrections for
        its count after this step ((K, 2) on the device, a row of
        :meth:`bias_corrections` in the moments' dtype: the rounding that
        :meth:`update`'s host floats get), ``lr`` is a (K, 1) tensor,
        ``sizes`` the parameters' numels in order (each row's clip norm is
        reduced as :meth:`update`'s, over the norms of its parameters).
        ``mu``, ``nu`` and ``params`` are updated in place; nothing is read
        from the host, so a CUDA graph of the stacked step bakes in no host
        value."""
        norm = None
        if self.grad_clip is not None:
            rows = [t for row in grads for t in row.split(sizes)]
            norm = torch.linalg.vector_norm(
                torch.stack(torch._foreach_norm(rows)).view(len(grads), -1),
                dim=1, keepdim=True)
        (updates,) = self._adam([grads], [mu], [nu], [params], norm,
                                [bc[:, :1]], [bc[:, 1:]])
        params.add_(updates.mul_(-lr))

    def _adam(self, g: list, mu: list, nu: list, params: list, norm,
              bc1, bc2) -> list:
        """The unscaled updates of :meth:`update` and
        :meth:`update_static` (lists of the parameters' tensors; ``norm`` a
        0-dim tensor, ``bc1`` and ``bc2`` floats or 0-dim tensors) and of
        :meth:`update_stacked` (lists of one flat (K, P) tensor; ``norm``
        (K, 1), ``bc1`` and ``bc2`` lists of one (K, 1) tensor). ``mu`` and
        ``nu`` are updated in place."""
        if norm is not None:
            # optax: where(‖g‖ < max, g, (g / ‖g‖) · max), without a host
            # sync (dividing and multiplying by 1 is exact)
            under = norm < self.grad_clip
            div = torch.where(under, 1.0, norm)
            mul = torch.where(under, 1.0, self.grad_clip)
            if norm.dim():  # a (K, 1) scale for each row
                div, mul = [div], [mul]
            g = torch._foreach_div(g, div)
            torch._foreach_mul_(g, mul)
        if self.kind == "adam" and self.weight_decay:
            g = torch._foreach_add(g, params, alpha=self.weight_decay)
        b1, b2 = self.b1, self.b2
        torch._foreach_mul_(mu, b1)
        torch._foreach_add_(mu, g, alpha=1 - b1)
        torch._foreach_mul_(nu, b2)
        torch._foreach_addcmul_(nu, g, g, value=1 - b2)
        mu_hat = torch._foreach_div(mu, bc1)
        nu_hat = torch._foreach_div(nu, bc2)
        denom = torch._foreach_sqrt(nu_hat)
        torch._foreach_add_(denom, self.eps)
        updates = torch._foreach_div(mu_hat, denom)
        if self.kind == "adamw" and self.weight_decay:
            torch._foreach_add_(updates, params, alpha=self.weight_decay)
        return updates


def make_optimizer(cfg: TrainConfig) -> Optimizer:
    """clip -> (adam | adamw) with unit LR; the LR is applied per step."""
    return Optimizer(cfg)


@dataclasses.dataclass
class TrainState:
    model: nn.Module  # parameters and BatchNorm running stats
    opt_state: AdamState
    step: int
    dropout_generator: torch.Generator


def train_state_dict(state: TrainState) -> dict:
    """``state`` as a dict of tensors (on the CPU) and ints (the CV
    driver's resume file): the model's state_dict, Adam's moments and
    count, the step, and the dropout generator's state. Tensor-parallel
    shards are gathered to the single-device tensors (every rank calls)."""
    return fetch_tree({
        "model": state.model.state_dict(keep_vars=True),
        "opt_mu": list(state.opt_state.mu),
        "opt_nu": list(state.opt_state.nu),
        "opt_count": state.opt_state.count, "step": state.step,
        "dropout_rng": state.dropout_generator.get_state()})


def load_train_state_dict(state: TrainState, saved: dict) -> TrainState:
    """Restore a :func:`train_state_dict` into ``state`` in place (its
    model, moments and generator keep their devices; a tensor-parallel
    shard takes its rows); returns ``state``."""
    state.model.load_state_dict(saved["model"], strict=True)
    with torch.no_grad():
        for mine, full in (("mu", "opt_mu"), ("nu", "opt_nu")):
            have = getattr(state.opt_state, mine)
            torch._foreach_copy_(have, [local_part(t, like) for t, like
                                        in zip(saved[full], have)])
    state.opt_state.count = int(saved["opt_count"])
    state.step = int(saved["step"])
    state.dropout_generator.set_state(saved["dropout_rng"])
    return state


def best_weights(state: TrainState) -> dict:
    """A copy on the CPU of the model's state_dict (parameters and
    BatchNorm running stats): what a fold checkpoint holds. Tensor-parallel
    shards are gathered (every rank calls), so it loads strictly into the
    single-device model."""
    return fetch_tree(state.model.state_dict(keep_vars=True))


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
      device: where the model and the data live ("cuda" unless asked):
          this rank's device under a mesh.
      mesh: a (data, model) ``DeviceMesh`` (module docstring), or None.
      batch_axis: the mesh axis the batch is sharded over.
      tensor_parallel: column-parallel wide dense layers over ``model``
          (on only when that axis is larger than 1).
      sharded_risk_set: the train Cox loss through the sharded risk-set
          scan (``ops/cox_distributed.py``); needs a mesh.
      aot_cache_dir: the kernel-build cache's directory
          (``io/aot_cache.py``), or None: the kernels build into
          ``build/kernels/``.
    """

    def __init__(self, model_fn: Callable[[torch.Generator], nn.Module],
                 batch_to_inputs: Callable,
                 hazard_and_aux: Callable | None = None,
                 cfg: TrainConfig = TrainConfig(), device="cuda", mesh=None,
                 batch_axis: str = "data", tensor_parallel: bool = False,
                 sharded_risk_set: bool = False, aot_cache_dir=None):
        self.aot_cache_dir = aot_cache_dir
        if aot_cache_dir:
            aot_cache.use(aot_cache_dir)
        if sharded_risk_set and mesh is None:
            raise ValueError("sharded_risk_set requires a mesh")
        self.model_fn = model_fn
        self.batch_to_inputs = batch_to_inputs
        self.hazard_and_aux = hazard_and_aux or (lambda out, batch: (out, 0.0))
        self.cfg = cfg
        self.device = resolve_device(device)
        if mesh is not None and mesh.device_type != self.device.type:
            raise ValueError(f"a {mesh.device_type} mesh cannot train on "
                             f"{self.device}")
        self.mesh = mesh
        self.batch_axis = batch_axis
        self.sharded_risk_set = sharded_risk_set
        shape = mesh_shape(mesh)
        self.tensor_parallel = tensor_parallel and shape.get("model", 1) > 1
        self._data_group = (mesh.get_group(batch_axis) if mesh is not None
                            else None)
        self._model_group = (mesh.get_group("model") if self.tensor_parallel
                             else None)
        self.tx = make_optimizer(cfg)
        self.step_losses = None  # the last epoch's per-step losses (device)
        self._captured = None  # train_epoch's CapturedStep

    @property
    def aot_info(self) -> dict:
        """``{library: {"source": "cache" | "compile", "key", "path"}}`` of
        the kernel libraries loaded through the cache so far (JAX's
        per-program report); empty without ``aot_cache_dir``."""
        return aot_cache.report() if self.aot_cache_dir else {}

    # ---------------- init ----------------

    def init_state(self, fold: int = 0, seed: int | None = None) -> TrainState:
        """A fresh model for ``fold``: weights from a generator seeded by
        ``(seed, fold)`` (``seed`` defaults to ``cfg.seed``), dropout masks
        from a generator on the device seeded ``seed*1000 + fold`` (the JAX
        CV driver's per-fold dropout key)."""
        seed = self.cfg.seed if seed is None else seed
        with span("setup.init_state"):
            gen = torch.Generator().manual_seed(_init_seed(seed, fold))
            model = self.model_fn(gen).to(self.device)
            if self.mesh is not None:
                self._refuse_fused(model)
                shard_module(model, self.mesh, self.tensor_parallel,
                             self.batch_axis)
            drop = torch.Generator(device=self.device).manual_seed(
                seed * 1000 + fold)
            set_dropout_generator(model, drop)
            params = list(model.parameters())
            opt_state = self.tx.init(params)
            for p, mu, nu in zip(params, opt_state.mu, opt_state.nu):
                if tp_group(p) is not None:  # the moments follow the shard
                    mu.tp_group = nu.tp_group = tp_group(p)
        return TrainState(model=model, opt_state=opt_state, step=0,
                          dropout_generator=drop)

    def _refuse_fused(self, model: nn.Module):
        if max(mesh_shape(self.mesh).values()) > 1 and any(
                getattr(m, "fused_bn1", False) for m in model.modules()):
            raise ValueError(
                "fused_bn1 under a data or model axis larger than 1: the "
                "fused DenseNet stages take single-shard arrays (JAX "
                "ops/fused_dense.py); train the unfused model on a mesh")

    # ---------------- loss ----------------

    def _global(self, out, batch: dict):
        """Under a mesh: the model's outputs (every tensor per row) gathered
        over ``data`` for a replicated loss (``collectives.gather``), and
        the batch's ``LABEL_KEYS`` gathered to the global batch (no
        gradient; one collective); without one, both unchanged."""
        if self.mesh is None:
            return out, batch
        if isinstance(out, (tuple, list)):
            out = type(out)(gather(t, self._data_group) for t in out)
        else:
            out = gather(out, self._data_group)
        keys = [k for k in LABEL_KEYS if k in batch]
        cols = [batch[k].reshape(batch[k].shape[0], -1) for k in keys]
        # through gather's Function, whose vmap rule serves the stacked
        # folds of train/cv_parallel.py (the labels take no gradient)
        every = gather(torch.cat(cols, 1).float(), self._data_group)
        glob = dict(batch)
        for k, part in zip(keys, every.split([c.shape[1] for c in cols], 1)):
            glob[k] = part.reshape(-1, *batch[k].shape[1:]).to(
                batch[k].dtype)
        return out, glob

    def _loss_fn(self, model: nn.Module, batch: dict) -> torch.Tensor:
        out, glob = self._global(model(*self.batch_to_inputs(batch)), batch)
        # the adapter returns (hazard, aux) or (hazard, aux, main_scale);
        # main_scale=0 turns off the Cox term (SimMLM stage 1)
        res = self.hazard_and_aux(out, glob)
        hazard, aux = res[0], res[1]
        main_scale = res[2] if len(res) > 2 else 1.0
        if self.sharded_risk_set:
            # this rank's rows of the gathered hazards: the scan's gradient
            # reaches them through its all_gather, the aux term's through
            # the outputs' gather
            rows = batch_rows(hazard.shape[0], self.mesh, self.batch_axis)
            cox = cox_partial_likelihood_sharded(
                hazard[rows], batch["time"], batch["event"], self.mesh,
                axis_name=self.batch_axis, valid=batch["svalid"],
                presorted=False, ties=self.cfg.ties)
        else:
            cox = cox_partial_likelihood(hazard, glob["time"], glob["event"],
                                         valid=glob["svalid"],
                                         ties=self.cfg.ties)
        return main_scale * cox + aux

    def loss_and_grads(self, state: TrainState, batch: dict):
        """Train-mode loss on ``batch`` (this rank's rows under a mesh) and
        its gradient per parameter (in ``model.parameters()`` order; zeros
        where a parameter is unused; under a mesh, summed over ``data``:
        the whole batch's). Updates the BatchNorm running stats, as the
        forward does."""
        model = state.model.train()
        with span("train.forward"):
            loss = self._loss_fn(model, batch)
        with span("train.backward"):
            grads = torch.autograd.grad(loss, list(model.parameters()),
                                        allow_unused=True,
                                        materialize_grads=True)
            if self.mesh is not None:
                flat = all_reduce_tensor(
                    torch._utils._flatten_dense_tensors(grads),
                    self._data_group)
                grads = torch._utils._unflatten_dense_tensors(flat, grads)
        return loss.detach(), grads

    @torch.no_grad()
    def grad_norm(self, grads, params: list) -> torch.Tensor:
        """The global norm the clip reads: each replicated parameter's
        gradient once, and under tensor parallelism each shard's squared
        norm summed over ``model``."""
        sq = torch.stack(torch._foreach_norm(list(grads))).square()
        if self.tensor_parallel:
            shard = torch.tensor([tp_group(p) is not None for p in params],
                                 device=sq.device)
            return (sq[~shard].sum() + all_reduce_tensor(
                sq[shard].sum(), self._model_group)).sqrt()
        return sq.sum().sqrt()

    def train_step(self, state: TrainState, batch: dict, lr):
        """One optimizer step on ``batch``; returns the loss (a device
        scalar) and updates ``state`` in place. ``lr``: a row of
        :meth:`_step_scalars` (the learning rate and the step's two bias
        corrections on the device, read by
        :meth:`Optimizer.update_static`), as every epoch passes it and as
        :meth:`train_epoch`'s CUDA graph reads it; or the learning rate,
        made into that row here."""
        if not isinstance(lr, torch.Tensor):
            lr = self._step_scalars(state, lr, 1)[0]
        with span("train.step"):
            loss, grads = self.loss_and_grads(state, batch)
            with span("train.optimizer"):
                params = list(state.model.parameters())
                norm = (self.grad_norm(grads, params)
                        if self.tensor_parallel
                        and self.cfg.grad_clip is not None else None)
                updates, state.opt_state = self.tx.update_static(
                    grads, state.opt_state, params, lr, norm=norm)
                with torch.no_grad():
                    torch._foreach_add_(params, updates)
        state.step += 1
        return loss

    def _step_scalars(self, state: TrainState, lr: float,
                      steps: int) -> torch.Tensor:
        """The ``(steps, 3)`` rows of :meth:`Optimizer.step_scalars` for
        the next ``steps`` steps of ``state``, on the device in the Adam
        moments' dtype: one copy, which does not wait for the device (CUDA
        stages pageable memory before the call returns)."""
        return torch.from_numpy(self.tx.step_scalars(
            lr, state.opt_state.count, steps)).to(
                self.device, state.opt_state.mu[0].dtype, non_blocking=True)

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

    @staticmethod
    def _host_batches(host_data: dict, idx: np.ndarray, bvalid: np.ndarray):
        """``_gather_batch`` on the host: one dict of numpy arrays a row
        of ``idx``."""
        for bidx, bv in zip(idx, bvalid):
            batch = {k: v[bidx] for k, v in host_data.items()}
            batch["valid"] = bv
            batch["svalid"] = batch["svalid"] * bv
            yield batch

    def _local(self, idx: np.ndarray, bvalid: np.ndarray):
        """This rank's columns of the (steps, B) padded indices under a
        mesh (its contiguous rows of every batch); all of them without."""
        if self.mesh is None:
            return idx, bvalid
        rows = batch_rows(idx.shape[1], self.mesh, self.batch_axis)
        return idx[:, rows], bvalid[:, rows]

    def _device_indices(self, idx: np.ndarray, bvalid: np.ndarray):
        idx, bvalid = self._local(idx, bvalid)
        return (torch.from_numpy(idx.astype(np.int64)).to(self.device),
                torch.from_numpy(np.ascontiguousarray(bvalid)).to(
                    self.device))

    def _device_batches(self, data: dict, idx: np.ndarray,
                        bvalid: np.ndarray):
        idx, bvalid = self._device_indices(idx, bvalid)
        for i, bv in zip(idx, bvalid):
            yield self._gather_batch(data, i, bv)

    # ---------------- host-side API ----------------

    def _train_batches(self, state: TrainState, batches, steps: int,
                       lr: float):
        with span("train.epoch"):
            scalars = self._step_scalars(state, lr, steps)
            self.step_losses = torch.stack(
                [self.train_step(state, batch, row)
                 for batch, row in zip(batches, scalars)])
            return state, self._readback()

    def _readback(self) -> float:
        with span("train.readback"):
            return float(self.step_losses.mean())

    def train_epoch(self, state: TrainState, data: dict, indices,
                    shuffle_rng: np.random.Generator, lr: float):
        """One epoch over ``indices`` (global row ids into ``data``, a dict
        of tensors on the device). Returns ``(state, mean loss)``.

        Without a mesh each step is the batch gathered from ``data``
        (:meth:`_gather_batch`), then :meth:`train_step`, reading its
        batch's rows, their validity, the learning rate and Adam's bias
        corrections from the static inputs of a
        :class:`~.graphs.CapturedStep` (on a card: captured once as a CUDA
        graph and replayed; on the CPU: run eagerly), kept while
        :meth:`_graph_key` holds. Under a mesh, whose collectives stay
        eager, each step is :meth:`train_step` on its batch."""
        perm, bvalid = self._pad_indices(indices, self.cfg.batch_size,
                                         shuffle_rng)
        if self.mesh is not None:
            return self._train_batches(
                state, self._device_batches(data, perm, bvalid), len(perm),
                lr)
        with span("train.epoch"):
            idx, valid = self._device_indices(perm, bvalid)
            scalars = self._step_scalars(state, lr, len(idx))
            key = self._graph_key(state, data, idx.shape[1])
            if self._captured is None or self._captured.key != key:
                self._captured = None  # frees the old graph first
                self._captured = CapturedStep(
                    key, (state, state.model, state.opt_state,
                          state.dropout_generator, self.hazard_and_aux,
                          self.batch_to_inputs),
                    dict(idx=idx[0], valid=valid[0], scalars=scalars[0]),
                    [state.dropout_generator])

            def body(inputs):
                batch = self._gather_batch(data, inputs["idx"],
                                           inputs["valid"])
                return self.train_step(state, batch, inputs["scalars"])

            losses = []
            for i, v, row in zip(idx, valid, scalars):
                step, count = state.step, state.opt_state.count
                loss, replayed = self._captured(body, idx=i, valid=v,
                                                scalars=row)
                if replayed:  # also puts back what a capture advanced
                    state.step, state.opt_state.count = step + 1, count + 1
                losses.append(loss)
            self.step_losses = torch.stack(losses)
            return state, self._readback()

    def _graph_key(self, state: TrainState, data: dict,
                   batch_size: int) -> tuple:
        """What :meth:`train_epoch`'s CUDA graph bakes in: the train state
        (the objects, and the addresses of its parameters, buffers and
        moments), its dropout generator, the cohort's tensors (addresses,
        shapes, strides, dtypes), the batch size, the two adapters (whose
        non-tensor outputs, such as SimMLM stage 1's ``main_scale``, are
        constants of the adapter) and the TF32 and cuDNN flags."""
        model = state.model
        tensors = itertools.chain(model.parameters(), model.buffers(),
                                  state.opt_state.mu, state.opt_state.nu)
        return (id(state), id(model), id(state.opt_state),
                id(state.dropout_generator),
                tuple(t.data_ptr() for t in tensors),
                tuple((k, v.data_ptr(), tuple(v.shape), v.stride(), v.dtype)
                      for k, v in data.items()),
                batch_size, id(self.hazard_and_aux),
                id(self.batch_to_inputs), *backend_flags())

    def train_epoch_streaming(self, state: TrainState, host_data: dict,
                              indices, shuffle_rng: np.random.Generator,
                              lr: float, depth: int = 2):
        """:meth:`train_epoch` with the cohort on the host (``host_data``, a
        dict of numpy arrays): the same batches, gathered on the host and
        prefetched ``depth`` deep onto the device. One read-back (the mean
        loss) an epoch."""
        perm, bvalid = self._pad_indices(indices, self.cfg.batch_size,
                                         shuffle_rng)
        batches = BatchPrefetcher(
            self._host_batches(host_data, *self._local(perm, bvalid)),
            depth=depth, device=self.device)
        try:
            return self._train_batches(state, batches, len(perm), lr)
        finally:
            batches.close()

    def _evaluate_batches(self, state: TrainState, batches, n: int):
        model = state.model.eval()
        hs, ts, es, svs, losses = [], [], [], [], []
        with torch.inference_mode():
            for batch in batches:
                out, batch = self._global(model(*self.batch_to_inputs(batch)),
                                          batch)
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
        return float(cindex), float(loss), h[:n].float().cpu().numpy()

    def evaluate(self, state: TrainState, data: dict, indices):
        """Pooled C-index, mean loss and per-sample hazards over
        ``indices`` (reference final_multimodal.py:268-305): eval batches of
        ``cfg.eval_batch_size`` in index order, their hazards pooled into
        one C-index."""
        idx, bvalid = self._pad_indices(indices, self.cfg.eval_batch_size,
                                        None)
        return self._evaluate_batches(
            state, self._device_batches(data, idx, bvalid), len(indices))

    def evaluate_streaming(self, state: TrainState, host_data: dict, indices,
                           depth: int = 2):
        """:meth:`evaluate` with the cohort on the host: the same eval
        batches, prefetched onto the device; the pooled C-index is the
        port's ``concordance_index`` over all the pooled hazards."""
        idx, bvalid = self._pad_indices(indices, self.cfg.eval_batch_size,
                                        None)
        batches = BatchPrefetcher(
            self._host_batches(host_data, *self._local(idx, bvalid)),
            depth=depth, device=self.device)
        try:
            return self._evaluate_batches(state, batches, len(indices))
        finally:
            batches.close()

