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

``aot_cache_dir`` routes the kernels' builds through the kernel-build
cache (``io/aot_cache.py``): the libraries this process builds on first
launch go into that directory, and a later process loads them instead of
compiling; ``Trainer.aot_info`` reports each one's provenance.
"""

from __future__ import annotations

import dataclasses
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

    @torch.no_grad()
    def update(self, grads: list, state: AdamState, params: list,
               lr: float, norm: torch.Tensor | None = None):
        """``(updates, state)``; ``state``'s moments are updated in place.
        Under ``no_grad``: the decay term reads the parameters, and autograd
        would otherwise chain every step's moments to the last. ``norm``:
        the gradient's global norm when the caller computed it (tensor
        parallelism); by default it is taken over ``grads``."""
        g = list(grads)
        if self.grad_clip is None:
            norm = None
        elif norm is None:
            norm = torch.linalg.vector_norm(
                torch.stack(torch._foreach_norm(g)))
        state.count += 1
        updates = self._adam(g, state.mu, state.nu, params, norm,
                             1 - self.b1 ** state.count,
                             1 - self.b2 ** state.count)
        torch._foreach_mul_(updates, -lr)
        return updates, state

    @torch.no_grad()
    def update_stacked(self, grads: torch.Tensor, mu: torch.Tensor,
                       nu: torch.Tensor, params: torch.Tensor, count,
                       lr: torch.Tensor, sizes: list):
        """:meth:`update` of K states stacked on dim 0 of flat (K, P)
        tensors, each with its own global-norm clip, Adam count and
        learning rate: ``count`` holds the K counts after this step (host
        ints), ``lr`` is a (K, 1) tensor, ``sizes`` the parameters' numels
        in order (each row's clip norm is reduced as :meth:`update`'s, over
        the norms of its parameters). ``mu``, ``nu`` and ``params`` are
        updated in place."""
        norm = None
        if self.grad_clip is not None:
            rows = [t for row in grads for t in row.split(sizes)]
            norm = torch.linalg.vector_norm(
                torch.stack(torch._foreach_norm(rows)).view(len(grads), -1),
                dim=1, keepdim=True)
        # the bias corrections in float64 on the host, as update computes
        # them, then one per state in the moments' dtype
        bc = torch.tensor([[1 - self.b1 ** c, 1 - self.b2 ** c]
                           for c in count],
                          dtype=mu.dtype).to(mu.device, non_blocking=True)
        (updates,) = self._adam([grads], [mu], [nu], [params], norm,
                                [bc[:, :1]], [bc[:, 1:]])
        params.add_(updates.mul_(-lr))

    def _adam(self, g: list, mu: list, nu: list, params: list, norm,
              bc1, bc2) -> list:
        """The unscaled updates of both :meth:`update` (lists of the
        parameters' tensors; ``norm`` a 0-dim tensor, ``bc1`` and ``bc2``
        floats) and :meth:`update_stacked` (lists of one flat (K, P)
        tensor; ``norm`` (K, 1), ``bc1`` and ``bc2`` lists of one (K, 1)
        tensor). ``mu`` and ``nu`` are updated in place."""
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
        loss = self._loss_fn(model, batch)
        grads = torch.autograd.grad(loss, list(model.parameters()),
                                    allow_unused=True, materialize_grads=True)
        if self.mesh is not None:
            flat = all_reduce_tensor(
                torch._utils._flatten_dense_tensors(grads), self._data_group)
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

    def train_step(self, state: TrainState, batch: dict, lr: float):
        """One optimizer step on ``batch``; returns the loss (a device
        scalar) and updates ``state`` in place."""
        loss, grads = self.loss_and_grads(state, batch)
        params = list(state.model.parameters())
        norm = (self.grad_norm(grads, params)
                if self.tensor_parallel and self.cfg.grad_clip is not None
                else None)
        updates, state.opt_state = self.tx.update(grads, state.opt_state,
                                                  params, lr, norm=norm)
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

    def _train_batches(self, state: TrainState, batches, lr: float):
        self.step_losses = torch.stack([self.train_step(state, batch, lr)
                                        for batch in batches])
        return state, float(self.step_losses.mean())

    def train_epoch(self, state: TrainState, data: dict, indices,
                    shuffle_rng: np.random.Generator, lr: float):
        """One epoch over ``indices`` (global row ids into ``data``, a dict
        of tensors on the device). Returns ``(state, mean loss)``."""
        perm, bvalid = self._pad_indices(indices, self.cfg.batch_size,
                                         shuffle_rng)
        return self._train_batches(
            state, self._device_batches(data, perm, bvalid), lr)

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
            return self._train_batches(state, batches, lr)
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
