"""Fold-parallel cross-validation: every fold trained in the same step (port
of ``multimodal_survival_prediction_tpu/train/cv_parallel.py``).

The K folds' train states are stacked on a leading axis
(:class:`StackedState`): the parameters and Adam's moments as flat (K, P)
float32 tensors, the buffers as one flat (K, Q) tensor per dtype, each
named parameter or buffer a (K, ...) view into them. One training step is
``torch.func.vmap`` over that axis of ``grad_and_value`` of the Trainer's
loss through ``functional_call`` of one template model, so each launch of
the step does all K folds' work (a convolution with per-fold weights
becomes a grouped convolution). The optimizer then runs on the flat (K, P)
tensors (``Optimizer.update_stacked``): a clip norm, a learning rate and an
Adam count per fold. Every vmapped call runs with functorch's per-sample
fallback off, so an op without a batching rule raises instead of looping
over the folds.

Trajectory fidelity to the sequential driver (``train/cv.py``), as in JAX:
  * per-fold init (``Trainer.init_state(fold)``), shuffle RNG
    (``default_rng(seed + fold)``) and padded batch order;
  * dropout: each fold's uniforms come from that fold's generator, in the
    sequential forward's order and shapes (found once by a forward of fold
    1 that draws nothing), drawn outside vmap and passed in stacked
    (``models/layers.py:dropout_uniforms``);
  * per-fold LR schedule (cosine, or a ReduceLROnPlateau per fold),
    best-by-val-C-index snapshots and early stopping;
  * whole-step masking: step counts differ across folds (their train sets
    differ by a patient), so every fold's epoch is padded to the longest
    with all-invalid steps. Such a step leaves that fold's parameters,
    moments, Adam count, BatchNorm buffers and generator as they were: its
    uniforms are not drawn, and the rest is restored after the update.
BatchNorm writes its running stats in place, as in the sequential path;
under vmap the writes land in each fold's slice of the stacked buffers.
Early-stopped folds keep computing (their records are frozen on the host):
the run lasts as long as its slowest fold.

The epoch is a Python loop over steps, each one vmapped dispatch of all
folds (torch has no ``lax.scan``). The epochs, schedules and records
(:func:`train_stacked`) are shared with the sweep (``train/sweep.py``). ``streaming`` changes only where each
step's stacked (K, B, ...) batch is gathered: on the host, through
``data.pipeline.BatchPrefetcher``, instead of on the device.

The driver builds the unfused model, as JAX's does, so the fused
BN->ReLU->1x1-conv kernels are off this path. ``remat`` recomputes the
DenseNet dense layers in the backward (``models/layers.py:remat``, whose
region runs under the vmapped ``grad``).

A fold mesh (:func:`make_fold_mesh`: a ``("fold", "data")`` DeviceMesh
over the ranks of the default group, one process a device) spreads the
folds as JAX's ``P("fold")`` sharding does: K is padded to ``k_pad``, a
multiple of the fold axis (the dummy folds reuse the last split and are
never recorded or written), and each fold row of ranks inits and trains
its contiguous block of ``k_pad / F`` folds in its own vmapped step;
nothing crosses the fold axis inside a step. With a data axis larger than
1, each fold's batch rows are split over its data group as JAX's
``(fold, -, data)`` index sharding does: BatchNorm's sums and the
gathered hazards go through ``parallel/collectives.py``, whose Functions
carry a ``vmap`` rule (one collective serves every fold of the rank), each
fold's dropout uniforms are those of the global batch, and the stacked
gradients are summed over the data group after the vmapped step.
Evaluation is replicated: every rank gathers every fold's val loss and
C-index over the fold axis, so every rank takes the same schedule, patience
and snapshot branches; the best states move to the coordinator, which
alone writes. ``aot_cache_dir`` routes the run's kernel builds through
the kernel-build cache (``io/aot_cache.py``), as in the sequential driver.
No resume checkpoints (JAX's parallel driver has none either).
"""

from __future__ import annotations

import contextlib
import dataclasses
import logging
import time

import numpy as np
import torch
import torch.distributed as dist
from torch.distributed.device_mesh import DeviceMesh
from torch.func import functional_call, grad_and_value, vmap

from ..config import ModelRunConfig
from ..data.pipeline import BatchPrefetcher
from ..io import aot_cache
from ..models.layers import dropout_uniforms
from ..ops.cindex import concordance_index
from ..ops.cox import cox_partial_likelihood
from ..parallel.collectives import all_gather_tensor, all_reduce_tensor
from ..parallel.mesh import mesh_shape
from ..parallel.multihost import is_coordinator
from ..parallel.sharding import batch_rows
from ..utils.device import resolve_device
from .cv import (
    FoldOutcome,
    _compute_dtype,
    build_and_write_cv_payload,
    make_trainers,
    prepare_cv_data,
    save_fold,
)
from .engine import TrainConfig, Trainer, TrainState
from .schedules import ReduceLROnPlateau, cosine_annealing

log = logging.getLogger(__name__)


def make_fold_mesh(n_devices: int | None = None, data_parallel: int = 1,
                   device="cuda"):
    """A ``("fold", "data")`` mesh over the ranks of the default group:
    ``n_devices / data_parallel`` fold rows of ``data_parallel`` ranks,
    row-major as JAX's ``reshape``, so rank ``f * dp + d`` sits at ``(f,
    d)`` and a fold's data group is consecutive ranks. ``n_devices`` must
    be the world size (None: the world size); ``device`` names the ranks'
    device type. Every rank calls this together.

    Without a process group, the one-device "mesh" of ``n_devices`` None or
    1 is None: the fold axis is vmapped on this device."""
    if not dist.is_initialized():
        if (n_devices or 1) == 1 and data_parallel == 1:
            return None
        raise RuntimeError(
            "a fold mesh over more than one device needs a "
            "torch.distributed process group: call "
            "parallel.multihost.initialize_distributed first, or run the "
            "training CLI's --fold-parallel N, which starts the ranks")
    world = dist.get_world_size()
    n = world if n_devices is None else n_devices
    if n != world:
        raise ValueError(f"a fold mesh of {n} devices over a process group "
                         f"of {world} ranks")
    if n % data_parallel:
        raise ValueError(
            f"{n} devices not divisible by data={data_parallel}")
    return DeviceMesh(torch.device(device).type,
                      torch.arange(n).reshape(n // data_parallel,
                                              data_parallel),
                      mesh_dim_names=("fold", "data"))


@dataclasses.dataclass(frozen=True)
class FoldPlacement:
    """Where the ``k`` stacked states of a run live: padded to ``k_pad``
    (a multiple of the fold axis), this rank trains ``local`` (a range of
    state indices, its fold row's block); ``fold_group`` joins the ranks
    of this data index across the fold axis (None: one fold row),
    ``data_group`` this fold row's ranks (None: one rank a row), and
    ``data_rank`` is this rank's index in it."""
    k: int
    k_pad: int
    local: range
    fold_group: object = None
    data_group: object = None
    data_rank: int = 0


def fold_placement(k: int, mesh=None, fold_axis: str = "fold",
                   data_axis: str = "data") -> FoldPlacement:
    """The placement of ``k`` states on ``mesh`` (None: all on this
    device)."""
    if mesh is None:
        return FoldPlacement(k, k, range(k))
    shape = mesh_shape(mesh)
    n_fold, n_data = shape.get(fold_axis, 1), shape.get(data_axis, 1)
    k_pad = -(-k // n_fold) * n_fold
    per = k_pad // n_fold
    row = mesh.get_local_rank(fold_axis) if fold_axis in shape else 0
    return FoldPlacement(
        k, k_pad, range(row * per, (row + 1) * per),
        fold_group=mesh.get_group(fold_axis) if n_fold > 1 else None,
        data_group=mesh.get_group(data_axis) if n_data > 1 else None,
        data_rank=mesh.get_local_rank(data_axis) if n_data > 1 else 0)


@contextlib.contextmanager
def no_vmap_fallback():
    """Within the block, an op without a vmap batching rule raises instead
    of running once per fold (functorch's silent per-sample fallback)."""
    fc = torch._C._functorch
    was = fc._is_vmap_fallback_enabled()
    fc._set_vmap_fallback_enabled(False)
    try:
        yield
    finally:
        fc._set_vmap_fallback_enabled(was)


def _flat(per_state: list, names: list):
    """Stack each state's tensors ``names`` into one flat (K, total) tensor;
    returns it and a dict of (K, ...) views into it."""
    flat = torch.stack([torch.cat([t[n].detach().reshape(-1) for n in names])
                        for t in per_state])
    views, off = {}, 0
    for n in names:
        shape = per_state[0][n].shape
        size = per_state[0][n].numel()
        views[n] = flat[:, off:off + size].view(len(per_state), *shape)
        off += size
    return flat, views


class StackedState:
    """K train states (``engine.TrainState``) stacked on a leading axis.

    ``params``, ``mu`` and ``nu`` are flat (K, P) tensors in
    ``model.parameters()`` order (``sizes`` their numels); ``buffers``
    maps each buffer dtype to a flat (K, Q) tensor; ``param_views`` and
    ``buffer_views`` map every parameter and buffer name to its (K, ...)
    view into them. ``count`` and ``step`` are the K Adam counts and
    steps (host ints), ``generators`` the K dropout generators. The first
    state's model becomes the template (moved to the meta device: only its
    structure is used), so the states are taken over."""

    def __init__(self, states: list[TrainState]):
        models = [s.model for s in states]
        self.k = len(states)
        self.param_names = [n for n, _ in models[0].named_parameters()]
        named = [dict(m.named_parameters()) for m in models]
        self.params, self.param_views = _flat(named, self.param_names)
        self.sizes = [named[0][n].numel() for n in self.param_names]
        index = {n: i for i, n in enumerate(self.param_names)}
        self.mu = _flat([{n: s.opt_state.mu[index[n]] for n in index}
                         for s in states], self.param_names)[0]
        self.nu = _flat([{n: s.opt_state.nu[index[n]] for n in index}
                         for s in states], self.param_names)[0]
        bufs = [dict(m.named_buffers()) for m in models]
        self.buffers, self.buffer_views = {}, {}
        for dt in dict.fromkeys(b.dtype for b in bufs[0].values()):
            names = [n for n, b in bufs[0].items() if b.dtype == dt]
            self.buffers[dt], views = _flat(bufs, names)
            self.buffer_views.update(views)
        self.count = np.array([s.opt_state.count for s in states], np.int64)
        self.step = np.array([s.step for s in states], np.int64)
        self.generators = [s.dropout_generator for s in states]
        self.state_keys = list(models[0].state_dict())
        self.template = models[0].to("meta")
        for m in models[1:]:
            m.to("meta")  # their tensors live on in the stack

    @property
    def device(self) -> torch.device:
        return self.params.device

    def _tensors(self) -> list:
        return [self.params, self.mu, self.nu, *self.buffers.values()]

    def save(self) -> list:
        """Copies of every stacked tensor, for :meth:`restore`."""
        return [t.clone() for t in self._tensors()]

    def restore(self, saved: list, keep: torch.Tensor):
        """Put ``saved`` back in the states where ``keep`` (K, 1) is
        False."""
        for t, old in zip(self._tensors(), saved):
            t.copy_(torch.where(keep, t, old))

    def fold_state_dict(self, k: int) -> dict:
        """State ``k``'s model state_dict, copied to the CPU (what a fold
        checkpoint holds; ``engine.best_weights`` of a TrainState)."""
        views = {**self.param_views, **self.buffer_views}
        return {n: views[n][k].to("cpu", copy=True) for n in self.state_keys}

    def fold_train_state(self, k: int) -> dict:
        """State ``k`` as ``engine.train_state_dict`` gives a TrainState."""
        return {"model": self.fold_state_dict(k),
                "opt_mu": [t[k].cpu() for t in _split(self.mu, self)],
                "opt_nu": [t[k].cpu() for t in _split(self.nu, self)],
                "opt_count": int(self.count[k]), "step": int(self.step[k]),
                "dropout_rng": self.generators[k].get_state()}


def _split(flat: torch.Tensor, state: StackedState) -> list:
    """A flat (K, P) tensor as its (K, ...) views, in parameter order."""
    return [t.view(state.param_views[n].shape) for n, t in
            zip(state.param_names, flat.split(state.sizes, dim=1))]


def _stack_fold_indices(per_fold, batch_size, rngs):
    """Per-fold ``Trainer._pad_indices``, then step counts padded to the
    cross-fold max with fully invalid steps (idx 0, bvalid 0: masked out as
    whole steps). Returns (K, steps, B) int32 indices and float32 masks."""
    padded = [Trainer._pad_indices(rows, batch_size, rng)
              for rows, rng in zip(per_fold, rngs)]
    steps = max(p[0].shape[0] for p in padded)
    idxs, bvalids = [], []
    for idx, bv in padded:
        extra = steps - idx.shape[0]
        if extra:
            idx = np.concatenate(
                [idx, np.zeros((extra, batch_size), np.int32)])
            bv = np.concatenate(
                [bv, np.zeros((extra, batch_size), np.float32)])
        idxs.append(idx)
        bvalids.append(bv)
    return np.stack(idxs), np.stack(bvalids)


def stacked_batches(trainer: Trainer, data: dict, idx: np.ndarray,
                    bvalid: np.ndarray, streaming: bool = False,
                    rows: slice | None = None):
    """Each step's stacked (K, B, ...) batch of the (K, steps, B) ``idx``
    and ``bvalid``: gathered on the device from ``data`` (tensors there),
    or with ``streaming`` on the host from ``data`` (numpy arrays) and
    prefetched two deep (JAX's depth). ``rows``: this rank's columns of
    every batch (a fold's data group), else all of them."""
    if rows is not None:
        idx, bvalid = idx[..., rows], bvalid[..., rows]
    idx = np.ascontiguousarray(idx.transpose(1, 0, 2))
    bvalid = np.ascontiguousarray(bvalid.transpose(1, 0, 2))
    if not streaming:
        dev = trainer.device
        for i, bv in zip(torch.from_numpy(idx.astype(np.int64)).to(dev),
                         torch.from_numpy(bvalid).to(dev)):
            yield Trainer._gather_batch(data, i, bv)
        return
    batches = BatchPrefetcher(Trainer._host_batches(data, idx, bvalid),
                              depth=2, device=trainer.device)
    try:
        yield from batches
    finally:
        batches.close()


def _model_call(template, params, buffers):
    return lambda *inputs: functional_call(template, (params, buffers),
                                           inputs)


def _dropout_shapes(trainer: Trainer, state: StackedState, batch: dict):
    """The shapes of the uniforms one fold's train-mode forward on
    ``batch`` draws, in order: a forward of fold 1 under ``no_grad`` on
    copies of its buffers, with every dropout fed ones."""
    shapes = []

    def record(x):
        shapes.append(tuple(x.shape))
        return torch.ones(x.shape, device=x.device)

    params = {n: v[0] for n, v in state.param_views.items()}
    buffers = {n: v[0].clone() for n, v in state.buffer_views.items()}
    state.template.train()
    with torch.no_grad(), dropout_uniforms(record):
        _model_call(state.template, params, buffers)(
            *trainer.batch_to_inputs({k: v[0] for k, v in batch.items()}))
    return shapes


def _draw_uniforms(state: StackedState, shapes: list, step_valid):
    """Each fold's dropout uniforms for one step, from its own generator in
    forward order, stacked per draw; a fold whose step is masked draws
    nothing (its generator stays where it is) and gets zeros."""
    dev = state.device
    per_fold = [[torch.rand(s, generator=g, device=dev, dtype=torch.float32)
                 if ok else torch.zeros(s, device=dev) for s in shapes]
                for g, ok in zip(state.generators, step_valid)]
    return [torch.stack(draws) for draws in zip(*per_fold)]


def _build_parallel_train_step(trainer: Trainer):
    """The vmapped single step: ``step(state, batch, lr, step_valid)``
    advances every fold of ``state`` on its slice of the stacked (K, B,
    ...) ``batch`` with learning rates ``lr`` ((K, 1), the parameters'
    dtype) and returns the (K,) losses (0 where masked). ``step_valid`` (K
    host bools) masks whole steps. Under a trainer's data group (a fold
    mesh's data axis) ``batch`` holds this rank's rows, and the stacked
    gradients are summed over the group in one collective."""

    def fold_loss(params, buffers, batch, uniforms, template):
        feed = iter(uniforms)
        with dropout_uniforms(lambda x: next(feed)):
            return trainer._loss_fn(_model_call(template, params, buffers),
                                    batch)

    grad_fn = grad_and_value(fold_loss)
    shapes: dict = {}

    def step(state: StackedState, batch: dict, lr: torch.Tensor, step_valid):
        step_valid = np.asarray(step_valid, bool)
        key = tuple((k, tuple(v.shape)) for k, v in batch.items())
        if key not in shapes:
            shapes[key] = _dropout_shapes(trainer, state, batch)
        uniforms = _draw_uniforms(state, shapes[key], step_valid)
        masked = not step_valid.all()
        saved = state.save() if masked else None
        state.template.train()
        with no_vmap_fallback():
            grads, loss = vmap(grad_fn, in_dims=(0, 0, 0, 0, None))(
                state.param_views, state.buffer_views, batch, uniforms,
                state.template)
        flat = torch.cat([grads[n].reshape(state.k, -1)
                          for n in state.param_names], dim=1)
        if trainer.mesh is not None:
            flat = all_reduce_tensor(flat, trainer._data_group)
        count = state.count + step_valid
        trainer.tx.update_stacked(flat, state.mu, state.nu, state.params,
                                  np.maximum(count, 1), lr, state.sizes)
        if masked:
            keep = torch.from_numpy(step_valid).to(state.device)[:, None]
            state.restore(saved, keep)
            loss = torch.where(keep[:, 0], loss, 0.0)
        state.count = count
        state.step = state.step + step_valid
        return loss.detach()

    return step


def _build_parallel_train_epoch(trainer: Trainer):
    """``epoch(state, batches, step_valid, lrs)``: the vmapped step over
    ``batches`` (each step's stacked batch) with whole-step masking by
    ``step_valid`` (K, steps) and the K learning rates ``lrs``. Returns the
    (steps, K) losses and each fold's mean over its valid steps, on the
    device."""
    step = _build_parallel_train_step(trainer)

    def epoch(state: StackedState, batches, step_valid, lrs):
        lr = torch.tensor(np.asarray(lrs)[:, None],
                          dtype=state.params.dtype).to(state.device)
        losses = torch.stack([step(state, batch, lr, step_valid[:, s])
                              for s, batch in enumerate(batches)])
        n_valid = torch.from_numpy(
            np.maximum(step_valid.sum(axis=1), 1).astype(np.float32))
        return losses, losses.sum(dim=0) / n_valid.to(state.device)

    return epoch


def _build_parallel_eval_step(trainer: Trainer):
    """``eval_step(state, batch)``: every fold's eval-mode hazards (K, B)
    and Cox loss (K,) on its slice of a stacked batch, one vmapped call."""

    def fold_eval(params, buffers, batch, template):
        out = _model_call(template, params, buffers)(
            *trainer.batch_to_inputs(batch))
        hazard = trainer.hazard_and_aux(out, batch)[0]
        return hazard, cox_partial_likelihood(
            hazard, batch["time"], batch["event"], valid=batch["svalid"],
            ties=trainer.cfg.ties)

    def eval_step(state: StackedState, batch: dict):
        state.template.eval()
        with torch.no_grad(), no_vmap_fallback():
            return vmap(fold_eval, in_dims=(0, 0, 0, None))(
                state.param_views, state.buffer_views, batch, state.template)

    return eval_step


def _build_parallel_eval(trainer: Trainer):
    """``evaluate(state, batches, step_valid)``: pooled validation of every
    fold, the (K,) C-index over each fold's pooled hazards and the (K,)
    mean loss over its valid steps. Masked steps add nothing: their rows
    have svalid 0 in the C-index, and they are left out of the mean."""
    eval_step = _build_parallel_eval_step(trainer)

    def evaluate(state: StackedState, batches, step_valid):
        hs, ts, es, svs, losses = [], [], [], [], []
        for batch in batches:
            hazard, loss = eval_step(state, batch)
            hs.append(hazard)
            losses.append(loss)
            ts.append(batch["time"])
            es.append(batch["event"])
            svs.append(batch["svalid"])
        with torch.no_grad(), no_vmap_fallback():
            cindex = vmap(concordance_index)(
                torch.cat(hs, 1), torch.cat(ts, 1), torch.cat(es, 1),
                torch.cat(svs, 1))
        valid = torch.from_numpy(step_valid).to(state.device)
        losses = torch.where(valid, torch.stack(losses, 1), 0.0)
        return cindex, losses.sum(1) / valid.sum(1).clamp_min(1)

    return evaluate


def init_stacked(trainer: Trainer, starts: list,
                 init_hook=None) -> StackedState:
    """The stacked state of ``trainer.init_state(fold, seed)`` for each
    ``(key, fold, seed)`` of ``starts``, each passed through ``init_hook``
    (``(key, state) -> state | None``) first."""
    states = []
    for key, fold, seed in starts:
        st = trainer.init_state(fold=fold, seed=seed)
        if init_hook is not None:
            st = init_hook(key, st) or st
        states.append(st)
    return StackedState(states)


@dataclasses.dataclass
class StackedRun:
    """What :func:`train_stacked` gives back, one entry per state of the
    run (every rank's, ``placement.k`` of them): the epoch histories, the
    best val C-index and its epoch, the best snapshot
    (``StackedState.fold_state_dict``; None unless kept, and kept only on
    the data rank 0 of the states' fold row), the epochs recorded, and the
    fold-steps this rank ran (valid steps of its real states summed)."""
    histories: list
    best_c: np.ndarray
    best_epoch: np.ndarray
    best_params: list
    epochs_run: np.ndarray
    total_steps: int


def train_stacked(trainer: Trainer, stage1_trainer, state: StackedState,
                  cfg: ModelRunConfig, data: dict, train_rows: list,
                  val_rows: list, base_lrs, shuffle_rngs: list,
                  num_epochs: int, streaming: bool = False,
                  keep_best: bool = True, tag: str = "parallel",
                  unit: str = "fold",
                  placement: FoldPlacement | None = None) -> StackedRun:
    """The epochs of the fold-parallel driver and the sweep: the stacked
    states trained together, state k on ``train_rows[k]`` shuffled by
    ``shuffle_rngs[k]`` from base learning rate ``base_lrs[k]``, validated
    on ``val_rows[k]``. Stage 1 (SimMLM, with ``stage1_trainer``) runs
    ``cfg.stage1_epochs`` at the base rates; then ``num_epochs`` main
    epochs with a per-state cosine or plateau schedule,
    best-by-val-C-index records (snapshots with ``keep_best``) and early
    stopping, which freezes a state's record while it goes on computing.
    One read-back an epoch. ``tag`` and ``unit`` name the run and its
    states in the log.

    ``placement`` (:func:`fold_placement`; None: every state here) says
    which of the ``k_pad`` states of the lists ``state`` holds: this rank
    steps those (its data rows of each batch, under a data group), and
    after each epoch's evaluation gathers every state's losses and C-index
    over the fold axis, so the records of the first ``placement.k`` states
    are kept alike on every rank; the padding states are never
    recorded."""
    pl = placement or fold_placement(state.k)
    loc = pl.local
    base_lrs = np.asarray(base_lrs, np.float64)
    lrs = base_lrs.copy()
    plateaus = [ReduceLROnPlateau(lr=lr) for lr in base_lrs]
    train_loc = [train_rows[i] for i in loc]
    rngs_loc = [shuffle_rngs[i] for i in loc]
    real = np.asarray([i < pl.k for i in loc])
    rows = (batch_rows(cfg.batch_size, trainer.mesh, trainer.batch_axis)
            if pl.data_group is not None else None)
    # eval indices are epoch-invariant; every rank of a fold row evaluates
    # its folds' whole batches (eval mode makes no collective)
    eidx, ebv = _stack_fold_indices([val_rows[i] for i in loc],
                                    trainer.cfg.eval_batch_size,
                                    [None] * len(loc))
    eval_valid = ebv.max(axis=2) > 0
    evaluate = _build_parallel_eval(trainer)
    total_steps = 0

    def run_epoch(epoch_fn, lr_vec):
        nonlocal total_steps
        idx, bv = _stack_fold_indices(train_loc, cfg.batch_size, rngs_loc)
        step_valid = bv.max(axis=2) > 0
        total_steps += int(step_valid[real].sum())
        return epoch_fn(state, stacked_batches(trainer, data, idx, bv,
                                               streaming, rows),
                        step_valid, lr_vec[loc.start:loc.stop])[1]

    def gathered(*per_state):
        """The (k_pad,) values of every rank's states, on the host."""
        local = torch.stack([t.float() for t in per_state], 1)
        if pl.fold_group is not None:
            local = all_gather_tensor(local, pl.fold_group)
        return local.cpu().numpy().T

    # ---- stage 1 (SimMLM expert pretraining): base LRs, no selection ----
    # (the sequential driver's stage 1 runs at cfg.learning_rate, which for
    # a swept candidate is that candidate's lr)
    if stage1_trainer is not None:
        s1_epoch = _build_parallel_train_epoch(stage1_trainer)
        for epoch in range(1, cfg.stage1_epochs + 1):
            s1_loss = run_epoch(s1_epoch, base_lrs)
            if epoch % 10 == 0 or epoch == 1:
                log.info("[%s %s] stage1 epoch %d mean loss %.4f", cfg.name,
                         tag, epoch, float(s1_loss.mean()))

    # ---- main epochs: all states advance together, records per state ----
    train_epoch = _build_parallel_train_epoch(trainer)
    k_n = pl.k
    run = StackedRun(histories=[[] for _ in range(k_n)],
                     best_c=np.full(k_n, -np.inf),
                     best_epoch=np.zeros(k_n, np.int64),
                     best_params=[None] * k_n,
                     epochs_run=np.zeros(k_n, np.int64), total_steps=0)
    bad = np.zeros(k_n, np.int64)
    active = np.ones(k_n, bool)
    keeps = keep_best and pl.data_rank == 0

    for epoch in range(1, num_epochs + 1):
        if not active.any():
            break
        if cfg.scheduler == "cosine":
            lrs = np.asarray([cosine_annealing(b, epoch - 1, num_epochs)
                              for b in base_lrs])
        tr_losses = run_epoch(train_epoch, lrs)
        cidx, vloss = evaluate(state, stacked_batches(
            trainer, data, eidx, ebv, streaming), eval_valid)
        # ONE read-back fences the epoch
        tr_losses, cidx, vloss = gathered(tr_losses, cidx, vloss)

        for k in range(k_n):
            if not active[k]:
                continue
            val_c = float(cidx[k])
            if cfg.scheduler == "plateau":
                lrs[k] = plateaus[k].step(val_c)
            run.histories[k].append(dict(
                epoch=epoch, train_loss=float(tr_losses[k]),
                val_loss=float(vloss[k]), val_c_index=val_c,
                lr=float(lrs[k])))
            run.epochs_run[k] = epoch
            if val_c > run.best_c[k]:
                run.best_c[k], run.best_epoch[k] = val_c, epoch
                if keeps and k in loc:
                    run.best_params[k] = state.fold_state_dict(k - loc.start)
                bad[k] = 0
            else:
                bad[k] += 1
            if cfg.patience is not None and bad[k] >= cfg.patience:
                active[k] = False
                log.info("[%s %s %d] early stop at epoch %d", cfg.name,
                         unit, k + 1, epoch)
        if epoch % 10 == 0 or epoch == 1:
            log.info("[%s %s] epoch %d mean val C %.4f, best so far %.4f "
                     "(%d active)", cfg.name, tag, epoch,
                     float(cidx[:k_n].mean()), float(run.best_c.max()),
                     int(active.sum()))
    run.total_steps = total_steps
    return run


def collect_best(best_params: list, placement: FoldPlacement) -> list:
    """Every state's best snapshot on the coordinator (each is kept by the
    data rank 0 of its fold row; one ``gather_object`` over the default
    group, every rank calls); the other ranks get Nones. Unchanged on one
    device."""
    if placement.fold_group is None and placement.data_group is None:
        return best_params
    mine = {k: v for k, v in enumerate(best_params) if v is not None}
    every = [None] * dist.get_world_size() if is_coordinator() else None
    dist.gather_object(mine, every, dst=0)
    out = [None] * len(best_params)
    for part in every or ():
        for k, v in part.items():
            out[k] = v
    return out


def run_cross_validation_parallel(
    cfg: ModelRunConfig,
    table,
    rnaseq_csv=None,
    results_dir="results",
    models_dir="models",
    mesh=None,
    fold_axis: str = "fold",
    data_axis: str = "data",
    backbone: str = "densenet121",
    dtype=None,
    remat: bool = False,
    use_pallas_resample: bool = False,
    hu_window=None,
    num_epochs: int | None = None,
    write_outputs: bool = True,
    aot_cache_dir=None,
    streaming: bool = False,
    prepared=None,
    init_hook=None,
    device="cuda",
):
    """Fold-parallel CV run for one model config on ``device``. Returns
    ``(payload, fold_outcomes)`` with the sequential driver's schema, and
    writes the same artifacts (``fold_K_best.pt`` + ``.meta.json``,
    ``cv_results.json``).

    ``mesh`` (:func:`make_fold_mesh`; None: one device) spreads the folds
    over its ``fold_axis`` and each fold's batch over its ``data_axis``
    (module docstring); every rank calls this with the same arguments, and
    only the coordinator writes. ``streaming`` keeps the cohort on the
    host and prefetches each step's stacked batch. ``prepared`` and
    ``init_hook`` (``(fold, state) -> state | None`` after each fold's
    ``init_state``) are the sequential driver's."""
    if aot_cache_dir:  # before the ingest, which may build the W-pass
        aot_cache.use(aot_cache_dir)
    name = cfg.name
    num_epochs = num_epochs or cfg.num_epochs
    dev = resolve_device(device)
    dtype = _compute_dtype(dtype)
    writes = write_outputs and is_coordinator()
    n_data = mesh_shape(mesh).get(data_axis, 1)
    eval_bs = TrainConfig.eval_batch_size
    if cfg.batch_size % n_data or eval_bs % n_data:
        raise ValueError(f"batch sizes ({cfg.batch_size}, {eval_bs}) must "
                         f"divide by the '{data_axis}' axis ({n_data})")

    arrays, splits = prepared if prepared is not None else prepare_cv_data(
        cfg, table, rnaseq_csv=rnaseq_csv,
        use_pallas_resample=use_pallas_resample, hu_window=hu_window,
        device=dev)
    rna_dim = arrays.arrays["rnaseq"].shape[1]
    n_folds = len(splits)
    placement = fold_placement(n_folds, mesh, fold_axis, data_axis)
    # the dummy folds (k_pad > K) reuse the last split; they compute but
    # are never recorded
    padded = splits + [splits[-1]] * (placement.k_pad - n_folds)
    trainer, stage1_trainer = make_trainers(
        cfg, rna_dim, backbone, dtype, dev, remat=remat,
        mesh=mesh if n_data > 1 else None, batch_axis=data_axis,
        aot_cache_dir=aot_cache_dir)
    data = ({k: np.asarray(v) for k, v in arrays.arrays.items()}
            if streaming else arrays.to_device(dev))

    t_start = time.monotonic()
    folds = range(1, placement.k_pad + 1)
    hook = init_hook and (lambda f, st: init_hook(f, st)
                          if f <= n_folds else None)
    state = init_stacked(trainer, [(folds[i], folds[i], cfg.seed)
                                   for i in placement.local], hook)

    run = train_stacked(
        trainer, stage1_trainer, state, cfg, data, [s[0] for s in padded],
        [s[1] for s in padded], np.full(placement.k_pad, cfg.learning_rate),
        [np.random.default_rng(cfg.seed + f) for f in folds], num_epochs,
        streaming=streaming, placement=placement)
    best_c, best_epoch = run.best_c, run.best_epoch
    best_params = (collect_best(run.best_params, placement) if write_outputs
                   else run.best_params)

    # ---- outcomes + artifacts (the sequential driver's schema) ----
    elapsed = time.monotonic() - t_start
    outcomes: list[FoldOutcome] = []
    for k, (tr, va, tss) in enumerate(splits):
        if writes and best_params[k] is not None:
            save_fold(models_dir, cfg, k + 1, best_params[k],
                      backbone=backbone, rna_dim=rna_dim, hu_window=hu_window,
                      use_pallas_resample=use_pallas_resample,
                      resample_mode=arrays.ingest_mode,
                      best_epoch=best_epoch[k], best_c_index=best_c[k])
        outcomes.append(FoldOutcome(
            fold=k + 1, best_c_index=float(best_c[k]),
            best_epoch=int(best_epoch[k]), train_size=len(tr),
            val_size=len(va), train_survival_size=tss,
            epochs_run=int(run.epochs_run[k]), history=run.histories[k],
            wall_s=elapsed))
        log.info("[%s parallel fold %d] best C-index %.4f @ epoch %d", name,
                 k + 1, best_c[k], best_epoch[k])

    payload = build_and_write_cv_payload(
        cfg, outcomes, num_epochs, int(arrays.n), results_dir,
        write_outputs=writes)
    log.info("[%s parallel] CV done: %.1fs, %d steps (%d folds in flight "
             "here), %.2f steps/s", name, elapsed, run.total_steps,
             len(placement.local), run.total_steps / max(elapsed, 1e-9))
    return payload, outcomes
