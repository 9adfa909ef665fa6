"""The numbers that decide ``correct``: gaps between what the program
produced and what the plain reference works out again from the same
inputs. Each is a worst case over its parts; ``limits/<cell>.json`` holds
the limit of each and the readings it was set from.

Training cells (:func:`training_numbers`). Two float32 runs of the same
steps drift apart after the first: Adam moves every weight by about the
learning rate whatever the size of its gradient, so a gradient element
near zero takes either sign on rounding. So the reference judges the
program two ways. It runs the set-up steps itself from the benchmark's
weights, and compares the first step and where the three steps end; and it
follows the program step by step, each step's loss taken at the state the
program started that step from, and the eval hazards at the state the
program ended in.

* ``loss1_gap``, ``loss2_gap``, ``loss3_gap``: each set-up step's loss
  against the reference's at the program's state before that step (the
  first is the benchmark's weights): ``|L_prog - L_ref|`` over
  ``max(|L_ref|, 0.1)``. The last step has as many rows as the window's
  ragged last batch, which the program pads and masks and the reference
  pads and masks again (:func:`setup_batches`).
* ``grad_gap``: the first step's gradient as the optimizer took it (the
  program's: its first moment after one step over ``1 - beta1``), by the
  worst leaf: ``|‖g_prog‖ - ‖g_ref‖|`` over the larger of ``‖g_ref‖`` and
  the median leaf's.
* ``grad_median_gap`` (reported, not compared): the same gap of the median
  leaf.
* ``change_gap``: the parameters' change over the set-up steps, against
  the reference's own three steps, by the worst leaf as ``grad_gap``,
  leaving out leaves whose reference gradient is under a thousandth of the
  median leaf's (Adam moves those by rounding alone).
* ``stats_gap``: the BatchNorm running means and variances' change, by the
  worst buffer, as ``change_gap``.
* ``count_gap``: the largest difference of ``num_batches_tracked``: exact.
* ``hazard_gap``: the eval-mode hazards of the validation rows against the
  reference's at the program's state after the set-up steps, the largest
  difference over the reference hazards' range.
* ``cindex_gap`` (reported, not compared): the program's C-index against
  Harrell's C-index of the program's own hazards, worked out by the
  reference.
"""

from __future__ import annotations

import math
from dataclasses import dataclass

import numpy as np
import torch

from . import model as ref_model
from . import survival
from . import train as ref_train

GRAD_FLOOR = 1e-3  # leaves under this share of the median leaf's gradient


@dataclass
class Outputs:
    """What one side produced over the set-up steps: each step's loss, the
    first step's gradient as the optimizer took it, the state_dict after
    each step, the eval hazards of the validation rows after the last and
    their C-index."""

    losses: list
    first_grads: dict
    states: list
    hazards: np.ndarray
    cindex: float

    @property
    def after(self) -> dict:
        return self.states[-1]


def _norms(d: dict, keys) -> np.ndarray:
    return np.asarray([float(torch.linalg.vector_norm(d[k].double()))
                       for k in keys])


def worst_leaf_gap(prog: np.ndarray, ref: np.ndarray, keys=()):
    """``(gap, key)``: the largest ``|prog - ref|`` over ``max(ref,
    median(ref))``, and the key where it is."""
    if not len(ref):
        return 0.0, None
    floor = max(float(np.median(ref)), 1e-30)
    gaps = np.abs(prog - ref) / np.maximum(ref, floor)
    i = int(np.argmax(gaps))
    return float(gaps[i]), (list(keys)[i] if len(keys) else None)


def median_leaf_gap(prog: np.ndarray, ref: np.ndarray) -> float:
    """The median over leaves of ``|prog - ref|`` over ``max(ref,
    median(ref))``."""
    if not len(ref):
        return 0.0
    floor = max(float(np.median(ref)), 1e-30)
    return float(np.median(np.abs(prog - ref) / np.maximum(ref, floor)))


@dataclass
class Inputs:
    """What the benchmark made and handed to both sides: the initial
    weights, the cohort, each set-up step's rows, the batch size the
    program pads a ragged step to, the seeds of its shuffle and dropout
    generators, and the validation rows."""

    weights: dict
    data: dict
    setup_rows: list
    batch_size: int
    shuffle_seed: int
    dropout_seed: int
    val_rows: np.ndarray


def setup_batches(inp: Inputs, padding_in_loss: bool = False):
    """The set-up steps' batches as ``Trainer.train_epoch`` makes them, worked
    out again: each step's rows in the order of the shared shuffle
    generator; a step of fewer rows than the batch padded by cycling that
    order, the padded rows seen by BatchNorm and dropout but masked out of
    the loss (``valid`` 0, and so ``svalid`` 0). ``padding_in_loss`` (a
    planted fault of the control) leaves the padded rows in the loss."""
    rng = np.random.default_rng(inp.shuffle_seed)
    dev = inp.data["time"].device
    out = []
    for rows in inp.setup_rows:
        order = rng.permutation(np.asarray(rows, np.int32))
        n, b = len(order), max(inp.batch_size, len(order))
        idx = np.concatenate([order, np.resize(order, b - n)])
        valid = torch.zeros(b, device=dev)
        valid[:n] = 1.0
        if padding_in_loss:
            valid[:] = 1.0
        batch = {k: v[torch.from_numpy(idx.astype(np.int64)).to(dev)]
                 for k, v in inp.data.items()}
        batch["valid"] = valid
        batch["svalid"] = batch["svalid"] * valid
        out.append(batch)
    return out


def _val(data, val_rows, key):
    return data[key][torch.from_numpy(np.asarray(val_rows, np.int64)).to(
        data[key].device)]


def reference_outputs(cfg, inp: Inputs, batch_fault=None, frozen=False,
                      padding_in_loss=False) -> Outputs:
    """The reference's :class:`Outputs` from the same inputs. The
    control's planted faults only: ``batch_fault`` rewrites each batch
    before the step; ``frozen`` makes every step return its state
    unchanged (the first moments stay 0); ``padding_in_loss`` counts a
    ragged step's padded rows in its loss."""
    batches = setup_batches(inp, padding_in_loss)
    if batch_fault is not None:
        batches = [batch_fault(b) for b in batches]
    losses, first, states = ref_train.run_steps(
        cfg, inp.weights, batches, inp.dropout_seed,
        cfg["train"]["learning_rate"], frozen=frozen)
    h = eval_hazards(cfg, states[-1], inp.data, inp.val_rows)
    return Outputs(losses, first, states, h,
                   _cindex(h, inp.data, inp.val_rows))


def eval_hazards(cfg, state, data, val_rows) -> np.ndarray:
    rows = torch.from_numpy(np.asarray(val_rows, np.int64)).to(
        data["time"].device)
    return ref_train.eval_hazards(cfg, state, data, rows).double(
    ).cpu().numpy()


def _cindex(h, data, val_rows) -> float:
    return survival.concordance(h, _val(data, val_rows, "time").cpu().numpy(),
                                _val(data, val_rows, "event").cpu().numpy(),
                                _val(data, val_rows, "svalid").cpu().numpy())


def training_numbers(cfg, prog: Outputs, ref: Outputs, inp: Inputs):
    """``(numbers, where)``: the training numbers (module docstring) and,
    for the leaf-wise ones, the leaf that sets each. ``ref`` is the
    reference's own run of the set-up steps."""
    weights, data, val_rows = inp.weights, inp.data, inp.val_rows
    followed = ref_train.follow_losses(
        cfg, [weights] + prog.states[:-1], setup_batches(inp),
        inp.dropout_seed)
    trained = [k for k in weights if ref_model.is_trained(k)]
    buffers = [k for k in weights if k.endswith(("running_mean",
                                                 "running_var"))]
    counts = [k for k in weights if k.endswith("num_batches_tracked")]
    numbers, where = {}, {}
    for i, (p, r) in enumerate(zip(prog.losses, followed)):
        numbers[f"loss{i + 1}_gap"] = abs(p - r) / max(abs(r), 0.1)

    g_ref = _norms(ref.first_grads, trained)
    g_prog = _norms(prog.first_grads, trained)
    numbers["grad_gap"], where["grad_gap"] = worst_leaf_gap(
        g_prog, g_ref, trained)
    numbers["grad_median_gap"] = median_leaf_gap(g_prog, g_ref)

    moved = g_ref >= GRAD_FLOOR * np.median(g_ref)
    keys = [k for k, m in zip(trained, moved) if m]
    where["left_out"] = [k for k, m in zip(trained, moved) if not m]

    def change(after, names):
        return {k: after[k].double() - weights[k].double() for k in names}

    numbers["change_gap"], where["change_gap"] = worst_leaf_gap(
        _norms(change(prog.after, keys), keys),
        _norms(change(ref.after, keys), keys), keys)
    numbers["stats_gap"], where["stats_gap"] = worst_leaf_gap(
        _norms(change(prog.after, buffers), buffers),
        _norms(change(ref.after, buffers), buffers), buffers)
    numbers["count_gap"] = float(max(
        (abs(int(prog.after[k]) - int(ref.after[k])) for k in counts),
        default=0))

    h_ref = eval_hazards(cfg, prog.after, data, val_rows)
    if prog.hazards.shape != h_ref.shape:  # hazards of other rows
        numbers["hazard_gap"] = numbers["cindex_gap"] = math.inf
        return numbers, where
    spread = max(float(h_ref.max() - h_ref.min()), 1e-30)
    numbers["hazard_gap"] = float(
        np.max(np.abs(prog.hazards - h_ref)) / spread)
    numbers["cindex_gap"] = abs(float(prog.cindex)
                                - _cindex(prog.hazards, data, val_rows))
    return numbers, where
