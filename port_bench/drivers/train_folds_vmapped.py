"""Fold-parallel training: every fold of the cross-validation trained in
the same step, as the port's fold-parallel driver runs them
(``train/cv_parallel.py``, the CLI's ``--fold-parallel``).

The mix gives the folds (``folds``), the batch size of each, the cohort's
availability patterns and how many set-up steps the reference follows; the
configuration gives the model, the optimizer and the precision. The fold
states are stacked (``StackedState``) and each step is one
``torch.func.vmap`` of the Trainer's loss and gradient over them, with the
model the configuration states (the gated flagship with its fused kernels,
whose wrappers carry a vmap rule); evaluation is one vmapped eval step a
batch, every fold's hazards pooled into its own C-index.

Set-up takes ``train_epochs``'s pieces (``registry.load_driver``): one
Trainer, each fold's state from its own benchmark weights, stacked and
driven through the set-up steps with the window's own vmapped epoch, one
step at a time on rows no other step sees (the last as ragged as the
window's last batch), then one evaluation. The window runs whole epochs of
every fold (each fold's shuffle, its plateau schedule and best-weights
copy, as ``train_stacked`` keeps them) until the first epoch end at or
after ``seconds``; ``train_patients_per_s`` counts the real rows of every
fold. A traced run profiles one such epoch instead.

The reference follows each fold's set-up steps from that fold's weights,
rows, shuffle and dropout seeds, and each number of the comparison is the
worst fold's.
"""

from __future__ import annotations

import dataclasses
import math
import time

import numpy as np
import torch

from port_bench.core import device as dev_mod
from port_bench.core import registry, report, synth
from port_bench.core import trace as tracing
from port_bench.reference import compare
from port_bench.reference import model as ref_model

epochs = registry.load_driver("train_epochs")


@dataclasses.dataclass
class Prepared:
    """A fold-parallel cell after set-up: the inputs of each fold, the
    trainer, the stacked state and the vmapped epoch and evaluation built
    once, each fold's shuffle generator, and what the program produced."""

    inputs: list  # compare.Inputs, one a fold
    train_rows: list
    trainer: object
    state: object  # cv_parallel.StackedState
    epoch_fn: object
    evaluate: object
    shuffles: list
    outputs: list  # compare.Outputs, one a fold


def _eval_batches(cvp, trainer, data, val_rows):
    eidx, ebv = cvp._stack_fold_indices(
        list(val_rows), trainer.cfg.eval_batch_size, [None] * len(val_rows))
    return eidx, ebv, ebv.max(axis=2) > 0


def prepare(cfg: dict, mix: dict, seed: int, device,
            kernel_cache=None) -> Prepared:
    """Set-up: the cohort, its folds and each fold's weights from
    ``seed``, one Trainer, the stacked fold states, driven through the
    set-up steps with the window's vmapped epoch and evaluated once."""
    from multimodal_survival_prediction_tpu_torch.train import (
        cv_parallel as cvp,
    )

    s_cohort, s_weights, s_fold, s_drop, s_shuffle, s_setup = \
        synth.seeds(seed, 6)
    arch, t = cfg["arch"], cfg["train"]
    folds = [int(f) for f in mix["folds"]]
    k, b = len(folds), int(mix["batch_size"])
    data = synth.make_cohort(mix["cohort"], arch["image_shape"],
                             arch["rna_dim"], s_cohort, device)
    keep = synth.select_rows(data, t["cohort_requires"])
    if len(keep) != len(data["svalid"]):
        data = {n: v[torch.from_numpy(keep).to(device)]
                for n, v in data.items()}
    splits = [synth.fold_rows(data["svalid"].cpu().numpy(), t["n_folds"], f,
                              s_fold, t["unlabelled_in_train"])
              for f in folds]
    train_rows = [tr for tr, _ in splits]
    val_rows = [va for _, va in splits]
    spec = ref_model.param_spec(cfg)
    weights = [synth.make_weights(spec, s, device)
               for s in synth.seeds(s_weights, k)]
    shuffle_seeds = synth.seeds(s_shuffle, k)

    trainer = epochs.build_trainer(cfg, b, device, kernel_cache)
    states = []
    for f, w in zip(folds, weights):
        st = trainer.init_state(fold=f, seed=s_drop)
        st.model.load_state_dict(w, strict=True)
        states.append(st)
    state = cvp.StackedState(states)
    epoch_fn = cvp._build_parallel_train_epoch(trainer)
    evaluate = cvp._build_parallel_eval(trainer)
    eval_step = cvp._build_parallel_eval_step(trainer)

    setup_rows = [epochs.pick_setup_rows(
        data, tr, epochs.setup_sizes(len(tr), int(mix["setup_steps"]), b), s)
        for tr, s in zip(train_rows, synth.seeds(s_setup, k))]
    shuffles = [np.random.default_rng(s) for s in shuffle_seeds]
    views = {**state.param_views, **state.buffer_views}
    losses, states_after = [[] for _ in folds], [[] for _ in folds]
    first, b1 = None, trainer.tx.b1
    for step_rows in zip(*setup_rows):
        idx, bv = cvp._stack_fold_indices(list(step_rows), b, shuffles)
        step_losses, _ = epoch_fn(
            state, cvp.stacked_batches(trainer, data, idx, bv),
            bv.max(axis=2) > 0, np.full(k, t["learning_rate"]))
        for i in range(k):
            losses[i].append(float(step_losses[0, i]))
            states_after[i].append({n: views[n][i].detach().clone()
                                    for n in state.state_keys})
        if first is None:  # the gradient as Adam took it: mu_1 / (1 - b1)
            mus = cvp._split(state.mu, state)
            first = [{n: m[i].detach() / (1 - b1)
                      for n, m in zip(state.param_names, mus)}
                     for i in range(k)]
    eidx, ebv, eval_valid = _eval_batches(cvp, trainer, data, val_rows)
    cindex, _ = evaluate(state, cvp.stacked_batches(trainer, data, eidx, ebv),
                         eval_valid)
    with torch.no_grad():
        hazards = torch.cat([eval_step(state, batch)[0] for batch in
                             cvp.stacked_batches(trainer, data, eidx, ebv)],
                            dim=1)
    state.fold_state_dict(0)  # warms the copy the window makes
    epochs._sync(device)
    inputs = [compare.Inputs(
        weights=weights[i], data=data, setup_rows=setup_rows[i],
        batch_size=b, shuffle_seed=shuffle_seeds[i],
        dropout_seed=s_drop * 1000 + folds[i],  # init_state's
        val_rows=val_rows[i]) for i in range(k)]
    outputs = [compare.Outputs(
        losses[i], first[i], states_after[i],
        hazards[i, :len(val_rows[i])].double().cpu().numpy(),
        float(cindex[i])) for i in range(k)]
    return Prepared(inputs=inputs, train_rows=train_rows, trainer=trainer,
                    state=state, epoch_fn=epoch_fn, evaluate=evaluate,
                    shuffles=shuffles, outputs=outputs)


def worst(per_fold: list):
    """``(numbers, where)``: each number's largest value over the folds,
    and where each was found (the fold, and its leaf where one is named)."""
    numbers, where = {}, {}
    for i, (nums, at) in enumerate(per_fold):
        for name, v in nums.items():
            if name not in numbers or v > numbers[name]:
                numbers[name] = v
                where[name] = {"fold": i, "at": at.get(name)}
    return numbers, where


def judge(cfg: dict, inputs: list, outputs: list):
    """The reference's run of each fold from the same inputs, and the worst
    fold's numbers."""
    per_fold = []
    for inp, out in zip(inputs, outputs):
        ref = compare.reference_outputs(cfg, inp)
        per_fold.append(compare.training_numbers(cfg, out, ref, inp))
        del ref
        epochs._free()
    return worst(per_fold)


def readings(cell, seeds, control_seeds, kernel_cache, emit,
             device="cuda"):
    """``control.py``'s readings (``train_epochs.readings``), each number
    the worst fold's: for every seed of ``seeds`` the program's set-up
    judged against the reference; for every seed of ``control_seeds`` the
    reference in the program's place one precision below the
    configuration's, and in float32 with each planted fault."""
    cfg, mix = cell.config, cell.traffic
    dev = torch.device(device)
    for kind, seed in ([("program", s) for s in seeds]
                       + [("control", s) for s in control_seeds]):
        t0 = time.perf_counter()
        dev_mod.pin_precision(cfg["precision"])
        prep = prepare(cfg, mix, seed, dev, kernel_cache)
        inputs, outputs = prep.inputs, prep.outputs
        prep = None
        epochs._free()
        if kind == "program":
            nums, where = judge(cfg, inputs, outputs)
            emit({"kind": "program", "seed": seed, "numbers": nums,
                  "where": where, "s": time.perf_counter() - t0})
            continue
        plants = {"control_tf32": None, **epochs.FAULTS,
                  **epochs.EXTRA_FAULTS}
        per_kind = {name: [] for name in plants}
        for inp in inputs:
            ref = compare.reference_outputs(cfg, inp)
            dev_mod.pin_precision("tf32")
            low = compare.reference_outputs(cfg, inp)
            dev_mod.pin_precision(cfg["precision"])
            per_kind["control_tf32"].append(
                compare.training_numbers(cfg, low, ref, inp))
            for name, plant in {**epochs.FAULTS,
                                **epochs.EXTRA_FAULTS}.items():
                bad = compare.reference_outputs(cfg, inp, **plant)
                per_kind[name].append(
                    compare.training_numbers(cfg, bad, ref, inp))
            del ref, low, bad
            epochs._free()
        for name, per_fold in per_kind.items():
            nums, where = worst(per_fold)
            emit({"kind": name, "seed": seed, "numbers": nums,
                  "where": where, "s": time.perf_counter() - t0})


def run(cell, seed: int, seconds: float, trace: bool, t_start: float,
        kernel_cache=None, device="cuda"):
    """One run of a fold-parallel cell; returns a ``report.Result``."""
    from multimodal_survival_prediction_tpu_torch.train import (
        cv_parallel as cvp,
    )

    cfg, mix = cell.config, cell.traffic
    device = torch.device(device)
    dev_mod.pin_precision(cfg["precision"])
    t = cfg["train"]
    b = int(mix["batch_size"])
    prep = prepare(cfg, mix, seed, device, kernel_cache)
    setup_s = time.perf_counter() - t_start

    # ---------------- the window ----------------
    trainer, state, data = prep.trainer, prep.state, prep.inputs[0].data
    k = len(prep.train_rows)
    val_rows = [inp.val_rows for inp in prep.inputs]
    eidx, ebv, eval_valid = _eval_batches(cvp, trainer, data, val_rows)
    scheds = [epochs.Schedule(t) for _ in range(k)]
    best_c, best = np.full(k, -math.inf), [None] * k
    steps_per_epoch = max(-(-len(r) // b) for r in prep.train_rows)
    counters = {"epochs": 0, "rows": 0, "steps": 0, "bad_loss": 0}

    def epoch():
        lrs = np.asarray([s.before_epoch() for s in scheds])
        idx, bv = cvp._stack_fold_indices(prep.train_rows, b, prep.shuffles)
        with tracing.span("train_epoch"):
            _, tr_loss = prep.epoch_fn(
                state, cvp.stacked_batches(trainer, data, idx, bv),
                bv.max(axis=2) > 0, lrs)
            tr_loss = tr_loss.cpu().numpy()  # waits for the epoch's steps
        with tracing.span("evaluate"):
            cindex, _ = prep.evaluate(
                state, cvp.stacked_batches(trainer, data, eidx, ebv),
                eval_valid)
            cindex = cindex.cpu().numpy()
        for i in range(k):
            scheds[i].after_epoch(float(cindex[i]))
            if cindex[i] > best_c[i]:
                with tracing.span("best_weights"):
                    best_c[i], best[i] = cindex[i], state.fold_state_dict(i)
        counters["epochs"] += 1
        counters["rows"] += sum(len(r) for r in prep.train_rows)
        counters["steps"] += steps_per_epoch * k
        counters["bad_loss"] += int((~np.isfinite(tr_loss)).sum())

    summary, read_s, plain_s, run_peak = None, 0.0, None, 0
    t0 = time.perf_counter()
    if trace:
        epoch()
        epochs._sync(device)
        plain_s = time.perf_counter() - t0
        if device.type == "cuda":
            run_peak = torch.cuda.max_memory_allocated(device)
            torch.cuda.reset_peak_memory_stats(device)
        with tracing.Profiled() as prof:
            with tracing.window():
                epoch()
        summary, read_s = prof.summary, prof.read_s
    else:
        while True:
            epoch()
            if time.perf_counter() - t0 >= seconds:
                break
    epochs._sync(device)
    window_s = time.perf_counter() - t0
    peak = (torch.cuda.max_memory_allocated(device)
            if device.type == "cuda" else 0)
    power = dev_mod.power_limit_w() if device.type == "cuda" else None

    # ---------------- the comparison ----------------
    prep.trainer = prep.state = prep.epoch_fn = prep.evaluate = None
    trainer = state = best = None
    epochs._free()
    numbers, where = judge(cfg, prep.inputs, prep.outputs)
    checks = report.compare(numbers, cell.limits)

    # ---------------- the result ----------------
    flops = cfg["flops"]
    eval_b = t["eval_batch_size"]
    eval_rows = sum(-(-len(v) // eval_b) * eval_b for v in val_rows)
    epoch_flops = (steps_per_epoch * k * b * flops["train_per_patient"]
                   + eval_rows * flops["eval_per_patient"])
    description = dev_mod.describe(cell.chips, max(peak, run_peak), power,
                                   device.type)
    notes = {"window_s": window_s, "epochs": counters["epochs"],
             "seconds_asked": seconds, "folds": k,
             "steps_per_epoch": steps_per_epoch,
             "train_rows": [int(len(r)) for r in prep.train_rows],
             "val_rows": [int(len(v)) for v in val_rows], "worst": where}
    breakdown = None
    if trace:
        run_info = epochs.RunInfo(
            summary=summary, plain_epoch_s=plain_s, steps=steps_per_epoch,
            peak_bytes=peak, epoch_flops=epoch_flops, fused_stages=None)
        metrics = report.per_layer(cell, run_info)
        description.update(busy_s=summary.busy_s(),
                           window_s=summary.window_s)
        breakdown = summary.breakdown()
        notes.update(trace_read_s=read_s, plain_epoch_s=plain_s,
                     traced_epoch_s=summary.window_s)
    else:
        metrics = {"train_patients_per_s": (counters["rows"] / window_s,
                                            "patients/s"),
                   "setup_s": (setup_s, "s")}
    return report.Result(
        attempted=counters["steps"], failed=counters["bad_loss"],
        metrics=metrics, device=description, checks=checks,
        breakdown=breakdown, notes=notes)
