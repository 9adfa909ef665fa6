"""Training epochs of one fold, as the CV driver runs them.

The general generator of every training mix: the mix file gives the batch
size, the fold, the cohort's availability patterns and how many set-up
steps the reference follows; the configuration file gives the model, the
optimizer and the precision.

Set-up builds one ``Trainer`` and one train state from the benchmark's
weights, then drives that state through its first steps with the window's
own call (``Trainer.train_epoch`` on one batch of rows that no other step
sees; the last as ragged as the window's last batch, so that the program
pads it) and one ``Trainer.evaluate``, which warms every shape the window
uses. The window hands on the same state and runs whole epochs
(``train_epoch``, ``evaluate``, the LR schedule and the best-weights copy,
as ``train/cv.py`` does) until the first epoch end at or after
``seconds``; ``train_patients_per_s`` is every real patient row trained in
it over all of its time. A traced run profiles one such epoch instead.

Once the window has closed and the program's state is freed, the plain
reference follows the set-up steps from the same weights, rows, shuffle
and dropout seeds, and the comparison decides ``correct``.

``readings`` gives ``control.py`` the readings the cell's limits are set
from.
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


def build_model_fn(cfg: dict):
    """The program's model constructor for ``cfg``'s family, found by name
    (``programs/<family>.py``)."""
    program = registry.load_program(cfg["family"])
    return lambda gen: program.model(cfg, gen)


def build_trainer(cfg: dict, batch_size: int, device, kernel_cache):
    from multimodal_survival_prediction_tpu_torch.config import ALL_CONFIGS
    from multimodal_survival_prediction_tpu_torch.train.adapters import (
        make_adapters,
    )
    from multimodal_survival_prediction_tpu_torch.train.engine import (
        TrainConfig,
        Trainer,
    )

    t = cfg["train"]
    run_cfg = dataclasses.replace(
        ALL_CONFIGS[cfg["family"]], batch_size=batch_size,
        learning_rate=t["learning_rate"], weight_decay=t["weight_decay"],
        optimizer=t["optimizer"], grad_clip=t["grad_clip"],
        gate_entropy_weight=t.get("gate_entropy_weight", 0.0))
    batch_to_inputs, hazard_and_aux = make_adapters(run_cfg)
    tcfg = TrainConfig(batch_size=batch_size,
                       eval_batch_size=t["eval_batch_size"],
                       learning_rate=t["learning_rate"],
                       weight_decay=t["weight_decay"],
                       optimizer=t["optimizer"], grad_clip=t["grad_clip"],
                       ties="breslow")
    return Trainer(build_model_fn(cfg), batch_to_inputs, hazard_and_aux,
                   tcfg, device=device,
                   aot_cache_dir=(str(kernel_cache) if kernel_cache
                                  else None))


class Schedule:
    """The configuration's epoch-granular LR schedule (the program's
    ``ReduceLROnPlateau`` or cosine annealing, as ``train/cv.py`` steps
    them)."""

    def __init__(self, t: dict):
        from multimodal_survival_prediction_tpu_torch.train import schedules

        self.t = t
        self.lr = t["learning_rate"]
        self._cosine = schedules.cosine_annealing
        self._plateau = (schedules.ReduceLROnPlateau(lr=self.lr)
                         if t["scheduler"] == "plateau" else None)
        self.epoch = 0

    def before_epoch(self) -> float:
        self.epoch += 1
        if self.t["scheduler"] == "cosine":
            self.lr = self._cosine(self.t["learning_rate"], self.epoch - 1,
                                   self.t["num_epochs"])
        return self.lr

    def after_epoch(self, val_c: float):
        if self._plateau is not None:
            self.lr = self._plateau.step(val_c)


def _sync(device):
    if device.type == "cuda":
        torch.cuda.synchronize(device)


@dataclasses.dataclass
class Prepared:
    """A training cell after set-up: the inputs the benchmark made, the
    program's trainer and state after the set-up steps, and what the
    program produced in them."""

    inputs: compare.Inputs
    train_rows: np.ndarray
    trainer: object
    state: object
    shuffle: np.random.Generator
    outputs: compare.Outputs


def setup_sizes(n_train: int, steps: int, batch: int) -> list:
    """Rows of each set-up step: full batches, and last as many rows as the
    window's ragged last batch (``n_train % batch``), which the program
    pads by cycling its permutation; a full one where the fold has none."""
    return [batch] * (steps - 1) + [n_train % batch or batch]


def pick_setup_rows(data: dict, train_rows, sizes: list,
                    seed: int) -> list:
    """Distinct train rows for the set-up steps, ``sizes[k]`` for step
    ``k``, drawn from ``seed``: each step holds two rows with an event, so
    that its Cox loss is never exactly 0 (a batch whose only event has the
    latest time has a zero loss and zero gradient, which no precision can
    tell apart), and the rest from the other train rows."""
    rng = np.random.default_rng(seed)
    ev = (data["event"].cpu().numpy() > 0) & (data["svalid"].cpu().numpy()
                                               > 0)
    rows = rng.permutation(np.asarray(train_rows))
    n_ev = [min(2, n) for n in sizes]
    with_event = rows[ev[rows]][:sum(n_ev)]
    rest = rng.permutation(np.setdiff1d(rows, with_event, assume_unique=True))
    out, i, j = [], 0, 0
    for n, e in zip(sizes, n_ev):
        out.append(np.concatenate([with_event[i:i + e], rest[j:j + n - e]]))
        i, j = i + e, j + n - e
    return out


def prepare(cfg: dict, mix: dict, seed: int, device, kernel_cache=None,
            plant=None) -> Prepared:
    """Set-up: the cohort, its fold and the weights from ``seed``, one
    Trainer and one train state, driven through the set-up steps with the
    window's own call and evaluated once. ``plant`` (tests only) is called
    with the trainer before the first step."""
    from multimodal_survival_prediction_tpu_torch.train.engine import (
        best_weights,
    )

    s_cohort, s_weights, s_fold, s_drop, s_shuffle, s_setup = \
        synth.seeds(seed, 6)
    arch, t = cfg["arch"], cfg["train"]
    b = int(mix["batch_size"])
    data = synth.make_cohort(mix["cohort"], arch["image_shape"],
                             arch["rna_dim"], s_cohort, device)
    keep = synth.select_rows(data, t["cohort_requires"])
    if len(keep) != len(data["svalid"]):
        data = {k: v[torch.from_numpy(keep).to(device)]
                for k, v in data.items()}
    train_rows, val_rows = synth.fold_rows(
        data["svalid"].cpu().numpy(), t["n_folds"], int(mix["fold"]), s_fold,
        t["unlabelled_in_train"])
    weights = synth.make_weights(ref_model.param_spec(cfg), s_weights, device)
    trainer = build_trainer(cfg, b, device, kernel_cache)
    if plant is not None:
        plant(trainer)
    state = trainer.init_state(fold=int(mix["fold"]), seed=s_drop)
    state.model.load_state_dict(weights, strict=True)

    setup_rows = pick_setup_rows(
        data, train_rows,
        setup_sizes(len(train_rows), int(mix["setup_steps"]), b), s_setup)
    shuffle = np.random.default_rng(s_shuffle)
    names = [n for n, _ in state.model.named_parameters()]
    losses, first, states = [], None, []
    b1 = trainer.tx.b1
    for rows in setup_rows:
        state, loss = trainer.train_epoch(state, data, rows, shuffle,
                                          t["learning_rate"])
        losses.append(loss)
        states.append({k: v.detach().clone()
                       for k, v in state.model.state_dict().items()})
        if first is None:  # the gradient as Adam took it: mu_1 / (1 - b1)
            first = {n: m.detach() / (1 - b1)
                     for n, m in zip(names, state.opt_state.mu)}
    val_c, _, hazards = trainer.evaluate(state, data, val_rows)
    best_weights(state)  # warms the copy the window makes
    _sync(device)
    inputs = compare.Inputs(
        weights=weights, data=data, setup_rows=setup_rows, batch_size=b,
        shuffle_seed=s_shuffle,
        dropout_seed=s_drop * 1000 + int(mix["fold"]),  # init_state's
        val_rows=val_rows)
    return Prepared(
        inputs=inputs, train_rows=train_rows, trainer=trainer, state=state,
        shuffle=shuffle,
        outputs=compare.Outputs(losses, first, states,
                                np.asarray(hazards, np.float64), val_c))


def judge(cfg: dict, prep: Prepared):
    """The reference's outputs from the same inputs, and the numbers."""
    ref = compare.reference_outputs(cfg, prep.inputs)
    return compare.training_numbers(cfg, prep.outputs, ref, prep.inputs)


def _free():
    import gc

    gc.collect()
    if torch.cuda.is_available():
        torch.cuda.empty_cache()


# the control's faults, planted in the reference put in the program's place
FAULTS = {
    "fault_half_batch": dict(batch_fault=lambda b: {
        k: v[:len(v) // 2] for k, v in b.items()}),
    "fault_state_unchanged": dict(frozen=True),
}
# read beside them, not a fault the limits are set from
EXTRA_FAULTS = {"fault_padding_in_loss": dict(padding_in_loss=True)}


def readings(cell, seeds, control_seeds, kernel_cache, emit,
             device="cuda"):
    """``control.py``'s readings of a training cell. For every seed of
    ``seeds`` the cell's set-up (the program's own path, as a benchmark run
    makes it) judged against the reference: the lower readings. For every
    seed of ``control_seeds`` the reference in the program's place, one
    precision below the configuration's (TF32 on for matmuls and cuDNN,
    where it states float32 with TF32 off), and again in float32 with each
    planted fault: the upper readings."""
    cfg, mix = cell.config, cell.traffic
    dev = torch.device(device)
    for kind, seed in ([("program", s) for s in seeds]
                       + [("control", s) for s in control_seeds]):
        t0 = time.perf_counter()
        dev_mod.pin_precision(cfg["precision"])
        prep = prepare(cfg, mix, seed, dev, kernel_cache)
        prep.trainer = prep.state = None
        _free()
        inp = prep.inputs
        ref = compare.reference_outputs(cfg, inp)
        if kind == "program":
            nums, where = compare.training_numbers(cfg, prep.outputs, ref,
                                                   inp)
            emit({"kind": "program", "seed": seed, "numbers": nums,
                  "where": where, "s": time.perf_counter() - t0})
            continue
        dev_mod.pin_precision("tf32")
        low = compare.reference_outputs(cfg, inp)
        dev_mod.pin_precision(cfg["precision"])
        nums, where = compare.training_numbers(cfg, low, ref, inp)
        emit({"kind": "control_tf32", "seed": seed, "numbers": nums,
              "where": where})
        for name, plant in {**FAULTS, **EXTRA_FAULTS}.items():
            bad = compare.reference_outputs(cfg, inp, **plant)
            nums, where = compare.training_numbers(cfg, bad, ref, inp)
            emit({"kind": name, "seed": seed, "numbers": nums,
                  "where": where, "s": time.perf_counter() - t0})
        del prep, ref, low, bad
        _free()


def run(cell, seed: int, seconds: float, trace: bool, t_start: float,
        kernel_cache=None, device="cuda", plant=None):
    """One run of a training cell; returns a ``report.Result``. ``plant``
    (tests only) breaks the timed path, to see ``correct`` come out
    false."""
    from multimodal_survival_prediction_tpu_torch.train.engine import (
        best_weights,
    )

    cfg, mix = cell.config, cell.traffic
    device = torch.device(device)
    dev_mod.pin_precision(cfg["precision"])
    t = cfg["train"]
    b = int(mix["batch_size"])
    prep = prepare(cfg, mix, seed, device, kernel_cache, plant)
    setup_s = time.perf_counter() - t_start

    # ---------------- the window ----------------
    trainer, data = prep.trainer, prep.inputs.data
    train_rows, val_rows = prep.train_rows, prep.inputs.val_rows
    sched = Schedule(t)
    best_c, best = -math.inf, None
    state = prep.state
    steps_per_epoch = -(-len(train_rows) // b)
    counters = {"epochs": 0, "rows": 0, "steps": 0, "bad_loss": 0}

    def epoch():
        nonlocal state, best_c, best
        lr = sched.before_epoch()
        with tracing.span("train_epoch"):
            state, tr_loss = trainer.train_epoch(state, data, train_rows,
                                                 prep.shuffle, lr)
        with tracing.span("evaluate"):
            val_c, _, _ = trainer.evaluate(state, data, val_rows)
        sched.after_epoch(val_c)
        if val_c > best_c:
            with tracing.span("best_weights"):
                best_c, best = val_c, best_weights(state)
        counters["epochs"] += 1
        counters["rows"] += len(train_rows)
        counters["steps"] += steps_per_epoch
        counters["bad_loss"] += not math.isfinite(tr_loss)

    summary, read_s, plain_s, run_peak = None, 0.0, None, 0
    t0 = time.perf_counter()
    if trace:
        # one epoch untimed by the profiler (its host clock gives
        # step_mfu.train), then one profiled epoch for the other readers
        epoch()
        _sync(device)
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
    _sync(device)
    window_s = time.perf_counter() - t0
    peak = (torch.cuda.max_memory_allocated(device)
            if device.type == "cuda" else 0)  # the profiled epoch's, traced
    power = dev_mod.power_limit_w() if device.type == "cuda" else None

    # ---------------- the comparison ----------------
    prep.trainer = prep.state = state = best = None
    trainer = None
    if device.type == "cuda":
        torch.cuda.empty_cache()
    numbers, where = judge(cfg, prep)
    checks = report.compare(numbers, cell.limits)

    # ---------------- the result ----------------
    flops = cfg["flops"]
    eval_rows = -(-len(val_rows) // t["eval_batch_size"]) * \
        t["eval_batch_size"]
    epoch_flops = (steps_per_epoch * b * flops["train_per_patient"]
                   + eval_rows * flops["eval_per_patient"])
    description = dev_mod.describe(cell.chips, max(peak, run_peak), power,
                                   device.type)
    notes = {"window_s": window_s, "epochs": counters["epochs"],
             "seconds_asked": seconds, "steps_per_epoch": steps_per_epoch,
             "train_rows": int(len(train_rows)),
             "val_rows": int(len(val_rows)), "worst": where}
    breakdown = None
    if trace:
        run_info = RunInfo(
            summary=summary, plain_epoch_s=plain_s,
            steps=steps_per_epoch, peak_bytes=peak,
            epoch_flops=epoch_flops,
            fused_stages=(ref_stages(cfg, b) if cfg.get("fused_bn1")
                          else None))
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


def ref_stages(cfg: dict, batch: int):
    from port_bench.core import peaks

    return peaks.densenet_fused_stages(cfg["arch"]["densenet"],
                                       cfg["arch"]["image_shape"], batch)


@dataclasses.dataclass
class RunInfo:
    """What a per-layer reader of a training cell reads."""

    summary: object  # trace.Summary of the profiled epoch
    plain_epoch_s: float  # the epoch before it, without the profiler
    steps: int  # train steps an epoch
    peak_bytes: int  # over the profiled epoch
    epoch_flops: float  # the reference's count for one epoch
    fused_stages: list | None
