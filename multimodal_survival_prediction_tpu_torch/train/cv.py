"""K-fold cross-validation driver (port of
``multimodal_survival_prediction_tpu/train/cv.py``).

The reference training loop's control flow: seed-42 KFold over the patient
list (``train/kfold.py``, equal to sklearn's), per-epoch train + pooled-val
C-index, ReduceLROnPlateau or cosine schedule, best weights by val C-index,
early stop after ``patience`` epochs without improvement, and the
partial-modality trick of folding ALL unlabeled patients into every fold's
train set (reference partial_modality_training.py:502-515). Outputs: fold
checkpoints ``<models_dir>/<model>/fold_K_best.pt`` with the ``.meta.json``
that ``train/predict.py`` reads, and ``<results_dir>/<model>/cv_results.json``.

SimMLM's two-stage schedule: with ``cfg.stage1_epochs``, each fold first
trains ``stage1_epochs`` epochs with the stage-1 adapter (the experts' Cox
losses alone) at the fixed ``cfg.learning_rate``, without model selection,
on the same model and optimizer state (Adam's moments and count carry into
stage 2), then runs the main loop.

With ``resume``, every ``checkpoint_every`` epochs a fold saves its whole
train state under ``fold_K_resume/`` (``io/checkpoint.py``) and a resumed
run continues that fold's trajectory exactly (stage 1 is not run again);
the torch dropout generator's state takes the place of the JAX driver's
dropout key.

``dtype`` (None or ``torch.bfloat16``) is every family's compute
dtype, as the JAX driver's ``dtype``: parameters, optimizer state and fold
checkpoints stay float32, and the checkpoints' ``.meta.json`` records no
dtype (``predict_risk`` scores them in float32, as JAX does).

Not ported yet (each raises ``NotImplementedError`` naming its ROADMAP
item): ``streaming``, meshes / tensor parallelism / the sharded risk set,
``aot_cache_dir``, ``profile_dir`` and ``remat``.
"""

from __future__ import annotations

import json
import logging
import math
import time
from dataclasses import dataclass, field
from pathlib import Path

import numpy as np
import torch

from ..config import ModelRunConfig
from ..data.datasets import build_cohort_arrays, load_rnaseq_matrix, select_cohort
from ..io.checkpoint import (
    load_checkpoint,
    load_train_state,
    save_checkpoint,
    save_fold_meta,
    save_train_state,
)
from ..io.results import build_cv_payload, write_cv_results
from ..utils.device import resolve_device
from .adapters import (
    make_adapters,
    make_model_and_adapters,
    simmlm_stage1_adapter,
)
from .engine import (
    TrainConfig,
    Trainer,
    best_weights,
    load_train_state_dict,
    train_state_dict,
)
from .kfold import kfold_split
from .schedules import ReduceLROnPlateau, cosine_annealing

log = logging.getLogger(__name__)

# option -> the ROADMAP.md item that brings it
_NOT_PORTED = {
    "streaming": "streaming epochs are not ported yet: ROADMAP.md Queue 1 "
                 "item 11",
    "mesh": "meshes, tensor parallelism and the sharded risk set are not "
            "ported yet: ROADMAP.md Queue 1 item 10",
    "aot_cache_dir": "aot_cache_dir is not ported yet: ROADMAP.md Queue 1 "
                     "item 12",
    "profile_dir": "profile_dir needs utils/profiling.py, which is not "
                   "ported yet: ROADMAP.md Queue 1 item 11",
    "remat": "remat is not ported yet: ROADMAP.md Queue 1 item 16 "
             "(recomputation would update BatchNorm running stats twice and "
             "draw a second dropout mask)",
}


@dataclass
class FoldOutcome:
    fold: int
    best_c_index: float
    best_epoch: int
    train_size: int
    val_size: int
    train_survival_size: int | None = None
    epochs_run: int = 0
    history: list = field(default_factory=list)
    wall_s: float = 0.0  # the fold's wall time (not in the JAX outcome)


def prepare_cv_data(cfg: ModelRunConfig, table, rnaseq_csv=None,
                    use_pallas_resample: bool = False, hu_window=None,
                    resample: str | None = None, device="cuda"):
    """Cohort selection + array build + seed-``cfg.seed`` KFold splits.

    ``table`` is a sequence of matching-table row dicts. Returns ``(arrays,
    splits)``: ``splits`` is a list of ``(train_rows, val_rows,
    train_survival_size or None)`` with the partial-modality trick applied
    (the folds run over the labeled rows and ALL unlabeled rows are appended
    to every fold's train set). ``use_pallas_resample`` routes every CT
    through the CUDA W-pass kernel on ``device``."""
    name = cfg.name
    cohort = select_cohort(table, name)
    rnaseq = None
    if "rnaseq" in cfg.modalities and rnaseq_csv is not None:
        rnaseq = load_rnaseq_matrix(rnaseq_csv)
        if name == "rnaseq_only":
            # the reference intersects with the matrix index
            # (train_rnaseq_only.py:239), keeping the table's order
            cohort = [r for r in cohort if r["patient_id"] in rnaseq.index]

    arrays = build_cohort_arrays(
        cohort, rnaseq, with_image="image" in cfg.modalities,
        image_shape=cfg.image_shape, use_pallas=use_pallas_resample,
        hu_window=hu_window, resample=resample, device=device)

    svalid = arrays.arrays["svalid"] > 0
    labeled_rows = np.nonzero(svalid)[0]
    unlabeled_rows = np.nonzero(~svalid)[0]
    # Non-partial models select only labeled patients at the cohort level,
    # so their fold universe is every row
    fold_rows = (labeled_rows if cfg.include_unlabeled_in_train
                 else np.arange(arrays.n))

    splits = []
    for tr_idx, va_idx in kfold_split(len(fold_rows), cfg.n_folds, cfg.seed):
        train_rows = fold_rows[tr_idx]
        val_rows = fold_rows[va_idx]
        train_survival_size = None
        if cfg.include_unlabeled_in_train:
            train_survival_size = len(train_rows)
            train_rows = np.concatenate([train_rows, unlabeled_rows])
        splits.append((train_rows, val_rows, train_survival_size))
    return arrays, splits


def _compute_dtype(dtype) -> torch.dtype | None:
    """The models' compute dtype from ``run_cross_validation``'s ``dtype``:
    None (float32) or ``torch.bfloat16`` (the JAX driver's
    ``jnp.bfloat16``)."""
    if dtype is None or dtype is torch.bfloat16:
        return dtype
    raise ValueError(f"unsupported compute dtype {dtype!r}: None (float32) "
                     "or torch.bfloat16")


def _refuse_unported(*, streaming, mesh, tensor_parallel, sharded_risk_set,
                     aot_cache_dir, profile_dir, remat):
    given = {"streaming": streaming,
             "mesh": (mesh is not None or tensor_parallel
                      or sharded_risk_set),
             "aot_cache_dir": bool(aot_cache_dir),
             "profile_dir": bool(profile_dir), "remat": remat}
    for option, on in given.items():
        if on:
            raise NotImplementedError(_NOT_PORTED[option])


def run_cross_validation(
    cfg: ModelRunConfig,
    table,
    rnaseq_csv=None,
    results_dir="results",
    models_dir="models",
    mesh=None,
    tensor_parallel: bool = False,
    backbone: str = "densenet121",
    dtype=None,
    remat: bool = False,
    use_pallas_resample: bool = False,
    hu_window=None,
    num_epochs: int | None = None,
    write_outputs: bool = True,
    profile_dir: str | None = None,
    resume: bool = False,
    checkpoint_every: int = 10,
    prepared=None,
    streaming: bool = False,
    sharded_risk_set: bool = False,
    aot_cache_dir=None,
    init_hook=None,
    device="cuda",
):
    """Full CV run for one model config on ``device``. Returns ``(payload,
    fold_outcomes)``.

    ``prepared``: an ``(arrays, splits)`` from :func:`prepare_cv_data` with
    the same cfg, which skips the cohort's ingest.

    ``init_hook``: optional ``(fold, state) -> state | None`` applied right
    after each fold's ``init_state``; a returned TrainState replaces the
    fold's initial state (the tests start each fold from the JAX driver's
    initial weights through it)."""
    _refuse_unported(streaming=streaming, mesh=mesh,
                     tensor_parallel=tensor_parallel,
                     sharded_risk_set=sharded_risk_set,
                     aot_cache_dir=aot_cache_dir, profile_dir=profile_dir,
                     remat=remat)
    name = cfg.name
    num_epochs = num_epochs or cfg.num_epochs
    dev = resolve_device(device)
    dtype = _compute_dtype(dtype)

    arrays, splits = prepared if prepared is not None else prepare_cv_data(
        cfg, table, rnaseq_csv=rnaseq_csv,
        use_pallas_resample=use_pallas_resample, hu_window=hu_window,
        device=dev)
    rna_dim = arrays.arrays["rnaseq"].shape[1]

    batch_to_inputs, hazard_and_aux = make_adapters(cfg)
    tcfg = TrainConfig(
        batch_size=cfg.batch_size, learning_rate=cfg.learning_rate,
        weight_decay=cfg.weight_decay, optimizer=cfg.optimizer,
        grad_clip=cfg.grad_clip, seed=cfg.seed, ties=cfg.ties)
    data = arrays.to_device(dev)

    # ONE Trainer for all folds, as the JAX driver keeps one
    def model_fn(gen):
        return make_model_and_adapters(cfg, rna_dim=rna_dim,
                                       backbone=backbone, generator=gen,
                                       dtype=dtype)[0]

    trainer = Trainer(model_fn, batch_to_inputs, hazard_and_aux, tcfg,
                      device=dev)
    # SimMLM's stage 1: the same batches and optimizer, another loss
    stage1_trainer = (Trainer(model_fn, batch_to_inputs,
                              simmlm_stage1_adapter(), tcfg, device=dev)
                      if cfg.stage1_epochs else None)

    outcomes: list[FoldOutcome] = []
    t_start = time.monotonic()
    total_steps = 0
    for fold, (train_rows, val_rows, train_survival_size) in enumerate(
            splits, start=1):
        t_fold = time.monotonic()
        state = trainer.init_state(fold=fold)
        if init_hook is not None:
            state = init_hook(fold, state) or state

        shuffle_rng = np.random.default_rng(cfg.seed + fold)
        plateau = ReduceLROnPlateau(lr=cfg.learning_rate)
        lr = cfg.learning_rate
        best_c, best_epoch, best_params, bad = -math.inf, 0, None, 0
        history: list = []
        epochs_run = 0
        start_epoch = 1

        # ---- resume: the whole train state, a capability the reference
        #      lacks (it keeps only best weights) ----
        resume_dir = Path(models_dir) / name / f"fold_{fold}_resume"
        if resume and (resume_dir / "progress.json").exists():
            meta = json.loads((resume_dir / "progress.json").read_text())
            load_train_state_dict(state,
                                  load_train_state(resume_dir / "state.pt"))
            shuffle_rng.bit_generator.state = meta["shuffle_rng"]
            lr = plateau.lr = meta["lr"]
            plateau.best = meta["plateau_best"]
            plateau.num_bad = meta["plateau_num_bad"]
            best_c, best_epoch = meta["best_c"], meta["best_epoch"]
            bad, history = meta["bad"], meta["history"]
            epochs_run = meta["epoch"]
            start_epoch = meta["epoch"] + 1
            if (resume_dir / "best.pt").exists():
                best_params = load_checkpoint(resume_dir / "best.pt")
            log.info("[%s fold %d] resumed at epoch %d", name, fold,
                     start_epoch)

        # stage 1: no model selection, fixed LR; skipped on resume (it ran
        # before the first stage-2 checkpoint)
        if stage1_trainer is not None and start_epoch == 1:
            for epoch in range(1, cfg.stage1_epochs + 1):
                state, s1_loss = stage1_trainer.train_epoch(
                    state, data, train_rows, shuffle_rng, cfg.learning_rate)
                if epoch % 10 == 0 or epoch == 1:
                    log.info("[%s fold %d] stage1 epoch %d loss %.4f", name,
                             fold, epoch, s1_loss)
                total_steps += -(-len(train_rows) // cfg.batch_size)

        for epoch in range(start_epoch, num_epochs + 1):
            if cfg.scheduler == "cosine":
                lr = cosine_annealing(cfg.learning_rate, epoch - 1, num_epochs)
            state, tr_loss = trainer.train_epoch(state, data, train_rows,
                                                 shuffle_rng, lr)
            val_c, val_loss, _ = trainer.evaluate(state, data, val_rows)
            if cfg.scheduler == "plateau":
                lr = plateau.step(val_c)
            history.append(dict(epoch=epoch, train_loss=tr_loss,
                                val_loss=val_loss, val_c_index=val_c, lr=lr))
            epochs_run = epoch
            total_steps += -(-len(train_rows) // cfg.batch_size)

            if val_c > best_c:
                best_c, best_epoch = val_c, epoch
                best_params = best_weights(state)
                bad = 0
            else:
                bad += 1
            if cfg.patience is not None and bad >= cfg.patience:
                log.info("[%s fold %d] early stop at epoch %d", name, fold,
                         epoch)
                break
            if epoch % 10 == 0 or epoch == 1:
                log.info("[%s fold %d] epoch %d loss %.4f val C %.4f",
                         name, fold, epoch, tr_loss, val_c)
            if resume and checkpoint_every and epoch % checkpoint_every == 0:
                save_train_state(resume_dir / "state.pt",
                                 train_state_dict(state))
                if best_params is not None:
                    save_checkpoint(resume_dir / "best.pt", best_params)
                (resume_dir / "progress.json").write_text(json.dumps({
                    "epoch": epoch, "lr": lr, "plateau_best": plateau.best,
                    "plateau_num_bad": plateau.num_bad, "best_c": best_c,
                    "best_epoch": best_epoch, "bad": bad,
                    "shuffle_rng": shuffle_rng.bit_generator.state,
                    "history": history}))

        if write_outputs and best_params is not None:
            ckpt_path = Path(models_dir) / name / f"fold_{fold}_best.pt"
            save_checkpoint(ckpt_path, best_params)
            save_fold_meta(
                ckpt_path, model=name, fold=fold, backbone=backbone,
                image_shape=list(cfg.image_shape), rna_dim=rna_dim,
                hu_window=(list(hu_window) if hu_window else None),
                use_pallas_resample=use_pallas_resample, ties=cfg.ties,
                resample_mode=arrays.ingest_mode,
                best_epoch=best_epoch, best_c_index=float(best_c))

        outcome = FoldOutcome(
            fold=fold, best_c_index=float(best_c), best_epoch=best_epoch,
            train_size=len(train_rows), val_size=len(val_rows),
            train_survival_size=train_survival_size, epochs_run=epochs_run,
            history=history, wall_s=time.monotonic() - t_fold)
        outcomes.append(outcome)
        log.info("[%s fold %d] best C-index %.4f @ epoch %d (%.1f s)", name,
                 fold, best_c, best_epoch, outcome.wall_s)

    elapsed = time.monotonic() - t_start
    payload = build_and_write_cv_payload(
        cfg, outcomes, num_epochs, int(arrays.n), results_dir,
        write_outputs=write_outputs)
    log.info("[%s] CV done: %.1fs, %d steps, %.2f steps/s", name, elapsed,
             total_steps, total_steps / max(elapsed, 1e-9))
    return payload, outcomes


def build_and_write_cv_payload(cfg, outcomes, num_epochs, dataset_size,
                               results_dir, write_outputs=True):
    """fold_results + the reference-schema hyperparameters ->
    ``write_cv_results`` (or the same payload unwritten)."""
    fold_results = []
    for o in outcomes:
        fr = {"fold": o.fold, "best_c_index": o.best_c_index,
              "best_epoch": o.best_epoch, "train_size": o.train_size,
              "val_size": o.val_size}
        if o.train_survival_size is not None:
            fr["train_survival_size"] = o.train_survival_size
        fold_results.append(fr)

    hyper = {"batch_size": cfg.batch_size, "learning_rate": cfg.learning_rate}
    if cfg.stage1_epochs:
        # SimMLM variant keys (reference results/simmim/cv_results.json)
        hyper["stage1_epochs"] = cfg.stage1_epochs
        hyper["stage2_epochs"] = num_epochs
    else:
        hyper["epochs"] = num_epochs
    hyper["n_folds"] = cfg.n_folds
    if cfg.gate_entropy_weight:
        hyper["gate_entropy_weight"] = cfg.gate_entropy_weight
    if cfg.mofe_lambda:
        hyper["mofe_lambda"] = cfg.mofe_lambda

    extra = {"n_folds": cfg.n_folds, "num_epochs": num_epochs,
             "dataset_size": dataset_size}
    legacy = cfg.name == "image_only"
    if not write_outputs:
        return build_cv_payload(cfg.display_name, fold_results,
                                hyperparameters=hyper, extra=extra,
                                legacy=legacy)
    return write_cv_results(Path(results_dir) / cfg.name, cfg.display_name,
                            fold_results, hyperparameters=hyper, extra=extra,
                            legacy=legacy)
