"""A run with the timed path broken underneath comes out not correct, once
for each fault a cell can have, and the sound run comes out correct. The
harness's look for a card is skipped: these runs are on the CPU at a tiny
size, with the cells' own comparison."""

import time

import pytest
import torch

import pbench_tiny
from port_bench.core import registry

TRAIN_LIMITS = {"loss1_gap": 1e-4, "loss2_gap": 1e-4, "loss3_gap": 1e-4,
                "grad_gap": 1e-2, "change_gap": 0.1, "stats_gap": 0.1,
                "count_gap": 0.0, "hazard_gap": 1e-3}


def _train(plant=None, config="partial_modality-dn121-f32"):
    cell = pbench_tiny.TinyCell("pm_train_b8", config, "epochs_b8",
                                limits=TRAIN_LIMITS)
    return registry.load_driver("train_epochs").run(
        cell, seed=2 ** 35 + 11, seconds=0.1, trace=False,
        t_start=time.perf_counter(), device="cpu", plant=plant)


def _unchanged(trainer):
    """Every step returns its state unchanged (the loss is computed)."""
    trainer.train_step = lambda state, batch, lr: trainer.loss_and_grads(
        state, batch)[0]


def _half_batch(trainer):
    """Half of every batch left out, the mean taken over the rest."""
    gather = trainer._gather_batch

    def half(data, idx, bvalid):
        n = len(idx) // 2
        return gather(data, idx[:n], bvalid[:n])

    trainer._gather_batch = half


def _padding_in_loss(trainer):
    """A ragged batch's padded rows counted in the loss (its mask lost)."""
    gather = trainer._gather_batch

    def unmasked(data, idx, bvalid):
        return gather(data, idx, torch.ones_like(bvalid))

    trainer._gather_batch = unmasked


@pytest.mark.parametrize("config", ["partial_modality-dn121-f32",
                                    "simple_fusion-dn121-f32"])
def test_sound_training_run_is_correct(config):
    r = _train(config=config)
    assert r.correct, r.checks
    assert r.metrics["train_patients_per_s"][0] > 0


@pytest.mark.parametrize("fault", [_unchanged, _half_batch,
                                   _padding_in_loss])
def test_training_fault_is_not_correct(fault):
    r = _train(fault)
    assert not r.correct, r.checks

