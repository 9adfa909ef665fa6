"""LR schedules matching the reference's two mechanisms — the port's own
copy of ``multimodal_survival_prediction_tpu/train/schedules.py``.

Both are *epoch-granular* in the reference (scheduler.step() once per epoch),
so they live on the host between epochs and feed the learning rate to the
trainer as a scalar.
"""

from __future__ import annotations

import math
from dataclasses import dataclass, field


@dataclass
class ReduceLROnPlateau:
    """torch.optim.lr_scheduler.ReduceLROnPlateau(mode='max', factor=0.5,
    patience=5) stepped on val C-index (reference final_multimodal.py:351,361).

    torch semantics: a step counts as "bad" if metric <= best (for mode=max,
    threshold 1e-4 relative by default => bad if metric < best*(1+1e-4));
    after `patience` consecutive bad epochs the LR is multiplied by factor.
    """

    lr: float
    factor: float = 0.5
    patience: int = 5
    threshold: float = 1e-4
    min_lr: float = 0.0
    best: float = field(default=-math.inf, init=False)
    num_bad: int = field(default=0, init=False)

    def step(self, metric: float) -> float:
        if self.best == -math.inf or metric > self.best * (1.0 + self.threshold):
            self.best = metric
            self.num_bad = 0
        else:
            self.num_bad += 1
        if self.num_bad > self.patience:
            self.lr = max(self.lr * self.factor, self.min_lr)
            self.num_bad = 0
        return self.lr


def cosine_annealing(base_lr: float, epoch: int, t_max: int,
                     eta_min: float = 0.0) -> float:
    """torch CosineAnnealingLR value at `epoch` (reference
    train_rnaseq_only.py:272, stepped per epoch)."""
    return eta_min + (base_lr - eta_min) * (
        1 + math.cos(math.pi * epoch / t_max)
    ) / 2
