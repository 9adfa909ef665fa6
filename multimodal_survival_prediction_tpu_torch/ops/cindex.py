"""Harrell's concordance index as dense (n, n) torch (port of
``multimodal_survival_prediction_tpu/ops/cindex.py``).

Harrell's definition with the standard 0.5 credit for tied predictions
(torchsurv/lifelines behaviour), plus a ``naive`` variant equal to the
reference's double loop (reference train_rnaseq_only.py:55-70). Cohorts are
at most a few hundred patients, so the (n, n) outer products are small.
"""

from __future__ import annotations

import numpy as np
import torch


def concordance_index(hazard, time, event, valid=None,
                      variant: str = "harrell") -> torch.Tensor:
    """Concordance index of risk scores vs survival outcomes, a 0-dim
    float32 tensor on ``hazard``'s device.

    Higher hazard should predict shorter survival. 0.5 if there are no
    comparable pairs (reference partial_modality_training.py:336-340).

    Args:
      hazard: (n,) risk scores (higher = riskier).
      time:   (n,) times.
      event:  (n,) event indicators (1=event, 0=censored).
      valid:  optional (n,) validity mask for padded batches.
      variant: 'harrell' (ties in prediction get 0.5; tied-time
               event/censored pairs comparable) or 'naive' (the reference
               double loop: pairs are (i event, time_j > time_i) only, and
               tied predictions get 0 credit).
    """
    hazard = torch.as_tensor(hazard, dtype=torch.float32)
    dev = hazard.device
    time = torch.as_tensor(time, dtype=torch.float32, device=dev)
    event = torch.as_tensor(event, dtype=torch.float32, device=dev)
    if valid is None:
        valid = torch.ones_like(event)
    else:
        valid = torch.as_tensor(valid, dtype=torch.float32, device=dev)

    t_i = time[:, None]
    t_j = time[None, :]
    e_i = event[:, None]
    h_i = hazard[:, None]
    h_j = hazard[None, :]
    vv = valid[:, None] * valid[None, :]

    if variant == "naive":
        comparable = (e_i > 0) & (t_j > t_i)
    else:
        # Harrell: i experienced the event first —
        # t_i < t_j and event_i, or t_i == t_j, event_i and not event_j
        e_j = event[None, :]
        comparable = ((t_i < t_j) & (e_i > 0)) | (
            (t_i == t_j) & (e_i > 0) & (e_j == 0))

    comparable = comparable.to(torch.float32) * vv
    if variant == "naive":
        # strict inequality only — the reference counts tied predictions as 0
        concordant = torch.where(h_i > h_j, 1.0, 0.0)
    else:
        concordant = torch.where(
            h_i > h_j, 1.0, torch.where(h_i == h_j, 0.5, 0.0))

    num = (comparable * concordant).sum()
    den = comparable.sum()
    return torch.where(den > 0, num / den.clamp_min(1.0), 0.5)


def concordance_index_np(hazard, time, event,
                         variant: str = "harrell") -> float:
    """Host/numpy convenience wrapper (analysis layer)."""
    return float(concordance_index(
        torch.from_numpy(np.asarray(hazard, np.float32)),
        np.asarray(time, np.float32), np.asarray(event, np.float32),
        variant=variant))
