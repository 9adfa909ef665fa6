"""Loss terms of the survival models (port of
``multimodal_survival_prediction_tpu/ops/cox.py``).

Only ``gate_entropy_loss`` is ported so far — the ``partial_modality``
adapter needs it. ``cox_partial_likelihood`` comes with the training slice
(ROADMAP.md Queue 1 item 3).
"""

from __future__ import annotations

import torch


def gate_entropy_loss(gate_weights: torch.Tensor,
                      valid: torch.Tensor | None = None,
                      eps: float = 1e-8) -> torch.Tensor:
    """Negative mean gate entropy (minimizing this maximizes entropy).

    Applied to ALL samples including unlabeled ones, hence the separate
    ``valid`` mask defaulting to everything (reference
    partial_modality_training.py:322-331, :401-422)."""
    g = gate_weights.to(torch.float32)
    entropy = -(g * torch.log(g + eps)).sum(dim=-1)  # (B,)
    if valid is None:
        return -entropy.mean()
    valid = valid.to(torch.float32)
    return -(entropy * valid).sum() / valid.sum().clamp_min(1.0)
