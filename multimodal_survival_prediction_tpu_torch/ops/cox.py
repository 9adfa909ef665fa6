"""Loss terms of the survival models (port of
``multimodal_survival_prediction_tpu/ops/cox.py``).

Cox partial likelihood with the reference's stable form (reference
final_multimodal.py:171-186 / partial_modality_training.py:296-311):

    order       = argsort(time, descending)
    log_cumsum  = logcumsumexp(hazard[order])
    loss        = -sum((hazard - log_cumsum) * event) / (sum(event) + 1e-8)

with the degenerate-batch guards (fewer than 2 samples or no event -> loss
exactly 0) as masked math, a ``valid`` mask for padding and unlabeled rows,
and an Efron tie correction (``ties='efron'``); ``'breslow'`` (default)
matches the reference and equals Efron when event times are distinct.
"""

from __future__ import annotations

import torch

_NEG = -1.0e30  # effectively -inf for logcumsumexp without producing NaNs


def _sort_desc_by_time(time, *arrays):
    """Stable sort by time descending; returns sorted copies of *arrays."""
    order = torch.argsort(-time, stable=True)
    return tuple(a[order] for a in arrays)


def cox_partial_likelihood(
    hazard: torch.Tensor,
    time: torch.Tensor,
    event: torch.Tensor,
    valid: torch.Tensor | None = None,
    ties: str = "breslow",
    eps: float = 1e-8,
) -> torch.Tensor:
    """Negative Cox partial log-likelihood (mean over events).

    Args:
      hazard: (B,) predicted log-hazards.
      time:   (B,) survival/censoring times.
      event:  (B,) 1.0 if event observed, 0.0 if censored.
      valid:  optional (B,) 1.0 for real samples, 0.0 for padding / samples
              without survival labels. Invalid samples contribute neither to
              risk sets nor to the likelihood.
      ties:   'breslow' (reference-exact) or 'efron'.

    Returns a scalar tensor; exactly 0.0 when <2 valid samples or 0 valid
    events."""
    hazard = hazard.to(torch.float32)
    time = time.to(torch.float32)
    event = event.to(torch.float32)
    if valid is None:
        valid = torch.ones_like(event)
    else:
        valid = valid.to(torch.float32)

    event = event * valid
    # Invalid entries: pushed to the end of the descending-time order and
    # kept out of risk sets by an -inf-ish hazard.
    time_k = torch.where(valid > 0, time, -torch.inf)
    h_masked = torch.where(valid > 0, hazard, _NEG)

    h_s, e_s, t_s, v_s = _sort_desc_by_time(time_k, h_masked, event, time_k,
                                            valid)
    log_cumsum = torch.logcumsumexp(h_s, dim=0)

    if ties == "efron":
        # Within a tied event-time group with d events, the k-th event
        # (k=0..d-1) sees the risk-set sum adjusted by log(1 - k/d * frac),
        # frac = sum_exp(tied events) / sum_exp(risk set); dense (B, B).
        same_as_prev = torch.cat([
            torch.zeros(1, dtype=torch.int64, device=h_s.device),
            (t_s[1:] == t_s[:-1]).to(torch.int64)])
        group_id = torch.cumsum(1 - same_as_prev, 0) - 1
        n = h_s.shape[0]
        onehot = (group_id[:, None] == torch.arange(
            n, device=h_s.device)[None, :]).to(torch.float32)
        h_max = h_s.max().detach()
        ev_exp = torch.exp(h_s - h_max) * e_s
        tie_sum = onehot.T @ ev_exp  # (G,)
        d_g = onehot.T @ e_s  # events per group
        cums_in_group = torch.cumsum(onehot * e_s[:, None], dim=0)
        k_i = (cums_in_group * onehot).sum(-1) - e_s  # 0-based event rank
        # the risk set of a group is log_cumsum at its last (descending)
        # position
        is_last_in_group = torch.cat([
            (group_id[:-1] != group_id[1:]).to(torch.float32),
            torch.ones(1, dtype=torch.float32, device=h_s.device)])
        last_lcse = onehot.T @ (log_cumsum * is_last_in_group)  # (G,)
        risk_exp_g = torch.exp(last_lcse - h_max)
        frac_g = torch.where(risk_exp_g > 0,
                             tie_sum / risk_exp_g.clamp_min(1e-38), 0.0)
        d_safe = d_g.clamp_min(1.0)
        adj = torch.log(torch.clamp(
            1.0 - (k_i / d_safe[group_id]) * frac_g[group_id], 1e-12, 1.0))
        uncensored = h_s - (last_lcse[group_id] + adj)
    else:
        uncensored = h_s - log_cumsum

    uncensored = torch.where(e_s > 0, uncensored, 0.0)  # avoid NaN * 0
    n_events = e_s.sum()
    loss = -(uncensored * e_s).sum() / (n_events + eps)

    # Degenerate-batch guards (reference final_multimodal.py:173-176):
    # <2 valid samples or 0 events -> 0.
    ok = (v_s.sum() >= 2) & (n_events > 0)
    return torch.where(ok, loss, 0.0)


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
