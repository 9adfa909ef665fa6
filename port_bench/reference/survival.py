"""Plain reference of the losses, the optimizer and the C-index.

* Cox partial likelihood, Breslow form, as the published training scripts
  compute it (``partial_modality_training.py:296-311``): for every event
  ``i`` among the valid rows, ``h_i - log sum_{t_j >= t_i} exp(h_j)``; the
  negative mean over events; exactly 0 with fewer than two valid rows or
  no event. Written as a dense (B, B) risk-set mask, not as a sorted scan.
* Gate entropy (``:322-331``): minus the mean entropy of the gate weights
  over the valid rows, ``eps`` 1e-8 inside the log.
* optax ``chain(clip_by_global_norm(c), [add_decayed_weights(wd)],
  scale_by_adam(0.9, 0.999, 1e-8), [add_decayed_weights(wd)], scale(-lr))``:
  decay before Adam for ``adam`` (torch Adam's L2), after it for ``adamw``.
* Harrell's C-index with 0.5 for tied predictions, in float64 on the host.
"""

from __future__ import annotations

import numpy as np
import torch

B1, B2, ADAM_EPS = 0.9, 0.999, 1e-8


def cox_loss(hazard, time, event, valid):
    h = hazard.float()
    v = valid.float() > 0
    e = (event.float() > 0) & v
    at_risk = (time[None, :] >= time[:, None]) & v[None, :]  # row i: R(t_i)
    neg = torch.full_like(h, -torch.inf)
    log_risk = torch.logsumexp(
        torch.where(at_risk, h[None, :].expand_as(at_risk), neg[None, :]),
        dim=1)
    terms = torch.where(e, h - log_risk, torch.zeros_like(h))
    n_ev = e.float().sum()
    loss = -terms.sum() / (n_ev + 1e-8)
    ok = (v.float().sum() >= 2) & (n_ev > 0)
    return torch.where(ok, loss, torch.zeros_like(loss))


def gate_entropy(gates, valid):
    g = gates.float()
    ent = -(g * torch.log(g + 1e-8)).sum(dim=-1)
    v = valid.float()
    return -(ent * v).sum() / v.sum().clamp_min(1.0)


def adam_step(params: dict, grads: dict, state: dict, opt: dict, lr: float):
    """One step of the optimizer over ``params`` (updated in place under
    ``no_grad``); ``state`` holds ``mu``, ``nu`` and ``count``. Returns the
    gradient as the optimizer's moments take it (after the clip and, for
    ``adam``, the L2 term)."""
    keys = list(params)
    with torch.no_grad():
        g = [grads[k] for k in keys]
        if opt.get("grad_clip") is not None:
            norm = torch.sqrt(sum((t.double() ** 2).sum() for t in g))
            if float(norm) >= opt["grad_clip"]:
                g = [t * (opt["grad_clip"] / norm.float()) for t in g]
        wd = opt["weight_decay"]
        if opt["kind"] == "adam" and wd:
            g = [t + wd * params[k] for t, k in zip(g, keys)]
        state["count"] += 1
        n = state["count"]
        bc1, bc2 = 1 - B1 ** n, 1 - B2 ** n
        for t, k in zip(g, keys):
            mu = state["mu"].setdefault(k, torch.zeros_like(t))
            nu = state["nu"].setdefault(k, torch.zeros_like(t))
            mu.mul_(B1).add_(t, alpha=1 - B1)
            nu.mul_(B2).addcmul_(t, t, value=1 - B2)
            upd = (mu / bc1) / (torch.sqrt(nu / bc2) + ADAM_EPS)
            if opt["kind"] == "adamw" and wd:
                upd = upd + wd * params[k]
            params[k].sub_(lr * upd)
    return dict(zip(keys, g))


def concordance(hazard, time, event, valid=None) -> float:
    """Harrell's C-index: pairs where ``i`` had the event first (earlier
    time, or the same time with ``i`` an event and ``j`` censored);
    concordant when ``h_i > h_j``, 0.5 for ``h_i == h_j``; 0.5 without
    comparable pairs."""
    h = np.asarray(hazard, np.float64)
    t = np.asarray(time, np.float64)
    e = np.asarray(event, np.float64) > 0
    v = np.ones_like(h, bool) if valid is None else np.asarray(valid) > 0
    h, t, e = h[v], t[v], e[v]
    comp = (((t[:, None] < t[None, :]) & e[:, None])
            | ((t[:, None] == t[None, :]) & e[:, None] & ~e[None, :]))
    conc = np.where(h[:, None] > h[None, :], 1.0,
                    np.where(h[:, None] == h[None, :], 0.5, 0.0))
    den = comp.sum()
    return float((comp * conc).sum() / den) if den else 0.5
