"""Kaplan-Meier estimator and log-rank test (the port's copy of
``multimodal_survival_prediction_tpu/ops/km.py``, numpy + scipy).

The reference's analysis layer uses lifelines' KaplanMeierFitter and
logrank_test (reference evaluate_model.py:13-14, generate_km_curves.py:14-15);
these are the same product-limit curve with a Greenwood log-log band
(``scipy.stats.norm.ppf``) and the Mantel-Haenszel test (``chi2.sf``),
held against the JAX package's in tests/test_torch_analysis.py.
"""

from __future__ import annotations

from dataclasses import dataclass

import numpy as np


@dataclass
class KaplanMeier:
    """Product-limit survival curve.

    Attributes:
      timeline: event/censor times in ascending order (unique), prepended 0.
      survival: S(t) evaluated at each timeline point (right-continuous step).
      at_risk / observed: risk-set size and event count at each unique time.
    """

    timeline: np.ndarray
    survival: np.ndarray
    at_risk: np.ndarray
    observed: np.ndarray
    ci_lower: np.ndarray
    ci_upper: np.ndarray

    def survival_at(self, t: float) -> float:
        idx = np.searchsorted(self.timeline, t, side="right") - 1
        return float(self.survival[max(idx, 0)])

    @property
    def median_survival_time(self) -> float:
        below = np.nonzero(self.survival <= 0.5)[0]
        if below.size == 0:
            return float("inf")
        return float(self.timeline[below[0]])


def kaplan_meier(time, event, alpha: float = 0.05) -> KaplanMeier:
    """Fit a KM curve with Greenwood log-log confidence intervals."""
    time = np.asarray(time, dtype=np.float64)
    event = np.asarray(event, dtype=np.float64)
    order = np.argsort(time, kind="stable")
    time, event = time[order], event[order]
    n = time.size

    uniq, first_idx = np.unique(time, return_index=True)
    # events and removals at each unique time
    d = np.array([event[time == t].sum() for t in uniq])
    removed = np.array([(time == t).sum() for t in uniq])
    at_risk = n - np.concatenate([[0], np.cumsum(removed)[:-1]])

    with np.errstate(divide="ignore", invalid="ignore"):
        frac = 1.0 - d / at_risk
    surv = np.cumprod(np.where(at_risk > 0, frac, 1.0))

    # Greenwood variance -> exp(-exp) CI
    with np.errstate(divide="ignore", invalid="ignore"):
        gw_terms = np.where(
            (at_risk - d) > 0, d / (at_risk * (at_risk - d)), 0.0
        )
        gw = np.cumsum(gw_terms)
        log_s = np.log(np.clip(surv, 1e-300, 1.0))
        se = np.sqrt(gw) / np.abs(np.where(log_s == 0, -1e-300, log_s))
    from scipy.stats import norm

    z = norm.ppf(1 - alpha / 2)
    with np.errstate(divide="ignore", invalid="ignore"):
        lower = surv ** np.exp(z * se)
        upper = surv ** np.exp(-z * se)
    lower = np.where(surv >= 1.0, 1.0, np.nan_to_num(lower, nan=1.0))
    upper = np.where(surv >= 1.0, 1.0, np.nan_to_num(upper, nan=1.0))

    timeline = np.concatenate([[0.0], uniq])
    return KaplanMeier(
        timeline=timeline,
        survival=np.concatenate([[1.0], surv]),
        at_risk=np.concatenate([[n], at_risk]).astype(np.int64),
        observed=np.concatenate([[0], d]).astype(np.int64),
        ci_lower=np.concatenate([[1.0], lower]),
        ci_upper=np.concatenate([[1.0], upper]),
    )


def median_survival_time(time, event) -> float:
    return kaplan_meier(time, event).median_survival_time


@dataclass
class LogRankResult:
    test_statistic: float
    p_value: float


def logrank_test(time_a, event_a, time_b, event_b) -> LogRankResult:
    """Two-sample Mantel-Haenszel log-rank test (chi-square, 1 dof)."""
    time_a = np.asarray(time_a, dtype=np.float64)
    time_b = np.asarray(time_b, dtype=np.float64)
    event_a = np.asarray(event_a, dtype=np.float64)
    event_b = np.asarray(event_b, dtype=np.float64)

    all_times = np.unique(
        np.concatenate([time_a[event_a > 0], time_b[event_b > 0]])
    )
    obs_a = 0.0
    exp_a = 0.0
    var_a = 0.0
    for t in all_times:
        n_a = np.sum(time_a >= t)
        n_b = np.sum(time_b >= t)
        n_tot = n_a + n_b
        d_a = np.sum((time_a == t) & (event_a > 0))
        d_b = np.sum((time_b == t) & (event_b > 0))
        d = d_a + d_b
        if n_tot == 0 or d == 0:
            continue
        obs_a += d_a
        exp_a += d * n_a / n_tot
        if n_tot > 1:
            var_a += d * (n_a / n_tot) * (n_b / n_tot) * (n_tot - d) / (n_tot - 1)

    if var_a <= 0:
        return LogRankResult(test_statistic=0.0, p_value=1.0)
    stat = (obs_a - exp_a) ** 2 / var_a
    from scipy.stats import chi2

    p = float(chi2.sf(stat, df=1))
    return LogRankResult(test_statistic=float(stat), p_value=p)
