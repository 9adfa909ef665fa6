"""K-fold splits in numpy, equal to scikit-learn's
``KFold(n_splits, shuffle=True, random_state=seed).split(range(n))`` in
values and order (the JAX CV driver calls sklearn, which the card's machine
lacks)."""

from __future__ import annotations

import numpy as np


def kfold_split(n: int, n_splits: int, seed: int):
    """``[(train_idx, val_idx), ...]`` over ``range(n)``, one pair a fold.

    The indices are shuffled by ``np.random.RandomState(seed)``; fold j's
    validation rows are the j-th slice of them, the first ``n % n_splits``
    slices one row longer than ``n // n_splits``; the train rows are the
    rest. Both come back sorted ascending, as sklearn builds them from a
    mask."""
    if not 2 <= n_splits <= n:
        raise ValueError(f"need 2 <= n_splits <= n samples, got n_splits="
                         f"{n_splits} for {n} samples")
    idx = np.arange(n)
    np.random.RandomState(seed).shuffle(idx)
    sizes = np.full(n_splits, n // n_splits, dtype=int)
    sizes[: n % n_splits] += 1
    splits, start = [], 0
    for size in sizes:
        val = np.zeros(n, bool)
        val[idx[start:start + size]] = True
        splits.append((np.nonzero(~val)[0], np.nonzero(val)[0]))
        start += size
    return splits
