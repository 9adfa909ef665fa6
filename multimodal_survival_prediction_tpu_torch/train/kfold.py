"""Splits in numpy, equal to scikit-learn's in values and order (the JAX
package calls sklearn, which the card's machine lacks): K-fold CV
(``KFold(n_splits, shuffle=True, random_state=seed)``, the CV driver's) and
the stratified train/test split of ``train_test_split(..., stratify=y)``
(``StratifiedShuffleSplit``, the complete-cohort dataset's)."""

from __future__ import annotations

import math

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


def approximate_mode(class_counts: np.ndarray, n_draws: int,
                     rng: np.random.RandomState) -> np.ndarray:
    """sklearn's ``_approximate_mode``: ``n_draws`` spread over the
    classes in proportion to ``class_counts``, floored, then one more to
    the largest remainders, ties broken by ``rng.choice``."""
    continuous = class_counts / class_counts.sum() * n_draws
    floored = np.floor(continuous)
    need_to_add = int(n_draws - floored.sum())
    if need_to_add > 0:
        remainder = continuous - floored
        for value in np.sort(np.unique(remainder))[::-1]:
            (inds,) = np.where(remainder == value)
            add_now = min(len(inds), need_to_add)
            floored[rng.choice(inds, size=add_now, replace=False)] += 1
            need_to_add -= add_now
            if need_to_add == 0:
                break
    return floored.astype(int)


def stratified_split(y, test_size: float, seed: int):
    """``(train_idx, test_idx)`` of ``train_test_split(range(len(y)),
    test_size=test_size, random_state=seed, stratify=y)``: ``ceil(test_size
    * n)`` test rows, each class's share of both sides by
    :func:`approximate_mode`, each class's rows permuted and cut, then
    each side permuted, all draws from one ``RandomState(seed)`` in
    sklearn's order. sklearn's ``ValueError``\\s where a class has one
    member or a side has fewer rows than there are classes."""
    y = np.asarray(y)
    n = len(y)
    n_test = math.ceil(test_size * n)
    n_train = n - n_test
    if not 0 < test_size < 1 or n_train == 0:
        raise ValueError(f"test_size={test_size} leaves no train rows of {n}")
    classes, y_indices, class_counts = np.unique(
        y, return_inverse=True, return_counts=True)
    if class_counts.min() < 2:
        raise ValueError(
            "The least populated classes in y have only 1 member, which is "
            "too few. The minimum number of groups for any class cannot be "
            f"less than 2. Classes with too few members are: "
            f"{classes[class_counts < 2].tolist()}")
    for side, size in (("train", n_train), ("test", n_test)):
        if size < len(classes):
            raise ValueError(f"The {side}_size = {size} should be greater or "
                             f"equal to the number of classes = "
                             f"{len(classes)}")
    class_indices = np.split(np.argsort(y_indices, kind="stable"),
                             np.cumsum(class_counts)[:-1])
    rng = np.random.RandomState(seed)
    n_i = approximate_mode(class_counts, n_train, rng)
    t_i = approximate_mode(class_counts - n_i, n_test, rng)
    train, test = [], []
    for i in range(len(classes)):
        rows = class_indices[i][rng.permutation(class_counts[i])]
        train.extend(rows[:n_i[i]])
        test.extend(rows[n_i[i]:n_i[i] + t_i[i]])
    return rng.permutation(train), rng.permutation(test)
