"""The scorers' host protocol in numpy: scikit-learn's stratified split and
the four metrics the TimeGAN eval reports.

The JAX package takes these from scikit-learn (``eegsynth/eval/
classifiers.py``), which the port does not depend on. Each function here
gives scikit-learn's result for the arguments the eval passes:
:func:`train_test_split` the same index sets in the same order (it makes
scikit-learn's draws from one ``np.random.RandomState``, in its order), the
metrics the same values, computed in the inputs' dtype as scikit-learn does.
"""

from __future__ import annotations

import math

import numpy as np


def _approximate_mode(class_counts: np.ndarray, n_draws: int,
                      rng: np.random.RandomState) -> np.ndarray:
    """scikit-learn's ``utils.extmath._approximate_mode``: the floor of each
    class's share of ``n_draws``, then one more for the classes with the
    largest remainders, ties broken by ``rng.choice``."""
    continuous = class_counts / class_counts.sum() * n_draws
    floored = np.floor(continuous)
    need_to_add = int(n_draws - floored.sum())
    if need_to_add > 0:
        remainder = continuous - floored
        for value in np.sort(np.unique(remainder))[::-1]:
            (inds,) = np.where(remainder == value)
            add_now = min(len(inds), need_to_add)
            inds = rng.choice(inds, size=add_now, replace=False)
            floored[inds] += 1
            need_to_add -= add_now
            if need_to_add == 0:
                break
    return floored.astype(int)


def stratified_split_indices(y: np.ndarray, test_size: float,
                             random_state: int) -> tuple[np.ndarray, np.ndarray]:
    """(train, test) row indices of ``train_test_split(..., test_size=
    test_size, stratify=y, random_state=random_state)``: scikit-learn's
    ``StratifiedShuffleSplit._iter_indices``, first split."""
    y = np.asarray(y)
    n = len(y)
    n_test = math.ceil(test_size * n)
    n_train = n - n_test
    _, y_indices, class_counts = np.unique(y, return_inverse=True,
                                           return_counts=True)
    n_classes = len(class_counts)
    if class_counts.min() < 2:
        raise ValueError("the least populated class in y has only 1 member")
    if n_train < n_classes or n_test < n_classes:
        raise ValueError(f"train {n_train} and test {n_test} rows must each "
                         f"cover the {n_classes} classes")
    class_indices = np.split(np.argsort(y_indices, kind="stable"),
                             np.cumsum(class_counts)[:-1])
    rng = np.random.RandomState(random_state)
    n_i = _approximate_mode(class_counts, n_train, rng)
    t_i = _approximate_mode(class_counts - n_i, n_test, rng)
    train, test = [], []
    for i in range(n_classes):
        perm = class_indices[i].take(rng.permutation(class_counts[i]), mode="clip")
        train.extend(perm[:n_i[i]])
        test.extend(perm[n_i[i]:n_i[i] + t_i[i]])
    return rng.permutation(train), rng.permutation(test)


def train_test_split(X: np.ndarray, y: np.ndarray, test_size: float = 0.3,
                     random_state: int = 0):
    """``sklearn.model_selection.train_test_split(X, y, test_size=test_size,
    stratify=y, random_state=random_state)``: (Xtr, Xte, ytr, yte)."""
    train, test = stratified_split_indices(y, test_size, random_state)
    return X[train], X[test], y[train], y[test]


def accuracy_score(y_true, y_pred) -> float:
    """Share of exact matches."""
    return float(np.mean(np.asarray(y_true) == np.asarray(y_pred)))


def roc_auc_score(y_true, y_score) -> float:
    """Area under the ROC curve of binary labels, ties included: the
    trapezoid over the curve's points at each distinct score, as
    scikit-learn's ``roc_curve`` + ``auc``. ``nan`` where scikit-learn raises
    (not exactly two classes in ``y_true``)."""
    y_true = np.asarray(y_true).ravel()
    y_score = np.asarray(y_score).ravel()
    classes = np.unique(y_true)
    if len(classes) != 2:
        return float("nan")
    pos = (y_true == classes[1]).astype(np.float64)
    order = np.argsort(y_score, kind="mergesort")[::-1]
    y_score, pos = y_score[order], pos[order]
    thresholds = np.r_[np.where(np.diff(y_score))[0], len(pos) - 1]
    tps = np.cumsum(pos)[thresholds]
    fps = 1 + thresholds - tps
    tpr = np.r_[0.0, tps] / tps[-1]
    fpr = np.r_[0.0, fps] / fps[-1]
    return float(np.trapezoid(tpr, fpr))


def mean_squared_error(y_true, y_pred) -> float:
    """Mean over rows, then over outputs, in the inputs' dtype."""
    return float(np.mean(np.mean((y_true - y_pred) ** 2, axis=0)))


def r2_score(y_true, y_pred) -> float:
    """R² per output, uniformly averaged (``multioutput="uniform_average"``),
    with scikit-learn's ``force_finite``: an output whose target is constant
    scores 1.0 if predicted exactly, else 0.0."""
    y_true = np.asarray(y_true)
    y_pred = np.asarray(y_pred)
    if y_true.ndim == 1:
        y_true, y_pred = y_true[:, None], y_pred[:, None]
    numerator = np.sum((y_true - y_pred) ** 2, axis=0)
    denominator = np.sum((y_true - np.mean(y_true, axis=0)) ** 2, axis=0)
    scores = np.ones(y_true.shape[1], dtype=numerator.dtype)
    valid = (denominator != 0) & (numerator != 0)
    scores[valid] = 1 - numerator[valid] / denominator[valid]
    scores[(numerator != 0) & (denominator == 0)] = 0.0
    return float(np.mean(scores))
