"""The port's numpy scorer protocol (eegsynth_torch.eval.protocol) against
scikit-learn, which the JAX package's scorers call: the stratified split
index for index, and accuracy, ROC AUC (ties included), MSE and R² (a
constant target column included)."""

import numpy as np
import pytest
from sklearn.metrics import (
    accuracy_score, mean_squared_error, r2_score, roc_auc_score,
)
from sklearn.model_selection import train_test_split

from test_torch_threads import one_thread_each  # noqa: F401

from eegsynth_torch.eval import protocol

# float64 sums of at most a few hundred terms in another order
AUC_TOL = 1e-12


@pytest.mark.parametrize("seed", [0, 1, 5, 42])
def test_split_matches_sklearn_index_for_index(seed):
    """The eval's split (n real then n fake, labels 1 then 0) for every 2n
    from 4 to 400, odd and even n."""
    for n in range(2, 201):
        y = np.concatenate([np.ones(n), np.zeros(n)]).astype(np.float32)
        X = np.arange(2 * n)
        Xtr, Xte, ytr, yte = train_test_split(X, y, test_size=0.3, stratify=y,
                                              random_state=seed)
        got = protocol.train_test_split(X, y, test_size=0.3, random_state=seed)
        for a, b, name in zip((Xtr, Xte, ytr, yte), got, ("Xtr", "Xte", "ytr", "yte")):
            np.testing.assert_array_equal(b, a, err_msg=f"{name} n={n} seed={seed}")


@pytest.mark.parametrize("counts", [(5, 9), (7, 3, 11), (2, 2), (40, 41)])
def test_split_matches_sklearn_unbalanced_classes(counts):
    """Classes of unequal size draw from the RandomState to break ties in
    the approximate mode: the same draws, the same indices."""
    rng = np.random.default_rng(sum(counts))
    y = rng.permutation(np.repeat(np.arange(len(counts)), counts))
    for seed in (0, 3, 17):
        want = train_test_split(np.arange(len(y)), test_size=0.3, stratify=y,
                                random_state=seed)
        got = protocol.stratified_split_indices(y, 0.3, seed)
        for a, b in zip(want, got):
            np.testing.assert_array_equal(b, a)


def test_split_rejects_a_class_of_one():
    with pytest.raises(ValueError, match="only 1 member"):
        protocol.stratified_split_indices(np.array([0, 0, 0, 1]), 0.5, 0)


@pytest.mark.parametrize("ties", [False, True])
def test_roc_auc_matches_sklearn(ties):
    rng = np.random.default_rng(int(ties))
    for _ in range(100):
        m = int(rng.integers(4, 120))
        y = rng.integers(0, 2, m).astype(np.float32)
        if len(np.unique(y)) < 2:
            continue
        if ties:    # few distinct values, as a scorer's saturated probabilities
            s = (rng.integers(0, 6, m) / 5).astype(np.float32)
        else:
            s = rng.standard_normal(m).astype(np.float32)
        assert abs(protocol.roc_auc_score(y, s) - roc_auc_score(y, s)) <= AUC_TOL


@pytest.mark.filterwarnings("ignore::sklearn.exceptions.UndefinedMetricWarning")
def test_roc_auc_of_one_class_is_nan():
    """Older scikit-learn versions raise there, and the JAX package catches
    it as nan; newer ones warn and return nan."""
    for y in (np.ones(5), np.zeros(5)):
        try:
            want = roc_auc_score(y, np.arange(5.0))
        except ValueError:
            want = float("nan")
        assert np.isnan(want) and np.isnan(protocol.roc_auc_score(y, np.arange(5.0)))


def test_accuracy_mse_r2_match_sklearn():
    rng = np.random.default_rng(3)
    y = rng.integers(0, 2, 50).astype(np.float32)
    pred = rng.integers(0, 2, 50)
    assert protocol.accuracy_score(y, pred) == accuracy_score(y, pred)

    yt = rng.standard_normal((40, 5)).astype(np.float32)
    yp = rng.standard_normal((40, 5)).astype(np.float32)
    yt[:, 1] = yp[:, 1] = 0.25      # constant target, predicted exactly: 1.0
    yt[:, 3] = 0.5                  # constant target, missed: 0.0
    assert protocol.mean_squared_error(yt, yp) == mean_squared_error(yt, yp)
    assert protocol.r2_score(yt, yp) == r2_score(yt, yp,
                                                 multioutput="uniform_average")
    assert protocol.r2_score(yt[:, 0], yp[:, 0]) == r2_score(yt[:, 0], yp[:, 0])
