"""The linear models of the CGAN eval, in float64 on the caller's device.

The JAX package fits them on the host with scikit-learn
(``eegsynth/eval/cgan_eval.py``: ``StandardScaler``, ``Ridge(alpha=1.0)``
and ``LogisticRegression(max_iter=1000)``), which the port does not depend
on. These are their counterparts on torch tensors:

- :class:`StandardScaler`: population std; a feature that scikit-learn
  would call constant keeps scale 1;
- :class:`Ridge`: the closed form, intercept fitted by centring; the dual
  (samples × samples) system when there are fewer samples than features, as
  scikit-learn's Cholesky solver does;
- :class:`LogisticRegression`: L2 with C = 1, intercept not penalised,
  solved to its optimum by Newton's method with a backtracking line search.
  scikit-learn's lbfgs stops at ``tol=1e-4``, so its coefficients differ
  from the optimum's slightly (``tests/test_torch_cgan_eval.py`` says by
  how much).
"""

from __future__ import annotations

import torch

_F64 = torch.float64


class StandardScaler:
    """``sklearn.preprocessing.StandardScaler()``: (x - mean) / std per
    column, the std of the population (ddof 0)."""

    def fit(self, X: torch.Tensor) -> "StandardScaler":
        X = X.to(_F64)
        n = X.shape[0]
        self.mean_ = X.mean(dim=0)
        self.var_ = ((X - self.mean_) ** 2).mean(dim=0)
        # scikit-learn's _is_constant_feature: a variance within the error
        # bound of its two-pass computation counts as zero
        eps = torch.finfo(_F64).eps
        constant = self.var_ <= n * eps * self.var_ + (n * self.mean_ * eps) ** 2
        self.scale_ = torch.where(constant, torch.ones_like(self.var_),
                                  self.var_.sqrt())
        return self

    def transform(self, X: torch.Tensor) -> torch.Tensor:
        return (X.to(_F64) - self.mean_) / self.scale_

    def fit_transform(self, X: torch.Tensor) -> torch.Tensor:
        return self.fit(X).transform(X)


def _spd_solve(A: torch.Tensor, B: torch.Tensor) -> torch.Tensor:
    """A⁻¹ B for a symmetric positive definite A."""
    return torch.cholesky_solve(B, torch.linalg.cholesky(A))


class Ridge:
    """``sklearn.linear_model.Ridge(alpha=alpha)`` with an intercept, for a
    target matrix Y (n, k): minimises ‖Y - X W - b‖² + alpha ‖W‖²."""

    def __init__(self, alpha: float = 1.0):
        self.alpha = alpha

    def fit(self, X: torch.Tensor, Y: torch.Tensor) -> "Ridge":
        X, Y = X.to(_F64), Y.to(_F64)
        x_mean, y_mean = X.mean(dim=0), Y.mean(dim=0)
        Xc, Yc = X - x_mean, Y - y_mean
        n, d = Xc.shape
        if d > n:      # the dual: W = Xcᵀ (Xc Xcᵀ + alpha I)⁻¹ Yc
            K = Xc @ Xc.T
            K.diagonal().add_(self.alpha)
            self.coef_ = Xc.T @ _spd_solve(K, Yc)
        else:          # the primal: W = (Xcᵀ Xc + alpha I)⁻¹ Xcᵀ Yc
            A = Xc.T @ Xc
            A.diagonal().add_(self.alpha)
            self.coef_ = _spd_solve(A, Xc.T @ Yc)
        self.intercept_ = y_mean - x_mean @ self.coef_
        return self

    def predict(self, X: torch.Tensor) -> torch.Tensor:
        return X.to(_F64) @ self.coef_ + self.intercept_


class LogisticRegression:
    """``sklearn.linear_model.LogisticRegression()`` for labels {0, 1}:
    minimises Σ log(1 + exp(-ỹ (x·w + b))) + ‖w‖² / (2C), b unpenalised, by
    Newton's method on the (d+1)² Hessian.

    It stops when the Newton decrement g·H⁻¹g falls under 1e-20 of the
    objective, or stops falling once under 1e-10 of it (the floor of float64
    rounding), or after ``max_iter`` steps; ``n_iter_`` says how many it
    took."""

    def __init__(self, C: float = 1.0, max_iter: int = 100):
        self.C = C
        self.max_iter = max_iter

    def fit(self, X: torch.Tensor, y: torch.Tensor) -> "LogisticRegression":
        X = X.to(_F64)
        y = y.to(device=X.device, dtype=_F64)
        Xa = torch.cat([X, torch.ones_like(X[:, :1])], dim=1)
        reg = torch.full((Xa.shape[1],), 1.0 / self.C, dtype=_F64, device=X.device)
        reg[-1] = 0.0
        w = torch.zeros_like(reg)

        def objective(w):
            z = Xa @ w
            return (torch.logaddexp(torch.zeros_like(z), z) - y * z).sum() \
                + 0.5 * (reg * w * w).sum()

        f = objective(w)
        prev = float("inf")
        self.n_iter_ = 0
        for self.n_iter_ in range(1, self.max_iter + 1):
            p = torch.sigmoid(Xa @ w)
            g = Xa.T @ (p - y) + reg * w
            H = (Xa * (p * (1.0 - p))[:, None]).T @ Xa
            H.diagonal().add_(reg)
            step = torch.linalg.solve(H, g)
            dec, scale = float(g @ step), max(1.0, float(f))
            if dec <= 1e-20 * scale or (dec <= 1e-10 * scale and dec > 0.25 * prev):
                break
            prev = dec
            t = 1.0
            while True:
                f_new = objective(w - t * step)
                if float(f_new) <= float(f) - 0.25 * t * dec or t < 1e-10:
                    break
                t *= 0.5
            w, f = w - t * step, f_new
        self.coef_, self.intercept_ = w[:-1], w[-1]
        return self

    def predict_proba(self, X: torch.Tensor) -> torch.Tensor:
        """P(class 1) of each row (the second column of scikit-learn's)."""
        return torch.sigmoid(X.to(_F64) @ self.coef_ + self.intercept_)
