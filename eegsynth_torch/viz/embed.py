"""The embeddings behind the cluster figures: standard scaling, PCA and
t-SNE, in PyTorch on the caller's device (the card unless the caller passes
CPU tensors).

They replace the scikit-learn calls of the JAX package's figures:

- ``standard_scale``: ``StandardScaler().fit_transform`` (population
  variance; a constant column keeps scale 1, by scikit-learn's test);
- ``pca(X, k)``: ``PCA(n_components=k, svd_solver="full")``, exact, in
  float64: the eigenvectors of the smaller of the Gram and the covariance
  matrix, each component signed so that its largest-magnitude entry is
  positive (scikit-learn's ``svd_flip(u_based_decision=False)``);
- ``tsne(X, perplexity)``: scikit-learn 1.9's ``TSNE(n_components=2,
  init="pca", learning_rate="auto")``: P from the ``min(N − 1,
  ⌊3·perplexity + 1⌋)`` nearest neighbours (each row's precision found by
  binary search on squared distances, then symmetrised and normalised),
  a PCA start scaled to standard deviation 1e-4, early exaggeration 12 for
  250 iterations at momentum 0.5, then momentum 0.8 to 1,000, gains +0.2 /
  ×0.8 floored at 0.01, the progress and gradient-norm stops every 50
  iterations. The Student-t repulsion and the gradient are exact over all
  pairs (scikit-learn approximates them by Barnes-Hut). It draws no random
  numbers: a run is deterministic.

``TooFewPoints`` (a ``ValueError``) is what t-SNE raises for a perplexity
not below the point count; callers that skip such a figure catch it alone.
"""

from __future__ import annotations

import math
import time
from dataclasses import dataclass

import numpy as np
import torch

MACHINE_EPSILON = float(np.finfo(np.float64).eps)
PERPLEXITY_TOLERANCE = 1e-5
# scikit-learn's TSNE defaults
EARLY_EXAGGERATION, MAX_ITER, N_ITER_WITHOUT_PROGRESS, MIN_GRAD_NORM = 12.0, 1000, 300, 1e-7
N_ITER_CHECK, EXPLORATION_ITER = 50, 250


STATS = {"pca_s": 0.0, "pca_calls": 0, "tsne_s": 0.0, "tsne_iters": 0, "tsne_calls": 0}
"""Seconds and counts of the ``pca`` and ``tsne`` calls since
``reset_stats`` (host clock, each call ending in a wait for its device; a
t-SNE's own PCA start counts in its t-SNE seconds)."""


def reset_stats() -> None:
    for k in STATS:
        STATS[k] = 0 if isinstance(STATS[k], int) else 0.0


def _sync(t: torch.Tensor) -> None:
    if t.is_cuda:
        torch.cuda.synchronize(t.device)


class TooFewPoints(ValueError):
    """t-SNE over fewer points than its perplexity needs."""


def as_tensor(X, device=None, dtype=torch.float64) -> torch.Tensor:
    """X (numpy or tensor) as a ``dtype`` tensor on ``device`` (X's own
    device for a tensor when ``device`` is None, else the CPU)."""
    if isinstance(X, torch.Tensor):
        return X.to(device=device if device is not None else X.device, dtype=dtype)
    return torch.as_tensor(np.asarray(X), dtype=dtype, device=device)


def standard_scale(X: torch.Tensor) -> torch.Tensor:
    """(X − mean) / std per column, in float64, as scikit-learn's
    StandardScaler: the variance with its first-order correction, and a
    column whose variance is within rounding of zero scaled by 1."""
    X = X.to(torch.float64)
    n = X.shape[0]
    mean = X.sum(0) / n
    diff = X - mean
    correction = diff.sum(0)
    var = ((diff * diff).sum(0) - correction * correction / n) / n
    constant = var <= n * MACHINE_EPSILON * var + (n * mean * MACHINE_EPSILON) ** 2
    scale = torch.where(constant, torch.ones_like(var), var.sqrt())
    return diff / scale


def winsorize(X: torch.Tensor, lo: float = 0.005, hi: float = 0.995) -> torch.Tensor:
    """Clip each column to its ``lo`` and ``hi`` quantiles (numpy's linear
    method, computed on a sort of the columns)."""
    n = X.shape[0]
    S, _ = torch.sort(X, dim=0)

    def quantile(q):
        pos = q * (n - 1)
        i = int(math.floor(pos))
        g = pos - i
        a, b = S[i], S[min(i + 1, n - 1)]
        d = b - a
        return a + d * g if g < 0.5 else b - d * (1 - g)

    return torch.minimum(torch.maximum(X, quantile(lo)), quantile(hi))


def pca(X: torch.Tensor, k: int) -> torch.Tensor:
    """The first ``k`` principal-component scores of X (N, D), float64:
    ``PCA(n_components=k, svd_solver="full").fit_transform(X)`` with its
    signs. Components past X's rank score 0."""
    t0 = time.perf_counter()
    scores = _pca(X, k)
    _sync(scores)
    STATS["pca_s"] += time.perf_counter() - t0
    STATS["pca_calls"] += 1
    return scores


def _pca(X: torch.Tensor, k: int) -> torch.Tensor:
    X = X.to(torch.float64)
    n, d = X.shape
    Xc = X - X.mean(0)
    if n <= d:
        evals, U = torch.linalg.eigh(Xc @ Xc.T)
        evals, U = evals.flip(0)[:k], U.flip(1)[:, :k]
        S = evals.clamp_min(0).sqrt()
        tol = (S[0] if len(S) else 0.0) * max(n, d) * MACHINE_EPSILON
        live = S > tol
        V = (Xc.T @ U) / torch.where(live, S, torch.ones_like(S))
        V = V * live
    else:
        evals, V = torch.linalg.eigh(Xc.T @ Xc)
        V = V.flip(1)[:, :k]
    idx = V.abs().argmax(0)
    signs = torch.sign(V[idx, torch.arange(V.shape[1], device=V.device)])
    signs = torch.where(signs == 0, torch.ones_like(signs), signs)
    scores = Xc @ (V * signs)
    if scores.shape[1] < k:     # fewer components than asked: zero columns
        scores = torch.cat([scores, scores.new_zeros(n, k - scores.shape[1])], 1)
    return scores


def sq_distances(X: torch.Tensor) -> torch.Tensor:
    """(N, N) squared Euclidean distances, float64, ≥ 0."""
    s = (X * X).sum(1)
    D = s[:, None] + s[None, :]
    D.addmm_(X, X.T, alpha=-2.0)
    return D.clamp_(min=0.0)


def nearest_neighbors(X: torch.Tensor, k: int) -> tuple[torch.Tensor, torch.Tensor]:
    """Each point's k nearest other points: (squared distances, indices),
    both (N, k), nearest first."""
    D = sq_distances(X.to(torch.float64))
    D.fill_diagonal_(float("inf"))
    d2, idx = torch.topk(D, k, dim=1, largest=False, sorted=True)
    return d2, idx


def binary_search_perplexity(d2: torch.Tensor, perplexity: float) -> torch.Tensor:
    """scikit-learn's ``_binary_search_perplexity`` over neighbour rows, all
    rows at once: each row's conditional P at the precision whose entropy is
    within 1e-5 of log(perplexity) (100 halvings at most). The distances are
    rounded to float32 first, as there; the sums run in float64."""
    d2 = d2.to(torch.float32).to(torch.float64)
    n = d2.shape[0]
    beta = torch.ones(n, dtype=torch.float64, device=d2.device)
    lo = torch.full_like(beta, -math.inf)
    hi = torch.full_like(beta, math.inf)
    done = torch.zeros(n, dtype=torch.bool, device=d2.device)
    P = torch.zeros_like(d2)
    target = math.log(perplexity)
    for _ in range(100):
        Pi = torch.exp(-d2 * beta[:, None])
        s = Pi.sum(1)
        s = torch.where(s == 0, torch.full_like(s, 1e-8), s)
        Pi = Pi / s[:, None]
        H = torch.log(s) + beta * (d2 * Pi).sum(1)
        diff = H - target
        P = torch.where(done[:, None], P, Pi)
        conv = diff.abs() <= PERPLEXITY_TOLERANCE
        up = ~done & ~conv & (diff > 0)
        down = ~done & ~conv & (diff <= 0)
        lo = torch.where(up, beta, lo)
        hi = torch.where(down, beta, hi)
        beta = torch.where(up, torch.where(torch.isinf(hi), beta * 2, (beta + hi) / 2), beta)
        beta = torch.where(down, torch.where(torch.isinf(lo), beta / 2, (beta + lo) / 2), beta)
        done = done | conv
        if bool(done.all()):
            break
    return P


def joint_probabilities_nn(d2: torch.Tensor, idx: torch.Tensor, perplexity: float) -> torch.Tensor:
    """Dense (N, N) joint P of t-SNE from each point's neighbours:
    conditional P by binary search, P + Pᵀ, divided by its sum (scikit-
    learn's ``_joint_probabilities_nn``)."""
    n = d2.shape[0]
    cond = binary_search_perplexity(d2, perplexity)
    P = torch.zeros((n, n), dtype=torch.float64, device=d2.device)
    P.scatter_(1, idx, cond)
    P = P + P.T
    return P / max(float(P.sum()), MACHINE_EPSILON)


def _kl_grad(Y: torch.Tensor, P: torch.Tensor, error: bool):
    """Exact Student-t (one degree of freedom) KL(P‖Q) and its gradient."""
    W = sq_distances(Y)
    W.add_(1.0).reciprocal_()
    W.fill_diagonal_(0.0)
    Q = W / W.sum()
    Q.clamp_(min=MACHINE_EPSILON)
    kl = None
    if error:
        kl = (P * torch.log(P.clamp(min=MACHINE_EPSILON) / Q)).sum()
    M = Q.neg_().add_(P).mul_(W)           # (P − Q) · w
    grad = 4.0 * (M.sum(1, keepdim=True) * Y - M @ Y)
    return kl, grad


@dataclass
class TSNEResult:
    embedding: torch.Tensor   # (N, 2) float64
    kl_divergence: float      # at the last check, with the plain P
    n_iter: int               # scikit-learn's n_iter_: the last iteration run


def _graphed(step, state: tuple):
    """A CUDA graph of one ``step(False)`` on the state tensors it updates
    in place: warmed up on a side stream, the state then restored, so
    capturing changes nothing. Replaying it runs the step's ~30 launches
    as one (they bound a step at a few hundred points)."""
    saved = [t.clone() for t in state]
    side = torch.cuda.Stream(state[0].device)
    side.wait_stream(torch.cuda.current_stream(state[0].device))
    with torch.cuda.stream(side):
        step(False)
    torch.cuda.current_stream(state[0].device).wait_stream(side)
    for t, v in zip(state, saved):
        t.copy_(v)
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        step(False)
    return graph


def _descend(Y, P, it, max_iter, momentum, lr, n_without_progress, update, gains):
    """One stage of gradient descent; Y, update and gains change in place.
    Returns the last error and iteration."""
    def step(error: bool):
        kl, grad = _kl_grad(Y, P, error)
        inc = update * grad < 0.0
        torch.where(inc, gains + 0.2, gains * 0.8, out=gains)
        gains.clamp_(min=0.01)
        grad = grad * gains
        update.mul_(momentum).sub_(lr * grad)
        Y.add_(update)
        return kl, grad

    graph = _graphed(step, (Y, update, gains)) if Y.is_cuda else None
    best_error = error = float(np.finfo(float).max)
    best_iter = i = it
    for i in range(it, max_iter):
        check = (i + 1) % N_ITER_CHECK == 0
        if graph is not None and not check and i != max_iter - 1:
            graph.replay()
            continue
        kl, grad = step(check or i == max_iter - 1)
        if kl is not None:
            error = float(kl)
        if check:
            grad_norm = float(torch.linalg.vector_norm(grad))
            if error < best_error:
                best_error, best_iter = error, i
            elif i - best_iter > n_without_progress:
                break
            if grad_norm <= MIN_GRAD_NORM:
                break
    return error, i


def tsne(X, perplexity: float = 30.0) -> TSNEResult:
    """Two-dimensional t-SNE of X (N, D) on X's device (the CPU for numpy);
    see the module docstring for the schedule."""
    X = as_tensor(X)
    n = X.shape[0]
    if n < 2 or perplexity >= n:
        raise TooFewPoints(f"perplexity ({perplexity}) must be less than n_samples ({n})")
    t0 = time.perf_counter()
    lr = max(n / EARLY_EXAGGERATION / 4.0, 50.0)
    k = min(n - 1, int(3.0 * perplexity + 1))
    d2, idx = nearest_neighbors(X, k)
    P = joint_probabilities_nn(d2, idx, perplexity)
    Y = _pca(X, 2).to(torch.float32).to(torch.float64)
    Y = Y / Y[:, 0].std(unbiased=False) * 1e-4
    update = torch.zeros_like(Y)
    gains = torch.ones_like(Y)
    _, it = _descend(Y, P * EARLY_EXAGGERATION, 0, EXPLORATION_ITER, 0.5, lr,
                     EXPLORATION_ITER, update, gains)
    kl, it = _descend(Y, P, it + 1, MAX_ITER, 0.8, lr, N_ITER_WITHOUT_PROGRESS, update, gains)
    _sync(Y)
    STATS["tsne_s"] += time.perf_counter() - t0
    STATS["tsne_iters"] += it + 1
    STATS["tsne_calls"] += 1
    return TSNEResult(Y, kl, it)


def trustworthiness(X, Y, n_neighbors: int = 5) -> float:
    """scikit-learn's ``trustworthiness``: how far Y's k nearest neighbours
    are also X's, penalised by their rank in X."""
    X = as_tensor(X)
    Y = as_tensor(Y, X.device)
    n = X.shape[0]
    DX = sq_distances(X)
    DX.fill_diagonal_(float("inf"))
    order = torch.argsort(DX, dim=1)              # nearest first, self last
    ranks = torch.empty_like(order)
    ar = torch.arange(1, n + 1, device=X.device).expand(n, n)
    ranks.scatter_(1, order, ar)
    DY = sq_distances(Y)
    DY.fill_diagonal_(float("inf"))
    nn_y = torch.topk(DY, n_neighbors, dim=1, largest=False).indices
    r = torch.gather(ranks, 1, nn_y) - n_neighbors
    t = float(r.clamp(min=0).sum())
    k = n_neighbors
    return 1.0 - t * (2.0 / (n * k * (2.0 * n - 3.0 * k - 1.0)))
