"""CGAN evaluation metrics: discriminative, predictive and statistical.

Counterpart of ``eegsynth/eval/cgan_eval.py``, with the same rows, CSV
headers and row order. The features, statistics and linear models run on
``device`` (the FFTs in float32, the models in float64,
``eval/linear_models.py``); the split and the metrics run on the host with
``eval/protocol.py``, which gives scikit-learn's split index for index.
Artifacts per condition (v1) or per posture and ``global/`` (v2/v3):
``metrics_discriminative.csv``, ``metrics_predictive.csv``,
``metrics_stats.csv``, and the PCA / t-SNE scatter plots of the log-PSD
features (``scatter_plots``: ``pca_scatter.png``, ``tsne_scatter.png``,
``tsne_real_gen.png``), their PCA and t-SNE on ``device``
(``viz/embed.py``), their drawing on the host (``viz/raster.py``).
"""

from __future__ import annotations

import csv
import time
from pathlib import Path

import numpy as np
import torch

from eegsynth_torch.eval.features import psd_features_tensor
from eegsynth_torch.eval.linear_models import LogisticRegression, Ridge, StandardScaler
from eegsynth_torch.eval.protocol import (
    accuracy_score, mean_squared_error, r2_score, roc_auc_score,
    stratified_split_indices,
)
from eegsynth_torch.viz import embed, raster

NUM_POSTURES = 9
FIXED_PAIRS = [(0, 13), (6, 7), (9, 10), (1, 12)]


def _write_rows(path, rows):
    if not rows:
        rows = [{}]
    cols = list(rows[0].keys())
    with open(path, "w", newline="") as f:
        w = csv.DictWriter(f, fieldnames=cols)
        w.writeheader()
        w.writerows(rows)


def _finite(x: torch.Tensor) -> torch.Tensor:
    return torch.nan_to_num(x, nan=0.0, posinf=0.0, neginf=0.0)


def _logreg_acc_auc(Xs: torch.Tensor, y: np.ndarray, seed: int = 123):
    """Accuracy and AUC of a logistic regression on a stratified 70/30 split
    of the rows of ``Xs`` (labels ``y``, on the host)."""
    train, test = stratified_split_indices(y, 0.3, seed)
    ix = lambda a: torch.as_tensor(a, device=Xs.device)   # noqa: E731
    clf = LogisticRegression().fit(Xs[ix(train)], ix(y[train]))
    prob = clf.predict_proba(Xs[ix(test)]).cpu().numpy()
    return (accuracy_score(y[test], (prob > 0.5).astype(int)),
            roc_auc_score(y[test], prob))


def discriminative_metrics(Xr, Xg, yr, yg, out_csv, seed=123, v2_split=False, *,
                           device: torch.device | str):
    """Logistic regression real-vs-generated on standardised log-PSD
    features, global + per posture; ``Xr`` / ``Xg`` are (N, C, T), ``yr`` /
    ``yg`` their postures.

    ``v2_split=True`` reproduces eval_cgan_v2's per-posture selection with
    its positional bug, as the JAX package does: one posture vector of
    [p]×(nR_p + nG_p) blocks in ascending posture order, masked positionally
    against the stacked [real rows, generated rows], so a posture row scores
    a misaligned mixture whenever posture counts differ; its only guard is
    that both classes are present. The default is the v3 split: each
    posture's own rows, at least 20 of both classes."""
    Fr = psd_features_tensor(Xr, device=device)
    Fg = psd_features_tensor(Xg, device=device)
    y = np.hstack([np.zeros(len(Fr), np.int64), np.ones(len(Fg), np.int64)])
    y_post = np.hstack([yr, yg])
    Xs = _finite(StandardScaler().fit_transform(torch.cat([Fr, Fg])))
    acc, auc = _logreg_acc_auc(Xs, y, seed)
    rows = [dict(level="global", posture=0, acc=acc, auc=auc)]
    if v2_split:
        posts = np.unique(y_post)
        y_v2 = np.concatenate(
            [np.full(int((yr == p).sum() + (yg == p).sum()), p, np.int64)
             for p in posts]) if len(posts) else np.empty(0, np.int64)
        for p in posts:
            m = y_v2 == p
            if len(np.unique(y[m])) < 2:
                continue
            acc, auc = _logreg_acc_auc(Xs[torch.as_tensor(m, device=Xs.device)],
                                       y[m], seed)
            rows.append(dict(level="posture", posture=int(p), acc=acc, auc=auc))
    else:
        for p in range(1, NUM_POSTURES + 1):
            m = y_post == p
            if m.sum() < 20 or len(np.unique(y[m])) < 2:
                continue
            acc, auc = _logreg_acc_auc(Xs[torch.as_tensor(m, device=Xs.device)],
                                       y[m], seed)
            rows.append(dict(level="posture", posture=p, acc=acc, auc=auc))
    _write_rows(out_csv, rows)
    return rows


def _ridge_tstr(X_train, X_test, target_idx, device):
    """RMSE and R² of Ridge(α=1) predicting channel ``target_idx``'s trace
    from the other channels' (time-major features), standardised on the
    training rows."""
    C = X_train.shape[1]
    keep = torch.tensor([c for c in range(C) if c != target_idx], device=device)

    def make_xy(X):
        x = torch.as_tensor(np.asarray(X, np.float32), device=device)
        return (x.index_select(1, keep).transpose(1, 2).reshape(len(x), -1),
                x[:, target_idx, :])

    sX, sY = StandardScaler(), StandardScaler()
    Xtr, Ytr = make_xy(X_train)
    Xte, Yte = make_xy(X_test)
    Xtr = _finite(sX.fit_transform(Xtr))
    Ytr = _finite(sY.fit_transform(Ytr))
    Xte = _finite(sX.transform(Xte))
    Yte = _finite(sY.transform(Yte)).cpu().numpy()
    Yhat = Ridge(alpha=1.0).fit(Xtr, Ytr).predict(Xte).cpu().numpy()
    return (float(np.sqrt(mean_squared_error(Yte, Yhat))),
            float(r2_score(Yte, Yhat)))


def predictive_scores(Xr, Xg, yr, yg, out_csv, target_idx=13, seed=123, *,
                      device: torch.device | str):
    """Ridge(α=1) predicting the target channel's full trace from the other
    channels, TSTR + TRTS, global + per posture (postures with at least 10
    rows of each). ``seed`` is unused, as in the JAX package: the fits are
    deterministic."""
    rows = []
    rmse, r2 = _ridge_tstr(Xg, Xr, target_idx, device)
    rows.append(dict(level="global", posture=0, split="TSTR", rmse=rmse, r2=r2))
    rmse, r2 = _ridge_tstr(Xr, Xg, target_idx, device)
    rows.append(dict(level="global", posture=0, split="TRTS", rmse=rmse, r2=r2))
    for p in range(1, NUM_POSTURES + 1):
        mr, mg = yr == p, yg == p
        if mr.sum() < 10 or mg.sum() < 10:
            continue
        rmse, r2 = _ridge_tstr(Xg[mg], Xr[mr], target_idx, device)
        rows.append(dict(level="posture", posture=p, split="TSTR", rmse=rmse, r2=r2))
        rmse, r2 = _ridge_tstr(Xr[mr], Xg[mg], target_idx, device)
        rows.append(dict(level="posture", posture=p, split="TRTS", rmse=rmse, r2=r2))
    _write_rows(out_csv, rows)
    return rows


def _psd_avg(x: torch.Tensor) -> np.ndarray:
    """(N, C, T) → (C, F): the mean rFFT power."""
    F = torch.fft.rfft(x, dim=2)
    return (F.real ** 2 + F.imag ** 2).mean(dim=0).cpu().numpy()


def _acf_avg(x: torch.Tensor, max_lag: int = 128) -> np.ndarray:
    """(N, C, T) → (C, L): mean over rows and T - k of xc[:, :-k]·xc[:, k:]
    for lags k = 1..L, by one zero-padded FFT autocorrelation."""
    N, _, T = x.shape
    xc = x - x.mean(dim=2, keepdim=True)
    L = min(max_lag, T - 1)    # lag T has no valid samples
    n = 1 << (2 * T - 1).bit_length()
    spec = torch.fft.rfft(xc, n=n, dim=2)
    cross = torch.fft.irfft(spec * spec.conj(), n=n, dim=2)[:, :, 1:L + 1]
    counts = (T - torch.arange(1, L + 1, device=x.device)).to(x.dtype)
    return (cross.sum(dim=0) / (N * counts)[None, :]).cpu().numpy()


def _coh_avg(x: torch.Tensor, pairs=FIXED_PAIRS) -> np.ndarray:
    """(N, C, T) → (len(pairs), F): the mean over rows of each channel
    pair's per-window coherence |A B*| / sqrt(|A|² |B|² + 1e-8)."""
    F = torch.fft.rfft(x, dim=2)
    out = []
    for i, j in pairs:
        A, B = F[:, i, :], F[:, j, :]
        cross = A * B.conj()
        num = torch.sqrt(cross.real ** 2 + cross.imag ** 2)
        den = torch.sqrt((A.real ** 2 + A.imag ** 2) * (B.real ** 2 + B.imag ** 2)
                         + 1e-8)
        out.append((num / den).mean(dim=0))
    return torch.stack(out, 0).cpu().numpy()


def stats_similarity(Xr, Xg, yr, yg, out_csv, *,
                     device: torch.device | str):
    """Mean-PSD / mean-ACF / 4-pair coherence L1 distances, global + per
    posture (postures with at least 10 rows of each)."""
    def row(level, posture, R, G):
        r, g = (torch.as_tensor(np.asarray(a, np.float32), device=device)
                for a in (R, G))
        return dict(level=level, posture=posture,
                    psd_l1=float(np.mean(np.abs(_psd_avg(r) - _psd_avg(g)))),
                    acf_l1=float(np.mean(np.abs(_acf_avg(r) - _acf_avg(g)))),
                    coh_l1=float(np.mean(np.abs(_coh_avg(r) - _coh_avg(g)))))

    rows = [row("global", 0, Xr, Xg)]
    for p in range(1, NUM_POSTURES + 1):
        mr, mg = yr == p, yg == p
        if mr.sum() < 10 or mg.sum() < 10:
            continue
        rows.append(row("posture", p, Xr[mr], Xg[mg]))
    _write_rows(out_csv, rows)
    return rows


def scatter_plots(Xr, Xg, yr, yg, out_dir, perplexity=30.0, seed=123, *,
                  device: torch.device | str) -> None:
    """PCA and PCA-50 → t-SNE scatters of the log-PSD features: coloured by
    posture through tab10 with a colorbar (pca_scatter.png,
    tsne_scatter.png), and real against generated in C0 / C3
    (tsne_real_gen.png). ``seed`` is kept for the JAX signature: the PCA is
    exact and the t-SNE deterministic."""
    out_dir = Path(out_dir)
    Fr = psd_features_tensor(Xr, device=device)
    Fg = psd_features_tensor(Xg, device=device)
    X = torch.cat([Fr, Fg]).to(torch.float64)
    y = np.hstack([yr, yg])
    src = np.hstack([np.zeros(len(Fr)), np.ones(len(Fg))])

    Zp = embed.pca(X, 2).cpu().numpy()
    fig, ax = raster.subplots(figsize=(7, 6))
    m = ax.scatter(Zp[:, 0], Zp[:, 1], c=y, cmap="tab10", s=10, alpha=0.7,
                   edgecolors="none")
    fig.colorbar(m, ax=ax, label="posture")
    ax.set_title("PCA (color=posture)")
    fig.savefig(out_dir / "pca_scatter.png", dpi=150, bbox_inches="tight")

    X50 = embed.pca(X, min(50, X.shape[1] - 1))
    Z = embed.tsne(X50, perplexity=perplexity).embedding.cpu().numpy()
    fig, ax = raster.subplots(figsize=(7, 6))
    m = ax.scatter(Z[:, 0], Z[:, 1], c=y, cmap="tab10", s=8, alpha=0.7,
                   edgecolors="none")
    fig.colorbar(m, ax=ax, label="posture")
    ax.set_title("t-SNE (color=posture)")
    fig.savefig(out_dir / "tsne_scatter.png", dpi=150, bbox_inches="tight")
    fig, ax = raster.subplots(figsize=(7, 6))
    ax.scatter(Z[src == 0, 0], Z[src == 0, 1], c="C0", s=8, alpha=0.6, label="real")
    ax.scatter(Z[src == 1, 0], Z[src == 1, 1], c="C3", s=8, alpha=0.6, label="gen")
    ax.legend()
    ax.set_title("t-SNE (real vs gen)")
    fig.savefig(out_dir / "tsne_real_gen.png", dpi=150, bbox_inches="tight")


def evaluate_condition(Xr, yr, Xg, yg, out_dir, perplexity=30.0, seed=123, *,
                       device: torch.device | str) -> dict[str, float]:
    """One condition's CSV trio and scatter set; returns the seconds of each
    metric family and of the figures (host clock; each ends in a pull to
    the host)."""
    out_dir = Path(out_dir)
    out_dir.mkdir(parents=True, exist_ok=True)
    seconds = {}
    for name, fn, csv_name, kw in (
            ("discriminative", discriminative_metrics, "metrics_discriminative.csv",
             {"seed": seed}),
            ("predictive", predictive_scores, "metrics_predictive.csv",
             {"seed": seed}),
            ("statistics", stats_similarity, "metrics_stats.csv", {})):
        t0 = time.perf_counter()
        fn(Xr, Xg, yr, yg, out_dir / csv_name, device=device, **kw)
        seconds[name] = time.perf_counter() - t0
    t0 = time.perf_counter()
    scatter_plots(Xr, Xg, yr, yg, out_dir, perplexity, seed, device=device)
    seconds["figures"] = time.perf_counter() - t0
    return seconds
