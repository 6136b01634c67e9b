"""PCA / t-SNE cluster figures over (posture, condition) real/synthetic pairs.

Counterpart of ``eegsynth/viz/cluster.py``, with the same functions, file
names and figure contents:

- flatten → winsorize the 0.5–99.5 % quantiles → z-score;
- PCA-2 everywhere; PCA-``pca_keep`` → t-SNE on a balanced ≤ ``tsne_max``
  subsample;
- 36-colour (posture × condition × domain) or 18-colour (posture ×
  condition) hsv palettes; real ``o``, generated ``x``;
- a compact in-figure legend, the paired (Real, Synthetic) legend, or a
  separate legend PNG;
- per-(posture, condition) zoom figures with fresh subset embeddings and the
  global colours.

The winsorizing, scaling, PCA and t-SNE run in float64 on the device of the
data (``cluster_figures(device=...)``; ``eegsynth_torch/viz/embed.py``), the
drawing on the host (``raster.py``). PCA is exact where scikit-learn's
default picks a randomized solver for wide inputs, and t-SNE's gradient is
exact where scikit-learn's is Barnes-Hut.
"""

from __future__ import annotations

from pathlib import Path

import numpy as np
import torch

from eegsynth_torch.viz import embed, raster
from eegsynth_torch.viz.colors import get_cmap


def _as(X, like):
    """A tensor result in the kind (numpy or tensor) of ``like``."""
    return X if isinstance(like, torch.Tensor) else X.cpu().numpy()


def winsorize(X, lo: float = 0.005, hi: float = 0.995):
    """Clip each column to its ``lo`` / ``hi`` quantiles (numpy's linear
    interpolation); numpy in, numpy out, a tensor stays on its device."""
    return _as(embed.winsorize(embed.as_tensor(X, dtype=_dtype(X)), lo, hi), X)


def zscore(X):
    """StandardScaler().fit_transform(X), in float64."""
    return _as(embed.standard_scale(embed.as_tensor(X)), X)


def _dtype(X):
    if isinstance(X, torch.Tensor):
        return X.dtype
    return torch.from_numpy(np.zeros(0, dtype=np.asarray(X).dtype)).dtype


def balanced_subsample(X, P, D, C, max_total: int = 6000, seed: int = 0):
    """Cap every (posture, condition, domain) group at an equal share of
    ``max_total``, drawn with ``RandomState(seed)`` as the JAX package does
    (the same rows for the same labels)."""
    if len(X) <= max_total:
        return X, P, D, C
    rng = np.random.RandomState(seed)
    idxs = []
    posts = np.unique(P)
    for p in posts:
        for c in ("with_exo", "no_exo"):
            for d in (1, 0):
                m = (P == p) & (C == c) & (D == d)
                if not np.any(m):
                    continue
                take = min(max_total // (len(posts) * 2 * 2), m.sum())
                idxs.append(rng.choice(np.where(m)[0], size=take, replace=False))
    idx = np.concatenate(idxs) if idxs else np.arange(len(X))
    Xi = X[torch.as_tensor(idx, device=X.device)] if isinstance(X, torch.Tensor) else X[idx]
    return Xi, P[idx], D[idx], C[idx]


def make_palette(n: int, cmap_name: str = "hsv"):
    cmap = get_cmap(cmap_name).resampled(n)
    return [cmap(i) for i in range(n)]


def cluster_id(posture: int, cond: str, domain: int, color_scheme: str = "36",
               dark_posture: int | None = None) -> int:
    """36: one colour per posture × condition × domain; 18: per posture ×
    condition. ``dark_posture`` puts that posture on the low (darker) palette
    indices."""
    p = posture - 1
    c = 0 if cond == "with_exo" else 1
    if color_scheme == "36":
        if posture == dark_posture:
            return c * 2 + (0 if domain == 1 else 1)
        return p * 4 + c * 2 + (0 if domain == 1 else 1)
    if posture == dark_posture:
        return c
    return p * 2 + c


def scatter_clusters(ax, emb, P, D, C, colors, color_scheme: str = "36",
                     point_size: float = 9, dark_posture: int | None = None):
    emb = np.asarray(emb)
    for p in np.unique(P):
        for c in ("with_exo", "no_exo"):
            for d in (1, 0):
                m = (P == p) & (C == c) & (D == d)
                if not np.any(m):
                    continue
                gid = cluster_id(p, c, d, color_scheme, dark_posture)
                label = f"P{p} {'W' if c == 'with_exo' else 'N'} {'R' if d == 1 else 'G'}"
                ax.scatter(emb[m, 0], emb[m, 1], s=point_size, alpha=0.8,
                           marker=("o" if d == 1 else "x"), c=[colors[gid]],
                           label=label)


def _compact_legend(ax, ncols=3, fontsize=5.2):
    return ax.legend(bbox_to_anchor=(1.02, 1), loc="upper left", ncol=ncols,
                     fontsize=fontsize, frameon=False, borderaxespad=0.0,
                     columnspacing=0.7, handlelength=1.2, handletextpad=0.3,
                     markerscale=0.9)


def add_paired_legend(ax, colors, color_scheme: str = "36",
                      fontsize: float = 5.6, dark_posture: int | None = None):
    """The 2-column (Real, Synthetic) legend over postures 1..9 × both
    conditions, whichever are present."""
    handles, labels = [], []
    for p in range(1, 10):
        for cond in ("no_exo", "with_exo"):
            nm = "No exo" if cond == "no_exo" else "With exo"
            gid_r = cluster_id(p, cond, 1, color_scheme, dark_posture)
            handles.append(raster.Line2D([], [], linestyle="None", marker="o",
                                         markersize=5, color=colors[gid_r]))
            labels.append(f"P-{p} {nm} Real")
            gid_g = cluster_id(p, cond, 0, color_scheme, dark_posture)
            handles.append(raster.Line2D([], [], linestyle="None", marker="x",
                                         markersize=5, color=colors[gid_g]))
            labels.append(f"P-{p} {nm} Syn")
    return ax.legend(handles, labels, ncol=2, fontsize=fontsize, frameon=False,
                     loc="upper left", bbox_to_anchor=(1.02, 1),
                     borderaxespad=0.0, columnspacing=1.0, handlelength=1.2,
                     handletextpad=0.5, markerscale=1.0)


def zoom_pair_figures(X, P, D, C, colors, p, cond, out_dir,
                      color_scheme: str = "36", seed: int = 0,
                      pca_keep: int = 50, tsne_perplexity: float = 30.0,
                      dark_posture: int | None = None) -> bool:
    """The zoom pair of one (posture, condition) with fresh subset
    embeddings (PCA-2, and PCA-K → t-SNE): zoom_p{p}_{cond}_pca.png and
    zoom_p{p}_{cond}_tsne.png at dpi 180. A one-window subset pads its PCA
    and reuses it as the t-SNE figure."""
    ms = (P == p) & (C == cond)
    if not np.any(ms):
        return False
    X = embed.as_tensor(X)
    Xs, Ds = X[torch.as_tensor(np.where(ms)[0], device=X.device)], D[ms]
    n = len(Xs)
    gid_r = cluster_id(p, cond, 1, color_scheme, dark_posture)
    gid_g = cluster_id(p, cond, 0, color_scheme, dark_posture)
    nm = f"P{p} {'W' if cond == 'with_exo' else 'N'}"

    def save(emb, kind, title):
        fig, ax = raster.subplots(figsize=(6.0, 4.6))
        ri = Ds == 1
        if np.any(ri):
            ax.scatter(emb[ri, 0], emb[ri, 1], s=14, alpha=0.9, marker="o",
                       c=[colors[gid_r]], label=f"{nm} R")
        if np.any(~ri):
            ax.scatter(emb[~ri, 0], emb[~ri, 1], s=14, alpha=0.9, marker="x",
                       c=[colors[gid_g]], label=f"{nm} G")
        ax.set_title(title)
        ax.set_xlabel("Dim 1")
        ax.set_ylabel("Dim 2")
        ax.legend(loc="best", fontsize=8, frameon=False)
        fig.tight_layout()
        fig.savefig(Path(out_dir) / f"zoom_p{p}_{cond}_{kind}.png", dpi=180)

    k2 = min(2, n, Xs.shape[1])
    pca2 = embed.pca(Xs, k2).cpu().numpy()
    if pca2.shape[1] < 2:
        pca2 = np.concatenate([pca2, np.zeros((n, 2 - pca2.shape[1]))], axis=1)
    save(pca2, "pca", f"ZOOM PCA: P{p} – {cond} (●R, ×G)")

    if n < 2:
        save(pca2, "tsne", f"ZOOM t-SNE: P{p} – {cond} (●R, ×G)")
        return True

    K = min(pca_keep, Xs.shape[1], max(2, n - 1))
    Xred = embed.pca(Xs, K)
    perp = min(tsne_perplexity, max(5, n // 3), max(1, n - 1))
    ts2 = embed.tsne(Xred, perplexity=perp).embedding.cpu().numpy()
    save(ts2, "tsne", f"ZOOM t-SNE: P{p} – {cond} (●R, ×G)")
    return True


def tsne_embed(X, seed: int, pca_keep: int = 50, perplexity: float = 30.0):
    """PCA to ≤ ``pca_keep`` dimensions, then t-SNE to 2 (numpy, float64),
    with the clamps: K ≤ n − 1 and the data's width, perplexity < n, and
    zeros for fewer than two points. ``seed`` is kept for the JAX
    signature: both steps are deterministic here."""
    X = embed.as_tensor(X)
    n = len(X)
    if n < 2:
        return np.zeros((n, 2), np.float32)
    K = min(pca_keep, X.shape[1], max(2, n - 1))
    Xred = embed.pca(X, K)
    return embed.tsne(Xred, perplexity=min(perplexity, max(1, n - 1))).embedding.cpu().numpy()


def save_legend_png(handles_labels, out_path, ncols=4):
    """A standalone legend figure, cropped to its ink."""
    handles, labels = handles_labels
    fig = raster.Figure(figsize=(8, max(2, len(labels) / (ncols * 4))))
    fig.legend(handles, labels, loc="center", ncol=ncols, fontsize=7, frameon=False)
    fig.savefig(out_path, dpi=170, bbox_inches="tight")


def cluster_figures(pairs: dict, out_dir, color_scheme: str = "36", seed: int = 0,
                    tsne_perplexity: float = 30.0, tsne_max: int = 6000,
                    pca_keep: int = 50, winsor_low: float = 0.005,
                    winsor_high: float = 0.995, zooms: bool = False,
                    separate_legend: bool = False,
                    paired_legend: bool = False,
                    dark_posture: int | None = None, *,
                    device: torch.device | str = "cuda") -> None:
    """The full cluster-figure pass over {(posture, cond): (real, fake)}:
    pca_combined.png and tsne_combined.png; with ``zooms`` the per-pair
    zoom figures; with ``separate_legend`` standalone legend PNGs
    ({name}_legend.png); with ``paired_legend`` the fixed 2-column legend;
    with ``dark_posture`` that posture on the darker palette indices. The
    embeddings run on ``device``."""
    out_dir = Path(out_dir)
    out_dir.mkdir(parents=True, exist_ok=True)

    X_blocks, P, D, C = [], [], [], []
    for (p, c), (r, f) in sorted(pairs.items()):
        X_blocks.append(np.concatenate([r, f], axis=0))
        P += [p] * (len(r) + len(f))
        D += [1] * len(r) + [0] * len(f)
        C += [c] * (len(r) + len(f))
    P, D, C = np.array(P), np.array(D), np.array(C)

    X = np.concatenate(X_blocks, axis=0).reshape(len(P), -1)
    X = torch.as_tensor(X, device=device).to(torch.float64)
    X = embed.standard_scale(embed.winsorize(X, winsor_low, winsor_high))

    n_colors = 36 if color_scheme == "36" else 18
    colors = make_palette(n_colors)

    def one_plot(emb, Pm, Dm, Cm, name, title):
        fig, ax = raster.subplots(figsize=(8.6, 5.8))
        scatter_clusters(ax, emb, Pm, Dm, Cm, colors, color_scheme,
                         dark_posture=dark_posture)
        ax.set_title(title)
        ax.set_xlabel("Dim 1")
        ax.set_ylabel("Dim 2")
        fig.subplots_adjust(right=0.78)
        if separate_legend:
            save_legend_png(ax.get_legend_handles_labels(),
                            out_dir / f"{name}_legend.png")
        elif paired_legend:
            add_paired_legend(ax, colors, color_scheme, dark_posture=dark_posture)
        else:
            _compact_legend(ax)
        fig.savefig(out_dir / f"{name}.png", dpi=170)

    pca2 = embed.pca(X, 2).cpu().numpy()
    one_plot(pca2, P, D, C, "pca_combined",
             "Combined PCA: Posture×Condition (● Real, × Gen)")

    Xb, Pb, Db, Cb = balanced_subsample(X, P, D, C, max_total=tsne_max, seed=seed)
    ts2 = tsne_embed(Xb, seed, pca_keep=pca_keep, perplexity=tsne_perplexity)
    one_plot(ts2, Pb, Db, Cb, "tsne_combined",
             "Combined t-SNE: Posture×Condition (● Real, × Gen)")

    if zooms:
        for (p, c) in sorted(pairs):
            zoom_pair_figures(X, P, D, C, colors, p, c, out_dir,
                              color_scheme=color_scheme, seed=seed,
                              pca_keep=pca_keep, tsne_perplexity=tsne_perplexity,
                              dark_posture=dark_posture)
