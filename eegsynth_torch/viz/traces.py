"""Real-vs-synthetic trace figures with warm-up auto-trim.

Counterpart of ``eegsynth/viz/traces.py``: per-sequence standardization,
optional moving-average smoothing, a fixed or estimated synthetic warm-up
prefix trim (≤ 64 samples), per-channel sample grids and mean ± σ summary
ribbons. The numeric helpers are the JAX package's numpy code; the figures
are drawn by the port's raster layer.
"""

from __future__ import annotations

from pathlib import Path

import numpy as np

from eegsynth_torch.viz import raster


def standardize_per_seq(X: np.ndarray) -> np.ndarray:
    """z-score each (sequence, channel) trace over time."""
    mu = X.mean(axis=1, keepdims=True)
    sd = X.std(axis=1, keepdims=True) + 1e-8
    return (X - mu) / sd


def smooth_ma(X: np.ndarray, k: int) -> np.ndarray:
    """Centred moving average along time of (N, T, C): k forced odd, the
    ends padded by reflection."""
    if k <= 1:
        return X
    k = int(k) + (int(k) % 2 == 0)
    kernel = np.ones(k) / k
    pad = k // 2
    Xp = np.pad(X, ((0, 0), (pad, pad), (0, 0)), mode="reflect")
    out = np.empty_like(X)
    for c in range(X.shape[2]):
        out[:, :, c] = np.apply_along_axis(
            lambda v: np.convolve(v, kernel, mode="valid"), 1, Xp[:, :, c])
    return out


def estimate_prefix_to_trim(fake: np.ndarray, base_win: int = 16,
                            max_trim: int = 64, tol_mean: float = 0.18,
                            tol_step: float = 0.15,
                            use_first_C: int | None = None) -> int:
    """Synthetic warm-up length: the first offset whose adjacent-window
    means of the standardized data are small and close."""
    X = standardize_per_seq(fake.copy())
    N, T, C = X.shape
    if T < 3:
        return 0
    W = max(4, min(base_win, max(2, T // 6)))
    Csel = min(C, use_first_C if use_first_C is not None else C)
    max_L = min(max_trim, max(0, T - 2 * W - 1)) if T >= 2 * W + 2 else 0
    best = 0
    for L in range(0, max_L + 1):
        seg1 = X[:, L:L + W, :Csel].mean()
        seg2 = X[:, L + W:L + 2 * W, :Csel].mean()
        if abs(seg1) <= tol_mean and abs(seg1 - seg2) <= tol_step:
            best = L
            break
    if best == 0 and max_L > 0:
        best = min(base_win, max_trim, max_L)
    return max(best, 0)


def _axis_for(T_x: int, t_real: np.ndarray, fs: float) -> np.ndarray:
    """Time axis of an array of length T_x against real's axis: equal
    lengths share it, a shorter array aligns to its tail, a longer one gets
    its own."""
    if T_x == len(t_real):
        return t_real
    if T_x < len(t_real):
        return t_real[len(t_real) - T_x:]
    return (np.arange(T_x) / fs) if fs > 0 else np.arange(T_x)


def samples_grid(real, fake, ch_names, n_samples, fs, out_path, title=""):
    """channels × samples grid of overlaid real / synthetic traces."""
    N, T, C = real.shape
    n_samples = min(n_samples, N)
    idx = np.random.RandomState(0).choice(N, size=n_samples, replace=False)
    t = (np.arange(T) / fs) if fs > 0 else np.arange(T)
    tf = _axis_for(fake.shape[1], t, fs)
    rows, cols = len(ch_names), n_samples
    fig, axes = raster.subplots(rows, cols,
                                figsize=(2.0 * cols + 1.8, 1.0 * rows + 1.8),
                                sharex=True, squeeze=False)
    for r in range(rows):
        for c in range(cols):
            ax = axes[r, c]
            n = idx[c]
            ax.plot(t, real[n, :, r], lw=1.0, alpha=0.9, label="real")
            ax.plot(tf, fake[n, :, r], lw=1.0, alpha=0.9, linestyle="--", label="synth")
            if r == 0:
                ax.set_title(f"sample #{n}", fontsize=9)
            if c == 0:
                ax.set_ylabel(ch_names[r], fontsize=9)
            if r == rows - 1:
                ax.set_xlabel("time (s)" if fs > 0 else "t", fontsize=9)
            ax.grid(True, alpha=0.2)
            ax.margins(x=0)
    axes[0, 0].legend(loc="upper right", fontsize=8)
    if title:
        fig.suptitle(title, fontsize=11)
    fig.tight_layout()
    fig.savefig(out_path, dpi=150)


def summary_plot(real, fake, ch_names, fs, out_path, title=""):
    """Per-channel mean ± σ ribbons, real (C0) against synthetic (C3)."""
    T = real.shape[1]
    t = (np.arange(T) / fs) if fs > 0 else np.arange(T)
    tf = _axis_for(fake.shape[1], t, fs)
    rows = len(ch_names)
    fig, axes = raster.subplots(rows, 1, figsize=(9, 1.2 * rows + 1.5), sharex=True,
                                squeeze=False)
    for r in range(rows):
        ax = axes[r, 0]
        for X, tx, name, color in ((real, t, "real", "C0"), (fake, tf, "synth", "C3")):
            mu = X[:, :, r].mean(axis=0)
            sd = X[:, :, r].std(axis=0)
            ax.plot(tx, mu, lw=1.0, color=color, label=name)
            ax.fill_between(tx, mu - sd, mu + sd, alpha=0.2, color=color)
        ax.set_ylabel(ch_names[r], fontsize=8)
        ax.grid(True, alpha=0.2)
    axes[0, 0].legend(loc="upper right", fontsize=8)
    axes[-1, 0].set_xlabel("time (s)" if fs > 0 else "t")
    if title:
        fig.suptitle(title, fontsize=11)
    fig.tight_layout()
    fig.savefig(out_path, dpi=150)


def plot_pair(real, fake, ch_names, fs, out_dir, stem, n_samples: int = 4,
              auto_trim: bool = True, fixed_trim: int = 0, trim_both: bool = True,
              standardize: bool = True, smooth: int = 1,
              plot_all_channels: bool = True, first_k: int = 4) -> int:
    """One (real, fake) pair → samples_{stem}.png and summary_{stem}.png.
    Returns the trim applied."""
    out_dir = Path(out_dir)
    out_dir.mkdir(parents=True, exist_ok=True)
    m = min(len(real), len(fake))
    real, fake = real[:m].copy(), fake[:m].copy()

    L = (estimate_prefix_to_trim(fake, use_first_C=min(8, fake.shape[2]))
         if auto_trim else int(fixed_trim))
    L = max(0, min(L, fake.shape[1] - 2))
    if L > 0:
        if trim_both:
            real = real[:, L:, :]
        fake = fake[:, L:, :]
    if standardize:
        real, fake = standardize_per_seq(real), standardize_per_seq(fake)
    if smooth > 1:
        real, fake = smooth_ma(real, smooth), smooth_ma(fake, smooth)

    C = real.shape[2]
    names = list(ch_names[:C]) if plot_all_channels else list(ch_names[:min(first_k, C)])
    title = f"{stem} (N={len(real)}, T={real.shape[1]}, C={C})"
    samples_grid(real[:, :, :len(names)], fake[:, :, :len(names)], names,
                 n_samples, fs, out_dir / f"samples_{stem}.png", title)
    summary_plot(real[:, :, :len(names)], fake[:, :, :len(names)], names, fs,
                 out_dir / f"summary_{stem}.png", title)
    return L
