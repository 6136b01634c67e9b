"""Welch PSD and canonical EEG band powers, batched.

Counterpart of ``eegsynth/analysis/bandpower.py``: one float64 Welch over
every epoch and channel (1 s windows, 50 % overlap by default) on a device,
the epoch mean ± SEM, trapezoid band integrals over δ/θ/α/β/γ.
"""

from __future__ import annotations

import numpy as np
import torch

from eegsynth_torch.ops.spectral import trapezoid, welch_psd

BANDS = {
    "Delta": (1.0, 4.0),
    "Theta": (4.0, 8.0),
    "Alpha": (8.0, 13.0),
    "Beta": (13.0, 30.0),
    "Gamma": (30.0, 45.0),
}

REGION_ORDER = {
    "Frontal": ["AF3", "AF4", "F3", "F4", "FC5", "FC6", "F7", "F8"],
    "Temporal": ["T7", "T8"],
    "Parietal": ["P7", "P8"],
    "Occipital": ["O1", "O2"],
}

FRONTAL_SET = {"AF3", "AF4", "F3", "F4"}
PARIETAL_OCC_SET = {"P7", "P8", "O1", "O2"}


def epoch_psd(X, fs: float, nperseg: int | None, noverlap: int | None, device):
    """Float64 Welch PSD of every epoch and channel of X (N, T, C) on
    ``device``: (f (F,), psd (N, C, F)), both on the device."""
    nperseg = int(fs) if nperseg is None else nperseg
    noverlap = int(nperseg // 2) if noverlap is None else noverlap
    x = torch.as_tensor(np.asarray(X)).to(device=device, dtype=torch.float64)
    f, psd = welch_psd(x, fs=fs, nperseg=nperseg, noverlap=noverlap, axis=1)
    return f, psd.transpose(1, 2)


def compute_psd_per_channel(X: np.ndarray, fs: float, nperseg: int | None = None,
                            noverlap: int | None = None, *, device):
    """(N, T, C) → (f (F,), psd_mean (C, F), psd_sem (C, F)), numpy: one
    batched Welch on ``device``, then the epoch mean and the ddof-1 SEM on
    the host."""
    N = X.shape[0]
    f, psd = epoch_psd(X, fs, nperseg, noverlap, device)
    psd = psd.cpu().numpy()
    psd_mean = psd.mean(axis=0)
    psd_sem = psd.std(axis=0, ddof=1) / np.sqrt(max(1, N))
    return f.cpu().numpy(), psd_mean, psd_sem


def bandpower_from_psd(f, psd, lo: float, hi: float):
    """Trapezoid band integral over [lo, hi]: psd (..., F) → (...,), in the
    type of ``psd`` (numpy, or a tensor on its device)."""
    as_numpy = not isinstance(psd, torch.Tensor)
    f = torch.as_tensor(f)
    psd = torch.as_tensor(psd)
    idx = (f >= lo) & (f <= hi)
    if not bool(idx.any()):
        out = torch.zeros(psd.shape[:-1], dtype=torch.float64, device=psd.device)
    else:
        out = trapezoid(psd[..., idx.to(psd.device)], f[idx].to(psd.device))
    return out.cpu().numpy() if as_numpy else out


def band_powers(f, psd) -> dict:
    """band name → (...,) trapezoid power."""
    return {name: bandpower_from_psd(f, psd, lo, hi)
            for name, (lo, hi) in BANDS.items()}


def order_channels_grouped(ch_names: list[str]):
    """Region-grouped channel order for bar plots: (names, indices,
    [(region, start, stop)])."""
    present = set(ch_names)
    ordered_names, ordered_indices, boundaries = [], [], []
    cursor = 0
    for region, group in REGION_ORDER.items():
        group_present = [ch for ch in group if ch in present]
        if group_present:
            start = cursor
            for ch in group_present:
                ordered_names.append(ch)
                ordered_indices.append(ch_names.index(ch))
                cursor += 1
            boundaries.append((region, start, cursor))
    for i, ch in enumerate(ch_names):
        if ch not in ordered_names:
            boundaries.append(("Other", len(ordered_names), len(ordered_names) + 1))
            ordered_names.append(ch)
            ordered_indices.append(i)
    return ordered_names, ordered_indices, boundaries
