"""Fatigue and workload indices from band powers.

Counterpart of ``eegsynth/analysis/fatigue.py``: TBR / TABR / ABR / θα per
channel, the frontal-θ over parietal-occipital-α workload ratio, and the
per-(epoch, channel) Welch theta/beta matrix as one batched float64 Welch on
a device.
"""

from __future__ import annotations

import numpy as np

from eegsynth_torch.analysis.bandpower import (
    BANDS, FRONTAL_SET, PARIETAL_OCC_SET, bandpower_from_psd, epoch_psd,
)

EPS = 1e-12


def fatigue_indices(bp: dict) -> dict:
    """Per-channel indices from a band → (C,) power dict."""
    T, A, B = bp["Theta"], bp["Alpha"], bp["Beta"]
    return {
        "TBR (Theta/Beta)": T / (B + EPS),
        "TABR ((Theta+Alpha)/Beta)": (T + A) / (B + EPS),
        "ABR (Alpha/Beta)": A / (B + EPS),
        "Theta/Alpha": T / (A + EPS),
    }


def _region_mean(values: np.ndarray, ch_names: list[str], wanted: set) -> float:
    idxs = [i for i, n in enumerate(ch_names) if n in wanted]
    if not idxs:
        return float(np.mean(values))  # no channel of the region: the global mean
    return float(np.mean(values[idxs]))


def workload_ratio(bp: dict, ch_names: list[str]) -> float:
    """Frontal-θ mean over parietal-occipital-α mean."""
    theta_f = _region_mean(bp["Theta"], ch_names, FRONTAL_SET)
    alpha_po = _region_mean(bp["Alpha"], ch_names, PARIETAL_OCC_SET)
    return theta_f / (alpha_po + EPS)


def global_indices(bp: dict) -> dict:
    """The indices of the channel-mean band powers."""
    T, A, B = np.mean(bp["Theta"]), np.mean(bp["Alpha"]), np.mean(bp["Beta"])
    return {
        "Global Theta/Alpha": float(T / (A + EPS)),
        "Global TBR": float(T / (B + EPS)),
        "Global TABR": float((T + A) / (B + EPS)),
        "Global ABR": float(A / (B + EPS)),
    }


def tbr_matrix(X: np.ndarray, fs: float, nperseg: int | None = None,
               noverlap: int | None = None, *, device) -> np.ndarray:
    """Per-(epoch, channel) Welch theta/beta ratio: X (N, T, C) → (N, C)
    float64 numpy, the Welch and the band integrals on ``device``."""
    f, psd = epoch_psd(X, fs, nperseg, noverlap, device)     # (N, C, F)
    theta = bandpower_from_psd(f, psd, *BANDS["Theta"])
    beta = bandpower_from_psd(f, psd, *BANDS["Beta"])
    return (theta / (beta + EPS)).cpu().numpy()
