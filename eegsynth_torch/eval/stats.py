"""Statistical similarity of a real and a synthetic corpus: the mean absolute
differences of the Welch PSD, of the per-channel lag autocorrelation and of
the inter-channel correlation.

Counterpart of ``eegsynth/eval/stats.py``. Welch and the correlations run on
``device`` in float32; the autocorrelation runs on the host in float64
(``ops.acf.mean_acf_per_channel``).
"""

from __future__ import annotations

import numpy as np
import torch

from eegsynth_torch.ops.acf import mean_acf_per_channel
from eegsynth_torch.ops.spectral import welch_psd
from eegsynth_torch.ops.stats import channel_corrcoef


def psd_difference(real, fake, fs: float = 128.0, nperseg: int = 256,
                   device: torch.device | str = "cuda") -> float:
    """mean |Δ mean PSD|: Welch along time, averaged over the windows."""
    _, psd_r = welch_psd(torch.as_tensor(real, device=device), fs=fs,
                         nperseg=nperseg, axis=1)
    _, psd_f = welch_psd(torch.as_tensor(fake, device=device), fs=fs,
                         nperseg=nperseg, axis=1)
    return float(torch.mean(torch.abs(psd_r.mean(dim=0) - psd_f.mean(dim=0))))


def acf_difference(real, fake, fs: float = 128.0) -> float:
    """mean |Δ per-channel mean lag-1..0.75 fs autocorrelation|, on the host."""
    maxlag = int(0.75 * fs)
    acf_r = mean_acf_per_channel(np.asarray(real), maxlag)
    acf_f = mean_acf_per_channel(np.asarray(fake), maxlag)
    return float(np.mean(np.abs(acf_r - acf_f)))


def corr_difference(real, fake, device: torch.device | str = "cuda") -> float:
    """mean |Δ inter-channel Pearson correlation| (the "coherence" proxy)."""
    corr_r = channel_corrcoef(torch.as_tensor(real, device=device))
    corr_f = channel_corrcoef(torch.as_tensor(fake, device=device))
    return float(torch.mean(torch.abs(corr_r - corr_f)))


def statistical_similarity(real: np.ndarray, fake: np.ndarray, fs: float = 128.0,
                           device: torch.device | str = "cuda"):
    """(psd_diff, acf_diff, coh_diff) of (N, T, C) real and fake corpora."""
    return (psd_difference(real, fake, fs, device=device),
            acf_difference(real, fake, fs),
            corr_difference(real, fake, device=device))
