"""Log-PSD features for the CGAN eval family.

Counterpart of ``eegsynth/eval/features.py``: the rFFT power of each
channel, log, pooled to ``n_bins`` frequency bins, computed with
``torch.fft.rfft`` in float32 on the caller's device.
"""

from __future__ import annotations

import numpy as np
import torch


def psd_features_tensor(X, n_bins: int = 64, eps: float = 1e-6, *,
                        device: torch.device | str) -> torch.Tensor:
    """(N, C, T) → (N, C·n_bins) float32 tensor on ``device``: rFFT power /
    (T/2), log, then the frequency axis mean-pooled to ``n_bins`` (groups of
    ``bins // n_bins``, the rest dropped) when there are more bins, else
    edge-padded to ``n_bins``; NaN and ±inf become 0."""
    x = torch.as_tensor(np.asarray(X, dtype=np.float32), device=device)
    N, C, T = x.shape
    F = torch.fft.rfft(x, dim=2)
    P = (F.real ** 2 + F.imag ** 2) / (T / 2.0 + 1e-8)
    P = torch.log(P + eps)
    n_freq = P.shape[2]
    if n_bins < n_freq:
        pool = n_freq // n_bins
        P = P[:, :, :pool * n_bins].reshape(N, C, n_bins, pool).mean(-1)
    elif n_bins > n_freq:
        P = torch.cat([P, P[:, :, -1:].expand(N, C, n_bins - n_freq)], dim=2)
    return torch.nan_to_num(P.reshape(N, C * n_bins), nan=0.0, posinf=0.0,
                            neginf=0.0)


def psd_features(X, n_bins: int = 64, eps: float = 1e-6, *,
                 device: torch.device | str) -> np.ndarray:
    """:func:`psd_features_tensor` as a float32 numpy array."""
    return psd_features_tensor(X, n_bins, eps, device=device).cpu().numpy()
