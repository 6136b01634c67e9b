"""Autocorrelation statistic of the TimeGAN ACF loss.

Counterpart of ``acf_per_channel`` in ``eegsynth/ops/acf.py``. The eval-only
host float64 functions (``pearson_lag_corrs``, ``mean_acf_per_channel``) come
with the eval slice.
"""

from __future__ import annotations

import torch

DIRECT_MAX_LAG = 96
"""Up to this many lags the statistic is direct slice products; above, one FFT."""


def acf_per_channel(x: torch.Tensor, max_lag: int) -> torch.Tensor:
    """Globally z-normed lag correlations. x (…, B, T, C) → (…, L, C).

    z-norm over (B, T) per channel with the unbiased std (ddof = 1) + 1e-8,
    then for each lag ``mean_{B,T-lag}(xz[:, :-lag] * xz[:, lag:])``. Direct
    slice products for up to 96 lags (the training regime); one 2T-point FFT
    autocorrelation above that."""
    B, T, C = x.shape[-3:]
    max_lag = max(1, min(max_lag, T - 1))
    xm = x.mean(dim=(-3, -2), keepdim=True)
    xs = x.std(dim=(-3, -2), correction=1, keepdim=True) + 1e-8
    xz = (x - xm) / xs                                          # (…, B, T, C)

    if max_lag <= DIRECT_MAX_LAG:
        cols = [(xz[..., :T - lag, :] * xz[..., lag:, :]).sum(dim=(-3, -2))
                / (B * (T - lag)) for lag in range(1, max_lag + 1)]
        return torch.stack(cols, dim=-2)                        # (…, L, C)

    xzt = xz.transpose(-1, -2)                                  # (…, B, C, T)
    spec = torch.fft.rfft(xzt, n=2 * T, dim=-1)
    cross = torch.fft.irfft(spec * spec.conj(), n=2 * T, dim=-1)[..., :T]
    # cross[..., lag] = sum_t xz[t] * xz[t + lag]
    lags = torch.arange(1, max_lag + 1, device=x.device)
    counts = (B * (T - lags)).to(x.dtype)                       # (L,)
    corr = cross[..., 1:max_lag + 1].sum(dim=-3) / counts       # (…, C, L)
    return corr.transpose(-1, -2)
