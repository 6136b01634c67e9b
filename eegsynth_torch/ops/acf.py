"""Autocorrelation statistics: the TimeGAN ACF loss's and the evaluation's.

Counterpart of ``eegsynth/ops/acf.py`` (``acf_per_channel``,
``pearson_lag_corrs``, ``_pearson_lag_corrs_np64``,
``mean_acf_per_channel``). The evaluation's statistic runs on the host in
numpy float64, as the JAX package's does.
"""

from __future__ import annotations

import numpy as np
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


def pearson_lag_corrs(x: torch.Tensor, max_lag: int) -> torch.Tensor:
    """Pearson correlation of (x[:-lag], x[lag:]) for lags 1..max_lag: x (…, T)
    → (…, min(max_lag, T - 1)), ``np.corrcoef(x[:-lag], x[lag:])[0, 1]`` by
    one FFT cross-correlation and prefix sums. Computes in float32 at least,
    each sequence centred first (Pearson is shift-invariant, and centring
    removes the cancellation of E[x²] − m² when the mean dwarfs the std)."""
    T = x.shape[-1]
    L = min(max_lag, T - 1)
    xd = x.to(torch.promote_types(x.dtype, torch.float32))
    xd = xd - xd.mean(dim=-1, keepdim=True)

    spec = torch.fft.rfft(xd, n=2 * T, dim=-1)
    cross = torch.fft.irfft(spec * spec.conj(), n=2 * T, dim=-1)[..., 1:L + 1]

    csum = torch.cumsum(xd, dim=-1)
    csum2 = torch.cumsum(xd * xd, dim=-1)
    total, total2 = csum[..., -1:], csum2[..., -1:]
    n = (T - torch.arange(1, L + 1, device=x.device)).to(xd.dtype)
    # head segment x[:T-lag] sums at cumsum indices T-2 .. T-1-L (reversed);
    # tail segment x[lag:] sums are total - cumsum[0 .. L-1]
    sum_a = torch.flip(csum[..., T - 1 - L: T - 1], dims=(-1,))
    sum_a2 = torch.flip(csum2[..., T - 1 - L: T - 1], dims=(-1,))
    sum_b = total - csum[..., 0:L]
    sum_b2 = total2 - csum2[..., 0:L]

    ma, mb = sum_a / n, sum_b / n
    cov = cross / n - ma * mb
    var_a = sum_a2 / n - ma * ma
    var_b = sum_b2 / n - mb * mb
    den = torch.sqrt(var_a.clamp(min=0.0) * var_b.clamp(min=0.0))
    return (cov / (den + 1e-12)).to(x.dtype)


def _pearson_lag_corrs_np64(xt, max_lag: int) -> np.ndarray:
    """Host float64 twin of :func:`pearson_lag_corrs` in numpy. The eval
    statistic needs float64: a sequence whose head or tail segment is nearly
    constant against its mean cancels catastrophically in float32's
    per-segment moments, which no global centring fixes."""
    xt = np.asarray(xt, np.float64)
    T = xt.shape[-1]
    L = min(max_lag, T - 1)
    xd = xt - xt.mean(axis=-1, keepdims=True)
    spec = np.fft.rfft(xd, n=2 * T, axis=-1)
    cross = np.fft.irfft(spec * np.conj(spec), n=2 * T, axis=-1)[..., 1:L + 1]
    csum = np.cumsum(xd, axis=-1)
    csum2 = np.cumsum(xd * xd, axis=-1)
    total, total2 = csum[..., -1:], csum2[..., -1:]
    n = (T - np.arange(1, L + 1)).astype(np.float64)
    sum_a = csum[..., T - 1 - L: T - 1][..., ::-1]
    sum_a2 = csum2[..., T - 1 - L: T - 1][..., ::-1]
    sum_b = total - csum[..., 0:L]
    sum_b2 = total2 - csum2[..., 0:L]
    ma, mb = sum_a / n, sum_b / n
    cov = cross / n - ma * mb
    var_a = sum_a2 / n - ma * ma
    var_b = sum_b2 / n - mb * mb
    den = np.sqrt(np.maximum(var_a, 0.0) * np.maximum(var_b, 0.0))
    return cov / (den + 1e-12)


def mean_acf_per_channel(x, max_lag: int) -> np.ndarray:
    """The eval's ACF feature: per channel, the mean over sequences of the
    mean lag-1..max_lag Pearson autocorrelation. x (B, T, C) → (C,) numpy
    float64, on the host. A sequence whose std (ddof 0), taken in ``x``'s
    own dtype, is under 1e-8 contributes 0.0."""
    xt = np.moveaxis(np.asarray(x), 1, -1)                    # (B, C, T)
    corr = _pearson_lag_corrs_np64(xt, max_lag)               # (B, C, L)
    val = corr.mean(axis=-1)                                  # (B, C)
    val = np.where(xt.std(axis=-1) < 1e-8, 0.0, val)
    return val.mean(axis=0)
