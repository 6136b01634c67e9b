"""Covariance / correlation primitives used by the TimeGAN and CGAN losses.

Counterpart of ``eegsynth/ops/stats.py`` (``channel_cov``,
``channel_corrcoef``, ``per_sample_channel_cov``). The TimeGAN statistics
take leading (bucket) axes: x (…, B, T, C).
"""

from __future__ import annotations

import torch


def channel_cov(x: torch.Tensor) -> torch.Tensor:
    """Channel covariance over the flattened (B·T, C) samples, ddof=1 — the
    TimeGAN covariance-loss statistic. x (…, B, T, C) → (…, C, C)."""
    B, T, C = x.shape[-3:]
    X = x.reshape(*x.shape[:-3], B * T, C)
    X = X - X.mean(dim=-2, keepdim=True)
    return torch.matmul(X.transpose(-1, -2), X) / (B * T - 1)


def channel_corrcoef(x: torch.Tensor) -> torch.Tensor:
    """np.corrcoef(rowvar=False) of the flattened samples. x (…, B, T, C) →
    (…, C, C)."""
    cov = channel_cov(x)
    d = torch.sqrt(torch.diagonal(cov, dim1=-2, dim2=-1))
    return cov / (d.unsqueeze(-1) * d.unsqueeze(-2))


def per_sample_channel_cov(x: torch.Tensor) -> torch.Tensor:
    """Per-sample channel covariance over time (ddof=1), batch-meaned — the
    CGAN channel-covariance loss statistic. x (B, C, T) → (C, C)."""
    xc = x - x.mean(dim=-1, keepdim=True)
    cov = torch.matmul(xc, xc.transpose(-1, -2)) / (x.shape[-1] - 1)
    return cov.mean(dim=0)
