"""Spectral structure losses of the CGAN generator.

Counterpart of ``eegsynth/losses/spectral.py``: ``psd_loss``,
``log_psd_loss``, ``coh_loss``, ``coh_loss_random``, ``cov_loss`` and
``posture_conditional_losses``. The random pair subset of
``coh_loss_random`` is passed in (randomness is passed in; draw it with
:func:`draw_coh_pairs`). ``posture_conditional_losses`` keeps the JAX
package's gating: a zero weight leaves its component out entirely.
"""

from __future__ import annotations

import itertools

import numpy as np
import torch
import torch.nn.functional as F

from eegsynth_torch.ops.spectral import rfft_power
from eegsynth_torch.ops.stats import per_sample_channel_cov

FIXED_PAIRS = np.array([(0, 13), (6, 7), (9, 10), (1, 12)])
"""AF3-AF4, O1-O2, T8-FC6, F7-F8."""

ALL_PAIRS = np.array(list(itertools.combinations(range(14), 2)))
"""All C(14, 2) = 91 channel pairs."""


def psd_loss(real: torch.Tensor, fake: torch.Tensor) -> torch.Tensor:
    """L1 of the batch-mean rFFT power, (B, C, T) → scalar."""
    P_r = rfft_power(real, dim=2).mean(dim=0)
    P_f = rfft_power(fake, dim=2).mean(dim=0)
    return torch.mean(torch.abs(P_f - P_r))


def _log_power(x: torch.Tensor, eps: float = 1e-6) -> torch.Tensor:
    p = rfft_power(x, dim=2) / (x.shape[2] / 2.0 + 1e-8)
    return torch.log(p + eps)


def log_psd_loss(real: torch.Tensor, fake: torch.Tensor, eps: float = 1e-6) -> torch.Tensor:
    """L1 of the batch mean and (biased) std of the log rFFT power."""
    lr, lf = _log_power(real, eps), _log_power(fake, eps)
    return (torch.mean(torch.abs(lf.mean(0) - lr.mean(0)))
            + torch.mean(torch.abs(lf.std(0, unbiased=False) - lr.std(0, unbiased=False))))


def _coherence(x: torch.Tensor, pairs: torch.Tensor) -> torch.Tensor:
    """Per-sample normalised cross-spectrum magnitude of each channel pair:
    |A·conj(B)| / sqrt(|A|²|B|² + 1e-8), (B, C, T) → (B, P, F).

    A bin that is exactly 0 (a constant stretch of a channel, or an FFT's
    exact cancellation, which the card's FFT produces in training) has
    |A·conj(B)| = 0, where sqrt's gradient is infinite: the JAX package's
    gradient is NaN there, and one such bin turns the whole generator NaN.
    Here the magnitude's gradient at 0 is 0, |z|'s subgradient; the value,
    and the gradient at every other bin, are the JAX package's."""
    spec = torch.fft.rfft(x, dim=2)
    A, Bc = spec[:, pairs[:, 0]], spec[:, pairs[:, 1]]
    cross = A * torch.conj(Bc)
    sq = cross.real ** 2 + cross.imag ** 2
    live = sq > 0
    num = torch.where(live, torch.sqrt(torch.where(live, sq, torch.ones_like(sq))),
                      torch.zeros_like(sq))
    den = torch.sqrt((A.real ** 2 + A.imag ** 2) * (Bc.real ** 2 + Bc.imag ** 2) + 1e-8)
    return num / den


def _pairs(pairs, device) -> torch.Tensor:
    """Channel pairs (P, 2) as int64 on ``device``: an array, or a tensor on
    any device (a drawn subset lives on the card)."""
    if isinstance(pairs, torch.Tensor):
        return pairs.to(device=device, dtype=torch.long)
    return torch.as_tensor(np.asarray(pairs), dtype=torch.long, device=device)


def coh_loss(real: torch.Tensor, fake: torch.Tensor, pairs) -> torch.Tensor:
    """Mean-over-pairs L1 difference of the batch-mean coherence."""
    pairs = _pairs(pairs, real.device)
    return torch.mean(torch.abs(_coherence(fake, pairs).mean(0)
                                - _coherence(real, pairs).mean(0)))


def draw_coh_pairs(generator: torch.Generator, num_pairs: int = 24, *,
                   device: torch.device | str) -> torch.Tensor:
    """``num_pairs`` distinct rows of :data:`ALL_PAIRS`, (P, 2) int64: the
    first entries of a random permutation, as the JAX package draws them."""
    perm = torch.randperm(len(ALL_PAIRS), generator=generator, device=device)
    return _pairs(ALL_PAIRS, device)[perm[:num_pairs]]


def coh_loss_random(pairs: torch.Tensor, real: torch.Tensor,
                    fake: torch.Tensor) -> torch.Tensor:
    """:func:`coh_loss` on a drawn subset of channel pairs (the v2 loss)."""
    return coh_loss(real, fake, pairs)


def cov_loss(real: torch.Tensor, fake: torch.Tensor) -> torch.Tensor:
    """MSE of the batch-mean per-sample channel covariance."""
    return torch.mean((per_sample_channel_cov(fake) - per_sample_channel_cov(real)) ** 2)


def posture_conditional_losses(real: torch.Tensor, fake: torch.Tensor,
                               labels: torch.Tensor, num_classes: int,
                               psd_w: float, coh_w: float, cov_w: float,
                               log_psd_w: float = 0.0) -> torch.Tensor:
    """PSD, coherence (the 4 fixed pairs), covariance and log-PSD losses per
    class present in the batch, averaged over those classes. Each class's
    statistics are weighted means over its rows; a weight of 0 leaves its
    component out."""
    if not any(w > 0 for w in (psd_w, coh_w, cov_w, log_psd_w)):
        return torch.zeros((), dtype=real.dtype, device=real.device)
    onehot = F.one_hot(labels.long(), num_classes).to(real.dtype)   # (B, K)
    counts = onehot.sum(dim=0)
    present = counts > 0
    n = torch.clamp(counts, min=1.0)

    def wmean(v):
        """(B, ...) → per-class weighted mean (K, ...)."""
        shape = (num_classes,) + (1,) * (v.dim() - 1)
        return torch.tensordot(onehot.T, v, dims=1) / n.reshape(shape)

    losses = torch.zeros((num_classes,), dtype=real.dtype, device=real.device)
    if psd_w > 0:
        d = wmean(rfft_power(fake, dim=2)) - wmean(rfft_power(real, dim=2))
        losses = losses + psd_w * d.abs().mean(dim=(1, 2))
    if log_psd_w > 0:
        def log_stats(x):
            lp = _log_power(x)
            m = wmean(lp)
            var = torch.clamp(wmean(lp * lp) - m * m, min=0.0)
            return m, torch.sqrt(var + 1e-12)
        mr, sr = log_stats(real)
        mf, sf = log_stats(fake)
        losses = losses + log_psd_w * ((mf - mr).abs().mean(dim=(1, 2))
                                       + (sf - sr).abs().mean(dim=(1, 2)))
    if coh_w > 0:
        pairs = _pairs(FIXED_PAIRS, real.device)
        d = wmean(_coherence(fake, pairs)) - wmean(_coherence(real, pairs))
        losses = losses + coh_w * d.abs().mean(dim=(1, 2))
    if cov_w > 0:
        def cov(x):
            xc = x - x.mean(dim=2, keepdim=True)
            return torch.matmul(xc, xc.transpose(1, 2)) / (x.shape[2] - 1)
        d = wmean(cov(fake)) - wmean(cov(real))
        losses = losses + cov_w * (d ** 2).mean(dim=(1, 2))
    n_present = torch.clamp(present.to(real.dtype).sum(), min=1.0)
    return torch.where(present, losses, torch.zeros_like(losses)).sum() / n_present
