"""TimeGAN losses, matched to the JAX package's formulas.

Counterpart of ``eegsynth/losses/timegan.py``. Every loss reduces over its
sample axes and keeps any leading (bucket) axes, so one call scores all
stacked buckets: x (…, B, T, C) → (…). Randomness is passed in: the label
uniforms and the instance-noise normals are arguments, drawn by the caller.
``recon_loss`` and ``sup_loss`` take the per-sample weight masks (…, B) of the
sequential trainer's padded epochs.
"""

from __future__ import annotations

import torch

from eegsynth_torch.ops.acf import acf_per_channel
from eegsynth_torch.ops.stats import channel_cov


def sample_mean(se: torch.Tensor,
                weight: torch.Tensor | None = None) -> torch.Tensor:
    """Mean of se (…, B, T, C) over (B, T, C); with a per-sample weight
    (…, B), ``sum(se·w) / (sum(w)·T·C)``, so padded rows of weight 0 drop
    out."""
    if weight is None:
        return se.mean(dim=(-3, -2, -1))
    w = weight[..., None, None]
    return ((se * w).sum(dim=(-3, -2, -1))
            / (weight.sum(dim=-1) * se.shape[-2] * se.shape[-1]))


def recon_loss(x: torch.Tensor, x_tilde: torch.Tensor, eps: float = 1e-8,
               weight: torch.Tensor | None = None) -> torch.Tensor:
    """10·sqrt(MSE + eps) over (B, T, C), weighted per sample if given."""
    return 10.0 * torch.sqrt(sample_mean((x - x_tilde) ** 2, weight) + eps)


def sup_loss(h: torch.Tensor, weight: torch.Tensor | None = None) -> torch.Tensor:
    """Mean squared one-step latent difference over (B, T-1, z), weighted per
    sample if given."""
    return sample_mean((h[..., 1:, :] - h[..., :-1, :]) ** 2, weight)


def bce(p: torch.Tensor, y: torch.Tensor) -> torch.Tensor:
    """torch.nn.BCELoss on probabilities (…, B, 1), log clamped at -100, mean
    over (B, 1)."""
    logp = torch.clamp(torch.log(p), min=-100.0)
    log1mp = torch.clamp(torch.log1p(-p), min=-100.0)
    return (-(y * logp + (1.0 - y) * log1mp)).mean(dim=(-2, -1))


def smooth_labels(u_real: torch.Tensor, u_fake: torch.Tensor,
                  smooth: float) -> tuple[torch.Tensor, torch.Tensor]:
    """real ∈ [1−s, 1], fake ∈ [0, s] from given U[0,1) draws (…, B, 1)."""
    return (1.0 - smooth) + smooth * u_real, smooth * u_fake


def add_instance_noise(h: torch.Tensor, eps: torch.Tensor,
                       std: float) -> torch.Tensor:
    """Gaussian instance noise ``h + std·eps`` from given standard normals."""
    return h + std * eps


def cov_loss(x_fake: torch.Tensor, x_real: torch.Tensor) -> torch.Tensor:
    """Frobenius norm of the channel-covariance difference / sqrt(C·C); the
    real side carries no gradient."""
    cov_r = channel_cov(x_real).detach()
    cov_g = channel_cov(x_fake)
    C = cov_r.shape[-1]
    return torch.linalg.matrix_norm(cov_g - cov_r, ord="fro") / (C * C) ** 0.5


def acf_loss(x_fake: torch.Tensor, x_real: torch.Tensor,
             max_lag: int) -> torch.Tensor:
    """Mean |Δ autocorrelation| over lags × channels."""
    acf_g = acf_per_channel(x_fake, max_lag)
    acf_r = acf_per_channel(x_real, max_lag).detach()
    return (acf_g - acf_r).abs().mean(dim=(-2, -1))


def throttle_scale(acc: torch.Tensor, target_acc: float,
                   band: float) -> torch.Tensor:
    """Soft D throttle in [0.2, 1]: 1 near the target accuracy, 0.2 when D is
    far too strong. Carries no gradient (the accuracy has none)."""
    over = torch.clamp(acc - target_acc, min=0.0)
    return torch.clamp(1.0 - over / band, min=0.2)
