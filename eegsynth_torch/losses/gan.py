"""GAN objectives of the CGAN family.

Counterpart of ``eegsynth/losses/gan.py``: hinge, BCE and Wasserstein
losses, the WGAN-GP penalty, the ACGAN cross-entropy, feature matching and
the v2 amplitude calibration. The gradient penalty takes its interpolation
weights ε as an argument (randomness is passed in).
"""

from __future__ import annotations

from typing import Callable

import torch
import torch.nn.functional as F


def d_hinge(real_scores: torch.Tensor, fake_scores: torch.Tensor) -> torch.Tensor:
    """mean(relu(1 − s_r) + relu(1 + s_f))."""
    return torch.mean(F.relu(1.0 - real_scores) + F.relu(1.0 + fake_scores))


def g_hinge(fake_scores: torch.Tensor) -> torch.Tensor:
    return -torch.mean(fake_scores)


def d_bce(real_scores: torch.Tensor, fake_scores: torch.Tensor) -> torch.Tensor:
    """BCE-with-logits D loss, real → 1, fake → 0."""
    return torch.mean(F.softplus(-real_scores)) + torch.mean(F.softplus(fake_scores))


def g_bce(fake_scores: torch.Tensor) -> torch.Tensor:
    """Non-saturating BCE generator loss (fake → 1)."""
    return torch.mean(F.softplus(-fake_scores))


def d_wgan(real_scores: torch.Tensor, fake_scores: torch.Tensor) -> torch.Tensor:
    """Wasserstein critic loss (pair with :func:`gradient_penalty`)."""
    return torch.mean(fake_scores) - torch.mean(real_scores)


def g_wgan(fake_scores: torch.Tensor) -> torch.Tensor:
    return -torch.mean(fake_scores)


def gradient_penalty(score_fn: Callable[[torch.Tensor], torch.Tensor],
                     eps: torch.Tensor, real: torch.Tensor,
                     fake: torch.Tensor) -> torch.Tensor:
    """Two-sided WGAN-GP penalty E[(‖∇_x̂ D(x̂)‖₂ − 1)²] on the interpolates
    x̂ = ε·real + (1 − ε)·fake, with ε (B, 1, 1) passed in. The gradient flows
    to the critic's parameters inside ``score_fn``, not into real or fake."""
    x_hat = (eps * real.detach() + (1.0 - eps) * fake.detach()).requires_grad_()
    (g,) = torch.autograd.grad(score_fn(x_hat).sum(), x_hat, create_graph=True)
    norms = torch.sqrt(g.reshape(g.shape[0], -1).pow(2).sum(dim=1) + 1e-12)
    return torch.mean((norms - 1.0) ** 2)


def cross_entropy(logits: torch.Tensor, labels: torch.Tensor) -> torch.Tensor:
    """torch CrossEntropyLoss (mean reduction) for the ACGAN heads."""
    logp = torch.log_softmax(logits, dim=-1)
    return -torch.mean(logp.gather(-1, labels.long()[:, None])[:, 0])


def feature_matching(fake_feats: torch.Tensor, real_feats: torch.Tensor) -> torch.Tensor:
    """MSE between batch-mean D features, real side detached."""
    return torch.mean((fake_feats.mean(dim=0) - real_feats.mean(dim=0).detach()) ** 2)


def amp_calib_loss(real: torch.Tensor, fake: torch.Tensor) -> torch.Tensor:
    """L1 of per-channel mean + per-channel std (unbiased) over (B, T) — the
    v2 amplitude calibration. x (B, C, T)."""
    def stats(x):
        flat = x.transpose(0, 1).reshape(x.shape[1], -1)
        return flat.mean(dim=1), flat.std(dim=1, unbiased=True)

    mu_r, sd_r = stats(real)
    mu_f, sd_f = stats(fake)
    return torch.mean(torch.abs(mu_f - mu_r)) + torch.mean(torch.abs(sd_f - sd_r))
