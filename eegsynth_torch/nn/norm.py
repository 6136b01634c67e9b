"""Class-conditional batch normalisation with explicit running statistics.

Counterpart of ``eegsynth/nn/norm.py``: an affine-free BatchNorm1d whose γ
and β are the rows of a per-class embedding (γ initialised to 1, β to 0).
The running mean and variance are state passed in and returned, not module
buffers:

- train: normalise with the batch mean and biased variance over (B, L);
  the running variance moves toward the unbiased one, n/(n−1) with
  n = B·L, at momentum 0.1;
- eval: normalise with the running statistics, which stay as they are.

The new state carries no gradient.
"""

from __future__ import annotations

import torch


def cbn1d_init(num_features: int, num_classes: int, *,
               device: torch.device | str) -> dict:
    return {"embed": torch.cat([torch.ones((num_classes, num_features), device=device),
                                torch.zeros((num_classes, num_features), device=device)],
                               dim=1)}


def cbn1d_state_init(num_features: int, *, device: torch.device | str) -> dict:
    return {"mean": torch.zeros((num_features,), device=device),
            "var": torch.ones((num_features,), device=device)}


def cbn1d_apply(params: dict, state: dict, x: torch.Tensor, labels: torch.Tensor,
                train: bool = True, momentum: float = 0.1, eps: float = 1e-5):
    """x (B, C, L), labels (B,) → (y, new state)."""
    if train:
        mean = x.mean(dim=(0, 2))
        var = x.var(dim=(0, 2), unbiased=False)
        n = x.shape[0] * x.shape[2]
        with torch.no_grad():
            var_unbiased = var * n / max(1, n - 1)
            new_state = {"mean": (1 - momentum) * state["mean"] + momentum * mean,
                         "var": (1 - momentum) * state["var"] + momentum * var_unbiased}
    else:
        mean, var = state["mean"], state["var"]
        new_state = state
    h = (x - mean[None, :, None]) * torch.rsqrt(var[None, :, None] + eps)
    nf = x.shape[1]
    gb = params["embed"][labels.long()]                       # (B, 2C)
    gamma, beta = gb[:, :nf], gb[:, nf:]
    return gamma[:, :, None] * h + beta[:, :, None], new_state
