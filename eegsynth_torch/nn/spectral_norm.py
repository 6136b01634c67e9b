"""Spectral-norm dense layer with an explicit power-iteration vector ``u``.

Counterpart of ``eegsynth/nn/spectral_norm.py``, with torch.nn.utils'
parameter names (``weight_orig``, ``bias``, buffer ``weight_u``). Forward
only, with the reference's eval semantics, not torch's: torch caches ``v``
and computes ``sigma = u·W·v_stored``; here ``v = normalize(Wᵀu)`` is
re-derived on every forward and never stored, and ``u`` does not move.
"""

from __future__ import annotations

import torch
from torch import nn

from eegsynth_torch.nn.layers import xavier_uniform


def _l2_normalize(v: torch.Tensor, eps: float = 1e-12) -> torch.Tensor:
    return v / (torch.linalg.vector_norm(v) + eps)


def spectral_normalize(w2d: torch.Tensor, u: torch.Tensor):
    """Return (w / sigma, new_u) for a 2-D weight (out, in):
    v = normalize(Wᵀu); u' = normalize(W v); sigma = u'ᵀ W v."""
    with torch.no_grad():   # u, v are buffers in torch: no gradient through them
        v = _l2_normalize(torch.matmul(w2d.t(), u))
        u_new = _l2_normalize(torch.matmul(w2d, v))
    sigma = torch.dot(u_new, torch.matmul(w2d, v))
    return w2d / sigma, u_new


class SNDense(nn.Module):
    """Spectrally-normalized linear layer (discriminator head)."""

    def __init__(self, in_dim: int, out_dim: int, *, generator: torch.Generator,
                 device: torch.device | str):
        super().__init__()
        self.weight_orig = nn.Parameter(
            xavier_uniform((out_dim, in_dim), generator).to(device))
        self.bias = nn.Parameter(torch.zeros(out_dim, device=device))
        u = torch.randn(out_dim, generator=generator, device=generator.device)
        self.register_buffer("weight_u", _l2_normalize(u).to(device))

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        w_sn, _ = spectral_normalize(self.weight_orig, self.weight_u)
        return torch.matmul(x, w_sn.t()) + self.bias
