"""Spectral-norm dense layer with an explicit power-iteration vector ``u``.

Counterpart of ``eegsynth/nn/spectral_norm.py``, with torch.nn.utils'
parameter names (``weight_orig``, ``bias``, buffer ``weight_u``). The
reference's semantics, not torch's:

- train (:func:`sn_dense_apply` with ``train=True``): one power iteration per
  forward, and the new ``u`` is returned for the caller to keep, as torch's
  hook does in train mode;
- eval: torch caches ``v`` and computes ``sigma = u·W·v_stored``; here
  ``v = normalize(Wᵀu)`` is re-derived on every forward and never stored, and
  ``u`` does not move.

Weights may carry leading (bucket) axes: w (…, out, in), u (…, out), one
power iteration per bucket.
"""

from __future__ import annotations

import torch
from torch import nn

from eegsynth_torch.nn.layers import linear, xavier_uniform


def _l2_normalize(v: torch.Tensor, eps: float = 1e-12) -> torch.Tensor:
    return v / (torch.linalg.vector_norm(v, dim=-1, keepdim=True) + eps)


def spectral_normalize(w: torch.Tensor, u: torch.Tensor):
    """Return (w / sigma, new_u) for a weight (…, out, in):
    v = normalize(Wᵀu); u' = normalize(W v); sigma = u'ᵀ W v."""
    with torch.no_grad():   # u, v are buffers in torch: no gradient through them
        v = _l2_normalize(torch.matmul(w.transpose(-1, -2),
                                       u.unsqueeze(-1)).squeeze(-1))
        u_new = _l2_normalize(torch.matmul(w, v.unsqueeze(-1)).squeeze(-1))
    sigma = (u_new * torch.matmul(w, v.unsqueeze(-1)).squeeze(-1)).sum(-1)
    return w / sigma[..., None, None], u_new


def sn_dense_apply(params: dict, x: torch.Tensor, train: bool = True):
    """``params`` {"w", "b", "u"} (the JAX package's tree): returns
    (y, u_out), u_out the advanced vector in train mode and ``u`` itself in
    eval mode (``sn_dense_apply``)."""
    w_sn, u_new = spectral_normalize(params["w"], params["u"])
    return linear(x, w_sn, params["b"]), (u_new if train else params["u"])


class SNDense(nn.Module):
    """Spectrally-normalized linear layer (discriminator head), eval mode."""

    def __init__(self, in_dim: int, out_dim: int, *, generator: torch.Generator,
                 device: torch.device | str):
        super().__init__()
        self.weight_orig = nn.Parameter(
            xavier_uniform((out_dim, in_dim), generator).to(device))
        self.bias = nn.Parameter(torch.zeros(out_dim, device=device))
        u = torch.randn(out_dim, generator=generator, device=generator.device)
        self.register_buffer("weight_u", _l2_normalize(u).to(device))

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return sn_dense_apply({"w": self.weight_orig, "b": self.bias,
                               "u": self.weight_u}, x, train=False)[0]
