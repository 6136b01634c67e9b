"""Dense layer + initializers (PyTorch-parity xavier_uniform and nn.Linear's
default).

Counterpart of ``eegsynth/nn/layers.py``. Weights are drawn on the host from
the caller's ``torch.Generator`` and then moved to ``device``, so one seed
gives the same weights on every device.
"""

from __future__ import annotations

import math

import torch
from torch import nn


def xavier_uniform(shape: tuple[int, ...], generator: torch.Generator,
                   dtype=torch.float32) -> torch.Tensor:
    """torch.nn.init.xavier_uniform_ semantics: fan_in/fan_out from the last two
    dims as (out, in), bound sqrt(6/(fan_in+fan_out)). Drawn on the generator's
    device."""
    fan_out, fan_in = shape[-2], shape[-1]
    bound = math.sqrt(6.0 / (fan_in + fan_out))
    out = torch.empty(shape, dtype=dtype, device=generator.device)
    return out.uniform_(-bound, bound, generator=generator)


def torch_dense_init(in_dim: int, out_dim: int, generator: torch.Generator,
                     dtype=torch.float32) -> dict[str, torch.Tensor]:
    """torch.nn.Linear's default init (kaiming_uniform with a = √5): weight
    (out, in) and bias (out,) both ~ U(±1/√in_dim), as the JAX package's
    ``torch_dense_init``. Drawn on the generator's device."""
    bound = 1.0 / math.sqrt(in_dim)
    kw = {"dtype": dtype, "device": generator.device}
    w = torch.empty((out_dim, in_dim), **kw).uniform_(-bound, bound, generator=generator)
    b = torch.empty((out_dim,), **kw).uniform_(-bound, bound, generator=generator)
    return {"w": w, "b": b}


def linear(x: torch.Tensor, w: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """``x @ wᵀ + b`` for w (…, out, in), b (…, out) and x (…, *, in), where
    the leading axes of ``w`` (stacked buckets) lead ``x`` too: one batched
    product over every bucket."""
    lead = w.shape[:-2]
    flat = x.reshape(*lead, -1, x.shape[-1])
    y = torch.matmul(flat, w.transpose(-1, -2)) + b.unsqueeze(-2)
    return y.reshape(*x.shape[:-1], w.shape[-2])


class Dense(nn.Module):
    """Linear layer, torch layout ``weight`` (out, in) and ``bias`` (out,);
    xavier-uniform weight + zero bias (reference init)."""

    def __init__(self, in_dim: int, out_dim: int, *, generator: torch.Generator,
                 device: torch.device | str):
        super().__init__()
        self.weight = nn.Parameter(
            xavier_uniform((out_dim, in_dim), generator).to(device))
        self.bias = nn.Parameter(torch.zeros(out_dim, device=device))

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return linear(x, self.weight, self.bias)
