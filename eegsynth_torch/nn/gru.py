"""GRU layers on the port's own recurrence, with torch.nn.GRU's parameter names.

Counterpart of ``eegsynth/nn/gru.py``. The input projection ``x @ W_ihᵀ + b_ih``
has no sequential dependency, so it is hoisted out of the recurrence as one
batched ``torch.matmul`` over all T; only the small h-recurrence runs step by
step. Gate math follows the PyTorch GRU definition (gate order r, z, n; reset
gate applied to the projected hidden branch). The recurrence is never
``torch.nn.GRU``: on CUDA that is cuDNN.

Two recurrences, picked by ``impl``:

- ``"kernel"`` (default): :func:`eegsynth_torch.nn.gru_sequence.gru_sequence`,
  kernel K1 forward and backward on the card, first-order differentiable.
- ``"plain"``: the plain PyTorch loop, differentiable twice by autograd. The
  counterpart of JAX's ``impl="xla"``, used only by the discriminator, because
  R1 differentiates through it twice (``eegsynth/train/timegan.py:135-143``).
  It is a path of its own, not a fallback for K1, and never touches K1's
  launch counters.

A half-precision layer (bfloat16 synthesis) projects its input in its own
dtype and runs the recurrence in float32 (:func:`gru_recurrence`), so K1
only ever sees float32.

Weights may carry leading axes (the stacked buckets of the multi-bucket
trainer, ``nb`` first); inputs then carry the same leading axes.
"""

from __future__ import annotations

from typing import NamedTuple

import torch
from torch import nn

from eegsynth_torch.nn.gru_sequence import gru_sequence, gru_sequence_reference
from eegsynth_torch.nn.layers import linear, xavier_uniform


class GRULayer(NamedTuple):
    """One layer's weights, PyTorch layout: w_ih (…, 3H, in), w_hh (…, 3H, H),
    b_ih / b_hh (…, 3H), with optional leading (bucket) axes."""
    w_ih: torch.Tensor
    w_hh: torch.Tensor
    b_ih: torch.Tensor
    b_hh: torch.Tensor


_HALF_DTYPES = (torch.bfloat16, torch.float16)


def gru_recurrence(layer: GRULayer, x: torch.Tensor, h0: torch.Tensor,
                   impl: str = "kernel") -> torch.Tensor:
    """Time-major layer: x (…, T, B, in), h0 (…, B, H) → ys (…, T, B, H).

    The input projection runs in the layer's dtype. A half-precision
    layer's recurrence runs in float32: its xp, W_hh, b_hh and h0 are cast
    to float32 (the rule of the JAX ``gru_apply_pallas`` for half-precision
    callers of the GRU kernel), so K1 only ever sees float32, and ys stays
    float32 for callers that carry its last row. Other dtypes (float32, and
    the float64 of gradient checks) run as they come."""
    xp = linear(x, layer.w_ih, layer.b_ih)                      # (…, T, B, 3H)
    w_hh_t = layer.w_hh.transpose(-1, -2)
    b_hh = layer.b_hh.unsqueeze(-2)
    if xp.dtype in _HALF_DTYPES:
        xp, w_hh_t, b_hh = xp.float(), w_hh_t.float(), b_hh.float()
    h0 = h0.to(xp.dtype)
    if impl == "plain":
        return gru_sequence_reference(xp, w_hh_t, b_hh, h0)
    if impl != "kernel":
        raise ValueError(f"impl must be 'kernel' or 'plain', got {impl!r}")
    return gru_sequence(xp.contiguous(), w_hh_t.contiguous(), b_hh.contiguous(),
                        h0.contiguous())


def gru_apply_time_major(layer: GRULayer, x: torch.Tensor, h0: torch.Tensor,
                         impl: str = "kernel") -> torch.Tensor:
    """Time-major layer: x (…, T, B, in), h0 (…, B, H) → ys (…, T, B, H) in
    x's dtype; a half-precision layer runs :func:`gru_recurrence` in float32
    and casts ys back."""
    return gru_recurrence(layer, x, h0, impl).to(x.dtype)


def gru_apply(layer: GRULayer, x: torch.Tensor, h0: torch.Tensor | None = None,
              impl: str = "kernel") -> torch.Tensor:
    """Run one GRU layer over a batch-first sequence: x (…, B, T, in) → (…, B, T, H)."""
    if h0 is None:
        h0 = x.new_zeros((*x.shape[:-2], layer.w_hh.shape[-1]))
    ys = gru_apply_time_major(layer, x.transpose(-3, -2), h0, impl)
    return ys.transpose(-3, -2)


class GRU(nn.Module):
    """``num_layers`` GRU layers named as torch.nn.GRU names them
    (``weight_ih_l0``, ``weight_hh_l0``, ``bias_ih_l0``, ``bias_hh_l0``, …).
    Xavier-uniform weights / zero biases (reference init)."""

    def __init__(self, input_dim: int, hidden_dim: int, num_layers: int = 1, *,
                 generator: torch.Generator, device: torch.device | str):
        super().__init__()
        self.num_layers = num_layers
        for k in range(num_layers):
            in_dim = input_dim if k == 0 else hidden_dim
            for name, shape in ((f"weight_ih_l{k}", (3 * hidden_dim, in_dim)),
                                (f"weight_hh_l{k}", (3 * hidden_dim, hidden_dim))):
                setattr(self, name, nn.Parameter(
                    xavier_uniform(shape, generator).to(device)))
            for name in (f"bias_ih_l{k}", f"bias_hh_l{k}"):
                setattr(self, name, nn.Parameter(
                    torch.zeros(3 * hidden_dim, device=device)))

    def layer(self, k: int) -> GRULayer:
        return GRULayer(getattr(self, f"weight_ih_l{k}"),
                        getattr(self, f"weight_hh_l{k}"),
                        getattr(self, f"bias_ih_l{k}"),
                        getattr(self, f"bias_hh_l{k}"))

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        """x (B, T, in) → (B, T, H), every layer from a zero state."""
        for k in range(self.num_layers):
            x = gru_apply(self.layer(k), x)
        return x


class GRUStack(nn.Module):
    """The reference's GRU wrapper (``<net>.rnn``) around the layers
    (``<net>.rnn.rnn``). Inter-layer dropout never applies here: the module
    serves trained weights. The trainers apply it on the params tree
    (``models.timegan._run_gru``), with masks they draw."""

    def __init__(self, input_dim: int, hidden_dim: int, num_layers: int = 1, *,
                 generator: torch.Generator, device: torch.device | str):
        super().__init__()
        self.rnn = GRU(input_dim, hidden_dim, num_layers,
                       generator=generator, device=device)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return self.rnn(x)
