"""1-D convolutions with torch's default init, and their spectral-norm form.

Counterpart of ``eegsynth/nn/conv.py``, for the conv CGAN: nearest ×2
upsampling then Conv1d(k3, p1) in the generator's blocks, strided
spectral-norm Conv1d(k4, s2, p1) in the discriminators. Inputs are NCW and
weights OIW, the layout of both packages. The convolutions are
``torch.nn.functional.conv1d`` (cuDNN on the card, TF32 off): the JAX
package lowers them through XLA, outside any Pallas kernel.
"""

from __future__ import annotations

import math

import torch
import torch.nn.functional as F

from eegsynth_torch.nn.spectral_norm import _l2_normalize, spectral_normalize


def _torch_conv_init(generator: torch.Generator, out_ch: int, in_ch: int,
                     k: int) -> dict:
    """torch Conv1d's default: weight and bias both U(±1/√(in_ch·k)), drawn
    on the generator's device."""
    bound = 1.0 / math.sqrt(in_ch * k)
    kw = {"device": generator.device}
    w = torch.empty((out_ch, in_ch, k), **kw).uniform_(-bound, bound, generator=generator)
    b = torch.empty((out_ch,), **kw).uniform_(-bound, bound, generator=generator)
    return {"w": w, "b": b}


def conv1d_init(generator: torch.Generator, in_ch: int, out_ch: int, k: int) -> dict:
    return _torch_conv_init(generator, out_ch, in_ch, k)


def conv1d_apply(params: dict, x: torch.Tensor, stride: int = 1,
                 padding: int = 0) -> torch.Tensor:
    """x (B, C_in, L) → (B, C_out, L'); the bias is added after the
    convolution, as the JAX package does."""
    y = F.conv1d(x, params["w"], stride=stride, padding=padding)
    return y + params["b"][None, :, None]


def sn_conv1d_init(generator: torch.Generator, in_ch: int, out_ch: int,
                   k: int) -> dict:
    """A spectral-norm conv: the power iteration runs on the kernel reshaped
    to (out, in·k), so ``u`` has length ``out_ch``."""
    p = _torch_conv_init(generator, out_ch, in_ch, k)
    p["u"] = _l2_normalize(torch.randn((out_ch,), generator=generator,
                                       device=generator.device))
    return p


def sn_conv1d_apply(params: dict, x: torch.Tensor, stride: int = 1,
                    padding: int = 0, train: bool = True,
                    compute_dtype: torch.dtype | None = None):
    """(y, params with ``u`` advanced in train mode, kept in eval mode).

    The power iteration and ``u`` stay in the parameter dtype; a
    ``compute_dtype`` (bfloat16) casts the normalised weight, the bias and
    ``x`` after it and runs the convolution in that dtype."""
    w = params["w"]
    w_sn, u_new = spectral_normalize(w.reshape(w.shape[0], -1), params["u"])
    w_sn, b = w_sn.reshape(w.shape), params["b"]
    if compute_dtype is not None:
        w_sn, b, x = w_sn.to(compute_dtype), b.to(compute_dtype), x.to(compute_dtype)
    y = F.conv1d(x, w_sn, stride=stride, padding=padding) + b[None, :, None]
    return y, {**params, "u": u_new if train else params["u"]}


def upsample_nearest_2x(x: torch.Tensor) -> torch.Tensor:
    """nn.Upsample(scale_factor=2, mode="nearest") on (B, C, L)."""
    return x.repeat_interleave(2, dim=-1)
