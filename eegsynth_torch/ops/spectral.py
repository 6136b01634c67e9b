"""Spectral helpers of the CGAN losses.

Counterpart of ``rfft_power`` in ``eegsynth/ops/spectral.py``. The Welch PSD
of the evaluation is ported with the eval functions.
"""

from __future__ import annotations

import torch


def rfft_power(x: torch.Tensor, dim: int = -2) -> torch.Tensor:
    """Un-windowed rFFT power ``re² + im²`` along ``dim``."""
    spec = torch.fft.rfft(x, dim=dim)
    return spec.real ** 2 + spec.imag ** 2
