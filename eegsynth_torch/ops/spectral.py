"""Spectral helpers: the Welch PSD of the evaluation and the CGAN losses' rFFT
power.

Counterpart of ``eegsynth/ops/spectral.py`` (``hann_periodic``,
``welch_psd``, ``trapezoid``, ``rfft_power``), plus the two scipy.signal
calls of the preprocessing-stage figures: ``spectrogram`` (its defaults)
and ``resample`` (its FFT method). Everything computes in the input's
dtype, on the input's device.
"""

from __future__ import annotations

import numpy as np
import torch


def hann_periodic(n: int, dtype=torch.float64, device=None) -> torch.Tensor:
    """Periodic Hann window: scipy.signal.get_window('hann', n), fftbins=True.
    Computed in float64 on the host, then cast."""
    k = np.arange(n)
    w = 0.5 - 0.5 * np.cos(2.0 * np.pi * k / n)
    return torch.as_tensor(w, dtype=dtype, device=device)


def welch_psd(x: torch.Tensor, fs: float = 128.0, nperseg: int = 256,
              noverlap: int | None = None, detrend: str | None = "constant",
              axis: int = -1) -> tuple[torch.Tensor, torch.Tensor]:
    """Welch power spectral density with scipy.signal.welch's defaults.

    Periodic Hann window, ``noverlap = nperseg // 2``, ``nperseg = min(nperseg,
    T)``, constant detrend per segment, density scaling, one-sided doubling
    (except DC and the even-length Nyquist bin), the mean over segments.
    Returns ``(freqs, psd)``, ``psd`` with the time axis replaced in place by
    the frequency bins."""
    x = x.movedim(axis, -1)
    T = x.shape[-1]
    nperseg = min(nperseg, T)
    if noverlap is None:
        noverlap = nperseg // 2
    segs = x.unfold(-1, nperseg, nperseg - noverlap)        # (..., n_seg, nperseg)
    if detrend == "constant":
        segs = segs - segs.mean(dim=-1, keepdim=True)
    elif detrend:  # don't silently skip e.g. scipy's "linear"
        raise ValueError(f"unsupported detrend mode {detrend!r} "
                         "(supported: 'constant', False/None)")

    win = hann_periodic(nperseg, dtype=x.dtype, device=x.device)
    scale = 1.0 / (fs * torch.sum(win * win))
    spec = torch.fft.rfft(segs * win, dim=-1)
    psd = (spec.real ** 2 + spec.imag ** 2) * scale
    mask = np.full((nperseg // 2 + 1,), 2.0)
    mask[0] = 1.0
    if nperseg % 2 == 0:
        mask[-1] = 1.0
    psd = psd * torch.as_tensor(mask, dtype=psd.dtype, device=psd.device)
    psd = psd.mean(dim=-2).movedim(-1, axis)
    freqs = torch.fft.rfftfreq(nperseg, d=1.0 / fs, dtype=x.dtype, device=x.device)
    return freqs, psd


def trapezoid(y: torch.Tensor, x: torch.Tensor, axis: int = -1) -> torch.Tensor:
    """np.trapezoid along ``axis`` of ``y`` at the sample points ``x``."""
    y = y.movedim(axis, -1)
    dx = torch.diff(x)
    return torch.sum((y[..., 1:] + y[..., :-1]) * 0.5 * dx, dim=-1)


def rfft_power(x: torch.Tensor, dim: int = -2) -> torch.Tensor:
    """Un-windowed rFFT power ``re² + im²`` along ``dim``."""
    spec = torch.fft.rfft(x, dim=dim)
    return spec.real ** 2 + spec.imag ** 2


def spectrogram(x: torch.Tensor, fs: float, nperseg: int) -> tuple:
    """scipy.signal.spectrogram(x, fs, nperseg=nperseg) of a 1-D signal with
    its defaults: a periodic Tukey(0.25) window, ``nperseg // 8`` overlap,
    constant detrend per segment, density scaling, one-sided doubling.
    Returns (f (F,), t (S,), Sxx (F, S)) on x's device."""
    from scipy.signal import get_window

    noverlap = nperseg // 8
    step = nperseg - noverlap
    segs = x.unfold(-1, nperseg, step)                      # (S, nperseg)
    segs = segs - segs.mean(dim=-1, keepdim=True)
    win = torch.as_tensor(get_window(("tukey", 0.25), nperseg), dtype=x.dtype,
                          device=x.device)
    scale = 1.0 / (fs * torch.sum(win * win))
    spec = torch.fft.rfft(segs * win, dim=-1)
    S = (spec.real ** 2 + spec.imag ** 2) * scale
    mask = np.full((nperseg // 2 + 1,), 2.0)
    mask[0] = 1.0
    if nperseg % 2 == 0:
        mask[-1] = 1.0
    S = S * torch.as_tensor(mask, dtype=S.dtype, device=S.device)
    f = torch.fft.rfftfreq(nperseg, d=1.0 / fs, dtype=x.dtype, device=x.device)
    t = (torch.arange(segs.shape[0], dtype=x.dtype, device=x.device) * step
         + nperseg / 2) / fs
    return f, t, S.T


def resample(x: torch.Tensor, num: int) -> torch.Tensor:
    """scipy.signal.resample(x, num) of a real 1-D signal: its rFFT cut or
    zero-padded to ``num`` samples, the unpaired Nyquist bin of an even
    length doubled (down) or halved (up), the inverse rFFT scaled by
    num / len(x)."""
    n_x = x.shape[-1]
    m = min(num, n_x)
    X = torch.fft.rfft(x)[..., :m // 2 + 1].clone()
    if m % 2 == 0 and num != n_x:
        X[..., m // 2] *= 2.0 if num < n_x else 0.5
    return torch.fft.irfft(X * (num / n_x), n=num)
