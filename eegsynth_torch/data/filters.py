"""EEG filter design and line-frequency detection (design on the host,
filtering on the device).

Counterpart of ``eegsynth/data/filters.py``: a 4th-order Butterworth
band-pass (1–45 Hz by default) and an IIR notch (Q 30) designed per file at
the estimated sampling rate with scipy, applied zero-phase by
``eegsynth_torch.ops.filtering.filtfilt`` (the IIR kernel on the card), notch
first.
"""

from __future__ import annotations

import numpy as np
import torch

from eegsynth_torch.ops.filtering import filtfilt
from eegsynth_torch.ops.spectral import trapezoid, welch_psd


def design_filters(fs: float, low_cut: float = 1.0, high_cut: float = 45.0,
                   notch_hz: float = 60.0, notch_q: float = 30.0):
    """Butterworth band-pass and iirnotch coefficient pairs (numpy float64):
    ((b_bp, a_bp), (b_n, a_n))."""
    from scipy.signal import butter, iirnotch
    nyq = 0.5 * fs
    lo = max(0.001, low_cut / nyq)
    hi = min(0.999, high_cut / nyq)
    b_bp, a_bp = butter(4, [lo, hi], btype="band")
    b_n, a_n = iirnotch(notch_hz / nyq, notch_q)
    return (b_bp, a_bp), (b_n, a_n)


def detect_line_freq(x, fs: float) -> float:
    """50 or 60 Hz mains from the first 20 s of one channel: a float64 Welch
    PSD (4 s segments, 2 s overlap) on x's device (numpy input: the host),
    trapezoid power over 49–51 against 59–61 Hz. 60.0 for a clip under 4 s."""
    x = torch.as_tensor(x)
    n = min(len(x), int(fs * 20))
    if n < int(fs * 4):
        return 60.0
    freqs, psd = welch_psd(x[:n].to(torch.float64), fs=fs, nperseg=int(fs * 4),
                           noverlap=int(fs * 2))

    def band_power(lo, hi):
        m = (freqs >= lo) & (freqs <= hi)
        if not bool(m.any()):
            return 0.0
        return float(trapezoid(psd[m], freqs[m]))

    return 50.0 if band_power(49, 51) > band_power(59, 61) else 60.0


def notch_then_bandpass(x, fs: float, low_cut: float = 1.0, high_cut: float = 45.0,
                        notch_hz: float | None = None, notch_q: float = 30.0):
    """The reference's filtering stage: notch, then band-pass, both
    zero-phase, along axis 0 of ``x`` (T, C) on its device (numpy input: the
    host). Only a notch input too short for its padding (``ValueError``)
    falls back to unfiltered; any other error propagates."""
    x = torch.as_tensor(x)
    if notch_hz is None:
        notch_hz = detect_line_freq(x[:, 0], fs)
    (b_bp, a_bp), (b_n, a_n) = design_filters(fs, low_cut, high_cut, notch_hz, notch_q)
    try:
        xn = filtfilt(b_n, a_n, x, axis=0)
    except ValueError:
        xn = x  # too short for notch padding: the reference leaves it unfiltered
    return filtfilt(b_bp, a_bp, xn, axis=0)


def estimate_fs(time_values: np.ndarray, fallback_fs: float = 128.0) -> float:
    """Sampling rate from a time or counter column (numpy): the median of the
    positive diffs below their 99th percentile, read as seconds or
    milliseconds; ``fallback_fs`` when degenerate."""
    s = np.asarray(time_values, dtype=np.float64)
    s = s[np.isfinite(s)]
    if len(s) < 6:
        return fallback_fs
    diffs = np.diff(s)
    diffs = diffs[(diffs > 0) & (diffs < np.nanpercentile(diffs, 99))]
    if len(diffs) == 0:
        return fallback_fs
    med = float(np.median(diffs))
    if med > 1.0 or (0.001 <= med <= 0.2):
        fs = 1.0 / med
    else:
        fs = 1000.0 / med
    if not np.isfinite(fs) or fs < 10:
        return fallback_fs
    return fs
