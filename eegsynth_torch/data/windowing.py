"""Fixed-length epoching (windowing) of continuous recordings.

Counterpart of ``eegsynth/data/windowing.py`` (``epoch_fixed``): the same
windows, gathered on the recording's device.
"""

from __future__ import annotations

import torch


def epoch_fixed(arr: torch.Tensor, samples_per_epoch: int,
                overlap: float = 0.0) -> torch.Tensor:
    """Segment (T, C) into (N, samples_per_epoch, C) float32 windows on arr's
    device: a fixed sample count, non-overlapping by default; a fractional
    ``overlap`` shrinks the hop to ``int(win · (1 − overlap))``."""
    win = int(samples_per_epoch)
    step = win if overlap <= 0 else int(win * (1 - overlap))
    if step <= 0:
        step = win
    T = arr.shape[0]
    n = (T - win) // step + 1 if T >= win else 0
    if n <= 0:
        return torch.empty((0, win, arr.shape[1]), dtype=torch.float32,
                           device=arr.device)
    windows = arr[:(n - 1) * step + win].unfold(0, win, step)   # (N, C, win)
    return windows.transpose(1, 2).to(torch.float32).contiguous()
