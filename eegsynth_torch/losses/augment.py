"""DiffAugment-1D: three augmentations, each applied with probability p.

Counterpart of ``eegsynth/losses/augment.py``, with its draws passed in
(:class:`AugmentDraws`, drawn by :func:`draw_augment`):

- time shift: roll by one batch-shared integer in [−8, 8];
- amplitude jitter: per-sample scale in [0.9, 1.1] plus a 0.02·N bias,
  clamped to [0, 1];
- time cutout: zero a window of 5 % of T at a per-sample start.

The coin flips stay on the device (``torch.where``), so applying the draws
never waits for the card.
"""

from __future__ import annotations

import dataclasses

import torch


@dataclasses.dataclass
class AugmentDraws:
    do_shift: torch.Tensor   # () bool: apply the time shift
    shift: torch.Tensor      # () int64 in [-8, 8]
    do_jitter: torch.Tensor  # () bool: apply the amplitude jitter
    scale: torch.Tensor      # (B, 1, 1) in [0.9, 1.1)
    bias: torch.Tensor       # (B, 1, 1) 0.02 · N(0, 1)
    do_cutout: torch.Tensor  # () bool: apply the cutout
    start: torch.Tensor      # (B, 1, 1) int64 in [0, T - w)


def cutout_width(T: int) -> int:
    return max(1, int(0.05 * T))


def draw_augment(generator: torch.Generator, B: int, T: int, p: float, *,
                 device: torch.device | str) -> AugmentDraws:
    """The draws of one :func:`diffaugment_1d` call for a (B, C, T) batch."""
    kw = {"generator": generator, "device": device}
    return AugmentDraws(
        do_shift=torch.rand((), **kw) < p,
        shift=torch.randint(-8, 9, (), **kw),
        do_jitter=torch.rand((), **kw) < p,
        scale=0.9 + 0.2 * torch.rand((B, 1, 1), **kw),
        bias=0.02 * torch.randn((B, 1, 1), **kw),
        do_cutout=torch.rand((), **kw) < p,
        start=torch.randint(0, T - cutout_width(T), (B, 1, 1), **kw))


def diffaugment_1d(x: torch.Tensor, draws: AugmentDraws) -> torch.Tensor:
    """x (B, C, T) in [0, 1] → augmented (B, C, T)."""
    T = x.shape[2]
    t = torch.arange(T, device=x.device)
    rolled = x.index_select(2, torch.remainder(t - draws.shift, T))   # jnp.roll
    x = torch.where(draws.do_shift, rolled, x)
    jittered = torch.clamp(x * draws.scale + draws.bias, 0.0, 1.0)
    x = torch.where(draws.do_jitter, jittered, x)
    w = cutout_width(T)
    mask = ((t < draws.start) | (t >= draws.start + w)).to(x.dtype)
    return torch.where(draws.do_cutout, x * mask, x)
