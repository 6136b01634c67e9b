"""Filters for the IIR kernel's tests past preprocessing's 9 taps, shared by
the CPU tests and the card tests (numpy only: the card's machine runs
tests/test_torch_card.py without the CPU tests' helpers)."""

import numpy as np


def stable_taps(n: int, seed: int = 0):
    """b, a of n taps (float64) that stay stable with their taps rounded to
    bfloat16 or float16 at any n (a high-order Butterworth's, or a's of many
    poles, do not: a high-degree polynomial's roots move with its
    coefficients' rounding): b random, scaled by 1 / n; a of up to 8 poles
    within radius 0.5 (conjugate pairs at random angles and a real pole for
    an odd count), padded with zeros to n."""
    rng = np.random.default_rng(seed)
    poles = min(n - 1, 8)
    theta = rng.uniform(0.1, 3.0, poles // 2)
    radius = 0.5 * rng.uniform(0.6, 1.0, poles // 2)
    roots = np.concatenate([radius * np.exp(1j * theta), radius * np.exp(-1j * theta),
                            [0.25] * (poles % 2)])
    a = np.zeros(n)
    a[:poles + 1] = np.real(np.poly(roots))
    return rng.standard_normal(n) / n, a
