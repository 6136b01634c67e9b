"""Per-bucket channel-wise min-max scaling to [0, 1].

Counterpart of ``eegsynth/data/scaling.py`` (numpy, as there): min and max
over the flattened (N·T, C) samples of one (posture, condition) bucket, a
zero range replaced by 1e-6, ``X ← (X − mn) / rng``; the scalers travel with
the NPZ for later inversion. This is min-max scaling, not z-scoring.
"""

from __future__ import annotations

import numpy as np


def minmax_fit(x: np.ndarray) -> tuple[np.ndarray, np.ndarray]:
    """(scale_min, scale_range) per channel from (N, T, C) data (NaN-safe),
    float32."""
    flat = x.reshape(-1, x.shape[-1])
    mn = np.nanmin(flat, axis=0)
    mx = np.nanmax(flat, axis=0)
    rng = mx - mn
    rng[rng == 0] = 1e-6
    return mn.astype(np.float32), rng.astype(np.float32)


def minmax_apply(x, scale_min, scale_range):
    """(x − min) / range, the channel scalers broadcast over (..., C)."""
    return (x - scale_min) / scale_range


def minmax_invert(x, scale_min, scale_range):
    """x · range + min: the denormalisation of synthesis."""
    return x * scale_range + scale_min
