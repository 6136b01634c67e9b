"""Mixed-precision policy helpers.

Counterpart of ``eegsynth/nn/precision.py``: a CLI-facing precision name
maps to the dtype compute runs in, while master parameters stay float32.
``precision_d="bf16"`` of the CGAN trainer runs the D update's conv trunks
in bfloat16 through :func:`compute_dtype`; :func:`cast_floating` casts a
parameter tree for a half-precision pass.
"""

from __future__ import annotations

import torch

from eegsynth_torch.tree import tree_map

PRECISIONS = ("f32", "bf16")

_DTYPES = {"f32": torch.float32, "bf16": torch.bfloat16}


def compute_dtype(precision: str) -> torch.dtype:
    """The torch dtype of a precision name (``"f32"`` or ``"bf16"``)."""
    if precision not in _DTYPES:
        raise ValueError(f"precision must be one of {PRECISIONS}, got {precision!r}")
    return _DTYPES[precision]


def cast_floating(tree, dtype: torch.dtype):
    """``tree`` with every floating-point tensor cast to ``dtype``; integer
    and boolean leaves and ``None`` subtrees pass through unchanged."""
    return tree_map(lambda t: t.to(dtype) if t.is_floating_point() else t, tree)
