"""NPZ bucket contracts, byte-compatible with the reference pipeline.

Counterpart of ``bucket_paths`` and ``load_bucket`` in ``eegsynth/data/io.py``
(numpy only). A bucket is one (posture, condition) NPZ with keys ``X``
(N, T, C) float32 in [0, 1], ``participant`` / ``trial`` int32 per window,
``posture`` int32, ``condition`` str, ``fs`` float32, ``ch_names``,
``scale_min`` / ``scale_range`` float32 (C,) and ``epoch_len_samples`` int32.
"""

from __future__ import annotations

import dataclasses
from pathlib import Path

import numpy as np


@dataclasses.dataclass
class Bucket:
    X: np.ndarray                      # (N, T, C) float32 scaled to [0, 1]
    participant: np.ndarray            # (N,) int32
    trial: np.ndarray                  # (N,) int32
    posture: int
    condition: str
    fs: float
    ch_names: list[str]
    scale_min: np.ndarray              # (C,) float32
    scale_range: np.ndarray            # (C,) float32
    epoch_len_samples: int

    @property
    def shape(self):
        return self.X.shape


def load_bucket(path: Path | str) -> Bucket:
    """Read a bucket NPZ; keys a synthetic or partial file lacks get the JAX
    package's defaults."""
    with np.load(path, allow_pickle=True) as data:
        X = data["X"].astype(np.float32)
        N = X.shape[0]

        def opt(key, default):
            return data[key] if key in data.files else default

        return Bucket(
            X=X,
            participant=np.asarray(opt("participant", np.full(N, -1)), dtype=np.int32),
            trial=np.asarray(opt("trial", np.full(N, -1)), dtype=np.int32),
            posture=int(opt("posture", -1)),
            condition=str(opt("condition", "")),
            fs=float(opt("fs", 128.0)),
            ch_names=[str(c) for c in opt("ch_names", [])],
            scale_min=np.asarray(opt("scale_min", np.zeros(X.shape[-1])),
                                 dtype=np.float32),
            scale_range=np.asarray(opt("scale_range", np.ones(X.shape[-1])),
                                   dtype=np.float32),
            epoch_len_samples=int(opt("epoch_len_samples", X.shape[1])),
        )


def bucket_paths(data_dir: Path | str) -> list[Path]:
    """Sorted ``posture*_*.npz`` bucket files."""
    return sorted(Path(data_dir).glob("posture*_*.npz"))
