"""NPZ bucket contracts, byte-compatible with the reference pipeline.

Counterpart of ``eegsynth/data/io.py`` (``Bucket``, ``save_bucket``,
``load_bucket``, ``load_X``, ``write_prep_index``, ``bucket_paths``; numpy
only). A bucket is one (posture, condition) NPZ with keys ``X``
(N, T, C) float32 in [0, 1], ``participant`` / ``trial`` int32 per window,
``posture`` int32, ``condition`` str, ``fs`` float32, ``ch_names``,
``scale_min`` / ``scale_range`` float32 (C,) and ``epoch_len_samples`` int32.
"""

from __future__ import annotations

import csv
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


def save_bucket(path: Path | str, bucket: Bucket) -> None:
    """Write a bucket NPZ (compressed) with the keys and dtypes above."""
    np.savez_compressed(
        path,
        X=bucket.X.astype(np.float32),
        participant=bucket.participant.astype(np.int32),
        trial=bucket.trial.astype(np.int32),
        posture=np.int32(bucket.posture),
        condition=str(bucket.condition),
        fs=np.float32(bucket.fs),
        ch_names=np.array(bucket.ch_names, dtype=object),
        scale_min=bucket.scale_min.astype(np.float32),
        scale_range=bucket.scale_range.astype(np.float32),
        epoch_len_samples=np.int32(bucket.epoch_len_samples),
    )


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


def load_X(path: Path | str) -> np.ndarray:
    """Just the windows array (synthetic NPZs carry only ``X``)."""
    with np.load(path) as data:
        return data["X"].astype(np.float32)


def write_prep_index(out_dir: Path | str, rows: list[dict]) -> Path:
    """``prep_index.csv``: one row per bucket, sorted by posture and
    condition, with the reference's columns."""
    out = Path(out_dir) / "prep_index.csv"
    cols = ["posture", "condition", "n_epochs", "seq_len", "n_channels", "fs_hz", "file"]
    rows = sorted(rows, key=lambda r: (r["posture"], r["condition"]))
    with open(out, "w", newline="") as f:
        w = csv.DictWriter(f, fieldnames=cols)
        w.writeheader()
        w.writerows(rows)
    return out


def bucket_paths(data_dir: Path | str) -> list[Path]:
    """Sorted ``posture*_*.npz`` bucket files."""
    return sorted(Path(data_dir).glob("posture*_*.npz"))
