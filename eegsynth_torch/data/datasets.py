"""Bucket-set assembly and the balanced-sampling table of the CGAN family.

Counterpart of ``eegsynth/data/datasets.py`` (numpy only). The row order
comes from ``np.random.permutation`` after the caller's
``np.random.seed(hp.seed)``, as in the JAX package, so both packages see the
same rows in the same order.
"""

from __future__ import annotations

from pathlib import Path

import numpy as np

NUM_POSTURES = 9


def load_condition_dataset(data_dir, condition: str):
    """All posture buckets of one condition: X (N, C, T) float32, posture
    labels 1..9 (N,) int64, shuffled, and per-posture scaler meta for inverse
    scaling at generation."""
    files = sorted(Path(data_dir).glob(f"posture*_{condition}.npz"))
    if not files:
        raise SystemExit(f"No files found like posture*_{condition}.npz in {data_dir}")
    Xs, ys, meta = [], [], {}
    for fp in files:
        with np.load(fp, allow_pickle=True) as z:
            X = z["X"].astype(np.float32).transpose(0, 2, 1)
            posture = int(z["posture"])
            meta[posture] = {"file": str(fp),
                             "scale_min": z["scale_min"].astype(np.float32),
                             "scale_range": z["scale_range"].astype(np.float32),
                             "ch_names": z["ch_names"], "fs": float(z["fs"])}
        Xs.append(X)
        ys.append(np.full((X.shape[0],), posture, dtype=np.int64))
    X_all = np.concatenate(Xs, axis=0)
    y_all = np.concatenate(ys, axis=0)
    perm = np.random.permutation(X_all.shape[0])
    return X_all[perm], y_all[perm], meta


def load_posture_both_conditions(data_dir, posture: int):
    """Both condition buckets of one posture, labels {0: no_exo,
    1: with_exo}, shuffled, with the first bucket's scaler meta."""
    files = {0: Path(data_dir) / f"posture{posture}_no_exo.npz",
             1: Path(data_dir) / f"posture{posture}_with_exo.npz"}
    Xs, ys, meta = [], [], {}
    for cond, fp in files.items():
        if not fp.exists():
            raise SystemExit(f"Missing file: {fp}")
        with np.load(fp, allow_pickle=True) as z:
            X = z["X"].astype(np.float32).transpose(0, 2, 1)
            if not meta:
                meta = dict(ch_names=z["ch_names"], fs=float(z["fs"]),
                            scale_min=z["scale_min"].astype(np.float32),
                            scale_range=z["scale_range"].astype(np.float32))
        Xs.append(X)
        ys.append(np.full((X.shape[0],), cond, dtype=np.int64))
    X = np.concatenate(Xs, 0)
    y = np.concatenate(ys, 0)
    perm = np.random.permutation(len(y))
    return X[perm], y[perm], meta


def build_label_table(y: np.ndarray, num_classes: int, label_base: int = 0):
    """(table (K, max_count) int32, counts (K,) int32): row k lists the
    indices of class label_base + k, wrapped to fill the row."""
    idx_lists = [np.where(y == label_base + k)[0] for k in range(num_classes)]
    counts = np.array([len(i) for i in idx_lists], dtype=np.int32)
    if (counts == 0).any():
        missing = [label_base + k for k in range(num_classes) if counts[k] == 0]
        raise SystemExit(f"No samples for classes {missing}")
    m = int(counts.max())
    table = np.zeros((num_classes, m), dtype=np.int32)
    for k, il in enumerate(idx_lists):
        table[k, :] = np.resize(il, m)
    return table, counts
