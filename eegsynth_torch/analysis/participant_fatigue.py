"""Participant-paired fatigue pipeline from raw trial CSVs and synthetic
NPZs.

Counterpart of ``eegsynth/analysis/participant_fatigue.py``: per-trial
channel TBR from a Hann-windowed rFFT PSD, per-participant means, group
mean ± SD and paired t-tests over participants for real no-exo against
with-exo; synthetic epochs count-matched with ``RandomState(0)`` (the same
rows as in the JAX package) and paired-tested; the v2 inverse min-max
scaling with clamping and the canonical channel remap.

Where a direct port drifts: :func:`compute_fatigue_tbr` takes a batch of
epochs and runs one rFFT over all of them on a device, where the JAX package
loops over the epochs of a file.
"""

from __future__ import annotations

import glob
import os
import re
from pathlib import Path

import numpy as np
import torch
from scipy.stats import ttest_rel

from eegsynth_torch import EPOC_CHANNELS

COND_RE = re.compile(r"(no[ _-]*exo|with[ _-]*exo)", re.IGNORECASE)
POSTURE_RE = re.compile(r"posture[ _-]*(\d+)", re.IGNORECASE)
REST_RE = re.compile(r"rest\d*", re.IGNORECASE)


def compute_fatigue_tbr(epochs, fs: float, *, device) -> np.ndarray:
    """Per-channel TBR of each epoch from a Hann-windowed (symmetric) rFFT
    PSD of the demeaned epoch; θ [4, 8) and β [13, 30) as bin means + 1e-8.
    epochs (..., T, C) → (..., C) float64 numpy; one batched float64 FFT on
    ``device``. NaN where T < 4."""
    x = torch.as_tensor(np.asarray(epochs)).to(device=device, dtype=torch.float64)
    T, C = x.shape[-2:]
    if T < 4:
        return np.full(x.shape[:-2] + (C,), np.nan)
    w = torch.as_tensor(np.hanning(T)[:, None], device=device)
    Xw = torch.fft.rfft((x - x.mean(dim=-2, keepdim=True)) * w, dim=-2)
    psd = (Xw.real ** 2 + Xw.imag ** 2) / torch.sum(w ** 2)
    freqs = np.fft.rfftfreq(T, d=1.0 / max(1, fs))

    def band_power(lo, hi):
        m = (freqs >= lo) & (freqs < hi)
        if not np.any(m):
            return torch.full(x.shape[:-2] + (C,), 1e-8, dtype=torch.float64,
                              device=device)
        return psd[..., torch.as_tensor(m, device=device), :].mean(dim=-2) + 1e-8

    return (band_power(4.0, 8.0) / band_power(13.0, 30.0)).cpu().numpy()


def fatigue_vector_from_trial_csv(path: str, fallback_fs: float = 128.0, *, device):
    """One trial CSV → canonical-order (14,) TBR vector (NaN where a channel
    is missing), or None for an unreadable file or one with fewer than 4
    EPOC+ channels. Parsed by the port's native CSV reader."""
    from eegsynth_torch.data.fast_csv import read_columns, read_header
    from eegsynth_torch.data.filters import estimate_fs
    from eegsynth_torch.data.preprocess import find_time_col, match_epoc_columns

    try:
        header = read_header(path)
    except Exception:
        return None
    cols = match_epoc_columns(header)
    if len(cols) < 4:
        return None
    time_col = find_time_col(header)
    try:
        M = read_columns(path, cols + ([time_col] if time_col else []))
    except Exception:
        return None
    if time_col:
        tvals = M[:, -1]
        fs = estimate_fs(tvals[~np.isnan(tvals)], fallback_fs)
        X = M[:, :-1]
    else:
        fs = fallback_fs
        X = M
    tbr = compute_fatigue_tbr(np.nan_to_num(X.astype(np.float64)), fs, device=device)
    return remap_to_14_channels(tbr, cols)


def remap_to_14_channels(values: np.ndarray, ch_names) -> np.ndarray:
    """Per-source-channel values onto the canonical EPOC+ order; NaN where
    unmatched."""
    out = np.full(len(EPOC_CHANNELS), np.nan)
    for i, raw in enumerate(ch_names):
        base = str(raw).lower()
        base = base.replace("eeg.", "").replace(" (uv)", "").replace("_uv", "")
        base = base.strip().upper()
        if base in EPOC_CHANNELS:
            out[EPOC_CHANNELS.index(base)] = values[i]
    return out


def collect_real(data_root: Path, *, device) -> dict:
    """per_part[pid][posture][cond] → list of (14,) trial TBR vectors, from
    the ``protocol_outputs_*`` tree (rest files skipped)."""
    per_part: dict = {}
    parts = sorted(p for p in glob.glob(str(Path(data_root) / "protocol_outputs_*"))
                   if os.path.isdir(p))
    for pdir in parts:
        pid = os.path.basename(pdir)
        per_part.setdefault(pid, {i: {"no_exo": [], "with_exo": []}
                                  for i in range(1, 10)})
        for f in glob.glob(os.path.join(pdir, "**", "*.csv"), recursive=True):
            base = os.path.basename(f)
            if REST_RE.search(base):
                continue
            text = f.lower()
            m = POSTURE_RE.search(text)
            posture = int(m.group(1)) if m else None
            mc = COND_RE.search(text)
            cond = (mc.group(1).lower().replace(" ", "_").replace("-", "_")
                    if mc else None)
            if cond is not None:
                cond = "no_exo" if "no" in cond else "with_exo"
            if posture is None or cond is None or not (1 <= posture <= 9):
                continue
            vec = fatigue_vector_from_trial_csv(f, device=device)
            if vec is not None:
                per_part[pid][posture][cond].append(vec)
    return per_part


def aggregate_real(per_part: dict):
    """Across-participant means and SDs, and per-channel paired t-tests over
    the participants who have both conditions: (means, sds, pvals, counts)."""
    C = len(EPOC_CHANNELS)
    means = {p: {c: np.full(C, np.nan) for c in ("no_exo", "with_exo")}
             for p in range(1, 10)}
    sds = {p: {c: np.full(C, np.nan) for c in ("no_exo", "with_exo")}
           for p in range(1, 10)}
    pvals = {p: np.full(C, np.nan) for p in range(1, 10)}
    counts = {p: {"no_exo": 0, "with_exo": 0, "paired": 0} for p in range(1, 10)}

    for p in range(1, 10):
        per_no, per_we = {}, {}
        for pid, pdata in per_part.items():
            if pdata[p]["no_exo"]:
                per_no[pid] = np.nanmean(np.vstack(pdata[p]["no_exo"]), axis=0)
            if pdata[p]["with_exo"]:
                per_we[pid] = np.nanmean(np.vstack(pdata[p]["with_exo"]), axis=0)
        counts[p]["no_exo"] = len(per_no)
        counts[p]["with_exo"] = len(per_we)
        common = sorted(set(per_no) & set(per_we))
        counts[p]["paired"] = len(common)
        if per_no:
            A = np.vstack(list(per_no.values()))
            means[p]["no_exo"] = np.nanmean(A, axis=0)
            sds[p]["no_exo"] = np.nanstd(A, axis=0, ddof=0)
        if per_we:
            B = np.vstack(list(per_we.values()))
            means[p]["with_exo"] = np.nanmean(B, axis=0)
            sds[p]["with_exo"] = np.nanstd(B, axis=0, ddof=0)
        if common:
            A = np.vstack([per_no[pid] for pid in common])
            B = np.vstack([per_we[pid] for pid in common])
            for ci in range(C):
                a, b = A[:, ci], B[:, ci]
                m = ~np.isnan(a) & ~np.isnan(b)
                if m.sum() >= 2:
                    _, pvals[p][ci] = ttest_rel(a[m], b[m])
    return means, sds, pvals, counts


def synth_tbr_epochs(npz_path, real_npz=None, inverse_scale: bool = False, *,
                     device) -> np.ndarray:
    """Synthetic NPZ → per-epoch (N, 14) TBR matrix (every epoch in one
    batch on ``device``); with ``inverse_scale`` (v2) the windows are first
    mapped back through the real bucket's scalers and clamped to its range,
    and with a real bucket's channel names the columns are remapped to the
    canonical order."""
    with np.load(npz_path, allow_pickle=True) as z:
        X = z["X"].astype(np.float64)              # (N, T, C) in [0, 1]
        fs = float(z["fs"]) if "fs" in z.files else 128.0
    ch_names = None
    if real_npz is not None:
        with np.load(real_npz, allow_pickle=True) as r:
            if "ch_names" in r.files:
                ch_names = [str(c) for c in r["ch_names"].tolist()]
            if inverse_scale and "scale_min" in r.files:
                mn = r["scale_min"].astype(np.float64)
                rg = r["scale_range"].astype(np.float64)
                X = X * rg[None, None, :] + mn[None, None, :]
                # the real data span exactly [mn, mn + rg] by construction
                X = np.clip(X, mn, mn + rg)
            if "fs" in r.files:
                fs = float(r["fs"])
    tbr = compute_fatigue_tbr(X, fs, device=device)                 # (N, C)
    if ch_names is not None and len(ch_names) == tbr.shape[1]:
        tbr = np.stack([remap_to_14_channels(row, ch_names) for row in tbr], axis=0)
    return tbr


def _subsample_to_count(M: np.ndarray, k: int, rng) -> np.ndarray:
    """Drop all-NaN rows, then draw k rows without replacement (all of them
    when there are no more than k)."""
    M = M[~np.isnan(M).all(axis=1)]
    if len(M) == 0 or k <= 0:
        return np.empty((0, M.shape[1]))
    if len(M) <= k:
        return M
    return M[rng.choice(len(M), size=k, replace=False)]


def aggregate_fake(synth_dir, real_dir=None, inverse_scale: bool = False,
                   real_counts: dict | None = None, *, device):
    """Per-posture synthetic means and SDs and count-matched paired SN-vs-SW
    t-tests from ``synth_dir/posture{p}_{cond}/synthetic(_long).npz``. With
    ``real_counts`` (from :func:`aggregate_real`) each synthetic matrix is
    first cut with ``RandomState(0)`` to the real participant count of its
    (posture, condition)."""
    C = len(EPOC_CHANNELS)
    means = {p: {c: np.full(C, np.nan) for c in ("no_exo", "with_exo")}
             for p in range(1, 10)}
    sds = {p: {c: np.full(C, np.nan) for c in ("no_exo", "with_exo")}
           for p in range(1, 10)}
    pvals = {p: np.full(C, np.nan) for p in range(1, 10)}
    rng = np.random.RandomState(0)

    mats = {}
    for p in range(1, 10):
        for cond in ("no_exo", "with_exo"):
            run = Path(synth_dir) / f"posture{p}_{cond}"
            fp = None
            for name in ("synthetic_long.npz", "synthetic.npz"):
                if (run / name).exists():
                    fp = run / name
                    break
            if fp is None:
                continue
            real_npz = (Path(real_dir) / f"posture{p}_{cond}.npz"
                        if real_dir else None)
            if real_npz is not None and not real_npz.exists():
                real_npz = None
            tbr = synth_tbr_epochs(fp, real_npz, inverse_scale, device=device)
            if real_counts is not None:
                tbr = _subsample_to_count(tbr, max(0, real_counts[p][cond]), rng)
                if len(tbr) == 0:
                    continue
            mats[(p, cond)] = tbr
            means[p][cond] = np.nanmean(tbr, axis=0)
            sds[p][cond] = np.nanstd(tbr, axis=0, ddof=0)
        if (p, "no_exo") in mats and (p, "with_exo") in mats:
            a, b = mats[(p, "no_exo")], mats[(p, "with_exo")]
            n = min(len(a), len(b))
            for ci in range(C):
                x, y = a[:n, ci], b[:n, ci]
                m = ~np.isnan(x) & ~np.isnan(y)
                if m.sum() >= 2:
                    _, pvals[p][ci] = ttest_rel(x[m], y[m])
    return means, sds, pvals
