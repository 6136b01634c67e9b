"""CSV → NPZ preprocessing: raw Emotiv EPOC+ trial CSVs become one bucket
NPZ per (posture, condition).

Counterpart of ``eegsynth/data/preprocess.py``: discover ``Posture-*trial*``
CSVs under ``protocol_outputs_*``, match the EPOC+ headers, estimate fs from
the time column, detect 50 / 60 Hz mains, notch then band-pass zero-phase,
cut fixed-length epochs, scale each bucket channel-wise to [0, 1], write the
NPZs and ``prep_index.csv``. The filtering runs on ``device`` in float64 (on
the card: four IIR kernel launches a file); the windows come back to the
host as float32. Everything else is host work.

Where a direct port drifts: the JAX package catches every exception of the
notch pass and writes the file unfiltered. Here only ``ValueError`` (an
input too short for the notch's padding) falls back to unfiltered, so a
failed kernel build or launch stops the run instead of writing unfiltered
buckets.
"""

from __future__ import annotations

import re
from pathlib import Path
from typing import Dict, List, Optional, Tuple

import numpy as np
import torch

from eegsynth_torch import EPOC_CHANNELS
from eegsynth_torch.data.fast_csv import read_columns, read_header
from eegsynth_torch.data.filters import design_filters, detect_line_freq, estimate_fs
from eegsynth_torch.data.io import Bucket, save_bucket, write_prep_index
from eegsynth_torch.data.scaling import minmax_fit
from eegsynth_torch.data.windowing import epoch_fixed
from eegsynth_torch.ops.filtering import filtfilt

TIME_COL_KEYS = ("timestamp", "time", "time (s)", "time_s", "unix_time",
                 "datetime", "ms", "seconds")
COUNTER_COL_KEYS = ("counter", "sample", "samples", "frame")


def find_time_col(cols: List[str]) -> Optional[str]:
    """A wall-clock column if there is one, else a counter column, else None."""
    lc = {c.lower(): c for c in cols}
    for key in TIME_COL_KEYS:
        if key in lc:
            return lc[key]
    for key in COUNTER_COL_KEYS:
        if key in lc:
            return lc[key]
    return None


def match_epoc_columns(columns: List[str]) -> List[str]:
    """Map headers like AF3 / eeg.af3 / 'af3 (uv)' onto the 14 EPOC+
    channels: the source column names, in canonical channel order."""
    lowered = {c.lower(): c for c in columns}
    colset = set(columns)
    present = []
    for ch in EPOC_CHANNELS:
        found = None
        if ch in colset:
            found = ch
        else:
            base = ch.lower()
            for cand in (base, f"eeg.{base}", f"{base} (uv)", f"eeg.{base} (uv)",
                         f"{base}_uv", f"eeg_{base}"):
                if cand in lowered:
                    found = lowered[cand]
                    break
        if found is not None:
            present.append(found)
    return present


def parse_meta_from_name(name: str) -> Tuple[Optional[int], Optional[str], Optional[int]]:
    """(posture, condition, trial) from a file name; None where absent."""
    lower = name.lower()
    m_post = re.search(r"posture[-_\s]*([0-9]+)", lower)
    posture = int(m_post.group(1)) if m_post else None
    if "with exo" in lower or "withexo" in lower:
        cond = "with_exo"
    elif "no exo" in lower or "noexo" in lower:
        cond = "no_exo"
    else:
        cond = None
    m_trial = re.search(r"trial[-_\s]*([0-9]+)", lower) or re.search(r"t([0-9]+)(?![0-9])", lower)
    trial = int(m_trial.group(1)) if m_trial else None
    return posture, cond, trial


def discover_csvs(root: Path) -> List[Path]:
    """``protocol_outputs_*/**/*.csv`` named ``posture-*trial*``, sorted."""
    files: List[Path] = []
    for pdir in sorted(Path(root).glob("protocol_outputs_*")):
        files += sorted(pdir.rglob("*.csv"))
    return [fp for fp in files
            if fp.name.lower().startswith("posture-") and "trial" in fp.name.lower()]


def preprocess_file(fp: Path, fallback_fs: float, low_cut: float, high_cut: float,
                    notch_q: float, min_channels: int, epoch_len_samples: int,
                    overlap: float, device):
    """One CSV → (epochs (N, T, C) float32 numpy, meta dict), or (None,
    reason) for a file that is skipped. The filtering runs on ``device``."""
    try:
        header = read_header(fp)
    except Exception as e:  # an unreadable file is skipped, as in the reference
        return None, f"read error: {e}"

    cols = match_epoc_columns(header)
    if len(cols) < min_channels:
        return None, (f"only {len(cols)}/{len(EPOC_CHANNELS)} EPOC+ channels "
                      f"present (min {min_channels})")

    time_col = find_time_col(header)
    try:
        M = read_columns(fp, cols + ([time_col] if time_col else []))
    except Exception as e:
        return None, f"read error: {e}"
    if time_col:
        tvals = M[:, -1]
        fs_est = estimate_fs(tvals[~np.isnan(tvals)], fallback_fs)
    else:
        fs_est = fallback_fs

    posture, cond, trial = parse_meta_from_name(fp.name)
    if posture is None or cond is None or trial is None:
        return None, "could not parse posture/condition/trial"

    m_part = re.search(r"protocol_outputs_([0-9]+)", str(fp.parent))
    participant = int(m_part.group(1)) if m_part else -1

    X = torch.from_numpy(np.ascontiguousarray(M[:, :len(cols)])).to(device)
    if X.shape[0] < epoch_len_samples:
        return None, (f"not enough samples ({X.shape[0]}) for one fixed epoch "
                      f"({epoch_len_samples})")

    notch_hz = detect_line_freq(X[:min(len(X), int(fs_est * 20)), 0], fs_est)
    (b_bp, a_bp), (b_n, a_n) = design_filters(fs_est, low_cut, high_cut, notch_hz, notch_q)
    try:
        Xn = filtfilt(b_n, a_n, X, axis=0)
    except ValueError:
        Xn = X  # too short for the notch's padding: left unfiltered, as in the reference
    Xf = filtfilt(b_bp, a_bp, Xn, axis=0)

    epochs = epoch_fixed(Xf, epoch_len_samples, overlap).cpu().numpy()
    if epochs.shape[0] == 0:
        return None, "epoching produced 0 windows"

    meta = {"posture": posture, "cond": cond, "trial": trial,
            "participant": participant, "fs": fs_est, "notch": notch_hz,
            "ch_names": cols}
    return epochs, meta


def run_preprocess(root, out, fs: float = 128.0, epoch_sec: float = 6.0,
                   overlap: float = 0.0, low_cut: float = 1.0, high_cut: float = 45.0,
                   notch_q: float = 30.0, min_channels: int = 10,
                   epoch_fs_target: float = 128.0, dry_run: bool = False,
                   log=print, *, device) -> list[dict]:
    """The whole pipeline over a tree, filtering on ``device``; returns the
    prep_index rows (none on a dry run, which writes no file)."""
    device = torch.device(device)
    out_dir = Path(out)
    out_dir.mkdir(parents=True, exist_ok=True)
    epoch_len_samples = int(round(epoch_sec * round(epoch_fs_target)))
    log(f"fixed epoch length = {epoch_len_samples} samples "
        f"(~{epoch_sec}s @ {round(epoch_fs_target)} Hz)")

    files = discover_csvs(Path(root))
    if not files:
        raise SystemExit(f"No Posture-* trial CSVs found under '{root}'.")

    buckets: Dict[Tuple[int, str], dict] = {}
    for fp in files:
        epochs, meta = preprocess_file(fp, fs, low_cut, high_cut, notch_q,
                                       min_channels, epoch_len_samples, overlap,
                                       device)
        if epochs is None:
            log(f"[SKIP] {fp.name}: {meta}")
            continue
        key = (meta["posture"], meta["cond"])
        pack = buckets.setdefault(key, {"X": [], "participant": [], "trial": [],
                                        "fs": [], "ch_names": meta["ch_names"]})
        if meta["ch_names"] != pack["ch_names"]:
            if len(meta["ch_names"]) != len(pack["ch_names"]):
                # a different channel count cannot be concatenated: skip the file
                log(f"[SKIP] {fp.name}: {len(meta['ch_names'])} channels vs "
                    f"bucket's {len(pack['ch_names'])} — cannot concatenate")
                continue
            # the same count of other channels: concatenated, the last file's
            # names kept, as in the reference; say so
            log(f"[WARN] {fp.name}: channel set {meta['ch_names']} differs "
                f"from bucket's {pack['ch_names']}; columns may be misaligned")
            pack["ch_names"] = meta["ch_names"]
        pack["X"].append(epochs)
        pack["participant"].append(np.full((epochs.shape[0],), meta["participant"], np.int32))
        pack["trial"].append(np.full((epochs.shape[0],), meta["trial"], np.int32))
        pack["fs"].append(meta["fs"])
        log(f"done {fp.name}: fs~{meta['fs']:.1f}Hz, {epochs.shape[0]} epochs, "
            f"notch {meta['notch']:.0f}Hz, {len(meta['ch_names'])} channels")

    if dry_run:
        log("dry run: nothing written to disk")
        return []

    index_rows = []
    for (posture, cond), pack in sorted(buckets.items()):
        X = np.concatenate(pack["X"], axis=0)
        mn, rng = minmax_fit(X)
        Xs = ((X - mn) / rng).astype(np.float32)
        fs_bucket = float(np.median(np.array(pack["fs"], dtype=np.float32)))
        out_fp = out_dir / f"posture{posture}_{cond}.npz"
        save_bucket(out_fp, Bucket(
            X=Xs,
            participant=np.concatenate(pack["participant"]),
            trial=np.concatenate(pack["trial"]),
            posture=posture, condition=cond, fs=fs_bucket,
            ch_names=pack["ch_names"], scale_min=mn, scale_range=rng,
            epoch_len_samples=epoch_len_samples))
        log(f"wrote {out_fp} (shape {Xs.shape}, fs~{fs_bucket:.2f}Hz)")
        index_rows.append({"posture": posture, "condition": cond,
                           "n_epochs": int(Xs.shape[0]), "seq_len": int(Xs.shape[1]),
                           "n_channels": int(Xs.shape[2]),
                           "fs_hz": round(fs_bucket, 3), "file": str(out_fp)})

    if index_rows:
        idx_fp = write_prep_index(out_dir, index_rows)
        log(f"\nindex CSV at {idx_fp}")
    else:
        log("\nnothing matched: zero buckets assembled — verify the CSV naming "
            "scheme and channel headers")
    return index_rows
