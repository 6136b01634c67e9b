"""Four-group (RN/RW/SN/SW) TBR comparison: per-channel Welch t-tests and
display scaling.

Counterpart of ``eegsynth/analysis/ttests.py`` (numpy and scipy.stats on the
host, as there): RN-vs-RW and SN-vs-SW ``ttest_ind(equal_var=False)`` per
channel, the v2 95th-percentile and v3 per-pair median display scales of the
synthetic groups, the v4 CSV of t / p / scales, and the count-matched paired
real-vs-synthetic test. Statistics are always computed on the unscaled
values; the scales are for display only. ``four_group_report`` draws its
grouped 4-bar figure with the stars by the port's raster layer.
"""

from __future__ import annotations

import logging
import os
import re
from pathlib import Path

import numpy as np
from scipy.stats import ttest_ind

from eegsynth_torch.viz import raster

logger = logging.getLogger(__name__)

# Frontal order is AF3,AF4,F3,F4,FC5,FC6,F7,F8 — every reference fatigue
# script's REGION_ORDER (t_test.py:39-45); FC5/FC6 come BEFORE F7/F8
ORDERED_CH = ["AF3", "AF4", "F3", "F4", "FC5", "FC6", "F7", "F8",
              "T7", "T8", "P7", "P8", "O1", "O2"]
GROUPS = ("RN", "RW", "SN", "SW")


def scan_files(root) -> dict:
    """posture → {RN/RW/SN/SW: [paths]} from root/{real,synthetic}/*.npz
    (t_test.py:93-113)."""
    buckets: dict = {}
    for subset, codes in (("real", ("RN", "RW")), ("synthetic", ("SN", "SW"))):
        base = Path(root) / subset
        if not base.is_dir():
            continue
        for fname in sorted(os.listdir(base)):
            if not fname.lower().endswith(".npz"):
                continue
            low = fname.lower()
            m = re.search(r"posture\s*(\d+)", low)
            if not m:
                continue
            posture = int(m.group(1))
            if "no_exo" in low or "no-exo" in low or "noexo" in low:
                code = codes[0]
            elif "with" in low:
                code = codes[1]
            else:
                continue
            buckets.setdefault(posture, {g: [] for g in GROUPS})
            buckets[posture][code].append(str(base / fname))
    return buckets


def reorder_by_region(ch_names: list[str], arr: np.ndarray):
    """Canonical region channel ordering (t_test.py:116-127)."""
    order = [ch_names.index(ch) for ch in ORDERED_CH if ch in ch_names]
    order += [i for i in range(len(ch_names)) if i not in order]
    names = [ch_names[i] for i in order]
    return names, arr[order] if arr.ndim == 1 else arr[order, ...]


def sig_stars(p: float) -> str:
    if np.isnan(p):
        return ""
    if p < 1e-3:
        return "***"
    if p < 1e-2:
        return "**"
    if p < 5e-2:
        return "*"
    return ""


def welch_ttest_per_channel(a: np.ndarray | None, b: np.ndarray | None,
                            n_ch: int):
    """(t (C,), p (C,)) — Welch's unequal-variance test, NaN-omitting."""
    t = np.full(n_ch, np.nan)
    p = np.full(n_ch, np.nan)
    if a is None or b is None:
        return t, p
    for ci in range(n_ch):
        try:
            t[ci], p[ci] = ttest_ind(a[:, ci], b[:, ci], equal_var=False,
                                     nan_policy="omit")
        except (ValueError, TypeError) as exc:
            # older scipy raises on degenerate columns; leave NaN but say so
            logger.warning("welch_ttest_per_channel: skipping channel %d (%s)",
                           ci, exc)
            continue
        if not np.isfinite(p[ci]):
            # modern scipy returns NaN for <2 valid samples / all-NaN columns
            logger.warning("welch_ttest_per_channel: channel %d produced a NaN "
                           "p-value (insufficient or degenerate data)", ci)
    return t, p


def display_scales(groups: dict, mode: str = "none"):
    """Per-group display multipliers for synthetic bars (stats stay unscaled).

    - 'none' (t_test.py): 1.0
    - 'p95'  (t_test_v2.py): synthetic scaled by real/synthetic 95th-percentile ratio
    - 'median' (t_test_v3.py): SN→RN and SW→RW per-pair median ratio
    """
    scales = {g: 1.0 for g in GROUPS}
    def pct(arr, q):
        return float(np.nanpercentile(arr, q)) if arr is not None else np.nan

    if mode == "p95":
        # compute_visibility_scale (t_test_v2.py:119-137): scale DOWN only,
        # and only when synthetic exceeds real by the 1.5× allowance; never
        # upscale; floor at MIN_SCALE=0.05; 1.0 when either percentile <= 0
        ALLOWANCE, MIN_SCALE = 1.5, 0.05
        real_all = [groups[g] for g in ("RN", "RW") if groups.get(g) is not None]
        syn_all = [groups[g] for g in ("SN", "SW") if groups.get(g) is not None]
        if real_all and syn_all:
            r95 = pct(np.concatenate([a.ravel() for a in real_all]), 95)
            s95 = pct(np.concatenate([a.ravel() for a in syn_all]), 95)
            if (np.isfinite(r95) and np.isfinite(s95) and r95 > 0 and s95 > 0
                    and s95 > r95 * ALLOWANCE):
                scales["SN"] = scales["SW"] = max(MIN_SCALE,
                                                  (r95 * ALLOWANCE) / s95)
    elif mode == "median":
        # median_scale (t_test_v3.py:124-130): 1.0 unless BOTH medians are
        # finite and positive (a zero real median must not zero the bars)
        for syn, real in (("SN", "RN"), ("SW", "RW")):
            if groups.get(syn) is not None and groups.get(real) is not None:
                ms = float(np.nanmedian(groups[syn]))
                mr = float(np.nanmedian(groups[real]))
                if (np.isfinite(ms) and ms > 0
                        and np.isfinite(mr) and mr > 0):
                    scales[syn] = mr / ms
    return scales


def four_group_report(groups: dict, ch_names: list[str], posture: int,
                      out_png, scaling: str = "none", export_csv=None):
    """Per-channel Welch t-tests RN vs RW and SN vs SW, group means and SDs
    and the display scales of the synthetic groups; the grouped 4-bar
    figure (region-ordered channels, SD error bars, the stars of RN vs RW
    in black and of SN vs SW in C3) at ``out_png``;
    optionally the v4 CSV (region-ordered Channel rows, the global scales
    repeated on each row). Returns the stats dict."""
    n_ch = len(ch_names)
    means, stds = {}, {}
    for g in GROUPS:
        arr = groups.get(g)
        if arr is None:
            means[g] = np.full(n_ch, np.nan)
            stds[g] = np.full(n_ch, np.nan)
        else:
            means[g] = np.nanmean(arr, axis=0)
            stds[g] = np.nanstd(arr, axis=0, ddof=1)

    t_R, p_R = welch_ttest_per_channel(groups.get("RN"), groups.get("RW"), n_ch)
    t_S, p_S = welch_ttest_per_channel(groups.get("SN"), groups.get("SW"), n_ch)
    scales = display_scales(groups, scaling)

    names, _ = reorder_by_region(ch_names, np.arange(n_ch))
    order = [ch_names.index(n) for n in names]

    x = np.arange(n_ch)
    width = 0.2
    fig, ax = raster.subplots(figsize=(14, 6))
    for gi, g in enumerate(GROUPS):
        ax.bar(x + (gi - 1.5) * width, means[g][order] * scales[g], width,
               yerr=stds[g][order] * scales[g], capsize=2, label=g)
    ymax = np.nanmax([np.nanmax(means[g][order] * scales[g]) for g in GROUPS
                      if np.isfinite(means[g]).any()] or [1.0])
    for ci in range(n_ch):
        src = order[ci]
        star_r, star_s = sig_stars(p_R[src]), sig_stars(p_S[src])
        if star_r:
            ax.text(ci - width, ymax * 1.02, star_r, ha="center", fontsize=9)
        if star_s:
            ax.text(ci + width, ymax * 1.02, star_s, ha="center", fontsize=9,
                    color="C3")
    ax.set_xticks(x, names, rotation=45, ha="right")
    ax.set_ylabel("TBR (Theta/Beta)")
    title = f"Posture {posture}: TBR by channel (RN/RW/SN/SW)"
    if scaling != "none":
        title += f" [synthetic display-scaled: {scaling}]"
    ax.set_title(title)
    ax.legend()
    fig.tight_layout()
    fig.savefig(out_png, dpi=200)

    stats = {"ch_names": ch_names, "t_R": t_R, "p_R": p_R, "t_S": t_S, "p_S": p_S,
             "scales": scales, "means": {g: means[g] for g in GROUPS}}
    if export_csv is not None:
        import csv
        with open(export_csv, "w", newline="") as f:
            w = csv.writer(f)
            w.writerow(["Channel", "t_stat_real (RN vs RW)",
                        "p_val_real (RN vs RW)", "t_stat_synth (SN vs SW)",
                        "p_val_synth (SN vs SW)",
                        "SN_scale_display", "SW_scale_display"])
            for ci in range(n_ch):
                src = order[ci]
                w.writerow([names[ci], t_R[src], p_R[src], t_S[src], p_S[src],
                            scales["SN"], scales["SW"]])
    return stats


def paired_ttest_real_vs_fake(tbr_real: np.ndarray, tbr_fake: np.ndarray):
    """Count-matched paired t-test per channel (timeGAN/mental_fatigue_t_test_v3.py)."""
    from scipy.stats import ttest_rel
    n = min(len(tbr_real), len(tbr_fake))
    t = np.full(tbr_real.shape[1], np.nan)
    p = np.full(tbr_real.shape[1], np.nan)
    for ci in range(tbr_real.shape[1]):
        try:
            t[ci], p[ci] = ttest_rel(tbr_real[:n, ci], tbr_fake[:n, ci])
        except (ValueError, TypeError) as exc:
            logger.warning("paired_ttest_real_vs_fake: skipping channel %d (%s)",
                           ci, exc)
            continue
        if not np.isfinite(p[ci]):
            logger.warning("paired_ttest_real_vs_fake: channel %d produced a "
                           "NaN p-value (insufficient or degenerate data)", ci)
    return t, p
