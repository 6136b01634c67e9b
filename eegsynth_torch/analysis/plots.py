"""Analysis figures: region-grouped bars, scalar bars, the channel-mean PSD
with its SEM ribbon and per-band grouped bars.

Counterpart of ``eegsynth/analysis/plots.py``, the same functions, figure
sizes, dpi and strings, drawn by the port's raster layer
(``eegsynth_torch/viz/raster.py``) from numpy arrays on the host.
"""

from __future__ import annotations

import numpy as np

from eegsynth_torch.analysis.bandpower import order_channels_grouped
from eegsynth_torch.viz import raster


def grouped_bar_plot(ch_names, values, y_label, title, out_path):
    ordered_names, idxs, boundaries = order_channels_grouped(list(ch_names))
    vals = [values[i] for i in idxs]
    x = np.arange(len(ordered_names))
    fig, ax = raster.subplots(figsize=(12, 6))
    ax.bar(x, vals)
    ax.set_xticks(x, ordered_names, rotation=45, ha="right")
    ax.set_ylabel(y_label)
    ax.set_title(title)
    ymax = max(vals) if len(vals) else 1.0
    for region, start, end in boundaries:
        if start > 0:
            ax.axvline(start - 0.5, linestyle="--", alpha=0.5)
        ax.text((start + end - 1) / 2.0, ymax * 1.05, region, ha="center", va="bottom",
                fontsize=10)
    fig.tight_layout()
    fig.savefig(out_path, dpi=200)


def scalar_bar(value, label, title, out_path):
    fig, ax = raster.subplots(figsize=(5, 5))
    ax.bar([label], [value])
    ax.set_ylabel(label)
    ax.set_title(title)
    fig.tight_layout()
    fig.savefig(out_path, dpi=200)


def psd_mean_plot(f, psd_mean, psd_sem, title, out_path):
    """Channel-mean PSD with its ±SEM ribbon."""
    ch_mean = np.asarray(psd_mean).mean(axis=0)
    ch_sem = np.asarray(psd_sem).mean(axis=0)
    fig, ax = raster.subplots(figsize=(8, 5))
    ax.plot(f, ch_mean, label="Mean PSD (across channels)")
    ax.fill_between(f, ch_mean - ch_sem, ch_mean + ch_sem, alpha=0.3)
    ax.set_xlabel("Frequency (Hz)")
    ax.set_ylabel("PSD")
    ax.set_title(title)
    fig.tight_layout()
    fig.savefig(out_path, dpi=200)


def bandpower_bar_plot(bp: dict, ch_names, title, out_path):
    """Per-band grouped bars over the channels."""
    bands = list(bp.keys())
    C = len(ch_names)
    x = np.arange(C)
    width = 0.8 / len(bands)
    fig, ax = raster.subplots(figsize=(14, 6))
    for bi, band in enumerate(bands):
        ax.bar(x + (bi - len(bands) / 2 + 0.5) * width, bp[band], width, label=band)
    ax.set_xticks(x, list(ch_names), rotation=45, ha="right")
    ax.set_ylabel("Band power (trapezoid PSD)")
    ax.set_title(title)
    ax.legend()
    fig.tight_layout()
    fig.savefig(out_path, dpi=200)
