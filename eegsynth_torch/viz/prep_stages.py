"""Preprocessing-stage and labelling figures.

Counterpart of ``eegsynth/viz/prep_stages.py``: per-stage (raw → notch →
band-pass → resample → Hampel → 6 s epoch → band powers) signal,
spectrogram and PSD figures of one channel, and the labelling figures
(timeline with baseline / task / recovery bands, label tracks, epoch grid,
label card) from the file name and a default segment split. The
spectrogram, Welch PSD and band powers run on the signal's device (a tensor
stays where it is, numpy runs on the CPU); the Hampel filter and the
drawing run on the host.
"""

from __future__ import annotations

import re
from pathlib import Path

import numpy as np
import torch

from eegsynth_torch.viz import raster


def _tensor(x) -> torch.Tensor:
    return x.to(torch.float64) if isinstance(x, torch.Tensor) else \
        torch.as_tensor(np.asarray(x, np.float64))


def _host(x) -> np.ndarray:
    return x.cpu().numpy() if isinstance(x, torch.Tensor) else np.asarray(x)


def hampel(x: np.ndarray, k: int = 11, t0: float = 5.0) -> np.ndarray:
    """Sliding-median / MAD outlier replacement; the windows are truncated
    at the ends (NaN padding with nanmedian)."""
    n = len(x)
    pad = np.pad(x.astype(np.float64), (k, k), mode="constant", constant_values=np.nan)
    win = np.lib.stride_tricks.sliding_window_view(pad, 2 * k + 1)
    med = np.nanmedian(win, axis=1)
    mad = np.nanmedian(np.abs(win - med[:, None]), axis=1)
    mad = np.where(mad == 0, 1e-6, mad)
    out = x.copy()
    bad = np.abs(x - med) > t0 * 1.4826 * mad
    out[bad] = med[bad]
    return out


def parse_labels_from_filename(path) -> dict:
    """Posture / task / condition / state / trial from the Emotiv export's
    long file name."""
    name = Path(path).stem.lower()
    m = re.search(r"posture[-_\s]*([0-9]+)", name)
    posture = f"Posture {m.group(1)}" if m else "Posture ?"
    cond = ("with exo" if "with exo" in name or "withexo" in name
            else ("no exo" if "no exo" in name or "noexo" in name else "?"))
    m = re.search(r"trial[-_\s]*([0-9]+)", name)
    trial = f"Trial {m.group(1)}" if m else "Trial ?"
    state = ("fatigue" if "fatigue" in name
             else ("stress" if "stress" in name
                   else ("cognitive load" if "cognitive load" in name
                         or "cognitiveload" in name else "?")))
    task = "?"
    for b in Path(path).stem.replace("_", " ").split("-"):
        if any(k in b.lower() for k in ("lifting", "overhead", "squat", "kneel", "reach",
                                        "twist", "walk", "standing")):
            task = b.strip()
            break
    return {"posture": posture, "condition": cond, "trial": trial,
            "state": state, "task": task}


def plot_signal(x, fs, title, out_fp):
    x = _host(x)
    t = np.arange(len(x)) / fs
    fig, ax = raster.subplots(figsize=(10, 3))
    ax.plot(t, x)
    ax.set_xlabel("Time (s)")
    ax.set_ylabel("Amplitude")
    ax.set_title(title)
    fig.tight_layout()
    fig.savefig(out_fp, dpi=200)


def plot_spectrogram(x, fs, title, out_fp):
    """scipy.signal.spectrogram's defaults at nperseg min(256, max(16,
    len/8)) on x's device, 10·log10 drawn with gouraud shading."""
    from eegsynth_torch.ops.spectral import spectrogram
    x = _tensor(x)
    f, t, S = spectrogram(x, fs, min(256, max(16, len(x) // 8)))
    fig, ax = raster.subplots(figsize=(10, 3))
    m = ax.pcolormesh(_host(t), _host(f), _host(10 * torch.log10(S + 1e-12)),
                      shading="gouraud")
    ax.set_ylabel("Hz")
    ax.set_xlabel("Time (s)")
    ax.set_title(title)
    fig.colorbar(m, ax=ax, label="dB")
    fig.tight_layout()
    fig.savefig(out_fp, dpi=200)


def plot_psd(x, fs, title, out_fp):
    from eegsynth_torch.ops.spectral import welch_psd
    x = _tensor(x)
    f, p = welch_psd(x, fs=fs, nperseg=min(int(fs * 2), len(x)))
    fig, ax = raster.subplots(figsize=(8, 3))
    ax.semilogy(_host(f), _host(p))
    ax.set_xlabel("Frequency (Hz)")
    ax.set_ylabel("PSD")
    ax.set_title(title)
    fig.tight_layout()
    fig.savefig(out_fp, dpi=200)


def plot_bandpowers(x, fs, title, out_fp):
    from eegsynth_torch.analysis.bandpower import BANDS
    from eegsynth_torch.ops.spectral import trapezoid, welch_psd
    x = _tensor(x)
    f, p = welch_psd(x, fs=fs, nperseg=min(int(fs), len(x)))
    powers = []
    for lo, hi in BANDS.values():
        m = (f >= lo) & (f <= hi)
        powers.append(float(trapezoid(p[m], f[m])) if bool(m.any()) else 0.0)
    fig, ax = raster.subplots(figsize=(6, 4))
    ax.bar(list(BANDS.keys()), powers)
    ax.set_ylabel("Band power")
    ax.set_title(title)
    fig.tight_layout()
    fig.savefig(out_fp, dpi=200)


def make_default_btr_segments(total_sec: float):
    """The 30 % baseline / 50 % task / 20 % recovery split used when no
    markers exist."""
    b, t = total_sec * 0.30, total_sec * 0.50
    return [(0.0, b, "baseline"), (b, b + t, "task"), (b + t, total_sec, "recovery")]


LABEL_COLORS = {"baseline": "#4caf50", "task": "#2196f3", "recovery": "#ff9800",
                "with exo": "#6a1b9a", "no exo": "#00897b"}


def label_figures(sig_raw, fs, meta, segments, out_dir, epoch_sec=6.0,
                  target_fs=128.0, n_resampled=None):
    """8_labels_timeline.png, 8_labels_tracks.png, 8_labels_epoch_grid.png
    (with ``n_resampled``) and 8_labels_card.png."""
    out_dir = Path(out_dir)
    colors = LABEL_COLORS
    sig_raw = _host(sig_raw)

    t = np.arange(len(sig_raw)) / fs
    fig, ax = raster.subplots(figsize=(12, 3))
    for (t0, t1, lab) in segments:
        ax.axvspan(t0, t1, color=colors.get(lab, "#cccccc"), alpha=0.35)
    ax.plot(t, (sig_raw - np.median(sig_raw)) / (np.std(sig_raw) + 1e-6), lw=0.8,
            color="k")
    ax.set_xlabel("Time (s)")
    ax.set_title("Labels Timeline (Baseline/Task/Recovery)")
    handles = [raster.Rectangle((0, 0), 1, 1, color=colors[k], alpha=0.35)
               for k in ("baseline", "task", "recovery")]
    ax.legend(handles, ["Baseline", "Task", "Recovery"], loc="upper right", frameon=False)
    fig.tight_layout()
    fig.savefig(out_dir / "8_labels_timeline.png", dpi=200)

    end = segments[-1][1]
    fig, ax = raster.subplots(figsize=(12, 2.8))
    ax.set_xlim(0, end)
    ax.set_ylim(0, 3)
    ax.set_yticks([0.5, 1.5, 2.5])
    ax.set_yticklabels(["Posture", "Condition", "State"])
    ax.add_patch(raster.Rectangle((0, 0.1), end, 0.8, color="#9e9e9e", alpha=0.35))
    ax.text(0.2, 0.5, meta["posture"], va="center", ha="left")
    ax.add_patch(raster.Rectangle((0, 1.1), end, 0.8,
                                  color=colors.get(meta["condition"], "#cccccc"),
                                  alpha=0.35))
    ax.text(0.2, 1.5, meta["condition"], va="center", ha="left")
    for (t0, t1, lab) in segments:
        ax.add_patch(raster.Rectangle((t0, 2.1), t1 - t0, 0.8,
                                      color=colors.get(lab, "#cccccc"), alpha=0.35))
        ax.text((t0 + t1) / 2, 2.5, lab, va="center", ha="center", fontsize=9)
    ax.set_xlabel("Time (s)")
    fig.tight_layout()
    fig.savefig(out_dir / "8_labels_tracks.png", dpi=200)

    if n_resampled is not None:
        total_sec_rs = n_resampled / target_fs
        n_ep = max(1, int(np.floor(total_sec_rs / epoch_sec)))

        def state_at(tsec):
            for (a, b, s) in segments:
                if a <= tsec < b:
                    return s
            return segments[-1][2]

        states = [state_at(i * epoch_sec) for i in range(n_ep)]
        fig, ax = raster.subplots(figsize=(max(6, n_ep * 0.6), 1.8))
        for i, s in enumerate(states):
            ax.add_patch(raster.Rectangle((i, 0), 1, 1, color=colors.get(s, "#cccccc"),
                                          alpha=0.8, lw=0))
            ax.text(i + 0.5, 0.5, f"E{i+1}", ha="center", va="center", fontsize=8,
                    color="k")
        ax.set_xlim(0, n_ep)
        ax.set_ylim(0, 1)
        ax.set_yticks([])
        ax.set_xticks(np.arange(n_ep) + 0.5)
        ax.set_xticklabels(states, rotation=45, ha="right", fontsize=8)
        ax.set_title("Epoch Grid (6 s each) – State per Epoch")
        fig.tight_layout()
        fig.savefig(out_dir / "8_labels_epoch_grid.png", dpi=200)

    fig, ax = raster.subplots(figsize=(4.2, 2.8))
    ax.axis("off")
    txt = (f"{meta['posture']}\nTask: {meta['task']}\n"
           f"Condition: {meta['condition']}\nState (from name): {meta['state']}\n"
           f"{meta['trial']}")
    ax.text(0.02, 0.95, "LABEL CARD", fontsize=11, weight="bold", va="top")
    ax.text(0.02, 0.85, txt, fontsize=10, va="top")
    fig.tight_layout()
    fig.savefig(out_dir / "8_labels_card.png", dpi=200)
