"""Per-stage preprocessing figures of one raw trial CSV: the CLI of
``scripts/preprocessing_plots.py`` with its flags, plus ``--device``
(default ``cuda``).

    python -m eegsynth_torch.preprocessing_plots --csv <trial.csv> --out <dir> \\
        [--channel 0] [--fs 128] [--low_cut 1] [--high_cut 45] \\
        [--target_fs 128] [--epoch_sec 6] [--device cpu]

Stages: raw → notch → band-pass → resample to ``--target_fs`` → Hampel →
one epoch → band powers, each as signal, spectrogram and PSD figures
(1_raw_signal.png … 7_features_spec.png), then the labelling figures
(8_labels_*.png). The CSV is read by the port's native parser, the notch
and band-pass run zero-phase on the IIR kernel (the card) or its plain
version (the CPU), the resampling, spectrograms and PSDs on the device; the
Hampel filter and the drawing on the host. No pandas or matplotlib is
needed.
"""

from __future__ import annotations

import argparse
from pathlib import Path

import numpy as np
import torch


def main(argv: list[str] | None = None) -> None:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0],
                                 formatter_class=argparse.ArgumentDefaultsHelpFormatter)
    ap.add_argument("--csv", type=str, required=True, help="one raw trial CSV")
    ap.add_argument("--out", type=str, default="./prep_stage_plots")
    ap.add_argument("--channel", type=int, default=0)
    ap.add_argument("--fs", type=float, default=128.0, help="fallback fs")
    ap.add_argument("--low_cut", type=float, default=1.0)
    ap.add_argument("--high_cut", type=float, default=45.0)
    ap.add_argument("--target_fs", type=float, default=128.0)
    ap.add_argument("--epoch_sec", type=float, default=6.0)
    ap.add_argument("--device", type=str, default="cuda",
                    help="where the filters, resampling and spectra run")
    args = ap.parse_args(argv)

    device = torch.device(args.device)
    if device.type == "cuda" and not torch.cuda.is_available():
        raise SystemExit("--device cuda: no CUDA device is available")
    from eegsynth_torch.data.fast_csv import read_columns, read_header
    from eegsynth_torch.data.filters import design_filters, detect_line_freq, estimate_fs
    from eegsynth_torch.data.preprocess import find_time_col, match_epoc_columns
    from eegsynth_torch.ops.filtering import filtfilt
    from eegsynth_torch.ops.spectral import resample
    from eegsynth_torch.viz.prep_stages import (
        hampel, label_figures, make_default_btr_segments, parse_labels_from_filename,
        plot_bandpowers, plot_psd, plot_signal, plot_spectrogram,
    )

    out = Path(args.out)
    out.mkdir(parents=True, exist_ok=True)
    header = read_header(args.csv)
    ch_cols = match_epoc_columns(header)
    if not ch_cols:
        raise SystemExit("No EPOC+ EEG columns found.")
    ch_name = ch_cols[args.channel]
    time_col = find_time_col(header)
    M = read_columns(args.csv, [ch_name] + ([time_col] if time_col else []))
    if time_col:
        tv = M[:, 1]
        fs = estimate_fs(tv[~np.isnan(tv)], args.fs)
    else:
        fs = args.fs
    sig_raw = torch.as_tensor(np.nan_to_num(M[:, 0]), device=device)
    meta = parse_labels_from_filename(args.csv)

    plot_signal(sig_raw, fs, f"Raw – {ch_name}", out / "1_raw_signal.png")
    plot_spectrogram(sig_raw, fs, "Raw Spectrogram", out / "1_raw_spec.png")

    notch_hz = detect_line_freq(sig_raw, fs)
    (b_bp, a_bp), (b_n, a_n) = design_filters(fs, args.low_cut, args.high_cut,
                                              notch_hz, 30.0)
    sig_notch = filtfilt(b_n, a_n, sig_raw)
    plot_signal(sig_notch, fs, f"After Notch ({int(notch_hz)} Hz) – {ch_name}",
                out / "2_notch_signal.png")
    plot_spectrogram(sig_notch, fs, "Notched Spectrogram", out / "2_notch_spec.png")
    plot_psd(sig_notch, fs, "PSD After Notch", out / "2_notch_psd.png")

    sig_bp = filtfilt(b_bp, a_bp, sig_notch)
    plot_signal(sig_bp, fs, "After Bandpass (1–45 Hz)", out / "3_bandpass_signal.png")
    plot_spectrogram(sig_bp, fs, "Bandpass Spectrogram", out / "3_bandpass_spec.png")
    plot_psd(sig_bp, fs, "PSD After Bandpass", out / "3_bandpass_psd.png")

    n_rs = int(round(len(sig_bp) * args.target_fs / fs))
    sig_rs = resample(sig_bp, n_rs)
    plot_signal(sig_rs, args.target_fs, "After Resampling (128 Hz)",
                out / "4_resampled_signal.png")
    plot_spectrogram(sig_rs, args.target_fs, "Resampled Spectrogram",
                     out / "4_resampled_spec.png")
    plot_psd(sig_rs, args.target_fs, "PSD After Resampling", out / "4_resampled_psd.png")

    sig_art = torch.as_tensor(hampel(sig_rs.cpu().numpy(), k=11, t0=5.0), device=device)
    plot_signal(sig_art, args.target_fs, "After Artifact (Hampel)",
                out / "5_artifact_signal.png")
    plot_spectrogram(sig_art, args.target_fs, "Artifact-attenuated Spectrogram",
                     out / "5_artifact_spec.png")
    plot_psd(sig_art, args.target_fs, "PSD After Artifact", out / "5_artifact_psd.png")

    ep_len = int(args.epoch_sec * args.target_fs)
    if len(sig_art) < ep_len:
        raise SystemExit("Not enough samples for a 6 s epoch.")
    sig_ep = sig_art[:ep_len]
    plot_signal(sig_ep, args.target_fs, "Epoch (6 s)", out / "6_epoch_signal.png")
    plot_spectrogram(sig_ep, args.target_fs, "Epoch Spectrogram", out / "6_epoch_spec.png")
    plot_psd(sig_ep, args.target_fs, "PSD (Epoch)", out / "6_epoch_psd.png")

    plot_bandpowers(sig_ep, args.target_fs, "Band Powers (Epoch)",
                    out / "7_features_bandpower.png")
    plot_spectrogram(sig_ep, args.target_fs, "Features Stage Spectrogram",
                     out / "7_features_spec.png")

    segments = make_default_btr_segments(len(sig_raw) / fs)
    label_figures(sig_raw, fs, meta, segments, out, epoch_sec=args.epoch_sec,
                  target_fs=args.target_fs, n_resampled=len(sig_rs))
    print("All figures (including labeling) saved to", out)


if __name__ == "__main__":
    main()
