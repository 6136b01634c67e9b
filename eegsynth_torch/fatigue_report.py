"""Mental-fatigue reports over real and synthetic NPZ sets: the CLI of
``scripts/fatigue_report.py`` with its five subcommands and their flags,
plus ``--device``. It writes every CSV and figure the JAX CLI writes (the
same names, columns and row order, the same figure contents), the figures
drawn by the port's raster layer: no matplotlib is needed.

    python -m eegsynth_torch.fatigue_report bandpower|indices|paired \\
        --root <dir with real/ and synthetic/> --out <dir> [--device cpu]
    python -m eegsynth_torch.fatigue_report ttest --root <dir> --out <dir> \\
        [--scaling none|p95|median] [--export-csv]
    python -m eegsynth_torch.fatigue_report participants --data-root \\
        <raw CSV tree> --synth-dir <runs> --out <dir> [--real-dir <buckets>] \\
        [--inverse-scale]

- ``bandpower``: per NPZ, the channels' band powers of the epoch-mean Welch
  PSD (``<stem>_bandpowers.csv`` and ``.png``), the mean PSD with its SEM
  ribbon (``<stem>_PSD_mean.png``), and ``bandpower_summary.csv``;
- ``indices``: band powers, TBR / TABR / ABR / θα per channel
  (``<stem>_indices_per_channel.csv``) and the workload and global indices
  (``<stem>_indices_summary.csv``); figures ``<stem>_PSD_mean.png``,
  ``_MF_TABR``, ``_TBR``, ``_ABR``, ``_ThetaAlpha``, ``_Alpha`` (region-grouped
  bars) and ``_Workload_thetaF_over_alphaPO.png``;
- ``ttest``: per posture, per-channel Welch t-tests of the Welch-TBR
  matrices, RN vs RW and SN vs SW, the grouped 4-bar figure with stars
  (``posture{p}_tbr_4group.png``; ``posture{p}_stats.csv`` with
  ``--export-csv``);
- ``paired``: count-matched paired t-tests real vs synthetic per condition
  (``paired_ttests.csv``);
- ``participants``: participant-paired TBR from the raw trial CSVs against
  the synthetic runs (``participant_ttests.csv``,
  ``posture{p}_participant_tbr.png``).

The spectra run on ``--device`` (default cuda) in float64; the t-tests on
the host with scipy.stats.
"""

from __future__ import annotations

import argparse
import csv
from pathlib import Path

import numpy as np
import torch


def _load(fpath):
    with np.load(fpath, allow_pickle=True) as z:
        X = z["X"].astype(np.float32)
        fs = float(z["fs"]) if "fs" in z.files else 128.0
        if "ch_names" in z.files:
            ch_names = [str(c) for c in z["ch_names"].tolist()]
        else:
            ch_names = [f"Ch{i+1}" for i in range(X.shape[-1])]
    return X, fs, ch_names


def _iter_npzs(root):
    for subset in ("real", "synthetic"):
        d = Path(root) / subset
        if not d.is_dir():
            continue
        for fp in sorted(d.glob("*.npz")):
            yield subset, fp


def _write_bandpowers(base: Path, bp: dict, ch_names: list[str]) -> None:
    with open(f"{base}_bandpowers.csv", "w", newline="") as fh:
        w = csv.writer(fh)
        w.writerow(["channel"] + list(bp.keys()))
        for ci, ch in enumerate(ch_names):
            w.writerow([ch] + [bp[b][ci] for b in bp])


def cmd_bandpower(args):
    from eegsynth_torch.analysis.bandpower import band_powers, compute_psd_per_channel
    from eegsynth_torch.analysis.plots import bandpower_bar_plot, psd_mean_plot

    out = Path(args.out)
    summary = []
    for subset, fp in _iter_npzs(args.root):
        X, fs, ch_names = _load(fp)
        od = out / subset
        od.mkdir(parents=True, exist_ok=True)
        f, psd_mean, psd_sem = compute_psd_per_channel(X, fs, device=args.device)
        bp = band_powers(f, psd_mean)
        base = od / fp.stem
        _write_bandpowers(base, bp, ch_names)
        psd_mean_plot(f, psd_mean, psd_sem, f"{subset} | {fp.name} | Mean PSD",
                      f"{base}_PSD_mean.png")
        bandpower_bar_plot(bp, ch_names, f"{subset} | {fp.name} | Band powers",
                           f"{base}_bandpowers.png")
        summary.append({"subset": subset, "file": fp.name, "fs": fs,
                        "n_epochs": X.shape[0],
                        **{f"mean_{b}": float(np.mean(v)) for b, v in bp.items()}})
        print(f"[bandpower] {subset}/{fp.name}")
    if summary:
        with open(out / "bandpower_summary.csv", "w", newline="") as fh:
            w = csv.DictWriter(fh, fieldnames=list(summary[0].keys()))
            w.writeheader()
            w.writerows(summary)


def cmd_indices(args):
    from eegsynth_torch.analysis.bandpower import band_powers, compute_psd_per_channel
    from eegsynth_torch.analysis.fatigue import (
        fatigue_indices, global_indices, workload_ratio,
    )
    from eegsynth_torch.analysis.plots import grouped_bar_plot, psd_mean_plot, scalar_bar

    out = Path(args.out)
    for subset, fp in _iter_npzs(args.root):
        X, fs, ch_names = _load(fp)
        od = out / subset
        od.mkdir(parents=True, exist_ok=True)
        f, psd_mean, psd_sem = compute_psd_per_channel(X, fs, device=args.device)
        bp = band_powers(f, psd_mean)
        idx = fatigue_indices(bp)
        wl = workload_ratio(bp, ch_names)
        base = od / fp.stem
        _write_bandpowers(base, bp, ch_names)
        with open(f"{base}_indices_per_channel.csv", "w", newline="") as fh:
            w = csv.writer(fh)
            w.writerow(["channel"] + list(idx.keys()))
            for ci, ch in enumerate(ch_names):
                w.writerow([ch] + [idx[k][ci] for k in idx])
        summary = {"file": fp.name, "fs": fs, "n_epochs": X.shape[0],
                   "n_samples_per_epoch": X.shape[1], "n_channels": X.shape[2],
                   "Workload (thetaF/alphaPO)": wl, **global_indices(bp)}
        with open(f"{base}_indices_summary.csv", "w", newline="") as fh:
            w = csv.DictWriter(fh, fieldnames=list(summary.keys()))
            w.writeheader()
            w.writerow(summary)

        name = f"{subset.capitalize()} | {fp.name}"
        psd_mean_plot(f, psd_mean, psd_sem, f"{name} | Mean PSD", f"{base}_PSD_mean.png")
        for key, label, what, suffix in (
                ("TABR ((Theta+Alpha)/Beta)", "TABR ((Theta+Alpha)/Beta)",
                 "Mental Fatigue (TABR)", "MF_TABR"),
                ("TBR (Theta/Beta)", "TBR (Theta/Beta)", "TBR", "TBR"),
                ("ABR (Alpha/Beta)", "ABR (Alpha/Beta)", "ABR", "ABR"),
                ("Theta/Alpha", "Theta/Alpha", "Theta/Alpha", "ThetaAlpha")):
            grouped_bar_plot(ch_names, idx[key], label, f"{name} | {what}",
                             f"{base}_{suffix}.png")
        grouped_bar_plot(ch_names, bp["Alpha"], "Alpha Power (integrated PSD)",
                         f"{name} | Alpha power (context)", f"{base}_Alpha.png")
        scalar_bar(wl, "θf/αp", f"{name} | Workload (Frontal θ / ParOcc α)",
                   f"{base}_Workload_thetaF_over_alphaPO.png")
        print(f"[indices] {subset}/{fp.name} workload={wl:.4f}")


def cmd_ttest(args):
    from eegsynth_torch.analysis.fatigue import tbr_matrix
    from eegsynth_torch.analysis.ttests import four_group_report, scan_files

    out = Path(args.out)
    out.mkdir(parents=True, exist_ok=True)
    buckets = scan_files(args.root)
    if not buckets:
        raise SystemExit(f"No posture NPZs under {args.root}/(real|synthetic)")
    for posture in sorted(buckets):
        groups = {}
        ch_names = None
        for code, paths in buckets[posture].items():
            mats = []
            for fp in paths:
                X, fs, ch = _load(fp)
                ch_names = ch_names or ch
                mats.append(tbr_matrix(X, fs, device=args.device))
            groups[code] = np.concatenate(mats, 0) if mats else None
        if ch_names is None:
            continue
        export = (out / f"posture{posture}_stats.csv") if args.export_csv else None
        four_group_report(groups, ch_names, posture,
                          out / f"posture{posture}_tbr_4group.png",
                          scaling=args.scaling, export_csv=export)
        print(f"[ttest] posture {posture} → {out}/posture{posture}_tbr_4group.png")


def cmd_paired(args):
    from eegsynth_torch.analysis.fatigue import tbr_matrix
    from eegsynth_torch.analysis.ttests import paired_ttest_real_vs_fake, scan_files

    out = Path(args.out)
    out.mkdir(parents=True, exist_ok=True)
    buckets = scan_files(args.root)
    rows = []
    for posture in sorted(buckets):
        for cond, (rcode, scode) in (("no_exo", ("RN", "SN")),
                                     ("with_exo", ("RW", "SW"))):
            rp, sp = buckets[posture][rcode], buckets[posture][scode]
            if not rp or not sp:
                continue
            Xr, fs, ch_names = _load(rp[0])
            Xs, _, _ = _load(sp[0])
            tr = tbr_matrix(Xr, fs, device=args.device)
            ts = tbr_matrix(Xs, fs, device=args.device)
            t, p = paired_ttest_real_vs_fake(tr, ts)
            for ci, ch in enumerate(ch_names):
                rows.append({"posture": posture, "condition": cond, "channel": ch,
                             "t": t[ci], "p": p[ci],
                             "mean_real": float(np.nanmean(tr[:, ci])),
                             "mean_synth": float(np.nanmean(ts[:, ci]))})
            print(f"[paired] posture {posture} {cond}: "
                  f"{np.sum(p < 0.05)}/{len(ch_names)} channels p<0.05")
    if rows:
        with open(out / "paired_ttests.csv", "w", newline="") as fh:
            w = csv.DictWriter(fh, fieldnames=list(rows[0].keys()))
            w.writeheader()
            w.writerows(rows)


def _participant_figure(p: int, bars, r_pvals, s_pvals, n_paired: int, path) -> None:
    """Grouped 4-bar TBR figure of one posture (RN, RW, SN, SW), SD error
    bars, the stars of the participant-paired tests."""
    from eegsynth_torch import EPOC_CHANNELS
    from eegsynth_torch.analysis.ttests import sig_stars
    from eegsynth_torch.viz import raster

    C = len(EPOC_CHANNELS)
    x = np.arange(C)
    width = 0.2
    fig, ax = raster.subplots(figsize=(14, 6))
    for gi, (g, mu, sd) in enumerate(bars):
        ax.bar(x + (gi - 1.5) * width, np.nan_to_num(mu), width, yerr=np.nan_to_num(sd),
               capsize=2, label=g)
    finite = [np.nanmax(mu) for _, mu, _ in bars if np.isfinite(mu).any()]
    ymax = max(finite) if finite else 1.0
    for ci in range(C):
        sr, ss = sig_stars(r_pvals[ci]), sig_stars(s_pvals[ci])
        if sr:
            ax.text(ci - width, ymax * 1.02, sr, ha="center", fontsize=9)
        if ss:
            ax.text(ci + width, ymax * 1.02, ss, ha="center", fontsize=9, color="C3")
    ax.set_xticks(x, EPOC_CHANNELS, rotation=45, ha="right")
    ax.set_ylabel("TBR (Theta/Beta)")
    ax.set_title(f"Posture {p}: participant-paired TBR (paired n={n_paired})")
    ax.legend()
    fig.tight_layout()
    fig.savefig(path, dpi=200)


def cmd_participants(args):
    from eegsynth_torch import EPOC_CHANNELS
    from eegsynth_torch.analysis.participant_fatigue import (
        aggregate_fake, aggregate_real, collect_real,
    )

    out = Path(args.out)
    out.mkdir(parents=True, exist_ok=True)
    per_part = collect_real(Path(args.data_root), device=args.device)
    r_means, r_sds, r_pvals, counts = aggregate_real(per_part)
    s_means, s_sds, s_pvals = aggregate_fake(args.synth_dir, args.real_dir,
                                             inverse_scale=args.inverse_scale,
                                             real_counts=counts, device=args.device)
    rows = []
    for p in range(1, 10):
        # a posture counts if either condition has finite means on either side
        have_real = any(np.isfinite(r_means[p][c]).any()
                        for c in ("no_exo", "with_exo"))
        have_syn = any(np.isfinite(s_means[p][c]).any()
                       for c in ("no_exo", "with_exo"))
        if not (have_real or have_syn):
            continue
        bars = (("RN", r_means[p]["no_exo"], r_sds[p]["no_exo"]),
                ("RW", r_means[p]["with_exo"], r_sds[p]["with_exo"]),
                ("SN", s_means[p]["no_exo"], s_sds[p]["no_exo"]),
                ("SW", s_means[p]["with_exo"], s_sds[p]["with_exo"]))
        _participant_figure(p, bars, r_pvals[p], s_pvals[p], counts[p]["paired"],
                            out / f"posture{p}_participant_tbr.png")
        for ci, ch in enumerate(EPOC_CHANNELS):
            rows.append({"posture": p, "channel": ch,
                         "real_no_exo": r_means[p]["no_exo"][ci],
                         "real_with_exo": r_means[p]["with_exo"][ci],
                         "synth_no_exo": s_means[p]["no_exo"][ci],
                         "synth_with_exo": s_means[p]["with_exo"][ci],
                         "p_real_paired": r_pvals[p][ci],
                         "p_synth_paired": s_pvals[p][ci],
                         "n_paired_participants": counts[p]["paired"]})
        print(f"[participants] posture {p}: paired n={counts[p]['paired']}")
    if rows:
        with open(out / "participant_ttests.csv", "w", newline="") as fh:
            w = csv.DictWriter(fh, fieldnames=list(rows[0].keys()))
            w.writeheader()
            w.writerows(rows)


def main(argv: list[str] | None = None) -> None:
    ap = argparse.ArgumentParser(
        description="Mental-fatigue reports: the CSVs and figures of "
                    "scripts/fatigue_report.py.",
        formatter_class=argparse.ArgumentDefaultsHelpFormatter)
    sub = ap.add_subparsers(dest="cmd", required=True)
    p = sub.add_parser("participants", help="participant-paired TBR from raw CSVs")
    p.add_argument("--data-root", type=str, required=True,
                   help="raw CSV tree containing protocol_outputs_*")
    p.add_argument("--synth-dir", type=str, required=True,
                   help="timegan_runs root with posture*_*/synthetic.npz")
    p.add_argument("--real-dir", type=str, default=None,
                   help="preprocessed NPZs (for v2 inverse scaling / remap)")
    p.add_argument("--out", type=str, required=True)
    p.add_argument("--inverse-scale", action="store_true",
                   help="v2: invert min-max scaling + clamp to real range")
    p.set_defaults(fn=cmd_participants)
    for name, fn in (("bandpower", cmd_bandpower), ("indices", cmd_indices),
                     ("ttest", cmd_ttest), ("paired", cmd_paired)):
        p = sub.add_parser(name)
        p.add_argument("--root", type=str, required=True,
                       help="dir containing real/ and synthetic/ NPZ sets")
        p.add_argument("--out", type=str, required=True)
        if name == "ttest":
            p.add_argument("--scaling", type=str, default="none",
                           choices=["none", "p95", "median"])
            p.add_argument("--export-csv", action="store_true")
        p.set_defaults(fn=fn)
    for p in sub.choices.values():
        p.add_argument("--device", type=str, default="cuda",
                       help="where the spectra run (float64)")
    args = ap.parse_args(argv)
    args.device = torch.device(args.device)
    if args.device.type == "cuda" and not torch.cuda.is_available():
        raise SystemExit("--device cuda: no CUDA device is available")
    args.fn(args)


if __name__ == "__main__":
    main()
