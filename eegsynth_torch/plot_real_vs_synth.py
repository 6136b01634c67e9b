"""Real-vs-synthetic trace figures for every (posture, condition) pair: the
CLI of ``scripts/plot_real_vs_synth.py`` with its flags.

    python -m eegsynth_torch.plot_real_vs_synth --real_dir <dir of posture*_*.npz> \\
        --synth_dir <runs dir> --out <dir> [--n_samples 4] [--no-auto-trim] \\
        [--fixed-trim 16] [--no-trim-both] [--no-standardize] [--smooth 5] \\
        [--first_k 4]

Per pair it writes samples_posture{p}_{cond}.png (channels × samples) and
summary_posture{p}_{cond}.png (mean ± σ per channel). The traces are numpy
on the host and drawn by the port's raster layer; nothing runs on a device
and no matplotlib is needed.
"""

from __future__ import annotations

import argparse
from pathlib import Path

import numpy as np


def main(argv: list[str] | None = None) -> None:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0],
                                 formatter_class=argparse.ArgumentDefaultsHelpFormatter)
    ap.add_argument("--real_dir", type=str, default="./preprocessed")
    ap.add_argument("--synth_dir", type=str, default="./timegan_runs")
    ap.add_argument("--out", type=str, default="./trace_plots")
    ap.add_argument("--n_samples", type=int, default=4)
    ap.add_argument("--no-auto-trim", dest="auto_trim", action="store_false")
    ap.add_argument("--fixed-trim", type=int, default=0)
    ap.add_argument("--no-trim-both", dest="trim_both", action="store_false",
                    help="trim only the synthetic side (reference TRIM_BOTH=False)")
    ap.add_argument("--no-standardize", dest="standardize", action="store_false")
    ap.add_argument("--smooth", type=int, default=1)
    ap.add_argument("--first_k", type=int, default=0,
                    help=">0: plot only the first K channels")
    args = ap.parse_args(argv)

    from eegsynth_torch.eval.drivers import load_pairs_by_condition
    from eegsynth_torch.viz.traces import plot_pair

    pairs = load_pairs_by_condition(Path(args.real_dir), Path(args.synth_dir))
    if not pairs:
        raise SystemExit("No matching (posture, condition) pairs found.")
    for (p, cond), (real, fake) in sorted(pairs.items()):
        rfp = Path(args.real_dir) / f"posture{p}_{cond}.npz"
        with np.load(rfp, allow_pickle=True) as z:
            fs = float(z["fs"]) if "fs" in z.files else 128.0
            ch_names = ([str(c) for c in z["ch_names"].tolist()] if "ch_names" in z.files
                        else [f"ch{i}" for i in range(real.shape[2])])
        stem = f"posture{p}_{cond}"
        L = plot_pair(real, fake, ch_names, fs, args.out, stem,
                      n_samples=args.n_samples, auto_trim=args.auto_trim,
                      fixed_trim=args.fixed_trim, trim_both=args.trim_both,
                      standardize=args.standardize, smooth=args.smooth,
                      plot_all_channels=args.first_k <= 0, first_k=args.first_k)
        print(f"[ok] {stem}: trimmed {L} samples -> plots saved")


if __name__ == "__main__":
    main()
