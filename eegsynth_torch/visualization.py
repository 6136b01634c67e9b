"""PCA / t-SNE cluster figures over every (posture, condition) real/synthetic
pair: the CLI of ``scripts/visualization.py`` with its flags, plus
``--device`` (default ``cuda``: the embeddings run on the card).

    python -m eegsynth_torch.visualization --real_dir <dir of posture*_*.npz> \\
        --synth_dir <runs dir> --out <dir> [--zooms] [--paired-legend] \\
        [--separate-legend] [--color_scheme 36|18] [--dark-posture 2] \\
        [--tsne_max 6000] [--pca_keep 50] [--device cpu]

It writes pca_combined.png and tsne_combined.png, with ``--zooms``
zoom_p{p}_{cond}_{pca,tsne}.png, with ``--separate-legend``
{pca,tsne}_combined_legend.png. No matplotlib or scikit-learn is needed.
"""

from __future__ import annotations

import argparse
from pathlib import Path

import numpy as np
import torch


def main(argv: list[str] | None = None) -> None:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0],
                                 formatter_class=argparse.ArgumentDefaultsHelpFormatter)
    ap.add_argument("--real_dir", type=str, default="./preprocessed")
    ap.add_argument("--synth_dir", type=str, default="./timegan_runs")
    ap.add_argument("--out", type=str, default="./eval_out_plots")
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--tsne_perplexity", type=float, default=30.0)
    ap.add_argument("--tsne_max", type=int, default=6000)
    ap.add_argument("--pca_keep", type=int, default=50)
    ap.add_argument("--winsor_low", type=float, default=0.005)
    ap.add_argument("--winsor_high", type=float, default=0.995)
    ap.add_argument("--color_scheme", type=str, choices=["36", "18"], default="36")
    ap.add_argument("--zooms", action="store_true",
                    help="per-(posture,condition) zoom figures (fresh subset "
                         "PCA/t-SNE embeddings, global colors)")
    ap.add_argument("--separate-legend", action="store_true",
                    help="write legends as standalone PNGs")
    ap.add_argument("--paired-legend", action="store_true",
                    help="fixed 2-column (Real, Synthetic) enumeration legend")
    ap.add_argument("--dark-posture", type=int, default=None,
                    help="force this posture onto the darker low palette indices "
                         "(pass 2 for the reference rendering)")
    ap.add_argument("--device", type=str, default="cuda",
                    help="where the scaling, PCA and t-SNE run (cpu or cuda)")
    args = ap.parse_args(argv)

    device = torch.device(args.device)
    if device.type == "cuda" and not torch.cuda.is_available():
        raise SystemExit("--device cuda: no CUDA device is available")
    np.random.seed(args.seed)
    from eegsynth_torch.eval.drivers import load_pairs_by_condition
    from eegsynth_torch.viz.cluster import cluster_figures

    pairs = load_pairs_by_condition(Path(args.real_dir), Path(args.synth_dir))
    if not pairs:
        raise SystemExit("No matching (posture, condition) pairs found.")
    cluster_figures(pairs, args.out, color_scheme=args.color_scheme,
                    seed=args.seed, tsne_perplexity=args.tsne_perplexity,
                    tsne_max=args.tsne_max, pca_keep=args.pca_keep,
                    winsor_low=args.winsor_low, winsor_high=args.winsor_high,
                    zooms=args.zooms, separate_legend=args.separate_legend,
                    paired_legend=args.paired_legend,
                    dark_posture=args.dark_posture, device=device)
    print(f"Saved PCA and t-SNE to {args.out}")


if __name__ == "__main__":
    main()
