"""36-cluster PCA / t-SNE figures of the per-posture CGAN family: the CLI of
``scripts/visualization_cgan.py`` with its flags; ``--platform`` becomes
``--device`` (default ``cuda``).

    python -m eegsynth_torch.visualization_cgan --data-dir <dir of posture*_*.npz> \\
        --runs-root <v2 runs> --out <dir> [--postures 1,2] \\
        [--samples-per-cond match] [--tsne-perplexity 30] [--no-zooms] [--device cpu]

Per posture with both condition buckets and a generator
(``<runs-root>/posture{p}/CGAN_generator_posture{p}_{best,last}.npz``), it
generates as many windows of each condition as the smaller real count
(``match``) or ``--samples-per-cond``, embeds the 64-bin log-PSD features of
real and generated windows (one z-scoring over all, NaN and ±inf to 0), and
writes pca_36.png and tsne_36.png with the paired legend, and unless
``--no-zooms`` zooms/zoom_p{p}_{cond}_{pca,tsne}.png with fresh subset
embeddings. The noise comes from one ``torch.Generator`` on the device
seeded from ``--seed``, so the windows are not the JAX package's draws. No
matplotlib or scikit-learn is needed.
"""

from __future__ import annotations

import argparse
from pathlib import Path

import numpy as np
import torch

COND_NAME = {0: "no_exo", 1: "with_exo"}


def main(argv: list[str] | None = None) -> None:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0],
                                 formatter_class=argparse.ArgumentDefaultsHelpFormatter)
    ap.add_argument("--data-dir", type=str, default="./preprocessed")
    ap.add_argument("--runs-root", type=str, default="./cgan_runs_posture")
    ap.add_argument("--out", type=str, default="./cgan_viz_out")
    ap.add_argument("--postures", type=str, default="all")
    ap.add_argument("--samples-per-cond", type=str, default="match",
                    help='"match" real counts or an integer')
    ap.add_argument("--tsne-perplexity", type=float, default=30.0)
    ap.add_argument("--seed", type=int, default=123)
    ap.add_argument("--no-zooms", action="store_true",
                    help="global figures only (visualization_v2.py contract)")
    ap.add_argument("--device", type=str, default="cuda",
                    help="where the generators, features and embeddings run")
    args = ap.parse_args(argv)

    device = torch.device(args.device)
    if device.type == "cuda" and not torch.cuda.is_available():
        raise SystemExit("--device cuda: no CUDA device is available")
    from eegsynth_torch.data.datasets import load_posture_both_conditions
    from eegsynth_torch.eval.features import psd_features_tensor
    from eegsynth_torch.train.cgan import generate_batch, load_generator
    from eegsynth_torch.viz import embed, raster
    from eegsynth_torch.viz.cluster import (
        add_paired_legend, make_palette, scatter_clusters, tsne_embed,
        zoom_pair_figures,
    )

    np.random.seed(args.seed)
    postures = (range(1, 10) if args.postures == "all"
                else [int(p) for p in args.postures.split(",")])
    out_dir = Path(args.out)
    out_dir.mkdir(parents=True, exist_ok=True)

    feats, P, D, C = [], [], [], []
    generator = torch.Generator(device=device).manual_seed(args.seed)
    for p in postures:
        try:
            X, y, _ = load_posture_both_conditions(args.data_dir, p)
        except SystemExit:  # the loader raises on a missing condition bucket
            print(f"[posture {p}] real NPZs missing; skipping")
            continue
        real = {c: X[y == c] for c in (0, 1)}

        run_dir = Path(args.runs_root) / f"posture{p}"
        gpath = run_dir / f"CGAN_generator_posture{p}_best.npz"
        if not gpath.exists():
            gpath = run_dir / f"CGAN_generator_posture{p}_last.npz"
        if not gpath.exists():
            print(f"[posture {p}] no generator found under {run_dir}; skipping")
            continue
        G, bn, cfg, _ = load_generator(gpath, num_classes=2, variant="v2", device=device)

        if args.samples_per_cond.lower() == "match":
            n_synth = min(real[0].shape[0], real[1].shape[0])
        else:
            n_synth = int(args.samples_per_cond)
        n = min(real[0].shape[0], real[1].shape[0], n_synth)
        if n == 0:
            print(f"[posture {p}] a condition has no real data; skipping")
            continue
        for c in (0, 1):
            fake = generate_batch(G, bn, cfg, generator, n, c)
            Fr = psd_features_tensor(real[c][:n], device=device)
            Fg = psd_features_tensor(fake, device=device)
            feats.extend([Fr, Fg])
            P += [p] * (len(Fr) + len(Fg))
            D += [1] * len(Fr) + [0] * len(Fg)
            C += [COND_NAME[c]] * (len(Fr) + len(Fg))
        print(f"[posture {p}] featurized ({n} per condition per domain)")

    if not feats:
        raise SystemExit("No (real data, generator) pairs found.")
    P, D, C = np.array(P), np.array(D), np.array(C)
    X = torch.nan_to_num(embed.standard_scale(torch.cat(feats)), nan=0.0, posinf=0.0,
                         neginf=0.0)
    colors = make_palette(36)

    def one_plot(emb, name, title):
        fig, ax = raster.subplots(figsize=(8.6, 5.8))
        scatter_clusters(ax, emb, P, D, C, colors, "36")
        ax.set_title(title)
        ax.set_xlabel("Dim 1")
        ax.set_ylabel("Dim 2")
        fig.subplots_adjust(right=0.78)
        add_paired_legend(ax, colors, "36")
        fig.savefig(out_dir / f"{name}.png", dpi=170)

    one_plot(embed.pca(X, 2).cpu().numpy(), "pca_36",
             "PCA: 9 Postures × 2 Conditions × {Real, Synthetic}")
    Z = tsne_embed(X, args.seed, pca_keep=50, perplexity=args.tsne_perplexity)
    one_plot(Z, "tsne_36", "t-SNE: 9 Postures × 2 Conditions × {Real, Synthetic}")

    if not args.no_zooms:
        out_zoom = out_dir / "zooms"
        out_zoom.mkdir(parents=True, exist_ok=True)
        for p in sorted(set(P.tolist())):
            for cond in ("no_exo", "with_exo"):
                zoom_pair_figures(X, P, D, C, colors, p, cond, out_zoom,
                                  color_scheme="36", seed=args.seed, pca_keep=50,
                                  tsne_perplexity=args.tsne_perplexity)
    print(f"Saved global and zoom plots to {out_dir}")


if __name__ == "__main__":
    main()
