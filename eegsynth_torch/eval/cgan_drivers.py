#!/usr/bin/env python3
"""CGAN eval drivers: the v1 per-condition eval and the v2/v3 per-posture
eval, with the CSV trios of ``eval/cgan_eval.py``.

Counterpart of ``scripts/eval_cgan.py`` (``condition``) and
``scripts/eval_cgan_posture.py`` (``posture``), with the same flags and
behaviour; ``--platform`` becomes ``--device`` (default ``cuda``). Real
windows are assembled and subsampled with the global numpy generator
seeded from ``--seed``, as the scripts do, so the real rows are the same
index for index. Generated windows come from the port's
``train.cgan.load_generator`` / ``generate_batch`` with a
``torch.Generator`` on the device seeded from ``--seed`` (per condition in
``condition``, once in ``posture``), so they do not reproduce the JAX
package's draws. The scatter plots are not ported.

    python -m eegsynth_torch.eval.cgan_drivers condition --data-dir ./preprocessed \\
        --runs-root ./cgan_runs --save-root ./cgan_eval [--condition no_exo]
    python -m eegsynth_torch.eval.cgan_drivers posture --data-dir ./preprocessed \\
        --runs-root ./cgan_runs_posture --save-root ./cgan_eval_posture \\
        [--postures 1,2,8] [--samples-per-cond match] [--v2-split]
"""

from __future__ import annotations

import argparse
import time
from pathlib import Path

import numpy as np
import torch

from eegsynth_torch.data.datasets import (
    load_condition_dataset, load_posture_both_conditions,
)
from eegsynth_torch.eval.cgan_eval import (
    NUM_POSTURES, discriminative_metrics, evaluate_condition, predictive_scores,
    stats_similarity,
)
from eegsynth_torch.train.cgan import generate_batch, load_generator


def _generate(G, bn, cfg, generator: torch.Generator, n: int, label: int) -> np.ndarray:
    return generate_batch(G, bn, cfg, generator, n, label).cpu().numpy()


def eval_conditions(args, device: torch.device) -> dict:
    """``scripts/eval_cgan.py``: per condition, ``samples_per_posture`` real
    windows of each posture (shuffled) against as many generated ones;
    returns condition → seconds of generation and of each metric family."""
    np.random.seed(args.seed)
    conditions = (["with_exo", "no_exo"] if args.condition == "both"
                  else [args.condition])
    seconds = {}
    for condition in conditions:
        Xr, yr, _ = load_condition_dataset(args.data_dir, condition)
        npp = args.samples_per_posture
        keep = []
        for p in range(1, NUM_POSTURES + 1):
            idx = np.where(yr == p)[0]
            if len(idx):
                np.random.shuffle(idx)
                keep.append(idx[:min(npp, len(idx))])
        if keep:
            keep = np.concatenate(keep)
            Xr, yr = Xr[keep], yr[keep]

        run_dir = Path(args.runs_root) / condition
        gpath = run_dir / f"CGAN_generator_{condition}_best.npz"
        if not gpath.exists():
            gpath = run_dir / f"CGAN_generator_{condition}_last.npz"
        # arch (conv or transformer) is rebuilt from the checkpoint meta
        G, bn, cfg, _ = load_generator(gpath, num_classes=NUM_POSTURES, device=device)
        print(f"[{condition}] Loaded generator: {gpath}")

        t0 = time.perf_counter()
        generator = torch.Generator(device=device).manual_seed(args.seed)
        Xg = np.concatenate([_generate(G, bn, cfg, generator, npp, p - 1)
                             for p in range(1, NUM_POSTURES + 1)], 0)
        yg = np.repeat(np.arange(1, NUM_POSTURES + 1, dtype=np.int64), npp)
        gen_s = time.perf_counter() - t0

        out_dir = Path(args.save_root) / condition
        seconds[condition] = {"generation": gen_s,
                              **evaluate_condition(Xr, yr, Xg, yg, out_dir, args.seed,
                                                   device=device)}
        print(f"[{condition}] Saved results to {out_dir}")
    return seconds


def _csv_trio(R, Gx, yr, yg, out: Path, args, device) -> None:
    out.mkdir(parents=True, exist_ok=True)
    discriminative_metrics(R, Gx, yr, yg, out / "metrics_discriminative.csv",
                           args.seed, v2_split=args.v2_split, device=device)
    predictive_scores(R, Gx, yr, yg, out / "metrics_predictive.csv",
                      seed=args.seed, device=device)
    stats_similarity(R, Gx, yr, yg, out / "metrics_stats.csv", device=device)


def eval_postures(args, device: torch.device) -> list[int]:
    """``scripts/eval_cgan_posture.py``: per posture, both conditions' real
    windows against generated ones (``--samples-per-cond``, or the smaller
    real count with ``match``), cut to a common count; then every evaluated
    posture together under ``global/``. Returns the postures evaluated."""
    np.random.seed(args.seed)
    postures = (list(range(1, 10)) if args.postures == "all"
                else [int(p) for p in args.postures.split(",")])
    if args.v2_split and postures != sorted(postures):
        # the v2 positional selection assumes posture blocks in ascending
        # order; another order would reproduce neither v2 nor v3
        print(f"--v2-split requires ascending posture order; sorting {postures}")
        postures = sorted(postures)
    save_root = Path(args.save_root)
    save_root.mkdir(parents=True, exist_ok=True)

    glob_r, glob_g, glob_yr, glob_yg, done = [], [], [], [], []
    generator = torch.Generator(device=device).manual_seed(args.seed)
    for p in postures:
        X, y, _ = load_posture_both_conditions(args.data_dir, p)
        real = {c: X[y == c] for c in (0, 1)}

        run_dir = Path(args.runs_root) / f"posture{p}"
        gpath = run_dir / f"CGAN_generator_posture{p}_best.npz"
        if not gpath.exists():
            gpath = run_dir / f"CGAN_generator_posture{p}_last.npz"
        if not gpath.exists():
            print(f"[posture {p}] no generator found under {run_dir}; skipping")
            continue
        G, bn, cfg, _ = load_generator(gpath, num_classes=2, variant="v2",
                                       device=device)

        if args.samples_per_cond.lower() == "match":
            n_synth = min(real[0].shape[0], real[1].shape[0])
        else:
            n_synth = int(args.samples_per_cond)
        fakes = {c: _generate(G, bn, cfg, generator, n_synth, c) for c in (0, 1)}

        n = min(real[0].shape[0], real[1].shape[0], n_synth)
        R = np.concatenate([real[0][:n], real[1][:n]], 0)
        Gx = np.concatenate([fakes[0][:n], fakes[1][:n]], 0)
        yr = np.full(len(R), p, np.int64)
        yg = np.full(len(Gx), p, np.int64)
        _csv_trio(R, Gx, yr, yg, save_root / f"posture{p}", args, device)
        print(f"[posture {p}] evaluated ({len(R)} real / {len(Gx)} gen)")
        glob_r.append(R)
        glob_g.append(Gx)
        glob_yr.append(yr)
        glob_yg.append(yg)
        done.append(p)

    if glob_r:
        _csv_trio(np.concatenate(glob_r), np.concatenate(glob_g),
                  np.concatenate(glob_yr), np.concatenate(glob_yg),
                  save_root / "global", args, device)
        print(f"Saved all evaluations under: {save_root}")
    return done


def main(argv: list[str] | None = None):
    ap = argparse.ArgumentParser(
        description="CGAN eval: metric CSVs per condition (v1) or per posture "
                    "(v2/v3)",
        formatter_class=argparse.ArgumentDefaultsHelpFormatter)
    sub = ap.add_subparsers(dest="cmd", required=True)
    cond = sub.add_parser("condition", help="v1: scripts/eval_cgan.py",
                          formatter_class=argparse.ArgumentDefaultsHelpFormatter)
    cond.add_argument("--data-dir", type=str, default="./preprocessed")
    cond.add_argument("--runs-root", type=str, default="./cgan_runs")
    cond.add_argument("--save-root", type=str, default="./cgan_eval")
    cond.add_argument("--condition", type=str, default="both",
                      choices=["both", "with_exo", "no_exo"])
    cond.add_argument("--samples-per-posture", type=int, default=400)
    cond.add_argument("--tsne-perplexity", type=float, default=30.0,
                      help="unused: the scatter plots are not ported")
    post = sub.add_parser("posture", help="v2/v3: scripts/eval_cgan_posture.py",
                          formatter_class=argparse.ArgumentDefaultsHelpFormatter)
    post.add_argument("--data-dir", type=str, default="./preprocessed")
    post.add_argument("--runs-root", type=str, default="./cgan_runs_posture")
    post.add_argument("--save-root", type=str, default="./cgan_eval_posture")
    post.add_argument("--postures", type=str, default="all")
    post.add_argument("--samples-per-cond", type=str, default="match")
    post.add_argument("--v2-split", action="store_true",
                      help="reproduce eval_cgan_v2.py's per-posture "
                           "discriminative selection including its positional "
                           "bug (default: the eval_cgan_v3.py fixed split)")
    for p in (cond, post):
        p.add_argument("--noise-dim", type=int, default=100,
                       help="unused: noise_dim is read from checkpoint meta")
        p.add_argument("--seed", type=int, default=123)
        p.add_argument("--device", type=str, default="cuda",
                       help="cuda, or cpu for the plain versions")
    args = ap.parse_args(argv)

    device = torch.device(args.device)
    if device.type == "cuda" and not torch.cuda.is_available():
        raise SystemExit("--device cuda: no CUDA device is available")
    if args.cmd == "condition":
        return eval_conditions(args, device)
    return eval_postures(args, device)


if __name__ == "__main__":
    main()
