"""Saturation controls for the TimeGAN discriminative score (GRU scorers).

The CLI of ``scripts/disc_controls_timegan.py``. For each real bucket and
each scorer seed it scores arms whose answer is known:

- ``noise_<sigma>``: real against real + N(0, sigma) on the [0, 1] scale
  (sigma 0.001 is about 60 dB SNR, 0.01 about 40 dB);
- ``half``: one random half of the bucket against the other half, the
  protocol's floor at N/2 against N/2.

The arms come from the same numpy calls as the JAX script, so both packages
score the same pairs bit for bit. The scoring is the port's
``discriminative_scores_batch``: every arm's GRU(24) scorer of one seed is
trained in one stack (K1 forward and backward on the card). Writes
``controls.csv`` (``bucket,N,arm,seed,acc,auc``) and prints the median
accuracy over seeds per bucket and arm.

    python -m eegsynth_torch.eval.disc_controls --real_dir ./preprocessed \\
        --out ./timegan_disc_controls --device cuda
"""

from __future__ import annotations

import argparse
from pathlib import Path

import numpy as np
import torch

from eegsynth_torch.eval.classifiers import discriminative_scores_batch

CSV_HEADER = "bucket,N,arm,seed,acc,auc\n"


def control_arms(sigmas: list[float]) -> list[tuple[str, float | None]]:
    """(arm name, sigma or None) in the order they are drawn and scored."""
    return [(f"noise_{sig:g}", sig) for sig in sigmas] + [("half", None)]


def control_pairs(X: np.ndarray, sigmas: list[float], seed: int) -> tuple[list, list]:
    """(pairs, names) of one bucket X (N, T, C) float32 for one scorer seed:
    one ``np.random.default_rng(10_000 + seed)`` drawn through the arms in
    order."""
    rng = np.random.default_rng(10_000 + seed)
    N = len(X)
    pairs, names = [], []
    for name, sig in control_arms(sigmas):
        if sig is None:
            perm = rng.permutation(N)
            pairs.append((X[perm[: N // 2]], X[perm[N // 2:]]))
        else:
            pairs.append((X, X + rng.normal(0.0, sig, X.shape).astype(np.float32)))
        names.append(name)
    return pairs, names


def run_controls(buckets: list[Path], sigmas: list[float], seeds: list[int],
                 epochs: int, *, device: torch.device | str) -> list[tuple]:
    """Rows (bucket, N, arm, seed, acc, auc) of every bucket, seed and arm."""
    rows = []
    for fp in buckets:
        with np.load(fp) as z:
            X = z["X"].astype(np.float32)
        for seed in seeds:
            pairs, names = control_pairs(X, sigmas, seed)
            scores = discriminative_scores_batch(pairs, epochs=epochs, seed=seed,
                                                 device=device)
            for name, (acc, auc) in zip(names, scores):
                rows.append((fp.stem, len(X), name, seed, float(acc), float(auc)))
                print(f"{fp.stem:22s} N={len(X):3d} {name:12s} seed={seed} "
                      f"acc={acc:.3f} auc={auc:.3f}", flush=True)
    return rows


def write_csv(rows: list[tuple], path: Path) -> None:
    with open(path, "w") as f:
        f.write(CSV_HEADER)
        for r in rows:
            f.write(",".join(str(v) for v in r) + "\n")


def median_table(rows: list[tuple]) -> dict:
    """{(bucket, N): {arm: median accuracy over seeds}}."""
    by = {}
    for b, n, a, _, acc, _ in rows:
        by.setdefault((b, n), {}).setdefault(a, []).append(acc)
    return {k: {a: float(np.median(v)) for a, v in d.items()} for k, d in by.items()}


def main(argv: list[str] | None = None) -> list[tuple]:
    ap = argparse.ArgumentParser(
        description="Saturation controls of the TimeGAN discriminative score "
                    "(the port of scripts/disc_controls_timegan.py)")
    ap.add_argument("--real_dir", type=str, required=True,
                    help="directory of posture*_*.npz buckets")
    ap.add_argument("--out", type=str, default="docs/timegan_disc_controls")
    ap.add_argument("--sigmas", type=float, nargs="+", default=[0.001, 0.01])
    ap.add_argument("--seeds", type=int, nargs="+", default=[0, 1, 2])
    ap.add_argument("--epochs", type=int, default=20,
                    help="scorer training epochs (the eval's setting)")
    ap.add_argument("--device", type=str, default="cuda",
                    help="cuda (the kernels) or cpu (their plain versions)")
    args = ap.parse_args(argv)

    device = torch.device(args.device)
    if device.type == "cuda" and not torch.cuda.is_available():
        raise SystemExit("--device cuda: no CUDA device is available")
    out = Path(args.out)
    out.mkdir(parents=True, exist_ok=True)
    buckets = sorted(Path(args.real_dir).glob("posture*_*.npz"))
    if not buckets:
        raise SystemExit(f"no buckets under {args.real_dir}")
    rows = run_controls(buckets, args.sigmas, args.seeds, args.epochs, device=device)
    csv = out / "controls.csv"
    write_csv(rows, csv)
    print(f"\nwrote {csv}")

    table = median_table(rows)
    arms = list(dict.fromkeys(r[2] for r in rows))
    print(f"\n{'bucket':22s} {'N':>3s} " + " ".join(f"{a:>12s}" for a in arms))
    for (b, n), d in table.items():
        print(f"{b:22s} {n:3d} " + " ".join(f"{d[a]:12.3f}" for a in arms))
    return rows


if __name__ == "__main__":
    main()
