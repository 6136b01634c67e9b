"""Per-bucket G-loss weight tuning with best-of-k replica selection.

The CLI of ``scripts/tune_bucket_weights.py``. One bucket's windows are
copied under candidate × replica names (``{stem}_c{c}r{r}``) into
``<out>/replicas_data``, and the whole grid trains as one stacked
``train_all_buckets`` job with ``bucket_weights``. Each replica keeps its
own streams, seeded from (seed, bucket index) as JAX folds the bucket index
into its key, so the replicas see the run-to-run variance a deployment
sees (the weight sweep, ``train/timegan_sweep.py``, shares one stream
instead). Each replica's synthetic corpus is scored against the real bucket
(PSD, ACF and correlation differences); ``results.json`` holds every
replica's row, and the per-candidate median and the best replica on
``--metric`` are printed.

    python -m eegsynth_torch.tune_bucket_weights --npz posture2_with_exo.npz \\
        --out ./tune --replicas 3 --config configs/timegan_config.json \\
        --grid '[{"gamma_acf": 0.15, "gamma_cov": 0.15}, {"gamma_acf": 0.1}]'
"""

from __future__ import annotations

import argparse
import json
import shutil
from pathlib import Path

import numpy as np
import torch

from eegsynth_torch.eval.stats import statistical_similarity
from eegsynth_torch.train.timegan import CONFIG_KEYS
from eegsynth_torch.train.timegan_multi import train_all_buckets


def load_config(path: Path) -> dict:
    """A trainer config: JSON, or YAML where PyYAML is installed (the copy of
    ``scripts/train_timegan.py``'s ``load_config``)."""
    if not path.exists():
        raise SystemExit(f"Config file not found: {path}")
    if path.suffix.lower() in {".yaml", ".yml"}:
        try:
            import yaml
        except ImportError as e:
            raise SystemExit("YAML config requested but PyYAML is not installed; "
                             "use JSON.") from e
        with open(path, encoding="utf-8") as f:
            return yaml.safe_load(f)
    with open(path, encoding="utf-8") as f:
        return json.load(f)


def replica_names(stem: str, n_candidates: int, replicas: int) -> list[tuple]:
    """(name, candidate, replica) of every replica, candidate-major."""
    return [(f"{stem}_c{c}r{r}", c, r) for c in range(n_candidates)
            for r in range(replicas)]


def select(rows: list[dict], n_candidates: int, metric: str) -> tuple[list, dict]:
    """Per candidate (median of ``metric``, its best row); and the best row
    over all candidates (the first of equals)."""
    per, best = [], None
    for c in range(n_candidates):
        vals = [r for r in rows if r["candidate"] == c]
        top = min(vals, key=lambda v: v[metric])
        per.append((float(np.median([v[metric] for v in vals])), top))
        if best is None or top[metric] < best[metric]:
            best = top
    return per, best


def main(argv: list[str] | None = None) -> dict:
    """Returns ``{"rows", "best"}``: results.json's rows and the selected
    replica's row."""
    ap = argparse.ArgumentParser(
        formatter_class=argparse.ArgumentDefaultsHelpFormatter,
        description="Per-bucket weight tuning by candidate x replica stacks "
                    "(the port of scripts/tune_bucket_weights.py)")
    ap.add_argument("--npz", type=str, required=True, help="real bucket NPZ")
    ap.add_argument("--out", type=str, required=True)
    ap.add_argument("--grid", type=str, required=True,
                    help="JSON list of weight-override dicts (or a file path); "
                         "{} = config defaults")
    ap.add_argument("--replicas", type=int, default=3,
                    help="independent replicas per candidate")
    ap.add_argument("--config", type=str, default=None,
                    help="trainer config JSON (timegan_config.json schema)")
    ap.add_argument("--metric", choices=["acf", "psd", "coh"], default="acf",
                    help="the statistic that ranks replicas")
    ap.add_argument("--seed", type=int, default=None, help="override config seed")
    ap.add_argument("--device", type=str, default="cuda",
                    help="cuda (the kernels) or cpu (their plain versions)")
    args = ap.parse_args(argv)

    device = torch.device(args.device)
    if device.type == "cuda" and not torch.cuda.is_available():
        raise SystemExit("--device cuda: no CUDA device is available")
    grid = (json.loads(Path(args.grid).read_text()) if Path(args.grid).is_file()
            else json.loads(args.grid))
    if not isinstance(grid, list) or not all(isinstance(g, dict) for g in grid):
        raise SystemExit("--grid must be a JSON list of override dicts")

    src, out = Path(args.npz), Path(args.out)
    data_dir, runs_dir = out / "replicas_data", out / "runs"
    data_dir.mkdir(parents=True, exist_ok=True)
    names = replica_names(src.stem, len(grid), args.replicas)
    for name, _, _ in names:
        shutil.copy(src, data_dir / f"{name}.npz")

    hp = {}
    if args.config:
        cfg = load_config(Path(args.config))
        hp = {k: typ(cfg[k]) for k, typ in CONFIG_KEYS.items() if k in cfg}
    if args.seed is not None:
        hp["seed"] = args.seed
    print(f"[tune] {len(grid)} candidates × {args.replicas} replicas of {src.stem} "
          f"as one stacked job | {device}", flush=True)
    train_all_buckets(data_dir, runs_dir, device=device,
                      bucket_weights={n: grid[c] for n, c, _ in names if grid[c]},
                      **hp)

    with np.load(src) as real:
        X = real["X"].astype(np.float32)
        fs = float(real["fs"]) if "fs" in real.files else 128.0
    rows = []
    for name, c, r in names:
        with np.load(runs_dir / name / "synthetic.npz") as z:
            Xh = z["X"].astype(np.float32)
        psd, acf, coh = statistical_similarity(X, Xh, fs=fs, device=device)
        rows.append({"name": name, "candidate": c, "replica": r,
                     "overrides": grid[c], "psd": float(psd), "acf": float(acf),
                     "coh": float(coh)})
    with open(out / "results.json", "w") as f:
        json.dump(rows, f, indent=1)

    print(f"\n{'replica':30s} {'psd':>9s} {'acf':>8s} {'coh':>6s}")
    for r in rows:
        print(f"{r['name']:30s} {r['psd']:9.2e} {r['acf']:8.4f} {r['coh']:6.3f}")
    print(f"\nper-candidate {args.metric} median / best "
          f"(k={args.replicas} replicas each):")
    per, best = select(rows, len(grid), args.metric)
    for c, (med, top) in enumerate(per):
        print(f"  c{c} {grid[c]}: median {med:.4f}  best {top[args.metric]:.4f} "
              f"({top['name']})")
    print(f"\nbest-of-k selection: {runs_dir / best['name']}  ({args.metric}="
          f"{best[args.metric]:.4f}, overrides {best['overrides']})", flush=True)
    return {"rows": rows, "best": best}


if __name__ == "__main__":
    main()
