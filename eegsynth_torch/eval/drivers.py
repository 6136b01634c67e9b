"""TimeGAN evaluation driver: real/synthetic pair loading, the scorers and
statistics of every pair and of the global corpus, the metric CSVs and the
PCA / t-SNE figures.

Counterpart of ``eegsynth/eval/drivers.py``. The per-pair CSV is
``metrics_per_posture_condition.csv`` (one row per posture and condition,
``by_condition``) or ``metrics_per_posture.csv`` (conditions merged); both
runs also write ``metrics_global.csv``, ``pca_global.png`` and
``tsne_global.png`` (``--tsne_max`` caps the t-SNE's points;
``scripts/evaluate_18.py`` uses 6000). The PCA and t-SNE run on the device
(``viz/embed.py``), the drawing on the host; no matplotlib or scikit-learn
is needed.

Run it on the card (``--device cpu`` for the plain versions on the host):

    python -m eegsynth_torch.eval.drivers --real_dir <dir of posture*_*.npz> \\
        --synth_dir <runs dir> --out <out dir> [--by_condition] [--fs 128] \\
        [--tsne_max 6000]
"""

from __future__ import annotations

import argparse
import csv
import time
from pathlib import Path

import numpy as np
import torch

from eegsynth_torch.eval.classifiers import (
    discriminative_score, discriminative_scores_batch, predictive_score,
    predictive_scores_batch,
)
from eegsynth_torch.eval.stats import statistical_similarity
from eegsynth_torch.viz import embed, raster

METRIC_COLS = ["disc_acc", "disc_auc", "rmse_tstr", "r2_tstr", "rmse_trts",
               "r2_trts", "psd_diff", "acf_diff", "coh_diff",
               "n_real", "n_fake", "seq_len", "n_ch"]


def find_synth_npz(run_dir: Path) -> Path | None:
    """synthetic_long.npz, else synthetic.npz, else the first *.npz."""
    for name in ("synthetic_long.npz", "synthetic.npz"):
        c = run_dir / name
        if c.exists():
            return c
    all_npz = sorted(run_dir.glob("*.npz"))
    return all_npz[0] if all_npz else None


def load_posture_pairs(real_dir: Path, synth_dir: Path) -> dict:
    """posture → (real, fake), the conditions concatenated, each condition
    cut to its smaller count."""
    pairs = {}
    for p in range(1, 10):
        real_list, fake_list = [], []
        for cond in ("with_exo", "no_exo"):
            rfp = Path(real_dir) / f"posture{p}_{cond}.npz"
            sfp = Path(synth_dir) / f"posture{p}_{cond}" / "synthetic.npz"
            if rfp.exists() and sfp.exists():
                r = np.load(rfp)["X"].astype(np.float32)
                f = np.load(sfp)["X"].astype(np.float32)
                m = min(len(r), len(f))
                if m > 0:
                    real_list.append(r[:m])
                    fake_list.append(f[:m])
        if real_list and fake_list:
            pairs[p] = (np.concatenate(real_list), np.concatenate(fake_list))
    return pairs


def load_pairs_by_condition(real_dir: Path, synth_dir: Path) -> dict:
    """(posture, condition) → (real, fake), cut to the smaller count."""
    pairs = {}
    for p in range(1, 10):
        for cond in ("with_exo", "no_exo"):
            rfp = Path(real_dir) / f"posture{p}_{cond}.npz"
            sfp = find_synth_npz(Path(synth_dir) / f"posture{p}_{cond}")
            if rfp.exists() and sfp and sfp.exists():
                r = np.load(rfp)["X"].astype(np.float32)
                f = np.load(sfp)["X"].astype(np.float32)
                m = min(len(r), len(f))
                if m > 0:
                    pairs[(p, cond)] = (r[:m], f[:m])
    return pairs


def _metric_dict(real: np.ndarray, fake: np.ndarray, disc: tuple, tstr: tuple,
                 trts: tuple, fs: float, device: torch.device | str) -> dict:
    """One METRIC_COLS row from the scorers' results and the corpus's
    statistical similarity."""
    psd_diff, acf_diff, coh_diff = statistical_similarity(real, fake, fs=fs,
                                                          device=device)
    return {"disc_acc": disc[0], "disc_auc": disc[1],
            "rmse_tstr": tstr[0], "r2_tstr": tstr[1],
            "rmse_trts": trts[0], "r2_trts": trts[1],
            "psd_diff": psd_diff, "acf_diff": acf_diff, "coh_diff": coh_diff,
            "n_real": len(real), "n_fake": len(fake),
            "seq_len": real.shape[1], "n_ch": real.shape[2]}


def evaluate_pair(real: np.ndarray, fake: np.ndarray, fs: float = 128.0,
                  device: torch.device | str = "cuda") -> dict:
    """The full metric row of one real/fake corpus."""
    Xr_in, yr = real[:, :-1, :], real[:, -1, :]
    Xf_in, yf = fake[:, :-1, :], fake[:, -1, :]
    return _metric_dict(real, fake,
                        discriminative_score(real, fake, device=device),
                        predictive_score(Xf_in, yf, Xr_in, yr, device=device),
                        predictive_score(Xr_in, yr, Xf_in, yf, device=device),
                        fs, device)


def write_csv(path: Path, rows: list[dict], lead_cols: list[str]) -> None:
    cols = lead_cols + METRIC_COLS
    with open(path, "w", newline="") as f:
        w = csv.DictWriter(f, fieldnames=cols)
        w.writeheader()
        w.writerows(rows)


def scatter_by_posture(path: Path, emb: np.ndarray, labels: np.ndarray,
                       domain: np.ndarray, title: str) -> None:
    """Colour by posture (the colour cycle, real then generated), marker by
    domain (real ``o``, generated ``x``)."""
    fig, ax = raster.subplots(figsize=(7, 5))
    for pid in np.unique(labels):
        m_real = (labels == pid) & (domain == 1)
        m_fake = (labels == pid) & (domain == 0)
        ax.scatter(emb[m_real, 0], emb[m_real, 1], s=10, alpha=0.65, label=f"P{pid} real")
        ax.scatter(emb[m_fake, 0], emb[m_fake, 1], s=10, alpha=0.65, marker="x",
                   label=f"P{pid} gen")
    ax.set_title(title)
    ax.legend(bbox_to_anchor=(1.02, 1), loc="upper left", fontsize="small")
    fig.tight_layout()
    fig.savefig(path, dpi=160)


def pca_tsne_plots(out: Path, R: np.ndarray, F: np.ndarray, labels: np.ndarray,
                   domain: np.ndarray, tsne_max: int | None = None, *,
                   device: torch.device | str = "cuda") -> None:
    """pca_global.png (PCA-2 of every flattened window) and tsne_global.png
    (t-SNE of at most ``tsne_max`` of them, drawn by
    ``RandomState(0).permutation``), the embeddings on ``device``. Too few
    points for the t-SNE's perplexity skip its figure with a message; any
    other error propagates."""
    X_all = np.concatenate([R, F], axis=0).reshape(len(R) + len(F), -1)
    X = torch.as_tensor(X_all, device=device).to(torch.float64)
    pc = embed.pca(X, 2).cpu().numpy()
    scatter_by_posture(out / "pca_global.png", pc, labels, domain,
                       "PCA: posture clusters (real vs generated)")
    X_ts, lab_ts, dom_ts = X, labels, domain
    if tsne_max is not None and len(X_all) > tsne_max:
        idx = np.random.RandomState(0).permutation(len(X_all))[:tsne_max]
        X_ts = X[torch.as_tensor(idx, device=X.device)]
        lab_ts, dom_ts = labels[idx], domain[idx]
    try:
        ts2 = embed.tsne(X_ts, perplexity=30.0).embedding.cpu().numpy()
    except embed.TooFewPoints as e:
        print(f"t-SNE skipped: {e}")
        return
    scatter_by_posture(out / "tsne_global.png", ts2, lab_ts, dom_ts,
                       "t-SNE: posture clusters (real vs generated)")


def run_timegan_eval(real_dir, synth_dir, out, fs: float = 128.0,
                     by_condition: bool = False, tsne_max: int | None = None,
                     device: torch.device | str = "cuda") -> dict:
    """Score every real/synthetic pair and the global corpus; write the
    per-pair and the global metric CSVs and the PCA / t-SNE figures.
    Returns {"rows", "global", "seconds"}, the last the host time of each
    part (discriminative, predictive, statistics, csv, figures)."""
    out = Path(out)
    out.mkdir(parents=True, exist_ok=True)
    if by_condition:
        pairs = load_pairs_by_condition(Path(real_dir), Path(synth_dir))
        lead = ["posture", "condition"]
        per_csv = "metrics_per_posture_condition.csv"
    else:
        pairs = load_posture_pairs(Path(real_dir), Path(synth_dir))
        lead = ["posture"]
        per_csv = "metrics_per_posture.csv"
    if not pairs:
        raise SystemExit("No matching real/synthetic pairs found.")

    # Mixed sequence lengths: each pair is cut to its own min T, and only
    # the global concatenation to the min over all pairs; the pairs that
    # set a shorter T are named.
    t_pair = {k: min(r.shape[1], f.shape[1]) for k, (r, f) in pairs.items()}
    t_min = min(t_pair.values())
    if any(a.shape[1] != t_min for pair in pairs.values() for a in pair):
        t_max = max(max(r.shape[1], f.shape[1]) for r, f in pairs.values())
        offenders = sorted(str(k) for k, (r, f) in pairs.items()
                           if min(r.shape[1], f.shape[1]) < t_max)
        print(f"[eval] WARN: mixed sequence lengths across pairs "
              f"(min T={t_min} from {offenders}) — per-bucket stats use each "
              f"pair's own min T; the global concat truncates to T={t_min}",
              flush=True)
        pairs = {k: (r[:, :t_pair[k]], f[:, :t_pair[k]])
                 for k, (r, f) in pairs.items()}

    keys = sorted(pairs.keys())
    real_labels, fake_labels = [], []
    for keyid in keys:
        posture = keyid[0] if by_condition else keyid
        real_labels += [posture] * len(pairs[keyid][0])
        fake_labels += [posture] * len(pairs[keyid][1])
    R = np.concatenate([pairs[k][0][:, :t_min] for k in keys])
    F = np.concatenate([pairs[k][1][:, :t_min] for k in keys])
    corpora = [pairs[k] for k in keys] + [(R, F)]
    seconds = {}

    t0 = time.perf_counter()
    print(f"[eval] training {len(corpora)} discriminative scorers on {device}...",
          flush=True)
    disc = discriminative_scores_batch(corpora, device=device)
    seconds["discriminative"] = time.perf_counter() - t0

    t0 = time.perf_counter()
    pred_tasks = []
    for real, fake in corpora:
        Xr_in, yr = real[:, :-1, :], real[:, -1, :]
        Xf_in, yf = fake[:, :-1, :], fake[:, -1, :]
        pred_tasks.append((Xf_in, yf, Xr_in, yr))   # TSTR
        pred_tasks.append((Xr_in, yr, Xf_in, yf))   # TRTS
    print(f"[eval] training {len(pred_tasks)} predictive scorers (TSTR+TRTS)...",
          flush=True)
    pred = predictive_scores_batch(pred_tasks, device=device)
    seconds["predictive"] = time.perf_counter() - t0

    t0 = time.perf_counter()
    rows = []
    for i, keyid in enumerate(keys):
        row = _metric_dict(*corpora[i], disc[i], pred[2 * i], pred[2 * i + 1],
                           fs, device)
        if by_condition:
            row = {"posture": keyid[0], "condition": keyid[1], **row}
        else:
            row = {"posture": keyid, **row}
        rows.append(row)
        print(f"[eval] {keyid}: disc_acc={row['disc_acc']:.4f} "
              f"psd={row['psd_diff']:.2e} acf={row['acf_diff']:.4f} "
              f"coh={row['coh_diff']:.4f}", flush=True)
    g = _metric_dict(R, F, disc[-1], pred[-2], pred[-1], fs, device)
    seconds["statistics"] = time.perf_counter() - t0

    t0 = time.perf_counter()
    write_csv(out / per_csv, rows, lead)
    write_csv(out / "metrics_global.csv", [g], [])
    seconds["csv"] = time.perf_counter() - t0

    # labels and domain all real then all generated, as the [R; F] rows
    t0 = time.perf_counter()
    labels = np.array(real_labels + fake_labels)
    domain = np.array([1] * len(R) + [0] * len(F))
    pca_tsne_plots(out, R, F, labels, domain, tsne_max, device=device)
    seconds["figures"] = time.perf_counter() - t0
    print(f"Wrote {out / per_csv} and {out / 'metrics_global.csv'}", flush=True)
    return {"rows": rows, "global": g, "seconds": seconds}


def main(argv: list[str] | None = None) -> dict:
    ap = argparse.ArgumentParser(
        description="TimeGAN eval: per-pair and global metric CSVs. With "
                    "--by_condition one row per posture and condition, else "
                    "per posture with the conditions merged.",
        formatter_class=argparse.ArgumentDefaultsHelpFormatter)
    ap.add_argument("--real_dir", type=str, default="./preprocessed")
    ap.add_argument("--synth_dir", type=str, default="./timegan_runs")
    ap.add_argument("--out", type=str, default="./eval_out")
    ap.add_argument("--fs", type=float, default=128.0)
    ap.add_argument("--by_condition", action="store_true")
    ap.add_argument("--tsne_max", type=int, default=None,
                    help="t-SNE over at most this many windows (evaluate_18.py: "
                         "6000); default all")
    ap.add_argument("--device", type=str, default="cuda")
    ap.add_argument("--mesh", action="store_true",
                    help="refused: the scorers run on one device (--device)")
    args = ap.parse_args(argv)
    if args.mesh:
        raise SystemExit("--mesh has no counterpart in eegsynth_torch: the scorer "
                         "stacks run on one device (--device), not sharded over a mesh")
    return run_timegan_eval(args.real_dir, args.synth_dir, args.out, fs=args.fs,
                            by_condition=args.by_condition, tsne_max=args.tsne_max,
                            device=args.device)


if __name__ == "__main__":
    main()
