"""CGAN G-loss weight sweep: S weight settings of one condition, one stack.

Counterpart of ``eegsynth/train/cgan_sweep.py`` and the CLI of
``scripts/sweep_cgan.py``. Every sweep point starts from the same weights
and consumes the same draws (the same balanced batches and noise); the
points differ only in their G-loss weight vector (``G_WEIGHT_NAMES``), so
the differences between points are the weights' effect, not run-to-run
variance. Each step draws once and runs ``cgan_step`` for every point in
turn with its own vector; two points with equal weights train bit for bit
alike.

Each point's directory ``sweep{i}/`` holds ``hparams.json`` (the hparams,
the resolved weights, ``tag`` and ``sweep_overrides``) and the generator's
``CGAN_generator_sweep{i}_best.npz`` (when an adversarial epoch ran) and
``_last.npz``, which ``train.cgan.load_generator`` reads. The CLI then
scores every point against the real condition (PSD, ACF and coherence
distances, and the discriminative metrics) and writes
``sweep_results.json``. ``--arch transformer`` is the default, with
``tf_remat`` on unless ``--no-tf-remat``.

    python -m eegsynth_torch.train.cgan_sweep --smoke-from ./preprocessed \\
        --out ./cgan_sweep --grid '[{}, {"psd_weight": 4.0}]' --device cuda
"""

from __future__ import annotations

import argparse
import dataclasses
import json
import math
import tempfile
import time
from pathlib import Path

import numpy as np
import torch

from eegsynth_torch.convert import tree_to_numpy
from eegsynth_torch.data.datasets import (
    NUM_POSTURES, build_label_table, load_condition_dataset,
)
from eegsynth_torch.eval.cgan_eval import discriminative_metrics, stats_similarity
from eegsynth_torch.train import checkpoint as ckpt_io
from eegsynth_torch.train.cgan import (
    _INIT_DG, _INIT_DL, _INIT_G, _STEPS, G_WEIGHT_NAMES, CGANHParams, _device,
    _stream_seed, build_cfg, cgan_step, disc_init, draw_cgan_step, generate_batch,
    generator_init, generator_meta, load_generator, make_lr, sigma_at,
)
from eegsynth_torch.train.cgan_multi import Member
from eegsynth_torch.train.optim import Adam
from eegsynth_torch.tree import tree_map


def weight_matrix(hp: CGANHParams, grid: list[dict]) -> np.ndarray:
    """(S, len(G_WEIGHT_NAMES)) float32: the hp's weights overridden per
    point. An unknown name raises, and so does ``amp_weight`` under v1,
    whose loss has no amplitude term."""
    W = np.zeros((len(grid), len(G_WEIGHT_NAMES)), np.float32)
    for i, overrides in enumerate(grid):
        unknown = set(overrides) - set(G_WEIGHT_NAMES)
        if unknown:
            raise ValueError(f"unsweepable weights {sorted(unknown)}; "
                             f"sweepable: {G_WEIGHT_NAMES}")
        if hp.variant == "v1" and "amp_weight" in overrides:
            raise ValueError("amp_weight only affects variant='v2'; "
                             "overriding it in a v1 sweep is a silent no-op")
        for j, n in enumerate(G_WEIGHT_NAMES):
            W[i, j] = float(overrides.get(n, getattr(hp, n)))
    return W


def sweep_condition(data_dir, out_root, condition: str, grid: list[dict],
                    log=print, *, device: torch.device | str, **hparams) -> list[dict]:
    """Train ``len(grid)`` v1 models of ``condition``, one per weight
    setting, as one stack; write each point's directory; return per point
    ``{"dir", "weights", "best_g", "last_g"}``."""
    device = torch.device(device)
    hp = CGANHParams(**{"variant": "v1", **hparams})
    np.random.seed(hp.seed)
    X_np, y_np, _ = load_condition_dataset(data_dir, condition)
    cfg = build_cfg(hp, NUM_POSTURES)
    W = weight_matrix(hp, grid)
    S = len(grid)
    out_root = Path(out_root)

    def gen(stream):
        return torch.Generator().manual_seed(_stream_seed(hp.seed, stream))

    G, bn = generator_init(cfg, gen(_INIT_G), device=device)
    D = {"dg": disc_init(cfg, gen(_INIT_DG), device=device),
         "dl": disc_init(cfg, gen(_INIT_DL), device=device)}
    steps = max(1, X_np.shape[0] // hp.batch_size)
    optG = Adam(make_lr(hp, steps, hp.lr_g), hp.beta1, hp.beta2)
    optD = Adam(make_lr(hp, steps * max(1, hp.d_steps), hp.lr_d,
                        epoch_offset=hp.prewarm), hp.beta1, hp.beta2)
    points = [Member(*(tree_map(torch.clone, t) for t in (G, bn, D, G)),
                     optG.init(G), optD.init(D)) for _ in range(S)]
    weights = torch.from_numpy(W).to(device)
    best_g = [float("inf")] * S
    best = [{"G": m.ema if hp.ema else m.G, "bn": m.bn} for m in points]

    table_np, counts_np = build_label_table(y_np, cfg.num_classes, 1)
    X = torch.from_numpy(np.ascontiguousarray(X_np)).to(device)
    table = torch.from_numpy(table_np.astype(np.int64)).to(device)
    counts = torch.from_numpy(counts_np.astype(np.float32)).to(device)
    draw_gen = torch.Generator(device=device).manual_seed(_stream_seed(hp.seed, _STEPS))

    total_epochs = hp.prewarm + hp.epochs
    log(f"[sweep:{condition}] {S} weight settings × {total_epochs} epochs, "
        f"steps/epoch {steps} | {device}")
    dirs = []
    for i, overrides in enumerate(grid):
        d = out_root / f"sweep{i}"
        d.mkdir(parents=True, exist_ok=True)
        with open(d / "hparams.json", "w") as f:
            json.dump({**dataclasses.asdict(hp),
                       **dict(zip(G_WEIGHT_NAMES, W[i].tolist())),
                       "tag": f"sweep{i}", "sweep_overrides": overrides}, f, indent=2)
        dirs.append(d)

    t0 = time.perf_counter()
    last_g = np.full((S,), np.nan)
    for ep in range(total_epochs):
        prewarm = ep < hp.prewarm
        sigma = sigma_at(hp, total_epochs, ep)
        for step_idx in range(steps):
            draws = draw_cgan_step(draw_gen, hp, cfg, table, counts, prewarm=prewarm,
                                   device=device)
            logs = []
            for i, m in enumerate(points):
                (m.G, m.bn, m.D, m.ema, m.g_state, m.d_state, lg) = cgan_step(
                    m.G, m.bn, m.D, m.ema, m.g_state, m.d_state, X, draws, step_idx,
                    sigma, cfg=cfg, hp=hp, optG=optG, optD=optD, prewarm=prewarm,
                    weights=weights[i])
                logs.append(lg)
        last_g = torch.stack(logs)[:, 8].cpu().numpy()
        if not prewarm:
            for i, m in enumerate(points):
                if math.isfinite(last_g[i]) and last_g[i] < best_g[i]:
                    best_g[i] = float(last_g[i])
                    best[i] = {"G": m.ema if hp.ema else m.G, "bn": m.bn}
        if (ep + 1) % max(1, hp.print_every) == 0 or ep + 1 == total_epochs:
            log(f"[sweep:{condition}] Ep {ep + 1}/{total_epochs} | G per point "
                + " ".join(f"{v:.2f}" for v in last_g))

    results = []
    for i, (m, d) in enumerate(zip(points, dirs)):
        tag = f"sweep{i}"
        meta = generator_meta(hp, cfg.num_classes, tag)
        if math.isfinite(best_g[i]):
            ckpt_io.save_checkpoint(d / f"CGAN_generator_{tag}_best.npz",
                                    {"model": tree_to_numpy(best[i]["G"]),
                                     "bn": tree_to_numpy(best[i]["bn"])}, meta)
        ckpt_io.save_checkpoint(d / f"CGAN_generator_{tag}_last.npz",
                                {"model": tree_to_numpy(m.ema if hp.ema else m.G),
                                 "bn": tree_to_numpy(m.bn)}, meta)
        results.append({"dir": str(d), "weights": dict(zip(G_WEIGHT_NAMES,
                                                           W[i].tolist())),
                        "best_g": best_g[i], "last_g": float(last_g[i])})
    dt = time.perf_counter() - t0
    log(f"[sweep:{condition}] Done in {dt:.1f}s "
        f"({total_epochs * steps * S / max(dt, 1e-9):.1f} aggregate steps/s)")
    return results


def build_smoke_set(src_dir, condition: str, out_dir: Path) -> Path:
    """The condition's real buckets relabelled as postures 1..9 (cycling)."""
    srcs = sorted(Path(src_dir).glob(f"posture*_{condition}.npz"))
    if not srcs:
        raise SystemExit(f"no posture*_{condition}.npz in {src_dir}")
    out_dir.mkdir(parents=True, exist_ok=True)
    for p in range(1, NUM_POSTURES + 1):
        with np.load(srcs[(p - 1) % len(srcs)], allow_pickle=True) as f:
            z = dict(f)
        z["posture"] = np.int32(p)
        np.savez_compressed(out_dir / f"posture{p}_{condition}.npz", **z)
    return out_dir


def eval_sweep_points(results, Xr, yr, samples_per_posture=400, seed=123, log=print,
                      *, device: torch.device | str) -> list[dict]:
    """Score each point's best (else last) generator: ``samples_per_posture``
    windows a posture against the real (Xr, yr); adds the global rows of the
    statistics (``stats``) and of the discriminative metrics (``disc``) to
    each result and writes their CSVs beside the checkpoints."""
    for res in results:
        d = Path(res["dir"])
        tag = d.name
        gpath = d / f"CGAN_generator_{tag}_best.npz"
        if not gpath.exists():
            gpath = d / f"CGAN_generator_{tag}_last.npz"
        G, bn, cfg, _ = load_generator(gpath, num_classes=NUM_POSTURES, device=device)
        gen = torch.Generator(device=device).manual_seed(seed)
        Xg = np.concatenate([generate_batch(G, bn, cfg, gen, samples_per_posture,
                                            p - 1).cpu().numpy()
                             for p in range(1, NUM_POSTURES + 1)])
        yg = np.repeat(np.arange(1, NUM_POSTURES + 1), samples_per_posture)
        rows = stats_similarity(Xr, Xg, yr, yg, d / "stats_similarity.csv",
                                device=device)
        res["stats"] = rows[0]
        drows = discriminative_metrics(Xr, Xg, yr, yg, d / "metrics_discriminative.csv",
                                       seed=seed, device=device)
        res["disc"] = drows[0]
        log(f"[sweep] {tag} {res['weights']} → psd_l1={rows[0]['psd_l1']:.1f} "
            f"acf_l1={rows[0]['acf_l1']:.2e} coh_l1={rows[0]['coh_l1']:.3f} "
            f"logreg_acc={drows[0]['acc']:.3f} best_g={res['best_g']:.2f}")
    return results


def main(argv: list[str] | None = None) -> list[dict]:
    """The CLI of ``scripts/sweep_cgan.py``; returns the results it writes."""
    ap = argparse.ArgumentParser(
        formatter_class=argparse.ArgumentDefaultsHelpFormatter,
        description="CGAN G-loss weight sweep, one stacked job, then each point "
                    "scored (the port of scripts/sweep_cgan.py)")
    ap.add_argument("--data-dir", type=str, default="./preprocessed")
    ap.add_argument("--smoke-from", type=str, default="",
                    help="relabel this directory's buckets of the condition as "
                         "9 postures (cycling) instead of using --data-dir")
    ap.add_argument("--out", type=str, required=True)
    ap.add_argument("--condition", type=str, default="no_exo")
    ap.add_argument("--grid", type=str, required=True,
                    help='JSON list of weight-override dicts, e.g. '
                         '\'[{}, {"psd_weight": 4.0}]\' ({} = current defaults)')
    ap.add_argument("--epochs", type=int, default=600)
    ap.add_argument("--arch", choices=["conv", "transformer"], default="transformer")
    ap.add_argument("--no-tf-remat", action="store_true",
                    help="keep the transformer D blocks' activations instead of "
                         "recomputing them in the backward pass")
    ap.add_argument("--samples-per-posture", type=int, default=400)
    ap.add_argument("--seed", type=int, default=42)
    ap.add_argument("--device", type=str, default="cuda",
                    help="cuda (the kernels) or cpu (their plain versions)")
    args = ap.parse_args(argv)

    device = _device(args.device)
    data_dir = args.data_dir
    with tempfile.TemporaryDirectory(prefix="eegsynth_smoke_") as tmp:
        if args.smoke_from:
            data_dir = str(build_smoke_set(args.smoke_from, args.condition,
                                           Path(tmp) / "prep"))
            print(f"[sweep] smoke set → {data_dir}", flush=True)
        results = sweep_condition(
            data_dir, args.out, args.condition, json.loads(args.grid), device=device,
            epochs=args.epochs, seed=args.seed, arch=args.arch,
            tf_remat=args.arch == "transformer" and not args.no_tf_remat)
        np.random.seed(123)
        Xr, yr, _ = load_condition_dataset(data_dir, args.condition)
    eval_sweep_points(results, Xr, yr, samples_per_posture=args.samples_per_posture,
                      device=device)
    out = Path(args.out) / "sweep_results.json"
    with open(out, "w") as f:
        json.dump(results, f, indent=2)
    print(f"[sweep] wrote {out}", flush=True)
    return results


if __name__ == "__main__":
    main()
