"""TimeGAN G-loss weight sweep: S weight settings of one bucket, one stack.

Counterpart of ``eegsynth/train/timegan_sweep.py`` and the CLI of
``scripts/sweep_timegan.py``. The sweep points are the members of one
stacked run (``timegan_multi.run_stack``): each step is one kernel launch
per recurrence for every point. Every point sees the same windows, the same
initial weights, the same batches and the same noise, as JAX broadcasts one
key over the sweep axis: each member's generator is seeded from
(seed, 0, stream), where the multi-bucket trainer seeds member b from
(seed, b, stream). Only the (S, 4) G-loss weight matrix differs, so two
points with equal weights train bit for bit alike, and a difference between
points is the weights' effect, not GAN run-to-run variance.

``fused_step`` is on, as JAX forces it: the D-step inputs run kernel K2 at
every width ``models/timegan.py``'s ``_takes_k2`` accepts (on the card).

Each point's directory ``sweep{i}/`` holds ``hparams.json`` (the resolved
weights, ``sweep_overrides``, ``gan_steps``, ``seed``), ``ckpt_latest.npz``
and ``ckpt_best.npz`` (``{"model"}`` and JAX's meta keys) and
``synthetic.npz`` of N windows, drawn from the same noise for every point
(seed ``seed ^ 0x5eed``).

    python -m eegsynth_torch.train.timegan_sweep --npz posture2_with_exo.npz \\
        --out ./tg_sweep --gan_steps 8000 \\
        --grid '[{}, {"gamma_acf": 0.08}, {"gamma_acf": 0.2}]' --device cuda
"""

from __future__ import annotations

import argparse
import dataclasses
import json
import time
from pathlib import Path

import numpy as np
import torch

from eegsynth_torch.convert import from_jax_params, unstack_params
from eegsynth_torch.eval.stats import statistical_similarity
from eegsynth_torch.models.timegan import TimeGANConfig, adaptive_dims
from eegsynth_torch.train import checkpoint as ckpt_io
from eegsynth_torch.train.timegan import (
    _INIT, TIMEGAN_G_WEIGHT_NAMES, TimeGANHParams, bucket_seed, synthesize,
)
from eegsynth_torch.train.timegan_multi import run_stack

SYNTH_TAG = 0x5EED
"""Every point's synthesis noise comes from seed ``seed ^ SYNTH_TAG``."""


def timegan_weight_matrix(hp: TimeGANHParams, grid: list[dict]) -> np.ndarray:
    """(S, 4) float32 in ``TIMEGAN_G_WEIGHT_NAMES`` order: the hp's weights,
    overridden per sweep point; an unknown name raises ``ValueError``."""
    W = np.zeros((len(grid), len(TIMEGAN_G_WEIGHT_NAMES)), np.float32)
    for i, overrides in enumerate(grid):
        unknown = set(overrides) - set(TIMEGAN_G_WEIGHT_NAMES)
        if unknown:
            raise ValueError(f"unsweepable weights {sorted(unknown)}; "
                             f"sweepable: {TIMEGAN_G_WEIGHT_NAMES}")
        for j, n in enumerate(TIMEGAN_G_WEIGHT_NAMES):
            W[i, j] = float(overrides.get(n, getattr(hp, n)))
    return W


def shared_generators(seed: int, S: int, stream: int, device) -> list[torch.Generator]:
    """S generators on ``device`` in the same state: member 0's ``stream``
    of the stacked trainer, once per sweep point."""
    return [torch.Generator(device=device).manual_seed(bucket_seed(seed, 0, stream))
            for _ in range(S)]


def sweep_bucket(npz_path, out_root, grid: list[dict], *,
                 device: torch.device | str, log=print, **hparams) -> list[dict]:
    """Train ``len(grid)`` weight settings of one bucket as one stack; write
    each point's run directory; return per point ``{"dir", "weights",
    "final_g", "best_step"}`` (JAX's result dicts)."""
    device = torch.device(device)
    hp = TimeGANHParams(**{"fused_step": True, **hparams})
    with np.load(npz_path) as data:
        Xb = data["X"].astype(np.float32)
        fs = float(data["fs"]) if "fs" in data.files else 128.0
    N, T, C = Xb.shape
    S = len(grid)
    W = timegan_weight_matrix(hp, grid)
    out_root = Path(out_root)
    z_dim, h_dim = adaptive_dims(C, T)
    cfg = TimeGANConfig(x_dim=C, z_dim=z_dim, h_dim=h_dim, num_layers=hp.layers,
                        dropout=hp.dropout)
    log(f"[tsweep] {Path(npz_path).stem}: {S} weight settings | N={N} T={T} "
        f"C={C} z={z_dim} h={h_dim} | {device}")

    t0 = time.perf_counter()
    run = run_stack(
        torch.from_numpy(Xb).to(device)[None].expand(S, N, T, C),
        torch.full((S,), float(N), device=device), hp, cfg,
        init_gens=shared_generators(hp.seed, S, _INIT, "cpu"),
        streams=lambda stream: shared_generators(hp.seed, S, stream, device),
        device=device, weights=torch.from_numpy(W).to(device),
        log_every=max(1, hp.gan_steps), log=log)
    g_last = (run["logs"][-1][:, 2].cpu().numpy() if run["logs"]
              else np.full((S,), np.nan, np.float32))
    dt = time.perf_counter() - t0
    log(f"[tsweep] {S}×{hp.gan_steps} GAN steps in {dt:.1f}s "
        f"({S * hp.gan_steps / max(dt, 1e-9):.1f} aggregate steps/s) | final G "
        + " ".join(f"{v:.3f}" for v in g_last))

    best = run["best"]
    best_step, best_loss = best.step.cpu().numpy(), best.loss.cpu().numpy()
    meta_base = {"z_dim": z_dim, "h_dim": h_dim, "x_dim": C, "layers": hp.layers,
                 "fs": fs, "npz": Path(npz_path).name}
    results = []
    for i, overrides in enumerate(grid):
        d = out_root / f"sweep{i}"
        d.mkdir(parents=True, exist_ok=True)
        resolved = dict(zip(TIMEGAN_G_WEIGHT_NAMES, W[i].tolist()))
        with open(d / "hparams.json", "w") as f:
            json.dump({**resolved, "sweep_overrides": overrides,
                       "gan_steps": hp.gan_steps, "seed": hp.seed}, f, indent=2)
        model = unstack_params(run["params"], i)
        ckpt_io.save_checkpoint(d / "ckpt_latest.npz", {"model": model},
                                {**meta_base, "step": hp.gan_steps})
        ckpt_io.save_checkpoint(d / "ckpt_best.npz",
                                {"model": unstack_params(best.params, i)},
                                {**meta_base, "best": True,
                                 "step": int(best_step[i]),
                                 "best_loss": float(best_loss[i])})
        # the same synthesis noise for every point: the eval's differences
        # are the weights' effect, not the generation noise's
        gen = torch.Generator(device=device).manual_seed(hp.seed ^ SYNTH_TAG)
        X_hat = synthesize(from_jax_params(model, device=device).eval(), N, T,
                           generator=gen)
        np.savez_compressed(d / "synthetic.npz", X=X_hat.astype(np.float32))
        results.append({"dir": str(d), "weights": resolved,
                        "final_g": float(g_last[i]), "best_step": int(best_step[i])})
    return results


def _hparams_from_config(path, log=print) -> dict:
    """The ``TimeGANHParams`` fields of a trainer config; the other keys
    (``data_dir``, ``parallel_buckets``, ``bucket_weights``, ...) are named
    and dropped."""
    fields = {f.name for f in dataclasses.fields(TimeGANHParams)}
    with open(path, encoding="utf-8") as f:
        cfg = json.load(f)
    unknown = sorted(set(cfg) - fields)
    if unknown:
        log(f"[tsweep] ignoring non-hparam config keys: {unknown}")
    return {k: v for k, v in cfg.items() if k in fields}


def main(argv: list[str] | None = None) -> list[dict]:
    """The CLI of ``scripts/sweep_timegan.py``: the sweep, then each point's
    synthetic.npz scored against the real bucket (PSD, ACF, correlation
    differences); writes ``<out>/sweep_results.json`` and returns it."""
    ap = argparse.ArgumentParser(
        formatter_class=argparse.ArgumentDefaultsHelpFormatter,
        description="TimeGAN G-loss weight sweep on one bucket, one stacked job "
                    "(the port of scripts/sweep_timegan.py)")
    ap.add_argument("--npz", type=str, required=True, help="the real bucket to sweep on")
    ap.add_argument("--out", type=str, required=True)
    ap.add_argument("--grid", type=str, required=True,
                    help="JSON list of weight-override dicts over "
                         "alpha_sup/beta_rec/gamma_cov/gamma_acf ({} = defaults)")
    ap.add_argument("--config", type=str, default="",
                    help="optional trainer config JSON (train_timegan's schema)")
    for k in ("ae_epochs", "sup_epochs", "gan_steps", "batch_size", "seed"):
        ap.add_argument(f"--{k}", type=int, default=None)
    ap.add_argument("--device", type=str, default="cuda",
                    help="cuda (the kernels) or cpu (their plain versions)")
    args = ap.parse_args(argv)

    device = torch.device(args.device)
    if device.type == "cuda" and not torch.cuda.is_available():
        raise SystemExit("--device cuda: no CUDA device is available")
    hp = _hparams_from_config(args.config) if args.config else {}
    for k in ("ae_epochs", "sup_epochs", "gan_steps", "batch_size", "seed"):
        if getattr(args, k) is not None:
            hp[k] = getattr(args, k)
    results = sweep_bucket(args.npz, args.out, json.loads(args.grid), device=device,
                           **hp)

    with np.load(args.npz) as real:
        Xr = real["X"].astype(np.float32)
        fs = float(real["fs"]) if "fs" in real.files else 128.0
    for res in results:
        with np.load(Path(res["dir"]) / "synthetic.npz") as z:
            Xf = z["X"]
        psd, acf, coh = statistical_similarity(Xr, Xf, fs, device=device)
        res["stats"] = {"psd_diff": psd, "acf_diff": acf, "coh_diff": coh}
        print(f"[tsweep] {Path(res['dir']).name} {res['weights']} → "
              f"psd={psd:.3e} acf={acf:.4f} coh={coh:.3f}", flush=True)
    out = Path(args.out) / "sweep_results.json"
    with open(out, "w") as f:
        json.dump(results, f, indent=2)
    print(f"[tsweep] wrote {out}", flush=True)
    return results


if __name__ == "__main__":
    main()
