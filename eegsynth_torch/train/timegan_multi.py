"""Train every (posture, condition) TimeGAN at once, all buckets stacked.

Counterpart of ``train_all_buckets`` in ``eegsynth/train/timegan_multi.py``.
The buckets become a leading axis of every parameter, optimizer moment and
batch (the counterpart of ``jax.vmap``), so each recurrence of a step is one
kernel launch for all buckets, not a loop over them. Per-bucket semantics stay
per bucket: the gradient-norm clip, the Adam moments, the power-iteration
vector ``u`` and best-by-G-total tracking.

As in the JAX trainer:

- batches are drawn uniformly with replacement from each bucket's valid
  prefix (``floor(U · n_valid)``);
- the AE and SUP phases run ``epochs × ceil(n_max / B)`` steps per bucket;
- per-bucket artifacts: ``train_log.csv`` (same columns), ``ckpt_latest.npz``
  and ``ckpt_best.npz`` (``model``, ``optG``, ``optD``, meta) and
  ``synthetic.npz`` of ``n_valid`` windows.

Randomness: bucket b's weights come from a CPU ``torch.Generator`` seeded
from (seed, b), and its batches and noise from a generator on the device
seeded from (seed, b, phase); they do not reproduce JAX's threefry streams.

Not ported (ROADMAP "Do not port"): ``mesh``, ``max_stack``,
``dispatch_budget``; and, for a later slice, ``bucket_weights``,
``ckpt_every`` / ``resume``, ``profile_dir``, multi-layer stacks.

    python -m eegsynth_torch.train.timegan_multi --config configs/timegan_config.json \\
        --data_dir ./preprocessed --out_dir ./timegan_runs --device cuda
"""

from __future__ import annotations

import argparse
import json
import time
from pathlib import Path

import numpy as np
import torch

from eegsynth_torch.convert import from_jax_params, unstack_params
from eegsynth_torch.data.io import bucket_paths, load_bucket
from eegsynth_torch.models.timegan import (
    TimeGANConfig, adaptive_dims, timegan_init_stacked,
)
from eegsynth_torch.train import checkpoint as ckpt_io
from eegsynth_torch.train.optim import Optimizer, make_gan_opts
from eegsynth_torch.train.timegan import (
    GEN_NETS, LOG_COLUMNS, TimeGANHParams, draw_batch_idx, draw_gan, gan_step,
    gather_batch,
    pre_phase_step, synthesize,
)
from eegsynth_torch.tree import take, tree_map

_INIT, _AE, _SUP, _GAN, _SYNTH = range(5)   # seed streams per bucket


def bucket_seed(seed: int, b: int, stream: int) -> int:
    """A 63-bit seed for bucket ``b``'s ``stream`` (init, phases, synthesis)."""
    state = np.random.SeedSequence([seed, b, stream]).generate_state(2, np.uint32)
    return int(state[0]) << 31 | int(state[1]) >> 1


def stack_buckets(files: list[Path]):
    """Bucket NPZs → (X (nb, n_max, T, C) zero-padded, n_valid (nb,), names,
    fs list)."""
    buckets = [load_bucket(fp) for fp in files]
    Xs, fss = [b.X for b in buckets], [b.fs for b in buckets]
    names = [Path(fp).stem for fp in files]
    T, C = Xs[0].shape[1:]
    if not all(x.shape[1:] == (T, C) for x in Xs):
        raise ValueError("buckets must share (T, C)")
    n_valid = np.array([len(x) for x in Xs], dtype=np.int64)
    X = np.zeros((len(Xs), int(n_valid.max()), T, C), dtype=np.float32)
    for i, x in enumerate(Xs):
        X[i, :len(x)] = x
    return X, n_valid, names, fss


def _generators(seed: int, nb: int, stream: int, device) -> list[torch.Generator]:
    return [torch.Generator(device=device).manual_seed(bucket_seed(seed, b, stream))
            for b in range(nb)]


def train_all_buckets(data_dir, out_root, *, device: torch.device | str,
                      log_every: int = 100, **hparams) -> dict:
    """Stacked multi-bucket training; writes the per-bucket artifact set.
    Returns aggregate throughput stats, each GAN step's wall time (host clock,
    synchronised) and the pre-phase step counts."""
    device = torch.device(device)
    out_root = Path(out_root)
    hp = TimeGANHParams(**hparams)
    if hp.layers != 1:
        raise NotImplementedError("the stacked trainer takes single-layer "
                                  "GRU stacks (the reference's layers=1)")
    if hp.epoch_cycle:
        raise ValueError("epoch_cycle is a sequential-trainer A/B instrument; "
                         "unsupported with stacked buckets")
    files = bucket_paths(data_dir)
    if not files:
        raise SystemExit(f"No NPZs found in {data_dir}")
    X_host, n_valid_host, names, fss = stack_buckets(files)
    nb, n_max, T, C = X_host.shape
    z_dim, h_dim = adaptive_dims(C, T)
    cfg = TimeGANConfig(x_dim=C, z_dim=z_dim, h_dim=h_dim, num_layers=hp.layers,
                        dropout=hp.dropout)
    print(f"==> {nb} buckets | T={T} C={C} z={z_dim} h={h_dim} "
          f"N∈[{int(n_valid_host.min())},{n_max}] | {device}", flush=True)

    t_all = time.perf_counter()
    X = torch.from_numpy(X_host).to(device)
    n_valid = torch.from_numpy(n_valid_host).to(device=device, dtype=torch.float32)
    params = timegan_init_stacked(cfg, _generators(hp.seed, nb, _INIT, "cpu"),
                                  device=device)
    B = min(hp.batch_size, n_max)
    steps_per_epoch = -(-n_max // B)

    # Phases 1 + 2: autoencoder, then supervisor
    for tag, stream, which, epochs, nets in (
            ("AE", _AE, "ae", hp.ae_epochs, ("embedder", "recovery")),
            ("SUP", _SUP, "sup", hp.sup_epochs, None)):
        opt = Optimizer(hp.lr_g, hp.grad_clip, hp.beta1, hp.beta2)
        sub = ({k: params[k] for k in nets} if nets else params["supervisor"])
        state = opt.init(sub)
        gens = _generators(hp.seed, nb, stream, device)
        n_steps = epochs * steps_per_epoch
        loss = torch.full((nb,), float("nan"), device=device)
        for _ in range(n_steps):
            x = gather_batch(X, draw_batch_idx(gens, n_valid, B, device=device))
            params, state, loss = pre_phase_step(params, opt, state, x, which)
        print(f"[{tag}] {n_steps} steps × {nb} buckets  final "
              f"{'recon' if which == 'ae' else 'sup'}≈{loss.mean().item():.5f}",
              flush=True)

    # Phase 3: joint GAN steps
    optD, optG = make_gan_opts(hp)
    d_state = optD.init(params["discriminator"])
    g_state = optG.init({k: params[k] for k in GEN_NETS})
    gens = _generators(hp.seed, nb, _GAN, device)
    best_params = params
    best_loss = torch.full((nb,), float("inf"), device=device)
    best_step = torch.zeros((nb,), dtype=torch.long, device=device)
    logs, step_seconds = [], []
    t0 = time.perf_counter()
    for step in range(1, hp.gan_steps + 1):
        t_step = time.perf_counter()
        draws = draw_gan(gens, n_valid, B, T, z_dim, device=device)
        x = gather_batch(X, draws.idx)
        params, d_state, g_state, lg = gan_step(params, optD, d_state, optG,
                                                g_state, x, draws, step, hp)
        logs.append(lg)
        # best-by-G-total, per bucket, on the post-update parameters
        is_best = lg[:, 2] < best_loss
        best_params = tree_map(
            lambda new, old: torch.where(
                is_best.view((nb,) + (1,) * (new.dim() - 1)), new, old),
            params, best_params)
        best_loss = torch.where(is_best, lg[:, 2], best_loss)
        best_step = torch.where(is_best, torch.full_like(best_step, step), best_step)
        if device.type == "cuda":
            torch.cuda.synchronize(device)   # a step takes seconds: cheap
        step_seconds.append(time.perf_counter() - t_step)
        if step % log_every == 0 or step == hp.gan_steps:
            row = lg.mean(dim=0).tolist()
            print(f"[GAN] step {step}/{hp.gan_steps}  mean over {nb} buckets: "
                  f"D={row[0]:.4f} acc≈{row[1]:.2f} G={row[2]:.4f} "
                  f"({step_seconds[-1]:.3f} s)", flush=True)
    gan_seconds = time.perf_counter() - t0
    agg = nb * hp.gan_steps / max(gan_seconds, 1e-9)
    print(f"[GAN] {nb}×{hp.gan_steps} steps in {gan_seconds:.1f}s → "
          f"{agg:.1f} aggregate steps/s", flush=True)

    # Per-bucket artifacts
    logs_host = (torch.stack(logs, dim=1).cpu().numpy() if logs
                 else np.zeros((nb, 0, len(LOG_COLUMNS)), np.float32))
    to_np = lambda tree: tree_map(lambda t: t.detach().cpu().numpy(), tree)  # noqa: E731
    opt_trees = {"optG": to_np(optG.state_tree(g_state)),
                 "optD": to_np(optD.state_tree(d_state))}
    best_step_host, best_loss_host = best_step.cpu().numpy(), best_loss.cpu().numpy()
    meta_base = {"z_dim": z_dim, "h_dim": h_dim, "x_dim": C, "layers": hp.layers}
    for b, name in enumerate(names):
        out_dir = out_root / name
        out_dir.mkdir(parents=True, exist_ok=True)
        with open(out_dir / "train_log.csv", "w") as f:
            f.write("step,phase," + ",".join(LOG_COLUMNS) + "\n")
            for s in range(hp.gan_steps):
                f.write(f"{s + 1},GAN," + ",".join(repr(float(v))
                        for v in logs_host[b, s]) + "\n")
        opt_b = {k: take(v, b) for k, v in opt_trees.items()}
        model_b = unstack_params(params, b)
        ckpt_io.save_checkpoint(out_dir / "ckpt_latest.npz",
                                {"model": model_b, **opt_b},
                                {**meta_base, "npz": f"{name}.npz", "fs": fss[b],
                                 "step": hp.gan_steps})
        ckpt_io.save_checkpoint(out_dir / "ckpt_best.npz",
                                {"model": unstack_params(best_params, b), **opt_b},
                                {**meta_base, "npz": f"{name}.npz", "best": True,
                                 "fs": fss[b], "step": int(best_step_host[b]),
                                 "best_loss": float(best_loss_host[b])})
        gen = torch.Generator(device=device).manual_seed(
            bucket_seed(hp.seed, b, _SYNTH))
        X_hat = synthesize(from_jax_params(model_b, device=device).eval(),
                           int(n_valid_host[b]), T, generator=gen)
        np.savez_compressed(out_dir / "synthetic.npz", X=X_hat.astype(np.float32))
        print(f"[{name}] artifacts written (best@{int(best_step_host[b])})",
              flush=True)

    return {"aggregate_steps_per_sec": agg, "gan_seconds": gan_seconds,
            "total_seconds": time.perf_counter() - t_all, "n_buckets": nb,
            "gan_step_seconds": step_seconds,
            "ae_steps": hp.ae_epochs * steps_per_epoch,
            "sup_steps": hp.sup_epochs * steps_per_epoch}


CONFIG_KEYS = {
    "batch_size": int, "ae_epochs": int, "sup_epochs": int, "gan_steps": int,
    "lr_g": float, "lr_d": float, "beta1": float, "beta2": float,
    "alpha_sup": float, "beta_rec": float, "label_smooth": float,
    "inst_noise_start": float, "inst_noise_end": float, "grad_clip": float,
    "layers": int, "dropout": float, "seed": int, "r1_gamma": float,
    "d_min_acc": float, "d_max_acc": float, "gamma_cov": float,
    "gamma_acf": float, "acf_max_lag": int, "chunk": int,
}
"""The config keys of ``scripts/train_timegan.py``, with their types."""


def main(argv: list[str] | None = None) -> dict:
    ap = argparse.ArgumentParser(
        description="Stacked multi-bucket TimeGAN training (the port of "
                    "scripts/train_timegan.py --parallel_buckets)")
    ap.add_argument("--config", type=str, default=None,
                    help="JSON config, the schema of configs/timegan_config.json")
    ap.add_argument("--data_dir", type=str, default=None)
    ap.add_argument("--out_dir", type=str, default=None)
    ap.add_argument("--device", type=str, default="cuda",
                    help="cuda (the kernels) or cpu (their plain versions)")
    ap.add_argument("--log_every", type=int, default=100)
    for k, typ in CONFIG_KEYS.items():
        ap.add_argument(f"--{k}", type=typ, default=None)
    args = ap.parse_args(argv)

    cfg = {}
    if args.config:
        with open(args.config, encoding="utf-8") as f:
            cfg = json.load(f)
    data_dir = Path(args.data_dir or cfg.get("data_dir", "./preprocessed"))
    out_root = Path(args.out_dir or cfg.get("out_dir", "./timegan_runs"))
    hp = {k: typ(getattr(args, k) if getattr(args, k) is not None else cfg[k])
          for k, typ in CONFIG_KEYS.items()
          if getattr(args, k) is not None or k in cfg}
    device = torch.device(args.device)
    if device.type == "cuda" and not torch.cuda.is_available():
        raise SystemExit("--device cuda: no CUDA device is available")
    res = train_all_buckets(data_dir, out_root, device=device,
                            log_every=args.log_every, **hp)
    print(f"\nAggregate: {res['aggregate_steps_per_sec']:.1f} GAN steps/s "
          f"across {res['n_buckets']} buckets ({res['total_seconds']:.1f}s total)")
    return res


if __name__ == "__main__":
    main()
