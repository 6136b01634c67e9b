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
from (seed, b), and its batches, noise and dropout masks from a generator on
the device seeded from (seed, b, phase); they do not reproduce JAX's
threefry streams.

Options, as in JAX: multi-layer stacks with inter-layer dropout (masks per
bucket from its own generator, in the GAN phase only, as JAX's pre-phases
run without dropout); ``bucket_weights``, per-bucket G-loss weights;
``ckpt_every`` / ``resume`` through ``out_root/_multi_state.npz``, which also
holds each bucket's GAN generator, so a resumed run's log equals an
uninterrupted run's bit for bit on the same device.

``profile_dir`` writes a ``torch.profiler`` Chrome trace of the GAN phase.
The phases themselves are :func:`run_stack`, which the TimeGAN weight
sweep (``timegan_sweep.py``) drives with its own members.

Not ported (ROADMAP "Do not port"): ``mesh``, ``max_stack``,
``dispatch_budget``.

    python -m eegsynth_torch.train.timegan --parallel_buckets \\
        --config configs/timegan_config.json --data_dir ./preprocessed \\
        --out_dir ./timegan_runs --device cuda
"""

from __future__ import annotations

import sys
import time
from pathlib import Path

import numpy as np
import torch

from eegsynth_torch.convert import from_jax_params, restore_like, unstack_params
from eegsynth_torch.data.io import bucket_paths, load_bucket
from eegsynth_torch.models.timegan import (
    TimeGANConfig, adaptive_dims, timegan_init_stacked,
)
from eegsynth_torch.train import checkpoint as ckpt_io
from eegsynth_torch.train.optim import Optimizer, make_gan_opts
from eegsynth_torch.train.timegan import (
    _AE, _GAN, _INIT, _SUP, _SYNTH, GEN_NETS, LOG_COLUMNS, LOG_HEADER,
    TIMEGAN_G_WEIGHT_NAMES, BestTracker, TimeGANHParams, bucket_generators,
    bucket_seed, draw_batch_idx, draw_gan, draw_gan_masks, dropout_rate, gan_profile,
    gan_step, gather_batch, pre_phase_step, synthesize,
)
from eegsynth_torch.tree import take


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


def bucket_weight_matrix(bucket_weights: dict, names: list[str],
                         hp: TimeGANHParams) -> np.ndarray:
    """(nb, 4) G-loss weights in ``TIMEGAN_G_WEIGHT_NAMES`` order: the hp's,
    overridden per named bucket (JAX ``train_all_buckets``'s validation)."""
    unknown = set(bucket_weights) - set(names)
    if unknown:
        raise ValueError(f"bucket_weights for unknown buckets "
                         f"{sorted(unknown)}; have {names}")
    W = np.tile(np.asarray([getattr(hp, n) for n in TIMEGAN_G_WEIGHT_NAMES],
                           np.float32), (len(names), 1))
    for bname, overrides in bucket_weights.items():
        bad = set(overrides) - set(TIMEGAN_G_WEIGHT_NAMES)
        if bad:
            raise ValueError(f"unsweepable weights {sorted(bad)}; "
                             f"sweepable: {TIMEGAN_G_WEIGHT_NAMES}")
        b = names.index(bname)
        for j, n in enumerate(TIMEGAN_G_WEIGHT_NAMES):
            W[b, j] = float(overrides.get(n, W[b, j]))
    return W


def _log(msg: str) -> None:
    print(msg, flush=True)


def run_stack(X: torch.Tensor, n_valid: torch.Tensor, hp: TimeGANHParams,
              cfg: TimeGANConfig, *, init_gens: list, streams, device: torch.device,
              weights: torch.Tensor | None = None, log_every: int = 100,
              resume: tuple | None = None, ckpt_every: int | None = None,
              save_state=None, profile_dir=None, profile_name: str = "stack",
              log=_log) -> dict:
    """The three phases of a stacked run: AE, SUP (no dropout, as in JAX),
    then ``hp.gan_steps`` joint GAN steps, every member at once.

    ``X`` (nb, n_max, T, C) holds each member's windows, of which the first
    ``n_valid[b]`` are drawn (with replacement). Member b's weights come
    from ``init_gens[b]`` (CPU generators); ``streams(stream)`` returns the
    members' generators on the device for ``stream`` (``_AE``, ``_SUP``,
    ``_GAN``). ``weights`` (nb, 4) are per-member G-loss weights
    (:func:`gan_step`). ``resume`` = (trees, done) of a saved state skips
    phases 1-2 and continues the GAN phase from it; every ``ckpt_every``
    GAN steps (before the last) ``save_state(trees, done)`` receives the
    state. ``profile_dir`` wraps the GAN phase in a ``torch.profiler``
    trace (:func:`gan_profile`).

    Returns the final state: ``params``, ``best`` (:class:`BestTracker`),
    ``logs`` (one (nb, 8) tensor a step), the optimizers and their states,
    each GAN step's wall time (host clock, synchronised), the GAN phase's
    seconds, the first step run and the pre-phase step counts."""
    nb, n_max, T, _ = X.shape
    params = timegan_init_stacked(cfg, init_gens, device=device)
    B = min(hp.batch_size, n_max)
    steps_per_epoch = -(-n_max // B)
    rate = dropout_rate(hp)

    # Phases 1 + 2: autoencoder, then supervisor; a resumed run restores
    # their outcome instead
    phases = (("AE", _AE, "ae", hp.ae_epochs, ("embedder", "recovery")),
              ("SUP", _SUP, "sup", hp.sup_epochs, None))
    for tag, stream, which, epochs, nets in phases if resume is None else ():
        opt = Optimizer(hp.lr_g, hp.grad_clip, hp.beta1, hp.beta2)
        sub = ({k: params[k] for k in nets} if nets else params["supervisor"])
        state = opt.init(sub)
        gens = streams(stream)
        n_steps = epochs * steps_per_epoch
        loss = torch.full((nb,), float("nan"), device=device)
        for _ in range(n_steps):
            x = gather_batch(X, draw_batch_idx(gens, n_valid, B, device=device))
            params, state, loss = pre_phase_step(params, opt, state, x, which)
        log(f"[{tag}] {n_steps} steps × {nb} members  final "
            f"{'recon' if which == 'ae' else 'sup'}≈{loss.mean().item():.5f}")

    # Phase 3: joint GAN steps
    optD, optG = make_gan_opts(hp)
    d_state = optD.init(params["discriminator"])
    g_state = optG.init({k: params[k] for k in GEN_NETS})
    gens = streams(_GAN)
    best = BestTracker.start(params)
    logs, step_seconds, done0 = [], [], 0
    if resume is not None:
        trees, done0 = resume
        params = restore_like(params, trees["model"])
        d_state = optD.restore(trees["optD"], d_state)
        g_state = optG.restore(trees["optG"], g_state)
        best = BestTracker(restore_like(params, trees["best"]),
                           torch.from_numpy(trees["best_loss"]).to(device),
                           torch.from_numpy(trees["best_step"]).long().to(device))
        for g, rng in zip(gens, trees["rng"]):
            g.set_state(torch.from_numpy(rng))
        logs = list(torch.from_numpy(trees["logs"]).to(device).unbind(1))

    t0 = time.perf_counter()
    with gan_profile(profile_dir, profile_name, device):
        for step in range(done0 + 1, hp.gan_steps + 1):
            t_step = time.perf_counter()
            draws = draw_gan(gens, n_valid, B, T, cfg.z_dim, device=device)
            if rate > 0:
                draws.masks = draw_gan_masks(gens, params, B, T, rate, device=device)
            x = gather_batch(X, draws.idx)
            params, d_state, g_state, lg = gan_step(params, optD, d_state, optG,
                                                    g_state, x, draws, step, hp,
                                                    weights=weights)
            logs.append(lg)
            best.update(params, lg, step)
            if device.type == "cuda":
                torch.cuda.synchronize(device)   # a step takes seconds: cheap
            step_seconds.append(time.perf_counter() - t_step)
            if step % log_every == 0 or step == hp.gan_steps:
                row = lg.mean(dim=0).tolist()
                log(f"[GAN] step {step}/{hp.gan_steps}  mean over {nb} members: "
                    f"D={row[0]:.4f} acc≈{row[1]:.2f} G={row[2]:.4f} "
                    f"({step_seconds[-1]:.3f} s)")
            if ckpt_every and step < hp.gan_steps and step % ckpt_every == 0:
                save_state({"model": params, "optD": optD.state_tree(d_state),
                            "optG": optG.state_tree(g_state), "best": best.params,
                            "best_loss": best.loss, "best_step": best.step,
                            "logs": torch.stack(logs, dim=1),
                            "rng": [g.get_state() for g in gens]}, step)
    return {"params": params, "best": best, "logs": logs, "optD": optD,
            "d_state": d_state, "optG": optG, "g_state": g_state,
            "step_seconds": step_seconds, "gan_seconds": time.perf_counter() - t0,
            "done0": done0, "ae_steps": hp.ae_epochs * steps_per_epoch,
            "sup_steps": hp.sup_epochs * steps_per_epoch}


def train_all_buckets(data_dir, out_root, *, device: torch.device | str,
                      log_every: int = 100, bucket_weights: dict | None = None,
                      ckpt_every: int | None = None, resume: bool = False,
                      profile_dir=None, **hparams) -> dict:
    """Stacked multi-bucket training; writes the per-bucket artifact set.
    Returns aggregate throughput stats, each GAN step's wall time (host clock,
    synchronised) and the pre-phase step counts.

    ``bucket_weights``: ``{bucket_name: {weight: value}}`` G-loss weight
    overrides (``TIMEGAN_G_WEIGHT_NAMES``); buckets not named keep the hp's.
    ``ckpt_every``: every this many GAN steps (before the last) the stacked
    state (params, both optimizers, best tracking, the logs so far, each
    bucket's GAN generator) goes to ``out_root/_multi_state.npz``;
    ``resume`` continues from it, skipping phases 1-2, and refuses a file of
    another run (names, seed, gan_steps, chunk). ``profile_dir`` writes a
    Chrome trace of the GAN phase there (``all_buckets_gan.trace.json``)."""
    device = torch.device(device)
    out_root = Path(out_root)
    hp = TimeGANHParams(**hparams)
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

    state_path = out_root / "_multi_state.npz"
    run_meta = {"names": ",".join(names), "seed": hp.seed,
                "gan_steps": hp.gan_steps, "chunk_eff": hp.chunk}
    resumed = None
    if resume and state_path.exists():
        rmeta = ckpt_io.load_meta(state_path)
        got = {k: type(v)(rmeta.get(k)) for k, v in run_meta.items()}
        if got != run_meta:
            raise ValueError(f"{state_path} does not match this run (saved {got}, "
                             f"expected {run_meta}): wrong out_root or changed "
                             "config")
        resumed = (ckpt_io.load_checkpoint(state_path)[0], int(rmeta["done"]))
        print(f"==> resuming GAN phase from step {rmeta['done']} ({state_path})",
              flush=True)

    weights = None
    if bucket_weights:
        weights = torch.from_numpy(
            bucket_weight_matrix(bucket_weights, names, hp)).to(device)
        print(f"==> per-bucket G weights active for {sorted(bucket_weights)}",
              flush=True)

    def save_state(trees: dict, done: int) -> None:
        out_root.mkdir(parents=True, exist_ok=True)
        ckpt_io.save_checkpoint(state_path, trees,
                                {**run_meta, "done": done, "chunks_done": done})
        print(f"[state] saved {state_path.name} @ step {done}", flush=True)

    t_all = time.perf_counter()
    run = run_stack(
        torch.from_numpy(X_host).to(device),
        torch.from_numpy(n_valid_host).to(device=device, dtype=torch.float32),
        hp, cfg, init_gens=bucket_generators(hp.seed, nb, _INIT, "cpu"),
        streams=lambda stream: bucket_generators(hp.seed, nb, stream, device),
        device=device, weights=weights, log_every=log_every, resume=resumed,
        ckpt_every=ckpt_every, save_state=save_state, profile_dir=profile_dir,
        profile_name="all_buckets")
    params, best, logs = run["params"], run["best"], run["logs"]
    gan_seconds, done0 = run["gan_seconds"], run["done0"]
    agg = nb * (hp.gan_steps - done0) / max(gan_seconds, 1e-9)
    print(f"[GAN] {nb}×{hp.gan_steps - done0} steps in {gan_seconds:.1f}s → "
          f"{agg:.1f} aggregate steps/s", flush=True)

    # Per-bucket artifacts
    logs_host = (torch.stack(logs, dim=1).cpu().numpy() if logs
                 else np.zeros((nb, 0, len(LOG_COLUMNS)), np.float32))
    opt_trees = {"optG": run["optG"].state_tree(run["g_state"]),
                 "optD": run["optD"].state_tree(run["d_state"])}
    best_step_host, best_loss_host = best.step.cpu().numpy(), best.loss.cpu().numpy()
    meta_base = {"z_dim": z_dim, "h_dim": h_dim, "x_dim": C, "layers": hp.layers}
    for b, name in enumerate(names):
        out_dir = out_root / name
        out_dir.mkdir(parents=True, exist_ok=True)
        with open(out_dir / "train_log.csv", "w") as f:
            f.write(LOG_HEADER)
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
                                {"model": unstack_params(best.params, b), **opt_b},
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
            "gan_step_seconds": run["step_seconds"],
            "ae_steps": run["ae_steps"], "sup_steps": run["sup_steps"]}


def main(argv: list[str] | None = None) -> dict:
    """``python -m eegsynth_torch.train.timegan --parallel_buckets``, kept
    under this module's name."""
    from eegsynth_torch.train.timegan import main as cli
    return cli(["--parallel_buckets", *(sys.argv[1:] if argv is None else argv)])


if __name__ == "__main__":
    main()
