"""Train the nine per-posture v2 CGANs as one stack.

Counterpart of ``eegsynth/train/cgan_multi.py``. The reference trains one
condition-conditional model per posture in a loop; here the postures are
members of one run, advanced step by step together, with each posture's best
snapshot (the EMA generator, bn, dg and dl) kept on the device. The members
run one after another inside a step, each through ``train.cgan.cgan_step``
on its own draws: R1 takes ``torch.autograd.grad(create_graph=True)``, which
``torch.func.vmap`` cannot carry. Member p's update is a lone ``cgan_step``
on the same draws.

The JAX package's documented deviations from per-posture runs hold here:

- every posture takes the same steps per epoch, the largest N_p // B
  (balanced sampling draws with replacement);
- each posture's init and noise streams are seeded from (seed, posture id),
  so a subset of postures reproduces; its D inits have tags of their own;
- there is no mid-run resume (the sequential trainer has it).

The stacked data and label tables follow JAX's ``_stack_postures``: X (P,
N_max, C, T) zero-padded, tables (P, 2, L_max), counts (P, 2); padding rows
are never drawn. The row order of each posture comes from ``np.random``
after ``np.random.seed(seed)``. Artifacts per posture, as the JAX trainer
writes them: ``hparams.json`` (``parallel_postures: true``), ``metrics.csv``,
the generator's ``best`` / ``last`` / ``epoch{N}`` files and the best
``CGAN_globalD_*`` / ``CGAN_localD_*``. ``mesh`` is refused: one card.
"""

from __future__ import annotations

import dataclasses
import json
import math
import time
from pathlib import Path

import numpy as np
import torch

from eegsynth_torch.convert import tree_to_numpy
from eegsynth_torch.data.datasets import build_label_table, load_posture_both_conditions
from eegsynth_torch.train import checkpoint as ckpt_io
from eegsynth_torch.train.cgan import (
    _INIT_DG, _INIT_DL, _INIT_G, _STEPS, METRICS_HEADER_V2, V2_OVERRIDES,
    CGANHParams, build_cfg, cgan_step, disc_init, draw_cgan_step, generator_init,
    generator_meta, make_lr, sigma_at,
)
from eegsynth_torch.train.optim import Adam
from eegsynth_torch.tree import tree_map

NUM_POSTURES = 9
_POSTURE_TAG = 0x5EED0000   # keeps the stack's seeds apart from a lone run's


def posture_seed(seed: int, posture: int, stream: int) -> int:
    """A 63-bit seed for ``posture``'s ``stream`` (``train.cgan``'s streams:
    G init, Dg init, Dl init, the steps' draws)."""
    state = np.random.SeedSequence(
        [seed, _POSTURE_TAG, posture, stream]).generate_state(2, np.uint32)
    return int(state[0]) << 31 | int(state[1]) >> 1


def stack_postures(data_dir, postures: list[int]):
    """(X (P, N_max, C, T) float32, tables (P, 2, L_max) int32, counts (P, 2)
    float32, per-posture meta, per-posture N): JAX ``_stack_postures`` in
    numpy."""
    Xs, tabs, cnts, metas = [], [], [], []
    for p in postures:
        X, y, meta = load_posture_both_conditions(data_dir, p)
        tab, cnt = build_label_table(y, 2, 0)
        Xs.append(X)
        tabs.append(tab)
        cnts.append(cnt)
        metas.append(meta)
    n_max = max(x.shape[0] for x in Xs)
    l_max = max(tb.shape[1] for tb in tabs)
    X = np.zeros((len(Xs), n_max) + Xs[0].shape[1:], np.float32)
    table = np.zeros((len(Xs), 2, l_max), np.int32)
    counts = np.zeros((len(Xs), 2), np.float32)
    for i, (x, tb, cn) in enumerate(zip(Xs, tabs, cnts)):
        X[i, :x.shape[0]] = x
        table[i, :, :tb.shape[1]] = tb
        counts[i] = cn
    return X, table, counts, metas, [x.shape[0] for x in Xs]


@dataclasses.dataclass
class Member:
    """One posture's training state."""
    G: dict
    bn: dict
    D: dict
    ema: dict
    g_state: object
    d_state: object


def init_member(cfg, seed: int, posture: int, optG: Adam, optD: Adam, *,
                device) -> Member:
    """A fresh member: its G, Dg and Dl from their own streams of
    (seed, posture), the EMA a copy of G, fresh Adam states."""
    def gen(stream):
        return torch.Generator().manual_seed(posture_seed(seed, posture, stream))

    G, bn = generator_init(cfg, gen(_INIT_G), device=device)
    D = {"dg": disc_init(cfg, gen(_INIT_DG), device=device),
         "dl": disc_init(cfg, gen(_INIT_DL), device=device)}
    return Member(G, bn, D, tree_map(torch.clone, G), optG.init(G), optD.init(D))


def stack_step(members: list[Member], X: torch.Tensor, tables: torch.Tensor,
               counts: torch.Tensor, gens: list, step_idx: int, sigma: float, *,
               cfg, hp: CGANHParams, optG: Adam, optD: Adam,
               prewarm: bool) -> torch.Tensor:
    """One step of every member, in place: member p draws from ``gens[p]``
    on its own table and steps on ``X[p]``. Returns the logs (P, 10)."""
    logs = []
    for p, m in enumerate(members):
        draws = draw_cgan_step(gens[p], hp, cfg, tables[p], counts[p],
                               prewarm=prewarm, device=X.device)
        (m.G, m.bn, m.D, m.ema, m.g_state, m.d_state, lg) = cgan_step(
            m.G, m.bn, m.D, m.ema, m.g_state, m.d_state, X[p], draws, step_idx,
            sigma, cfg=cfg, hp=hp, optG=optG, optD=optD, prewarm=prewarm)
        logs.append(lg)
    return torch.stack(logs)


def train_all_postures(data_dir, runs_root, postures=None, log=print, mesh=None,
                       *, device: torch.device | str, **hparams) -> dict:
    """v2 training of every posture in ``postures`` (default 1..9) as one
    stack; writes each posture's run directory under ``runs_root``. Returns
    ``best_g`` (P,), the aggregate steps/s, each epoch's seconds, the
    steps per epoch, the per-posture meta, the config and the members."""
    if mesh is not None:
        raise ValueError("mesh: eegsynth_torch trains on one card")
    device = torch.device(device)
    hp = CGANHParams(**{**V2_OVERRIDES, **hparams, "variant": "v2"})
    if hp.ckpt_format != "npz" or hp.async_ckpt:
        raise ValueError("the posture stack writes NPZ files at the end of its "
                         "epochs only (no ckpt_format / async_ckpt)")
    postures = list(postures or range(1, NUM_POSTURES + 1))
    cfg = build_cfg(hp, 2)
    runs_root = Path(runs_root)

    np.random.seed(hp.seed)
    X_np, tab_np, cnt_np, metas, n_per = stack_postures(data_dir, postures)
    X = torch.from_numpy(X_np).to(device)
    tables = torch.from_numpy(tab_np.astype(np.int64)).to(device)
    counts = torch.from_numpy(cnt_np).to(device)
    P = len(postures)
    steps = max(1, max(n // hp.batch_size for n in n_per))
    total_epochs = hp.prewarm + hp.epochs
    log(f"[multi] {P} postures, N={n_per}, steps/epoch {steps} (uniform), "
        f"{total_epochs} epochs | {device}")

    optG = Adam(make_lr(hp, steps, hp.lr_g), hp.beta1, hp.beta2)
    optD = Adam(make_lr(hp, steps * max(1, hp.d_steps), hp.lr_d,
                        epoch_offset=hp.prewarm), hp.beta1, hp.beta2)
    members = [init_member(cfg, hp.seed, p, optG, optD, device=device)
               for p in postures]
    gens = [torch.Generator(device=device).manual_seed(posture_seed(hp.seed, p, _STEPS))
            for p in postures]
    best_loss = [float("inf")] * P
    best = [{"G": m.ema if hp.ema else m.G, "bn": m.bn, "dg": m.D["dg"],
             "dl": m.D["dl"]} for m in members]

    dirs = []
    for p in postures:
        d = runs_root / f"posture{p}"
        d.mkdir(parents=True, exist_ok=True)
        with open(d / "hparams.json", "w") as f:
            json.dump({**dataclasses.asdict(hp), "tag": f"posture{p}",
                       "parallel_postures": True}, f, indent=2)
        if not (d / "metrics.csv").exists():
            (d / "metrics.csv").write_text(METRICS_HEADER_V2)
        dirs.append(d)

    def save_generator(path, G, bn, tag):
        ckpt_io.save_checkpoint(path, {"model": tree_to_numpy(G),
                                       "bn": tree_to_numpy(bn)},
                                generator_meta(hp, 2, tag))

    def flush_best():
        for i, (p, d) in enumerate(zip(postures, dirs)):
            if not math.isfinite(best_loss[i]):
                continue
            tag = f"posture{p}"
            save_generator(d / f"CGAN_generator_{tag}_best.npz", best[i]["G"],
                           best[i]["bn"], tag)
            for which, key in (("globalD", "dg"), ("localD", "dl")):
                ckpt_io.save_checkpoint(d / f"CGAN_{which}_{tag}_best.npz",
                                        {"model": tree_to_numpy(best[i][key])},
                                        {"tag": tag})

    t0 = time.perf_counter()
    epoch_seconds = []
    for ep in range(total_epochs):
        t_ep = time.perf_counter()
        prewarm = ep < hp.prewarm
        sigma = sigma_at(hp, total_epochs, ep)
        logs = torch.stack([stack_step(members, X, tables, counts, gens, step_idx,
                                       sigma, cfg=cfg, hp=hp, optG=optG, optD=optD,
                                       prewarm=prewarm)
                            for step_idx in range(steps)], dim=1).cpu().numpy()
        epoch_seconds.append(time.perf_counter() - t_ep)      # logs (P, steps, 10)
        for i, (m, d) in enumerate(zip(members, dirs)):
            diag = logs[i, :, :8].mean(axis=0)
            gl, dl = float(logs[i, -1, 8]), float(logs[i, -1, 9])
            with open(d / "metrics.csv", "a") as f:
                f.write(f"{ep + 1},{gl},{dl}," + ",".join(f"{v}" for v in diag) + "\n")
            # best on the last step's G loss, in adversarial epochs only
            if not prewarm and math.isfinite(gl) and gl < best_loss[i]:
                best_loss[i] = gl
                best[i] = {"G": m.ema if hp.ema else m.G, "bn": m.bn,
                           "dg": m.D["dg"], "dl": m.D["dl"]}
        if (ep + 1) % hp.print_every == 0 or ep == 0:
            log(f"[multi] Ep {ep + 1}/{total_epochs} | G per posture "
                + " ".join(f"{v:.2f}" for v in logs[:, -1, 8]))
        if (ep + 1) % hp.save_every == 0:
            for p, m, d in zip(postures, members, dirs):
                save_generator(d / f"CGAN_generator_posture{p}_epoch{ep + 1}.npz",
                               m.G, m.bn, f"posture{p}")
            flush_best()

    flush_best()
    for p, m, d in zip(postures, members, dirs):
        save_generator(d / f"CGAN_generator_posture{p}_last.npz",
                       m.ema if hp.ema else m.G, m.bn, f"posture{p}")
    dt = time.perf_counter() - t0
    agg = total_epochs * steps * P / dt if dt > 0 else float("nan")
    log(f"[multi] Done in {dt:.1f}s — {agg:.1f} aggregate steps/s; best G per "
        f"posture: {np.round(best_loss, 3).tolist()}")
    return {"best_g": np.asarray(best_loss), "aggregate_steps_per_sec": agg,
            "epoch_seconds": epoch_seconds, "steps_per_epoch": steps,
            "metas": metas, "cfg": cfg, "members": members}
