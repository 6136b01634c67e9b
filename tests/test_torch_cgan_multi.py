"""The posture stack of eegsynth_torch (``train/cgan_multi.py``, the CLI
``train/cgan_posture.py``) and ``cgan_step``'s G-weight vector, against the
JAX package on the CPU.

- ``stack_postures`` against JAX's ``_stack_postures`` on the same files
  after the same ``np.random.seed`` (numpy code: exact);
- the stack's LR schedules at its steps per epoch (the largest N_p // B,
  D's with ``epoch_offset=prewarm``) against JAX's ``make_lr`` (1e-6
  relative: float32 in optax);
- member p of one stacked step equals a lone ``cgan_step`` on the same
  draws, bit for bit;
- ``cgan_step`` with a weight vector against JAX's ``epoch_core(...,
  weights)`` (one step, replayed draws), with ``test_torch_cgan_train.py``'s
  tolerances (``check_step``): the file's one JAX compile;
- ``train_all_postures``: every artifact of each posture, read back by the
  JAX package's ``load_generator`` and checkpoint loader;
- the CLI with and without ``--parallel-postures``, the ``[skip]`` of a
  posture without both conditions, and its refusals.

The transformer runs at dim 16 or 32, depth 1, 2 heads, patch 8 (96 tokens),
B 8. JAX runs with x64 off: float32 on both sides.
"""

import json

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

from test_torch_cgan_train import TINY, check_step, replay_draws
from test_torch_threads import one_thread_each  # noqa: F401

from eegsynth.data.datasets import build_label_table
from eegsynth.train import cgan as J
from eegsynth.train import checkpoint as jck
from eegsynth.train.cgan_multi import _stack_postures
from eegsynth_torch.convert import tree_to_device
from eegsynth_torch.train import cgan as P
from eegsynth_torch.train import cgan_multi as M
from eegsynth_torch.train.cgan_posture import main as posture_cli
from eegsynth_torch.tree import tree_leaves

T, C = 768, 14
SMALL = dict(batch_size=8, arch="transformer", tf_dim=16, tf_depth=1, tf_heads=2)
SIGMA = 0.15
JAX_COMPILE = {"xla_backend_optimization_level": 0,
               "xla_llvm_disable_expensive_passes": True}


def _write(root, counts: dict, conditions=("no_exo", "with_exo")):
    """posture{p}_{c}.npz of counts[p] random windows each."""
    data = root / "data"
    data.mkdir(exist_ok=True)
    rng = np.random.default_rng(0)
    for p, n in counts.items():
        for cond in conditions:
            np.savez(data / f"posture{p}_{cond}.npz",
                     X=rng.uniform(0, 1, (n + (cond == "with_exo"), T, C)).astype(np.float32),
                     posture=np.int32(p), fs=np.float32(128.0),
                     scale_min=np.full(C, -2.0, np.float32),
                     scale_range=np.full(C, 4.0, np.float32),
                     ch_names=np.array([f"ch{i}" for i in range(C)]))
    return data


def test_stack_postures_matches_jax(tmp_path):
    data = _write(tmp_path, {1: 3, 2: 5, 4: 2})
    np.random.seed(11)
    got = M.stack_postures(data, [4, 1, 2])
    np.random.seed(11)
    with jax.enable_x64(False):
        want = _stack_postures(data, [4, 1, 2])
    for a, b in zip(got[:3], want[:3]):
        assert a.dtype == np.asarray(b).dtype
        np.testing.assert_array_equal(a, np.asarray(b))
    assert got[4] == want[4] == [5, 7, 11]
    assert [m["fs"] for m in got[3]] == [m["fs"] for m in want[3]]


def test_stack_lr_schedules_match_jax():
    over = dict(lr_decay=0.5, lr_decay_step=2, prewarm=3, d_steps=2)
    hp, jhp = (mod.CGANHParams(**{**mod.V2_OVERRIDES, **over}) for mod in (P, J))
    steps = max(n // hp.batch_size for n in (70, 130, 64))
    for count in range(0, 40, 3):
        for base, per, off in ((hp.lr_g, steps, 0),
                               (hp.lr_d, steps * hp.d_steps, hp.prewarm)):
            assert P.make_lr(hp, per, base, off)(count) == pytest.approx(
                float(J.make_lr(jhp, per, base, epoch_offset=off)(count)), rel=1e-6)


def test_stack_member_equals_a_lone_step():
    """Two postures of a stack, one step (R1 fires): each member's update
    is bit for bit the lone ``cgan_step`` of that posture on the draws its
    generator gives."""
    hp = P.CGANHParams(**{**P.V2_OVERRIDES, **SMALL})
    cfg = P.build_cfg(hp, 2)
    rng = np.random.default_rng(1)
    X = torch.from_numpy(rng.uniform(0, 1, (2, 12, C, T)).astype(np.float32))
    tab, cnt = build_label_table(np.array([0, 1] * 6), 2, 0)
    tables = torch.from_numpy(np.stack([tab, tab[:, ::-1]]).astype(np.int64).copy())
    counts = torch.from_numpy(np.stack([cnt, cnt]).astype(np.float32))
    optG, optD = P.Adam(hp.lr_g, hp.beta1, hp.beta2), P.Adam(hp.lr_d, hp.beta1, hp.beta2)

    def fresh():
        return ([M.init_member(cfg, hp.seed, p, optG, optD, device="cpu") for p in (3, 7)],
                [torch.Generator().manual_seed(M.posture_seed(hp.seed, p, 3)) for p in (3, 7)])

    members, gens = fresh()
    logs = M.stack_step(members, X, tables, counts, gens, 0, SIGMA, cfg=cfg, hp=hp,
                        optG=optG, optD=optD, prewarm=False)
    lone, lone_gens = fresh()
    assert not all(torch.equal(a, b) for a, b in zip(tree_leaves(lone[0].G),
                                                     tree_leaves(lone[1].G)))
    for p in range(2):
        m = lone[p]
        draws = P.draw_cgan_step(lone_gens[p], hp, cfg, tables[p], counts[p],
                                 prewarm=False, device="cpu")
        out = P.cgan_step(m.G, m.bn, m.D, m.ema, m.g_state, m.d_state, X[p], draws, 0,
                          SIGMA, cfg=cfg, hp=hp, optG=optG, optD=optD, prewarm=False)
        got = members[p]
        assert torch.equal(logs[p], out[6])
        for a, b in zip(tree_leaves((got.G, got.bn, got.D, got.ema, got.g_state.mu,
                                     got.d_state.nu)),
                        tree_leaves((out[0], out[1], out[2], out[3], out[4].mu,
                                     out[5].nu))):
            assert torch.equal(a, b)


def test_weighted_cgan_step_matches_jax_epoch_core():
    """v1, R1 firing, the weights off their defaults (amp_weight has no v1
    term). log_psd_weight is 0 in the vector, so its component is computed
    and weighs 0, as JAX's traced weight keeps it: its per-class std is
    ill-conditioned here (at B 8 over 9 classes most classes hold one row,
    whose variance is rounding noise under a square root), and a weight of
    0.2 puts the two packages' float32 gradients 7 % apart."""
    weights = np.array([9.0, 0.8, 0.4, 0.6, 0.3, 1.1, 0.0], np.float32)
    assert len(weights) == len(P.G_WEIGHT_NAMES) == len(J.G_WEIGHT_NAMES)
    assert P.G_WEIGHT_NAMES == J.G_WEIGHT_NAMES
    kw = {**TINY, "variant": "v1"}
    hp, thp = J.CGANHParams(**kw), P.CGANHParams(**kw)
    rng = np.random.default_rng(0)
    X = rng.uniform(0, 1, (4 * 9, C, T)).astype(np.float32)
    tab, cnt = build_label_table(np.repeat(np.arange(1, 10), 4), 9, 1)
    with jax.enable_x64(False):
        cfg = J.build_cfg(hp, 9)
        G, bn = J.generator_init(jax.random.key(1), cfg)
        rk = jax.random.split(jax.random.key(9), cfg.depth + 1)
        for i in range(cfg.depth):
            G[f"blk{i}"]["ada"]["w"] = 0.1 * jax.random.normal(
                rk[i], G[f"blk{i}"]["ada"]["w"].shape)
        G["head_ada"]["w"] = 0.1 * jax.random.normal(rk[-1], G["head_ada"]["w"].shape)
        D = {"dg": J.disc_init(jax.random.key(2), cfg),
             "dl": J.disc_init(jax.random.key(3), cfg)}
        optG = optax.adam(hp.lr_g, b1=hp.beta1, b2=hp.beta2)
        optD = optax.adam(hp.lr_d, b1=hp.beta1, b2=hp.beta2)
        key = jax.random.key(5)
        args = (G, bn, D, G, optG.init(G), optD.init(D), jnp.asarray(X),
                jnp.asarray(tab), jnp.asarray(cnt, jnp.float32), jnp.float32(SIGMA), key,
                jnp.asarray(weights))
        core = jax.jit(J._make_epoch_core(cfg, hp, optG, optD, 1, prewarm=False))
        want = core.lower(*args).compile(compiler_options=JAX_COMPILE)(*args)
        draws = replay_draws(key, hp, cfg, tab, cnt, False)
    tcfg = P.build_cfg(thp, 9)
    oG, oD = P.Adam(thp.lr_g, thp.beta1, thp.beta2), P.Adam(thp.lr_d, thp.beta1, thp.beta2)
    tG, tD = (tree_to_device(jax.tree.map(np.asarray, t), device="cpu") for t in (G, D))
    got = P.cgan_step(tG, {}, tD, tG, oG.init(tG), oD.init(tD), torch.from_numpy(X),
                      draws, 0, float(np.float32(SIGMA)), cfg=tcfg, hp=thp, optG=oG,
                      optD=oD, prewarm=False, weights=torch.from_numpy(weights))
    check_step(got, want, thp)
    plain = P.cgan_step(tG, {}, tD, tG, oG.init(tG), oD.init(tD), torch.from_numpy(X),
                        draws, 0, float(np.float32(SIGMA)), cfg=tcfg, hp=thp, optG=oG,
                        optD=oD, prewarm=False)
    assert got[6][8] != plain[6][8] and torch.equal(got[6][9], plain[6][9])


def _artifacts(d, p, epochs):
    tag = f"posture{p}"
    return sorted(["hparams.json", "metrics.csv", f"CGAN_generator_{tag}_best.npz",
                   f"CGAN_generator_{tag}_last.npz", f"CGAN_globalD_{tag}_best.npz",
                   f"CGAN_localD_{tag}_best.npz"]
                  + [f"CGAN_generator_{tag}_epoch{e}.npz" for e in epochs])


def test_train_all_postures_writes_jax_readable_runs(tmp_path):
    data = _write(tmp_path, {1: 9, 2: 17, 3: 8})
    res = M.train_all_postures(data, tmp_path / "runs", postures=[1, 2, 3], device="cpu",
                               epochs=2, prewarm=1, save_every=2, print_every=1, **SMALL)
    assert res["steps_per_epoch"] == 35 // 8 and len(res["epoch_seconds"]) == 3
    assert np.isfinite(res["best_g"]).all()
    with jax.enable_x64(False):
        jhp = J.CGANHParams(**{**J.V2_OVERRIDES, **SMALL})
        jcfg = J.build_cfg(jhp, 2)
        D0 = J.disc_init(jax.random.key(0), jcfg)
    for p in (1, 2, 3):
        d = tmp_path / "runs" / f"posture{p}"
        assert sorted(f.name for f in d.iterdir()) == _artifacts(d, p, [2])
        hp = json.loads((d / "hparams.json").read_text())
        assert hp["parallel_postures"] is True and hp["tag"] == f"posture{p}"
        assert hp["variant"] == "v2" and hp["epochs"] == 2
        lines = (d / "metrics.csv").read_text().splitlines()
        assert lines[0] + "\n" == J.METRICS_HEADER_V2 and len(lines) == 4
        rows = np.array([[float(v) for v in ln.split(",")] for ln in lines[1:]])
        assert list(rows[:, 0]) == [1, 2, 3] and np.isfinite(rows).all()
        assert (rows[0, 2:] == 0).all()             # the prewarm epoch: no D
        with jax.enable_x64(False):
            G, bn, cfg, meta = J.load_generator(d / f"CGAN_generator_posture{p}_best.npz")
            for which in ("globalD", "localD"):
                jck.load_checkpoint(d / f"CGAN_{which}_posture{p}_best.npz",
                                    {"model": D0})
        assert meta["tag"] == f"posture{p}" and cfg.num_classes == 2
        assert cfg.dim == 16 and meta["variant"] == "v2"
    with pytest.raises(ValueError, match="one card"):
        M.train_all_postures(data, tmp_path / "x", device="cpu", mesh=object())


def test_posture_cli_both_modes(tmp_path, capsys):
    data = _write(tmp_path, {1: 8, 2: 8})
    _write(tmp_path, {3: 8}, conditions=("no_exo",))     # posture 3 lacks with_exo
    cli = ["--data-dir", str(data), "--epochs", "1", "--prewarm", "0", "--batch-size",
           "8", "--arch", "transformer", "--tf-dim", "16", "--tf-depth", "1",
           "--tf-heads", "2", "--save-every", "1", "--device", "cpu"]
    res = posture_cli([*cli, "--runs-root", str(tmp_path / "par"), "--parallel-postures"])
    assert "[skip] postures [3, 4, 5, 6, 7, 8, 9]" in capsys.readouterr().out
    assert len(res["best_g"]) == 2
    seq = posture_cli([*cli, "--runs-root", str(tmp_path / "seq"), "--posture", "2"])
    assert list(seq) == [2] and seq[2]["steps_per_epoch"] == 2
    d = tmp_path / "seq" / "posture2"
    assert "parallel_postures" not in json.loads((d / "hparams.json").read_text())
    assert (d / "checkpoint_epoch1.npz").exists()
    for name in ("CGAN_generator_posture2_best.npz", "CGAN_generator_posture2_epoch1.npz"):
        assert (tmp_path / "par" / "posture2" / name).exists()
    with pytest.raises(SystemExit, match="No postures"):
        posture_cli([*cli, "--runs-root", str(tmp_path / "x"), "--posture", "3"])
    for extra in (["--mesh"], ["--multihost"], ["--parallel-postures", "--ckpt-format",
                                                "npz"],
                  ["--parallel-postures", "--no-async-ckpt"]):
        with pytest.raises(SystemExit):
            posture_cli([*cli, "--runs-root", str(tmp_path / "x"), *extra])
    assert not (tmp_path / "x").exists()
