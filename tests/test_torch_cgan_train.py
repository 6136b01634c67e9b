"""eegsynth_torch's transformer-CGAN trainer against eegsynth's, on the CPU:
one step (``cgan_step``) against ``make_cgan_epoch(..., 1, ...)`` on the
same parameters, data and draws, v1 hinge with R1 on and off (v2 and
wgan-gp in ``test_torch_cgan_step.py``); the optimizer-state layout;
checkpoints in both directions; and a tiny ``train_one_condition`` through
the CLI that writes every artifact.

The draws are JAX's own: :func:`replay_draws` replays the step's key splits
(``split(key, 21)``: ``ks[0:12]`` for the D update, ``ks[12..19]`` for the G
update, a 12-way split of a fresh key for each further D update, the 7-way
split inside ``diffaugment_1d``, ``fold_in(kd[2], 0x47500001)`` for the
gradient penalty) into the port's draw dataclasses, at the batch, length
and feature width of the configuration.
JAX runs with x64 off: float32 on both sides.
"""

import dataclasses
import functools
import json

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

from test_torch_threads import one_thread_each  # noqa: F401

from eegsynth.data.datasets import build_label_table
from eegsynth.losses.spectral import ALL_PAIRS
from eegsynth.models.cgan import DISC_CHANNELS
from eegsynth.train import cgan as J
from eegsynth.train import checkpoint as jckpt
from eegsynth_torch.convert import tree_to_device
from eegsynth_torch.losses.augment import AugmentDraws
from eegsynth_torch.train import cgan as P
from eegsynth_torch.tree import tree_leaves

B, C, T = 8, 14, 768
TINY = dict(batch_size=B, arch="transformer", tf_dim=32, tf_depth=1, tf_heads=2,
            tf_patch=8)
SIGMA = 0.15
# Tolerances, float32 on both sides. Logged values: 2e-5 relative (sums in
# another order; the accuracies are exact). Adam's first moments (the
# gradients): 1e-5 of each leaf's largest. Parameters: Adam's first step
# moves an element by lr·g/(|g| + 1e-8), about lr·sign(g), so an element
# whose gradient sits at rounding level (|g| ≤ 1e-6, e.g. the key biases,
# whose gradient is zero in exact arithmetic) may land anywhere within ±lr:
# those are held through their gradient above; every other element within
# 2e-6.
LOG_RTOL, MU_RTOL, PARAM_ATOL, GRAD_FLOOR = 2e-5, 1e-5, 2e-6, 1e-6


def _t(a):
    return torch.from_numpy(np.array(a))


def _port(tree):
    return tree_to_device(jax.tree.map(np.asarray, tree), device="cpu")


def _augment(key, p, B, T):
    """The seven draws of ``diffaugment_1d`` from its own 7-way split."""
    k_c1, k_c2, k_c3, k_shift, k_scale, k_bias, k_start = jax.random.split(key, 7)
    w = max(1, int(0.05 * T))
    return dict(
        do_shift=jax.random.uniform(k_c1) < p,
        shift=jax.random.randint(k_shift, (), -8, 9),
        do_jitter=jax.random.uniform(k_c2) < p,
        scale=0.9 + 0.2 * jax.random.uniform(k_scale, (B, 1, 1), jnp.float32),
        bias=0.02 * jax.random.normal(k_bias, (B, 1, 1), jnp.float32),
        do_cutout=jax.random.uniform(k_c3) < p,
        start=jax.random.randint(k_start, (B, 1, 1), 0, T - w))


def _balanced(key, table, counts, variant, B):
    """``_sample_balanced``'s draws: (rows, labels)."""
    k1, k2, k3 = jax.random.split(key, 3)
    K = table.shape[0]
    if variant == "v1":
        lab = jax.random.randint(k1, (B,), 0, K)
    else:
        lab = jax.random.permutation(k3, jnp.concatenate(
            [jnp.zeros(B // 2, jnp.int32), jnp.ones(B - B // 2, jnp.int32)]))
    u = jax.random.uniform(k2, (B,))
    offs = jnp.floor(u * counts[lab]).astype(jnp.int32)
    return table[lab, offs], lab


@functools.partial(jax.jit, static_argnames=("hp", "cfg", "prewarm"))
def _replay_arrays(key, table, counts, hp, cfg, prewarm):
    """Every array of one JAX step's draws, in one compiled program (the
    same bits as drawn one by one)."""
    B, C, T = hp.batch_size, cfg.channels, cfg.seq_len
    width = cfg.dim if cfg.arch == "transformer" else DISC_CHANNELS[-1]
    key, *ks = jax.random.split(key, 21)
    v1 = hp.variant == "v1"
    crop = lambda k: (jax.random.randint(k, (), 0, T - hp.local_crop + 1)  # noqa: E731
                      if v1 and T > hp.local_crop else None)
    keep = lambda k: jax.random.bernoulli(k, 1.0 - cfg.dropout, (B, width))  # noqa: E731
    gp = hp.gan_loss == "wgan-gp" and hp.gp_weight > 0

    def d_draws(kd):
        rows, labels = _balanced(kd[0], table, counts, hp.variant, B)
        return dict(
            rows=rows, labels=labels,
            z=jax.random.normal(kd[1], (B, hp.noise_dim), jnp.float32),
            noise_real=jax.random.normal(kd[2], (B, C, T), jnp.float32),
            noise_fake=jax.random.normal(kd[3], (B, C, T), jnp.float32),
            aug_real=_augment(kd[4], hp.diffaugment_p, B, T),
            aug_fake=_augment(kd[5], hp.diffaugment_p, B, T),
            crop_real=crop(kd[6]), crop_fake=crop(kd[7]),
            keep=None if v1 else [keep(kd[i]) for i in range(8, 12)],
            gp_eps=((jax.random.uniform(jax.random.fold_in(kd[2], 0x47500001),
                                        (B, 1, 1), jnp.float32),
                     jax.random.uniform(jax.random.fold_in(kd[3], 0x47500002),
                                        (B, 1, 1), jnp.float32))
                    if gp else None))

    d = []
    if not prewarm:
        d.append(d_draws(ks[:12]))
        for _ in range(1, max(1, hp.d_steps)):    # further D updates: fresh keys
            key, sub = jax.random.split(key)
            d.append(d_draws(jax.random.split(sub, 12)))
    rows, labels = _balanced(ks[12], table, counts, hp.variant, B)
    g = dict(rows=rows, labels=labels,
             z=jax.random.normal(ks[13], (B, hp.noise_dim), jnp.float32),
             noise=jax.random.normal(ks[14], (B, C, T), jnp.float32),
             aug=_augment(ks[15], hp.diffaugment_p, B, T), crop=crop(ks[16]),
             keep=None if v1 else [keep(ks[17]), keep(ks[18])],
             perm=jax.random.permutation(ks[19], len(ALL_PAIRS))[:hp.coh_pairs])
    return d, g


def replay_draws(key, hp, cfg, table, counts, prewarm):
    """One JAX step's draws (``one_step``, eegsynth/train/cgan.py) as the
    port's :class:`CGANDraws`, at B = ``hp.batch_size``, T =
    ``cfg.seq_len`` and v2's keep masks at the discriminator's feature
    width. Call under ``jax.enable_x64(False)``."""
    d, g = _replay_arrays(key, jnp.asarray(table), jnp.asarray(counts, jnp.float32),
                          hp=hp, cfg=cfg, prewarm=prewarm)
    ints = ("rows", "labels", "shift", "start", "crop_real", "crop_fake", "crop")

    def tensors(tree):
        return {k: (None if v is None else AugmentDraws(**tensors(v)) if isinstance(v, dict)
                    else [_t(a) for a in v] if isinstance(v, list)
                    else tuple(_t(a) for a in v) if isinstance(v, tuple)
                    else _t(v).long() if k in ints else _t(v))
                for k, v in tree.items()}

    perm = np.asarray(g.pop("perm"))
    return P.CGANDraws(d=[P.DDraws(**tensors(dd)) for dd in d],
                       g=P.GDraws(**tensors(g), pairs=None if hp.variant == "v1"
                                  else torch.from_numpy(ALL_PAIRS[perm])))


def run_step_pair(variant="v1", prewarm=False, **over):
    """The same step in both packages from a perturbed generator (adaLN
    weights non-zero, so attention reaches the output and its gradient is
    not zero). Returns (port outputs, JAX outputs, port hp)."""
    K, base = (9, 1) if variant == "v1" else (2, 0)
    kw = {**(J.V2_OVERRIDES if variant == "v2" else {}), **TINY, "variant": variant,
          **over}
    hp, thp = J.CGANHParams(**kw), P.CGANHParams(**kw)
    rng = np.random.default_rng(0)
    X = rng.uniform(0, 1, (4 * K, C, T)).astype(np.float32)
    tab, cnt = build_label_table(np.repeat(np.arange(base, base + K), 4), K, base)
    with jax.enable_x64(False):
        cfg = J.build_cfg(hp, K)
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
        want = J.make_cgan_epoch(cfg, hp, optG, optD, 1, prewarm=prewarm)(
            G, bn, D, G, optG.init(G), optD.init(D), jnp.asarray(X), jnp.asarray(tab),
            jnp.asarray(cnt, jnp.float32), jnp.float32(SIGMA), key)
        draws = replay_draws(key, hp, cfg, tab, cnt, prewarm)
    tcfg = P.build_cfg(thp, K)
    oG = P.Adam(thp.lr_g, thp.beta1, thp.beta2)
    oD = P.Adam(thp.lr_d, thp.beta1, thp.beta2)
    tG, tD = _port(G), _port(D)
    got = P.cgan_step(tG, {}, tD, tG, oG.init(tG), oD.init(tD), torch.from_numpy(X),
                      draws, 0, float(np.float32(SIGMA)), cfg=tcfg, hp=thp, optG=oG,
                      optD=oD, prewarm=prewarm)
    return got, want, thp


def leaf_names(tree, prefix=""):
    """The dotted path of each leaf of a parameter tree, in tree_leaves' order."""
    if isinstance(tree, dict):
        return [n for k in sorted(tree) for n in leaf_names(tree[k], f"{prefix}{k}.")]
    return [prefix[:-1]]


def check_step(got, want, hp, d_first_mu=None, g_zero_grad=()):
    """``d_first_mu``: with two D updates, D's first moments after the
    first one alone; an element whose gradient was at rounding level in
    that update may also be anywhere within ±lr after it. ``g_zero_grad``:
    the paths of generator leaves whose gradient is zero in exact
    arithmetic, whatever its rounding noise (a conv bias ahead of a
    train-mode batch norm): held through their moments alone, as Adam's
    first step moves each element by ±lr on its noise's sign."""
    G2, _, D2, ema2, gs, ds, logs = got
    jG2, _, jD2, jema2, jgs, jds, jlogs = want
    np.testing.assert_allclose(logs.numpy(), np.asarray(jlogs)[0], rtol=LOG_RTOL,
                               atol=1e-6)
    assert set(g_zero_grad) <= set(leaf_names(G2)), g_zero_grad
    for state, jstate, params, jparams, first, zero in (
            (gs, jgs, G2, jG2, None, g_zero_grad), (ds, jds, D2, jD2, d_first_mu, ())):
        assert state.count == int(jstate[0].count)
        firsts = tree_leaves(first) if first is not None else [None] * len(
            tree_leaves(params))
        for name, m, mj, p, pj, m1 in zip(
                leaf_names(params), tree_leaves(state.mu), jax.tree.leaves(jstate[0].mu),
                tree_leaves(params), jax.tree.leaves(jparams), firsts):
            mj, pj = np.asarray(mj), np.asarray(pj)
            np.testing.assert_allclose(m.numpy(), mj, rtol=0,
                                       atol=MU_RTOL * max(1.0, np.abs(mj).max()))
            if name in zero:
                continue
            far = np.abs(p.numpy() - pj) > PARAM_ATOL
            # elements off by more than PARAM_ATOL: only where |g| is at
            # rounding level (g = mu / (1 - b1) after one step)
            small = np.abs(mj) / (1 - hp.beta1) <= GRAD_FLOOR
            if m1 is not None:
                small |= np.abs(m1.numpy()) / (1 - hp.beta1) <= GRAD_FLOOR
            assert np.all(small[far]), (p.shape, int(far.sum()))
    # EMA: 0.999 · G0 + 0.001 · G1, the u vectors of both discriminators
    for a, b in zip(tree_leaves(ema2), jax.tree.leaves(jema2)):
        np.testing.assert_allclose(a.numpy(), np.asarray(b), rtol=0, atol=PARAM_ATOL)
    for net in ("dg", "dl"):
        for head in ("fc", "cls"):
            np.testing.assert_allclose(D2[net][head]["u"].numpy(),
                                       np.asarray(jD2[net][head]["u"]), atol=1e-6)


@pytest.mark.parametrize("r1_gamma", [0.5, 0.0])
def test_v1_hinge_step_matches_jax(r1_gamma):
    """R1 fires at step index 0 (r1_gamma 0.5) or is off (0.0)."""
    got, want, hp = run_step_pair("v1", r1_gamma=r1_gamma)
    check_step(got, want, hp)


def test_optimizer_state_layout_matches_optax():
    params = {"a": {"w": jnp.ones((2, 3)), "u": jnp.ones((2,))}, "b": jnp.zeros((4,))}
    tparams = _port(params)
    for lr in (1e-3, J.make_lr(J.CGANHParams(lr_decay=0.5), 3, 1e-3)):
        with jax.enable_x64(False):
            state = optax.adam(lr, b1=0.5, b2=0.999).init(params)
        want = [jax.tree_util.keystr(k) for k, _ in
                jax.tree_util.tree_flatten_with_path(state)[0]]
        opt = P.Adam(lr, 0.5, 0.999)
        tree = opt.state_tree(opt.init(tparams))
        flat = {}
        P.ckpt_io._flatten(tree, "", flat)
        assert sorted(flat) == sorted(want)


def test_adam_matches_optax_over_steps():
    """Three updates with a StepLR schedule that decays after the second."""
    rng = np.random.default_rng(0)
    p0 = {"w": rng.standard_normal((5, 4)).astype(np.float32)}
    grads = [{"w": rng.standard_normal((5, 4)).astype(np.float32)} for _ in range(3)]
    hp = J.CGANHParams(lr_decay=0.5, lr_decay_step=1)
    with jax.enable_x64(False):
        opt = optax.adam(J.make_lr(hp, 2, 1e-2), b1=0.5, b2=0.999)
        p, s = jax.tree.map(jnp.asarray, p0), None
        s = opt.init(p)
        for g in grads:
            u, s = opt.update(jax.tree.map(jnp.asarray, g), s, p)
            p = optax.apply_updates(p, u)
    topt = P.Adam(P.make_lr(P.CGANHParams(lr_decay=0.5, lr_decay_step=1), 2, 1e-2),
                  0.5, 0.999)
    tp = _port(p0)
    ts = topt.init(tp)
    for g in grads:
        tp, ts = topt.update(_port(g), ts, tp)
    np.testing.assert_allclose(tp["w"].numpy(), np.asarray(p["w"]), rtol=0, atol=1e-6)
    assert ts.count == 3 and int(topt.state_tree(ts)[1]["count"]) == 3


def test_hparams_and_schedules_match_jax():
    j = {f.name: f.default for f in dataclasses.fields(J.CGANHParams)}
    t = {f.name: f.default for f in dataclasses.fields(P.CGANHParams)}
    assert j.pop("ckpt_format") == "orbax" and t.pop("ckpt_format") == "npz"
    assert j == t and J.V2_OVERRIDES == P.V2_OVERRIDES
    assert J.METRICS_HEADER_V1 == P.METRICS_HEADER_V1
    assert J.METRICS_HEADER_V2 == P.METRICS_HEADER_V2
    hp = P.CGANHParams(lr_decay=0.5, lr_decay_step=2)
    jhp = J.CGANHParams(lr_decay=0.5, lr_decay_step=2)
    for e in range(5):
        assert P.sigma_at(hp, 5, e) == J.sigma_at(jhp, 5, e)
    for count in range(12):
        assert P.make_lr(hp, 3, 1e-3, 1)(count) == pytest.approx(
            float(J.make_lr(jhp, 3, 1e-3, 1)(count)), rel=1e-6)
    assert P.generator_meta(P.CGANHParams(arch="transformer"), 9, "x") == \
        J.generator_meta(J.CGANHParams(arch="transformer"), 9, "x")
    assert P.CGANHParams(gan_loss="wgan-gp").r1_gamma == 0.0
    with pytest.raises(ValueError):
        P.CGANHParams(arch="transformer", precision_d="bf16")


def _write_buckets(root, n=2):
    data = root / "data"
    data.mkdir()
    rng = np.random.default_rng(0)
    for posture in range(1, 10):
        for cond in ("no_exo", "with_exo"):
            np.savez(data / f"posture{posture}_{cond}.npz",
                     X=rng.uniform(0, 1, (n, T, C)).astype(np.float32),
                     posture=np.int32(posture), fs=np.float32(128.0),
                     scale_min=np.full(C, -2.0, np.float32),
                     scale_range=np.full(C, 4.0, np.float32),
                     ch_names=np.array([f"ch{i}" for i in range(C)]))
    return data


CLI_TINY = ["--arch", "transformer", "--tf-dim", "16", "--tf-depth", "1",
            "--tf-heads", "2", "--batch-size", "8", "--device", "cpu",
            "--print-every", "1"]


def test_train_one_condition_cli_writes_every_artifact(tmp_path):
    from eegsynth_torch.train.checkpoint import load_checkpoint

    data = _write_buckets(tmp_path)
    runs = tmp_path / "runs"
    res = P.main(["--data-dir", str(data), "--save-root", str(runs), "--condition",
                  "no_exo", "--epochs", "2", "--save-every", "2", *CLI_TINY])
    run = runs / "no_exo"
    assert sorted(p.name for p in run.iterdir()) == sorted([
        "hparams.json", "metrics.csv", "checkpoint_epoch2.npz",
        "CGAN_generator_no_exo_epoch2.npz", "CGAN_generator_no_exo_best.npz",
        "CGAN_generator_no_exo_last.npz", "CGAN_globalD_no_exo_best.npz",
        "CGAN_localD_no_exo_best.npz"])
    lines = (run / "metrics.csv").read_text().splitlines()
    assert lines[0] + "\n" == P.METRICS_HEADER_V1 and len(lines) == 3
    rows = np.array([[float(v) for v in ln.split(",")] for ln in lines[1:]])
    assert np.isfinite(rows).all() and list(rows[:, 0]) == [1, 2]
    assert res["no_exo"]["steps_per_epoch"] == 2        # 18 windows // 8
    assert json.loads((run / "hparams.json").read_text())["tag"] == "no_exo"
    trees, meta = load_checkpoint(run / "checkpoint_epoch2.npz")
    assert set(trees) == {"G", "D", "ema", "optG", "optD"} and meta["epoch"] == 2
    assert int(trees["optD"][0]["count"]) == 4 and len(trees["optD"]) == 1  # EmptyState
    # the port resumes from its own full state (nothing left to run)
    again = P.main(["--data-dir", str(data), "--save-root", str(tmp_path / "again"),
                    "--condition", "no_exo", "--epochs", "2", "--resume",
                    str(run / "checkpoint_epoch2.npz"), *CLI_TINY])["no_exo"]
    for a, b in zip(tree_leaves(again["G"]), tree_leaves(trees["G"])):
        np.testing.assert_array_equal(a.numpy(), b)
    assert again["d_state"].count == 4 and again["best_g"] == meta["best_g"]

    # JAX's loaders read the port's artifacts, strict, into its own templates
    with jax.enable_x64(False):
        hp = J.CGANHParams(arch="transformer", tf_dim=16, tf_depth=1, tf_heads=2)
        cfg = J.build_cfg(hp, 9)
        G, bn = J.generator_init(jax.random.key(0), cfg)
        D = {"dg": J.disc_init(jax.random.key(0), cfg),
             "dl": J.disc_init(jax.random.key(0), cfg)}
        optG, optD = optax.adam(1e-3), optax.adam(1e-3)
        jckpt.load_checkpoint(run / "checkpoint_epoch2.npz", {
            "G": G, "bn": bn, "D": D, "ema": G, "optG": optG.init(G),
            "optD": optD.init(D)})
        G_j, bn_j, cfg_j, meta = J.load_generator(run / "CGAN_generator_no_exo_best.npz")
        z = np.random.default_rng(1).standard_normal((3, 100)).astype(np.float32)
        x_j = np.asarray(J.generator_apply(G_j, bn_j, jnp.asarray(z),
                                           jnp.array([0, 4, 8]), cfg_j, train=False)[0])
    G_p, bn_p, cfg_p, _ = P.load_generator(run / "CGAN_generator_no_exo_best.npz",
                                           device="cpu")
    assert meta["arch"] == "transformer" and cfg_j.dim == cfg_p.dim == 16
    x_p = P.generator_apply(G_p, bn_p, torch.from_numpy(z),
                            torch.tensor([0, 4, 8]), cfg_p, train=False)[0]
    np.testing.assert_allclose(x_p.numpy(), x_j, rtol=0, atol=1e-6)

    out = P.main(["generate", "--condition", "no_exo", "--data-dir", str(data),
                  "--save-root", str(runs), "--num-per-posture", "3", "--device", "cpu",
                  "--inverse-scale"])
    files = sorted(p.name for p in out.iterdir())
    assert files == [f"synth_posture{p}_no_exo.npz" for p in range(1, 10)]
    with np.load(out / files[0], allow_pickle=True) as z:
        assert z["X"].shape == (3, T, C) and int(z["posture"]) == 1
        assert z["X"].min() >= -2.0 and z["X"].max() <= 2.0   # x·4 − 2


def test_resume_from_a_jax_full_state_checkpoint(tmp_path):
    """The port resumes from the NPZ full state the JAX trainer writes:
    parameters, EMA, optimizer moments and counts load exactly; training
    continues at the next epoch."""
    data = _write_buckets(tmp_path)
    with jax.enable_x64(False):
        hp = J.CGANHParams(**{**TINY, "tf_dim": 16}, lr_decay=0.5)
        cfg = J.build_cfg(hp, 9)
        G, bn = J.generator_init(jax.random.key(3), cfg)
        D = {"dg": J.disc_init(jax.random.key(4), cfg),
             "dl": J.disc_init(jax.random.key(5), cfg)}
        ema = jax.tree.map(lambda a: a + 0.01, G)
        optG = optax.adam(J.make_lr(hp, 2, hp.lr_g), b1=hp.beta1, b2=hp.beta2)
        optD = optax.adam(J.make_lr(hp, 2, hp.lr_d), b1=hp.beta1, b2=hp.beta2)
        rng = np.random.default_rng(6)
        noisy = lambda t: jax.tree.map(  # noqa: E731
            lambda a: jnp.asarray(rng.standard_normal(a.shape), a.dtype) * 1e-3, t)
        g_state = optG.init(G)
        g_state = (g_state[0]._replace(count=jnp.int32(4), mu=noisy(G),
                                       nu=jax.tree.map(jnp.abs, noisy(G))),
                   g_state[1]._replace(count=jnp.int32(4)))
        d_state = optD.init(D)
        d_state = (d_state[0]._replace(count=jnp.int32(4), mu=noisy(D),
                                       nu=jax.tree.map(jnp.abs, noisy(D))),
                   d_state[1]._replace(count=jnp.int32(4)))
        ckpt = tmp_path / "checkpoint_epoch2.npz"
        jckpt.save_checkpoint(ckpt, {"G": G, "bn": bn, "D": D, "ema": ema,
                                     "optG": g_state, "optD": d_state},
                              {"epoch": 2, "g_loss": 3.0, "d_loss": 1.0,
                               "best_g": 2.5, "tag": "no_exo"})
    kw = {**TINY, "tf_dim": 16, "lr_decay": 0.5, "save_every": 100, "device": "cpu"}
    res = P.train_one_condition(data, tmp_path / "runs", "no_exo", resume=str(ckpt),
                                epochs=2, **kw)               # nothing left to run
    for got, want in ((res["G"], G), (res["D"], D), (res["ema"], ema),
                      (res["g_state"].mu, g_state[0].mu), (res["d_state"].nu, d_state[0].nu)):
        for a, b in zip(tree_leaves(got), jax.tree.leaves(want)):
            np.testing.assert_array_equal(a.numpy(), np.asarray(b))
    assert res["g_state"].count == res["d_state"].count == 4
    assert res["best_g"] == 2.5
    res = P.train_one_condition(data, tmp_path / "runs", "no_exo", resume=str(ckpt),
                                epochs=3, **kw)               # one more epoch
    assert res["g_state"].count == 6
    lines = (tmp_path / "runs" / "no_exo" / "metrics.csv").read_text().splitlines()
    assert lines[-1].startswith("3,")


def test_unported_options_raise(tmp_path):
    data = _write_buckets(tmp_path)
    with pytest.raises(ValueError, match="NPZ"):
        P.train_one_condition(data, tmp_path / "r", "no_exo", device="cpu",
                              ckpt_format="orbax", **TINY)
    # tf_remat is ported: the transformer's D blocks recompute in backward
    assert P.build_cfg(P.CGANHParams(tf_remat=True, **TINY), 9).remat
    with pytest.raises(SystemExit, match="one card"):
        P.main(["--mesh", "--data-dir", str(data), *CLI_TINY])
