"""eegsynth_torch's sequential TimeGAN trainer against the JAX package's
``train_single_npz`` pieces, one epoch or one step at a time on the same
parameters, batches, noise and dropout masks: ``make_ae_epoch`` /
``make_sup_epoch`` over ``_padded_batches`` (the last batch padded), one GAN
step of ``make_gan_chunk(...)(B)`` at chunk 1, with a weight matrix against
``with_weights=True``, and ``_epoch_cycle_next``. JAX's randomness is
re-derived here from its own key splits and handed to the port. Then the
checkpoints both ways, the trainers' artifacts and resume, and the CLI.

The JAX side runs with x64 off (conftest turns it on): float32 on both sides.
"""

import json
import shutil

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from eegsynth.losses import timegan as jlosses
from eegsynth.models import timegan as jmodels
from eegsynth.models.timegan import TimeGANConfig, timegan_init
from eegsynth.train import checkpoint as jck
from eegsynth.train import timegan as jtrain
from eegsynth_torch.losses import timegan as tlosses
from eegsynth_torch.models import timegan as tmodels
from eegsynth_torch.train import optim as topt
from eegsynth_torch.train import timegan as ttrain
from eegsynth_torch.train.checkpoint import load_checkpoint
from eegsynth_torch.tree import tree_leaves, tree_map

N, B, T, C = 10, 4, 12, 5          # three batches an epoch, the last padded
GEN = ("generator", "supervisor", "embedder", "recovery")
RATE = 0.2

# The tolerances of tests/test_torch_train.py: float32 on both sides, R1 the
# direct penalty here and JAX's surrogate (same value and gradient)
LOSS_TOL = 2e-5
PARAM_ATOL = 2e-5


def _cfg(layers):
    return TimeGANConfig(x_dim=C, z_dim=8, h_dim=12, num_layers=layers)


def _setup(layers, seed=0):
    with jax.enable_x64(False):
        params = timegan_init(jax.random.key(seed), _cfg(layers))
    X = np.random.default_rng(seed).uniform(0, 1, (N, T, C)).astype(np.float32)
    return params, X


def _stacked(tree):
    """A JAX tree of one model → the port's tree at nb 1."""
    return tree_map(lambda a: torch.from_numpy(np.array(a, np.float32))[None], tree)


def _close(got, want, **tol):
    """A port tree at nb 1 against the JAX tree of one model."""
    got, want = tree_leaves(got), jax.tree.leaves(want)
    assert len(got) == len(want)
    for a, b in zip(got, want):
        np.testing.assert_allclose(a.detach().numpy()[0], np.asarray(b), **tol)


def _jax_masks(key, n_boundaries, shape):
    """``gru_stack_apply``'s keep-masks for a stack with ``key`` (JAX
    ``eegsynth/nn/gru.py:134-138``), at nb 1 as the port takes them."""
    out = []
    for _ in range(n_boundaries):
        key, sub = jax.random.split(key)
        keep = jax.random.bernoulli(sub, 1.0 - RATE, shape)
        out.append(torch.from_numpy(np.array(keep))[None])
    return out


# ---------------------------------------------------------------------------
# losses and the model's dropout
# ---------------------------------------------------------------------------

def test_weighted_losses_match_jax():
    rng = np.random.default_rng(0)
    x, y = (rng.standard_normal((B, T, C)).astype(np.float32) for _ in range(2))
    w = np.array([1, 1, 0, 1], np.float32)
    with jax.enable_x64(False):
        want = [jlosses.recon_loss(x, y, weight=w), jlosses.sup_loss(x, weight=w),
                jlosses.recon_loss(x, y), jlosses.sup_loss(x)]
    tx, ty, tw = (torch.from_numpy(a) for a in (x, y, w))
    got = [tlosses.recon_loss(tx, ty, weight=tw), tlosses.sup_loss(tx, weight=tw),
           tlosses.recon_loss(tx, ty), tlosses.sup_loss(tx)]
    for a, b in zip(got, want):
        np.testing.assert_allclose(a.numpy(), np.asarray(b), rtol=1e-6)
    # the weighted loss is the unweighted one of the kept rows; bucket axes stay
    keep = torch.tensor([0, 1, 3])
    np.testing.assert_allclose(got[0].numpy(),
                               tlosses.recon_loss(tx[keep], ty[keep]).numpy(), rtol=1e-6)
    stacked = tlosses.recon_loss(tx.expand(3, -1, -1, -1), ty.expand(3, -1, -1, -1),
                                 weight=tw.expand(3, -1))
    assert stacked.shape == (3,) and torch.allclose(stacked, got[0].expand(3))
    # without a weight, the formula of the stacked trainer, bit for bit
    assert torch.equal(got[2], 10.0 * torch.sqrt(((tx - ty) ** 2).mean() + 1e-8))


@pytest.mark.parametrize("fn", ["encode", "reconstruct", "refine_latent"])
def test_dropout_masks_match_jax(fn):
    """Three layers (two boundaries a stack): the batch-first masks land on
    the right rows, steps and units, and reconstruct splits them between
    the embedder and the recovery as JAX splits its key."""
    params, X = _setup(layers=3)
    x = X[:B] if fn != "refine_latent" else X[:B, :, :1].repeat(8, -1)
    key = jax.random.key(11)
    with jax.enable_x64(False):
        want = getattr(jmodels, fn)(params, jnp.asarray(x), dropout=RATE, key=key,
                                    train=True)
        if fn == "reconstruct":
            ke, kr = jax.random.split(key)
            masks = (_jax_masks(ke, 2, (B, T, 8)) + _jax_masks(kr, 2, (B, T, 12)))
        else:
            masks = _jax_masks(key, 2, (B, T, 8 if fn == "encode" else 12))
    got = getattr(tmodels, fn)(_stacked(params), torch.from_numpy(x)[None], RATE, masks)
    np.testing.assert_allclose(got[0].numpy(), np.asarray(want), rtol=1e-5, atol=1e-6)
    with pytest.raises(ValueError, match="masks"):
        tmodels.encode(_stacked(params), torch.from_numpy(x)[None], RATE, masks[:1])


# ---------------------------------------------------------------------------
# the AE and SUP epochs
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("which", ["ae", "sup"])
@pytest.mark.parametrize("layers", [1, 2])
def test_epoch_matches_jax(which, layers):
    params, X = _setup(layers)
    hp = jtrain.TimeGANHParams(batch_size=B, layers=layers, dropout=RATE)
    live = layers > 1
    sub_of = ((lambda p: {"embedder": p["embedder"], "recovery": p["recovery"]})
              if which == "ae" else (lambda p: p["supervisor"]))
    key = jax.random.key(5)
    with jax.enable_x64(False):
        opt = jtrain._make_opt(hp.lr_g, hp.grad_clip, hp.beta1, hp.beta2)
        make = jtrain.make_ae_epoch if which == "ae" else jtrain.make_sup_epoch
        new_p, new_s, loss = make(hp, opt)(params, opt.init(sub_of(params)),
                                           jnp.asarray(X), key)
        # the epoch's own draws (train/timegan.py:214-221, 253-270)
        k_perm, k_do = jax.random.split(key) if live else (key, None)
        idx, w = jtrain._padded_batches(k_perm, N, B)
        masks = None
        if live:
            masks = []
            for dk in jax.random.split(k_do, idx.shape[0]):
                k1, k2 = jax.random.split(dk)
                t2 = T if which == "ae" else T - 1   # the recovery's or the supervisor's
                masks.append(_jax_masks(k1, 1, (B, T, 8))
                             + _jax_masks(k2, 1, (B, t2, 12)))
    assert idx.shape == (3, B) and float(w[-1].sum()) == 2.0

    tp = _stacked(params)
    t_opt = topt.Optimizer(hp.lr_g, hp.grad_clip, hp.beta1, hp.beta2)
    epoch = ttrain.ae_epoch if which == "ae" else ttrain.sup_epoch
    got_p, got_s, got_loss = epoch(
        tp, t_opt, t_opt.init(sub_of(tp)), torch.from_numpy(X)[None],
        torch.from_numpy(np.array(idx)).long()[:, None],
        torch.from_numpy(np.array(w))[:, None], RATE if live else 0.0, masks)
    np.testing.assert_allclose(got_loss.numpy(), [float(loss)], rtol=LOSS_TOL,
                               atol=LOSS_TOL)
    assert got_s.count == 3 and int(new_s[1][0].count) == 3
    _close(sub_of(got_p), sub_of(new_p), rtol=0, atol=PARAM_ATOL)


def test_padded_batches_cover_every_row_once():
    g = torch.Generator().manual_seed(0)
    idx, w = ttrain.padded_batches(g, N, B, device="cpu")
    assert idx.shape == w.shape == (3, B)
    assert sorted(idx.flatten()[w.flatten() > 0].tolist()) == list(range(N))
    assert idx[-1, 2:].tolist() == [0, 0] and w[-1].tolist() == [1, 1, 0, 0]


# ---------------------------------------------------------------------------
# one GAN step, the batch draws
# ---------------------------------------------------------------------------

def _jax_gan_draws(key, n, live):
    """``one_step``'s draws at nb 1 (train/timegan.py:348-364): the batch
    without replacement, the noise, and the dropout masks of ``dks``."""
    key, k_idx, k_z1, k_nr, k_nf, k_lbl, k_z2, k_ng = jax.random.split(key, 8)
    kr, kf = jax.random.split(k_lbl)
    shape = (B, T, 8)

    def t(a):
        return torch.from_numpy(np.array(a))[None]

    draws = ttrain.GANDraws(
        idx=t(jax.random.permutation(k_idx, n)[:B]).long(),
        z=t(jax.random.uniform(k_z1, shape, jnp.float32)),
        eps_real=t(jax.random.normal(k_nr, shape, jnp.float32)),
        eps_fake=t(jax.random.normal(k_nf, shape, jnp.float32)),
        u_real=t(jax.random.uniform(kr, (B, 1), jnp.float32)),
        u_fake=t(jax.random.uniform(kf, (B, 1), jnp.float32)),
        z2=t(jax.random.uniform(k_z2, shape, jnp.float32)),
        eps_g=t(jax.random.normal(k_ng, shape, jnp.float32)))
    if live:
        _, k_do = jax.random.split(key)
        dks = jax.random.split(k_do, 12)
        h = (B, T, 12)
        ke, kr_ = jax.random.split(dks[9])
        draws.masks = {
            "d_encode": _jax_masks(dks[0], 1, shape), "d_gen": _jax_masks(dks[1], 1, h),
            "d_refine": _jax_masks(dks[2], 1, h), "d_real": _jax_masks(dks[3], 1, h),
            "d_fake": _jax_masks(dks[4], 1, h), "g_gen": _jax_masks(dks[6], 1, h),
            "g_refine": _jax_masks(dks[7], 1, h), "g_disc": _jax_masks(dks[8], 1, h),
            "g_reconstruct": _jax_masks(ke, 1, shape) + _jax_masks(kr_, 1, h),
            "g_decode": _jax_masks(dks[10], 1, h)}
        assert list(draws.masks) == list(ttrain.MASK_SITES)
    return draws


@pytest.mark.parametrize("layers,weights", [(1, None), (2, None),
                                            (1, (2.0, 0.3, 0.0, 0.05))])
def test_gan_step_matches_jax(layers, weights):
    """One sequential GAN step: the 8 logged values, Adam's first moments,
    every updated parameter with ``u``, and the best tracking. Layers 2 take
    live dropout (JAX's composed route, its masks); the weighted step's
    gamma_cov weight is 0 and its cov term is still computed and logged."""
    params, X = _setup(layers, seed=1)
    hp = dict(batch_size=B, gan_steps=10, acf_max_lag=5, layers=layers,
              dropout=RATE, gamma_cov=0.0)
    jhp = jtrain.TimeGANHParams(**hp)
    step, key = 4, jax.random.key(3)
    with jax.enable_x64(False):
        optD, optG = jtrain.make_gan_opts(jhp)
        d_state = optD.init(params["discriminator"])
        g_state = optG.init({k: params[k] for k in GEN})
        build = jtrain.make_gan_chunk(_cfg(layers), jhp, optD, optG)
        args = (params, d_state, g_state, params, jnp.float32(jnp.inf), jnp.int32(0),
                key, jnp.int32(step - 1), jnp.arange(1, 2, dtype=jnp.int32),
                jnp.asarray(X))
        if weights is None:
            out = build(B)(*args)
        else:
            out = build(B, with_weights=True)(*args, 0, jnp.asarray(weights, jnp.float32))
        (new_p, new_d, new_g, best_p, _, best_s, _), logs = out
        draws = _jax_gan_draws(key, N, layers > 1)

    tp = _stacked(params)
    thp = ttrain.TimeGANHParams(**hp)
    tD, tG = topt.make_gan_opts(thp)
    tw = None if weights is None else torch.tensor([weights])
    got_p, got_d, got_g, got_logs = ttrain.gan_step(
        tp, tD, tD.init(tp["discriminator"]), tG, tG.init({k: tp[k] for k in GEN}),
        ttrain.gather_batch(torch.from_numpy(X)[None], draws.idx), draws, step, thp,
        weights=tw)
    want_logs = np.asarray(logs)
    np.testing.assert_allclose(got_logs.numpy(), want_logs, rtol=LOSS_TOL, atol=LOSS_TOL)
    if weights is not None:
        assert want_logs[0, 6] > 0          # cov computed though its weight is 0
    _close(got_d.mu, new_d[1][0].mu, rtol=1e-3, atol=1e-6)
    _close(got_g.mu, new_g[1][0].mu, rtol=1e-3, atol=1e-6)
    _close(got_p, new_p, rtol=0, atol=PARAM_ATOL)
    best = ttrain.BestTracker.start(tp)
    best.update(got_p, got_logs, step)
    assert int(best_s) == step and best.step.tolist() == [step]
    _close(best.params, best_p, rtol=0, atol=PARAM_ATOL)


def test_epoch_cycle_matches_jax():
    """The epoch-cycled batches on the same permutations: a fresh one at
    each epoch's start, consecutive slices, the short tail dropped."""
    n, steps = 10, 7
    keys = jax.random.split(jax.random.key(2), steps)
    with jax.enable_x64(False):
        perm, cursor, want = jnp.zeros(n, jnp.int32), jnp.int32(0), []
        for k in keys:
            idx, perm, cursor = jtrain._epoch_cycle_next(perm, cursor, k, B)
            want.append(np.array(idx))
    perms = iter(np.array(jax.random.permutation(k, n)) for k in keys)
    got, t_perm, t_cursor = [], None, 0
    for _ in range(steps):
        fresh = next(perms)
        idx, t_perm, t_cursor = ttrain.epoch_cycle_next(
            t_perm, t_cursor, B, lambda: torch.from_numpy(fresh))
        got.append(idx.numpy())
    np.testing.assert_array_equal(np.stack(got), np.stack(want))


def test_draw_perm_idx_draws_without_replacement():
    gens = [torch.Generator().manual_seed(s) for s in range(3)]
    idx = ttrain.draw_perm_idx(gens, 6, 6, device="cpu")
    assert idx.shape == (3, 6)
    assert all(sorted(row) == list(range(6)) for row in idx.tolist())


# ---------------------------------------------------------------------------
# checkpoints across the packages
# ---------------------------------------------------------------------------

def _write_bucket(path, n=N, seed=0):
    X = np.random.default_rng(seed).uniform(0, 1, (n, 16, C)).astype(np.float32)
    np.savez(path, X=X, fs=np.float32(128.0))


def test_jax_checkpoint_resumes_in_port(tmp_path):
    """A JAX-written ckpt_latest.npz (timegan_init and make_gan_opts trees,
    count 7 and moved moments) restores exactly, with the learning rate of
    count 7, and train_single_npz resumes from it to step 9."""
    jhp = jtrain.TimeGANHParams(gan_steps=10)
    cfg = TimeGANConfig(x_dim=C, z_dim=16, h_dim=32)   # adaptive_dims(5, 16)
    with jax.enable_x64(False):
        params = timegan_init(jax.random.key(0), cfg)
        optD, optG = jtrain.make_gan_opts(jhp)

        def moved(state):
            clip, (adam, sched) = state
            mu = jax.tree.map(lambda a: a + 0.01, adam.mu)
            return (clip, (adam._replace(count=jnp.int32(7), mu=mu),
                           sched._replace(count=jnp.int32(7))))

        g_state = moved(optG.init({k: params[k] for k in GEN}))
        d_state = moved(optD.init(params["discriminator"]))
    run = tmp_path / "run"
    run.mkdir()
    jck.save_checkpoint(run / "ckpt_latest.npz",
                        {"model": params, "optG": g_state, "optD": d_state},
                        {"npz": "posture1_no_exo.npz", "step": 7})
    trees, _ = load_checkpoint(run / "ckpt_latest.npz")
    tparams = _stacked(params)
    tD, tG = topt.make_gan_opts(ttrain.TimeGANHParams(gan_steps=10))
    got = tG.restore(trees["optG"], tG.init({k: tparams[k] for k in GEN}))
    assert got.count == 7 and tG.lr(got.count) == pytest.approx(1e-3 * 0.25)
    _close(got.mu, g_state[1][0].mu, rtol=0, atol=0)
    _close(tD.restore(trees["optD"], tD.init(tparams["discriminator"])).nu,
           d_state[1][0].nu, rtol=0, atol=0)

    _write_bucket(tmp_path / "posture1_no_exo.npz")
    res = ttrain.train_single_npz(tmp_path / "posture1_no_exo.npz", run, device="cpu",
                                  resume=True, gan_steps=9, batch_size=4,
                                  acf_max_lag=4)
    rows = (run / "train_log.csv").read_text().splitlines()
    assert [r.split(",")[0] for r in rows] == ["8", "9"]
    trees, meta = load_checkpoint(run / "ckpt_latest.npz")
    assert meta["step"] == 9 and int(trees["optG"][1][0]["count"]) == 9
    assert 8 <= res["best_step"] <= 9


def test_port_checkpoint_loads_in_jax(tmp_path):
    """The sequential trainer's checkpoints load into the JAX package's
    templates with strict=True, count and all."""
    _write_bucket(tmp_path / "posture1_no_exo.npz")
    ttrain.train_single_npz(tmp_path / "posture1_no_exo.npz", tmp_path / "run",
                            device="cpu", ae_epochs=1, sup_epochs=1, gan_steps=2,
                            batch_size=4, acf_max_lag=4)
    jhp = jtrain.TimeGANHParams(gan_steps=2)
    with jax.enable_x64(False):
        template = timegan_init(jax.random.key(0), TimeGANConfig(x_dim=C, z_dim=16,
                                                                  h_dim=32))
        optD, optG = jtrain.make_gan_opts(jhp)
        templates = {"model": template,
                     "optG": optG.init({k: template[k] for k in GEN}),
                     "optD": optD.init(template["discriminator"])}
    for name in ("ckpt_latest.npz", "ckpt_best.npz"):
        trees, meta = jck.load_checkpoint(tmp_path / "run" / name, templates)
        for got, want in zip(jax.tree.leaves(trees), jax.tree.leaves(templates)):
            assert np.shape(got) == np.shape(want)
        assert int(trees["optG"][1][0].count) == 2 and meta["x_dim"] == C


# ---------------------------------------------------------------------------
# the trainers and the CLI
# ---------------------------------------------------------------------------

def _cli(tmp_path, out, *extra):
    cfg = tmp_path / "cfg.json"
    cfg.write_text(json.dumps({"batch_size": 4, "ae_epochs": 1, "sup_epochs": 1,
                               "acf_max_lag": 4}))
    return ttrain.main(["--config", str(cfg), "--data_dir", str(tmp_path / "data"),
                        "--out_dir", str(out), "--device", "cpu", *extra])


def _data(tmp_path):
    (tmp_path / "data").mkdir()
    _write_bucket(tmp_path / "data" / "posture1_no_exo.npz", n=6, seed=0)
    _write_bucket(tmp_path / "data" / "posture2_with_exo.npz", n=5, seed=1)


def test_train_single_npz_artifacts_and_resume(tmp_path):
    """The CLI without --parallel_buckets: the JAX header and one row a GAN
    step, every artifact; --resume appends to step 5 with the optimizer's
    count carried; a second run of the same seed writes the same log; layers
    2 with dropout trains."""
    _data(tmp_path)
    res = _cli(tmp_path, tmp_path / "a", "--gan_steps", "3", "--chunk", "2")
    assert set(res) == {"posture1_no_exo", "posture2_with_exo"}
    run = tmp_path / "a" / "posture1_no_exo"
    first = (run / "train_log.csv").read_text()
    lines = first.splitlines()
    assert lines[0] == ("step,phase,loss_D,acc_D,loss_G,loss_adv,loss_sup,"
                        "loss_rec,loss_cov,loss_acf")
    assert [ln.split(",")[0] for ln in lines[1:]] == ["1", "2", "3"]
    assert all(np.isfinite(float(v)) for ln in lines[1:] for v in ln.split(",")[2:])
    with np.load(run / "synthetic.npz") as s:
        assert s["X"].shape == (6, 16, C) and np.isfinite(s["X"]).all()
    _, meta = load_checkpoint(run / "ckpt_best.npz")
    assert meta["best"] and 1 <= meta["step"] <= 3 and "best_loss" in meta
    _cli(tmp_path, tmp_path / "b", "--gan_steps", "3", "--chunk", "2")
    assert (tmp_path / "b" / "posture1_no_exo" / "train_log.csv").read_text() == first

    _cli(tmp_path, tmp_path / "a", "--gan_steps", "5", "--chunk", "2", "--resume")
    lines = (run / "train_log.csv").read_text().splitlines()
    assert lines[:4] == first.splitlines()
    assert [ln.split(",")[0] for ln in lines[1:]] == ["1", "2", "3", "4", "5"]
    trees, meta = load_checkpoint(run / "ckpt_latest.npz")
    assert meta["step"] == 5 and int(trees["optD"][1][0]["count"]) == 5

    _cli(tmp_path, tmp_path / "c", "--gan_steps", "2", "--layers", "2",
         "--dropout", "0.2", "--epoch_cycle")
    trees, meta = load_checkpoint(tmp_path / "c" / "posture1_no_exo" / "ckpt_latest.npz")
    assert meta["layers"] == 2 and len(trees["model"]["generator"]["gru"]) == 2


def test_stacked_resume_is_bit_identical(tmp_path):
    """The stacked trainer at layers 2 with dropout and per-bucket weights:
    a run resumed from _multi_state.npz at step 2 writes the logs and
    synthetic windows of the uninterrupted run, bit for bit."""
    _data(tmp_path)
    args = ("--parallel_buckets", "--gan_steps", "4", "--layers", "2",
            "--bucket_weights", '{"posture1_no_exo": {"gamma_acf": 0.5}}',
            "--ckpt_every", "2")
    _cli(tmp_path, tmp_path / "full", *args)
    (tmp_path / "resumed").mkdir()
    shutil.copy(tmp_path / "full" / "_multi_state.npz", tmp_path / "resumed")
    _cli(tmp_path, tmp_path / "resumed", *args, "--resume")
    for name in ("posture1_no_exo", "posture2_with_exo"):
        a, b = tmp_path / "full" / name, tmp_path / "resumed" / name
        assert (a / "train_log.csv").read_text() == (b / "train_log.csv").read_text()
        with np.load(a / "synthetic.npz") as x, np.load(b / "synthetic.npz") as y:
            np.testing.assert_array_equal(x["X"], y["X"])
    with pytest.raises(ValueError, match="does not match"):
        _cli(tmp_path, tmp_path / "resumed", *args, "--seed", "7", "--resume")


@pytest.mark.parametrize("weights,match", [({"posture9_no_exo": {}}, "unknown"),
                                           ({"posture1_no_exo": {"lr_g": 1}},
                                            "unsweepable")])
def test_bucket_weights_are_validated(tmp_path, weights, match):
    _data(tmp_path)
    with pytest.raises(ValueError, match=match):
        _cli(tmp_path, tmp_path / "o", "--parallel_buckets", "--gan_steps", "1",
             "--bucket_weights", json.dumps(weights))


@pytest.mark.parametrize("flags", [["--mesh"], ["--multihost"],
                                   ["--ckpt_format", "orbax"], ["--async_ckpt"],
                                   ["--dispatch_budget", "10"], ["--max_stack", "2"],
                                   ["--profile_dir", "prof"],
                                   ["--bucket_weights", "{}"], ["--ckpt_every", "2"]])
def test_cli_refuses_flags_without_counterpart(tmp_path, flags):
    _data(tmp_path)
    with pytest.raises(SystemExit):
        _cli(tmp_path, tmp_path / "o", "--gan_steps", "1", *flags)
    assert not (tmp_path / "o" / "posture1_no_exo").exists()


def test_orbax_checkpoints_are_refused(tmp_path):
    _write_bucket(tmp_path / "posture1_no_exo.npz")
    with pytest.raises(ValueError, match="NPZ"):
        ttrain.train_single_npz(tmp_path / "posture1_no_exo.npz", tmp_path / "r",
                                device="cpu", ckpt_format="orbax")
