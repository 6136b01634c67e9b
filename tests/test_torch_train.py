"""eegsynth_torch's stacked multi-bucket trainer against the JAX package's
vmapped one, one step at a time on the same parameters, batch and noise:
a pre-phase step (AE and SUP, ``_make_pre_phase``) and a GAN step
(``make_gan_chunk(..., with_valid_n=True, vmapped=True)`` at chunk 1, with
the Pallas multi-GRU kernel in interpret mode for the D-step inputs). The
randomness comes from JAX's own key splits and is handed to the port.
Then a tiny ``train_all_buckets`` run that writes every artifact.

The JAX side runs with x64 off (conftest turns it on): float32 on both sides.
"""

import json

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from eegsynth.models.timegan import TimeGANConfig, timegan_init
from eegsynth.train import timegan as jtrain
from eegsynth.train.timegan_multi import _make_pre_phase
from eegsynth_torch.train import optim as topt
from eegsynth_torch.train import timegan as ttrain
from eegsynth_torch.train.timegan_multi import main as train_main
from eegsynth_torch.tree import tree_leaves, tree_map

NB, B, T = 2, 4, 12
N_VALID = np.array([6, 4], np.int32)
CFG = TimeGANConfig(x_dim=5, z_dim=8, h_dim=12)
GEN = ("generator", "supervisor", "embedder", "recovery")

# Tolerances, float32 on both sides. Values agree to about 1e-6; R1 is the
# direct penalty here and the forward-over-reverse surrogate in JAX (same
# value and gradient, another summation order). The parameters move by
# about lr = 1e-3 in Adam's first step, whose update g/(|g| + eps) magnifies
# the relative error of a gradient near zero, hence the looser bound on them.
LOSS_TOL = 2e-5
GRAD_RTOL, GRAD_ATOL = 1e-3, 1e-6
PARAM_ATOL = 2e-5


def _setup(seed=0):
    with jax.enable_x64(False):
        keys = jax.vmap(lambda i: jax.random.fold_in(jax.random.key(seed), i))(
            jnp.arange(NB))
        params = jax.vmap(timegan_init, in_axes=(0, None))(keys, CFG)
    rng = np.random.default_rng(seed)
    X = rng.uniform(0, 1, (NB, int(N_VALID.max()), T, CFG.x_dim)).astype(np.float32)
    for b, n in enumerate(N_VALID):
        X[b, n:] = 0.0
    return params, X


def _torch(tree):
    return tree_map(lambda a: torch.from_numpy(np.array(a, np.float32)), tree)


def _close(got, want, **tol):
    for a, b in zip(tree_leaves(got), jax.tree.leaves(want)):
        np.testing.assert_allclose(a.detach().numpy(), np.asarray(b), **tol)


@pytest.mark.parametrize("which", ["ae", "sup"])
def test_pre_phase_step_matches_jax(which):
    params, X = _setup()
    hp = jtrain.TimeGANHParams(batch_size=B)
    sub_of = ((lambda p: {"embedder": p["embedder"], "recovery": p["recovery"]})
              if which == "ae" else (lambda p: p["supervisor"]))
    with jax.enable_x64(False):
        opt = jtrain._make_opt(hp.lr_g, hp.grad_clip, hp.beta1, hp.beta2)
        state = jax.vmap(lambda p: opt.init(sub_of(p)))(params)
        keys = jax.vmap(lambda i: jax.random.fold_in(jax.random.key(7), i))(
            jnp.arange(NB))
        phase = _make_pre_phase(hp, opt, which)
        new_p, new_s, _, losses = phase(params, state, keys, jnp.asarray(X),
                                        jnp.asarray(N_VALID), 1)
        # the step's own batch draw (timegan_multi.py:64-66)
        k_idx = jax.vmap(lambda k: jax.random.split(k)[1])(keys)
        idx = jax.vmap(lambda k, n: jnp.floor(jax.random.uniform(k, (B,)) * n)
                       .astype(jnp.int32))(k_idx, jnp.asarray(N_VALID))

    tp = _torch(params)
    topt_ = topt.Optimizer(hp.lr_g, hp.grad_clip, hp.beta1, hp.beta2)
    tstate = topt_.init(sub_of(tp))
    x = ttrain.gather_batch(torch.from_numpy(X), torch.from_numpy(np.array(idx)).long())
    got_p, got_s, loss = ttrain.pre_phase_step(tp, topt_, tstate, x, which)

    np.testing.assert_allclose(loss.numpy(), np.asarray(losses)[:, 0],
                               rtol=LOSS_TOL, atol=LOSS_TOL)
    # Adam's first moment after one step is (1 - b1) · the clipped gradient
    _close(got_s.mu, new_s[1][0].mu, rtol=GRAD_RTOL, atol=GRAD_ATOL)
    assert got_s.count == 1 and np.all(np.asarray(new_s[1][0].count) == 1)
    _close(sub_of(got_p), sub_of(new_p), rtol=0, atol=PARAM_ATOL)
    # the networks the phase does not train stay bit-identical
    trained = ("embedder", "recovery") if which == "ae" else ("supervisor",)
    for k in (k for k in tp if k not in trained):
        for a, b in zip(tree_leaves(got_p[k]), tree_leaves(tp[k])):
            assert torch.equal(a, b)


def _jax_draws(keys, n_valid, T, z):
    """The draws of ``one_step`` (train/timegan.py:348-396), per bucket."""
    def one(key, nv):
        _, k_idx, k_z1, k_nr, k_nf, k_lbl, k_z2, k_ng = jax.random.split(key, 8)
        kr, kf = jax.random.split(k_lbl)
        shape = (B, T, z)
        return dict(
            idx=jnp.floor(jax.random.uniform(k_idx, (B,)) * nv).astype(jnp.int32),
            z=jax.random.uniform(k_z1, shape, jnp.float32),
            eps_real=jax.random.normal(k_nr, shape, jnp.float32),
            eps_fake=jax.random.normal(k_nf, shape, jnp.float32),
            u_real=jax.random.uniform(kr, (B, 1), jnp.float32),
            u_fake=jax.random.uniform(kf, (B, 1), jnp.float32),
            z2=jax.random.uniform(k_z2, shape, jnp.float32),
            eps_g=jax.random.normal(k_ng, shape, jnp.float32))
    return jax.vmap(one)(keys, n_valid)


@pytest.mark.parametrize("step,grad_clip,pallas", [(4, 0.01, True),
                                                  (9, 100.0, False)])
def test_gan_step_matches_jax(step, grad_clip, pallas):
    """One stacked GAN step: the 8 logged values, the clipped gradients (Adam's
    first moments), every updated parameter, ``u``, and the best tracking.
    grad_clip 0.01 fires the clip, 100 leaves it idle; the steps differ in
    their instance-noise std. The JAX D-step inputs run the Pallas multi-GRU
    kernel (interpret mode) or its XLA fused scan: the same numbers."""
    params, X = _setup(seed=1)
    hp = dict(batch_size=B, gan_steps=10, grad_clip=grad_clip, acf_max_lag=5,
              fused_step=True, pallas_multigru=pallas)
    jhp = jtrain.TimeGANHParams(**hp)
    with jax.enable_x64(False):
        optD, optG = jtrain.make_gan_opts(jhp)
        d_state = jax.vmap(lambda p: optD.init(p["discriminator"]))(params)
        g_state = jax.vmap(lambda p: optG.init({k: p[k] for k in GEN}))(params)
        chunk = jtrain.make_gan_chunk(CFG, jhp, optD, optG)(
            B, with_valid_n=True, vmapped=True)
        keys = jax.vmap(lambda i: jax.random.fold_in(jax.random.key(3), i))(
            jnp.arange(NB))
        nv = jnp.asarray(N_VALID, jnp.float32)
        (new_p, new_d, new_g, best_p, best_l, best_s, _), logs = chunk(
            params, d_state, g_state, params, jnp.full((NB,), jnp.inf, jnp.float32),
            jnp.zeros((NB,), jnp.int32), keys, jnp.int32(step - 1),
            jnp.arange(1, 2, dtype=jnp.int32), jnp.asarray(X), nv)
        draws = _jax_draws(keys, nv, T, CFG.z_dim)

    tp = _torch(params)
    thp = ttrain.TimeGANHParams(**hp)
    tD, tG = topt.make_gan_opts(thp)
    d_s, g_s = tD.init(tp["discriminator"]), tG.init({k: tp[k] for k in GEN})
    td = ttrain.GANDraws(**{k: torch.from_numpy(np.array(v)) for k, v in draws.items()})
    td.idx = td.idx.long()
    x = ttrain.gather_batch(torch.from_numpy(X), td.idx)
    got_p, got_d, got_g, got_logs = ttrain.gan_step(tp, tD, d_s, tG, g_s, x, td,
                                                    step, thp)

    want_logs = np.asarray(logs)[:, 0]
    assert got_logs.shape == (NB, 8)
    np.testing.assert_allclose(got_logs.numpy(), want_logs, rtol=LOSS_TOL,
                               atol=LOSS_TOL)
    _close(got_d.mu, new_d[1][0].mu, rtol=GRAD_RTOL, atol=GRAD_ATOL)
    _close(got_g.mu, new_g[1][0].mu, rtol=GRAD_RTOL, atol=GRAD_ATOL)
    for state in (got_d, got_g):   # the clip fired (norm == clip) or did not
        norm = torch.sqrt(sum((m / (1 - thp.beta1)).pow(2).reshape(NB, -1).sum(1)
                              for m in tree_leaves(state.mu)))
        if grad_clip < 1:
            np.testing.assert_allclose(norm.numpy(), grad_clip, rtol=1e-4)
        else:
            assert (norm < grad_clip).all()
    _close(got_p, new_p, rtol=0, atol=PARAM_ATOL)
    # u (stored after the G step's discriminator forward) is among the params
    # compared above; with one output it is ±1 whatever the iteration
    # the first step is always the best, with the post-update parameters
    np.testing.assert_array_equal(np.asarray(best_s), [step, step])
    _close(got_p, best_p, rtol=0, atol=PARAM_ATOL)
    # the state trees keep optax's layout
    want_keys = [jax.tree_util.keystr(k) for k, _ in
                 jax.tree_util.tree_flatten_with_path(new_d)[0]]
    assert "[1][0].count" in want_keys and "[1][1].count" in want_keys
    tree = tD.state_tree(got_d)
    assert tree[0] is None and int(tree[1][1]["count"][0]) == 1


def test_train_all_buckets_writes_artifacts(tmp_path):
    """The CLI on three ragged buckets at tiny sizes writes the artifact set,
    and the checkpoints reload into the port."""
    from eegsynth_torch.serve import ModelRegistry
    from eegsynth_torch.train.checkpoint import load_checkpoint

    data, out = tmp_path / "data", tmp_path / "runs"
    data.mkdir()
    rng = np.random.default_rng(0)
    for name, n in (("posture1_no_exo", 5), ("posture1_with_exo", 7),
                    ("posture2_no_exo", 3)):
        np.savez(data / f"{name}.npz", X=rng.uniform(0, 1, (n, 16, 5))
                 .astype(np.float32), fs=np.float32(128.0))
    cfg = tmp_path / "cfg.json"
    cfg.write_text(json.dumps({"batch_size": 4, "ae_epochs": 2, "sup_epochs": 1,
                               "gan_steps": 3, "acf_max_lag": 4}))
    res = train_main(["--config", str(cfg), "--data_dir", str(data), "--out_dir",
                      str(out), "--device", "cpu", "--log_every", "1"])
    assert res["n_buckets"] == 3 and res["aggregate_steps_per_sec"] > 0
    for name, n in (("posture1_no_exo", 5), ("posture1_with_exo", 7),
                    ("posture2_no_exo", 3)):
        d = out / name
        lines = (d / "train_log.csv").read_text().splitlines()
        assert lines[0] == ("step,phase,loss_D,acc_D,loss_G,loss_adv,loss_sup,"
                            "loss_rec,loss_cov,loss_acf")
        assert len(lines) == 4
        assert all(np.isfinite(float(v)) for ln in lines[1:] for v in ln.split(",")[2:])
        with np.load(d / "synthetic.npz") as s:
            assert s["X"].shape == (n, 16, 5) and np.isfinite(s["X"]).all()
        trees, meta = load_checkpoint(d / "ckpt_best.npz")
        assert set(trees) == {"model", "optG", "optD"} and meta["best"]
        assert meta["z_dim"] == 16 and meta["h_dim"] == 32 and 1 <= meta["step"] <= 3
        assert int(trees["optD"][1][0]["count"]) == 3
    reg = ModelRegistry(out, None, device="cpu")
    X = reg.synthesize("posture1_with_exo", 2, 16, 0, False, 2, 16)
    assert X.shape == (2, 16, 5) and np.isfinite(X).all()


def test_instance_noise_schedule():
    hp = ttrain.TimeGANHParams(gan_steps=10)
    assert ttrain.instance_noise_std(hp, 1) == pytest.approx(0.25)
    assert ttrain.instance_noise_std(hp, 6) == pytest.approx(0.15, abs=1e-7)
    assert ttrain.instance_noise_std(hp, 100) == pytest.approx(0.05)


def test_hparams_match_jax_defaults():
    import dataclasses
    j = {f.name: f.default for f in dataclasses.fields(jtrain.TimeGANHParams)}
    t = {f.name: f.default for f in dataclasses.fields(ttrain.TimeGANHParams)}
    assert j == t


def test_load_bucket_matches_jax(tmp_path):
    """data/io.py reads a bucket NPZ as the JAX package does, full or with
    only ``X`` (the defaults)."""
    from eegsynth.data.io import Bucket as JBucket
    from eegsynth.data.io import bucket_paths as j_paths
    from eegsynth.data.io import load_bucket as j_load
    from eegsynth.data.io import save_bucket
    from eegsynth_torch.data.io import bucket_paths, load_bucket

    rng = np.random.default_rng(0)
    X = rng.uniform(0, 1, (3, 8, 2)).astype(np.float32)
    save_bucket(tmp_path / "posture2_with_exo.npz", JBucket(
        X=X, participant=np.arange(3), trial=np.ones(3), posture=2,
        condition="with_exo", fs=128.0, ch_names=["C3", "C4"],
        scale_min=np.array([-5, -6], np.float32),
        scale_range=np.array([10, 12], np.float32), epoch_len_samples=8))
    np.savez(tmp_path / "posture1_no_exo.npz", X=X[:2])
    (tmp_path / "notes.npz").write_bytes(b"")
    assert bucket_paths(tmp_path) == j_paths(tmp_path)
    assert [p.name for p in bucket_paths(tmp_path)] == ["posture1_no_exo.npz",
                                                        "posture2_with_exo.npz"]
    for path in bucket_paths(tmp_path):
        got, want = load_bucket(path), j_load(path)
        for f in ("X", "participant", "trial", "scale_min", "scale_range"):
            np.testing.assert_array_equal(getattr(got, f), getattr(want, f))
            assert getattr(got, f).dtype == getattr(want, f).dtype
        for f in ("posture", "condition", "fs", "ch_names", "epoch_len_samples"):
            assert getattr(got, f) == getattr(want, f)
