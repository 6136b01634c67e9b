"""The TimeGAN weight sweep of eegsynth_torch against the JAX package's, on
the CPU at tiny widths (x5/z16/h32 windows of 12 steps, B 4).

- ``timegan_weight_matrix`` against JAX's (numpy code: exact), errors too;
- one stacked GAN step with a per-member (nb, 4) weight matrix against
  JAX's ``make_gan_chunk(..., vmapped=True, with_weights=True)`` at chunk 1
  on the same parameters and JAX's own draws, with
  ``test_torch_train.py``'s tolerances (the file's one JAX compile);
- a grid of two equal points: every parameter, log row and synthetic window
  of the two points equal bit for bit after the AE, SUP and 2 GAN steps;
- two unequal points: step 1's D columns (loss, accuracy) and D parameters
  equal bit for bit across the points, the G columns and the generator's
  parameters differ;
- the CLI: the artifacts, ``sweep_results.json`` with the port's statistics,
  the config's non-hparam keys named and dropped, every checkpoint read by
  the JAX package's loader into its own templates (strict).

JAX runs with x64 off: float32 on both sides.
"""

import json

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from test_torch_threads import one_thread_each  # noqa: F401
from test_torch_train import (
    CFG, GEN, GRAD_ATOL, GRAD_RTOL, LOSS_TOL, NB, PARAM_ATOL, B, T, _close,
    _jax_draws, _setup, _torch,
)

from eegsynth.models.timegan import TimeGANConfig, timegan_init
from eegsynth.train import checkpoint as jck
from eegsynth.train import timegan as jtrain
from eegsynth.train.timegan_sweep import timegan_weight_matrix as jax_weight_matrix
from eegsynth_torch.eval.stats import statistical_similarity
from eegsynth_torch.models.timegan import TimeGANConfig as TCfg
from eegsynth_torch.train import optim as topt
from eegsynth_torch.train import timegan as ttrain
from eegsynth_torch.train import timegan_sweep as tsweep
from eegsynth_torch.train.timegan_multi import run_stack
from eegsynth_torch.tree import take, tree_leaves

N, C = 6, 5
TINY = dict(batch_size=B, ae_epochs=1, sup_epochs=1, gan_steps=2, acf_max_lag=4)
JAX_COMPILE = {"xla_backend_optimization_level": 0,
               "xla_llvm_disable_expensive_passes": True}


def _bucket(path, seed=0):
    rng = np.random.default_rng(seed)
    np.savez(path, X=rng.uniform(0, 1, (N, T, C)).astype(np.float32),
             fs=np.float32(128.0))
    return path


@pytest.mark.parametrize("grid", [[{}], [{"gamma_acf": 0.1}, {"alpha_sup": 1.0,
                                                              "beta_rec": 0.0}]])
def test_weight_matrix_matches_jax(grid):
    hp = dict(gamma_cov=0.07)
    got = tsweep.timegan_weight_matrix(ttrain.TimeGANHParams(**hp), grid)
    want = jax_weight_matrix(jtrain.TimeGANHParams(**hp), grid)
    assert got.dtype == np.float32 and got.shape == (len(grid), 4)
    np.testing.assert_array_equal(got, want)


def test_weight_matrix_refuses_unknown_names():
    grid = [{"gamma_acf": 0.1}, {"lr_g": 1.0}]
    with pytest.raises(ValueError, match="unsweepable"):
        jax_weight_matrix(jtrain.TimeGANHParams(), grid)
    with pytest.raises(ValueError, match=r"unsweepable weights \['lr_g'\]"):
        tsweep.timegan_weight_matrix(ttrain.TimeGANHParams(), grid)


def test_stacked_weighted_gan_step_matches_jax():
    """Two members, each with its own weights (member 1's gamma_cov is 0:
    its cov term is still computed and logged, as JAX's traced weights
    keep it)."""
    params, X = _setup(seed=2)
    W = np.array([[3.0, 0.15, 0.03, 0.02], [1.0, 0.5, 0.0, 0.3]], np.float32)
    hp = dict(batch_size=B, gan_steps=10, acf_max_lag=5, fused_step=True)
    jhp = jtrain.TimeGANHParams(**hp)
    step = 3
    n_valid = np.array([6, 4], np.float32)
    with jax.enable_x64(False):
        optD, optG = jtrain.make_gan_opts(jhp)
        d_state = jax.vmap(lambda p: optD.init(p["discriminator"]))(params)
        g_state = jax.vmap(lambda p: optG.init({k: p[k] for k in GEN}))(params)
        chunk = jtrain.make_gan_chunk(CFG, jhp, optD, optG)(
            B, with_valid_n=True, vmapped=True, with_weights=True)
        keys = jax.vmap(lambda i: jax.random.fold_in(jax.random.key(4), i))(
            jnp.arange(NB))
        args = (params, d_state, g_state, params, jnp.full((NB,), jnp.inf, jnp.float32),
                jnp.zeros((NB,), jnp.int32), keys, jnp.int32(step - 1),
                jnp.arange(1, 2, dtype=jnp.int32), jnp.asarray(X),
                jnp.asarray(n_valid), jnp.asarray(W))
        (new_p, new_d, new_g, *_), logs = chunk.lower(*args).compile(
            compiler_options=JAX_COMPILE)(*args)
        draws = _jax_draws(keys, jnp.asarray(n_valid), T, CFG.z_dim)

    tp = _torch(params)
    thp = ttrain.TimeGANHParams(**hp)
    tD, tG = topt.make_gan_opts(thp)
    td = ttrain.GANDraws(**{k: torch.from_numpy(np.array(v)) for k, v in draws.items()})
    td.idx = td.idx.long()
    got_p, got_d, got_g, got_logs = ttrain.gan_step(
        tp, tD, tD.init(tp["discriminator"]), tG, tG.init({k: tp[k] for k in GEN}),
        ttrain.gather_batch(torch.from_numpy(X), td.idx), td, step, thp,
        weights=torch.from_numpy(W))
    want_logs = np.asarray(logs)[:, 0]
    assert want_logs[1, 6] > 0                    # cov logged at weight 0
    np.testing.assert_allclose(got_logs.numpy(), want_logs, rtol=LOSS_TOL, atol=LOSS_TOL)
    _close(got_d.mu, new_d[1][0].mu, rtol=GRAD_RTOL, atol=GRAD_ATOL)
    _close(got_g.mu, new_g[1][0].mu, rtol=GRAD_RTOL, atol=GRAD_ATOL)
    _close(got_p, new_p, rtol=0, atol=PARAM_ATOL)


def _leaves_equal(a, b):
    return all(torch.equal(x, y) for x, y in zip(tree_leaves(a), tree_leaves(b)))


def test_equal_weight_points_are_bitwise_equal(tmp_path):
    res = tsweep.sweep_bucket(_bucket(tmp_path / "posture1_no_exo.npz"),
                              tmp_path / "out", [{}, {}], device="cpu", **TINY)
    assert [r["dir"] for r in res] == [str(tmp_path / "out" / f"sweep{i}")
                                       for i in range(2)]
    assert res[0]["final_g"] == res[1]["final_g"]
    assert res[0]["best_step"] == res[1]["best_step"]
    for name in ("ckpt_latest.npz", "ckpt_best.npz", "synthetic.npz"):
        with np.load(tmp_path / "out" / "sweep0" / name) as a, \
                np.load(tmp_path / "out" / "sweep1" / name) as b:
            assert a.files == b.files
            for k in a.files:
                np.testing.assert_array_equal(a[k], b[k])


def test_unequal_weights_share_the_d_step():
    """Step 1 of two points that differ only in their G weights: the D step
    precedes the G update, so its log columns and the D parameters agree
    bit for bit; the G step's columns and the generator differ."""
    rng = np.random.default_rng(3)
    X = torch.from_numpy(rng.uniform(0, 1, (1, N, T, C)).astype(np.float32))
    hp = ttrain.TimeGANHParams(**{**TINY, "gan_steps": 1})
    cfg = TCfg(x_dim=C, z_dim=16, h_dim=32)
    W = torch.tensor([[3.0, 0.15, 0.03, 0.02], [1.0, 0.5, 0.3, 0.3]])
    run = run_stack(X.expand(2, N, T, C), torch.full((2,), float(N)), hp, cfg,
                    init_gens=tsweep.shared_generators(hp.seed, 2, ttrain._INIT, "cpu"),
                    streams=lambda s: tsweep.shared_generators(hp.seed, 2, s, "cpu"),
                    device=torch.device("cpu"), weights=W, log=lambda m: None)
    logs = run["logs"][0]
    assert torch.equal(logs[0, :2], logs[1, :2])
    assert (logs[0, 2:] != logs[1, 2:]).any()
    p = run["params"]
    assert _leaves_equal(*(take(p["discriminator"], i) for i in range(2)))
    assert not _leaves_equal(*(take(p["generator"], i) for i in range(2)))


def test_sweep_cli_writes_jax_readable_points(tmp_path, capsys):
    npz = _bucket(tmp_path / "posture2_with_exo.npz", seed=1)
    cfg = tmp_path / "cfg.json"
    cfg.write_text(json.dumps({**TINY, "data_dir": "x", "parallel_buckets": True,
                               "gamma_cov": 0.05}))
    grid = [{}, {"gamma_acf": 0.5}]
    results = tsweep.main(["--npz", str(npz), "--out", str(tmp_path / "out"),
                           "--grid", json.dumps(grid), "--config", str(cfg),
                           "--gan_steps", "3", "--device", "cpu"])
    assert "ignoring non-hparam config keys: ['data_dir', 'parallel_buckets']" \
        in capsys.readouterr().out
    saved = json.loads((tmp_path / "out" / "sweep_results.json").read_text())
    assert saved == json.loads(json.dumps(results)) and len(saved) == 2
    with np.load(npz) as z:
        real = z["X"]
    with jax.enable_x64(False):
        template = timegan_init(jax.random.key(0), TimeGANConfig(x_dim=C, z_dim=16,
                                                                  h_dim=32))
    for i, res in enumerate(saved):
        d = tmp_path / "out" / f"sweep{i}"
        hp = json.loads((d / "hparams.json").read_text())
        assert hp == {**res["weights"], "sweep_overrides": grid[i], "gan_steps": 3,
                      "seed": 42}
        assert res["weights"]["gamma_cov"] == pytest.approx(0.05)
        assert res["weights"]["gamma_acf"] == pytest.approx(0.5 if i else 0.02)
        with np.load(d / "synthetic.npz") as z:
            fake = z["X"]
        assert fake.shape == (N, T, C)
        psd, acf, coh = statistical_similarity(real, fake, 128.0, device="cpu")
        assert res["stats"] == {"psd_diff": psd, "acf_diff": acf, "coh_diff": coh}
        _, meta = jck.load_checkpoint(d / "ckpt_latest.npz", {"model": template})
        assert meta == {"z_dim": 16, "h_dim": 32, "x_dim": C, "layers": 1,
                        "fs": 128.0, "npz": npz.name, "step": 3}
        trees, meta = jck.load_checkpoint(d / "ckpt_best.npz", {"model": template})
        assert meta["best"] and meta["step"] == res["best_step"]
        assert set(meta) == {"z_dim", "h_dim", "x_dim", "layers", "fs", "npz", "best",
                             "step", "best_loss"}
        for got, want in zip(jax.tree.leaves(trees), jax.tree.leaves(template)):
            assert np.shape(got) == np.shape(want)
