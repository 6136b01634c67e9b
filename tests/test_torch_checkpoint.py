"""eegsynth_torch NPZ checkpoints read and write the JAX package's format."""

import jax
import numpy as np
import pytest
import torch

from eegsynth.models.timegan import TimeGANConfig, timegan_init
from eegsynth.train import checkpoint as jck
from eegsynth_torch.convert import from_jax_params, to_jax_params
from eegsynth_torch.models.timegan import TimeGAN
from eegsynth_torch.models.timegan import TimeGANConfig as TorchConfig
from eegsynth_torch.train import checkpoint as tck

META = {"npz": "posture1_no_exo.npz", "z_dim": 28, "h_dim": 56, "step": 7,
        "best": True}


def _jax_params(cfg, seed=0):
    return timegan_init(jax.random.key(seed), cfg)


@pytest.mark.parametrize("cfg", [TimeGANConfig(), TimeGANConfig(x_dim=4, z_dim=16,
                                                                 h_dim=16)])
def test_jax_writes_port_reads(tmp_path, cfg):
    params = _jax_params(cfg)
    path = tmp_path / "ckpt_best.npz"
    jck.save_checkpoint(path, {"model": params}, META)
    trees, meta = tck.load_checkpoint(path)
    assert meta == META
    got = trees["model"]
    want = jax.tree.map(np.asarray, params)
    flat_got = dict(jax.tree_util.tree_flatten_with_path(got)[0])
    flat_want = dict(jax.tree_util.tree_flatten_with_path(want)[0])
    assert flat_got.keys() == flat_want.keys()
    for k in flat_want:
        np.testing.assert_array_equal(flat_got[k], flat_want[k])
    # and the loaded tree builds the port's model with those exact weights
    back = to_jax_params(from_jax_params(got, device="cpu"))
    for a, b in zip(jax.tree.leaves(back), jax.tree.leaves(want)):
        np.testing.assert_array_equal(a, b)


@pytest.mark.parametrize("h_dim", [56, 28])
def test_port_writes_jax_reads(tmp_path, h_dim):
    cfg = TorchConfig(x_dim=14, z_dim=28, h_dim=h_dim)
    model = TimeGAN(cfg, generator=torch.Generator().manual_seed(1), device="cpu")
    path = tmp_path / "ckpt_latest.npz"
    tck.save_checkpoint(path, {"model": to_jax_params(model)}, META)
    template = _jax_params(TimeGANConfig(x_dim=14, z_dim=28, h_dim=h_dim))
    trees, meta = jck.load_checkpoint(path, {"model": template})
    assert meta == META
    got = trees["model"]
    want = to_jax_params(model)
    assert jax.tree.structure(got) == jax.tree.structure(want)
    for a, b in zip(jax.tree.leaves(got), jax.tree.leaves(want)):
        np.testing.assert_array_equal(np.asarray(a), b)


def test_keys_match_jax_keystr(tmp_path):
    """Both writers store the same key set, byte for byte."""
    params = _jax_params(TimeGANConfig())
    jck.save_checkpoint(tmp_path / "j.npz", {"model": params}, META)
    tck.save_checkpoint(tmp_path / "t.npz",
                        {"model": jax.tree.map(np.asarray, params)}, META)
    with np.load(tmp_path / "j.npz") as a, np.load(tmp_path / "t.npz") as b:
        assert sorted(a.files) == sorted(b.files)
        assert len(a.files) == 29 + 1                # 29 leaves + __meta__
        assert "model['generator']['gru'][0]['w_hh']" in b.files


def test_load_meta(tmp_path):
    path = tmp_path / "ckpt_best.npz"
    jck.save_checkpoint(path, {"model": _jax_params(TimeGANConfig())}, META)
    assert tck.load_meta(path) == META == jck.load_meta(path)


def test_find_checkpoint(tmp_path):
    assert tck.find_checkpoint(tmp_path, "ckpt_best") is None
    jck.save_checkpoint(tmp_path / "ckpt_best.npz",
                        {"model": _jax_params(TimeGANConfig())}, META)
    assert tck.find_checkpoint(tmp_path, "ckpt_best") == tmp_path / "ckpt_best.npz"


def test_orbax_raises(tmp_path):
    path = tmp_path / "ckpt_best.orbax"
    path.mkdir()
    for fn in (tck.load_checkpoint, tck.load_meta):
        with pytest.raises(ValueError, match="Orbax"):
            fn(path)
    with pytest.raises(ValueError, match="Orbax"):
        tck.save_checkpoint(path, {"model": {}}, META)


def test_unparseable_key_raises(tmp_path):
    path = tmp_path / "bad.npz"
    np.savez(path, **{"model['a'][x]": np.zeros(1),
                      "__meta__": np.frombuffer(b"{}", np.uint8)})
    with pytest.raises(ValueError, match="unparseable"):
        tck.load_checkpoint(path)


def _gan_states(params, gan_steps=10):
    from eegsynth.train.timegan import TimeGANHParams, make_gan_opts
    optD, optG = make_gan_opts(TimeGANHParams(gan_steps=gan_steps))
    gser = {k: params[k] for k in ("generator", "supervisor", "embedder", "recovery")}
    return optG.init(gser), optD.init(params["discriminator"])


def test_jax_checkpoint_with_optimizer_state_serves(tmp_path):
    """A checkpoint as the JAX trainers write it, model + optG + optD (optax
    states under keys such as ``optD[1][0].count``), loads into the port with
    every tree, and ModelRegistry serves it."""
    from eegsynth_torch.serve import ModelRegistry
    params = _jax_params(TimeGANConfig(x_dim=4, z_dim=16, h_dim=32))
    optG, optD = _gan_states(params)
    run = tmp_path / "runs" / "posture3_with_exo"
    run.mkdir(parents=True)
    jck.save_checkpoint(run / "ckpt_latest.npz",
                        {"model": params, "optG": optG, "optD": optD},
                        {**META, "z_dim": 16, "h_dim": 32, "x_dim": 4})
    trees, _ = tck.load_checkpoint(run / "ckpt_latest.npz")
    assert set(trees) == {"model", "optG", "optD"}
    assert trees["optD"][0] is None                      # optax EmptyState
    adam = trees["optD"][1][0]
    assert isinstance(adam, tck.Attrs) and list(adam) == ["count", "mu", "nu"]
    np.testing.assert_array_equal(adam["count"], 0)
    np.testing.assert_array_equal(adam["mu"]["fc"]["w"], optD[1][0].mu["fc"]["w"])
    assert set(trees["optG"][1][0]["nu"]) == {"generator", "supervisor",
                                             "embedder", "recovery"}
    assert list(trees["optG"][1][1]) == ["count"]
    reg = ModelRegistry(tmp_path / "runs", None, device="cpu")
    X = reg.synthesize("posture3_with_exo", 3, 20, 0, False, 4, 8)
    assert X.shape == (3, 20, 4) and np.isfinite(X).all()


def test_port_trained_checkpoint_loads_in_jax(tmp_path):
    """A ckpt_latest.npz written by the port's trainer loads strictly into the
    JAX package's templates for model, optG and optD, and JAX synthesize runs
    on its model."""
    from eegsynth.train.timegan import synthesize as jax_synthesize
    from eegsynth_torch.train.timegan_multi import train_all_buckets
    data = tmp_path / "data"
    data.mkdir()
    rng = np.random.default_rng(0)
    for name in ("posture1_no_exo", "posture2_with_exo"):
        np.savez(data / f"{name}.npz",
                 X=rng.uniform(0, 1, (5, 12, 4)).astype(np.float32))
    train_all_buckets(data, tmp_path / "runs", device="cpu", batch_size=4,
                      ae_epochs=1, sup_epochs=1, gan_steps=2, acf_max_lag=4)
    path = tmp_path / "runs" / "posture2_with_exo" / "ckpt_latest.npz"
    meta = tck.load_meta(path)
    cfg = TimeGANConfig(x_dim=meta["x_dim"], z_dim=meta["z_dim"], h_dim=meta["h_dim"])
    template = _jax_params(cfg, seed=3)
    optG, optD = _gan_states(template)
    trees, meta = jck.load_checkpoint(
        path, {"model": template, "optG": optG, "optD": optD}, strict=True)
    assert meta["step"] == 2
    assert int(trees["optD"][1][0].count) == 2 == int(trees["optG"][1][1].count)
    ours, _ = tck.load_checkpoint(path)
    for a, b in zip(jax.tree.leaves(trees["model"]), jax.tree.leaves(ours["model"])):
        np.testing.assert_array_equal(np.asarray(a), b)
    X = jax_synthesize(trees["model"], cfg, jax.random.key(0), 3, 12)
    assert X.shape == (3, 12, 4) and np.isfinite(np.asarray(X)).all()
