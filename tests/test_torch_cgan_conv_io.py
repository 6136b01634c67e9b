"""Conv-CGAN files and entry points in eegsynth_torch against eegsynth, on
the CPU at full width (T 768): a generator written by the JAX package
loading in the port and giving JAX's eval-mode X, one written by the port
loading in ``eegsynth.train.cgan.load_generator``, resume from the JAX
trainer's NPZ full state, ``python -m eegsynth_torch.train.cgan`` with no
``--arch`` writing every artifact at 1 tiny epoch, and ``serve.py``
answering ``/synthesize_cgan`` from a conv generator.

JAX runs with x64 off: float32 on both sides.
"""

import http.client
import io
import json
import threading

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

from test_torch_cgan_train import _write_buckets

from eegsynth.train import cgan as J
from eegsynth.train import checkpoint as jckpt
from eegsynth_torch.serve import ModelRegistry, make_server
from eegsynth_torch.train import cgan as P
from eegsynth_torch.train.checkpoint import load_checkpoint
from eegsynth_torch.tree import tree_leaves

C = 14


def _jax_generator(seed=7, K=9):
    """A full-width JAX conv generator with perturbed bn statistics, so
    eval mode reads them."""
    cfg = J.CGANConfig(num_classes=K)
    G, bn = J.generator_init(jax.random.key(seed), cfg)
    ks = iter(jax.random.split(jax.random.key(seed + 1), 10))
    bn = {k: {"mean": 0.1 * jax.random.normal(next(ks), v["mean"].shape),
              "var": 1 + 0.2 * jax.random.uniform(next(ks), v["var"].shape)}
          for k, v in bn.items()}
    return cfg, G, bn


@pytest.fixture(scope="module")
def jax_conv_generator(tmp_path_factory):
    """<root>/with_exo/CGAN_generator_with_exo_best.npz written by the JAX
    package (v1, meta with arch "conv"), and JAX's eval-mode X for a fixed
    noise and labels."""
    root = tmp_path_factory.mktemp("conv_root")
    z = np.random.default_rng(1).standard_normal((3, 100)).astype(np.float32)
    labels = np.array([0, 4, 8], np.int32)
    with jax.enable_x64(False):
        cfg, G, bn = _jax_generator()
        (root / "with_exo").mkdir()
        path = root / "with_exo" / "CGAN_generator_with_exo_best.npz"
        jckpt.save_checkpoint(path, {"model": G, "bn": bn},
                              J.generator_meta(J.CGANHParams(), 9, "with_exo"))
        x = np.asarray(J.generator_apply(G, bn, jnp.asarray(z), jnp.asarray(labels),
                                         cfg, train=False)[0])
    return root, path, z, labels, x


def test_jax_conv_generator_loads_in_the_port(jax_conv_generator):
    _, path, z, labels, want = jax_conv_generator
    G, bn, cfg, meta = P.load_generator(path, device="cpu")
    assert meta["arch"] == "conv" and cfg.arch == "conv" and set(bn) == {
        f"up{i}" for i in range(1, 6)}
    got = P.generator_apply(G, bn, torch.from_numpy(z), torch.from_numpy(labels), cfg,
                            train=False)[0]
    np.testing.assert_allclose(got.numpy(), want, rtol=0, atol=1e-6)
    # eval mode: each row depends on its own noise only
    two = P.generator_apply(G, bn, torch.from_numpy(z[:2]), torch.from_numpy(labels[:2]),
                            cfg, train=False)[0]
    np.testing.assert_allclose(two.numpy(), got[:2].numpy(), rtol=0, atol=1e-6)
    x = P.generate_batch(G, bn, cfg, torch.Generator().manual_seed(3), 5, 2)
    assert x.shape == (5, C, 768) and 0 < x.min() and x.max() < 1


def test_resume_from_a_jax_conv_checkpoint(tmp_path):
    """Parameters, bn, EMA, optimizer moments and counts load exactly from
    the JAX trainer's NPZ full state; training continues at the next
    epoch."""
    data = _write_buckets(tmp_path, n=1)
    with jax.enable_x64(False):
        hp = J.CGANHParams(batch_size=8)
        cfg, G, bn = _jax_generator(3)
        D = {"dg": J.disc_init(jax.random.key(4), cfg),
             "dl": J.disc_init(jax.random.key(5), cfg)}
        ema = jax.tree.map(lambda a: a + 0.01, G)
        optG = optax.adam(hp.lr_g, b1=hp.beta1, b2=hp.beta2)
        optD = optax.adam(hp.lr_d, b1=hp.beta1, b2=hp.beta2)
        g_state = optG.init(G)
        g_state = (g_state[0]._replace(count=jnp.int32(2),
                                       mu=jax.tree.map(lambda a: a * 1e-3, G)),
                   g_state[1])
        d_state = optD.init(D)
        d_state = (d_state[0]._replace(count=jnp.int32(2)), d_state[1])
        ckpt = tmp_path / "checkpoint_epoch2.npz"
        jckpt.save_checkpoint(ckpt, {"G": G, "bn": bn, "D": D, "ema": ema,
                                     "optG": g_state, "optD": d_state},
                              {"epoch": 2, "g_loss": 3.0, "d_loss": 1.0,
                               "best_g": 2.5, "tag": "no_exo"})
    kw = {"batch_size": 8, "save_every": 100, "device": "cpu"}
    res = P.train_one_condition(data, tmp_path / "runs", "no_exo", resume=str(ckpt),
                                epochs=2, **kw)               # nothing left to run
    for got, want in ((res["G"], G), (res["bn"], bn), (res["D"], D), (res["ema"], ema),
                      (res["g_state"].mu, g_state[0].mu)):
        for a, b in zip(tree_leaves(got), jax.tree.leaves(want)):
            np.testing.assert_array_equal(a.numpy(), np.asarray(b))
    assert res["g_state"].count == res["d_state"].count == 2 and res["best_g"] == 2.5
    res = P.train_one_condition(data, tmp_path / "runs", "no_exo", resume=str(ckpt),
                                epochs=3, **kw)               # one more epoch
    assert res["g_state"].count == 3
    assert not np.array_equal(res["bn"]["up1"]["mean"].numpy(), np.asarray(bn["up1"]["mean"]))
    lines = (tmp_path / "runs" / "no_exo" / "metrics.csv").read_text().splitlines()
    assert lines[-1].startswith("3,")


def test_cli_without_arch_trains_the_conv_model(tmp_path):
    """``main`` with no --arch: every artifact, bn in every generator file
    and in the full state, the best generator loading in the JAX package
    and giving the port's eval-mode X."""
    data = _write_buckets(tmp_path, n=1)
    runs = tmp_path / "runs"
    res = P.main(["--data-dir", str(data), "--save-root", str(runs), "--condition",
                  "no_exo", "--device", "cpu", "--epochs", "1", "--batch-size", "8",
                  "--save-every", "1", "--print-every", "1"])["no_exo"]
    run = runs / "no_exo"
    assert sorted(p.name for p in run.iterdir()) == sorted([
        "hparams.json", "metrics.csv", "checkpoint_epoch1.npz",
        "CGAN_generator_no_exo_epoch1.npz", "CGAN_generator_no_exo_best.npz",
        "CGAN_generator_no_exo_last.npz", "CGAN_globalD_no_exo_best.npz",
        "CGAN_localD_no_exo_best.npz"])
    assert json.loads((run / "hparams.json").read_text())["arch"] == "conv"
    rows = np.loadtxt(run / "metrics.csv", delimiter=",", skiprows=1, ndmin=2)
    assert rows.shape == (1, 11) and np.isfinite(rows).all()
    assert res["cfg"].arch == "conv" and res["steps_per_epoch"] == 1   # 9 windows // 8
    trees, meta = load_checkpoint(run / "checkpoint_epoch1.npz")
    assert set(trees) == {"G", "bn", "D", "ema", "optG", "optD"} and meta["epoch"] == 1
    for name in ("epoch1", "best", "last"):
        saved, _ = load_checkpoint(run / f"CGAN_generator_no_exo_{name}.npz")
        for a, b in zip(tree_leaves(res["bn"]), tree_leaves(saved["bn"])):
            np.testing.assert_array_equal(a.numpy(), b)
    z = np.random.default_rng(2).standard_normal((3, 100)).astype(np.float32)
    labels = np.array([1, 5, 7], np.int32)
    G_p, bn_p, cfg_p, _ = P.load_generator(run / "CGAN_generator_no_exo_best.npz",
                                           device="cpu")
    x_p = P.generator_apply(G_p, bn_p, torch.from_numpy(z), torch.from_numpy(labels),
                            cfg_p, train=False)[0]
    with jax.enable_x64(False):
        G_j, bn_j, cfg_j, meta = J.load_generator(run / "CGAN_generator_no_exo_best.npz")
        x_j = np.asarray(J.generator_apply(G_j, bn_j, jnp.asarray(z), jnp.asarray(labels),
                                           cfg_j, train=False)[0])
    assert meta["arch"] == "conv" and cfg_j.arch == "conv"
    np.testing.assert_allclose(x_p.numpy(), x_j, rtol=0, atol=1e-6)
    out = P.main(["generate", "--condition", "no_exo", "--data-dir", str(data),
                  "--save-root", str(runs), "--num-per-posture", "2", "--device", "cpu"])
    with np.load(out / "synth_posture9_no_exo.npz", allow_pickle=True) as f:
        assert f["X"].shape == (2, 768, C) and 0 < f["X"].min() and f["X"].max() < 1


def _post(addr, body):
    conn = http.client.HTTPConnection(*addr, timeout=120)
    try:
        conn.request("POST", "/synthesize_cgan", body=json.dumps(body))
        resp = conn.getresponse()
        return resp.status, resp.read()
    finally:
        conn.close()


def test_serve_answers_synthesize_cgan_from_a_conv_generator(jax_conv_generator):
    """n over serve_batch takes two micro-batches; the seeded request
    repeats; X is the port's generator on the server's noise; /runs says
    arch "conv"."""
    root, path, *_ = jax_conv_generator
    reg = ModelRegistry(None, None, device="cpu", cgan_root=root)
    srv = make_server(reg, "127.0.0.1", 0, 4, 768)
    thread = threading.Thread(target=srv.serve_forever, daemon=True)
    thread.start()
    try:
        conn = http.client.HTTPConnection(*srv.server_address, timeout=60)
        conn.request("GET", "/runs")
        runs = json.loads(conn.getresponse().read())
        conn.close()
        assert runs["cgan"] == {"with_exo": {"arch": "conv", "variant": "v1",
                                             "num_classes": 9, "noise_dim": 100}}
        body = {"model": "with_exo", "label": 4, "n": 6, "seed": 11}
        status, data = _post(srv.server_address, body)
        assert status == 200
        with np.load(io.BytesIO(data)) as f:
            X = f["X"]
        assert _post(srv.server_address, body)[1] == data
        assert _post(srv.server_address, {**body, "label": 9})[0] == 400
    finally:
        srv.shutdown()
        srv.server_close()
        thread.join(timeout=30)
    assert X.shape == (6, 768, C) and X.dtype == np.float32
    G, bn, cfg, _ = P.load_generator(path, device="cpu")
    gen = torch.Generator().manual_seed(11)
    want = torch.cat([P.generate_batch(G, bn, cfg, gen, 4, 4) for _ in range(2)])[:6]
    np.testing.assert_allclose(X, want.numpy().transpose(0, 2, 1), rtol=0, atol=1e-6)

