"""eegsynth_torch.serve on the CPU: the TimeGAN and transformer-CGAN
endpoints of scripts/serve_synthesis.py, same JSON, shapes, caps and error
codes (the conv CGAN's in ``test_torch_cgan_conv_train.py``)."""

import http.client
import io
import json
import sys
import threading
from pathlib import Path

import jax
import numpy as np
import pytest
import torch

from eegsynth.models.timegan import TimeGANConfig, timegan_init
from eegsynth.train.checkpoint import save_checkpoint
from eegsynth_torch.serve import ModelRegistry, main, make_server

sys.path.insert(0, str(Path(__file__).resolve().parent.parent / "scripts"))

SERVE_BATCH, TIME_CHUNK = 4, 16
RUNS = ("posture1_no_exo", "posture2_with_exo")
CGAN_TAG = "with_exo"        # a v1 transformer generator (9 posture classes)
CGAN_TINY = {"tf_dim": 16, "tf_depth": 1, "tf_heads": 2, "tf_patch": 8}


def _write_runs(root: Path):
    runs, real = root / "runs", root / "real"
    real.mkdir(parents=True)
    cfg = TimeGANConfig(x_dim=3, z_dim=16, h_dim=24)
    for i, name in enumerate(RUNS):
        (runs / name).mkdir(parents=True)
        save_checkpoint(runs / name / "ckpt_best.npz",
                        {"model": timegan_init(jax.random.key(i), cfg)},
                        {"npz": f"{name}.npz", "z_dim": 16, "h_dim": 24,
                         "step": 5 + i, "best": True})
        extra = ({"scale_min": np.full((3,), 2.0, np.float32),
                  "scale_range": np.full((3,), 10.0, np.float32)}
                 if i == 0 else {})
        np.savez(real / f"{name}.npz",
                 X=np.random.default_rng(i).uniform(0, 1, (4, 32, 3))
                 .astype(np.float32), fs=np.float32(128.0), **extra)
    return runs, real


def _write_cgan(root: Path, arch: str = "transformer") -> Path:
    """<root>/<tag>/CGAN_generator_<tag>_best.npz written by the JAX package,
    adaLN heads perturbed so that label and noise reach the output."""
    from eegsynth.models import cgan as jconv
    from eegsynth.train import cgan as jtrain

    hp = jtrain.CGANHParams(arch=arch, **CGAN_TINY)
    with jax.enable_x64(False):
        if arch == "transformer":
            cfg = jtrain.build_cfg(hp, 9)
            G, bn = jtrain.generator_init(jax.random.key(7), cfg)
            G["blk0"]["ada"]["w"] = 0.1 * jax.random.normal(jax.random.key(8),
                                                           G["blk0"]["ada"]["w"].shape)
        else:
            G, bn = jconv.generator_init(jax.random.key(7), jconv.CGANConfig())
    d = root / CGAN_TAG
    d.mkdir(parents=True)
    save_checkpoint(d / f"CGAN_generator_{CGAN_TAG}_best.npz", {"model": G, "bn": bn},
                    jtrain.generator_meta(hp, 9, CGAN_TAG))
    return root


def _serve(reg):
    srv = make_server(reg, "127.0.0.1", 0, SERVE_BATCH, TIME_CHUNK)
    threading.Thread(target=srv.serve_forever, daemon=True).start()
    return srv


@pytest.fixture(scope="module")
def dirs(tmp_path_factory):
    return _write_runs(tmp_path_factory.mktemp("serve_torch"))


@pytest.fixture(scope="module")
def cgan_root(tmp_path_factory, dirs):
    np.savez(dirs[1] / f"posture1_{CGAN_TAG}.npz",
             X=np.zeros((1, 768, 14), np.float32),
             scale_min=np.full((14,), -3.0, np.float32),
             scale_range=np.full((14,), 6.0, np.float32))
    return _write_cgan(tmp_path_factory.mktemp("cgan_root"))


@pytest.fixture(scope="module")
def served(dirs, cgan_root):
    srv = _serve(ModelRegistry(*dirs, device="cpu", cgan_root=cgan_root))
    yield srv.server_address
    srv.shutdown()
    srv.server_close()


def _request(addr, method, path, body=None):
    conn = http.client.HTTPConnection(*addr, timeout=120)
    try:
        conn.request(method, path, body=json.dumps(body) if body else None)
        resp = conn.getresponse()
        return resp.status, resp.getheader("Content-Type"), resp.read()
    finally:
        conn.close()


def _synth(addr, **body):
    status, ctype, data = _request(addr, "POST", "/synthesize", body)
    assert status == 200, data
    if body.get("format") == "json":
        obj = json.loads(data)
        X = np.asarray(obj["X"], np.float32)
        assert list(X.shape) == obj["shape"]
        return X
    assert ctype == "application/octet-stream"
    with np.load(io.BytesIO(data)) as npz:
        return npz["X"]


def test_healthz_and_runs_match_jax_server(served, dirs, cgan_root):
    from serve_synthesis import ModelRegistry as JaxRegistry
    from serve_synthesis import make_handler as jax_handler
    from http.server import ThreadingHTTPServer

    jsrv = ThreadingHTTPServer(("127.0.0.1", 0),
                               jax_handler(JaxRegistry(*dirs, cgan_root=cgan_root),
                                           SERVE_BATCH, TIME_CHUNK))
    threading.Thread(target=jsrv.serve_forever, daemon=True).start()
    try:
        for path in ("/healthz", "/runs"):
            s1, _, ours = _request(served, "GET", path)
            s2, _, theirs = _request(jsrv.server_address, "GET", path)
            assert s1 == s2 == 200
            assert json.loads(ours) == json.loads(theirs)
    finally:
        jsrv.shutdown()
        jsrv.server_close()
    obj = json.loads(_request(served, "GET", "/runs")[2])
    assert obj["cgan"] == {CGAN_TAG: {"arch": "transformer", "variant": "v1",
                                      "num_classes": 9, "noise_dim": 100}}
    assert obj["timegan"]["posture1_no_exo"]["has_scalers"]
    assert not obj["timegan"]["posture2_with_exo"]["has_scalers"]


@pytest.mark.parametrize("n,seq_len", [(6, 25), (4, 16), (1, 40), (9, 7)])
def test_synthesize_npz_shapes(served, n, seq_len):
    """Micro-batching (n > serve_batch), time streaming (seq_len >
    time_chunk) and slice-down on both axes."""
    X = _synth(served, run=RUNS[0], n=n, seq_len=seq_len, seed=7)
    assert X.shape == (n, seq_len, 3) and X.dtype == np.float32
    assert np.isfinite(X).all()


def test_synthesize_json_and_seed(served):
    a = _synth(served, run=RUNS[1], n=6, seq_len=25, seed=3, format="json")
    b = _synth(served, run=RUNS[1], n=6, seq_len=25, seed=3)
    c = _synth(served, run=RUNS[1], n=6, seq_len=25, seed=4)
    assert a.shape == (6, 25, 3)
    np.testing.assert_array_equal(a, b)       # same seed → same decoded X
    assert not np.array_equal(b, c)


def test_served_equals_synthesize(served, dirs):
    """The endpoint returns exactly the port's synthesize at the padded shape."""
    from eegsynth_torch.train.timegan import synthesize
    reg = ModelRegistry(*dirs, device="cpu")
    X = _synth(served, run=RUNS[0], n=6, seq_len=25, seed=11)
    ref = synthesize(reg.models[RUNS[0]]["model"], 8, 32,
                     generator=torch.Generator().manual_seed(11),
                     batch=SERVE_BATCH, time_chunk=TIME_CHUNK)[:6, :25]
    np.testing.assert_array_equal(X, ref)


def test_denorm(served):
    raw = _synth(served, run=RUNS[0], n=2, seq_len=8, seed=1)
    den = _synth(served, run=RUNS[0], n=2, seq_len=8, seed=1, denorm=True,
                 format="json")
    np.testing.assert_allclose(den, raw * 10.0 + 2.0, rtol=1e-6)
    # no scalers for this run: denorm is a no-op
    raw2 = _synth(served, run=RUNS[1], n=2, seq_len=8, seed=1)
    np.testing.assert_array_equal(
        _synth(served, run=RUNS[1], n=2, seq_len=8, seed=1, denorm=True), raw2)


@pytest.mark.parametrize("method,path,body,code", [
    ("POST", "/synthesize", {"run": "nope"}, 404),
    ("POST", "/synthesize", {"run": RUNS[0], "n": 0}, 400),
    ("POST", "/synthesize", {"run": RUNS[0], "seq_len": (1 << 20) + 1}, 400),
    ("POST", "/synthesize", {"n": 2}, 400),
    ("POST", "/synthesize_cgan", {"model": "no_exo", "n": 2}, 404),
    ("POST", "/synthesize_cgan", {"model": CGAN_TAG, "n": 0}, 400),
    ("POST", "/synthesize_cgan", {"model": CGAN_TAG, "label": 9}, 400),
    ("POST", "/synthesize_cgan", {"n": 2}, 400),
    ("GET", "/bogus", None, 404),
])
def test_errors(served, method, path, body, code):
    assert _request(served, method, path, body)[0] == code


def test_request_size_caps(served):
    status, _, data = _request(served, "POST", "/synthesize",
                               {"run": RUNS[0], "n": 65536, "seq_len": 1024})
    assert status == 400 and "n*seq_len" in json.loads(data)["error"]
    # under the cap raw, over it once padded to (serve_batch, time_chunk)
    status, _, data = _request(served, "POST", "/synthesize",
                               {"run": RUNS[0], "n": 52429, "seq_len": 65})
    assert status == 400 and "padded" in json.loads(data)["error"]


def test_device_cuda_without_card_raises(dirs, monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        ModelRegistry(*dirs, device="cuda")
    with pytest.raises(RuntimeError, match="no CUDA device"):
        main(["--runs_dir", str(dirs[0]), "--real_dir", str(dirs[1]),
              "--device", "cuda", "--port", "0"])


def test_unported_options_refused(dirs):
    """An unknown precision is refused; bf16 serving is taken, and its
    windows are float32 within the bf16 bounds of the f32 ones."""
    reg = ModelRegistry(*dirs, device="cpu")
    with pytest.raises(ValueError, match="precision"):
        make_server(reg, "127.0.0.1", 0, SERVE_BATCH, TIME_CHUNK,
                    precision="fp16")
    srv = make_server(reg, "127.0.0.1", 0, SERVE_BATCH, TIME_CHUNK,
                      precision="bf16")
    srv.server_close()
    args = (RUNS[0], 5, 40, 0, False, SERVE_BATCH, TIME_CHUNK)
    x16 = reg.synthesize(*args, precision="bf16")
    x32 = reg.synthesize(*args)
    assert x16.shape == (5, 40, 3) and x16.dtype == np.float32
    assert np.corrcoef(x16.ravel(), x32.ravel())[0, 1] > 0.999
    assert np.abs(x16 - x32).max() < 0.05


def _synth_cgan(addr, **body):
    status, ctype, data = _request(addr, "POST", "/synthesize_cgan", body)
    assert status == 200, data
    if body.get("format") == "json":
        return np.asarray(json.loads(data)["X"], np.float32)
    assert ctype == "application/octet-stream"
    with np.load(io.BytesIO(data)) as npz:
        return npz["X"]


def test_synthesize_cgan_shapes_seed_and_scaling(served):
    """n over serve_batch takes two micro-batches; the same seed gives the
    same X (npz or json); inverse_scale applies the class's bucket scalers."""
    X = _synth_cgan(served, model=CGAN_TAG, label=0, n=6, seed=1)
    assert X.shape == (6, 768, 14) and X.dtype == np.float32
    assert np.isfinite(X).all() and 0 < X.min() and X.max() < 1
    np.testing.assert_array_equal(
        _synth_cgan(served, model=CGAN_TAG, label=0, n=6, seed=1, format="json"), X)
    assert not np.array_equal(_synth_cgan(served, model=CGAN_TAG, label=0, n=6,
                                          seed=2), X)
    assert not np.array_equal(_synth_cgan(served, model=CGAN_TAG, label=5, n=6,
                                          seed=1), X)
    scaled = _synth_cgan(served, model=CGAN_TAG, label=0, n=6, seed=1,
                         inverse_scale=True)
    np.testing.assert_allclose(scaled, X * 6.0 - 3.0, rtol=1e-6, atol=1e-6)
    # no scalers for posture 2 of this condition: a no-op
    np.testing.assert_array_equal(
        _synth_cgan(served, model=CGAN_TAG, label=1, n=2, seed=1, inverse_scale=True),
        _synth_cgan(served, model=CGAN_TAG, label=1, n=2, seed=1))


def test_served_cgan_generator_matches_jax(dirs, cgan_root):
    """The registry's generator is the JAX checkpoint's: same output on the
    same noise."""
    from eegsynth.train import cgan as jtrain
    from eegsynth_torch.models.cgan_transformer import generator_apply

    reg = ModelRegistry(*dirs, device="cpu", cgan_root=cgan_root)
    m = reg.cgan[CGAN_TAG]
    z = np.random.default_rng(3).standard_normal((3, 100)).astype(np.float32)
    labels = np.array([0, 4, 8], np.int32)
    path = cgan_root / CGAN_TAG / f"CGAN_generator_{CGAN_TAG}_best.npz"
    with jax.enable_x64(False):
        G, bn, cfg, _ = jtrain.load_generator(path)
        want = np.asarray(jtrain.generator_apply(G, bn, z, labels, cfg, train=False)[0])
    got = generator_apply(m["G"], m["bn"], torch.from_numpy(z),
                          torch.from_numpy(labels).long(), m["cfg"], train=False)[0]
    np.testing.assert_allclose(got.numpy(), want, rtol=0, atol=1e-6)
    X = reg.synthesize_cgan(CGAN_TAG, 3, 5, 0, False, SERVE_BATCH)
    assert X.shape == (5, 768, 14)
