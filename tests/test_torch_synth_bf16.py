"""bf16 TimeGAN synthesis, bf16 serving and long-horizon generation in
eegsynth_torch, against the JAX package's ``synthesize(precision="bf16")``
and against float32 on the same parameters and noise.

The bounds are ``tests/test_precision.py``'s for JAX's own bf16 against
f32: correlation over 0.999 and max |Δ| under 0.05. At x14/z28/h56, 8
windows of 96 steps, the port's bf16 sits at corr 0.99998 and max |Δ|
0.0039 from JAX's bf16 and 0.0032 from its own f32 (JAX's bf16 is 0.0052
from f32; ``test_bf16_cascade_matches_jax_bf16_and_f32`` prints them,
``pytest -s``): JAX's fused scan rounds the recurrence state to bfloat16
every step, while the port keeps it float32 inside K1 (and its plain
twin here).

Every JAX call runs under ``jax.enable_x64(False)``; no GAN step is
compiled.
"""

import http.client
import io
import json
import threading

import jax
import numpy as np
import pytest
import torch
from threadpoolctl import threadpool_limits

from eegsynth.models import timegan as jtg
from eegsynth.train.timegan import synthesize as jax_synthesize
from eegsynth_torch import generate_long_synth
from eegsynth_torch.convert import from_jax_params, to_jax_params
from eegsynth_torch.eval.drivers import find_synth_npz
from eegsynth_torch.models import timegan as ttg
from eegsynth_torch.nn import gru as tgru
from eegsynth_torch.nn.precision import cast_floating
from eegsynth_torch.serve import ModelRegistry, make_server
from eegsynth_torch.train.checkpoint import save_checkpoint
from eegsynth_torch.train.timegan import synthesize, synthesize_from_noise

FULL = jtg.TimeGANConfig(x_dim=14, z_dim=28, h_dim=56)
SMALL = ttg.TimeGANConfig(x_dim=3, z_dim=16, h_dim=24)
BF16_CORR, BF16_MAX = 0.999, 0.05        # tests/test_precision.py:49-52
BF16 = torch.bfloat16


@pytest.fixture(autouse=True, scope="module")
def _one_thread_each():
    """One intra-op thread for torch and for numpy's BLAS while this file
    runs. Under pytest-xdist, with a thread pool per worker process, the
    workers oversubscribe the cores, and these fits and full-width
    convolutions ran about 60 times slower than alone (spinning threads
    waiting on descheduled ones)."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    try:
        with threadpool_limits(1):
            yield
    finally:
        torch.set_num_threads(n)


def _params(cfg, seed=0):
    with jax.enable_x64(False):
        p = jtg.timegan_init(jax.random.key(seed), cfg)
    return jax.tree.map(lambda a: np.asarray(a, np.float32), p)


def _assert_bf16_close(x16, x32, what: str = ""):
    assert x16.dtype == np.float32 and x16.shape == x32.shape
    assert np.isfinite(x16).all()
    corr = np.corrcoef(x16.ravel(), x32.ravel())[0, 1]
    err = np.abs(x16 - x32).max()
    if what:
        print(f"{what}: corr {corr:.5f}, max|diff| {err:.4f}")
    assert corr > BF16_CORR, corr
    assert err < BF16_MAX


def _bf16(model):
    return cast_floating(ttg.params_tree(model), BF16)


def test_bf16_cascade_matches_jax_bf16_and_f32():
    """The port's bf16 cascade on JAX synthesize's own noise, against JAX's
    bf16 windows and the port's f32 ones."""
    p = _params(FULL)
    key = jax.random.key(3)
    with jax.enable_x64(False):
        ref16 = np.asarray(jax_synthesize(p, FULL, key, 8, 96, precision="bf16"))
        z = np.asarray(jtg.sample_noise(key, 8, 96, FULL.z_dim))
    model = from_jax_params(p, device="cpu").eval()
    zt = torch.from_numpy(z.copy())
    x16, carry = synthesize_from_noise(_bf16(model), zt.to(BF16))
    x32, _ = synthesize_from_noise(model, zt)
    assert all(h.dtype == torch.float32 for h in carry)
    x16 = x16.numpy()
    _assert_bf16_close(x16, ref16, "port bf16 vs JAX bf16")
    _assert_bf16_close(x16, x32.numpy(), "port bf16 vs port f32")
    with jax.enable_x64(False):
        ref32 = np.asarray(jax_synthesize(p, FULL, key, 8, 96))
    _assert_bf16_close(ref16, ref32, "JAX bf16 vs JAX f32")


def test_bf16_chunked_matches_jax_bf16_chunked():
    """Chunked with carried state in both packages, on JAX's per-chunk
    noise (one key split a chunk)."""
    p = _params(FULL, seed=1)
    key = jax.random.key(5)
    with jax.enable_x64(False):
        ref = np.asarray(jax_synthesize(p, FULL, key, 4, 80, time_chunk=32,
                                        precision="bf16"))
        zs, k = [], key
        for _ in range(3):
            k, sub = jax.random.split(k)
            zs.append(np.asarray(jtg.sample_noise(sub, 4, 32, FULL.z_dim)))
    tree = _bf16(from_jax_params(p, device="cpu"))
    carry, xs = None, []
    for z in zs:
        x, carry = synthesize_from_noise(tree, torch.from_numpy(z.copy()).to(BF16),
                                         carry)
        xs.append(x.numpy())
    _assert_bf16_close(np.concatenate(xs, 1)[:, :80], ref)


def test_bf16_synthesize_against_f32_on_the_same_generator():
    """Noise is drawn in f32 and cast, so one generator state gives the
    same noise to both precisions, one-shot and chunked."""
    model = from_jax_params(_params(FULL, seed=2), device="cpu")
    for kw in ({}, {"batch": 3, "time_chunk": 24}):
        run = lambda precision: synthesize(  # noqa: E731
            model, 7, 60, generator=torch.Generator().manual_seed(4),
            precision=precision, **kw)
        _assert_bf16_close(run("bf16"), run("f32"))


def test_chunked_bf16_equals_one_shot():
    """The carried states are K1's float32 last rows, so a chunked bf16 run
    over the same noise equals the one-shot run bit for bit."""
    tree = _bf16(from_jax_params(_params(FULL, seed=3), device="cpu"))
    z = torch.from_numpy(np.random.default_rng(3).uniform(0, 1, (3, 48, 28))
                         .astype(np.float32)).to(BF16)
    ref, _ = synthesize_from_noise(tree, z)
    carry, xs = None, []
    for t0 in (0, 16, 32):
        x, carry = synthesize_from_noise(tree, z[:, t0:t0 + 16], carry)
        xs.append(x)
    np.testing.assert_array_equal(torch.cat(xs, 1).numpy(), ref.numpy())


def test_bf16_microbatched_and_seeded_runs_repeat():
    model = from_jax_params(_params(FULL, seed=4), device="cpu")

    def run(seed):
        return synthesize(model, 7, 40, generator=torch.Generator().manual_seed(seed),
                          batch=3, time_chunk=16, precision="bf16")
    a = run(0)
    assert a.shape == (7, 40, 14) and a.dtype == np.float32
    np.testing.assert_array_equal(a, run(0))
    assert not np.array_equal(a, run(1))


def test_bf16_multilayer_stack_runs_one_shot():
    """Two-layer stacks take the composed path in bf16, one-shot even when
    a time_chunk is asked for."""
    cfg = ttg.TimeGANConfig(x_dim=3, z_dim=8, h_dim=12, num_layers=2)
    model = ttg.TimeGAN(cfg, generator=torch.Generator().manual_seed(0), device="cpu")
    run = lambda precision, **kw: synthesize(  # noqa: E731
        model, 4, 30, generator=torch.Generator().manual_seed(2),
        precision=precision, **kw)
    x16 = run("bf16", time_chunk=8)
    np.testing.assert_array_equal(x16, run("bf16"))
    _assert_bf16_close(x16, run("f32"))


@pytest.mark.parametrize("impl,fn", [("kernel", "gru_sequence"),
                                     ("plain", "gru_sequence_reference")])
def test_recurrence_runs_in_float32(monkeypatch, impl, fn):
    """A bf16 layer hands the recurrence float32 xp, W_hhᵀ, b_hh and h0 on
    both paths (K1's wrapper keeps refusing other dtypes on the card) and
    casts ys back to bf16; both paths agree."""
    seen = []
    real = getattr(tgru, fn)

    def spy(*args):
        seen.append({a.dtype for a in args})
        return real(*args)
    monkeypatch.setattr(tgru, fn, spy)
    rng = np.random.default_rng(0)
    layer = tgru.GRULayer(*(torch.from_numpy(rng.standard_normal(s).astype(np.float32))
                            .to(BF16) for s in ((36, 5), (36, 12), (36,), (36,))))
    x = torch.from_numpy(rng.standard_normal((10, 4, 5)).astype(np.float32)).to(BF16)
    h0 = torch.zeros(4, 12)
    ys = tgru.gru_apply_time_major(layer, x, h0, impl)
    assert seen == [{torch.float32}] and ys.dtype == BF16
    other = tgru.gru_apply_time_major(layer, x, h0,
                                      "plain" if impl == "kernel" else "kernel")
    np.testing.assert_array_equal(ys.float().numpy(), other.float().numpy())


# ---- long-horizon generation and bf16 serving on runs written by the port


def _write_model(path, seed, meta_extra=None):
    model = ttg.TimeGAN(SMALL, generator=torch.Generator().manual_seed(seed),
                        device="cpu")
    meta = {"z_dim": SMALL.z_dim, "h_dim": SMALL.h_dim, "x_dim": SMALL.x_dim,
            "layers": 1, "step": seed, **(meta_extra or {})}
    save_checkpoint(path, {"model": to_jax_params(model)}, meta)
    return model


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    """posture1_no_exo: best and latest, a real file with scalers;
    posture2_with_exo: latest only, a real file without scalers;
    posture3_no_exo: no checkpoint; posture4_no_exo: a checkpoint without
    fs and no real file; ``notes``: not a run."""
    root = tmp_path_factory.mktemp("long_synth")
    runs, real = root / "runs", root / "real"
    for d in ("posture1_no_exo", "posture2_with_exo", "posture3_no_exo",
              "posture4_no_exo", "notes"):
        (runs / d).mkdir(parents=True)
    real.mkdir()
    models = {"p1_best": _write_model(runs / "posture1_no_exo" / "ckpt_best.npz", 1,
                                      {"fs": 128.0}),
              "p1_latest": _write_model(runs / "posture1_no_exo" / "ckpt_latest.npz", 2,
                                        {"fs": 128.0}),
              "p2": _write_model(runs / "posture2_with_exo" / "ckpt_latest.npz", 3,
                                 {"fs": 128.0}),
              "p4": _write_model(runs / "posture4_no_exo" / "ckpt_best.npz", 4)}
    rng = np.random.default_rng(0)
    np.savez(real / "posture1_no_exo.npz",
             X=rng.uniform(0, 1, (5, 32, 3)).astype(np.float32), fs=np.float32(128.0),
             scale_min=np.array([1.0, -2.0, 0.5], np.float32),
             scale_range=np.array([10.0, 3.0, 0.25], np.float32))
    np.savez(real / "posture2_with_exo.npz",
             X=rng.uniform(0, 1, (6, 32, 3)).astype(np.float32), fs=np.float32(128.0))
    return runs, real, models


def _cli(runs, real, *extra):
    return generate_long_synth.main(["--runs_dir", str(runs), "--real_dir", str(real),
                                     "--device", "cpu", *extra])


def test_generate_long_synth_writes_each_run(runs, capsys):
    """--gen_len, --time_chunk, --denorm and a {T} suffix: each file is
    synthesize on the run's ckpt_best (else ckpt_latest), one generator
    advanced run by run, then X * scale_range + scale_min where the real
    file has scalers; the SKIP cases print and write nothing."""
    runs_dir, real, models = runs
    written = _cli(runs_dir, real, "--gen_len", "40", "--time_chunk", "16",
                   "--denorm", "--seed", "3", "--out_suffix", "long_{T}.npz")
    out = capsys.readouterr().out
    assert "[SKIP] posture3_no_exo: no checkpoint found." in out
    assert "[SKIP] posture4_no_exo: real file missing" in out and "--n" in out
    assert sorted(written) == ["posture1_no_exo", "posture2_with_exo"]
    gen = torch.Generator().manual_seed(3)
    want1 = synthesize(models["p1_best"], 5, 40, generator=gen, time_chunk=16)
    want2 = synthesize(models["p2"], 6, 40, generator=gen, time_chunk=16)
    with np.load(real / "posture1_no_exo.npz") as z:
        want1 = want1 * z["scale_range"] + z["scale_min"]
    for name, want in (("posture1_no_exo", want1), ("posture2_with_exo", want2)):
        assert written[name] == runs_dir / name / "long_40.npz"
        with np.load(written[name]) as z:
            assert z["X"].dtype == np.float32 and z["X"].shape == want.shape
            np.testing.assert_array_equal(z["X"], want)


def test_generate_long_synth_prefer_latest_bf16_and_seconds(runs, capsys):
    """--prefer_latest takes ckpt_latest; --gen_seconds sets T from fs, the
    meta's 128 Hz (with a WARN) when the real file is missing; --n then
    lets that run generate, --denorm is ignored there with a WARN; bf16
    runs as synthesize(precision="bf16"). The default file name is the one
    the TimeGAN eval picks first."""
    runs_dir, real, models = runs
    written = _cli(runs_dir, real, "--prefer_latest", "--n", "3",
                   "--gen_seconds", "0.25", "--precision", "bf16", "--denorm")
    out = capsys.readouterr().out
    assert "[WARN] posture4_no_exo: real file missing and checkpoint meta has no fs" in out
    assert "[WARN] posture4_no_exo: --denorm ignored" in out
    assert sorted(written) == ["posture1_no_exo", "posture2_with_exo", "posture4_no_exo"]
    gen = torch.Generator().manual_seed(0)
    want = synthesize(models["p1_latest"], 3, 32, generator=gen, precision="bf16")
    with np.load(real / "posture1_no_exo.npz") as z:
        want = want * z["scale_range"] + z["scale_min"]
    with np.load(written["posture1_no_exo"]) as z:
        np.testing.assert_array_equal(z["X"], want)
    with np.load(written["posture4_no_exo"]) as z:
        assert z["X"].shape == (3, 32, 3) and np.isfinite(z["X"]).all()
    for name, path in written.items():
        assert find_synth_npz(runs_dir / name) == path == \
            runs_dir / name / "synthetic_long.npz"


def test_generate_long_synth_refusals(runs, monkeypatch):
    runs_dir, real, _ = runs
    with pytest.raises(SystemExit, match="--mesh"):
        _cli(runs_dir, real, "--mesh", "--gen_len", "8")
    with pytest.raises(SystemExit, match="Runs dir not found"):
        _cli(runs_dir / "missing", real)
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(SystemExit, match="no CUDA device"):
        generate_long_synth.main(["--runs_dir", str(runs_dir), "--device", "cuda"])


def test_bf16_server_matches_in_process_synthesize(runs):
    """A --precision bf16 server answers /synthesize (padded to its serving
    shape) with in-process bf16 synthesize on the same seed."""
    runs_dir, real, models = runs
    reg = ModelRegistry(runs_dir, real, device="cpu")
    srv = make_server(reg, "127.0.0.1", 0, 4, 16, precision="bf16")
    threading.Thread(target=srv.serve_forever, daemon=True).start()
    try:
        conn = http.client.HTTPConnection(*srv.server_address, timeout=120)
        conn.request("POST", "/synthesize", body=json.dumps(
            {"run": "posture1_no_exo", "n": 6, "seq_len": 20, "seed": 5}))
        resp = conn.getresponse()
        assert resp.status == 200
        with np.load(io.BytesIO(resp.read())) as z:
            got = z["X"]
        conn.close()
    finally:
        srv.shutdown()
        srv.server_close()
    want = synthesize(models["p1_best"], 8, 32, generator=torch.Generator()
                      .manual_seed(5), batch=4, time_chunk=16,
                      precision="bf16")[:6, :20]
    assert got.dtype == np.float32
    np.testing.assert_array_equal(got, want)
    f32 = reg.synthesize("posture1_no_exo", 6, 20, 5, False, 4, 16)
    _assert_bf16_close(got, f32)
