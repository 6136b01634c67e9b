"""eegsynth_torch's conv CGAN against eegsynth's on the same parameters and
inputs (CPU): the conv and spectral-norm conv layers, nearest upsampling,
the class-conditional BN with its running statistics, the generator and
both discriminator flavours (v2 with JAX's own keep mask), in train and
eval mode, at CGANConfig(init_len=3, seq_len=96) and B 4; then the
bfloat16 trunk against JAX's, the parameter layout that checkpoints share,
and the precision helpers.

JAX runs eagerly with x64 off: float32 on both sides.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from eegsynth.models import cgan as J
from eegsynth.nn import conv as jconv
from eegsynth.nn import norm as jnorm
from eegsynth.nn import precision as jprec
from eegsynth_torch.convert import tree_to_device
from eegsynth_torch.models import cgan as P
from eegsynth_torch.nn import conv as pconv
from eegsynth_torch.nn import norm as pnorm
from eegsynth_torch.nn import precision as pprec
from eegsynth_torch.tree import tree_leaves

B = 4
SMALL = dict(init_len=3, seq_len=96)
# float32 on both sides, sums in another order: every output within 1e-5
# of its largest magnitude (at least 1)
RTOL = 1e-5
# bfloat16 trunk, another backend's bf16 convolution: the pooled features
# within 2e-2 of their largest magnitude (bf16 keeps 8 bits, five layers)
BF16_RTOL = 2e-2


def _port(tree):
    return tree_to_device(jax.tree.map(np.asarray, tree), device="cpu")


def _close(got, want, rtol=RTOL):
    got = got.detach().float().numpy() if isinstance(got, torch.Tensor) else got
    want = np.asarray(want, np.float32)
    assert got.shape == want.shape
    scale = max(1.0, float(np.abs(want).max()))
    err = float(np.abs(got - want).max())
    assert err <= rtol * scale, (err, scale)


def _x(shape, seed=0):
    return np.random.default_rng(seed).uniform(0, 1, shape).astype(np.float32)


@pytest.mark.parametrize("k,stride,padding", [(3, 1, 1), (4, 2, 1)])
def test_conv1d_matches_jax(k, stride, padding):
    x = _x((B, 14, 96))
    with jax.enable_x64(False):
        p = jconv.conv1d_init(jax.random.key(0), 14, 32, k)
        want = jconv.conv1d_apply(p, jnp.asarray(x), stride, padding)
    _close(pconv.conv1d_apply(_port(p), torch.from_numpy(x), stride, padding), want)


@pytest.mark.parametrize("train", [True, False])
def test_sn_conv1d_matches_jax(train):
    x = _x((B, 14, 96), 1)
    with jax.enable_x64(False):
        p = jconv.sn_conv1d_init(jax.random.key(1), 14, 32, 4)
        y, new = jconv.sn_conv1d_apply(p, jnp.asarray(x), 2, 1, train=train)
    got, pnew = pconv.sn_conv1d_apply(_port(p), torch.from_numpy(x), 2, 1, train=train)
    _close(got, y)
    _close(pnew["u"], new["u"])
    if train:
        assert not np.allclose(np.asarray(new["u"]), np.asarray(p["u"]))
    else:
        np.testing.assert_array_equal(pnew["u"].numpy(), np.asarray(p["u"]))


def test_upsample_matches_jax():
    x = _x((B, 16, 12), 2)
    with jax.enable_x64(False):
        want = np.asarray(jconv.upsample_nearest_2x(jnp.asarray(x)))
    np.testing.assert_array_equal(pconv.upsample_nearest_2x(torch.from_numpy(x)).numpy(),
                                  want)


@pytest.mark.parametrize("train", [True, False])
def test_cbn1d_matches_jax(train):
    """Perturbed γ/β rows and running statistics, so the class and the
    state reach the output."""
    rng = np.random.default_rng(3)
    x = rng.standard_normal((B, 16, 24)).astype(np.float32) * 2 + 0.5
    labels = np.array([0, 2, 2, 1], np.int32)
    embed = rng.standard_normal((3, 32)).astype(np.float32)
    state = {"mean": rng.standard_normal(16).astype(np.float32),
             "var": rng.uniform(0.5, 2, 16).astype(np.float32)}
    with jax.enable_x64(False):
        y, new = jnorm.cbn1d_apply({"embed": jnp.asarray(embed)},
                                   jax.tree.map(jnp.asarray, state), jnp.asarray(x),
                                   jnp.asarray(labels), train=train)
    got, pnew = pnorm.cbn1d_apply({"embed": torch.from_numpy(embed)}, _port(state),
                                  torch.from_numpy(x), torch.from_numpy(labels),
                                  train=train)
    _close(got, y)
    for k in ("mean", "var"):
        _close(pnew[k], new[k])
        assert not pnew[k].requires_grad
    # the initial parameters and state are JAX's
    with jax.enable_x64(False):
        jp, js = jnorm.cbn1d_init(None, 16, 3), jnorm.cbn1d_state_init(16)
    np.testing.assert_array_equal(pnorm.cbn1d_init(16, 3, device="cpu")["embed"].numpy(),
                                  np.asarray(jp["embed"]))
    for k, v in pnorm.cbn1d_state_init(16, device="cpu").items():
        np.testing.assert_array_equal(v.numpy(), np.asarray(js[k]))


def _generator(cfg, seed=0):
    """A JAX generator whose BN embeddings and running statistics are
    perturbed from their init (γ=1, β=0, mean 0, var 1)."""
    G, bn = J.generator_init(jax.random.key(seed), cfg)
    ks = iter(jax.random.split(jax.random.key(50 + seed), 20))
    for i in range(1, 6):
        e = G[f"up{i}"]["cbn"]["embed"]
        G[f"up{i}"]["cbn"]["embed"] = e + 0.1 * jax.random.normal(next(ks), e.shape)
        s = bn[f"up{i}"]
        bn[f"up{i}"] = {"mean": 0.1 * jax.random.normal(next(ks), s["mean"].shape),
                        "var": 1 + 0.2 * jax.random.uniform(next(ks), s["var"].shape)}
    return G, bn


@pytest.mark.parametrize("train", [True, False])
@pytest.mark.parametrize("variant,K", [("v1", 9), ("v2", 2)])
def test_generator_matches_jax(train, variant, K):
    cfg = J.CGANConfig(num_classes=K, variant=variant, **SMALL)
    pcfg = P.CGANConfig(num_classes=K, variant=variant, **SMALL)
    rng = np.random.default_rng(4)
    z = rng.standard_normal((B, 100)).astype(np.float32)
    labels = rng.integers(0, K, B).astype(np.int32)
    with jax.enable_x64(False):
        G, bn = _generator(cfg)
        x, new = J.generator_apply(G, bn, jnp.asarray(z), jnp.asarray(labels), cfg,
                                   train=train)
    got, pnew = P.generator_apply(_port(G), _port(bn), torch.from_numpy(z),
                                  torch.from_numpy(labels), pcfg, train=train)
    assert got.shape == (B, 14, 96)
    _close(got, x)
    for a, b in zip(tree_leaves(pnew), jax.tree.leaves(new)):
        _close(a, b)


def _disc_inputs(cfg, seed=5):
    rng = np.random.default_rng(seed)
    x = rng.uniform(0, 1, (B, 14, cfg.seq_len)).astype(np.float32)
    labels = rng.integers(0, cfg.num_classes, B).astype(np.int32)
    return x, labels


@pytest.mark.parametrize("train", [True, False])
@pytest.mark.parametrize("variant,K,T", [("v1", 9, 96), ("v1", 9, 32), ("v2", 2, 96)])
def test_disc_matches_jax(train, variant, K, T):
    """Score, logits, features and every ``u`` (the five convs' and the
    head's); v2 in train mode with the keep mask JAX draws; T 32 is the
    local crop's length."""
    cfg = J.CGANConfig(num_classes=K, variant=variant, **SMALL)
    pcfg = P.CGANConfig(num_classes=K, variant=variant, **SMALL)
    x, labels = _disc_inputs(cfg)
    x = x[:, :, :T]
    key = jax.random.key(7)
    with jax.enable_x64(False):
        D = J.disc_init(jax.random.key(6), cfg)
        D["std_weight"] = jnp.full((1,), 0.3)
        want = J.disc_apply(D, jnp.asarray(x), jnp.asarray(labels), cfg, train=train,
                            dropout_key=key)
        keep = (torch.from_numpy(np.array(jax.random.bernoulli(key, 0.9, (B, 512))))
                if variant == "v2" else None)
    got = P.disc_apply(_port(D), torch.from_numpy(x), torch.from_numpy(labels), pcfg,
                       train=train, dropout_keep=keep)
    for a, b in zip(got[:3], want[:3]):
        _close(a, b)
    for name in [f"c{i}" for i in range(1, 6)] + ["fc", "cls"]:
        _close(got[3][name]["u"], want[3][name]["u"])
        if not train:
            np.testing.assert_array_equal(got[3][name]["u"].numpy(), np.asarray(D[name]["u"]))


def test_bf16_trunk_matches_jax():
    """The bfloat16 trunk's pooled features (float32) against JAX's bf16
    trunk within BF16_RTOL of their scale; the power iteration stays in the
    parameter dtype, so every ``u`` equals the float32 trunk's bit for bit."""
    cfg = J.CGANConfig(**SMALL)
    x, _ = _disc_inputs(cfg)
    with jax.enable_x64(False):
        D = J.disc_init(jax.random.key(8), cfg)
        f16, new16 = J.disc_features(D, jnp.asarray(x), compute_dtype=jnp.bfloat16)
    tD = _port(D)
    got, pnew = P.disc_features(tD, torch.from_numpy(x), compute_dtype=torch.bfloat16)
    f32, pnew32 = P.disc_features(tD, torch.from_numpy(x))
    assert got.dtype == torch.float32 and f16.dtype == jnp.float32
    _close(got, f16, BF16_RTOL)
    assert (got - f32).abs().max().item() > 0          # the trunk did run in bf16
    for i in range(1, 6):
        u = pnew[f"c{i}"]["u"]
        assert u.dtype == torch.float32
        np.testing.assert_array_equal(u.numpy(), pnew32[f"c{i}"]["u"].numpy())
        _close(u, new16[f"c{i}"]["u"])


def test_parameter_layout_matches_jax():
    """The port's fresh trees have JAX's paths and shapes (what checkpoints
    and the converter rely on), torch's init bounds, and JAX's BN init."""
    cfg = J.CGANConfig(**SMALL)
    pcfg = P.CGANConfig(**SMALL)
    gen = torch.Generator().manual_seed(0)
    with jax.enable_x64(False):
        trees = (*J.generator_init(jax.random.key(0), cfg), J.disc_init(jax.random.key(1), cfg))
    ptrees = (*P.generator_init(pcfg, gen, device="cpu"), P.disc_init(pcfg, gen, device="cpu"))
    for want, got in zip(trees, ptrees):
        paths = [(jax.tree_util.keystr(k), v.shape)
                 for k, v in jax.tree_util.tree_flatten_with_path(want)[0]]
        assert [(p, tuple(v.shape)) for p, v in
                zip([p for p, _ in paths], tree_leaves(got))] == paths
    G, bn, D = ptrees
    for name, ci in (("up1", 512), ("up5", 32)):
        bound = 1 / np.sqrt(ci * 3)
        assert G[name]["conv"]["w"].abs().max().item() <= bound
    np.testing.assert_array_equal(bn["up3"]["var"].numpy(), np.ones(64, np.float32))
    for i in range(1, 6):
        np.testing.assert_allclose(torch.linalg.vector_norm(D[f"c{i}"]["u"]).item(), 1.0,
                                   rtol=1e-6)


def test_precision_helpers_match_jax():
    assert pprec.PRECISIONS == jprec.PRECISIONS
    assert pprec.compute_dtype("f32") == torch.float32
    assert pprec.compute_dtype("bf16") == torch.bfloat16
    for mod in (pprec, jprec):
        with pytest.raises(ValueError):
            mod.compute_dtype("f16")
    tree = {"w": torch.ones(2), "n": torch.arange(3), "none": None}
    cast = pprec.cast_floating(tree, torch.bfloat16)
    assert cast["w"].dtype == torch.bfloat16 and cast["n"].dtype == torch.int64
    assert cast["none"] is None


@pytest.mark.parametrize("which", ["posture_conditional", "random_pairs"])
def test_coherence_gradient_at_t96(which):
    """The coherence losses' gradient in the fake at T 96, B 4 (the step
    tests' size, where they run with coh_weight 0): the two packages agree
    in float64 within 1e-9 of its scale, the same formula. In float32 it
    is ill-conditioned (num / den of two nearly equal magnitudes): JAX's
    own float32 gradient is off its float64 value by more than the step
    tests' 1e-5, and the port's float32 error is of the same size."""
    from eegsynth.losses import spectral as JS
    from eegsynth_torch.losses import spectral as PS

    rng = np.random.default_rng(9)
    real = rng.uniform(0, 1, (B, 14, 96))
    fake = 0.5 + 0.05 * rng.standard_normal((B, 14, 96))
    labels = np.array([0, 3, 3, 7], np.int32)
    key = jax.random.key(4)
    perm = np.asarray(jax.random.permutation(key, len(PS.ALL_PAIRS)))[:24]
    pairs = torch.from_numpy(PS.ALL_PAIRS[perm])

    def grads(dtype):
        r, f = real.astype(dtype), fake.astype(dtype)
        if which == "posture_conditional":
            jloss = lambda x: JS.posture_conditional_losses(  # noqa: E731
                jnp.asarray(r), x, jnp.asarray(labels), 9, 0.0, 1.0, 0.0)
            ploss = lambda x: PS.posture_conditional_losses(  # noqa: E731
                torch.from_numpy(r), x, torch.from_numpy(labels), 9, 0.0, 1.0, 0.0)
        else:
            jloss = lambda x: JS.coh_loss_random(key, jnp.asarray(r), x)  # noqa: E731
            ploss = lambda x: PS.coh_loss_random(pairs, torch.from_numpy(r), x)  # noqa: E731
        gj = np.asarray(jax.grad(jloss)(jnp.asarray(f)), np.float64)
        x = torch.from_numpy(f).requires_grad_()
        (gp,) = torch.autograd.grad(ploss(x), x)
        return gp.double().numpy(), gj

    gp64, gj64 = grads(np.float64)
    scale = np.abs(gj64).max()
    assert np.abs(gp64 - gj64).max() <= 1e-9 * scale
    gp32, gj32 = grads(np.float32)
    jax_err, port_err = np.abs(gj32 - gj64).max(), np.abs(gp32 - gj64).max()
    assert jax_err > 1e-5 * scale and port_err <= 2 * jax_err, (jax_err, port_err, scale)


def test_bench_formulations_agree_on_the_cpu(monkeypatch):
    """``tools/bench_cgan_conv.py``'s three formulations of the D trunk and
    the G stack compute the port's function: against ``ncw`` within 1e-5
    of the largest magnitude in float32 and one bfloat16 rounding per
    layer (5 · 2**-8) in bfloat16; ``ncw``'s D trunk is the port's
    ``disc_features`` (train mode). The timing needs a card."""
    from eegsynth_torch.tools import bench_cgan_conv as bench

    gen = torch.Generator().manual_seed(0)
    errors = bench.check(2, "cpu", gen)
    for (_, prec, _), err in errors.items():
        assert err <= (1e-5 if prec == "f32" else 5 * 2.0 ** -8), errors
    d_layers, _ = bench.make_weights(gen, "cpu")
    x = torch.rand((2, 14, 768), generator=gen)
    params = {f"c{i + 1}": p for i, p in enumerate(d_layers)}
    want, _ = P.disc_features(params, x)
    _close(bench.d_trunk("ncw", d_layers, x, torch.float32), want)
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(SystemExit, match="no CUDA device"):
        bench.main([])


def test_coherence_gradient_at_an_exact_zero_bin():
    """A constant channel has exactly-zero spectral bins: the JAX package's
    coherence gradient is NaN there (sqrt at 0), and one such bin makes a
    generator's update NaN. The port's gradient there is 0 (|z|'s
    subgradient), finite everywhere, the same loss value, and the same
    gradient, within 1e-9 in float64, wherever JAX's is finite."""
    from eegsynth.losses import spectral as JS
    from eegsynth_torch.losses import spectral as PS

    rng = np.random.default_rng(11)
    real = rng.uniform(0, 1, (B, 14, 96))
    fake = 0.5 + 0.05 * rng.standard_normal((B, 14, 96))
    fake[1, 0] = 0.5                       # channel 0 of pair (0, 13): constant
    labels = np.array([0, 3, 3, 7], np.int32)
    jloss = lambda x: JS.posture_conditional_losses(  # noqa: E731
        jnp.asarray(real), x, jnp.asarray(labels), 9, 0.0, 1.0, 0.0)
    gj = np.asarray(jax.grad(jloss)(jnp.asarray(fake)))
    x = torch.from_numpy(fake).requires_grad_()
    loss = PS.posture_conditional_losses(torch.from_numpy(real), x,
                                         torch.from_numpy(labels), 9, 0.0, 1.0, 0.0)
    (gp,) = torch.autograd.grad(loss, x)
    gp = gp.numpy()
    assert np.isnan(gj).any() and np.isfinite(gp).all()
    np.testing.assert_allclose(loss.item(), float(jloss(jnp.asarray(fake))), rtol=1e-12)
    ok = np.isfinite(gj)
    assert np.abs(gp[ok] - gj[ok]).max() <= 1e-9 * np.abs(gj[ok]).max()
