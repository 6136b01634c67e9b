"""eegsynth_torch's transformer CGAN against eegsynth's on the same
parameters and inputs (CPU, float32 on both sides): the generator and the
discriminator (train and eval mode, v1 and v2 with a passed dropout mask,
the local crop), the generator through flash attention (plain versions on
the CPU) against JAX's dense path, and R1 through the discriminator with the
attention impl forced to flash. Every generator starts from perturbed adaLN
weights: at init the adaLN-zero gates keep attention out of the output."""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from test_torch_threads import one_thread_each  # noqa: F401

from eegsynth.models import cgan_transformer as J
from eegsynth.nn.attention import set_attention_impl as jax_set_impl
from eegsynth_torch.convert import tree_to_device
from eegsynth_torch.models import cgan_transformer as P
from eegsynth_torch.nn.attention import set_attention_impl
from eegsynth_torch.tree import tree_leaves

TINY = dict(dim=32, depth=2, heads=2, patch=8)
B = 4
# float32 on both sides, sums in another order: outputs within 2e-5
# (scores and logits are O(1)), features within 2e-5
TOL = 2e-5


def _cfgs(**kw):
    return J.TransformerCGANConfig(**TINY, **kw), P.TransformerCGANConfig(**TINY, **kw)


def _port(tree):
    return tree_to_device(jax.tree.map(np.asarray, tree), device="cpu")


def _perturbed_generator(cfg, seed=0):
    """A JAX generator whose adaLN heads are non-zero (as after training)."""
    G, bn = J.generator_init(jax.random.key(seed), cfg)
    ks = jax.random.split(jax.random.key(100 + seed), cfg.depth + 1)
    for i in range(cfg.depth):
        G[f"blk{i}"]["ada"]["w"] = 0.1 * jax.random.normal(ks[i], G[f"blk{i}"]["ada"]["w"].shape)
        G[f"blk{i}"]["ada"]["b"] = 0.05 * jax.random.normal(ks[i], G[f"blk{i}"]["ada"]["b"].shape)
    G["head_ada"]["w"] = 0.1 * jax.random.normal(ks[-1], G["head_ada"]["w"].shape)
    return G, bn


def _inputs(cfg, seed=0):
    rng = np.random.default_rng(seed)
    z = rng.standard_normal((B, cfg.noise_dim)).astype(np.float32)
    labels = rng.integers(0, cfg.num_classes, B).astype(np.int32)
    x = rng.uniform(0, 1, (B, cfg.channels, cfg.seq_len)).astype(np.float32)
    return z, labels, x


@pytest.mark.parametrize("variant,K", [("v1", 9), ("v2", 2)])
def test_generator_matches_jax(variant, K):
    jcfg, pcfg = _cfgs(num_classes=K, variant=variant)
    z, labels, _ = _inputs(jcfg)
    with jax.enable_x64(False):
        G, bn = _perturbed_generator(jcfg)
        want = np.asarray(J.generator_apply(G, bn, jnp.asarray(z), jnp.asarray(labels),
                                            jcfg)[0])
    got, state = P.generator_apply(_port(G), {}, torch.from_numpy(z),
                                   torch.from_numpy(labels).long(), pcfg)
    assert got.shape == (B, 14, 768) and state == {}
    np.testing.assert_allclose(got.numpy(), want, atol=TOL, rtol=0)
    # the perturbed gates let the class reach the output
    other, _ = P.generator_apply(_port(G), {}, torch.from_numpy(z),
                                 (torch.from_numpy(labels).long() + 1) % K, pcfg)
    assert (other - got).abs().max().item() > 1e-5


def test_generator_through_flash_matches_jax_dense():
    """The port's generator with flash forced (on the CPU: the kernels'
    plain versions, through FlashAttention's backward too) against JAX's
    dense attention: outputs and parameter gradients."""
    jcfg, pcfg = _cfgs(num_classes=9)
    z, labels, _ = _inputs(jcfg, seed=1)
    w = np.random.default_rng(2).standard_normal((B, 14, 768)).astype(np.float32)
    with jax.enable_x64(False):
        G, bn = _perturbed_generator(jcfg, seed=1)

        def loss(G):
            x = J.generator_apply(G, bn, jnp.asarray(z), jnp.asarray(labels), jcfg)[0]
            return jnp.sum(x * w)
        want_loss, want_grads = jax.value_and_grad(loss)(G)
    tG = {k: v for k, v in _port(G).items()}
    leaves = tree_leaves(tG)
    for t in leaves:
        t.requires_grad_()
    set_attention_impl("flash")
    try:
        x, _ = P.generator_apply(tG, {}, torch.from_numpy(z),
                                 torch.from_numpy(labels).long(), pcfg)
        got_loss = (x * torch.from_numpy(w)).sum()
        grads = torch.autograd.grad(got_loss, leaves)
    finally:
        set_attention_impl("auto")
    np.testing.assert_allclose(got_loss.item(), float(want_loss), rtol=1e-5)
    for g, gw in zip(grads, jax.tree.leaves(want_grads)):
        gw = np.asarray(gw)
        np.testing.assert_allclose(g.numpy(), gw, rtol=0,
                                   atol=1e-4 * max(1.0, np.abs(gw).max()))


@pytest.mark.parametrize("variant,K,train,T", [
    ("v1", 9, True, 768), ("v1", 9, False, 768), ("v1", 9, True, 256),
    ("v2", 2, True, 768), ("v2", 2, False, 256)])
def test_discriminator_matches_jax(variant, K, train, T):
    jcfg, pcfg = _cfgs(num_classes=K, variant=variant)
    _, labels, x = _inputs(jcfg, seed=3)
    x = x[:, :, :T]
    with jax.enable_x64(False):
        D = J.disc_init(jax.random.key(4), jcfg)
        key = jax.random.key(5)
        keep = np.asarray(jax.random.bernoulli(key, 1.0 - jcfg.dropout, (B, jcfg.dim)))
        want = J.disc_apply(D, jnp.asarray(x), jnp.asarray(labels), jcfg, train=train,
                            dropout_key=key)
    got = P.disc_apply(_port(D), torch.from_numpy(x), torch.from_numpy(labels).long(),
                       pcfg, train=train, dropout_keep=torch.from_numpy(np.array(keep)))
    for a, b in zip(got[:3], want[:3]):
        np.testing.assert_allclose(a.numpy(), np.asarray(b), atol=TOL, rtol=0)
    for head in ("fc", "cls"):       # u advances in train mode only
        np.testing.assert_allclose(got[3][head]["u"].numpy(),
                                   np.asarray(want[3][head]["u"]), atol=1e-6, rtol=0)
    if train and K == 9:
        assert not torch.equal(got[3]["cls"]["u"], _port(D)["cls"]["u"])
    f, params = P.disc_features(_port(D), torch.from_numpy(x), cfg=pcfg)
    assert f.shape == (B, 32)


def test_v2_train_mode_needs_a_keep_mask():
    _, pcfg = _cfgs(num_classes=2, variant="v2")
    D = P.disc_init(pcfg, torch.Generator().manual_seed(0), device="cpu")
    x = torch.rand((B, 14, 768))
    with pytest.raises(ValueError, match="keep mask"):
        P.disc_apply(D, x, torch.zeros(B, dtype=torch.long), pcfg, train=True)
    s, *_ = P.disc_apply(D, x, torch.zeros(B, dtype=torch.long), pcfg, train=False)
    assert torch.isfinite(s).all()


def test_disc_refuses_a_compute_dtype():
    """The discriminator takes the conv model's arguments, but it has no
    reduced-precision trunk: a compute dtype raises, none runs as before."""
    _, pcfg = _cfgs()
    D = P.disc_init(pcfg, torch.Generator().manual_seed(0), device="cpu")
    x, labels = torch.rand((B, 14, 768)), torch.zeros(B, dtype=torch.long)
    with pytest.raises(ValueError, match="parameters' dtype"):
        P.disc_apply(D, x, labels, pcfg, False, None, compute_dtype=torch.bfloat16)
    s, *_ = P.disc_apply(D, x, labels, pcfg, False, None, compute_dtype=None)
    assert torch.isfinite(s).all()


def test_r1_with_flash_forced_matches_jax():
    """R1 differentiates the discriminator twice; with the impl forced to
    flash in both packages, the D still takes dense attention, so R1 and its
    parameter gradient work and agree."""
    jcfg, pcfg = _cfgs(num_classes=9)
    _, labels, x = _inputs(jcfg, seed=6)
    with jax.enable_x64(False):
        D = J.disc_init(jax.random.key(7), jcfg)

        def r1(D):
            g = jax.grad(lambda xx: jnp.sum(J.disc_apply(D, xx, jnp.asarray(labels), jcfg,
                                                         train=False)[0]))(jnp.asarray(x))
            return 0.5 * jnp.mean(jnp.sum(g.reshape(B, -1) ** 2, axis=1))
        jax_set_impl("pallas")
        try:
            want, want_g = jax.value_and_grad(r1)(D)
        finally:
            jax_set_impl("auto")
    tD = _port(D)
    w = tD["embed_in"]["w"].requires_grad_()
    set_attention_impl("flash")
    try:
        xx = torch.from_numpy(x).requires_grad_()
        score = P.disc_apply(tD, xx, torch.from_numpy(labels).long(), pcfg, train=False)[0]
        (g,) = torch.autograd.grad(score.sum(), xx, create_graph=True)
        got = 0.5 * g.reshape(B, -1).pow(2).sum(1).mean()
        (gw,) = torch.autograd.grad(got, w)
    finally:
        set_attention_impl("auto")
    np.testing.assert_allclose(got.item(), float(want), rtol=1e-4)
    want_w = np.asarray(want_g["embed_in"]["w"])
    np.testing.assert_allclose(gw.numpy(), want_w, rtol=0,
                               atol=1e-4 * np.abs(want_w).max())


def test_init_shapes_match_jax_and_adaln_zero():
    jcfg, pcfg = _cfgs(num_classes=9)
    with jax.enable_x64(False):
        G, _ = J.generator_init(jax.random.key(0), jcfg)
        D = J.disc_init(jax.random.key(1), jcfg)
    tG, _ = P.generator_init(pcfg, torch.Generator().manual_seed(0), device="cpu")
    tD = P.disc_init(pcfg, torch.Generator().manual_seed(1), device="cpu")
    for mine, theirs in ((tG, G), (tD, D)):
        got = [(k, tuple(v.shape)) for k, v in _flat(mine)]
        want = [(jax.tree_util.keystr(p), tuple(v.shape))
                for p, v in jax.tree_util.tree_flatten_with_path(theirs)[0]]
        assert got == want
    assert all(float(t.abs().max()) == 0.0 for t in
               (tG["blk0"]["ada"]["w"], tG["head_ada"]["w"], tD["std_weight"]))
    # torch_dense_init's bound: U(±1/√in)
    assert tG["cond2"]["w"].abs().max().item() <= 32 ** -0.5
    assert abs(float(tD["fc"]["u"].norm()) - 1.0) < 1e-6
    # remat=True builds, and the remat D's features equal the plain D's
    rcfg = dataclasses.replace(pcfg, remat=True)
    x = torch.rand((2, pcfg.channels, pcfg.seq_len), generator=torch.Generator().manual_seed(2))
    assert torch.equal(P.disc_features(tD, x, cfg=rcfg)[0],
                       P.disc_features(tD, x, cfg=pcfg)[0])


def _flat(tree, prefix=""):
    if isinstance(tree, dict):
        return [kv for k in sorted(tree) for kv in _flat(tree[k], f"{prefix}[{k!r}]")]
    return [(prefix, tree)]
