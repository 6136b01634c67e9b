"""eegsynth_torch's CGAN losses against eegsynth's on the same inputs (CPU,
float32 on both sides): the GAN objectives, the gradient penalty on
replayed interpolation weights, the spectral structure losses (the random
coherence pairs replayed from JAX's permutation), the posture-conditional
losses with their zero-weight gating, and DiffAugment-1D on replayed draws."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from test_torch_threads import one_thread_each  # noqa: F401

from eegsynth.losses import augment as JA
from eegsynth.losses import gan as JG
from eegsynth.losses import spectral as JS
from eegsynth_torch.losses import augment as PA
from eegsynth_torch.losses import gan as PG
from eegsynth_torch.losses import spectral as PS

B, C, T = 6, 14, 128
# float32 on both sides, sums and FFTs in another order
RTOL, ATOL = 2e-5, 1e-6


def _x(seed, shape=(B, C, T)):
    return np.random.default_rng(seed).uniform(0, 1, shape).astype(np.float32)


def _close(got, want, rtol=RTOL, atol=ATOL):
    np.testing.assert_allclose(np.asarray(got.detach()), np.asarray(want),
                               rtol=rtol, atol=atol)


@pytest.mark.parametrize("name", ["d_hinge", "d_bce", "d_wgan"])
def test_discriminator_objectives(name):
    r, f = (np.random.default_rng(s).standard_normal((B, 1)).astype(np.float32)
            for s in (0, 1))
    with jax.enable_x64(False):
        want = getattr(JG, name)(jnp.asarray(r), jnp.asarray(f))
    _close(getattr(PG, name)(torch.from_numpy(r), torch.from_numpy(f)), want)


@pytest.mark.parametrize("name", ["g_hinge", "g_bce", "g_wgan"])
def test_generator_objectives(name):
    f = np.random.default_rng(2).standard_normal((B, 1)).astype(np.float32)
    with jax.enable_x64(False):
        want = getattr(JG, name)(jnp.asarray(f))
    _close(getattr(PG, name)(torch.from_numpy(f)), want)


def test_cross_entropy_feature_matching_amp():
    rng = np.random.default_rng(3)
    logits = rng.standard_normal((B, 9)).astype(np.float32)
    labels = rng.integers(0, 9, B).astype(np.int32)
    ff, rf = (rng.standard_normal((B, 16)).astype(np.float32) for _ in range(2))
    real, fake = _x(4), _x(5)
    with jax.enable_x64(False):
        ce = JG.cross_entropy(jnp.asarray(logits), jnp.asarray(labels))
        fm = JG.feature_matching(jnp.asarray(ff), jnp.asarray(rf))
        amp = JG.amp_calib_loss(jnp.asarray(real), jnp.asarray(fake))
    _close(PG.cross_entropy(torch.from_numpy(logits), torch.from_numpy(labels)), ce)
    _close(PG.feature_matching(torch.from_numpy(ff), torch.from_numpy(rf)), fm)
    _close(PG.amp_calib_loss(torch.from_numpy(real), torch.from_numpy(fake)), amp)


def test_gradient_penalty_on_replayed_eps():
    """A linear-plus-square critic in both packages, ε from JAX's draw."""
    real, fake = _x(6), _x(7)
    w = np.random.default_rng(8).standard_normal((C, T)).astype(np.float32)
    key = jax.random.key(9)
    with jax.enable_x64(False):
        want = JG.gradient_penalty(
            lambda x: jnp.sum(x * w, axis=(1, 2)) + jnp.sum(x ** 2, axis=(1, 2)),
            key, jnp.asarray(real), jnp.asarray(fake))
        eps = np.asarray(jax.random.uniform(key, (B, 1, 1), jnp.float32))
    tw = torch.from_numpy(w).requires_grad_()
    got = PG.gradient_penalty(lambda x: (x * tw).sum((1, 2)) + (x ** 2).sum((1, 2)),
                              torch.from_numpy(np.array(eps)), torch.from_numpy(real),
                              torch.from_numpy(fake))
    _close(got, want)
    (g,) = torch.autograd.grad(got, tw)       # differentiable in the critic
    assert torch.isfinite(g).all() and g.abs().max() > 0


def test_spectral_losses():
    real, fake = _x(10, (B, C, 768)), _x(11, (B, C, 768))
    key = jax.random.key(12)
    with jax.enable_x64(False):
        args = (jnp.asarray(real), jnp.asarray(fake))
        want = {"psd": JS.psd_loss(*args), "log_psd": JS.log_psd_loss(*args),
                "coh": JS.coh_loss(*args, JS.FIXED_PAIRS), "cov": JS.cov_loss(*args),
                "coh_random": JS.coh_loss_random(key, *args, 24)}
        perm = np.asarray(jax.random.permutation(key, len(JS.ALL_PAIRS))[:24])
    r, f = torch.from_numpy(real), torch.from_numpy(fake)
    _close(PS.psd_loss(r, f), want["psd"], rtol=1e-4)
    _close(PS.log_psd_loss(r, f), want["log_psd"], rtol=1e-4)
    _close(PS.coh_loss(r, f, PS.FIXED_PAIRS), want["coh"], rtol=1e-4)
    _close(PS.cov_loss(r, f), want["cov"], rtol=1e-4)
    pairs = torch.from_numpy(PS.ALL_PAIRS[perm])
    _close(PS.coh_loss_random(pairs, r, f), want["coh_random"], rtol=1e-4)
    drawn = PS.draw_coh_pairs(torch.Generator().manual_seed(0), 24, device="cpu")
    assert drawn.shape == (24, 2) and len({tuple(p) for p in drawn.tolist()}) == 24


@pytest.mark.parametrize("weights", [(0.5, 0.25, 0.25, 0.0), (0.0, 0.8, 0.0, 0.3),
                                     (0.0, 0.0, 0.0, 0.0)])
def test_posture_conditional_losses(weights):
    """Two classes of the nine absent, one present once; the zero weights
    drop their components in both packages."""
    real, fake = _x(13, (8, C, 768)), _x(14, (8, C, 768))
    labels = np.array([0, 0, 3, 3, 3, 5, 8, 8], np.int32)
    with jax.enable_x64(False):
        want = JS.posture_conditional_losses(jnp.asarray(real), jnp.asarray(fake),
                                             jnp.asarray(labels), 9, *weights)
    got = PS.posture_conditional_losses(torch.from_numpy(real), torch.from_numpy(fake),
                                        torch.from_numpy(labels), 9, *weights)
    _close(got, want, rtol=1e-4)
    if not any(weights):
        assert got.item() == 0.0


def _replay_augment(key, B, T, p):
    """The seven draws of eegsynth's diffaugment_1d, from its own splits."""
    k_c1, k_c2, k_c3, k_shift, k_scale, k_bias, k_start = jax.random.split(key, 7)
    w = max(1, int(0.05 * T))
    draws = dict(
        do_shift=jax.random.uniform(k_c1) < p,
        shift=jax.random.randint(k_shift, (), -8, 9),
        do_jitter=jax.random.uniform(k_c2) < p,
        scale=0.9 + 0.2 * jax.random.uniform(k_scale, (B, 1, 1), jnp.float32),
        bias=0.02 * jax.random.normal(k_bias, (B, 1, 1), jnp.float32),
        do_cutout=jax.random.uniform(k_c3) < p,
        start=jax.random.randint(k_start, (B, 1, 1), 0, T - w))
    return PA.AugmentDraws(**{k: torch.from_numpy(np.array(v)) for k, v in draws.items()})


@pytest.mark.parametrize("seed,p", [(0, 0.25), (1, 0.5), (2, 1.0), (3, 0.0)])
def test_diffaugment_on_replayed_draws(seed, p):
    x = _x(20 + seed, (B, C, 768))
    key = jax.random.key(seed)
    with jax.enable_x64(False):
        want = np.asarray(JA.diffaugment_1d(key, jnp.asarray(x), p))
        draws = _replay_augment(key, B, 768, p)
    got = PA.diffaugment_1d(torch.from_numpy(x), draws)
    np.testing.assert_allclose(got.numpy(), want, rtol=0, atol=1e-7)
    if p == 1.0:
        assert not np.array_equal(got.numpy(), x)


def test_draw_augment_ranges():
    d = PA.draw_augment(torch.Generator().manual_seed(0), 64, 768, 0.5, device="cpu")
    assert -8 <= int(d.shift) <= 8 and d.do_shift.dtype == torch.bool
    assert d.scale.shape == (64, 1, 1) and 0.9 <= d.scale.min() and d.scale.max() < 1.1
    assert 0 <= int(d.start.min()) and int(d.start.max()) < 768 - 38
