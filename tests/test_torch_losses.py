"""eegsynth_torch TimeGAN losses and statistics against the JAX package on
the same inputs: every loss, both branches of ``acf_per_channel`` (direct
slices for lags <= 96, the FFT above), the channel covariance and
correlation, and the stacked (leading bucket axis) forms against
``jax.vmap``. float32 on both sides."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from test_torch_threads import one_thread_each  # noqa: F401

from eegsynth.losses import timegan as jl
from eegsynth.ops.acf import acf_per_channel as j_acf
from eegsynth.ops.stats import channel_corrcoef as j_corr
from eegsynth.ops.stats import channel_cov as j_cov
from eegsynth_torch.losses import timegan as tl
from eegsynth_torch.ops.acf import acf_per_channel
from eegsynth_torch.ops.stats import channel_corrcoef, channel_cov

TOL = 1e-5   # float32, another summation order


def _x(shape, seed=0, lo=0.0, hi=1.0):
    return np.random.default_rng(seed).uniform(lo, hi, shape).astype(np.float32)


def _j(fn, *args):
    with jax.enable_x64(False):
        return np.asarray(fn(*(jnp.asarray(a) for a in args)))


def _t(fn, *args):
    out = fn(*(torch.from_numpy(a) for a in args))
    return out.detach().numpy()


@pytest.mark.parametrize("max_lag", [5, 48, 96, 97, 130])
def test_acf_both_branches(max_lag):
    x = _x((3, 200, 4), seed=max_lag)
    want = _j(lambda a: j_acf(a, max_lag), x)
    got = _t(lambda a: acf_per_channel(a, max_lag), x)
    assert got.shape == want.shape == (max_lag, 4)
    np.testing.assert_allclose(got, want, atol=TOL, rtol=TOL)


def test_acf_stacked_and_clipped_lag():
    x = _x((2, 3, 30, 4), seed=1)
    want = _j(lambda a: jax.vmap(lambda b: j_acf(b, 64))(a), x)   # lag clips to 29
    got = _t(lambda a: acf_per_channel(a, 64), x)
    assert got.shape == (2, 29, 4)
    np.testing.assert_allclose(got, want, atol=TOL, rtol=TOL)


def test_cov_and_corrcoef():
    x = _x((2, 5, 40, 6), seed=2)
    for jf, tf in ((j_cov, channel_cov), (j_corr, channel_corrcoef)):
        want = _j(lambda a: jax.vmap(jf)(a), x)
        np.testing.assert_allclose(_t(tf, x), want, atol=TOL, rtol=TOL)
    np.testing.assert_allclose(_t(channel_corrcoef, x[0]),
                               np.corrcoef(x[0].reshape(-1, 6), rowvar=False),
                               atol=1e-5)


def test_losses_match_jax():
    x, y = _x((2, 4, 30, 5), seed=3), _x((2, 4, 30, 5), seed=4)
    h = _x((2, 4, 30, 8), seed=5)
    cases = [
        (jl.recon_loss, tl.recon_loss, (x, y)),
        (jl.sup_loss, tl.sup_loss, (h,)),
        (jl.cov_loss, tl.cov_loss, (x, y)),
        (lambda a, b: jl.acf_loss(a, b, 12), lambda a, b: tl.acf_loss(a, b, 12),
         (x, y)),
    ]
    for jf, tf, args in cases:
        want = _j(lambda *a: jax.vmap(jf)(*a), *args)
        got = _t(tf, *args)
        assert got.shape == (2,)
        np.testing.assert_allclose(got, want, atol=TOL, rtol=TOL)


def test_bce_clamps_log():
    p = np.array([[[0.0], [0.3], [1.0], [0.999]]], np.float32)
    y = np.array([[[1.0], [0.2], [0.0], [1.0]]], np.float32)
    want = _j(lambda a, b: jax.vmap(jl.bce)(a, b), p, y)
    got = _t(tl.bce, p, y)
    np.testing.assert_allclose(got, want, rtol=1e-6)
    assert np.isfinite(got).all() and got[0] > 50      # log(0) clamped at -100


def test_labels_noise_throttle():
    u_r, u_f = _x((2, 4, 1), seed=6), _x((2, 4, 1), seed=7)
    real, fake = tl.smooth_labels(torch.from_numpy(u_r), torch.from_numpy(u_f), 0.2)
    np.testing.assert_allclose(real.numpy(), (1.0 - 0.2) + 0.2 * u_r, rtol=1e-7)
    np.testing.assert_allclose(fake.numpy(), 0.2 * u_f, rtol=1e-7)
    h, eps = _x((3, 5), seed=8), _x((3, 5), seed=9)
    np.testing.assert_allclose(
        tl.add_instance_noise(torch.from_numpy(h), torch.from_numpy(eps), 0.19).numpy(),
        h + np.float32(0.19) * eps, rtol=1e-7)
    acc = np.array([0.3, 0.565, 0.7, 1.0], np.float32)
    want = _j(lambda a: jl.throttle_scale(a, 0.565, 0.23), acc)
    np.testing.assert_allclose(_t(lambda a: tl.throttle_scale(a, 0.565, 0.23), acc),
                               want, rtol=1e-6)


def test_loss_gradients_match_jax():
    """Gradients of cov + ACF + recon through the fake side, as the G step
    takes them (the real side carries none)."""
    x, y = _x((3, 25, 4), seed=10), _x((3, 25, 4), seed=11)

    def jloss(a, b):
        return jl.cov_loss(a, b) + jl.acf_loss(a, b, 7) + jl.recon_loss(b, a)

    with jax.enable_x64(False):
        want = np.asarray(jax.grad(jloss)(jnp.asarray(x), jnp.asarray(y)))
    xt = torch.from_numpy(x).requires_grad_()
    yt = torch.from_numpy(y)
    (tl.cov_loss(xt, yt) + tl.acf_loss(xt, yt, 7) + tl.recon_loss(yt, xt)).backward()
    np.testing.assert_allclose(xt.grad.numpy(), want, atol=1e-6, rtol=1e-4)
