"""K2 on the CPU: the plain version of the fused multi-network kernel against
the JAX package's ``multigru_disc_inputs_pallas`` in interpret mode, on the
same stacked parameters and inputs; a numpy emulation of the Hopper
kernel's arithmetic (``csrc/multigru.cu``) against the same; the port's
``fused_disc_inputs`` against its own composed recurrences; and its route
rule: every single-layer stack with projections at widths up to 128 takes
K2, the others the composed route, both against the JAX package's
``fused_disc_inputs``. The kernel itself is checked on the card by
tests/test_torch_card.py and chip_smoke.py."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from eegsynth.models.timegan import TimeGANConfig, timegan_init
from eegsynth.models.timegan import fused_disc_inputs as jax_fused_disc_inputs
from eegsynth.nn.pallas_multigru import multigru_disc_inputs_pallas
from eegsynth_torch.models import timegan as ttg
from eegsynth_torch.nn.multigru import multigru_disc_inputs
from eegsynth_torch.tree import tree_map

# float32 on both sides, another summation order over up to 16 steps
TOL = 2e-5


def _stacked(cfg, nb, seed=0):
    with jax.enable_x64(False):
        keys = jax.vmap(lambda i: jax.random.fold_in(jax.random.key(seed), i))(
            jnp.arange(nb))
        return jax.vmap(timegan_init, in_axes=(0, None))(keys, cfg)


@pytest.mark.parametrize("cfg,nb,B,T", [
    (TimeGANConfig(x_dim=5, z_dim=8, h_dim=12), 3, 4, 16),
    (TimeGANConfig(x_dim=14, z_dim=28, h_dim=56), 2, 3, 12),   # reference dims
    (TimeGANConfig(x_dim=20, z_dim=40, h_dim=80), 2, 3, 8),    # 20 channels
    (TimeGANConfig(x_dim=28, z_dim=64, h_dim=128), 2, 2, 6),   # the widest
])
def test_plain_matches_pallas_interpret(cfg, nb, B, T):
    params = _stacked(cfg, nb)
    rng = np.random.default_rng(nb)
    x = rng.uniform(0, 1, (nb, B, T, cfg.x_dim)).astype(np.float32)
    z = rng.uniform(0, 1, (nb, B, T, cfg.z_dim)).astype(np.float32)
    with jax.enable_x64(False):
        want_r, want_f = multigru_disc_inputs_pallas(params, jnp.asarray(x),
                                                     jnp.asarray(z), interpret=True)
    tp = tree_map(lambda a: torch.from_numpy(np.array(a)), params)
    before = multigru_disc_inputs.launches
    got_r, got_f = ttg.fused_disc_inputs(tp, torch.from_numpy(x), torch.from_numpy(z))
    assert multigru_disc_inputs.launches == before      # CPU: the plain version
    assert got_r.shape == (nb, B, T, cfg.z_dim) == got_f.shape
    np.testing.assert_allclose(got_r.numpy(), np.asarray(want_r), atol=TOL, rtol=TOL)
    np.testing.assert_allclose(got_f.numpy(), np.asarray(want_f), atol=TOL, rtol=TOL)


def test_fused_equals_composed():
    """fused_disc_inputs == (encode(x), refine_latent(gen_latent(z))) on the
    stacked tree: K2's six stages are the three networks' recurrences."""
    params = _stacked(TimeGANConfig(x_dim=3, z_dim=6, h_dim=10), 2, seed=1)
    tp = tree_map(lambda a: torch.from_numpy(np.array(a)), params)
    rng = np.random.default_rng(5)
    x = torch.from_numpy(rng.uniform(0, 1, (2, 3, 9, 3)).astype(np.float32))
    z = torch.from_numpy(rng.uniform(0, 1, (2, 3, 9, 6)).astype(np.float32))
    h_real, h_fake = ttg.fused_disc_inputs(tp, x, z)
    with torch.no_grad():
        torch.testing.assert_close(h_real, ttg.encode(tp, x), rtol=1e-5, atol=1e-6)
        torch.testing.assert_close(h_fake, ttg.refine_latent(tp, ttg.gen_latent(tp, z)),
                                   rtol=1e-5, atol=1e-6)


def _jax_disc_inputs(params, x, z):
    """The JAX package's fused_disc_inputs, vmapped over the bucket axis
    (its fused scan, or its composed fallback), in float32."""
    with jax.enable_x64(False):
        h_real, h_fake = jax.vmap(jax_fused_disc_inputs)(params, jnp.asarray(x),
                                                          jnp.asarray(z))
    return np.asarray(h_real), np.asarray(h_fake)


def _disc_inputs_case(cfg, nb, B, T, seed):
    params = _stacked(cfg, nb, seed=seed)
    rng = np.random.default_rng(seed)
    x = rng.uniform(0, 1, (nb, B, T, cfg.x_dim)).astype(np.float32)
    z = rng.uniform(0, 1, (nb, B, T, cfg.z_dim)).astype(np.float32)
    tp = tree_map(lambda a: torch.from_numpy(np.array(a)), params)
    return params, tp, x, z


def test_identity_projection_raises():
    """A stack without projections (h_dim == z_dim) raised here before K2's
    route got its rule; it now takes the composed networks and matches the
    JAX package's fused_disc_inputs."""
    params, tp, x, z = _disc_inputs_case(TimeGANConfig(x_dim=3, z_dim=8, h_dim=8),
                                         2, 3, 12, seed=2)
    assert not ttg._takes_k2(tp)
    got = ttg.fused_disc_inputs(tp, torch.from_numpy(x), torch.from_numpy(z))
    for g, w in zip(got, _jax_disc_inputs(params, x, z)):
        np.testing.assert_allclose(g.numpy(), w, atol=1e-5, rtol=0)


# adaptive_dims' widths from 8 to 32 channels take K2; past 128, without
# projections (h_dim == z_dim) or with two layers the composed route
@pytest.mark.parametrize("cfg,takes", [
    (ttg.TimeGANConfig(x_dim=8, z_dim=16, h_dim=32), True),
    (ttg.TimeGANConfig(x_dim=14, z_dim=28, h_dim=56), True),
    (ttg.TimeGANConfig(x_dim=20, z_dim=40, h_dim=80), True),
    (ttg.TimeGANConfig(x_dim=32, z_dim=64, h_dim=128), True),
    (ttg.TimeGANConfig(x_dim=32, z_dim=64, h_dim=129), False),
    (ttg.TimeGANConfig(x_dim=3, z_dim=8, h_dim=12, num_layers=2), False),
    (ttg.TimeGANConfig(x_dim=3, z_dim=8, h_dim=8), False),
])
def test_k2_route_rule(cfg, takes):
    params = ttg.timegan_init_stacked(cfg, [torch.Generator().manual_seed(0)],
                                      device="cpu")
    assert ttg._takes_k2(params) is takes


@pytest.mark.parametrize("route", ["composed", "k2_plain"])
def test_wide_disc_inputs_match_jax(route):
    """z40/h80 (20 channels), which K2 takes on every device since it runs
    its cells on a cluster: fused_disc_inputs' route through K2 (its plain
    version here) and the composed networks (encode, refine_latent ∘
    gen_latent) both match the JAX package's vmapped fused_disc_inputs
    within 1e-5."""
    cfg = TimeGANConfig(x_dim=20, z_dim=40, h_dim=80)
    params, tp, x, z = _disc_inputs_case(cfg, 2, 5, 48, seed=3)
    assert ttg._takes_k2(tp)
    x, z = torch.from_numpy(x), torch.from_numpy(z)
    before = multigru_disc_inputs.launches
    if route == "composed":
        with torch.no_grad():
            got = ttg.encode(tp, x), ttg.refine_latent(tp, ttg.gen_latent(tp, z))
    else:
        got = ttg.fused_disc_inputs(tp, x, z)
    assert multigru_disc_inputs.launches == before
    for g, w in zip(got, _jax_disc_inputs(params, x.numpy(), z.numpy())):
        assert g.shape == (2, 5, 48, 40) and not g.requires_grad
        np.testing.assert_allclose(g.numpy(), w, atol=1e-5, rtol=0)


def _sigmoid_fwd(x):
    return (np.float32(0.5) * np.tanh(np.float32(0.5) * x) + np.float32(0.5)).astype(
        np.float32)


def _sliced_dot(v, w, kl, s):
    """v (R, K) @ w (K, N) as the kernel sums it: each of S lanes a chain of
    multiply-adds over its kl-long slice of K from zero (v and w padded with
    zeros), then the lanes' partial sums added pairwise at distance S/2,
    S/4, ... (the butterfly). A multiply-add is rounded once from float64,
    as fmaf is (within double rounding)."""
    R, K = v.shape
    vp = np.zeros((R, s * kl), np.float32)
    vp[:, :K] = v
    wp = np.zeros((s * kl, w.shape[1]), np.float32)
    wp[:K] = w
    v_sl = vp.reshape(R, s, kl).transpose(1, 0, 2).astype(np.float64)
    w_sl = wp.reshape(s, kl, -1).astype(np.float64)
    part = np.zeros((s, R, w.shape[1]), np.float32)
    for k in range(kl):
        part = (v_sl[:, :, k, None] * w_sl[:, None, k, :] + part).astype(np.float32)
    while len(part) > 1:
        half = len(part) // 2
        part = part[:half] + part[half:]
    return part[0]


def _cell(x, acc, b, h):
    H = h.shape[-1]
    r = _sigmoid_fwd(x[:, :H] + (acc[:, :H] + b[:H]))
    z = _sigmoid_fwd(x[:, H:2 * H] + (acc[:, H:2 * H] + b[H:2 * H]))
    n = np.tanh(x[:, 2 * H:] + r * (acc[:, 2 * H:] + b[2 * H:]))
    return ((1 - z) * n + z * h).astype(np.float32)


def _k2_kernel_order(xp_e, xp_g, w_e, b_e, w_g, b_g, w_pg, b_pg, w_is, b_is, w_s,
                     b_s, w_ps, b_ps):
    """K2's arithmetic in the Hopper kernel's order (csrc/multigru.cu), one
    bucket, numpy float32: K1 forward's instance for the widest width (KL 16
    up to 64, 32 up to 96, 64 up to 128; S the power of two at or above
    ceil(width / KL)) for every sum; the cells' sums and the two output
    projections over KL-long slices of h, e W_is over slices of KLZ =
    ceil(Z / S) rounded up to 4; a bias added to its sum, then the gates with
    the kernel's sigmoid 1/2 + tanh(x/2)/2. S's gates take (s_in + b_is) +
    (h_s W_s + b_s)."""
    T, B, _ = xp_e.shape
    He, Hg, Hs, Z = w_e.shape[0], w_g.shape[0], w_s.shape[0], w_pg.shape[1]
    hmax = max(He, Hg, Hs, Z)
    kl = 16 if hmax <= 64 else 32 if hmax <= 96 else 64
    s = 1
    while s * kl < hmax:
        s *= 2
    c = -(-Z // s)                  # ceil(Z / S)
    klz = -(-c // 4) * 4            # rounded up to 4
    h_e = np.zeros((B, He), np.float32)
    h_g = np.zeros((B, Hg), np.float32)
    h_s = np.zeros((B, Hs), np.float32)
    real = np.empty((T, B, He), np.float32)
    fake = np.empty((T, B, Z), np.float32)
    for t in range(T):
        h_e = _cell(xp_e[t], _sliced_dot(h_e, w_e, kl, s), b_e, h_e)
        h_g = _cell(xp_g[t], _sliced_dot(h_g, w_g, kl, s), b_g, h_g)
        e = _sliced_dot(h_g, w_pg, kl, s) + b_pg
        s_in = _sliced_dot(e, w_is, klz, s) + b_is
        h_s = _cell(s_in, _sliced_dot(h_s, w_s, kl, s), b_s, h_s)
        real[t] = h_e
        fake[t] = _sliced_dot(h_s, w_ps, kl, s) + b_ps
    return real, fake


# the reference width (KL 16, S 4), then one width of each other instance:
# KL 16 with S 1 and 2, KL 32 (z40/h80, KLZ 12), KL 64 (z64/h128, KLZ 32)
@pytest.mark.parametrize("cfg", [TimeGANConfig(x_dim=14, z_dim=28, h_dim=56),
                                 TimeGANConfig(x_dim=3, z_dim=8, h_dim=16),
                                 TimeGANConfig(x_dim=8, z_dim=16, h_dim=32),
                                 TimeGANConfig(x_dim=20, z_dim=40, h_dim=80),
                                 TimeGANConfig(x_dim=28, z_dim=64, h_dim=128)])
def test_kernel_order_matches_pallas_interpret(cfg):
    """The emulated kernel order stays within the card tests' 1e-4 of the
    Pallas kernel in interpret mode."""
    nb, B, T = 2, 3, 10
    params = _stacked(cfg, nb, seed=4)
    rng = np.random.default_rng(4)
    x = rng.uniform(0, 1, (nb, B, T, cfg.x_dim)).astype(np.float32)
    z = rng.uniform(0, 1, (nb, B, T, cfg.z_dim)).astype(np.float32)
    with jax.enable_x64(False):
        want_r, want_f = multigru_disc_inputs_pallas(params, jnp.asarray(x),
                                                     jnp.asarray(z), interpret=True)
    tp = tree_map(lambda a: torch.from_numpy(np.array(a)), params)
    args = [a.numpy() for a in ttg.k2_inputs(tp, torch.from_numpy(x), torch.from_numpy(z))]
    for k in range(nb):
        real, fake = _k2_kernel_order(*(a[k] for a in args))
        np.testing.assert_allclose(real.transpose(1, 0, 2), np.asarray(want_r)[k],
                                   rtol=0, atol=1e-4)
        np.testing.assert_allclose(fake.transpose(1, 0, 2), np.asarray(want_f)[k],
                                   rtol=0, atol=1e-4)
