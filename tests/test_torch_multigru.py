"""K2 on the CPU: the plain version of the fused multi-network kernel against
the JAX package's ``multigru_disc_inputs_pallas`` in interpret mode, on the
same stacked parameters and inputs, the port's ``fused_disc_inputs``
against its own composed recurrences, and its route rule: the widths K2
takes (``k2_fits``), and the composed route for the others against the JAX
package's ``fused_disc_inputs``. The kernel itself is checked on the card by
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
from eegsynth_torch.nn.multigru import k2_fits, multigru_disc_inputs, smem_bytes
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


# the reference width, adaptive_dims' T > 800 width (both fit the H100's
# 232,448 B of opt-in shared memory per block), and 20 channels' z40/h80
@pytest.mark.parametrize("dims,fits", [((28, 56, 56, 28), True),
                                       ((36, 72, 72, 36), True),
                                       ((40, 80, 80, 40), False)])
def test_k2_fits(dims, fits):
    assert k2_fits(*dims, 232448) is fits


@pytest.mark.parametrize("route", ["composed", "k2_plain"])
def test_wide_disc_inputs_match_jax(route):
    """z40/h80 (20 channels), which K2 does not take on the H100:
    fused_disc_inputs takes the composed route there on every device (on
    the card 3 K1 forward launches), and it and K2's plain version both
    match the JAX package's vmapped fused_disc_inputs within 1e-5."""
    cfg = TimeGANConfig(x_dim=20, z_dim=40, h_dim=80)
    params, tp, x, z = _disc_inputs_case(cfg, 2, 5, 48, seed=3)
    assert not ttg._takes_k2(tp)
    run = ttg.fused_disc_inputs if route == "composed" else ttg._k2_disc_inputs
    before = multigru_disc_inputs.launches
    got = run(tp, torch.from_numpy(x), torch.from_numpy(z))
    assert multigru_disc_inputs.launches == before
    for g, w in zip(got, _jax_disc_inputs(params, x, z)):
        assert g.shape == (2, 5, 48, 40) and not g.requires_grad
        np.testing.assert_allclose(g.numpy(), w, atol=1e-5, rtol=0)


def test_shared_memory_budget():
    """The widths K2 takes: the reference width and adaptive_dims' T > 800
    width fit in the H100's 227 KB of opt-in shared memory per block."""
    # six weight matrices of 116,032 B / 191,808 B, plus biases and one row
    assert 116_032 < smem_bytes(28, 56, 56, 28) < 122_000
    assert 191_808 < smem_bytes(36, 72, 72, 36) < 200_000
    assert smem_bytes(36, 72, 72, 36, rows=9) < 232448   # nb 18, B 63: 9 rows
    assert smem_bytes(40, 80, 80, 40) > 232448        # C = 20: too wide
