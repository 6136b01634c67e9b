"""K2 on the CPU: the plain version of the fused multi-network kernel against
the JAX package's ``multigru_disc_inputs_pallas`` in interpret mode, on the
same stacked parameters and inputs, and the port's ``fused_disc_inputs``
against its own composed recurrences. The kernel itself is checked on the
card by tests/test_torch_card.py and chip_smoke.py."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from eegsynth.models.timegan import TimeGANConfig, timegan_init
from eegsynth.nn.pallas_multigru import multigru_disc_inputs_pallas
from eegsynth_torch.models import timegan as ttg
from eegsynth_torch.nn.multigru import multigru_disc_inputs, smem_bytes
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


def test_identity_projection_raises():
    params = _stacked(TimeGANConfig(x_dim=3, z_dim=8, h_dim=8), 1)
    tp = tree_map(lambda a: torch.from_numpy(np.array(a)), params)
    with pytest.raises(ValueError, match="projections"):
        ttg.fused_disc_inputs(tp, torch.zeros(1, 2, 4, 3), torch.zeros(1, 2, 4, 8))


def test_shared_memory_budget():
    """The widths K2 takes: the reference width and adaptive_dims' T > 800
    width fit in the H100's 227 KB of opt-in shared memory per block."""
    # six weight matrices of 116,032 B / 191,808 B, plus biases and one row
    assert 116_032 < smem_bytes(28, 56, 56, 28) < 122_000
    assert 191_808 < smem_bytes(36, 72, 72, 36) < 200_000
    assert smem_bytes(36, 72, 72, 36, rows=9) < 232448   # nb 18, B 63: 9 rows
    assert smem_bytes(40, 80, 80, 40) > 232448        # C = 20: too wide
