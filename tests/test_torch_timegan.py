"""eegsynth_torch TimeGAN against the JAX package on the same params and noise:
the serving cascade (one-shot and chunked), the composed functions, the
identity-projection configuration, and the params round trip."""

import sys
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from eegsynth.models import timegan as jtg
from eegsynth.nn.spectral_norm import sn_dense_apply
from eegsynth.train.timegan import _synth_run, _synth_step
from eegsynth_torch.convert import from_jax_params, to_jax_params
from eegsynth_torch.models import timegan as ttg
from eegsynth_torch.train.timegan import synthesize, synthesize_from_noise

sys.path.insert(0, str(Path(__file__).resolve().parent.parent / "scripts"))

FULL = jtg.TimeGANConfig(x_dim=14, z_dim=28, h_dim=56)


def _params(cfg, seed=0):
    """JAX init, as numpy float32 (conftest enables x64)."""
    p = jtg.timegan_init(jax.random.key(seed), cfg)
    return jax.tree.map(lambda a: np.asarray(a, np.float32), p)


def _noise(shape, seed=0):
    return np.random.default_rng(seed).uniform(0, 1, shape).astype(np.float32)


def test_full_width_cascade_matches_synth_run():
    """fused_gen_refine(with_decode=True) == JAX _synth_run at x14/z28/h56."""
    p = _params(FULL)
    model = from_jax_params(p, device="cpu")
    z = _noise((3, 48, FULL.z_dim))
    ref = np.asarray(_synth_run(p, jnp.asarray(z)))
    with torch.inference_mode():
        h_hat, x_hat = ttg.fused_gen_refine(model, torch.from_numpy(z),
                                            with_decode=True)
    assert x_hat.shape == (3, 48, FULL.x_dim) and h_hat.shape == (3, 48, FULL.z_dim)
    np.testing.assert_allclose(x_hat.numpy(), ref, atol=5e-5)
    ref_h = np.asarray(jtg.fused_gen_refine(p, jnp.asarray(z)))
    np.testing.assert_allclose(h_hat.numpy(), ref_h, atol=5e-5)


def _chunked(model, z, sizes):
    carry = ttg.cascade_init_carry(model, z.shape[0], device="cpu")
    hs, xs, t0 = [], [], 0
    with torch.inference_mode():
        for n in sizes:
            carry, (h, x) = ttg.gen_refine_carry(model, z[:, t0:t0 + n], carry,
                                                 with_decode=True)
            hs.append(h)
            xs.append(x)
            t0 += n
    return carry, torch.cat(hs, 1), torch.cat(xs, 1)


def test_chunked_equals_one_shot():
    model = from_jax_params(_params(FULL), device="cpu")
    z = torch.from_numpy(_noise((3, 48, FULL.z_dim), seed=1))
    with torch.inference_mode():
        ref_h, ref_x = ttg.fused_gen_refine(model, z, with_decode=True)
    _, h, x = _chunked(model, z, (16, 16, 16))
    np.testing.assert_allclose(h.numpy(), ref_h.numpy(), atol=1e-6)
    np.testing.assert_allclose(x.numpy(), ref_x.numpy(), atol=1e-6)


def test_chunked_matches_synth_step():
    """Chunks with carried state against JAX _synth_step chained over the
    same chunks, carry included."""
    p = _params(FULL, seed=2)
    model = from_jax_params(p, device="cpu")
    z = _noise((2, 40, FULL.z_dim), seed=2)
    sizes = (16, 16, 8)
    carry = jtg.cascade_init_carry(p, 2, jnp.float32)
    xs, t0 = [], 0
    for n in sizes:
        x, carry = _synth_step(p, jnp.asarray(z[:, t0:t0 + n]), carry)
        xs.append(np.asarray(x))
        t0 += n
    got_carry, _, got_x = _chunked(model, torch.from_numpy(z), sizes)
    np.testing.assert_allclose(got_x.numpy(), np.concatenate(xs, 1), atol=5e-5)
    for a, b in zip(got_carry, carry):
        np.testing.assert_allclose(a.numpy(), np.asarray(b), atol=5e-5)


def test_synthesize_from_noise_carry_matches_synth_step():
    p = _params(FULL, seed=3)
    model = from_jax_params(p, device="cpu")
    z = _noise((2, 24, FULL.z_dim), seed=3)
    x_ref, _ = _synth_step(p, jnp.asarray(z), jtg.cascade_init_carry(p, 2))
    x, carry = synthesize_from_noise(model, torch.from_numpy(z))
    np.testing.assert_allclose(x.numpy(), np.asarray(x_ref), atol=5e-5)
    assert [tuple(c.shape) for c in carry] == [(2, 56), (2, 56), (2, 56)]


def test_identity_projection():
    """h_dim == z_dim: generator/supervisor projections are Identity."""
    cfg = jtg.TimeGANConfig(x_dim=4, z_dim=16, h_dim=16)
    p = _params(cfg, seed=4)
    assert p["generator"]["proj"] is None
    model = from_jax_params(p, device="cpu")
    assert isinstance(model.generator.proj, torch.nn.Identity)
    z = _noise((2, 20, 16), seed=4)
    ref = np.asarray(_synth_run(p, jnp.asarray(z)))
    x, _ = synthesize_from_noise(model, torch.from_numpy(z))
    np.testing.assert_allclose(x.numpy(), ref, atol=5e-5)


def test_composed_functions_match_jax():
    p = _params(jtg.TimeGANConfig(x_dim=5, z_dim=16, h_dim=24), seed=5)
    model = from_jax_params(p, device="cpu")
    x = _noise((3, 30, 5), seed=5)
    z = _noise((3, 30, 16), seed=6)
    with torch.inference_mode():
        h = ttg.encode(model, torch.from_numpy(x))
        e = ttg.gen_latent(model, torch.from_numpy(z))
        hh = ttg.refine_latent(model, e)
        xr = ttg.decode(model, hh)
    for got, ref in ((h, jtg.encode(p, jnp.asarray(x))),
                     (e, jtg.gen_latent(p, jnp.asarray(z))),
                     (hh, jtg.refine_latent(p, jtg.gen_latent(p, jnp.asarray(z)))),
                     (xr, jtg.decode(p, jnp.asarray(hh.numpy())))):
        np.testing.assert_allclose(got.numpy(), np.asarray(ref), atol=5e-5)


def test_multi_layer_falls_back_to_composed():
    cfg = jtg.TimeGANConfig(x_dim=3, z_dim=8, h_dim=12, num_layers=2)
    p = _params(cfg, seed=7)
    model = from_jax_params(p, device="cpu")
    assert model.cfg.num_layers == 2
    z = _noise((2, 10, 8), seed=7)
    ref = np.asarray(_synth_run(p, jnp.asarray(z)))
    x, carry = synthesize_from_noise(model, torch.from_numpy(z))
    assert carry is None
    np.testing.assert_allclose(x.numpy(), ref, atol=5e-5)
    X = synthesize(model, 3, 10, generator=torch.Generator().manual_seed(0),
                   time_chunk=4)          # multi-layer stacks run one-shot
    assert X.shape == (3, 10, 3) and np.isfinite(X).all()


def test_sn_dense_matches_jax_eval():
    p = _params(FULL, seed=8)
    model = from_jax_params(p, device="cpu").eval()
    h = _noise((4, FULL.h_dim), seed=8)
    ref, new_fc = sn_dense_apply(p["discriminator"]["fc"], jnp.asarray(h),
                                 train=False)
    with torch.no_grad():
        got = model.discriminator.fc(torch.from_numpy(h))
    np.testing.assert_allclose(got.numpy(), np.asarray(ref), atol=1e-5)
    np.testing.assert_array_equal(model.discriminator.fc.weight_u.numpy(),
                                  p["discriminator"]["fc"]["u"])


@pytest.mark.parametrize("cfg", [FULL, jtg.TimeGANConfig(x_dim=4, z_dim=16,
                                                         h_dim=16)])
def test_params_round_trip_exact(cfg):
    p = _params(cfg, seed=9)
    q = to_jax_params(from_jax_params(p, device="cpu"))
    assert jax.tree.structure(q) == jax.tree.structure(p)
    assert len(jax.tree.leaves(q)) == (29 if cfg.h_dim != cfg.z_dim else 25)
    for a, b in zip(jax.tree.leaves(q), jax.tree.leaves(p)):
        assert a.dtype == b.dtype == np.float32
        np.testing.assert_array_equal(a, b)


def test_state_dict_names_match_reference_converter():
    """The module's state_dict carries the reference torch names, so
    scripts/convert_torch_ckpt.py maps it to the JAX params unchanged."""
    from convert_torch_ckpt import convert_timegan_model
    model = ttg.TimeGAN(ttg.TimeGANConfig(), generator=torch.Generator()
                        .manual_seed(0), device="cpu")
    conv = convert_timegan_model(model.state_dict())
    ours = to_jax_params(model)
    assert jax.tree.structure(conv) == jax.tree.structure(ours)
    for a, b in zip(jax.tree.leaves(conv), jax.tree.leaves(ours)):
        np.testing.assert_array_equal(a, b)


def test_synthesize_shapes_and_seed():
    model = from_jax_params(_params(FULL, seed=10), device="cpu")

    def run(**kw):
        return synthesize(model, 5, 50, generator=torch.Generator()
                          .manual_seed(3), **kw)
    X = run(batch=2, time_chunk=16)
    assert X.shape == (5, 50, 14) and X.dtype == np.float32
    np.testing.assert_array_equal(X, run(batch=2, time_chunk=16))
    assert run().shape == (5, 50, 14)
    X16 = run(batch=2, time_chunk=16, precision="bf16")
    assert X16.shape == (5, 50, 14) and X16.dtype == np.float32
    np.testing.assert_array_equal(X16, run(batch=2, time_chunk=16, precision="bf16"))
    with pytest.raises(ValueError, match="precision"):
        run(precision="fp16")


def test_synthesize_draws_full_last_chunk():
    """The last, partial chunk draws a full time_chunk of noise and slices,
    as the JAX synthesize does: a longer request's prefix is the same."""
    model = from_jax_params(_params(FULL, seed=11), device="cpu")
    a = synthesize(model, 2, 40, generator=torch.Generator().manual_seed(1),
                   time_chunk=16)
    b = synthesize(model, 2, 48, generator=torch.Generator().manual_seed(1),
                   time_chunk=16)
    np.testing.assert_array_equal(a, b[:, :40])


def test_adaptive_dims_matches_jax():
    for c in (3, 14, 20, 40):
        for T in (768, 1024):
            assert ttg.adaptive_dims(c, T) == jtg.adaptive_dims(c, T)
