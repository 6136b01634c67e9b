"""K1's backward on the CPU: the plain version against ``jax.vjp`` of the JAX
package's ``gru_sequence`` (Pallas kernel in interpret mode, custom VJP
``_gru_seq_bwd``), a float64 gradcheck of ``GRUSequence``, the bucket axis,
and the discriminator's twice-differentiable plain recurrence. The kernel
itself is checked on the card by tests/test_torch_card.py and chip_smoke.py.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from eegsynth.nn.gru import gru_init
from eegsynth.nn.pallas_gru import gru_apply_pallas
from eegsynth.nn.pallas_gru import gru_sequence as jax_gru_sequence
from eegsynth_torch.nn.gru import GRULayer, gru_apply
from eegsynth_torch.nn.gru_sequence import (
    GRUSequence, gru_sequence, gru_sequence_bwd, gru_sequence_bwd_reference,
    gru_sequence_reference,
)

# float32 on both sides, another summation order over up to 16 steps
TOL = 2e-5


def _inputs(rng, T, B, H, lead=()):
    xp = rng.standard_normal((*lead, T, B, 3 * H)).astype(np.float32)
    w = (rng.standard_normal((*lead, H, 3 * H)) * 0.3).astype(np.float32)
    b = (rng.standard_normal((*lead, 1, 3 * H)) * 0.1).astype(np.float32)
    h0 = rng.standard_normal((*lead, B, H)).astype(np.float32)
    dy = rng.standard_normal((*lead, T, B, H)).astype(np.float32)
    return (xp, w, b, h0), dy


@pytest.mark.parametrize("T,B,H", [(9, 2, 4), (16, 4, 12), (12, 3, 28)])
def test_bwd_reference_matches_jax_vjp(T, B, H):
    (xp, w, b, h0), dy = _inputs(np.random.default_rng(T), T, B, H)
    with jax.enable_x64(False):
        args = [jnp.asarray(a) for a in (xp, w, b, h0)]
        ys, vjp = jax.vjp(lambda *a: jax_gru_sequence(*a, True), *args)
        want = vjp(jnp.asarray(dy))
    t = [torch.from_numpy(a) for a in (xp, w, b, h0)]
    got = gru_sequence_bwd_reference(*t, gru_sequence_reference(*t),
                                     torch.from_numpy(dy))
    np.testing.assert_allclose(gru_sequence_reference(*t).numpy(), np.asarray(ys),
                               atol=TOL)
    for g, r, name in zip(got, want, ("dxp", "dw_hh_t", "db_hh", "dh0")):
        assert g.shape == r.shape, name
        np.testing.assert_allclose(g.numpy(), np.asarray(r), atol=TOL, rtol=TOL,
                                   err_msg=name)


def test_bucket_axis_equals_separate_buckets():
    """The stacked wrapper (nb = 3) gives each bucket its own gradients, those
    of three unstacked calls (batched products round differently: 1e-6)."""
    (xp, w, b, h0), dy = _inputs(np.random.default_rng(1), 10, 3, 8, lead=(3,))
    t = [torch.from_numpy(a) for a in (xp, w, b, h0)]
    ys = gru_sequence(*t)
    stacked = gru_sequence_bwd(*t, ys, torch.from_numpy(dy))
    for k in range(3):
        one = [a[k] for a in t]
        ref = gru_sequence_bwd_reference(*one, gru_sequence_reference(*one),
                                         torch.from_numpy(dy[k]))
        for g, r in zip(stacked, ref):
            torch.testing.assert_close(g[k], r, rtol=0, atol=1e-6)


def test_gradcheck_float64():
    """GRUSequence's analytic backward (the plain version on the CPU) against
    finite differences, stacked, in float64."""
    g = torch.Generator().manual_seed(0)
    nb, T, B, H = 2, 5, 3, 4
    args = [torch.randn(s, generator=g, dtype=torch.float64) * sc
            for s, sc in (((nb, T, B, 3 * H), 1.0), ((nb, H, 3 * H), 0.4),
                          ((nb, 1, 3 * H), 0.1), ((nb, B, H), 0.5))]
    args = [a.requires_grad_() for a in args]
    assert torch.autograd.gradcheck(GRUSequence.apply, args, eps=1e-6, atol=1e-7)


@pytest.mark.parametrize("lead", [(), (2,)])
def test_gru_apply_grad_matches_jax(lead):
    """Gradients of a loss through gru_apply (K1 path, stacked or not) equal
    JAX's through gru_apply_pallas in interpret mode."""
    rng = np.random.default_rng(2)
    B, T, I, H = 3, 11, 5, 8
    with jax.enable_x64(False):
        params = [gru_init(jax.random.key(k), I, H) for k in range(lead[0] if lead else 1)]
        params = jax.tree.map(lambda *a: jnp.stack(a), *params) if lead else params[0]
    x = rng.standard_normal((*lead, B, T, I)).astype(np.float32)
    c = rng.standard_normal((*lead, B, T, H)).astype(np.float32)

    def jloss(p, x):
        if not lead:
            return jnp.sum(gru_apply_pallas(p, x, interpret=True) * c)
        return sum(jnp.sum(gru_apply_pallas(jax.tree.map(lambda a: a[k], p), x[k],
                                            interpret=True) * c[k])
                   for k in range(lead[0]))

    with jax.enable_x64(False):
        want_p, want_x = jax.grad(jloss, argnums=(0, 1))(params, jnp.asarray(x))
    layer = GRULayer(*(torch.from_numpy(np.array(params[k])).requires_grad_()
                       for k in ("w_ih", "w_hh", "b_ih", "b_hh")))
    xt = torch.from_numpy(x).requires_grad_()
    (gru_apply(layer, xt) * torch.from_numpy(c)).sum().backward()
    for k, t in zip(("w_ih", "w_hh", "b_ih", "b_hh"), layer):
        np.testing.assert_allclose(t.grad.numpy(), np.asarray(want_p[k]), atol=TOL,
                                   rtol=TOL, err_msg=k)
    np.testing.assert_allclose(xt.grad.numpy(), np.asarray(want_x), atol=TOL, rtol=TOL)


def test_plain_impl_is_twice_differentiable():
    """The discriminator's recurrence (impl="plain") takes a second
    derivative, as R1 needs; K1's custom backward is first-order only."""
    g = torch.Generator().manual_seed(3)
    layer = GRULayer(*(torch.randn(s, generator=g, dtype=torch.float64) * 0.3
                       for s in ((12, 3), (12, 4), (12,), (12,))))
    x = torch.randn((2, 6, 3), generator=g, dtype=torch.float64, requires_grad=True)
    assert torch.autograd.gradgradcheck(
        lambda x: gru_apply(layer, x, impl="plain")[:, -1].sum(), (x,))
    y = gru_apply(layer, x)
    (gx,) = torch.autograd.grad(y.sum(), x, create_graph=True)
    with pytest.raises(RuntimeError):
        torch.autograd.grad(gx.sum(), x)


def test_cpu_backward_never_launches():
    (xp, w, b, h0), dy = _inputs(np.random.default_rng(4), 6, 2, 4, lead=(2,))
    t = [torch.from_numpy(a).requires_grad_() for a in (xp, w, b, h0)]
    before = (gru_sequence.launches, gru_sequence_bwd.launches)
    (gru_sequence(*t) * torch.from_numpy(dy)).sum().backward()
    assert (gru_sequence.launches, gru_sequence_bwd.launches) == before
    assert all(a.grad is not None for a in t)
