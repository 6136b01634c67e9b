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


def _sigmoid_fwd(x):
    return (np.float32(0.5) * np.tanh(np.float32(0.5) * x) + np.float32(0.5)).astype(
        np.float32)


def _fma(a, b, c):
    """fmaf: a b + c rounded once to float32 (from float64: within double
    rounding)."""
    return (a.astype(np.float64) * b + c).astype(np.float32)


def _bwd_kernel_order(xp, w, b, h0, ys, dy):
    """K1 backward's arithmetic in the Hopper kernel's order
    (eegsynth_torch/csrc/gru_seq.cu), in numpy float32: hp = h_prev W_hhᵀ +
    b_hh hoisted as one float32 product; the coefficients of dhp and dxp
    from xp, hp and h_prev with the sigmoid 1/2 + tanh(x/2)/2; then the
    reverse chain dh_prev = (dh z + d_ys) + dhp W_hh, in which each of S
    lanes sums, per gate, a KL-long slice of dhp W_hh as a chain of
    multiply-adds from zero (zero padding past H), adds its three gates as
    (r + z) + n, and the S lane sums are added pairwise at distance S/2, then
    S/4, ... (the shuffle butterfly). dW and db as float32 sums over T·B
    rows. Returns (dxp, dw_hh_t, db_hh, dh0)."""
    T, B, G = xp.shape
    H = G // 3
    kl = 16 if H <= 64 else 32 if H <= 96 else 64
    s = 1
    while s * kl < H:
        s *= 2
    f32 = np.float32
    h_prev = np.concatenate([h0[None], ys[:T - 1]]).astype(f32)
    hp = ((h_prev.reshape(T * B, H) @ w).reshape(T, B, G) + b[0]).astype(f32)
    xr, xz, xn = xp[..., :H], xp[..., H:2 * H], xp[..., 2 * H:]
    pr, pz, pn = hp[..., :H], hp[..., H:2 * H], hp[..., 2 * H:]
    r = _sigmoid_fwd(xr + pr)
    z = _sigmoid_fwd(xz + pz)
    n = np.tanh(xn + r * pn).astype(f32)
    e = (f32(1) - z) * (f32(1) - n * n)
    coef = ((e * pn) * (r * (f32(1) - r)), (h_prev - n) * (z * (f32(1) - z)), e * r)
    # W_hhᵀ by row j, as (H, 3, S, KL) slices, zeros past H; f64 for _fma
    w_sl = np.zeros((H, 3, s * kl), f32)
    w_sl[:, :, :H] = w.reshape(H, 3, H)
    w_sl = w_sl.reshape(H, 3, s, kl).astype(np.float64)
    dxp = np.empty_like(xp)
    dhp = np.zeros((T, B, G), f32)
    g_cur = np.zeros((B, 3, s * kl), f32)
    st = dy[T - 1] if T else np.zeros((B, H), f32)
    for t in range(T, -1, -1):
        g_sl = g_cur.reshape(B, 3, s, kl)
        acc = [np.zeros((s, B, H), f32) for _ in range(3)]
        for kk in range(kl):
            for g in range(3):
                acc[g] = _fma(g_sl[:, g, :, kk].T[:, :, None],
                              w_sl[None, :, g, :, kk].transpose(2, 0, 1), acc[g])
        part = (acc[0] + acc[1]) + acc[2]
        while len(part) > 1:
            half = len(part) // 2
            part = part[:half] + part[half:]
        dh = (st + part[0]).astype(f32)
        if t == 0:
            return dxp, (h_prev.reshape(T * B, H).T @ dhp.reshape(T * B, G)).astype(f32), \
                dhp.reshape(T * B, G).sum(0, keepdims=True, dtype=f32), dh
        d = [dh * c[t - 1] for c in coef]
        dhp[t - 1] = np.concatenate(d, axis=-1)
        dxp[t - 1] = np.concatenate([d[0], d[1], dh * e[t - 1]], axis=-1)
        g_cur = np.zeros((B, 3, s * kl), f32)
        g_cur[:, :, :H] = np.stack(d, axis=1)
        st = _fma(dh, z[t - 1], dy[t - 2] if t >= 2 else np.zeros((B, H), f32))


def _assert_bwd_close(got, want, tol=1e-4):
    """dxp and dh0 within ``tol``; dW and db within ``tol`` of their largest
    magnitude (sums over T·B rows), as the card's checks hold the kernel."""
    for g, r, name in zip(got, want, ("dxp", "dw_hh_t", "db_hh", "dh0")):
        g, r = np.asarray(g), np.asarray(r)
        assert g.shape == r.shape and np.isfinite(g).all(), name
        scale = max(1.0, float(np.abs(r).max())) if name in ("dw_hh_t", "db_hh") else 1.0
        np.testing.assert_allclose(g, r, rtol=0, atol=tol * scale, err_msg=name)


# the H cap (KL 64, S 2) over 1024 steps; the training width (KL 16, S 4);
# the wide model's h80 (KL 32, S 4)
@pytest.mark.parametrize("T,B,H", [(1024, 5, 128), (768, 4, 56), (768, 3, 80)])
def test_bwd_kernel_order_matches_reference(T, B, H):
    """The backward kernel's arithmetic (hoisted hp, the tanh sigmoid, the
    coefficient form, sliced sums and the butterfly) stays within the card
    checks' 1e-4 of the plain backward: f32 sums in another order over up
    to 1024 reverse steps."""
    (xp, w, b, h0), dy = _inputs(np.random.default_rng(T + H), T, B, H)
    w /= np.float32(0.3 * np.sqrt(H))    # W ~ 1/sqrt(H), as at init
    t = [torch.from_numpy(a) for a in (xp, w, b, h0)]
    ys = gru_sequence_reference(*t)
    want = gru_sequence_bwd_reference(*t, ys, torch.from_numpy(dy))
    got = _bwd_kernel_order(xp, w, b, h0, ys.numpy(), dy)
    _assert_bwd_close(got, [a.numpy() for a in want])


def test_bwd_kernel_order_matches_jax_vjp():
    """The same order against jax.vjp of the JAX package's gru_sequence
    (Pallas kernel in interpret mode, custom VJP _gru_seq_bwd) at H 20
    (KL 16, S 2: 12 zero-padded k)."""
    T, B, H = 16, 3, 20
    (xp, w, b, h0), dy = _inputs(np.random.default_rng(T), T, B, H)
    with jax.enable_x64(False):
        args = [jnp.asarray(a) for a in (xp, w, b, h0)]
        ys, vjp = jax.vjp(lambda *a: jax_gru_sequence(*a, True), *args)
        want = vjp(jnp.asarray(dy))
    got = _bwd_kernel_order(xp, w, b, h0, np.asarray(ys), dy)
    _assert_bwd_close(got, want)


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
