"""eegsynth_torch.nn.attention against eegsynth.nn.attention on the CPU: the
plain versions of the flash kernels K3a, K3b and K3c against the Pallas
kernels in interpret mode, ``mha``'s dispatch, first-order-only
``flash_attention``, and the split-TF32 products of the card's K3a, K3b and
K3c (to head dim 128 and past it), emulated, against the card's tolerances.
Same numpy inputs on both sides; the JAX side runs with x64 off (float32, as
the port)."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from eegsynth.nn.attention import _fa_impl, attention_xla
from eegsynth.nn.attention import flash_attention as jax_flash
from eegsynth_torch.nn import attention as A

# float32 on both sides, sums in another order (blocked online softmax
# against one logsumexp): o and lse within 2e-6, gradients within 2e-6
FWD_TOL = 2e-6
BWD_TOL = 2e-6


def _inputs(shape, n, seed=0):
    rng = np.random.default_rng(seed)
    return [rng.standard_normal(shape).astype(np.float32) for _ in range(n)]


def _t(*arrays):
    return [torch.from_numpy(a) for a in arrays]


# the shapes of tests/test_attention.py: the CGAN's training geometry, a T
# that is not a multiple of 128 with an odd head dim, two and three blocks;
# and a head dim past 128, which the card's wide kernels take
@pytest.mark.parametrize("B,H,T,D", [(2, 2, 96, 64), (1, 3, 200, 48),
                                     (2, 1, 256, 64), (1, 2, 384, 32),
                                     (1, 2, 130, 160)])
def test_forward_plain_matches_pallas(B, H, T, D):
    q, k, v = _inputs((B, H, T, D), 3, seed=T)
    with jax.enable_x64(False):
        o_pad, lse_pad, _ = _fa_impl(jnp.asarray(q), jnp.asarray(k), jnp.asarray(v), True)
        o_jax = np.asarray(jax_flash(jnp.asarray(q), jnp.asarray(k), jnp.asarray(v), True))
    o_pad = np.asarray(o_pad)[:, :T].reshape(B, H, T, D)
    lse_pad = np.asarray(lse_pad)[:, :T, 0].reshape(B, H, T)
    o, lse = A.flash_forward_plain(*_t(q, k, v))
    np.testing.assert_allclose(o.numpy(), o_pad, atol=FWD_TOL, rtol=0)
    np.testing.assert_allclose(lse.numpy(), lse_pad, atol=FWD_TOL, rtol=0)
    np.testing.assert_allclose(A.flash_attention(*_t(q, k, v)).numpy(), o_jax,
                               atol=FWD_TOL, rtol=0)
    # the wrapper takes the plain version for CPU tensors, launching nothing
    before = (A.flash_forward.launches, A.flash_forward.wide_launches)
    o_w, lse_w = A.flash_forward(*_t(q, k, v))
    assert torch.equal(o_w, o) and torch.equal(lse_w, lse)
    assert (A.flash_forward.launches, A.flash_forward.wide_launches) == before


@pytest.mark.parametrize("B,H,T,D", [(2, 2, 96, 32), (1, 2, 200, 32), (1, 1, 130, 160),
                                     (1, 1, 70, 256)])
def test_backward_plain_matches_pallas_vjp(B, H, T, D):
    q, k, v, g = _inputs((B, H, T, D), 4, seed=D + T)
    with jax.enable_x64(False):
        out, vjp = jax.vjp(lambda q, k, v: jax_flash(q, k, v, True),
                           *map(jnp.asarray, (q, k, v)))
        want = [np.asarray(x) for x in vjp(jnp.asarray(g))]
    tq, tk, tv, tg = _t(q, k, v, g)
    o, lse = A.flash_forward_plain(tq, tk, tv)
    got = A.flash_backward_plain(tq, tk, tv, o, lse, tg)
    for a, b in zip(got, want):
        np.testing.assert_allclose(a.numpy(), b, atol=BWD_TOL, rtol=0)
    # through the autograd.Function: the same gradients
    leaves = [x.clone().requires_grad_() for x in (tq, tk, tv)]
    A.flash_attention(*leaves).backward(tg)
    for x, b in zip(leaves, want):
        np.testing.assert_allclose(x.grad.numpy(), b, atol=BWD_TOL, rtol=0)
    # K3b's and K3c's plain versions are the two halves of it
    delta = (tg * o).sum(-1)
    dq = A.flash_dq(tq, tk, tv, tg, lse, delta)
    dk, dv = A.flash_dkv(tq, tk, tv, tg, lse, delta)
    for a, b in zip((dq, dk, dv), got):
        assert torch.equal(a, b)


def test_dense_matches_xla():
    q, k, v = _inputs((2, 2, 40, 16), 3, seed=1)
    with jax.enable_x64(False):
        want = np.asarray(attention_xla(*map(jnp.asarray, (q, k, v))))
    np.testing.assert_allclose(A.attention_dense(*_t(q, k, v)).numpy(), want,
                               atol=FWD_TOL, rtol=0)


def test_mha_dispatch_on_cpu():
    q, k, v = _t(*_inputs((1, 2, 64, 16), 3, seed=2))
    ref = A.attention_dense(q, k, v)
    try:
        A.set_attention_impl("auto")
        assert torch.equal(A.mha(q, k, v), ref)        # CPU tensors: dense
        long = _t(*_inputs((1, 1, 512, 8), 3, seed=3))
        assert torch.equal(A.mha(*long), A.attention_dense(*long))
        A.set_attention_impl("flash")
        torch.testing.assert_close(A.mha(q, k, v), ref, atol=FWD_TOL, rtol=0)
        assert torch.equal(A.mha(q, k, v, impl="dense"), ref)
        with pytest.raises(ValueError):
            A.set_attention_impl("pallas")
        with pytest.raises(ValueError):
            A.mha(q, k, v, impl="xla")
    finally:
        A.set_attention_impl("auto")


# "auto" on the card: the kernels from 512 tokens, as JAX's mha, at any head
# dim (the tensor-core kernels to 128, the wide kernels past it) and any B·H
@pytest.mark.parametrize("shape,device,flash", [
    ((64, 4, 768, 64), "cuda", True), ((2, 1, 512, 128), "cuda", True),
    ((1, 2, 512, 160), "cuda", True), ((64, 4, 511, 64), "cuda", False),
    ((16384, 4, 512, 64), "cuda", True), ((65535, 1, 512, 64), "cuda", True),
    ((65536, 1, 512, 64), "cuda", True), ((64, 4, 768, 64), "cpu", False),
])
def test_auto_rule(shape, device, flash):
    assert A.auto_takes_flash(shape, device) is flash


# which kernels a head dim takes on the card: whole rows to 128, the wide
# kernels past it
@pytest.mark.parametrize("D,wide", [(1, False), (64, False), (128, False), (129, True),
                                    (256, True), (512, True)])
def test_takes_wide_kernels(D, wide):
    assert A.takes_wide_kernels(D) is wide


def test_second_derivative_raises_for_flash_only():
    q, k, v = [x.requires_grad_() for x in _t(*_inputs((1, 2, 24, 8), 3, seed=4))]
    (g,) = torch.autograd.grad((A.attention_dense(q, k, v) ** 2).sum(), q,
                               create_graph=True)
    (gg,) = torch.autograd.grad(g.pow(2).sum(), k)      # dense: twice works
    assert torch.isfinite(gg).all()
    (g,) = torch.autograd.grad((A.flash_attention(q, k, v) ** 2).sum(), q,
                               create_graph=True)
    with pytest.raises(RuntimeError, match="once_differentiable"):
        g.pow(2).sum().backward()


def test_wrappers_check_shapes():
    q, k, v = _t(*_inputs((1, 2, 8, 4), 3))
    with pytest.raises(ValueError, match="k must be"):
        A.flash_forward(q, k[:, :1], v)
    with pytest.raises(ValueError, match="lse must be"):
        A.flash_dq(q, k, v, q, torch.zeros(1, 2, 7), torch.zeros(1, 2, 8))


# ------------------------------------------------------------------
# The card kernels' numerics: split-TF32 products
# ------------------------------------------------------------------

def _tf32(x: torch.Tensor) -> torch.Tensor:
    """float32 rounded to TF32 (10 mantissa bits), to nearest with ties away
    from zero, on the bits: what the K3a/K3c kernels feed the tensor cores."""
    bits = x.contiguous().numpy().view(np.uint32)
    rounded = (bits + np.uint32(0x1000)) & np.uint32(0xFFFFE000)
    return torch.from_numpy(rounded.view(np.float32))


def _mm_split(a, b):
    """a @ b as the kernels compute it: x = hi + lo, both TF32, and the
    products lo·hi + hi·lo + hi·hi summed in float32."""
    a_hi, b_hi = _tf32(a), _tf32(b)
    a_lo, b_lo = _tf32(a - a_hi), _tf32(b - b_hi)
    return a_lo @ b_hi + a_hi @ b_lo + a_hi @ b_hi


def _mm_tf32(a, b):
    """One-pass TF32: each operand rounded once."""
    return _tf32(a) @ _tf32(b)


def _k3_products(q, k, v, do, mm):
    """K3a's, K3b's and K3c's formulas (the plain versions') with every tile
    product through ``mm``; delta = rowsum(dO∘O) in float32 between them, as
    FlashAttention.backward computes it. Returns (o, lse, dq, dk, dv)."""
    scale = q.shape[-1] ** -0.5
    s = mm(q, k.transpose(-1, -2)) * scale
    lse = torch.logsumexp(s, dim=-1)
    o = mm(torch.exp(s - lse[..., None]), v)
    delta = (do * o).sum(-1)
    p = torch.exp(s - lse[..., None])
    ds = p * (mm(do, v.transpose(-1, -2)) - delta[..., None]) * scale
    return (o, lse, mm(ds, k), mm(ds.transpose(-1, -2), q),
            mm(p.transpose(-1, -2), do))


def _mm_chunks(a, b, chunk, mm):
    """a @ b with the contraction (a's last axis) taken ``chunk`` values at
    a time, each chunk's product through ``mm`` into a fresh sum, the
    chunks' sums added in float32: how the wide K3b and K3c sum over D and
    over the streamed rows (64 a step or a tile)."""
    out = mm(a[..., :chunk], b[..., :chunk, :])
    for c in range(chunk, a.shape[-1], chunk):
        out = out + mm(a[..., c:c + chunk], b[..., c:c + chunk, :])
    return out


def _mm_halves(a, b, mm):
    """a @ b over D as the wide K3c and K3a sum it: the two blocks of a
    cluster (K3c) or the two warpgroups of a block (K3a) each take half of
    the 64-column chunks (``_mm_chunks``), and their partial sums are
    added."""
    half = 64 * ((-(-a.shape[-1] // 64) + 1) // 2)
    out = _mm_chunks(a[..., :half], b[..., :half, :], 64, mm)
    if half < a.shape[-1]:
        out = out + _mm_chunks(a[..., half:], b[..., half:, :], 64, mm)
    return out


def _wide_forward(q, k, v, mm):
    """The wide K3a's arithmetic past head dim 128: per key tile of 64 rows,
    s summed over D in the two warpgroups' halves of 64-column chunks
    (``_mm_halves``), the online softmax in base 2, and the tile's p·v
    through ``mm`` into a fresh sum, folded into o after o is scaled by
    alpha. Returns (o, lse)."""
    f32 = torch.float32
    scale2 = torch.tensor(q.shape[-1] ** -0.5, dtype=f32) * torch.tensor(np.log2(np.e),
                                                                          dtype=f32)
    m = torch.full(q.shape[:-1], -1e30, dtype=f32)
    l = torch.zeros(q.shape[:-1], dtype=f32)
    o = torch.zeros_like(q)
    for j0 in range(0, q.shape[-2], 64):
        kt, vt = k[..., j0:j0 + 64, :], v[..., j0:j0 + 64, :]
        s = _mm_halves(q, kt.transpose(-1, -2), mm) * scale2
        m_new = torch.maximum(m, s.amax(-1))
        alpha = torch.exp2(m - m_new)
        p = torch.exp2(s - m_new[..., None])
        l = alpha * l + p.sum(-1)
        o = o * alpha[..., None] + mm(p, vt)
        m = m_new
    l = torch.where(l == 0, torch.ones_like(l), l)
    return o / l[..., None], m * torch.tensor(np.log(2.0), dtype=f32) + torch.log(l)


def _wide_products(q, k, v, do, mm):
    """The wide kernels' arithmetic past head dim 128: K3a as
    ``_wide_forward``; K3b with s and dp summed over D in chunks of 64, K3c
    in two halves of such chunks; dq, dk, dv summed over the streamed rows
    in tiles of 64; each piece's product through ``mm``. Returns (o, lse,
    dq, dk, dv)."""
    scale = q.shape[-1] ** -0.5
    o, lse = _wide_forward(q, k, v, mm)
    delta = (do * o).sum(-1)

    def probs(over_d):
        p = torch.exp(over_d(q, k.transpose(-1, -2)) * scale - lse[..., None])
        return p, p * (over_d(do, v.transpose(-1, -2)) - delta[..., None]) * scale

    _, ds = probs(lambda a, b: _mm_chunks(a, b, 64, mm))
    p_c, ds_c = probs(lambda a, b: _mm_halves(a, b, mm))
    return (o, lse, _mm_chunks(ds, k, 64, mm),
            _mm_chunks(ds_c.transpose(-1, -2), q, 64, mm),
            _mm_chunks(p_c.transpose(-1, -2), do, 64, mm))


# the card's tolerances (chip_smoke.py: ATTN_FWD_TOL, ATTN_BWD_RTOL)
CARD_FWD_TOL, CARD_BWD_RTOL = 1e-5, 1e-4


# head dims to 128 (flash_attn_tc.cu), then 160, 256, 300 and 512, past it
# (the wide kernels, their sums over D chunk by chunk; 160 gives the halves
# 2 and 1 chunks, 300 and 512 two column groups, 100 keys two key tiles)
@pytest.mark.parametrize("B,H,T,D", [(2, 4, 96, 64), (1, 3, 200, 48), (1, 2, 40, 160),
                                     (1, 1, 24, 256), (1, 1, 40, 300), (1, 1, 100, 512)])
def test_split_tf32_meets_the_card_tolerances(B, H, T, D):
    """The products K3a, K3b and K3c run on the tensor cores, emulated here
    (TF32 rounding on the bits, float32 sums), hold the card's tolerances
    against the Pallas kernels in interpret mode: 1e-5 on o and lse, 1e-4 of
    the largest magnitude on dq, dk and dv. One-pass TF32 misses both: that
    is why every product is split. Past head dim 128 the emulation sums as
    the wide kernels do."""
    q, k, v, g = _inputs((B, H, T, D), 4, seed=7 * T + D)
    with jax.enable_x64(False):
        o_pad, lse_pad, _ = _fa_impl(jnp.asarray(q), jnp.asarray(k), jnp.asarray(v), True)
        _, vjp = jax.vjp(lambda q, k, v: jax_flash(q, k, v, True),
                         *map(jnp.asarray, (q, k, v)))
        grads_want = [np.asarray(x) for x in vjp(jnp.asarray(g))]
    o_want = np.asarray(o_pad)[:, :T].reshape(B, H, T, D)
    lse_want = np.asarray(lse_pad)[:, :T, 0].reshape(B, H, T)
    wide = A.takes_wide_kernels(D)

    def errors(mm):
        products = _wide_products if wide else _k3_products
        o, lse, *grads = products(*_t(q, k, v, g), mm)
        return (max(np.abs(o.numpy() - o_want).max(), np.abs(lse.numpy() - lse_want).max()),
                max(np.abs(a.numpy() - w).max() / np.abs(w).max()
                    for a, w in zip(grads, grads_want)))

    fwd, bwd = errors(_mm_split)
    assert fwd <= CARD_FWD_TOL and bwd <= CARD_BWD_RTOL, (fwd, bwd)
    fwd, bwd = errors(_mm_tf32)
    assert bwd > CARD_BWD_RTOL, bwd
    assert fwd > CARD_FWD_TOL, fwd
