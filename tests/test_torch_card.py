"""eegsynth_torch on a CUDA card: the Hopper kernels (K1 forward and
backward, K2, flash attention K3a/K3b/K3c, for head dims to 128 and past
it) against their plain versions,
K1's bucket axis against separate launches, the wrappers' checks, gradients
through K1 and through flash_attention against the CPU, the serving
cascade chunked against one-shot, and the eval's GRU(24) scorers and
statistics against the CPU.

Every test skips without a card: the kernels have no CPU mode. This file
imports no jax, so it also runs on a machine without it:

    python -m pytest --noconftest tests/test_torch_card.py -q
"""

import numpy as np
import pytest
import torch

from eegsynth_torch.eval import classifiers as eval_classifiers
from eegsynth_torch.eval.stats import statistical_similarity
from eegsynth_torch.models.timegan import (
    TimeGAN, TimeGANConfig, fused_disc_inputs, timegan_init_stacked,
)
from eegsynth_torch.nn.attention import (
    attention_dense, flash_attention, flash_dkv, flash_dkv_plain, flash_dq,
    flash_dq_plain, flash_forward, flash_forward_plain, mha,
)
from eegsynth_torch.nn.gru_sequence import (
    gru_sequence, gru_sequence_bwd, gru_sequence_bwd_reference,
    gru_sequence_reference,
)
from eegsynth_torch.nn.multigru import (
    multigru_disc_inputs, multigru_disc_inputs_reference,
)
from eegsynth_torch.train.timegan import synthesize_from_noise
from eegsynth_torch.tree import tree_map

pytestmark = pytest.mark.cuda


@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: the Hopper kernel has no CPU mode")
    return torch.device("cuda")


def _inputs(T, B, H, device, seed=0, lead=()):
    rng = np.random.default_rng(seed)
    xp = rng.standard_normal((*lead, T, B, 3 * H)).astype(np.float32)
    w = (rng.standard_normal((*lead, H, 3 * H)) / np.sqrt(H)).astype(np.float32)
    b = (rng.standard_normal((*lead, 1, 3 * H)) * 0.1).astype(np.float32)
    h0 = rng.uniform(-0.5, 0.5, (*lead, B, H)).astype(np.float32)
    return [torch.from_numpy(a).to(device) for a in (xp, w, b, h0)]


# serving width, embedder width, H cap with a ragged batch, a batch just
# over one tile per SM, an H that is not a multiple of 32, one step; the
# forward's instance boundaries (KL 16 up to H 64, KL 32 past it) and H 127
# (3H not a multiple of 4: 4-byte copies of xp); the training shape through
# the bucket axis (9 rows a block, a ragged group of rows); the eval's
# GRU(24) scorers at cut T: a stack of tasks of 63 rows, and one task of
# 1587 rows (13 rows a block)
@pytest.mark.parametrize("T,B,H,nb", [(768, 256, 56, None), (768, 256, 28, None),
                                      (1024, 37, 128, None), (64, 133, 56, None),
                                      (50, 7, 20, None), (1, 3, 8, None),
                                      (300, 37, 64, None), (300, 37, 65, None),
                                      (300, 37, 96, None), (300, 37, 127, None),
                                      (768, 63, 56, 18), (200, 63, 24, 36),
                                      (200, 1587, 24, 1)])
def test_kernel_matches_plain(cuda_device, T, B, H, nb):
    lead = () if nb is None else (nb,)
    inputs = _inputs(T, B, H, cuda_device, lead=lead)
    before = gru_sequence.launches
    got = gru_sequence(*inputs)
    ref = gru_sequence_reference(*inputs)
    torch.cuda.synchronize()
    assert gru_sequence.launches == before + 1
    assert got.shape == (*lead, T, B, H) and torch.isfinite(got).all()
    # f32 with another summation order over up to 1024 dependent steps
    assert (got - ref).abs().max().item() <= 1e-4


@pytest.mark.parametrize("nb,T,B,H", [(1, 768, 256, 56), (18, 768, 63, 56),
                                      (2, 100, 37, 128)])
def test_kernel_repeats_bitwise(cuda_device, nb, T, B, H):
    """Two launches on the same inputs give the same bits: the kernel's sums
    have a fixed order (no atomics)."""
    inputs = _inputs(T, B, H, cuda_device, seed=5, lead=(nb,))
    first = gru_sequence(*inputs)
    second = gru_sequence(*inputs)
    torch.cuda.synchronize()
    assert torch.equal(first, second)


def test_wrapper_raises_instead_of_falling_back(cuda_device):
    xp, w, b, h0 = _inputs(8, 4, 16, cuda_device)
    with pytest.raises(TypeError, match="float32"):
        gru_sequence(xp.double(), w, b, h0)
    with pytest.raises(ValueError, match="contiguous"):
        gru_sequence(xp, w.t().contiguous().t(), b, h0)
    with pytest.raises(ValueError, match="several devices"):
        gru_sequence(xp, w.cpu(), b, h0)
    with pytest.raises(ValueError, match="H=160"):
        gru_sequence(*_inputs(4, 2, 160, cuda_device))
    ys = gru_sequence(xp, w, b, h0)[None]
    with pytest.raises(TypeError, match="float32"):
        gru_sequence_bwd(xp[None], w[None], b[None], h0[None], ys, ys.double())
    xe, xg, weights = _multigru_inputs(1, 4, 2, 8, 16, 16, 8, cuda_device)
    with pytest.raises(ValueError, match="contiguous"):
        multigru_disc_inputs(xe.transpose(1, 2).contiguous().transpose(1, 2), xg,
                             *weights)
    wide = _multigru_inputs(1, 4, 2, 64, 129, 129, 64, cuda_device)
    with pytest.raises(ValueError, match="H=129"):
        multigru_disc_inputs(wide[0], wide[1], *wide[2])


def _assert_bwd_matches(got, ref):
    for g, r, name in zip(got, ref, ("dxp", "dw", "db", "dh0")):
        assert g.shape == r.shape and torch.isfinite(g).all(), name
        # f32 over up to 1024 reverse steps; dW and db sum T·B terms
        scale = max(1.0, r.abs().max().item())
        assert (g - r).abs().max().item() <= 1e-4 * scale, name


# (nb, T, B, H): the training widths (generator/supervisor/recovery and the
# embedder), a ragged batch at the H cap, a batch over one tile per SM with
# a ragged last tile (3 rows a block, 1 in the last); every other instance
# of the kernel (H 16: KL 16, S 1; H 80: KL 32, S 4), H 127 (H % 4 != 0:
# 4-byte copies) and one step; the eval's GRU(24) scorers at cut T (a stack
# of tasks of 63 rows, one task of 1134 rows)
@pytest.mark.parametrize("nb,T,B,H", [(18, 768, 63, 56), (18, 768, 63, 28),
                                      (3, 1024, 37, 128), (2, 64, 133, 20),
                                      (2, 100, 37, 16), (2, 300, 37, 80),
                                      (2, 50, 37, 127), (3, 1, 5, 56),
                                      (36, 200, 63, 24), (1, 200, 1134, 24)])
def test_backward_kernel_matches_plain(cuda_device, nb, T, B, H):
    inputs = _inputs(T, B, H, cuda_device, seed=H, lead=(nb,))
    ys = gru_sequence_reference(*inputs)
    d_ys = torch.randn(ys.shape, generator=torch.Generator().manual_seed(1))
    d_ys = d_ys.to(cuda_device)
    before = gru_sequence_bwd.launches
    got = gru_sequence_bwd(*inputs, ys, d_ys)
    ref = gru_sequence_bwd_reference(*inputs, ys, d_ys)
    torch.cuda.synchronize()
    assert gru_sequence_bwd.launches == before + 1
    _assert_bwd_matches(got, ref)


def test_backward_kernel_without_steps(cuda_device):
    """T = 0: no step to walk back; dh0, dW and db are zero."""
    inputs = _inputs(0, 5, 28, cuda_device, lead=(2,))
    ys = gru_sequence_reference(*inputs)
    before = gru_sequence_bwd.launches
    dxp, dw, db, dh0 = gru_sequence_bwd(*inputs, ys, torch.zeros_like(ys))
    torch.cuda.synchronize()
    assert gru_sequence_bwd.launches == before + 1
    assert dxp.shape == inputs[0].shape
    for t in (dw, db, dh0):
        assert torch.equal(t, torch.zeros_like(t))


def test_backward_kernel_takes_unaligned_inputs(cuda_device):
    """xp and d_ys as contiguous views 4 bytes into their storage, not
    16-byte aligned: the kernel copies them 4 bytes at a time and still
    matches the plain backward."""
    nb, T, B, H = 2, 200, 19, 56
    xp, w, b, h0 = _inputs(T, B, H, cuda_device, seed=7, lead=(nb,))
    xp = torch.cat([xp.new_zeros(1), xp.reshape(-1)])[1:].view(xp.shape)
    ys = gru_sequence_reference(xp, w, b, h0)
    d_ys = torch.randn(ys.numel() + 1, generator=torch.Generator().manual_seed(2))
    d_ys = d_ys.to(cuda_device)[1:].view(ys.shape)
    assert xp.is_contiguous() and xp.data_ptr() % 16 and d_ys.data_ptr() % 16
    got = gru_sequence_bwd(xp, w, b, h0, ys, d_ys)
    _assert_bwd_matches(got, gru_sequence_bwd_reference(xp, w, b, h0, ys, d_ys))


@pytest.mark.parametrize("nb,T,B,H", [(18, 768, 63, 56), (2, 100, 37, 128)])
def test_backward_repeats_bitwise(cuda_device, nb, T, B, H):
    """Two backward calls on the same inputs give the same bits: the
    kernel's sums have a fixed order and dW, db are one product and one sum
    after it (no atomics)."""
    inputs = _inputs(T, B, H, cuda_device, seed=6, lead=(nb,))
    ys = gru_sequence(*inputs)
    d_ys = torch.randn(ys.shape, generator=torch.Generator().manual_seed(8))
    d_ys = d_ys.to(cuda_device)
    first = gru_sequence_bwd(*inputs, ys, d_ys)
    second = gru_sequence_bwd(*inputs, ys, d_ys)
    torch.cuda.synchronize()
    for a, b, name in zip(first, second, ("dxp", "dw", "db", "dh0")):
        assert torch.equal(a, b), name


def test_bucket_axis_equals_separate_launches(cuda_device):
    nb, T, B, H = 5, 200, 19, 56
    inputs = _inputs(T, B, H, cuda_device, seed=2, lead=(nb,))
    stacked = gru_sequence(*inputs)
    for k in range(nb):
        one = gru_sequence(*(a[k].contiguous() for a in inputs))
        assert torch.equal(stacked[k], one)


def test_autograd_matches_cpu(cuda_device):
    """Gradients through gru_sequence on the card (K1 forward and backward)
    equal the CPU's (the plain versions)."""
    cpu = [a.requires_grad_() for a in _inputs(96, 9, 28, "cpu", seed=3, lead=(2,))]
    card = [a.detach().to(cuda_device).requires_grad_() for a in cpu]
    w = torch.randn((2, 96, 9, 28), generator=torch.Generator().manual_seed(4))
    (gru_sequence(*cpu) * w).sum().backward()
    (gru_sequence(*card) * w.to(cuda_device)).sum().backward()
    for a, b in zip(cpu, card):
        assert (a.grad - b.grad.cpu()).abs().max().item() <= 1e-4


def test_unstacked_autograd_matches_cpu(cuda_device):
    """One model (nb 1, no bucket axis) through gru_sequence's autograd
    path: one forward and one backward launch on the card, gradients equal
    to the CPU's."""
    cpu = [a.requires_grad_() for a in _inputs(128, 7, 56, "cpu", seed=4)]
    card = [a.detach().to(cuda_device).requires_grad_() for a in cpu]
    w = torch.randn((128, 7, 56), generator=torch.Generator().manual_seed(5))
    (gru_sequence(*cpu) * w).sum().backward()
    before = (gru_sequence.launches, gru_sequence_bwd.launches)
    (gru_sequence(*card) * w.to(cuda_device)).sum().backward()
    torch.cuda.synchronize()
    assert (gru_sequence.launches, gru_sequence_bwd.launches) == \
        (before[0] + 1, before[1] + 1)
    for a, b in zip(cpu, card):
        assert a.grad.shape == b.grad.shape
        assert (a.grad - b.grad.cpu()).abs().max().item() <= 1e-4


def _multigru_inputs(nb, T, B, He, Hg, Hs, Z, device, seed=0):
    g = torch.Generator().manual_seed(seed)
    r = lambda *s, sc=1.0: (torch.randn(s, generator=g) * sc).to(device)  # noqa
    xe, xg = r(nb, T, B, 3 * He), r(nb, T, B, 3 * Hg)
    weights = [r(nb, He, 3 * He, sc=He ** -0.5), r(nb, 3 * He, sc=0.1),
               r(nb, Hg, 3 * Hg, sc=Hg ** -0.5), r(nb, 3 * Hg, sc=0.1),
               r(nb, Hg, Z, sc=Hg ** -0.5), r(nb, Z, sc=0.1),
               r(nb, Z, 3 * Hs, sc=Z ** -0.5), r(nb, 3 * Hs, sc=0.1),
               r(nb, Hs, 3 * Hs, sc=Hs ** -0.5), r(nb, 3 * Hs, sc=0.1),
               r(nb, Hs, Z, sc=Hs ** -0.5), r(nb, Z, sc=0.1)]
    return xe, xg, weights


# the reference width at the training shape, the T > 800 width, ragged;
# adaptive_dims' narrowest (z16/h32), 20 channels (z40/h80) and widest
# (z64/h128) widths, every width at 128 (the largest shared memory a block
# takes: W_is^T at Z = Hs = 128), mixed widths; one step, and no step (no
# launch: nothing to compute)
@pytest.mark.parametrize("nb,T,B,dims", [(18, 768, 63, (28, 56, 56, 28)),
                                         (18, 1024, 63, (36, 72, 72, 36)),
                                         (3, 50, 7, (8, 12, 12, 8)),
                                         (2, 300, 37, (16, 32, 32, 16)),
                                         (18, 768, 63, (40, 80, 80, 40)),
                                         (3, 1024, 37, (64, 128, 128, 64)),
                                         (2, 64, 5, (128, 128, 128, 128)),
                                         (2, 100, 19, (20, 100, 72, 90)),
                                         (3, 1, 5, (28, 56, 56, 28)),
                                         (2, 0, 5, (28, 56, 56, 28))])
def test_multigru_kernel_matches_plain(cuda_device, nb, T, B, dims):
    xe, xg, weights = _multigru_inputs(nb, T, B, *dims, cuda_device)
    before = multigru_disc_inputs.launches
    got = multigru_disc_inputs(xe, xg, *weights)
    ref = multigru_disc_inputs_reference(xe, xg, *weights)
    torch.cuda.synchronize()
    assert multigru_disc_inputs.launches == before + (1 if T else 0)
    for g, r in zip(got, ref):
        assert g.shape == r.shape and torch.isfinite(g).all()
        if T:
            assert (g - r).abs().max().item() <= 1e-4


def test_multigru_takes_unaligned_inputs(cuda_device):
    """xp_e and xp_g as contiguous views 4 bytes into their storage, not
    16-byte aligned: the kernel copies them 4 bytes at a time and still
    matches the plain version."""
    nb, T, B, dims = 2, 200, 19, (28, 56, 56, 28)
    xe, xg, weights = _multigru_inputs(nb, T, B, *dims, cuda_device, seed=3)
    xe, xg = (torch.cat([t.new_zeros(1), t.reshape(-1)])[1:].view(t.shape) for t in (xe, xg))
    assert xe.is_contiguous() and xe.data_ptr() % 16 and xg.data_ptr() % 16
    got = multigru_disc_inputs(xe, xg, *weights)
    ref = multigru_disc_inputs_reference(xe, xg, *weights)
    for g, r in zip(got, ref):
        assert (g - r).abs().max().item() <= 1e-4


@pytest.mark.parametrize("nb,T,B,dims", [(18, 768, 63, (28, 56, 56, 28)),
                                         (3, 300, 37, (64, 128, 128, 64))])
def test_multigru_repeats_bitwise(cuda_device, nb, T, B, dims):
    """Two launches on the same inputs give the same bits: every sum has a
    fixed order, and the rings between the blocks change only when a value
    arrives, not what it is."""
    xe, xg, weights = _multigru_inputs(nb, T, B, *dims, cuda_device, seed=5)
    first = multigru_disc_inputs(xe, xg, *weights)
    second = multigru_disc_inputs(xe, xg, *weights)
    torch.cuda.synchronize()
    for a, b in zip(first, second):
        assert torch.equal(a, b)


def test_wide_disc_inputs_take_k1(cuda_device):
    """z40/h80 (20 channels): on the card fused_disc_inputs runs K2 (its
    three cells on a cluster of three blocks), no K1, and matches the same
    route on the CPU."""
    cfg = TimeGANConfig(x_dim=20, z_dim=40, h_dim=80)
    nb, B, T = 18, 63, 768
    params = timegan_init_stacked(
        cfg, [torch.Generator().manual_seed(b) for b in range(nb)], device="cpu")
    rng = np.random.default_rng(0)
    x = torch.from_numpy(rng.uniform(0, 1, (nb, B, T, 20)).astype(np.float32))
    z = torch.from_numpy(rng.uniform(0, 1, (nb, B, T, 40)).astype(np.float32))
    card = tree_map(lambda t: t.to(cuda_device), params)
    k1, k2 = gru_sequence.launches, multigru_disc_inputs.launches
    got = fused_disc_inputs(card, x.to(cuda_device), z.to(cuda_device))
    torch.cuda.synchronize()
    assert (gru_sequence.launches - k1, multigru_disc_inputs.launches - k2) == (0, 1)
    want = fused_disc_inputs(params, x, z)
    for g, w in zip(got, want):
        assert g.shape == (nb, B, T, 40) and torch.isfinite(g).all()
        assert (g.cpu() - w).abs().max().item() <= 1e-4


def test_cascade_chunked_equals_one_shot(cuda_device):
    model = TimeGAN(TimeGANConfig(), generator=torch.Generator().manual_seed(0),
                    device=cuda_device).eval()
    z = torch.rand((16, 3 * 64, 28), generator=torch.Generator().manual_seed(1))
    z = z.to(cuda_device)
    one_shot, _ = synthesize_from_noise(model, z)
    carry, pieces = None, []
    for t0 in range(0, z.shape[1], 64):
        x, carry = synthesize_from_noise(model, z[:, t0:t0 + 64], carry)
        pieces.append(x)
    assert (torch.cat(pieces, 1) - one_shot).abs().max().item() <= 1e-5


def _attn(B, H, T, D, device, seed=0):
    g = torch.Generator().manual_seed(seed)
    return [torch.randn((B, H, T, D), generator=g).to(device) for _ in range(4)]


# the CGAN's training geometry, its patch-1 geometry, ragged T with an odd D,
# one row, D at its cap, a T just over one tile, the patch-1 geometry at
# serve_batch 256, and a D that is not a multiple of 4 (4-byte copies)
@pytest.mark.parametrize("B,H,T,D", [(64, 4, 96, 64), (4, 4, 768, 64),
                                     (2, 3, 200, 48), (1, 1, 1, 16),
                                     (2, 2, 130, 128), (3, 1, 65, 20),
                                     (256, 4, 768, 64), (1, 2, 77, 3)])
def test_flash_kernels_match_plain(cuda_device, B, H, T, D):
    q, k, v, do = _attn(B, H, T, D, cuda_device, seed=T)
    counters = (flash_forward, flash_dq, flash_dkv)
    before = [c.launches for c in counters]
    o, lse = flash_forward(q, k, v)
    o_ref, lse_ref = flash_forward_plain(q, k, v)
    delta = (do * o_ref).sum(-1)
    dq = flash_dq(q, k, v, do, lse_ref, delta)
    dk, dv = flash_dkv(q, k, v, do, lse_ref, delta)
    torch.cuda.synchronize()
    assert [c.launches for c in counters] == [n + 1 for n in before]
    # f32 sums in another order: 1e-5 on o and lse, 1e-4 relative on the
    # gradients
    assert (o - o_ref).abs().max().item() <= 1e-5
    assert (lse - lse_ref).abs().max().item() <= 1e-5
    refs = (flash_dq_plain(q, k, v, do, lse_ref, delta),
            *flash_dkv_plain(q, k, v, do, lse_ref, delta))
    for got, ref, name in zip((dq, dk, dv), refs, ("dq", "dk", "dv")):
        assert torch.isfinite(got).all()
        if T == 1 and name in ("dq", "dk"):
            err, size = _t1_error(name, got, q, k, v, do, lse_ref, delta)
            assert err <= T1_RTOL * size, name
            continue
        size = ref.abs().max().item()
        assert (got - ref).abs().max().item() <= 1e-4 * size, name


# One key (T = 1): the softmax has zero gradient, so dq and dk are what is
# left of ds = p (dp - delta) scale, where dp = do . v and delta = do . o
# cancel; in float32 that is rounding noise, and the tensor cores' split-TF32
# sums round dp otherwise than the plain version's float32 product does, so
# the two noises do not match. There dq and dk are held instead to their
# function in float64 on the same inputs (the plain version in float64),
# within T1_RTOL of the size of the terms that cancel, sum_d |do_d v_d| (the
# largest over rows), times scale and the largest |k| (dq = ds k) or |q|
# (dk = ds^T q). T1_RTOL is 3.8 times the largest such error an H100 showed
# for K3b and K3c at chip_smoke.py's T = 1 shapes (1.315e-7, K3b at D 128;
# the plain float32 version's were up to 1.5e-8; PERF.md). The same limit
# holds the wide K3b and K3c at head dim 256.
T1_RTOL = 5e-7


def _t1_error(name, got, q, k, v, do, lse, delta):
    """(max |got - float64 value|, the size of the cancelling terms) of dq
    or dk at T = 1."""
    f64 = [t.double() for t in (q, k, v, do, lse, delta)]
    want = (flash_dq_plain(*f64) if name == "dq" else flash_dkv_plain(*f64)[0])
    other = k if name == "dq" else q
    terms = (do.double().abs() * v.double().abs()).sum(-1).max()
    size = (terms * q.shape[-1] ** -0.5 * other.abs().max()).item()
    return (got.double() - want).abs().max().item(), size


# heads wider than 128 (the wide kernels): the "auto" shape at head dim
# 160, a ragged T with an odd D just past 128, head dim 256 (a transformer
# CGAN of dim 512 with 2 heads) at 768 tokens, a D of two column groups of
# K3a and K3b, the first D past 128, a D of four column groups of K3c, and
# one key at head dim 256; K3a twice, bitwise equal
@pytest.mark.parametrize("B,H,T,D", [(1, 2, 512, 160), (2, 3, 77, 131),
                                     (2, 2, 768, 256), (1, 1, 40, 300),
                                     (2, 2, 64, 129), (1, 1, 100, 512),
                                     (1, 2, 1, 256)])
def test_wide_flash_kernels_match_plain(cuda_device, B, H, T, D):
    q, k, v, do = _attn(B, H, T, D, cuda_device, seed=D)
    counters = (flash_forward, flash_dq, flash_dkv)
    before = [(c.launches, c.wide_launches) for c in counters]
    o, lse = flash_forward(q, k, v)
    o_ref, lse_ref = flash_forward_plain(q, k, v)
    delta = (do * o_ref).sum(-1)
    dq = flash_dq(q, k, v, do, lse_ref, delta)
    dk, dv = flash_dkv(q, k, v, do, lse_ref, delta)
    torch.cuda.synchronize()
    assert [(c.launches, c.wide_launches) for c in counters] == \
        [(n, w + 1) for n, w in before]
    assert (o - o_ref).abs().max().item() <= 1e-5
    assert (lse - lse_ref).abs().max().item() <= 1e-5
    o2, lse2 = flash_forward(q, k, v)      # no atomics: the same bits again
    assert torch.equal(o, o2) and torch.equal(lse, lse2)
    refs = (flash_dq_plain(q, k, v, do, lse_ref, delta),
            *flash_dkv_plain(q, k, v, do, lse_ref, delta))
    for got, ref, name in zip((dq, dk, dv), refs, ("dq", "dk", "dv")):
        assert torch.isfinite(got).all()
        if T == 1 and name in ("dq", "dk"):
            err, size = _t1_error(name, got, q, k, v, do, lse_ref, delta)
            assert err <= T1_RTOL * size, name
            continue
        assert (got - ref).abs().max().item() <= 1e-4 * ref.abs().max().item(), name


# B·H past 65,535 (once the limit of a grid's second dimension): the
# tensor-core kernels at D 8 and the wide kernels at D 136
@pytest.mark.parametrize("T,D", [(20, 8), (3, 136)])
def test_flash_kernels_take_any_bh(cuda_device, T, D):
    q, k, v, do = _attn(65537, 1, T, D, cuda_device, seed=13)
    o, lse = flash_forward(q, k, v)
    o_ref, lse_ref = flash_forward_plain(q, k, v)
    assert (o - o_ref).abs().max().item() <= 1e-5
    assert (lse - lse_ref).abs().max().item() <= 1e-5
    delta = (do * o_ref).sum(-1)
    got = (flash_dq(q, k, v, do, lse_ref, delta), *flash_dkv(q, k, v, do, lse_ref, delta))
    refs = (flash_dq_plain(q, k, v, do, lse_ref, delta),
            *flash_dkv_plain(q, k, v, do, lse_ref, delta))
    for a, ref in zip(got, refs):
        assert (a - ref).abs().max().item() <= 1e-4 * ref.abs().max().item()


# the tensor-core kernels at D 32, the wide kernels at D 136
@pytest.mark.parametrize("B,H,T,D", [(2, 2, 150, 32), (1, 2, 70, 136)])
def test_flash_kernels_take_unaligned_inputs(cuda_device, B, H, T, D):
    """Contiguous views that start 4 bytes into their storage are not
    16-byte aligned: K3a, K3b and K3c load them with 4-byte copies and
    still match their plain versions."""
    g = torch.Generator().manual_seed(11)
    q, k, v, do = [torch.randn(B * H * T * D + 1, generator=g).to(cuda_device)[1:]
                   .view(B, H, T, D) for _ in range(4)]
    assert q.is_contiguous() and q.data_ptr() % 16 != 0
    o, lse = flash_forward(q, k, v)
    o_ref, lse_ref = flash_forward_plain(q, k, v)
    assert (o - o_ref).abs().max().item() <= 1e-5
    assert (lse - lse_ref).abs().max().item() <= 1e-5
    delta = (do * o_ref).sum(-1)
    got = (flash_dq(q, k, v, do, lse_ref, delta), *flash_dkv(q, k, v, do, lse_ref, delta))
    refs = (flash_dq_plain(q, k, v, do, lse_ref, delta),
            *flash_dkv_plain(q, k, v, do, lse_ref, delta))
    for a, ref in zip(got, refs):
        assert (a - ref).abs().max().item() <= 1e-4 * ref.abs().max().item()


def test_flash_kernels_are_deterministic(cuda_device):
    """Two launches of K3a, K3b and K3c on the same inputs give bitwise
    equal o, lse, dq, dk and dv: no atomics, a fixed order of sums. The
    same for the wide kernels at head dim 160 and 256."""
    for shape in ((8, 4, 768, 64), (2, 2, 300, 160), (2, 2, 300, 256)):
        q, k, v, do = _attn(*shape, cuda_device, seed=9)
        o, lse = flash_forward(q, k, v)
        o2, lse2 = flash_forward(q, k, v)
        delta = (do * o).sum(-1)
        dq, dq2 = flash_dq(q, k, v, do, lse, delta), flash_dq(q, k, v, do, lse, delta)
        dk, dv = flash_dkv(q, k, v, do, lse, delta)
        dk2, dv2 = flash_dkv(q, k, v, do, lse, delta)
        for a, b in ((o, o2), (lse, lse2), (dq, dq2), (dk, dk2), (dv, dv2)):
            assert torch.equal(a, b), shape


def test_flash_attention_autograd_matches_cpu(cuda_device):
    """flash_attention's forward and gradients on the card (K3a, K3b, K3c)
    equal the CPU's (the plain versions); a second derivative raises."""
    cpu = [t.requires_grad_() for t in _attn(2, 2, 150, 32, "cpu", seed=5)[:3]]
    card = [t.detach().to(cuda_device).requires_grad_() for t in cpu]
    w = torch.randn((2, 2, 150, 32), generator=torch.Generator().manual_seed(6))
    out_cpu, out_card = flash_attention(*cpu), flash_attention(*card)
    assert (out_cpu - out_card.cpu()).abs().max().item() <= 1e-5
    (out_cpu * w).sum().backward()
    (out_card * w.to(cuda_device)).sum().backward()
    for a, b in zip(cpu, card):
        assert (a.grad - b.grad.cpu()).abs().max().item() <= 1e-4
    x = card[0].detach().requires_grad_()
    (g,) = torch.autograd.grad(flash_attention(x, card[1], card[2]).sum(), x,
                               create_graph=True)
    with pytest.raises(RuntimeError):
        g.sum().backward()


def test_auto_takes_the_wide_kernels_past_head_dim_128(cuda_device):
    """At head dim 160 and 512 tokens "auto" runs the wide kernels on the
    card, as JAX's mha runs its kernel at any head dim: one forward, one dq
    and one dk/dv launch through autograd, matching dense attention and its
    gradients."""
    leaves = [t.requires_grad_() for t in _attn(1, 2, 512, 160, cuda_device, seed=12)[:3]]
    dense = [t.detach().clone().requires_grad_() for t in leaves]
    w = torch.randn((1, 2, 512, 160), generator=torch.Generator().manual_seed(3))
    w = w.to(cuda_device)
    counters = (flash_forward, flash_dq, flash_dkv)
    before = [c.wide_launches for c in counters]
    got = mha(*leaves, impl="auto")
    (got * w).sum().backward()
    want = attention_dense(*dense)
    (want * w).sum().backward()
    assert [c.wide_launches for c in counters] == [n + 1 for n in before]
    assert (got - want).abs().max().item() <= 1e-5
    for a, b in zip(leaves, dense):
        assert (a.grad - b.grad).abs().max().item() <= 1e-4 * b.grad.abs().max().item()


def test_flash_wrappers_raise_instead_of_falling_back(cuda_device):
    q, k, v, _ = _attn(1, 2, 16, 8, cuda_device)
    with pytest.raises(TypeError, match="float32"):
        flash_forward(q.double(), k, v)
    with pytest.raises(ValueError, match="contiguous"):
        flash_forward(q.transpose(2, 3).contiguous().transpose(2, 3), k, v)
    with pytest.raises(ValueError, match="several devices"):
        flash_forward(q, k.cpu(), v)
    before = (flash_forward.launches, flash_forward.wide_launches)
    flash_forward(*_attn(1, 1, 4, 160, cuda_device)[:3])    # past D 128: wide
    assert (flash_forward.launches, flash_forward.wide_launches) == \
        (before[0], before[1] + 1)
    assert mha(q, k, v, impl="auto").shape == q.shape      # T < 512: dense


def _scorer_tasks(n_tasks, rows, test_rows, T, C, out_dim, seed):
    rng = np.random.default_rng(seed)
    return [{"params": eval_classifiers._rnn_head_init(i, C, 24, out_dim),
             "Xtr": rng.uniform(0, 1, (rows, T, C)).astype(np.float32),
             "ytr": (rng.integers(0, 2, (rows, out_dim)) if out_dim == 1 else
                     rng.uniform(0, 1, (rows, out_dim))).astype(np.float32),
             "Xte": rng.uniform(0, 1, (test_rows, T, C)).astype(np.float32)}
            for i in range(n_tasks)]


@pytest.mark.parametrize("classify", [True, False])
def test_eval_scorer_group_matches_cpu(cuda_device, classify):
    """One stack of GRU(24) scorers trained 2 epochs on the card (K1 forward
    and backward, nb = tasks) and on the CPU (the plain versions): the test
    rows' outputs within 1e-4; each epoch one forward and one backward
    launch, then one forward for the test rows."""
    tasks = _scorer_tasks(3, 63, 27, 96, 14, 1 if classify else 14, seed=0)
    cpu = eval_classifiers._run_grouped(tasks, 2, 1e-3, classify, "cpu")
    before = (gru_sequence.launches, gru_sequence_bwd.launches)
    card = eval_classifiers._run_grouped(tasks, 2, 1e-3, classify, cuda_device)
    assert (gru_sequence.launches, gru_sequence_bwd.launches) == \
        (before[0] + 3, before[1] + 2)
    for a, b in zip(card, cpu):
        assert a.shape == b.shape and np.isfinite(a).all()
        assert np.abs(a - b).max() <= 1e-4


def test_eval_statistics_match_cpu(cuda_device):
    """Welch and the channel correlations on the card against the CPU
    (relative 1e-5); the ACF feature runs on the host in float64 either way."""
    rng = np.random.default_rng(1)
    real = rng.uniform(0, 1, (63, 768, 14)).astype(np.float32)
    fake = rng.uniform(0, 1, (63, 768, 14)).astype(np.float32)
    card = statistical_similarity(real, fake, device=cuda_device)
    cpu = statistical_similarity(real, fake, device="cpu")
    assert card[0] == pytest.approx(cpu[0], rel=1e-5)
    assert card[1] == pytest.approx(cpu[1], rel=0, abs=1e-10)
    assert card[2] == pytest.approx(cpu[2], rel=1e-5)


def test_eval_scores_launch_k1(cuda_device):
    """The batch scorers on the card go through K1: two pairs of one shape
    are one stack, so 2 epochs launch the forward 3 times and the backward
    twice."""
    rng = np.random.default_rng(2)
    pairs = [(rng.uniform(0, 1, (20, 64, 5)).astype(np.float32),
              rng.uniform(0, 1, (20, 64, 5)).astype(np.float32)) for _ in range(2)]
    before = (gru_sequence.launches, gru_sequence_bwd.launches)
    res = eval_classifiers.discriminative_scores_batch(pairs, epochs=2,
                                                       device=cuda_device)
    assert (gru_sequence.launches, gru_sequence_bwd.launches) == \
        (before[0] + 3, before[1] + 2)
    assert all(0.0 <= acc <= 1.0 and np.isfinite(auc) for acc, auc in res)
