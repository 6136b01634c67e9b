"""eegsynth_torch on a CUDA card: the Hopper kernels (K1 forward and
backward, K2, flash attention K3a/K3b/K3c, for head dims to 128 and past
it) against their plain versions,
K1's bucket axis against separate launches, the wrappers' checks, gradients
through K1 and through flash_attention against the CPU, the serving
cascade chunked against one-shot, the eval's GRU(24) scorers and
statistics against the CPU, the sequential trainer (one GAN step of a
2-layer stack with dropout masks against the CPU, and a short run), and the
conv CGAN (a v1 and a v2 step against the CPU, a bfloat16 D step, the
generator against the CPU), bfloat16 synthesis against the CPU, the
CGAN eval's metric functions against the CPU, a weight sweep's stacked GAN
step against the CPU, a posture-stack member against its lone step, a
remat transformer step against the plain one, the IIR filter kernel against
its plain version, preprocessing and the fatigue spectra against the
CPU, and the figures' PCA, t-SNE, spectrogram and resampling against the
CPU and a figure CLI on the card.

Every test skips without a card: the kernels have no CPU mode, and a
test of the card's route has nothing to compare without one. This file
imports no jax, so it also runs on a machine without it:

    python -m pytest --noconftest tests/test_torch_card.py -q
"""

import numpy as np
import pytest
import torch

from eegsynth_torch.eval import cgan_eval
from eegsynth_torch.eval import classifiers as eval_classifiers
from eegsynth_torch.eval.stats import statistical_similarity
from eegsynth_torch.models.timegan import (
    TimeGAN, TimeGANConfig, fused_disc_inputs, params_tree, timegan_init_stacked,
)
from eegsynth_torch.nn.attention import (
    attention_dense, flash_attention, flash_dkv, flash_dkv_plain, flash_dq,
    flash_dq_plain, flash_forward, flash_forward_plain, mha,
)
from eegsynth_torch.nn.gru_sequence import (
    GRID_MAX_HIDDEN, MAX_HIDDEN, cluster_bwd_geometry, cluster_bwd_plan, cluster_card,
    cluster_geometry, cluster_plan, grid_bwd_plan, grid_plan, grid_stream_plan, gru_sequence,
    gru_sequence_bwd, gru_sequence_bwd_reference, gru_sequence_bwd_wide, gru_sequence_reference,
    gru_sequence_wide, weight_grads, wide_bwd_plan, wide_cap, wide_plan,
)
from eegsynth_torch.nn.multigru import (
    multigru_disc_inputs, multigru_disc_inputs_reference,
)
from eegsynth_torch.nn.precision import cast_floating
from eegsynth_torch.train import cgan as cgan_train
from eegsynth_torch.train import cgan_multi
from eegsynth_torch.train import timegan as ttrain
from eegsynth_torch.train.optim import make_gan_opts
from eegsynth_torch.train.timegan import synthesize_from_noise
from eegsynth_torch.tree import tree_leaves, tree_map
from eegsynth_torch.viz import embed

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


def _device_inputs(T, B, H, device, seed=0, lead=()):
    """_inputs' distributions drawn on the card: at the wide route's cap W_hhᵀ
    alone is 1.1 GB of float32."""
    g = torch.Generator(device=device).manual_seed(seed)
    xp = torch.randn((*lead, T, B, 3 * H), generator=g, device=device)
    w = torch.randn((*lead, H, 3 * H), generator=g, device=device) / H ** 0.5
    b = torch.randn((*lead, 1, 3 * H), generator=g, device=device) * 0.1
    h0 = torch.rand((*lead, B, H), generator=g, device=device) - 0.5
    return [xp, w, b, h0]


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
                                      (200, 1587, 24, 1), (768, 64, 56, 1),
                                      (767, 64, 56, 1), (768, 26, 56, 1),
                                      (767, 26, 56, 1)])
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
    past = wide_cap(cluster_card()) + 1
    with pytest.raises(ValueError, match=f"H={past} past the wide route's cap H {past - 1}"):
        gru_sequence(*(torch.zeros(shape, device=cuda_device)
                       for shape in ((2, 2, 3 * past), (past, 3 * past), (1, 3 * past),
                                     (2, past))))
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
# of tasks of 63 rows, one task of 1134 rows); the sequential trainer's
# one bucket of B 64 and of a small bucket's odd B 26, at T 768 and at the
# supervisor's T 767
@pytest.mark.parametrize("nb,T,B,H", [(18, 768, 63, 56), (18, 768, 63, 28),
                                      (3, 1024, 37, 128), (2, 64, 133, 20),
                                      (2, 100, 37, 16), (2, 300, 37, 80),
                                      (2, 50, 37, 127), (3, 1, 5, 56),
                                      (36, 200, 63, 24), (1, 200, 1134, 24),
                                      (1, 768, 64, 56), (1, 767, 64, 56),
                                      (1, 768, 26, 56), (1, 767, 26, 56)])
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


def _wide_counts() -> tuple:
    """K1 forward, the wide route's cluster, grid, streaming and grid past
    H 1024 forwards, K1 backward, the wide route's cluster, streaming and
    grid backwards."""
    return (gru_sequence.launches, gru_sequence_wide.cluster_launches,
            gru_sequence_wide.grid_launches, gru_sequence_wide.launches,
            gru_sequence_wide.grid_stream_launches, gru_sequence_bwd.launches,
            gru_sequence_bwd_wide.cluster_launches, gru_sequence_bwd_wide.launches,
            gru_sequence_bwd_wide.grid_launches)


def _wide_forward(nb, B, H) -> list:
    """The wide forward's launches _wide_counts expects at (nb, B, H): the
    cluster kernel where the card's cluster plan fits, the grid kernel (one
    launch a wave of buckets) where its blocks are resident, past H 1024 the
    grid that streams W's remainder (one launch a wave), else the streaming
    kernel."""
    plan = wide_plan(nb, B, H, cluster_card())
    route = plan["route"]
    return [0, int(route == "cluster"), plan["waves"] if route == "grid" else 0,
            int(route == "stream"), plan["waves"] if route == "grid_stream" else 0]


def _wide_backward(nb, B, H) -> list:
    """The wide backward's launches _wide_counts expects at (nb, B, H): the
    cluster kernel where the card's backward plan fits, the grid kernel (one
    launch a wave of buckets) where its blocks are resident, else the
    streaming kernel."""
    plan = wide_bwd_plan(nb, B, H, cluster_card())
    route = plan["route"]
    return [0, int(route == "cluster"), int(route == "stream"),
            plan["waves"] if route == "grid" else 0]


# K1's wide route (H past 128; each half on a cluster up to its cap, in
# gru_seq_cluster.cu and gru_seq_cluster_bwd.cu; past it each half on a
# grid, gru_seq_grid.cu and gru_seq_grid_bwd.cu; past H 1024 the forward on
# the grid that streams W's remainder, gru_seq_grid_stream.cu, and the
# backward on the streaming kernel, gru_seq_wide.cu): the first width past
# the register kernels' cap (3H and H not multiples of 4: the scalar
# tails), H 256 and 512 (bench_kernels' sweep) with odd T and B, a batch
# past one wave, one step, the grids' largest H; past it H 1025 (nb 2: two
# waves forward, two columns a thread backward), 1536 (ten 64-row tiles
# forward, four rows a block backward), 2048 and the wide route's cap on
# this card (ten groups a block forward; one row a block backward, its dhp
# filling a block's shared memory) at a short T
@pytest.mark.parametrize("nb,T,B,H", [(2, 101, 37, 129), (2, 301, 33, 256),
                                      (2, 77, 5, 512), (1, 50, 600, 200),
                                      (3, 1, 5, 256), (1, 20, 3, 1024),
                                      (2, 40, 5, 1025), (1, 30, 600, 1536),
                                      (1, 20, 3, 2048), (1, 4, 2, "cap")])
def test_wide_kernels_match_plain(cuda_device, nb, T, B, H):
    if H == "cap":
        H = wide_cap(cluster_card())
        inputs = _device_inputs(T, B, H, cuda_device, seed=H, lead=(nb,))
    else:
        inputs = _inputs(T, B, H, cuda_device, seed=H, lead=(nb,))
    if H > GRID_MAX_HIDDEN:
        waves = wide_plan(nb, B, H, cluster_card())["waves"]
        assert _wide_forward(nb, B, H) + _wide_backward(nb, B, H) == [0, 0, 0, 0, waves,
                                                                      0, 0, 1, 0]
    before = _wide_counts()
    ys = gru_sequence(*inputs)
    ref = gru_sequence_reference(*inputs)
    d_ys = torch.randn(ys.shape, generator=torch.Generator().manual_seed(1))
    d_ys = d_ys.to(cuda_device)
    got = gru_sequence_bwd(*inputs, ys, d_ys)
    want = gru_sequence_bwd_reference(*inputs, ys, d_ys)
    torch.cuda.synchronize()
    assert [a - b for a, b in zip(_wide_counts(), before)] == [*_wide_forward(nb, B, H),
                                                              *_wide_backward(nb, B, H)]
    assert ys.shape == (nb, T, B, H) and torch.isfinite(ys).all()
    assert (ys - ref).abs().max().item() <= 1e-4
    _assert_bwd_matches(got, want)


# each cluster size, its plan given: widths not a multiple of C or of 4,
# a ragged last block (H 129 on two blocks of 65 units, H 300 on sixteen of
# 19), nb 3, and sixteen blocks at H 512 with eight rows (231,440 shared
# bytes a block)
@pytest.mark.parametrize("C,R,nb,T,B,H", [(2, 8, 1, 60, 37, 129), (4, 4, 2, 75, 9, 200),
                                          (8, 2, 3, 33, 5, 300), (8, 4, 1, 40, 64, 256),
                                          (16, 8, 1, 30, 64, 512), (16, 1, 2, 25, 3, 300)])
def test_cluster_forward_each_size_matches_plain(cuda_device, C, R, nb, T, B, H):
    inputs = _inputs(T, B, H, cuda_device, seed=H + C, lead=(nb,))
    plan = {"route": "cluster", "C": C, "R": R, **cluster_geometry(H, C)}
    before = _wide_counts()
    ys = gru_sequence_wide(*inputs, plan=plan)
    torch.cuda.synchronize()
    assert [a - b for a, b in zip(_wide_counts(), before)] == [0, 1, 0, 0, 0, 0, 0, 0, 0]
    assert ys.shape == (nb, T, B, H) and torch.isfinite(ys).all()
    assert (ys - gru_sequence_reference(*inputs)).abs().max().item() <= 1e-4


# the plan's own choice: a ragged batch past one wave, nb 3 at T 1, and
# the training batch of eighteen buckets
@pytest.mark.parametrize("nb,T,B,H", [(1, 40, 600, 300), (3, 1, 5, 200), (18, 50, 63, 256)])
def test_cluster_route_matches_plain(cuda_device, nb, T, B, H):
    inputs = _inputs(T, B, H, cuda_device, seed=T + H, lead=(nb,))
    before = _wide_counts()
    ys = gru_sequence(*inputs)
    torch.cuda.synchronize()
    assert [a - b for a, b in zip(_wide_counts(), before)] == [0, 1, 0, 0, 0, 0, 0, 0, 0]
    assert (ys - gru_sequence_reference(*inputs)).abs().max().item() <= 1e-4


def test_cluster_route_ends_at_its_cap(cuda_device):
    """The largest H a cluster holds on this card runs the cluster kernel,
    the next H the grid kernel; both match the plain version. Two
    calls of the cluster kernel give the same bits, and a plan it cannot
    launch raises."""
    card = cluster_card()
    cap = max(H for H in range(MAX_HIDDEN + 1, GRID_MAX_HIDDEN + 1)
              if cluster_plan(1, 1, H, card)["route"] == "cluster")
    for H, want in ((cap, [0, 1, 0, 0, 0, 0, 0, 0, 0]), (cap + 1, [0, 0, 1, 0, 0, 0, 0, 0, 0])):
        inputs = _inputs(40, 5, H, cuda_device, seed=H, lead=(1,))
        before = _wide_counts()
        ys = gru_sequence(*inputs)
        torch.cuda.synchronize()
        assert [a - b for a, b in zip(_wide_counts(), before)] == want, H
        assert (ys - gru_sequence_reference(*inputs)).abs().max().item() <= 1e-4
    inputs = _inputs(200, 37, 256, cuda_device, seed=7, lead=(2,))
    assert torch.equal(gru_sequence(*inputs), gru_sequence(*inputs))
    inputs = _inputs(10, 3, 129, cuda_device, seed=8, lead=(1,))
    empty_block = {"route": "cluster", "C": 16, "R": 1, **cluster_geometry(129, 16)}
    with pytest.raises(RuntimeError, match="gru_seq_cluster_fwd"):
        gru_sequence_wide(*inputs, plan=empty_block)


# the grid forward (gru_seq_grid.cu), the card's plan given: below the cap
# at H 160 and 544 (forced; 20 and 68 blocks), the cap + 1 (69 blocks, the
# last owning one unit), a ragged depth (600, 777: odd, 98 blocks), the
# largest H (128 blocks), nb 3 (three waves at 1024), B 1, 9, 64 and 600
# (ten 64-row tiles, the last ragged), B 70 (a full and a ragged tile) and
# B 5 (a stage holding 50 parts of 16), T 1
@pytest.mark.parametrize("nb,T,B,H", [(1, 30, 9, 160), (1, 101, 9, 545), (3, 40, 64, 600),
                                      (1, 20, 600, 777), (3, 25, 64, 1024), (1, 1, 1, 1024),
                                      (1, 50, 1, 545), (3, 1, 9, 777), (1, 12, 600, 1024),
                                      (1, 40, 70, 160), (1, 30, 5, 544), (1, 30, 70, 777),
                                      (1, 30, 5, 1024)])
def test_grid_forward_matches_plain(cuda_device, nb, T, B, H):
    inputs = _inputs(T, B, H, cuda_device, seed=H + T, lead=(nb,))
    plan = grid_plan(nb, B, H, cluster_card())
    before = _wide_counts()
    ys = gru_sequence_wide(*inputs, plan=plan)
    torch.cuda.synchronize()
    assert [a - b for a, b in zip(_wide_counts(), before)] == [0, 0, plan["waves"], 0, 0,
                                                              0, 0, 0, 0]
    assert ys.shape == (nb, T, B, H) and torch.isfinite(ys).all()
    assert (ys - gru_sequence_reference(*inputs)).abs().max().item() <= 1e-4


def test_grid_route_takes_over_past_the_cluster_cap(cuda_device):
    """The automatic route: the largest H a cluster holds on this card runs
    the cluster kernel, the next H and 1024 the grid kernel, by the
    counters; all match the plain version. Two calls of the grid kernel
    give the same bits; T = 0 launches nothing; a plan with more blocks than
    the card holds resident at once is refused by the cooperative launch and
    raises."""
    card = cluster_card()
    cap = max(H for H in range(MAX_HIDDEN + 1, GRID_MAX_HIDDEN + 1)
              if cluster_plan(1, 1, H, card)["route"] == "cluster")
    for H, want in ((cap, [0, 1, 0, 0, 0, 0, 0, 0, 0]), (cap + 1, [0, 0, 1, 0, 0, 0, 0, 0, 0]),
                    (GRID_MAX_HIDDEN, [0, 0, 1, 0, 0, 0, 0, 0, 0])):
        inputs = _inputs(40, 9, H, cuda_device, seed=H, lead=(1,))
        before = _wide_counts()
        ys = gru_sequence(*inputs)
        torch.cuda.synchronize()
        assert [a - b for a, b in zip(_wide_counts(), before)] == want, H
        assert (ys - gru_sequence_reference(*inputs)).abs().max().item() <= 1e-4
    inputs = _inputs(200, 37, 777, cuda_device, seed=7, lead=(2,))
    assert torch.equal(gru_sequence(*inputs), gru_sequence(*inputs))
    inputs = _inputs(0, 9, 1024, cuda_device, lead=(3,))
    before = _wide_counts()
    ys = gru_sequence(*inputs)
    torch.cuda.synchronize()
    assert ys.shape == (3, 0, 9, 1024)
    assert [a - b for a, b in zip(_wide_counts(), before)] == [0] * 9
    inputs = _inputs(10, 3, 1024, cuda_device, seed=8, lead=(2,))
    plan = grid_plan(2, 3, 1024, card)
    too_many = {**plan, "buckets_per_wave": 2}
    assert 2 * plan["blocks"] > plan["resident"]
    with pytest.raises(RuntimeError, match="gru_seq_grid_fwd"):
        gru_sequence_wide(*inputs, plan=too_many)


# the grid forward past H 1024 (gru_seq_grid_stream.cu) on its planned
# route: H 1025 at nb 2 (two waves of 129 blocks of 8 units), 1536 and 2048
# at the sequential trainer's bucket (96 and 128 blocks of 16 units), a
# ragged B (63) and T (767), three 64-row tiles (B 130), every other group
# count its plans take (J 3 to 9 at H 3000 to 9000), and the wide route's
# cap (T 8, B 2: ten groups, all of W streamed)
@pytest.mark.parametrize("nb,T,B,H", [(2, 40, 37, 1025), (1, 30, 64, 1536), (1, 20, 64, 2048),
                                      (1, 25, 63, 1536), (1, 767, 64, 1536), (1, 6, 130, 1536),
                                      (1, 6, 5, 3000), (1, 6, 5, 4000), (1, 6, 5, 5000),
                                      (1, 6, 5, 6000), (1, 6, 5, 7000), (1, 6, 5, 8000),
                                      (1, 6, 5, 9000), (1, 8, 2, "cap")])
def test_grid_stream_forward_matches_plain(cuda_device, nb, T, B, H):
    if H == "cap":
        H = wide_cap(cluster_card())
    inputs = _device_inputs(T, B, H, cuda_device, seed=H + T, lead=(nb,))
    plan = wide_plan(nb, B, H, cluster_card())
    assert plan["route"] == "grid_stream"
    assert plan == grid_stream_plan(nb, B, H, cluster_card())
    before = _wide_counts()
    ys = gru_sequence_wide(*inputs)
    torch.cuda.synchronize()
    assert [a - b for a, b in zip(_wide_counts(), before)] == [0, 0, 0, 0, plan["waves"],
                                                              0, 0, 0, 0]
    assert ys.shape == (nb, T, B, H) and torch.isfinite(ys).all()
    assert (ys - gru_sequence_reference(*inputs)).abs().max().item() <= 1e-4


def test_grid_stream_forward_repeats_bitwise_and_takes_unaligned_inputs(cuda_device):
    """The grid forward past H 1024 sums in a fixed order: two calls give
    the same bits; xp and W_hhᵀ 4 bytes into their storage are read as they
    are; T = 0 launches nothing; a plan with more blocks than the card holds
    resident at once is refused by the cooperative launch and raises."""
    nb, T, B, H = 2, 30, 9, 1100
    xp, w, b, h0 = _inputs(T, B, H, cuda_device, seed=11, lead=(nb,))
    xp = torch.cat([xp.new_zeros(1), xp.reshape(-1)])[1:].view(xp.shape)
    w = torch.cat([w.new_zeros(1), w.reshape(-1)])[1:].view(w.shape)
    ys = gru_sequence(xp, w, b, h0)
    assert torch.equal(ys, gru_sequence(xp, w, b, h0))
    assert (ys - gru_sequence_reference(xp, w, b, h0)).abs().max().item() <= 1e-4
    inputs = _inputs(0, 9, H, cuda_device, lead=(3,))
    before = _wide_counts()
    assert gru_sequence(*inputs).shape == (3, 0, 9, H)
    torch.cuda.synchronize()
    assert [a - b for a, b in zip(_wide_counts(), before)] == [0] * 9
    plan = grid_stream_plan(nb, B, H, cluster_card())
    too_many = {**plan, "buckets_per_wave": 2}
    assert 2 * plan["blocks"] > plan["resident"]
    with pytest.raises(RuntimeError, match="gru_seq_grid_stream_fwd"):
        gru_sequence_wide(xp, w, b, h0, plan=too_many)


def _wide_bwd_inputs(nb, T, B, H, device, seed):
    """A wide backward's inputs as gru_sequence_bwd feeds its kernel: the
    forward's, ys from the plain recurrence, d_ys, h_prev = [h0, ys[:-1]]
    and hp = h_prev W_hhᵀ (nb, T·B, ·)."""
    inputs = _inputs(T, B, H, device, seed=seed, lead=(nb,))
    ys = gru_sequence_reference(*inputs)
    d_ys = torch.randn(ys.shape, generator=torch.Generator().manual_seed(seed)).to(device)
    h_prev = torch.cat([inputs[3].unsqueeze(1), ys[:, :T - 1]], dim=1).reshape(nb, T * B, H)
    return inputs, ys, d_ys, h_prev, torch.matmul(h_prev, inputs[1])


# each cluster size, its backward plan given: widths not a multiple of C or
# of 4 (quads that straddle two blocks), a ragged last block (H 129 on two
# blocks of 65 units, H 300 on eight of 38 and on sixteen of 19), nb 3,
# each S, and sixteen blocks at H 512 (218,160 shared bytes a block)
@pytest.mark.parametrize("C,R,S,nb,T,B,H", [(2, 2, 4, 1, 60, 37, 129), (4, 4, 4, 2, 75, 9, 200),
                                            (8, 2, 4, 3, 33, 5, 300), (8, 4, 2, 1, 40, 64, 256),
                                            (16, 4, 1, 1, 30, 64, 512), (16, 1, 4, 2, 25, 3, 300),
                                            (16, 8, 2, 1, 20, 20, 256), (16, 2, 8, 3, 21, 7, 256)])
def test_cluster_backward_each_size_matches_plain(cuda_device, C, R, S, nb, T, B, H):
    inputs, ys, d_ys, h_prev, hp = _wide_bwd_inputs(nb, T, B, H, cuda_device, seed=H + C)
    plan = {"route": "cluster", "C": C, "R": R, **cluster_bwd_geometry(H, C, S)}
    before = _wide_counts()
    dxp, dh0 = gru_sequence_bwd_wide(inputs[0], hp, h_prev, d_ys, inputs[1], inputs[2], hp,
                                     plan=plan)
    torch.cuda.synchronize()
    assert [a - b for a, b in zip(_wide_counts(), before)] == [0, 0, 0, 0, 0, 0, 1, 0, 0]
    ref = gru_sequence_bwd_reference(*inputs, ys, d_ys)
    dw, db = weight_grads(h_prev, hp)
    _assert_bwd_matches((dxp, dw, db, dh0), ref)


# the backward plan's own choice: eighteen buckets of the training batch
# (past one wave), a ragged batch past one wave, and nb 3 at T 1
@pytest.mark.parametrize("nb,T,B,H", [(18, 50, 63, 256), (1, 40, 600, 300), (3, 1, 5, 200)])
def test_cluster_backward_route_matches_plain(cuda_device, nb, T, B, H):
    inputs = _inputs(T, B, H, cuda_device, seed=T + H, lead=(nb,))
    ys = gru_sequence_reference(*inputs)
    d_ys = torch.randn(ys.shape, generator=torch.Generator().manual_seed(4)).to(cuda_device)
    before = _wide_counts()
    got = gru_sequence_bwd(*inputs, ys, d_ys)
    torch.cuda.synchronize()
    assert [a - b for a, b in zip(_wide_counts(), before)] == [0, 0, 0, 0, 0, 0, 1, 0, 0]
    _assert_bwd_matches(got, gru_sequence_bwd_reference(*inputs, ys, d_ys))


def test_cluster_backward_ends_at_its_cap(cuda_device):
    """The largest H a backward cluster holds on this card runs the cluster
    backward, the next H the grid one; both match the plain backward.
    Two calls of the cluster backward give the same bits, T = 0 gives zero
    gradients, and a plan it cannot launch raises."""
    card = cluster_card()
    cap = max(H for H in range(MAX_HIDDEN + 1, GRID_MAX_HIDDEN + 1)
              if cluster_bwd_plan(1, 1, H, card)["route"] == "cluster")
    for H, want in ((cap, [0, 0, 0, 0, 0, 0, 1, 0, 0]), (cap + 1, [0, 0, 0, 0, 0, 0, 0, 0, 1])):
        inputs = _inputs(40, 5, H, cuda_device, seed=H, lead=(1,))
        ys = gru_sequence_reference(*inputs)
        d_ys = torch.randn(ys.shape, generator=torch.Generator().manual_seed(H)).to(cuda_device)
        before = _wide_counts()
        got = gru_sequence_bwd(*inputs, ys, d_ys)
        torch.cuda.synchronize()
        assert [a - b for a, b in zip(_wide_counts(), before)] == want, H
        _assert_bwd_matches(got, gru_sequence_bwd_reference(*inputs, ys, d_ys))
    inputs = _inputs(200, 37, 256, cuda_device, seed=7, lead=(2,))
    ys = gru_sequence(*inputs)
    d_ys = torch.randn(ys.shape, generator=torch.Generator().manual_seed(9)).to(cuda_device)
    for a, b in zip(gru_sequence_bwd(*inputs, ys, d_ys), gru_sequence_bwd(*inputs, ys, d_ys)):
        assert torch.equal(a, b)
    inputs = _inputs(0, 5, 256, cuda_device, lead=(2,))
    ys = gru_sequence_reference(*inputs)
    before = _wide_counts()
    dxp, dw, db, dh0 = gru_sequence_bwd(*inputs, ys, torch.zeros_like(ys))
    torch.cuda.synchronize()
    assert [a - b for a, b in zip(_wide_counts(), before)] == [0, 0, 0, 0, 0, 0, 1, 0, 0]
    assert dxp.shape == inputs[0].shape
    for t in (dw, db, dh0):
        assert torch.equal(t, torch.zeros_like(t))
    inputs, ys, d_ys, h_prev, hp = _wide_bwd_inputs(1, 10, 3, 129, cuda_device, seed=8)
    empty_block = {"route": "cluster", "C": 16, "R": 1, **cluster_bwd_geometry(129, 16, 1)}
    with pytest.raises(RuntimeError, match="gru_seq_cluster_bwd"):
        gru_sequence_bwd_wide(inputs[0], hp, h_prev, d_ys, inputs[1], inputs[2], hp,
                              plan=empty_block)


# the grid backward (gru_seq_grid_bwd.cu), the card's plan given: below the
# cap at H 160 and 544 (forced; 20 and 68 blocks), the cap + 1 (69 blocks,
# the last owning one unit), a ragged depth (600, 777: each gate padded),
# the largest H (128 blocks), nb 3 (three waves), B 1, 5, 9, 64 and 70 (a
# full and a ragged 64-row tile), T 1
@pytest.mark.parametrize("nb,T,B,H", [(1, 30, 9, 160), (1, 30, 5, 544), (1, 101, 9, 545),
                                      (3, 40, 64, 600), (1, 20, 70, 777), (3, 25, 64, 1024),
                                      (1, 1, 1, 1024), (1, 50, 1, 545), (3, 1, 9, 777),
                                      (1, 40, 70, 160), (1, 30, 5, 1024), (1, 30, 70, 1024)])
def test_grid_backward_matches_plain(cuda_device, nb, T, B, H):
    inputs, ys, d_ys, h_prev, hp = _wide_bwd_inputs(nb, T, B, H, cuda_device, seed=H + T)
    plan = grid_bwd_plan(nb, B, H, cluster_card())
    before = _wide_counts()
    dxp, dh0 = gru_sequence_bwd_wide(inputs[0], hp, h_prev, d_ys, inputs[1], inputs[2], hp,
                                     plan=plan)
    torch.cuda.synchronize()
    assert [a - b for a, b in zip(_wide_counts(), before)] == [0] * 8 + [plan["waves"]]
    ref = gru_sequence_bwd_reference(*inputs, ys, d_ys)
    dw, db = weight_grads(h_prev, hp)
    _assert_bwd_matches((dxp, dw, db, dh0), ref)


def test_grid_backward_takes_over_past_the_cluster_cap(cuda_device):
    """The automatic route: the largest H a backward cluster holds on this
    card runs the cluster backward, the next H and 1024 the grid backward,
    by the counters; all match the plain backward. Two calls of the grid
    backward give the same bits; T = 0 launches nothing and gives zero
    gradients; a plan with more blocks than the card holds resident at once
    is refused by the cooperative launch and raises."""
    card = cluster_card()
    cap = max(H for H in range(MAX_HIDDEN + 1, GRID_MAX_HIDDEN + 1)
              if cluster_bwd_plan(1, 1, H, card)["route"] == "cluster")
    for H, want in ((cap, [0, 0, 0, 0, 0, 0, 1, 0, 0]), (cap + 1, [0, 0, 0, 0, 0, 0, 0, 0, 1]),
                    (GRID_MAX_HIDDEN, [0, 0, 0, 0, 0, 0, 0, 0, 1])):
        inputs = _inputs(40, 9, H, cuda_device, seed=H, lead=(1,))
        ys = gru_sequence_reference(*inputs)
        d_ys = torch.randn(ys.shape, generator=torch.Generator().manual_seed(H)).to(cuda_device)
        before = _wide_counts()
        got = gru_sequence_bwd(*inputs, ys, d_ys)
        torch.cuda.synchronize()
        assert [a - b for a, b in zip(_wide_counts(), before)] == want, H
        _assert_bwd_matches(got, gru_sequence_bwd_reference(*inputs, ys, d_ys))
    inputs = _inputs(200, 37, 777, cuda_device, seed=7, lead=(2,))
    ys = gru_sequence(*inputs)
    d_ys = torch.randn(ys.shape, generator=torch.Generator().manual_seed(9)).to(cuda_device)
    for a, b in zip(gru_sequence_bwd(*inputs, ys, d_ys), gru_sequence_bwd(*inputs, ys, d_ys)):
        assert torch.equal(a, b)
    inputs = _inputs(0, 9, 1024, cuda_device, lead=(3,))
    ys = gru_sequence_reference(*inputs)
    before = _wide_counts()
    dxp, dw, db, dh0 = gru_sequence_bwd(*inputs, ys, torch.zeros_like(ys))
    torch.cuda.synchronize()
    assert [a - b for a, b in zip(_wide_counts(), before)] == [0] * 9
    assert dxp.shape == inputs[0].shape
    for t in (dw, db, dh0):
        assert torch.equal(t, torch.zeros_like(t))
    inputs, ys, d_ys, h_prev, hp = _wide_bwd_inputs(2, 10, 3, 1024, cuda_device, seed=8)
    plan = grid_bwd_plan(2, 3, 1024, card)
    too_many = {**plan, "buckets_per_wave": 2}
    assert 2 * plan["blocks"] > plan["resident"]
    with pytest.raises(RuntimeError, match="gru_seq_grid_bwd"):
        gru_sequence_bwd_wide(inputs[0], hp, h_prev, d_ys, inputs[1], inputs[2], hp,
                              plan=too_many)


# the streaming backward (gru_seq_wide.cu), which the automatic route takes
# only past H 1024: below it, past the clusters' cap and at H 1024 with nb
# 2, on plan={"route": "stream"}, as chip_smoke.py times it in turns
@pytest.mark.parametrize("nb,T,B,H", [(1, 40, 9, 545), (2, 30, 5, 1024)])
def test_streaming_backward_runs_only_when_asked(cuda_device, nb, T, B, H):
    inputs, ys, d_ys, h_prev, hp = _wide_bwd_inputs(nb, T, B, H, cuda_device, seed=H + 1)
    before = _wide_counts()
    dxp, dh0 = gru_sequence_bwd_wide(inputs[0], hp, h_prev, d_ys, inputs[1], inputs[2], hp,
                                     plan={"route": "stream"})
    torch.cuda.synchronize()
    assert [a - b for a, b in zip(_wide_counts(), before)] == [0, 0, 0, 0, 0, 0, 0, 1, 0]
    dw, db = weight_grads(h_prev, hp)
    _assert_bwd_matches((dxp, dw, db, dh0), gru_sequence_bwd_reference(*inputs, ys, d_ys))


def test_wide_kernels_repeat_bitwise_and_take_unaligned_inputs(cuda_device):
    """The wide route's sums have a fixed order: two calls give the same
    bits. xp and d_ys 4 bytes into their storage are read as they are."""
    nb, T, B, H = 2, 150, 9, 300
    xp, w, b, h0 = _inputs(T, B, H, cuda_device, seed=5, lead=(nb,))
    xp = torch.cat([xp.new_zeros(1), xp.reshape(-1)])[1:].view(xp.shape)
    ys = gru_sequence(xp, w, b, h0)
    assert torch.equal(ys, gru_sequence(xp, w, b, h0))
    d_ys = torch.randn(ys.numel() + 1, generator=torch.Generator().manual_seed(3))
    d_ys = d_ys.to(cuda_device)[1:].view(ys.shape)
    first = gru_sequence_bwd(xp, w, b, h0, ys, d_ys)
    second = gru_sequence_bwd(xp, w, b, h0, ys, d_ys)
    for a, c in zip(first, second):
        assert torch.equal(a, c)
    _assert_bwd_matches(first, gru_sequence_bwd_reference(xp, w, b, h0, ys, d_ys))


def test_wide_timegan_step_runs_on_wide_k1(cuda_device):
    """A TimeGAN at z64/h256 (a TimeGANConfig the JAX package builds): one
    GAN step on the card takes the composed D-step route, no K2; the
    generator's and supervisor's recurrences (H 256) run the wide K1
    forward and backward on their cluster kernels, the embedder's and
    recovery's (H 64) the narrow K1; the step matches the CPU."""
    cfg = TimeGANConfig(x_dim=14, z_dim=64, h_dim=256)
    nb, B, T = 1, 4, 64
    params = timegan_init_stacked(
        cfg, [torch.Generator().manual_seed(b) for b in range(nb)], device="cpu")
    hp = ttrain.TimeGANHParams(batch_size=B)
    optD, optG = make_gan_opts(hp)
    rng = np.random.default_rng(0)
    X = torch.from_numpy(rng.uniform(0, 1, (nb, 16, T, 14)).astype(np.float32))
    gens = [torch.Generator().manual_seed(b) for b in range(nb)]
    draws = ttrain.draw_gan(gens, torch.full((nb,), 16.0), B, T, cfg.z_dim,
                            device="cpu")
    x = ttrain.gather_batch(X, draws.idx)

    def step(device):
        p = tree_map(lambda t: t.to(device), params)
        d = type(draws)(**{k: tree_map(lambda t: t.to(device), v)
                           for k, v in vars(draws).items()})
        d_state = optD.init(p["discriminator"])
        g_state = optG.init({k: p[k] for k in ttrain.GEN_NETS})
        return ttrain.gan_step(p, optD, d_state, optG, g_state, x.to(device), d, 1, hp)

    counts = lambda: (*_wide_counts(), multigru_disc_inputs.launches)  # noqa: E731
    before = counts()
    card = step(cuda_device)
    torch.cuda.synchronize()
    launched = [a - b for a, b in zip(counts(), before)]
    assert launched[9] == 0 and launched[1] >= 2 and launched[2] == launched[3] == 0
    assert launched[4] == 0 and launched[6] >= 1 and launched[7] == launched[8] == 0
    host = step("cpu")
    logs = (card[3].cpu() - host[3]).abs() / host[3].abs().clamp(min=1.0)
    assert torch.isfinite(card[3]).all() and logs.max().item() <= 1e-4


def test_wide_timegan_step_runs_on_streaming_k1(cuda_device):
    """A TimeGAN at z64/h1536 (a TimeGANConfig the JAX package builds, past
    the grids' H 1024): one GAN step on the card takes the composed D-step
    route, no K2; the generator's and supervisor's recurrences run their
    forwards on the grid that streams W's remainder and their backwards on
    the streaming kernel, no cluster, no H <= 1024 grid kernel and no
    streaming forward; the step matches the CPU."""
    cfg = TimeGANConfig(x_dim=14, z_dim=64, h_dim=1536)
    nb, B, T = 1, 4, 32
    params = timegan_init_stacked(
        cfg, [torch.Generator().manual_seed(b) for b in range(nb)], device="cpu")
    hp = ttrain.TimeGANHParams(batch_size=B)
    optD, optG = make_gan_opts(hp)
    rng = np.random.default_rng(1)
    X = torch.from_numpy(rng.uniform(0, 1, (nb, 16, T, 14)).astype(np.float32))
    gens = [torch.Generator().manual_seed(b) for b in range(nb)]
    draws = ttrain.draw_gan(gens, torch.full((nb,), 16.0), B, T, cfg.z_dim, device="cpu")
    x = ttrain.gather_batch(X, draws.idx)

    def step(device):
        p = tree_map(lambda t: t.to(device), params)
        d = type(draws)(**{k: tree_map(lambda t: t.to(device), v)
                           for k, v in vars(draws).items()})
        d_state = optD.init(p["discriminator"])
        g_state = optG.init({k: p[k] for k in ttrain.GEN_NETS})
        return ttrain.gan_step(p, optD, d_state, optG, g_state, x.to(device), d, 1, hp)

    counts = lambda: (*_wide_counts(), multigru_disc_inputs.launches)  # noqa: E731
    before = counts()
    card = step(cuda_device)
    torch.cuda.synchronize()
    launched = [a - b for a, b in zip(counts(), before)]
    assert launched[9] == 0 and launched[4] >= 2 and launched[1] == launched[2] == 0
    assert launched[3] == 0 and launched[7] >= 1 and launched[6] == launched[8] == 0
    host = step("cpu")
    logs = (card[3].cpu() - host[3]).abs() / host[3].abs().clamp(min=1.0)
    assert torch.isfinite(card[3]).all() and logs.max().item() <= 1e-4


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
# launch: nothing to compute); the sequential trainer's one bucket of B 64
@pytest.mark.parametrize("nb,T,B,dims", [(18, 768, 63, (28, 56, 56, 28)),
                                         (1, 768, 64, (28, 56, 56, 28)),
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


def test_dropout_gan_step_matches_cpu(cuda_device):
    """One sequential GAN step of 2-layer stacks with dropout masks (the
    composed route: K1 for every recurrence, no K2) on the card and on the
    CPU, on the same parameters and draws: logs within 1e-4 relative,
    parameters within 2e-4 (a fifth of lr_g: Adam's first update magnifies
    a gradient at rounding level), and both optimizers' first moments, which
    scale with |g| where the first update sees only its sign, within 1e-3
    of each leaf's largest magnitude."""
    hp = ttrain.TimeGANHParams(layers=2, dropout=0.2, gan_steps=4, batch_size=4)
    cfg = TimeGANConfig(x_dim=14, num_layers=2)
    params = timegan_init_stacked(cfg, [torch.Generator().manual_seed(0)], device="cpu")
    g = torch.Generator().manual_seed(1)
    X = torch.rand((1, 8, 96, 14), generator=g)
    draws = ttrain.draw_gan([g], None, 4, 96, 28, device="cpu",
                            idx=ttrain.draw_perm_idx([g], 8, 4, device="cpu"))
    draws.masks = ttrain.draw_gan_masks([g], params, 4, 96, 0.2, device="cpu")
    results = []
    for device in ("cpu", cuda_device):
        p = tree_map(lambda t: t.to(device), params)
        d = ttrain.GANDraws(**{k: tree_map(lambda t: t.to(device), v)
                               for k, v in vars(draws).items()})
        optD, optG = make_gan_opts(hp)
        before = (gru_sequence.launches, multigru_disc_inputs.launches)
        out = ttrain.gan_step(p, optD, optD.init(p["discriminator"]), optG,
                              optG.init({k: p[k] for k in ttrain.GEN_NETS}),
                              ttrain.gather_batch(X.to(device), d.idx), d, 1, hp)
        launches = (gru_sequence.launches - before[0],
                    multigru_disc_inputs.launches - before[1])
        mu = [t.cpu() for state in out[1:3] for t in tree_leaves(state.mu)]
        results.append((tree_map(lambda t: t.cpu(), out[0]), out[3].cpu(), launches, mu))
    (cpu_p, cpu_logs, _, cpu_mu), (card_p, card_logs, launches, card_mu) = results
    # D inputs: E, G, S; G step: G, S, E, R and R on h_hat; two layers each
    assert launches == (16, 0)
    assert torch.isfinite(card_logs).all()
    assert ((card_logs - cpu_logs).abs() / cpu_logs.abs().clamp(min=1.0)).max() <= 1e-4
    for a, b in zip(tree_leaves(card_p), tree_leaves(cpu_p)):
        assert (a - b).abs().max().item() <= 2e-4
    for a, b in zip(card_mu, cpu_mu):
        assert (a - b).abs().max().item() <= 1e-3 * b.abs().max().item()


def test_train_single_npz_on_the_card(cuda_device, tmp_path):
    """A short sequential run on the card, through K1 forward and backward
    and K2: finite logs of every step and every artifact."""
    rng = np.random.default_rng(0)
    np.savez(tmp_path / "posture1_no_exo.npz",
             X=rng.uniform(0, 1, (12, 128, 14)).astype(np.float32))
    before = (gru_sequence.launches, gru_sequence_bwd.launches,
              multigru_disc_inputs.launches)
    res = ttrain.train_single_npz(tmp_path / "posture1_no_exo.npz", tmp_path / "run",
                                  device=cuda_device, ae_epochs=1, sup_epochs=1,
                                  gan_steps=3, batch_size=8)
    after = (gru_sequence.launches, gru_sequence_bwd.launches,
             multigru_disc_inputs.launches)
    assert all(a > b for a, b in zip(after, before))
    assert after[2] - before[2] == 3                  # K2 once a GAN step
    rows = np.loadtxt(tmp_path / "run" / "train_log.csv", delimiter=",",
                      skiprows=1, usecols=range(2, 10), ndmin=2)
    assert rows.shape == (3, 8) and np.isfinite(rows).all()
    assert res["steps_per_sec"] > 0 and 1 <= res["best_step"] <= 3
    with np.load(tmp_path / "run" / "synthetic.npz") as s:
        assert s["X"].shape == (12, 128, 14) and np.isfinite(s["X"]).all()


def _conv_step(device, hp, seed=3):
    """One conv-CGAN step at full width (B = hp.batch_size, T 768) on
    ``device`` from a seeded model and seeded draws made on the host, R1
    firing (step index 0). Returns the step's outputs on the host and the
    hand-kernel launches it made."""
    K = 9 if hp.variant == "v1" else 2
    cfg = cgan_train.build_cfg(hp, K)
    g = torch.Generator().manual_seed(seed)
    G, bn = cgan_train.generator_init(cfg, g, device="cpu")
    D = {k: cgan_train.disc_init(cfg, g, device="cpu") for k in ("dg", "dl")}
    B = hp.batch_size
    X = torch.rand((K * B, 14, 768), generator=g)
    draws = cgan_train.draw_cgan_step(g, hp, cfg, torch.arange(K * B).reshape(K, B),
                                      torch.full((K,), float(B)), prewarm=False,
                                      device="cpu")
    to = lambda tree: tree_map(lambda t: t.to(device), tree)  # noqa: E731
    G, bn, D = to(G), to(bn), to(D)
    optG = cgan_train.Adam(hp.lr_g, hp.beta1, hp.beta2)
    optD = cgan_train.Adam(hp.lr_d, hp.beta1, hp.beta2)
    before = (gru_sequence.launches, multigru_disc_inputs.launches, flash_forward.launches)
    out = cgan_train.cgan_step(G, bn, D, G, optG.init(G), optD.init(D), X.to(device),
                               cgan_train.draws_to(draws, device), 0, 0.1, cfg=cfg, hp=hp,
                               optG=optG, optD=optD, prewarm=False)
    launches = (gru_sequence.launches - before[0],
                multigru_disc_inputs.launches - before[1],
                flash_forward.launches - before[2])
    host = lambda tree: tree_map(lambda t: t.cpu(), tree)  # noqa: E731
    return (host(out[0]), host(out[1]), host(out[2]), out[4].count, host(out[4].mu),
            host(out[5].mu), out[6].cpu()), launches


@pytest.mark.parametrize("variant", ["v1", "v2"])
def test_conv_cgan_step_matches_cpu(cuda_device, variant):
    """One conv-CGAN step (v1 with R1, v2 with its keep masks), B 8, full
    width, on the card and on the CPU on the same parameters and draws,
    with chip_smoke.py's conv CGAN tolerances, leaf by leaf: logs within
    1e-4 relative; Adam's first moments within 1e-3 of the leaf's own
    largest; parameters within 1e-5, except where the gradient is within
    that tolerance of zero or under 1e-5 (its sign is not held, and Adam's
    first step moves it by ±lr whatever its size), at most 1 % of a leaf;
    a leaf whose whole gradient is under 1e-5 on the CPU (zero by
    construction: a conv bias ahead of a train-mode batch norm) must be so
    on the card too; the bn statistics within 1e-5. The convolutions are
    cuDNN's: no hand kernel launches."""
    over = cgan_train.V2_OVERRIDES if variant == "v2" else {}
    hp = cgan_train.CGANHParams(**{**over, "batch_size": 8})
    (cG, cbn, cD, _, cmuG, cmuD, clogs), _ = _conv_step("cpu", hp)
    (G, bn, D, _, muG, muD, logs), launches = _conv_step(cuda_device, hp)
    assert launches == (0, 0, 0)
    assert torch.isfinite(logs).all()
    assert ((logs - clogs).abs() / clogs.abs().clamp(min=1.0)).max() <= 1e-4
    _hold_conv_step((G, D), (muG, muD), bn, (cG, cD), (cmuG, cmuD), cbn, hp.beta1)


def _hold_conv_step(params, mu, bn, ref_params, ref_mu, ref_bn, beta1):
    """A conv-CGAN step's parameters, Adam first moments and bn against a
    reference step's, leaf by leaf, by test_conv_cgan_step_matches_cpu's
    rule."""
    for p, pr, m, mr in zip(tree_leaves(params), tree_leaves(ref_params),
                            tree_leaves(mu), tree_leaves(ref_mu)):
        p, pr, m, mr = p.cpu(), pr.cpu(), m.cpu(), mr.cpu()
        g, gr = m.abs() / (1 - beta1), mr.abs() / (1 - beta1)
        if gr.max() <= 1e-5:
            assert g.max() <= 1e-5, p.shape
            continue
        assert (m - mr).abs().max() <= 1e-3 * mr.abs().max(), p.shape
        far = (p - pr).abs() > 1e-5
        small = gr <= max(1e-5, 1e-3 * gr.max().item())
        assert not (far & ~small).any(), p.shape
        assert (far & small).sum() <= 0.01 * p.numel(), p.shape
    for a, b in zip(tree_leaves(bn), tree_leaves(ref_bn)):
        assert (a.cpu() - b.cpu()).abs().max().item() <= 1e-5


def test_conv_cgan_bf16_d_step(cuda_device):
    """precision_d="bf16" on the card: the D update's conv trunks in
    bfloat16, a finite step, and every parameter, bn statistic and Adam
    moment float32; the logs near the float32 step's (the D loss passes
    through the bfloat16 trunk: 2e-2 relative)."""
    hp = cgan_train.CGANHParams(batch_size=8, precision_d="bf16")
    (G, bn, D, count, muG, muD, logs), _ = _conv_step(cuda_device, hp)
    (*_, logs32), _ = _conv_step(cuda_device, cgan_train.CGANHParams(batch_size=8))
    assert count == 1 and torch.isfinite(logs).all()
    for t in tree_leaves((G, bn, D, muG, muD)):
        assert t.dtype == torch.float32 and torch.isfinite(t).all()
    assert ((logs[8:] - logs32[8:]).abs() / logs32[8:].abs()).max() <= 2e-2
    assert not torch.equal(logs, logs32)


def test_conv_generator_matches_cpu(cuda_device):
    """A conv generator's eval-mode output (n 64, bn statistics perturbed
    from their init) on the card against the CPU within 1e-4."""
    cfg = cgan_train.build_cfg(cgan_train.CGANHParams(), 9)
    g = torch.Generator().manual_seed(4)
    G, bn = cgan_train.generator_init(cfg, g, device="cpu")
    bn = {k: {"mean": 0.1 * torch.randn(v["mean"].shape, generator=g),
              "var": 1 + 0.2 * torch.rand(v["var"].shape, generator=g)}
          for k, v in bn.items()}
    z = torch.randn((64, 100), generator=g)
    labels = torch.randint(0, 9, (64,), generator=g)
    want = cgan_train.generator_apply(G, bn, z, labels, cfg, train=False)[0]
    to = lambda tree: tree_map(lambda t: t.to(cuda_device), tree)  # noqa: E731
    got = cgan_train.generator_apply(to(G), to(bn), z.to(cuda_device),
                                     labels.to(cuda_device), cfg, train=False)[0]
    assert (got.cpu() - want).abs().max().item() <= 1e-4


# bf16 synthesis: tests/test_precision.py's bounds on JAX's bf16 against f32
BF16_CORR, BF16_MAX = 0.999, 0.05


def _bf16_close(a: torch.Tensor, b: torch.Tensor) -> bool:
    a, b = a.double().flatten().cpu(), b.double().flatten().cpu()
    corr = torch.corrcoef(torch.stack([a, b]))[0, 1].item()
    return corr > BF16_CORR and (a - b).abs().max().item() < BF16_MAX


def test_bf16_synthesis_matches_cpu(cuda_device):
    """The bf16 cascade (a cast tree, bf16 noise) on the card against the
    CPU's and against the card's f32, by the bf16 bounds; 3 K1 launches a
    chunk, the carry float32; chunked within the bounds of one-shot."""
    model = TimeGAN(TimeGANConfig(), generator=torch.Generator().manual_seed(5),
                    device="cpu").eval()
    z = torch.rand((32, 3 * 64, 28), generator=torch.Generator().manual_seed(6))
    tree = cast_floating(params_tree(model), torch.bfloat16)
    want, _ = synthesize_from_noise(tree, z.to(torch.bfloat16))
    card = tree_map(lambda t: t.to(cuda_device), tree)
    zc = z.to(cuda_device, torch.bfloat16)
    k1 = gru_sequence.launches
    got, carry = synthesize_from_noise(card, zc)
    torch.cuda.synchronize()
    assert gru_sequence.launches - k1 == 3
    assert got.dtype == torch.float32 and all(h.dtype == torch.float32 for h in carry)
    assert _bf16_close(got, want)
    f32, _ = synthesize_from_noise(model.to(cuda_device), z.to(cuda_device))
    assert _bf16_close(got, f32)
    carry, pieces = None, []
    for t0 in range(0, zc.shape[1], 64):
        x, carry = synthesize_from_noise(card, zc[:, t0:t0 + 64], carry)
        pieces.append(x)
    assert _bf16_close(torch.cat(pieces, 1), got)


def test_k1_still_refuses_bf16(cuda_device):
    """The bf16 path casts around K1; the wrapper itself takes float32 only."""
    xp, w, b, h0 = (t.to(torch.bfloat16) for t in _inputs(8, 4, 16, cuda_device))
    with pytest.raises(TypeError, match="float32"):
        gru_sequence(xp, w, b, h0)


def _cgan_eval_corpora():
    rng = np.random.default_rng(0)
    X, y = [], []
    for shift, counts in ((0.5, {1: 30, 3: 24, 5: 26}), (0.4, {1: 30, 3: 22, 5: 28})):
        xs, ys = [], []
        for p, n in counts.items():
            x = rng.standard_normal((n, 14, 768)).astype(np.float32)
            xs.append(x + shift * np.sin(np.arange(768) / (3 + p)).astype(np.float32))
            ys.append(np.full(n, p, np.int64))
        X.append(np.concatenate(xs))
        y.append(np.concatenate(ys))
    return X[0], y[0], X[1], y[1]


@pytest.mark.parametrize("v2_split", [False, True])
def test_cgan_eval_metrics_match_cpu(cuda_device, tmp_path, v2_split):
    """The CGAN eval's three metric families on the card against the CPU:
    accuracy within one test row and AUC within 1e-3 (the same float64
    Newton optimum on features that differ by float32 FFT rounding), the
    rest within 1e-5 relative + 1e-6."""
    Xr, yr, Xg, yg = _cgan_eval_corpora()
    n_test = {0: np.ceil(0.3 * (len(Xr) + len(Xg)))}
    n_test.update({p: np.ceil(0.3 * ((yr == p).sum() + (yg == p).sum()))
                   for p in (1, 3, 5)})
    for fn, kw in ((cgan_eval.discriminative_metrics, {"v2_split": v2_split}),
                   (cgan_eval.predictive_scores, {}),
                   (cgan_eval.stats_similarity, {})):
        card = fn(Xr, Xg, yr, yg, tmp_path / "c.csv", device=cuda_device, **kw)
        host = fn(Xr, Xg, yr, yg, tmp_path / "h.csv", device="cpu", **kw)
        assert len(card) == len(host) > 1
        for c, h in zip(card, host):
            for k, v in h.items():
                if k in ("level", "posture", "split"):
                    assert c[k] == v
                elif k == "acc":
                    assert abs(c[k] - v) <= 1 / n_test[h["posture"]]
                elif k == "auc":
                    assert abs(c[k] - v) <= 1e-3
                else:
                    assert abs(c[k] - v) <= 1e-6 + 1e-5 * abs(v), (k, c[k], v)


def test_sweep_gan_step_matches_cpu(cuda_device):
    """One stacked GAN step of three sweep points, B 4, T 96, each with its
    own G-loss weights (points 0 and 1 equal in everything), through K2 and
    K1 on the card and the plain versions on the CPU, with
    test_dropout_gan_step_matches_cpu's tolerances; on the card the two
    equal points come out bit for bit alike."""
    hp = ttrain.TimeGANHParams(gan_steps=4, batch_size=4, fused_step=True)
    cfg = TimeGANConfig(x_dim=14)
    params = timegan_init_stacked(cfg, [torch.Generator().manual_seed(0)
                                        for _ in range(3)], device="cpu")
    g = torch.Generator().manual_seed(1)
    X = torch.rand((1, 8, 96, 14), generator=g).expand(3, 8, 96, 14)
    gens = [torch.Generator().manual_seed(2) for _ in range(3)]
    draws = ttrain.draw_gan(gens, torch.full((3,), 8.0), 4, 96, 28, device="cpu")
    W = torch.tensor([[3.0, 0.15, 0.03, 0.02], [3.0, 0.15, 0.03, 0.02],
                      [1.0, 0.5, 0.2, 0.3]])
    results = []
    for device in ("cpu", cuda_device):
        p = tree_map(lambda t: t.to(device), params)
        d = ttrain.GANDraws(**{k: tree_map(lambda t: t.to(device), v)
                               for k, v in vars(draws).items()})
        optD, optG = make_gan_opts(hp)
        before = (gru_sequence.launches, multigru_disc_inputs.launches)
        out = ttrain.gan_step(p, optD, optD.init(p["discriminator"]), optG,
                              optG.init({k: p[k] for k in ttrain.GEN_NETS}),
                              ttrain.gather_batch(X.to(device), d.idx), d, 1, hp,
                              weights=W.to(device))
        launches = (gru_sequence.launches - before[0],
                    multigru_disc_inputs.launches - before[1])
        mu = [t.cpu() for state in out[1:3] for t in tree_leaves(state.mu)]
        results.append((tree_map(lambda t: t.cpu(), out[0]), out[3].cpu(), launches, mu))
    (cpu_p, cpu_logs, _, cpu_mu), (card_p, card_logs, launches, card_mu) = results
    assert launches == (5, 1)
    assert torch.isfinite(card_logs).all()
    assert ((card_logs - cpu_logs).abs() / cpu_logs.abs().clamp(min=1.0)).max() <= 1e-4
    for a, b in zip(tree_leaves(card_p), tree_leaves(cpu_p)):
        assert (a - b).abs().max().item() <= 2e-4
    for a, b in zip(card_mu, cpu_mu):
        assert (a - b).abs().max().item() <= 1e-3 * b.abs().max().item()
    assert torch.equal(card_logs[0], card_logs[1])
    assert all(torch.equal(a[0], a[1]) for a in tree_leaves(card_p))
    assert not torch.equal(card_logs[0], card_logs[2])


def test_posture_stack_member_matches_its_lone_step(cuda_device):
    """Two members of the conv v2 posture stack, B 8, full width, one step
    (R1 fires) on the card: member 1 against its lone ``cgan_step`` on the
    card on the same draws, by test_conv_cgan_step_matches_cpu's rule."""
    hp = cgan_train.CGANHParams(**{**cgan_train.V2_OVERRIDES, "batch_size": 8})
    cfg = cgan_train.build_cfg(hp, 2)
    optG = cgan_train.Adam(hp.lr_g, hp.beta1, hp.beta2)
    optD = cgan_train.Adam(hp.lr_d, hp.beta1, hp.beta2)
    X = torch.rand((2, 16, 14, 768), generator=torch.Generator().manual_seed(3),
                   ).to(cuda_device)
    tables = torch.arange(16).reshape(2, 8).expand(2, 2, 8).contiguous().to(cuda_device)
    counts = torch.full((2, 2), 8.0, device=cuda_device)

    def fresh():
        return ([cgan_multi.init_member(cfg, hp.seed, p, optG, optD, device=cuda_device)
                 for p in (1, 2)],
                [torch.Generator(device=cuda_device).manual_seed(p) for p in (1, 2)])

    members, gens = fresh()
    cgan_multi.stack_step(members, X, tables, counts, gens, 0, 0.1, cfg=cfg, hp=hp,
                          optG=optG, optD=optD, prewarm=False)
    (lone, *_), (gen, *_) = fresh()
    draws = cgan_train.draw_cgan_step(gen, hp, cfg, tables[0], counts[0],
                                      prewarm=False, device=cuda_device)
    out = cgan_train.cgan_step(lone.G, lone.bn, lone.D, lone.ema, lone.g_state,
                               lone.d_state, X[0], draws, 0, 0.1, cfg=cfg, hp=hp,
                               optG=optG, optD=optD, prewarm=False)
    m = members[0]
    _hold_conv_step((m.G, m.D), (m.g_state.mu, m.d_state.mu), m.bn, (out[0], out[2]),
                    (out[4].mu, out[5].mu), out[1], hp.beta1)


def test_remat_transformer_step_matches_plain(cuda_device):
    """One transformer CGAN step (dim 32, depth 2, B 8, T 768, R1 fires)
    with tf_remat on the card against the same step without it on the card:
    logs within 1e-5 relative, Adam's first moments within 1e-4 of each
    leaf's largest, or of 1e-3 for a leaf at rounding level, such as the
    key biases (the recomputed blocks run the same operations; only the
    backward's order of accumulation may differ)."""
    outs = []
    for remat in (False, True):
        hp = cgan_train.CGANHParams(arch="transformer", tf_dim=32, tf_depth=2,
                                    tf_heads=2, batch_size=8, tf_remat=remat)
        cfg = cgan_train.build_cfg(hp, 9)
        g = torch.Generator().manual_seed(4)
        G, bn = cgan_train.generator_init(cfg, g, device=cuda_device)
        D = {k: cgan_train.disc_init(cfg, g, device=cuda_device) for k in ("dg", "dl")}
        X = torch.rand((72, 14, 768), generator=g).to(cuda_device)
        draws = cgan_train.draw_cgan_step(
            torch.Generator().manual_seed(5), hp, cfg, torch.arange(72).reshape(9, 8),
            torch.full((9,), 8.0), prewarm=False, device="cpu")
        optG = cgan_train.Adam(hp.lr_g, hp.beta1, hp.beta2)
        optD = cgan_train.Adam(hp.lr_d, hp.beta1, hp.beta2)
        outs.append(cgan_train.cgan_step(
            G, bn, D, G, optG.init(G), optD.init(D), X,
            cgan_train.draws_to(draws, cuda_device), 0, 0.1, cfg=cfg, hp=hp,
            optG=optG, optD=optD, prewarm=False))
    (_, _, _, _, g0, d0, l0), (_, _, _, _, g1, d1, l1) = outs
    assert torch.isfinite(l1).all() and l0[9] != 0
    assert ((l1 - l0).abs() / l0.abs().clamp(min=1.0)).max() <= 1e-5
    for a, b in zip(tree_leaves((g1.mu, d1.mu)), tree_leaves((g0.mu, d0.mu))):
        assert (a - b).abs().max().item() <= 1e-4 * max(b.abs().max().item(), 1e-3)


# ------------------------------------------------------------------
# The IIR filter kernel, preprocessing and the fatigue analysis
# ------------------------------------------------------------------

def _iir_case(T, M, order, dtype, seed):
    from eegsynth_torch.data.filters import design_filters
    from eegsynth_torch.ops.filtering import lfilter_zi
    (b_bp, a_bp), (b_n, a_n) = design_filters(128.0)
    b, a = (b_bp, a_bp) if order == 8 else (b_n, a_n)
    x = torch.from_numpy(np.random.default_rng(seed).standard_normal((T, M))
                         .cumsum(axis=0)).to(dtype)
    zi = torch.as_tensor(lfilter_zi(b, a)).to(dtype)[:, None] * x[0]
    return b, a, x, zi


@pytest.mark.parametrize("M", [1, 14, 300])
@pytest.mark.parametrize("T", [10, 7734, 100000])
@pytest.mark.parametrize("dtype", [torch.float32, torch.float64])
@pytest.mark.parametrize("order", [2, 8])
def test_iir_kernel_matches_plain(cuda_device, order, dtype, T, M):
    """The IIR kernel against its plain version (run on the CPU on the same
    inputs: the same operations in the same order, each rounded on its
    own): equal bit for bit (so within 1e-12 (float64) or 1e-5 (float32) of
    the largest output), one launch a call."""
    from eegsynth_torch.ops.filtering import _taps, lfilter, lfilter_reference
    b, a, x, zi = _iir_case(T, M, order, dtype, seed=T + M + order)
    before = lfilter.launches
    got = lfilter(b, a, x.to(cuda_device), zi=zi.to(cuda_device))
    torch.cuda.synchronize()
    assert lfilter.launches == before + 1
    ref = lfilter_reference(*_taps(b, a, dtype), x, zi)
    assert got.dtype == dtype and got.shape == (T, M)
    tol = 1e-12 if dtype == torch.float64 else 1e-5
    assert (got.cpu() - ref).abs().max().item() <= tol * ref.abs().max().item()
    assert torch.equal(got.cpu(), ref)


# every tap count to 9, the lanes route's 10 and widest 17 in float64, the
# column route's widest (17) in float32, the runtime route's first (18)
# in both, 34, 35 and 41 taps (its state in shared memory) and 200 (in a
# global buffer); bfloat16 and float16 take the runtime route at every n
@pytest.mark.parametrize("M", [14, 4099])
@pytest.mark.parametrize("dtype", [torch.float32, torch.float64, torch.bfloat16,
                                   torch.float16])
@pytest.mark.parametrize("n", [*range(1, 10), 10, 17, 18, 34, 35, 41, 200])
def test_iir_kernel_routes_equal_plain(cuda_device, n, dtype, M):
    """Every route the plan keeps, at 14 columns and at a wide batch:
    float64 takes the lane groups up to 17 taps (one thread a column where
    lane 0 holds the whole state), float32 one thread a column up to 17, and
    past those (and in bfloat16 and float16) one thread a column holding its
    state in memory;
    stable Butterworth low-passes to 17 taps in float32 and float64, past
    them and in bfloat16 and float16 filters of up to 8 poles within 0.5; a
    ragged last chunk: equal to the plain version (on the CPU, in the same
    dtype) bit for bit."""
    import scipy.signal
    from iir_cases import stable_taps
    from eegsynth_torch.ops.filtering import (
        _taps, iir_lanes, iir_plan, lfilter, lfilter_reference,
    )
    if dtype in (torch.float32, torch.float64) and n <= 17:
        lanes = dtype == torch.float64 and iir_lanes(n) > 1
        assert iir_plan(M, n, dtype)["route"] == ("lanes" if lanes else "column")
    else:
        assert iir_plan(M, n, dtype)["route"] == "runtime"
    if n == 1:
        b, a = np.array([0.7]), np.array([1.0])
    elif n <= 17 and dtype in (torch.float32, torch.float64):
        b, a = scipy.signal.butter(n - 1, 0.3)
    else:
        b, a = stable_taps(n, seed=n)
    T = 1000 + 7
    x = torch.from_numpy(np.random.default_rng(n).standard_normal((T, M)).cumsum(axis=0)).to(dtype)
    zi = torch.from_numpy(np.random.default_rng(n + 1).standard_normal((n - 1, M))).to(dtype)
    got = lfilter(b, a, x.to(cuda_device), zi=zi.to(cuda_device))
    ref = lfilter_reference(*_taps(b, a, dtype), x, zi)
    assert torch.isfinite(ref).all()
    assert torch.equal(got.cpu(), ref)


def test_iir_float32_refuses_the_lanes_route(cuda_device):
    """The float32 entry point builds no lane groups: it refuses the lanes
    the float64 plan takes, and launches nothing."""
    from eegsynth_torch import _build
    from eegsynth_torch.ops.filtering import iir_lanes
    lib = _build.load_library()
    x = torch.zeros(16, 14, device=cuda_device)
    zi, y = torch.zeros(8, 14, device=cuda_device), torch.empty_like(x)
    b, a = torch.ones(9), torch.ones(9)
    stream = torch.cuda.current_stream(cuda_device).cuda_stream
    assert lib.iir_filter_f32(x.data_ptr(), zi.data_ptr(), b.data_ptr(), a.data_ptr(),
                              y.data_ptr(), 16, 14, 9, iir_lanes(9), stream) != 0
    assert lib.iir_filter_f32(x.data_ptr(), zi.data_ptr(), b.data_ptr(), a.data_ptr(),
                              y.data_ptr(), 16, 14, 9, 1, stream) == 0


@pytest.mark.parametrize("dtype", [torch.float32, torch.float64])
def test_iir_chain_probe_launches(cuda_device, dtype):
    """The step-chain probe, alone and with a shuffle round trip a step,
    launches, returns the chain's finite y in every lane (the same in both),
    and counts no IIR launch."""
    from eegsynth_torch.ops.filtering import iir_chain_probe, lfilter
    before = lfilter.launches
    outs = [iir_chain_probe(7734, dtype, shuffle) for shuffle in (False, True)]
    torch.cuda.synchronize()
    assert lfilter.launches == before
    for out in outs:
        assert out.shape == (32,) and out.dtype == dtype and torch.isfinite(out).all()
    assert torch.equal(outs[0], outs[1]) and torch.equal(outs[0], outs[0][:1].expand(32))


def test_filtfilt_on_the_card_matches_cpu(cuda_device):
    """filtfilt along axis 1 of a batch, two launches, against the CPU."""
    from eegsynth_torch.data.filters import design_filters
    from eegsynth_torch.ops.filtering import filtfilt, lfilter
    (b, a), _ = design_filters(128.0)
    x = torch.from_numpy(np.random.default_rng(1).standard_normal((3, 900, 5)))
    before = lfilter.launches
    got = filtfilt(b, a, x.to(cuda_device), axis=1)
    assert lfilter.launches == before + 2
    ref = filtfilt(b, a, x, axis=1)
    assert (got.cpu() - ref).abs().max().item() <= 1e-12 * ref.abs().max().item()


@pytest.mark.parametrize("dtype", [torch.float64, torch.float32, torch.bfloat16,
                                   torch.float16])
@pytest.mark.parametrize("n", [10, 17, 41])
def test_filtfilt_past_9_taps_on_the_card_equals_cpu(cuda_device, n, dtype):
    """filtfilt at 10, 17 and 41 taps in every dtype the kernel takes: two
    launches, equal to the CPU's filtfilt (the plain version) bit for bit,
    and in float64 and float32 to scipy's lfilter pass by pass."""
    import scipy.signal
    from iir_cases import stable_taps
    from eegsynth_torch.ops.filtering import filtfilt, lfilter
    b, a = stable_taps(n, seed=n + 1)
    x = torch.from_numpy(np.random.default_rng(n).standard_normal((3, 900, 5))).to(dtype)
    before = lfilter.launches
    got = filtfilt(b, a, x.to(cuda_device), axis=1)
    assert lfilter.launches == before + 2
    ref = filtfilt(b, a, x, axis=1)
    assert got.dtype == dtype and torch.isfinite(ref).all()
    assert torch.equal(got.cpu(), ref)
    if dtype in (torch.float64, torch.float32):
        np_dtype = np.float64 if dtype == torch.float64 else np.float32
        xs = x[0].numpy()
        ys = lfilter(b, a, x[0].to(cuda_device)).cpu().numpy()
        want = scipy.signal.lfilter(b.astype(np_dtype), a.astype(np_dtype), xs, axis=0)
        np.testing.assert_array_equal(ys, want)


def test_iir_kernel_failure_raises(cuda_device, monkeypatch):
    """A CUDA tensor whose kernel call fails raises: it never returns the
    plain version's result."""
    from eegsynth_torch import _build
    from eegsynth_torch.ops import filtering
    b, a, x, zi = _iir_case(100, 3, 8, torch.float64, seed=0)
    x, zi = x.to(cuda_device), zi.to(cuda_device)
    lib = _build.load_library()

    class Failing:
        def __getattr__(self, name):
            if name.startswith("iir_filter"):
                return lambda *args: 1                 # cudaErrorInvalidValue
            return getattr(lib, name)

    def no_plain(*args, **kw):
        raise AssertionError("the plain version ran for a CUDA tensor")
    monkeypatch.setattr(_build, "load_library", lambda: Failing())
    monkeypatch.setattr(filtering, "lfilter_reference", no_plain)
    before = filtering.lfilter.launches
    with pytest.raises(RuntimeError, match="iir_filter_f64: CUDA error 1"):
        filtering.lfilter(b, a, x, zi=zi)
    assert filtering.lfilter.launches == before
    with pytest.raises(ValueError, match="taps"):
        filtering.lfilter(np.ones(0), np.ones(0), x, zi=torch.zeros(0, 3).to(x))
    with pytest.raises(TypeError, match="float64, float32, bfloat16 or float16"):
        filtering.lfilter(b, a, x.to(torch.int32), zi=zi.to(torch.int32))


def test_preprocess_on_the_card_matches_cpu(cuda_device, tmp_path):
    """run_preprocess on a tiny raw tree, card against CPU: the same buckets,
    X within 2e-6, the scalers within 1e-6 relative, everything else equal;
    four IIR launches a filtered file on the card."""
    from eegsynth_torch.data.preprocess import run_preprocess
    from eegsynth_torch.ops.filtering import lfilter
    from eegsynth_torch.tools.raw_tree import write_raw_tree
    write_raw_tree(tmp_path / "raw", participants=2, postures=(1, 2), seconds=14.0)
    logs = []
    for dev in ("cuda", "cpu"):
        log = []
        lfilter.launches = 0
        run_preprocess(tmp_path / "raw", tmp_path / dev, log=log.append, device=dev)
        logs.append([str(line).replace(str(tmp_path / dev), "") for line in log])
        if dev == "cuda":     # 8 trials and the 10-channel one are filtered
            assert lfilter.launches == 4 * 9
    assert logs[0] == logs[1]
    for fp in sorted((tmp_path / "cpu").glob("*.npz")):
        with np.load(fp, allow_pickle=True) as h, \
                np.load(tmp_path / "cuda" / fp.name, allow_pickle=True) as c:
            assert c.files == h.files
            for key in h.files:
                if key == "X":
                    assert np.abs(c[key] - h[key]).max() <= 2e-6
                elif key in ("scale_min", "scale_range"):
                    np.testing.assert_allclose(c[key], h[key], rtol=1e-6)
                else:
                    np.testing.assert_array_equal(c[key], h[key])


def test_fatigue_spectra_on_the_card_match_cpu(cuda_device):
    """tbr_matrix (Welch) and compute_fatigue_tbr (batched rFFT), float64 on
    the card against the CPU, within 1e-10 relative."""
    from eegsynth_torch.analysis.fatigue import tbr_matrix
    from eegsynth_torch.analysis.participant_fatigue import compute_fatigue_tbr
    X = np.random.default_rng(2).standard_normal((63, 768, 14)).cumsum(axis=1)
    for fn in (tbr_matrix, compute_fatigue_tbr):
        got = fn(X.astype(np.float32), 128.0, device=cuda_device)
        ref = fn(X.astype(np.float32), 128.0, device="cpu")
        np.testing.assert_allclose(got, ref, rtol=1e-10, atol=0)


def _figure_rows(n, dims, seed=0):
    rng = np.random.default_rng(seed)
    centres = rng.normal(0, 4.0, (3, dims))
    return np.concatenate([c + rng.normal(size=(n // 3, dims)) for c in centres])


@pytest.mark.parametrize("shape,k", [((600, 10752), 2), ((300, 896), 50), ((900, 50), 2)])
def test_pca_on_the_card_matches_cpu(cuda_device, shape, k):
    X = torch.as_tensor(_figure_rows(*shape))
    got = embed.pca(X.to(cuda_device), k).cpu().numpy()
    want = embed.pca(X, k).numpy()
    scale = np.abs(want).max(axis=0)
    assert (np.abs(got - want).max(axis=0) <= 1e-6 * scale).all()


def test_tsne_on_the_card_matches_cpu(cuda_device):
    X = embed.pca(torch.as_tensor(_figure_rows(600, 200, seed=1)), 50)
    card = embed.tsne(X.to(cuda_device), perplexity=30.0)
    host = embed.tsne(X, perplexity=30.0)
    assert torch.equal(card.embedding, embed.tsne(X.to(cuda_device), 30.0).embedding)
    assert abs(card.kl_divergence - host.kl_divergence) <= 0.05 * host.kl_divergence
    tw = [embed.trustworthiness(X, r.embedding.cpu(), 10) for r in (card, host)]
    assert abs(tw[0] - tw[1]) <= 0.02


def test_figure_spectra_on_the_card_match_cpu(cuda_device):
    from eegsynth_torch.ops.spectral import resample, spectrogram
    x = torch.as_tensor(np.random.default_rng(2).normal(size=7734))
    for a, b in zip(spectrogram(x.to(cuda_device), 128.0, 256), spectrogram(x, 128.0, 256)):
        np.testing.assert_allclose(a.cpu().numpy(), b.numpy(), rtol=1e-9,
                                   atol=1e-12 * float(b.abs().max()))
    np.testing.assert_allclose(resample(x.to(cuda_device), 3867).cpu().numpy(),
                               resample(x, 3867).numpy(), rtol=0, atol=1e-12)


def test_visualization_runs_on_the_card(cuda_device, tmp_path):
    from eegsynth_torch.visualization import main as viz_cli
    rng = np.random.default_rng(3)
    for p, cond in ((1, "no_exo"), (2, "with_exo")):
        (tmp_path / "runs" / f"posture{p}_{cond}").mkdir(parents=True)
        (tmp_path / "real").mkdir(exist_ok=True)
        np.savez(tmp_path / "real" / f"posture{p}_{cond}.npz",
                 X=rng.uniform(0, 1, (40, 768, 14)).astype(np.float32))
        np.savez(tmp_path / "runs" / f"posture{p}_{cond}" / "synthetic.npz",
                 X=rng.uniform(0, 1, (40, 768, 14)).astype(np.float32))
    embed.reset_stats()
    viz_cli(["--real_dir", str(tmp_path / "real"), "--synth_dir", str(tmp_path / "runs"),
             "--out", str(tmp_path / "out"), "--zooms"])
    assert embed.STATS["tsne_calls"] == 3 and embed.STATS["pca_calls"] == 1 + 2 * 2 + 1
    assert len(list((tmp_path / "out").glob("*.png"))) == 2 + 4
