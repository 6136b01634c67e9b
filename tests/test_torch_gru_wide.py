"""K1's wide forward and backward on thread-block clusters
(``csrc/gru_seq_cluster.cu``, ``csrc/gru_seq_cluster_bwd.cu``), past the
clusters' cap on one cooperative grid (``csrc/gru_seq_grid.cu``,
``csrc/gru_seq_grid_bwd.cu``), past the grids the forward on a grid that
streams W's remainder (``csrc/gru_seq_grid_stream.cu``) and the backward on
the streaming kernel (``csrc/gru_seq_wide.cu``) on the CPU: the route,
cluster and rows that ``cluster_plan`` and ``cluster_bwd_plan`` pick at the
H100's numbers, the grid plans above the cap, ``grid_stream_plan`` and the
streaming tile past H 1024 up to the wide route's cap, and each kernel's
summation order, emulated in numpy float32, against the plain versions and
the Pallas kernel (and its custom VJP) in interpret mode. The kernels
themselves run on the card (tests/test_torch_card.py, chip_smoke.py)."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from test_torch_gru import _seq_inputs, _sigmoid_fwd
from test_torch_threads import one_thread_each  # noqa: F401

from eegsynth.nn.pallas_gru import gru_sequence as jax_gru_sequence
from eegsynth_torch.nn.gru_sequence import (
    CLUSTER_MAX_THREADS, CLUSTER_ROWS, GRID_BWD_AHEAD, GRID_CHUNK, GRID_MAX_HIDDEN, GRID_PAD,
    GRID_STAGES, GRID_STREAM_CHUNK, GRID_STREAM_MAX_GROUPS, GRID_THREADS, GRID_UNITS,
    MAX_HIDDEN, STREAM_MAX_THREADS, STREAM_ROWS, cluster_bwd_fits, cluster_bwd_plan,
    cluster_bwd_smem, cluster_fits, cluster_plan, cluster_smem, grid_bwd_plan, grid_bwd_smem,
    grid_plan, grid_resident, grid_smem, grid_stream_plan, grid_stream_smem, grid_stream_stages,
    gru_sequence_bwd_reference, gru_sequence_bwd_wide, gru_sequence_reference,
    gru_sequence_wide, resident_clusters, stream_plan, stream_smem, weight_grads,
    wide_bwd_plan, wide_cap, wide_plan)

# The H100 SXM's numbers (132 SMs, 232,448 shared bytes a block, 233,472 an
# SM, 1,024 reserved a block) with the clusters resident at once for each C
# at one block an SM (cudaOccupancyMaxActiveClusters) and the grid
# forward's, the grid backward's and the grid forward past H 1024's blocks
# an SM at no dynamic shared memory
# (cudaOccupancyMaxActiveBlocksPerMultiprocessor: the forwards' 256
# threads' registers allow one, the backward's two) that the H100 80GB HBM3
# reports; and the same card without clusters of 16.
H100 = {"sms": 132, "smem": 232448, "smem_sm": 233472, "smem_reserved": 1024,
        "resident": {2: 66, 4: 30, 8: 15, 16: 7}, "grid_blocks_sm": 1,
        "grid_bwd_blocks_sm": 2, "grid_stream_blocks_sm": 1}
H100_PORTABLE = {**H100, "resident": {**H100["resident"], 16: 0}}
CAPS = {"16 blocks": (H100, 544), "8 blocks": (H100_PORTABLE, 384)}
# the wide route's cap on the H100: the streaming backward's one-row tile,
# 2·3H floats of dhp (3H rounded up to 4), in 232,448 shared bytes
H100_CAP = 9685


def _one_wave_exists(nb, B, H, numbers):
    """Whether some cluster that fits holds nb·ceil(B / R) clusters
    resident at once."""
    return any(nb * -(-B // R) <= resident_clusters(numbers, C, g["threads"], smem)
               for C, R, g, smem in cluster_fits(H, numbers))


@pytest.mark.parametrize("card", sorted(CAPS))
@pytest.mark.parametrize("B", [1, 4, 37, 64, 600])
def test_cluster_plan_covers_every_wide_width(card, B):
    """For every H from 129 to 1024: the cluster route up to its cap and
    the grid kernel above it (wide_plan); a cluster plan's shared bytes fit a
    block, its tiles of R rows cover B, every block owns a unit and C·U
    covers H (the last block's ragged slice masked), its depth S·KL covers
    H in float4s, short of a float4 a lane, its blocks keep to their thread bound, and it runs in one
    wave wherever some C and R allow."""
    numbers, cap = CAPS[card]
    for nb in (1, 3):
        routes = {}
        for H in range(MAX_HIDDEN + 1, GRID_MAX_HIDDEN + 1):
            plan = wide_plan(nb, B, H, numbers)
            routes[H] = plan["route"]
            if plan["route"] != "cluster":
                continue
            C, R, S, KL, U = (plan[k] for k in ("C", "R", "S", "KL", "U"))
            resident = resident_clusters(numbers, C, plan["threads"], plan["smem"])
            assert numbers["resident"][C] >= 1 and plan["resident"] == resident
            assert R in CLUSTER_ROWS
            assert plan["smem"] == cluster_smem(R, S, KL, U) <= numbers["smem"]
            tiles = -(-B // R)
            assert tiles * R >= B > (tiles - 1) * R
            assert plan["clusters"] == nb * tiles
            assert plan["waves"] == -(-plan["clusters"] // resident)
            assert C * U >= H > (C - 1) * U
            assert KL % 4 == 0 and H <= S * KL < H + 4 * S
            assert plan["threads"] == -(-U * S // 32) * 32 <= CLUSTER_MAX_THREADS
            one_wave = _one_wave_exists(nb, B, H, numbers)
            assert plan["waves"] == 1 or not one_wave, (nb, B, H, plan)
        assert [H for H, r in routes.items() if r == "cluster"] == list(
            range(MAX_HIDDEN + 1, cap + 1))
        assert all(r == "grid" for H, r in routes.items() if H > cap)


@pytest.mark.parametrize("card", sorted(CAPS))
@pytest.mark.parametrize("B", [1, 4, 37, 64, 600])
def test_grid_plan_covers_every_width_past_the_cap(card, B):
    """For every H from the clusters' cap + 1 to 1024 and nb 1 and 3, the
    grid plan: its shared bytes fit a block, its blocks each own a unit and
    together cover H (U·blocks >= H > U·(blocks - 1)), 3U is a multiple of 8
    (wgmma's N), the blocks of a wave's buckets are resident at once, a
    wave holds as many buckets as are resident, and its waves take all nb
    buckets. B does not enter: a block loops over the batch in tiles of 64
    rows."""
    numbers, cap = CAPS[card]
    for nb in (1, 3):
        for H in range(cap + 1, GRID_MAX_HIDDEN + 1):
            plan = grid_plan(nb, B, H, numbers)
            assert plan == grid_plan(nb, 1, H, numbers)
            U, chunk, stages, blocks = (plan[k] for k in ("U", "chunk", "stages", "blocks"))
            assert plan["route"] == "grid" and U == GRID_UNITS and (3 * U) % 8 == 0
            assert chunk == GRID_CHUNK and stages == GRID_STAGES
            assert plan["smem"] == grid_smem(H) <= numbers["smem"]
            assert blocks * U >= H > (blocks - 1) * U
            assert plan["resident"] == grid_resident(numbers, plan["smem"])
            per_wave = plan["buckets_per_wave"]
            assert 1 <= per_wave <= nb and blocks * per_wave <= plan["resident"]
            assert per_wave == min(nb, plan["resident"] // blocks), (nb, H, plan)
            assert plan["waves"] == -(-nb // per_wave)


def test_grid_plan_at_the_headline_shapes():
    """The grid plans the card's main paths start from: (1, 64, 1024) on 128
    blocks of 8 units, chunks of 64 in two stages (229,376 shared bytes a
    block), one wave; three buckets in three waves; (1, 9, 545) on 69 blocks,
    chunks of 64 in two stages (143,360 bytes); the automatic route turns
    from the cluster kernel to the grid at H 545; a card without cooperative
    launches gets no grid plan, and the route past the cap takes the
    streaming kernel there."""
    plan = grid_plan(1, 64, 1024, H100)
    assert (plan["U"], plan["blocks"], plan["chunk"], plan["stages"], plan["smem"],
            plan["resident"], plan["waves"]) == (8, 128, 64, 2, 229376, 132, 1)
    assert (grid_plan(3, 64, 1024, H100)["waves"],
            grid_plan(3, 64, 1024, H100)["buckets_per_wave"]) == (3, 1)
    plan = grid_plan(1, 9, 545, H100)
    assert (plan["U"], plan["blocks"], plan["chunk"], plan["stages"], plan["smem"],
            plan["waves"]) == (8, 69, 64, 2, 143360, 1)
    assert wide_plan(1, 64, 544, H100)["route"] == "cluster"
    assert wide_plan(1, 64, 545, H100)["route"] == "grid"
    none = {**H100, "grid_blocks_sm": 0}
    for H in (545, 1024):
        with pytest.raises(RuntimeError, match="grid forward"):
            grid_plan(1, 64, H, none)
        assert grid_plan(1, 64, H, none, must=False) is None
        assert wide_plan(1, 64, H, none) == stream_plan(1, 64, H, none)
        assert wide_plan(1, 64, H, none)["route"] == "stream"
    assert wide_plan(1, 64, 544, none)["route"] == "cluster"


def test_cluster_plan_at_the_headline_shapes():
    """The plans the card's main paths start from: (1, 64, 256) on sixteen
    blocks of four rows, three blocks an SM, one wave; (1, 64, 512) on
    sixteen blocks at one block an SM, in waves; (2, 37, 129) on eight
    blocks of two rows; the x14/z64/h256 TimeGAN's B 16 in one wave; nothing
    resident, no cluster."""
    plan = cluster_plan(1, 64, 256, H100)
    assert (plan["C"], plan["R"], plan["waves"], plan["S"], plan["KL"], plan["U"],
            plan["resident"]) == (16, 4, 1, 8, 32, 16, 21)
    plan = cluster_plan(1, 64, 512, H100)
    assert (plan["C"], plan["resident"], plan["waves"]) == (16, 7, 2)
    assert (cluster_plan(2, 37, 129, H100)["C"], cluster_plan(2, 37, 129, H100)["R"]) == (8, 2)
    assert cluster_plan(1, 16, 256, H100)["waves"] == 1
    none = {**H100, "resident": {c: 0 for c in H100["resident"]}}
    assert cluster_plan(1, 64, 256, none) == {"route": "stream"}


def _cluster_sum_order(xp, w, b, h0, kl, s):
    """K1 cluster forward's arithmetic in its order (csrc/gru_seq_cluster.cu),
    in numpy float32: each of S lanes sums a KL-long slice of the depth of h
    W_hhᵀ as a chain of multiply-adds from zero, in order (h and W padded
    with zeros past H), the S partial sums are added pairwise at distance
    S/2, then S/4, ... (the shuffle butterfly), then b_hh, then the gates
    with the kernel's sigmoid 1/2 + tanh(x/2)/2. A multiply-add is rounded
    once from float64, as fmaf is (within double rounding). Which block of
    the cluster owns a unit changes no sum."""
    T, B, G = xp.shape
    H = G // 3
    w_pad = np.zeros((s * kl, G), np.float32)
    w_pad[:H] = w
    w_sl = w_pad.reshape(s, kl, G).astype(np.float64)
    h = h0.astype(np.float32)
    ys = np.empty((T, B, H), np.float32)
    for t in range(T):
        h_pad = np.zeros((B, s * kl), np.float32)
        h_pad[:, :H] = h
        h_sl = h_pad.reshape(B, s, kl).transpose(1, 0, 2).astype(np.float64)
        part = np.zeros((s, B, G), np.float32)
        for k in range(kl):
            part = (h_sl[:, :, k, None] * w_sl[:, None, k, :] + part).astype(np.float32)
        while len(part) > 1:
            half = len(part) // 2
            part = part[:half] + part[half:]
        acc = part[0]
        x = xp[t]
        r = _sigmoid_fwd(x[:, :H] + (acc[:, :H] + b[0, :H]))
        z = _sigmoid_fwd(x[:, H:2 * H] + (acc[:, H:2 * H] + b[0, H:2 * H]))
        n = np.tanh(x[:, 2 * H:] + r * (acc[:, 2 * H:] + b[0, 2 * H:]))
        h = ((1 - z) * n + z * h).astype(np.float32)
        ys[t] = h
    return ys


def _geometry(B, H):
    plan = cluster_plan(1, B, H, H100)
    assert plan["route"] == "cluster"
    return plan["KL"], plan["S"]


# the headline width (KL 32, S 8, eight blocks); past H 512 on sixteen
# blocks with a ragged depth (KL 68: 24 zero-padded k) and a ragged last
# block (U 33)
@pytest.mark.parametrize("T,B,H", [(768, 3, 256), (768, 2, 520)])
def test_cluster_sum_order_matches_reference(T, B, H):
    """The cluster kernel's summation order stays within the card tests'
    1e-4 of the plain recurrence over 768 dependent steps, W at its init
    scale (~1/sqrt(H))."""
    inputs = list(_seq_inputs(np.random.default_rng(T + H), T, B, H))
    inputs[1] /= np.float32(0.3 * np.sqrt(H))
    got = _cluster_sum_order(*inputs, *_geometry(B, H))
    ref = gru_sequence_reference(*(torch.from_numpy(a) for a in inputs))
    assert np.isfinite(got).all()
    np.testing.assert_allclose(got, ref.numpy(), rtol=0, atol=1e-4)


def test_cluster_sum_order_matches_pallas_interpret():
    """The same order against the Pallas kernel in interpret mode at H 160
    (KL 20, S 8: no padding; eight blocks of 20 units)."""
    T, B, H = 16, 3, 160
    inputs = list(_seq_inputs(np.random.default_rng(T), T, B, H))
    inputs[1] /= np.float32(0.3 * np.sqrt(H))
    kl, s = _geometry(B, H)
    assert (kl, s) == (20, 8)
    ref = jax_gru_sequence(*(jnp.asarray(a) for a in inputs), True)
    np.testing.assert_allclose(_cluster_sum_order(*inputs, kl, s), np.asarray(ref),
                               rtol=0, atol=1e-4)


def _tf32(x):
    """float32 rounded to TF32 on the bits (to nearest, ties away from
    zero), as the kernels' split does."""
    bits = np.ascontiguousarray(x, np.float32).view(np.uint32)
    return ((bits + np.uint32(0x1000)) & np.uint32(0xFFFFE000)).view(np.float32)


def _tf32_slices(x):
    """x (R, K), K a multiple of 16, in the grid kernels' k-slices of 8
    (slice 2c + s, column j holds depth 16c + 4(j % 4) + 2s + j / 4),
    split x = hi + lo in TF32: two (K / 8, R, 8) arrays."""
    R, K = x.shape
    kl = np.arange(K)
    kk, j = kl // 8, kl % 8
    x = x[:, (kk // 2) * 16 + (j % 4) * 4 + (kk % 2) * 2 + j // 4]
    hi = _tf32(x)
    lo = _tf32(x - hi)
    return tuple(y.reshape(R, K // 8, 8).transpose(1, 0, 2) for y in (hi, lo))


def _grid_product(w):
    """The grid kernels' product a ↦ a w (csrc/gru_seq_grid.cu,
    csrc/gru_seq_grid_bwd.cu) in their order, in numpy float32, for W (K,
    N) with K a multiple of GRID_PAD (zeros in the padding) and a (B, K):
    the depth taken in k-slices of 8 in the kernels' order (slice 2c + s,
    column j holds depth 16c + 4(j % 4) + 2s + j / 4), each side split x =
    hi + lo in TF32; each k-slice's 8 products of lo.hi, hi.lo and hi.hi
    summed in float32 (a wgmma's partial); warpgroup s takes the slices 2c
    + s, each pass a chain for each part parity c mod 2 summed in slice
    order from zero (np.add.accumulate: one float32 rounding a slice, in
    order); a warpgroup's sum is hh + (lh + hl) with the two sets added in
    order, warpgroup 0's plus warpgroup 1's. Which block owns a unit, the
    chunk and the ring of stages change no sum."""
    slices = w.shape[0] // 8
    w_hi, w_lo = (np.ascontiguousarray(x.transpose(0, 2, 1))    # (slices, 8, N)
                  for x in _tf32_slices(w.T))

    def product(a):
        B = a.shape[0]
        a_hi, a_lo = _tf32_slices(a)
        # chain r = s + 2c of each pass (lo.hi, hi.lo, hi.hi): the slices r,
        # r + 4, r + 8, ... in order
        lh, hl, hh = (np.add.accumulate((x @ y).reshape(slices // 4, 4, B, -1), axis=0)[-1]
                      for x, y in ((a_lo, w_hi), (a_hi, w_lo), (a_hi, w_hi)))
        acc = None
        for s in (0, 1):
            part = (hh[s] + hh[s + 2]) + ((lh[s] + lh[s + 2]) + (hl[s] + hl[s + 2]))
            acc = part if acc is None else acc + part
        return acc

    return product


def _grid_sum_order(xp, w, b, h0):
    """K1 grid forward's arithmetic in its order (csrc/gru_seq_grid.cu), in
    numpy float32: h and W_hhᵀ padded with zeros to a depth of GRID_PAD,
    h W_hhᵀ as _grid_product; then b_hh and the gates with the kernel's
    sigmoid 1/2 + tanh(x/2)/2."""
    T, B, G = xp.shape
    H = G // 3
    kp = -(-H // GRID_PAD) * GRID_PAD
    w_pad = np.zeros((kp, G), np.float32)
    w_pad[:H] = w
    product = _grid_product(w_pad)
    h = h0.astype(np.float32)
    ys = np.empty((T, B, H), np.float32)
    for t in range(T):
        h_pad = np.zeros((B, kp), np.float32)
        h_pad[:, :H] = h
        acc = product(h_pad)
        x = xp[t]
        r = _sigmoid_fwd(x[:, :H] + (acc[:, :H] + b[0, :H]))
        z = _sigmoid_fwd(x[:, H:2 * H] + (acc[:, H:2 * H] + b[0, H:2 * H]))
        n = np.tanh(x[:, 2 * H:] + r * (acc[:, 2 * H:] + b[0, 2 * H:]))
        h = ((1 - z) * n + z * h).astype(np.float32)
        ys[t] = h
    return ys


# past the cap: a ragged depth (600: 8 zero-padded k) and a ragged last
# block (75 blocks of 8 units), and the largest H (128 blocks)
@pytest.mark.parametrize("T,B,H", [(768, 2, 600), (768, 2, 1024)])
def test_grid_sum_order_matches_reference(T, B, H):
    """The grid kernel's summation order (split-TF32 products, its k-slice
    order and chains) stays within the card tests' 1e-4 of the plain
    recurrence over 768 dependent steps, W at its init scale
    (~1/sqrt(H))."""
    inputs = list(_seq_inputs(np.random.default_rng(T + H), T, B, H))
    inputs[1] /= np.float32(0.3 * np.sqrt(H))
    assert grid_plan(1, B, H, H100)["route"] == "grid"
    got = _grid_sum_order(*inputs)
    ref = gru_sequence_reference(*(torch.from_numpy(a) for a in inputs))
    assert np.isfinite(got).all()
    np.testing.assert_allclose(got, ref.numpy(), rtol=0, atol=1e-4)


def test_grid_sum_order_matches_pallas_interpret():
    """The same order against the Pallas kernel in interpret mode at H 160,
    a grid plan forced below the cap (20 blocks of 8 units; no padding)."""
    T, B, H = 16, 3, 160
    inputs = list(_seq_inputs(np.random.default_rng(T), T, B, H))
    inputs[1] /= np.float32(0.3 * np.sqrt(H))
    assert grid_plan(1, B, H, H100)["blocks"] == 20
    ref = jax_gru_sequence(*(jnp.asarray(a) for a in inputs), True)
    np.testing.assert_allclose(_grid_sum_order(*inputs), np.asarray(ref), rtol=0, atol=1e-4)


def _one_bwd_wave_exists(nb, B, H, numbers):
    """Whether some backward cluster that fits holds nb·ceil(B / R)
    clusters resident at once."""
    return any(nb * -(-B // R) <= resident_clusters(numbers, C, g["threads"], smem)
               for C, R, g, smem in cluster_bwd_fits(H, numbers))


@pytest.mark.parametrize("card", sorted(CAPS))
@pytest.mark.parametrize("B", [1, 4, 37, 64, 600])
def test_cluster_bwd_plan_covers_every_wide_width(card, B):
    """For every H from 129 to 1024: the cluster backward up to the same
    cap as the forward and the grid backward above it (wide_bwd_plan); a
    cluster plan's shared
    bytes fit a block, its tiles of R rows cover B, every block owns at
    least four units and C·U covers H (the last block's ragged slice
    masked), its S slices of KE entries (a multiple of 4) cover the block's
    3U entries, short of four entries a lane, a thread holds each of the R·U (row, unit) pairs,
    its blocks keep to their thread bound, and it runs in one wave wherever
    some C, S and R allow."""
    numbers, cap = CAPS[card]
    for nb in (1, 3):
        routes = {}
        for H in range(MAX_HIDDEN + 1, GRID_MAX_HIDDEN + 1):
            plan = wide_bwd_plan(nb, B, H, numbers)
            routes[H] = plan["route"]
            if plan["route"] != "cluster":
                continue
            C, R, S, KE, U = (plan[k] for k in ("C", "R", "S", "KE", "U"))
            resident = resident_clusters(numbers, C, plan["threads"], plan["smem"])
            assert numbers["resident"][C] >= 1 and plan["resident"] == resident
            assert R in CLUSTER_ROWS and S in (1, 2, 4, 8)
            assert plan["smem"] == cluster_bwd_smem(H, C, R, S, KE, U) <= numbers["smem"]
            tiles = -(-B // R)
            assert tiles * R >= B > (tiles - 1) * R
            assert plan["clusters"] == nb * tiles
            assert plan["waves"] == -(-plan["clusters"] // resident)
            assert C * U >= H > (C - 1) * U and U >= 4
            assert KE % 4 == 0 and S * KE >= 3 * U > S * (KE - 4)
            assert plan["NO"] == -(-H // 4)
            assert plan["threads"] == -(-plan["NO"] * S // 32) * 32 <= CLUSTER_MAX_THREADS
            assert R * U <= plan["threads"]
            one_wave = _one_bwd_wave_exists(nb, B, H, numbers)
            assert plan["waves"] == 1 or not one_wave, (nb, B, H, plan)
        assert [H for H, r in routes.items() if r == "cluster"] == list(
            range(MAX_HIDDEN + 1, cap + 1))
        assert all(r == "grid" for H, r in routes.items() if H > cap)


def test_cluster_bwd_plan_at_the_headline_shapes():
    """The backward plans the card's main paths start from: (1, 64, 256) on
    sixteen blocks of four rows, two lanes a quad, three blocks an SM, one
    wave; (1, 64, 512) on sixteen blocks at one block an SM, four rows
    (eight do not fit), in three waves; the x14/z64/h256 TimeGAN's B 16 on
    eight clusters of two rows, four lanes a quad (not sixteen clusters of
    one row: two clusters sharing an SM ran slower); H 545 on the grid
    kernel; nothing resident, no cluster."""
    plan = cluster_bwd_plan(1, 64, 256, H100)
    assert (plan["C"], plan["R"], plan["S"], plan["KE"], plan["U"], plan["threads"],
            plan["resident"], plan["waves"]) == (16, 4, 2, 24, 16, 128, 21, 1)
    plan = cluster_bwd_plan(1, 64, 512, H100)
    assert (plan["C"], plan["R"], plan["resident"], plan["waves"]) == (16, 4, 7, 3)
    plan = cluster_bwd_plan(1, 16, 256, H100)
    assert (plan["C"], plan["R"], plan["S"], plan["clusters"], plan["waves"]) == (16, 2, 4, 8, 1)
    assert wide_bwd_plan(1, 64, 545, H100)["route"] == "grid"
    none = {**H100, "resident": {c: 0 for c in H100["resident"]}}
    assert cluster_bwd_plan(1, 64, 256, none) == {"route": "stream"}


def _fma(a, b, c):
    """fmaf: a b + c rounded once to float32 (from float64: within double
    rounding)."""
    return (a * b + c).astype(np.float32)


def _bwd_coefficients(xp, w, b, h0, ys):
    """The wide backwards' coefficients of every step, in numpy float32:
    hp = h_prev W_hhᵀ as one float32 product, b_hh added in the kernel;
    (c_r, c_z, c_n, (1 - z)(1 - n²), z) from xp, hp and h_prev with the
    sigmoid 1/2 + tanh(x/2)/2, as csrc/gru_seq_cluster_bwd.cu and
    csrc/gru_seq_grid_bwd.cu form them."""
    T, B, G = xp.shape
    H = G // 3
    f32 = np.float32
    h_prev = np.concatenate([h0[None], ys[:T - 1]]).astype(f32)
    hp = (h_prev.reshape(T * B, H) @ w).reshape(T, B, G).astype(f32)
    hr, hz, hn = (hp[..., k * H:(k + 1) * H] + b[0, k * H:(k + 1) * H] for k in range(3))
    r = _sigmoid_fwd(xp[..., :H] + hr)
    z = _sigmoid_fwd(xp[..., H:2 * H] + hz)
    n = np.tanh(xp[..., 2 * H:] + r * hn).astype(f32)
    omz = f32(1) - z
    e = omz * (f32(1) - n * n)
    return ((e * hn) * (r * (f32(1) - r)), (h_prev - n) * (z * omz), e * r, e, z)


def _bwd_step(dh, dy_t, coef, t):
    """Step t of the wide backwards from dh_t: (dxp_t, dhp_t, d z) with d =
    dh_t + d_ys_t."""
    d = (dh + dy_t).astype(np.float32)
    d_r, d_z, d_n = (d * coef[k][t] for k in range(3))
    return (np.concatenate([d_r, d_z, d * coef[3][t]], axis=-1),
            np.concatenate([d_r, d_z, d_n], axis=-1), d * coef[4][t])


def _cluster_bwd_sum_order(xp, w, b, h0, ys, dy, plan):
    """K1 cluster backward's arithmetic in its order
    (csrc/gru_seq_cluster_bwd.cu), in numpy float32: the coefficients of
    _bwd_coefficients; then the reverse
    chain, in which block c of the plan's C (units [cU, cU + U)) sums, for
    every output i, its 3U entries e = gU + j of dhp_t (gate g, unit j;
    zeros past its units) times W_hh[gH + cU + j, i]: each of S lanes a
    KE-long slice of the entries as a chain of multiply-adds from zero, the
    S lane sums added pairwise at distance S/2, then S/4, ... (the shuffle
    butterfly); the C blocks' partials are added in block order, then dh z.
    Returns (dxp, dhp, dh0), dhp as (T, B, 3H)."""
    T, B, G = xp.shape
    H = G // 3
    C, S, KE, U = (plan[k] for k in ("C", "S", "KE", "U"))
    f32 = np.float32
    coef = _bwd_coefficients(xp, w, b, h0, ys)
    # each block's entries as rows m of W_hh, zeros past 3U and past its units
    ent = np.arange(S * KE)
    g, j = ent // U, ent % U
    m = np.zeros((C, S * KE), np.int64)
    mask = np.zeros((C, S * KE), bool)
    for c in range(C):
        nu = min(U, H - c * U)
        mask[c] = (g < 3) & (j < nu)
        m[c] = np.where(mask[c], g * H + c * U + j, 0)
    w_hh = w.T.astype(np.float64)                               # (3H, H)
    w_sl = (w_hh[m] * mask[..., None]).reshape(C, S, KE, H)
    dxp = np.empty_like(xp)
    dhp = np.empty_like(xp)
    dh = np.zeros((B, H), f32)
    for t in range(T - 1, -1, -1):
        dxp[t], dhp[t], st = _bwd_step(dh, dy[t], coef, t)
        g_sl = (dhp[t][:, m] * mask).transpose(1, 0, 2).reshape(C, B, S, KE)
        g_sl = g_sl.transpose(0, 2, 1, 3).astype(np.float64)     # (C, S, B, KE)
        part = np.zeros((C, S, B, H), f32)
        for k in range(KE):
            part = _fma(g_sl[:, :, :, k, None], w_sl[:, :, None, k, :], part)
        while part.shape[1] > 1:
            half = part.shape[1] // 2
            part = part[:, :half] + part[:, half:]
        total = part[0, 0]
        for c in range(1, C):
            total = total + part[c, 0]
        dh = (st + total).astype(f32)
    return dxp, dhp, dh


def _bwd_inputs(T, B, H):
    inputs = list(_seq_inputs(np.random.default_rng(T + 2 * H), T, B, H))
    inputs[1] /= np.float32(0.3 * np.sqrt(H))
    ys = gru_sequence_reference(*(torch.from_numpy(a) for a in inputs)).numpy()
    dy = np.random.default_rng(H).standard_normal(ys.shape).astype(np.float32)
    return inputs, ys, dy


def _grads_of(inputs, ys, dxp, dhp, dh0):
    """(dxp, dW_hhᵀ, db_hh, dh0) with dW and db through weight_grads."""
    T, B, H = ys.shape
    h_prev = np.concatenate([inputs[3][None], ys[:T - 1]]).reshape(1, T * B, H)
    dw, db = weight_grads(torch.from_numpy(h_prev),
                          torch.from_numpy(dhp.reshape(1, T * B, 3 * H)))
    return dxp, dw[0].numpy(), db[0].numpy(), dh0


def _assert_grads_close(got, ref):
    for g, r, name in zip(got, ref, ("dxp", "dw", "db", "dh0")):
        r = np.asarray(r)
        assert g.shape == r.shape and np.isfinite(g).all(), name
        scale = 1.0 if name in ("dxp", "dh0") else max(1.0, float(np.abs(r).max()))
        np.testing.assert_allclose(g, r, rtol=0, atol=1e-4 * scale, err_msg=name)


# the headline width (sixteen blocks of 16 units, four lanes a quad at B
# 3); past H 512 on sixteen blocks with a ragged last block (U 33, 25 units
# in the last), quads that straddle two blocks and two lanes a quad
@pytest.mark.parametrize("T,B,H", [(768, 3, 256), (768, 2, 520)])
def test_cluster_bwd_sum_order_matches_reference(T, B, H):
    """The cluster backward's summation order stays within the card tests'
    1e-4 of the plain backward over 768 reverse steps, W at its init scale
    (~1/sqrt(H)): dxp and dh0, and dW and db (relative to their scale)
    through weight_grads."""
    inputs, ys, dy = _bwd_inputs(T, B, H)
    plan = cluster_bwd_plan(1, B, H, H100)
    assert plan["route"] == "cluster"
    got = _grads_of(inputs, ys, *_cluster_bwd_sum_order(*inputs, ys, dy, plan))
    ref = gru_sequence_bwd_reference(*(torch.from_numpy(a) for a in (*inputs, ys, dy)))
    _assert_grads_close(got, [t.numpy() for t in ref])


def test_cluster_bwd_sum_order_matches_pallas_interpret():
    """The same order against the custom VJP of the Pallas kernel in
    interpret mode at H 160 (sixteen blocks of 10 units, four lanes a quad
    of 8 entries each, the last two of the 32 zeros)."""
    T, B, H = 16, 3, 160
    inputs, ys, dy = _bwd_inputs(T, B, H)
    plan = cluster_bwd_plan(1, B, H, H100)
    assert (plan["C"], plan["S"], plan["KE"], plan["U"]) == (16, 4, 8, 10)
    got = _grads_of(inputs, ys, *_cluster_bwd_sum_order(*inputs, ys, dy, plan))
    ys_jax, vjp = jax.vjp(lambda *a: jax_gru_sequence(*a, True),
                          *(jnp.asarray(a) for a in inputs))
    np.testing.assert_allclose(np.asarray(ys_jax), ys, rtol=0, atol=1e-5)
    _assert_grads_close(got, vjp(jnp.asarray(dy)))


@pytest.mark.parametrize("card", sorted(CAPS))
@pytest.mark.parametrize("B", [1, 4, 37, 64, 600])
def test_grid_bwd_plan_covers_every_width_past_the_cap(card, B):
    """For every H from the clusters' cap + 1 to 1024 and nb 1 and 3, the
    grid backward's plan (wide_bwd_plan's there): its shared bytes fit a
    block, its blocks each own a unit and together cover H (U·blocks >= H >
    U·(blocks - 1)), the blocks of a wave's buckets are resident at once, a
    wave holds as many buckets as are resident, and its waves take all nb
    buckets; B does not enter. A card without cooperative launches gets no
    grid plan: grid_bwd_plan raises there, and wide_bwd_plan takes the
    streaming kernel."""
    numbers, cap = CAPS[card]
    none = {**numbers, "grid_bwd_blocks_sm": 0}
    for nb in (1, 3):
        for H in range(cap + 1, GRID_MAX_HIDDEN + 1):
            plan = grid_bwd_plan(nb, B, H, numbers)
            assert plan == grid_bwd_plan(nb, 1, H, numbers) == wide_bwd_plan(nb, B, H, numbers)
            U, blocks = plan["U"], plan["blocks"]
            assert plan["route"] == "grid" and U == GRID_UNITS and plan["threads"] == GRID_THREADS
            two = 2 * (plan["smem"] + numbers["smem_reserved"]) <= numbers["smem_sm"]
            assert plan["ahead"] == GRID_BWD_AHEAD[0 if two else 1]
            assert plan["smem"] == grid_bwd_smem(H) <= numbers["smem"]
            assert blocks * U >= H > (blocks - 1) * U
            assert plan["resident"] == grid_resident(numbers, plan["smem"], "grid_bwd_blocks_sm")
            per_wave = plan["buckets_per_wave"]
            assert 1 <= per_wave <= nb and blocks * per_wave <= plan["resident"]
            assert per_wave == min(nb, plan["resident"] // blocks), (nb, H, plan)
            assert plan["waves"] == -(-nb // per_wave)
        for H in (cap + 1, 777, GRID_MAX_HIDDEN):
            with pytest.raises(RuntimeError, match="grid backward"):
                grid_bwd_plan(nb, B, H, none)
            assert wide_bwd_plan(nb, B, H, none) == stream_plan(nb, B, H, none)


def test_grid_bwd_plan_at_the_headline_shapes():
    """The grid backward's plans the card's main paths start from: (1, 64,
    1024) on 128 blocks of 8 units, 196,608 bytes of W_hh's columns and 4,096
    of the warps' sums (200,704 shared bytes a block), one block an SM, one
    wave, eight parts in flight a lane; three buckets in three waves; (1, 9,
    545) on 69 blocks of 114,688 bytes, two an SM, two parts in flight;
    three buckets at H 545 in one wave and eighteen in six; the automatic
    route turns from the cluster backward to the grid at H 545."""
    plan = grid_bwd_plan(1, 64, 1024, H100)
    assert (plan["U"], plan["blocks"], plan["ahead"], plan["smem"], plan["resident"],
            plan["waves"]) == (8, 128, 8, 196608 + 4096, 132, 1)
    plan = grid_bwd_plan(3, 64, 1024, H100)
    assert (plan["waves"], plan["buckets_per_wave"]) == (3, 1)
    plan = grid_bwd_plan(1, 9, 545, H100)
    assert (plan["blocks"], plan["ahead"], plan["smem"], plan["resident"], plan["waves"]) == (
        69, 2, 110592 + 4096, 264, 1)
    assert grid_bwd_plan(3, 63, 545, H100)["waves"] == 1
    assert grid_bwd_plan(18, 63, 545, H100)["waves"] == 6
    assert wide_bwd_plan(1, 64, 544, H100)["route"] == "cluster"
    assert wide_bwd_plan(1, 64, 545, H100)["route"] == "grid"


def _grid_bwd_product(w):
    """The grid backward's product a ↦ a w (csrc/gru_seq_grid_bwd.cu) in its
    order, in numpy float32, for W (K, N) with K a multiple of GRID_PAD
    (zeros in the padding) and a (B, K): the depth in _tf32_slices' k-slices,
    both sides split in TF32. The rows go in tiles of 64, each cut into nt =
    ceil(n / 16) tiles of 16 (1, 2, or 3 and 4 taken as 4); the block's 8
    warps split evenly over them, ways = 8 / tiles warps a tile, and warp v
    of a tile takes the 16-deep parts p = v mod ways in order, each as its
    slices 2p and 2p + 1, with one chain for each product (lo.hi, hi.lo,
    hi.hi): a slice's 8 products summed in float32 (an mma's partial),
    added in slice order from zero (np.add.accumulate); a warp's sum is hh
    + (lh + hl), a tile's warps' sums are added in order."""
    parts = w.shape[0] // 16
    w_hi, w_lo = (np.ascontiguousarray(x.transpose(0, 2, 1))    # (slices, 8, N)
                  for x in _tf32_slices(w.T))

    def product(a):
        a_hi, a_lo = _tf32_slices(a)
        passes = (a_lo @ w_hi, a_hi @ w_lo, a_hi @ w_hi)     # (slices, B, N) each
        acc = np.empty(passes[0].shape[1:], np.float32)
        for m0 in range(0, a.shape[0], 64):
            rows = slice(m0, m0 + 64)
            nt = -(-min(64, a.shape[0] - m0) // 16)
            ways = 8 // (nt if nt < 3 else 4)
            tile = None
            for v in range(ways):
                idx = [s for p in range(v, parts, ways) for s in (2 * p, 2 * p + 1)]
                lh, hl, hh = (np.add.accumulate(x[idx, rows], axis=0)[-1] for x in passes)
                part = hh + (lh + hl)
                tile = part if tile is None else tile + part
            acc[rows] = tile
        return acc

    return product


def _grid_bwd_sum_order(xp, w, b, h0, ys, dy):
    """K1 grid backward's arithmetic in its order (csrc/gru_seq_grid_bwd.cu),
    in numpy float32: the coefficients of _bwd_coefficients; then the reverse
    chain, in which dhp_t is laid out gate by gate, each gate padded with
    zeros to Hp (H rounded up to GRID_PAD), and multiplied by W_hh's rows in
    the same padded order (zeros in the padding) as _grid_bwd_product, over
    K = 3 Hp; then dh_{t-1} = d z + that sum. Which block owns a unit, the
    ring of stages and the 16-row tiles change no sum: a unit's whole sum is
    made in one block. Returns (dxp, dhp, dh0), dhp as (T, B, 3H)."""
    T, B, G = xp.shape
    H = G // 3
    hp = -(-H // GRID_PAD) * GRID_PAD
    coef = _bwd_coefficients(xp, w, b, h0, ys)
    w_pad = np.zeros((3 * hp, H), np.float32)
    for g in range(3):
        w_pad[g * hp:g * hp + H] = w[:, g * H:(g + 1) * H].T    # W_hh's rows of gate g
    product = _grid_bwd_product(w_pad)
    dxp = np.empty_like(xp)
    dhp = np.empty_like(xp)
    dh = np.zeros((B, H), np.float32)
    for t in range(T - 1, -1, -1):
        dxp[t], dhp[t], st = _bwd_step(dh, dy[t], coef, t)
        a = np.zeros((B, 3 * hp), np.float32)
        for g in range(3):
            a[:, g * hp:g * hp + H] = dhp[t][:, g * H:(g + 1) * H]
        dh = (st + product(a)).astype(np.float32)
    return dxp, dhp, dh


# past the cap: a ragged depth (600: each gate padded by 8) and a ragged
# last block (75 blocks of 8 units), and the largest H (128 blocks), eight
# warps on one 16-row tile; and 40 rows (three 16-row tiles: two warps a
# tile)
@pytest.mark.parametrize("T,B,H", [(768, 2, 600), (768, 2, 1024), (64, 40, 600)])
def test_grid_bwd_sum_order_matches_reference(T, B, H):
    """The grid backward's summation order (split-TF32 products over the
    gate-padded depth, its warps' k-slices and chains) stays within the card
    tests' 1e-4 of the plain backward over 768 reverse steps, W at its init
    scale (~1/sqrt(H)): dxp and dh0, and dW and db (relative to their scale)
    through weight_grads."""
    inputs, ys, dy = _bwd_inputs(T, B, H)
    assert wide_bwd_plan(1, B, H, H100)["route"] == "grid"
    got = _grads_of(inputs, ys, *_grid_bwd_sum_order(*inputs, ys, dy))
    ref = gru_sequence_bwd_reference(*(torch.from_numpy(a) for a in (*inputs, ys, dy)))
    _assert_grads_close(got, [t.numpy() for t in ref])


def test_grid_bwd_sum_order_matches_pallas_interpret():
    """The same order against the custom VJP of the Pallas kernel in
    interpret mode at H 160, a grid plan forced below the cap (20 blocks of
    8 units; 160 is a multiple of 32: no padding)."""
    T, B, H = 16, 3, 160
    inputs, ys, dy = _bwd_inputs(T, B, H)
    assert grid_bwd_plan(1, B, H, H100)["blocks"] == 20
    got = _grads_of(inputs, ys, *_grid_bwd_sum_order(*inputs, ys, dy))
    ys_jax, vjp = jax.vjp(lambda *a: jax_gru_sequence(*a, True),
                          *(jnp.asarray(a) for a in inputs))
    np.testing.assert_allclose(np.asarray(ys_jax), ys, rtol=0, atol=1e-5)
    _assert_grads_close(got, vjp(jnp.asarray(dy)))


@pytest.mark.parametrize("half", ["forward", "backward"])
def test_wide_route_refuses_an_unknown_plan(half):
    """A plan whose route is none of the cluster, grid and streaming
    kernels raises before anything is launched, on whatever device the
    tensors lie: no route is taken in its place."""
    nb, T, B, H = 1, 3, 2, 160
    xp, w, b, h0 = (torch.zeros(shape) for shape in ((nb, T, B, 3 * H), (nb, H, 3 * H),
                                                     (nb, 1, 3 * H), (nb, B, H)))
    with pytest.raises(ValueError, match="no route 'tiles'"):
        if half == "forward":
            gru_sequence_wide(xp, w, b, h0, plan={"route": "tiles"})
        else:
            h_prev = torch.zeros(nb, T * B, H)
            gru_sequence_bwd_wide(xp, xp.reshape(nb, T * B, 3 * H), h_prev,
                                  torch.zeros(nb, T, B, H), w, b, xp, plan={"route": "tiles"})


@pytest.mark.parametrize("card", sorted(CAPS))
@pytest.mark.parametrize("B", [1, 4, 37, 64, 600])
def test_wide_plans_keep_their_routes_up_to_1024(card, B):
    """For every H from 129 to 1024 and nb 1 and 3, wide_plan and
    wide_bwd_plan are the plans they were before the streaming kernels
    joined the route: the cluster plan where one fits, else the grid plan
    (which raises where it cannot launch); never the streaming kernel."""
    numbers, _ = CAPS[card]
    for nb in (1, 3):
        for H in range(MAX_HIDDEN + 1, GRID_MAX_HIDDEN + 1):
            for wide, cluster, grid in ((wide_plan, cluster_plan, grid_plan),
                                        (wide_bwd_plan, cluster_bwd_plan, grid_bwd_plan)):
                plan = cluster(nb, B, H, numbers)
                want = plan if plan["route"] == "cluster" else grid(nb, B, H, numbers)
                assert wide(nb, B, H, numbers) == want, (wide.__name__, nb, B, H)


@pytest.mark.parametrize("nb,B", [(1, 1), (1, 16), (1, 64), (18, 63), (1, 600)])
def test_wide_plans_stream_past_1024(nb, B):
    """For every H from 1025 to the cap (9685 on the H100), the forward
    takes the grid that streams W's remainder (wide_plan is
    grid_stream_plan's plan) and the backward the streaming kernel
    (wide_bwd_plan is stream_plan's tile), on the card with clusters of 16
    and without."""
    for numbers in (H100, H100_PORTABLE):
        assert wide_cap(numbers) == H100_CAP
        for H in range(GRID_MAX_HIDDEN + 1, H100_CAP + 1):
            plan = stream_plan(nb, B, H, numbers)
            assert plan["route"] == "stream" and plan == wide_bwd_plan(nb, B, H, numbers)
            fwd = wide_plan(nb, B, H, numbers)
            assert fwd["route"] == "grid_stream" and fwd == grid_stream_plan(nb, B, H, numbers)


# the paths' (nb, B) past H 1024: the sequential trainer's bucket,
# [timegan-wide]'s generator batch, chip_smoke.py's two waves at H 1025, and
# the parallel trainer's eighteen buckets at the D step's batch
@pytest.mark.parametrize("nb,B", [(1, 64), (1, 16), (2, 37), (18, 63)])
def test_grid_stream_plan_covers_every_width_past_1024(nb, B):
    """For every H from 1025 to the cap, grid_stream_plan at the H100's
    numbers: the fewest groups J (to GRID_STREAM_MAX_GROUPS) whose blocks of
    8J units, one an SM, are resident at once, and they cover H; 3U a
    multiple of 8 and at most 256 (J wgmma n24 a k-slice); its shared bytes
    (grid_stream_smem) fit a block and an SM; the resident and the streamed
    depth, multiples of GRID_STREAM_CHUNK, cover W's padded depth exactly
    once, the resident as deep as fits; a wave's buckets are resident at
    once and the waves take all nb. B does not enter. A card without
    cooperative launches gets no plan: grid_stream_plan and wide_plan raise
    there, naming what did not fit. H up to 1024 keeps its plans."""
    none = {**H100, "grid_stream_blocks_sm": 0}
    room = min(H100["smem"], H100["smem_sm"] - H100["smem_reserved"])
    for H in range(GRID_MAX_HIDDEN + 1, H100_CAP + 1):
        plan = grid_stream_plan(nb, B, H, H100)
        assert plan == grid_stream_plan(nb, 1, H, H100)
        J, U, blocks = plan["groups"], plan["U"], plan["blocks"]
        assert 1 <= J <= GRID_STREAM_MAX_GROUPS and U == GRID_UNITS * J
        assert (3 * U) % 8 == 0 and 3 * U <= 256
        assert blocks * U >= H > (blocks - 1) * U
        assert plan["resident"] == H100["sms"] and plan["blocks_sm"] == 1
        assert blocks <= plan["resident"]
        assert J == 1 or -(-H // (GRID_UNITS * (J - 1))) > plan["resident"]
        depth = -(-H // GRID_PAD) * GRID_PAD
        kept, streamed = plan["resident_depth"], plan["streamed_depth"]
        assert kept + streamed == depth and kept >= 0 and streamed >= 0
        assert kept % GRID_STREAM_CHUNK == 0 and streamed % GRID_STREAM_CHUNK == 0
        assert plan["smem"] == grid_stream_smem(J, kept) <= room
        assert kept == depth or grid_stream_smem(J, kept + GRID_STREAM_CHUNK) > room
        assert plan["stages"] == grid_stream_stages(J) and plan["chunk"] == GRID_STREAM_CHUNK
        assert plan["threads"] == GRID_THREADS
        per_wave = plan["buckets_per_wave"]
        assert per_wave == min(nb, plan["resident"] // blocks) and blocks * per_wave <= 132
        assert plan["waves"] == -(-nb // per_wave)
    for H in (GRID_MAX_HIDDEN + 1, 1536, 2048, H100_CAP):
        with pytest.raises(RuntimeError, match="grid forward past H 1024.*resident"):
            grid_stream_plan(nb, B, H, none)
        with pytest.raises(RuntimeError, match="cooperative launches no"):
            wide_plan(nb, B, H, none)
    for H in (MAX_HIDDEN + 1, 544, 545, 777, GRID_MAX_HIDDEN):
        assert wide_plan(nb, B, H, H100)["route"] in ("cluster", "grid")


def test_grid_stream_plan_at_the_headline_shapes():
    """The plans the card's main paths start from past H 1024: (1, 64,
    1536) on 96 blocks of 16 units, 384 of W's 1536 rows resident and 1152
    streamed, four stages (229,376 shared bytes), one wave; (1, 64, 2048) on
    128 blocks, 1664 rows streamed; H 1025 on 129 blocks of 8 units (1056
    deep: 896 resident), two buckets in two waves and eighteen in eighteen;
    H 2113 the first on three groups; the cap on 122 blocks of 80 units,
    three stages, all 9696 rows streamed."""
    plan = grid_stream_plan(1, 64, 1536, H100)
    assert (plan["groups"], plan["blocks"], plan["resident_depth"], plan["streamed_depth"],
            plan["stages"], plan["smem"], plan["waves"]) == (2, 96, 384, 1152, 4, 229376, 1)
    plan = grid_stream_plan(1, 64, 2048, H100)
    assert (plan["groups"], plan["blocks"], plan["streamed_depth"]) == (2, 128, 1664)
    plan = grid_stream_plan(2, 37, 1025, H100)
    assert (plan["groups"], plan["blocks"], plan["resident_depth"], plan["waves"]) == (
        1, 129, 896, 2)
    assert grid_stream_plan(18, 63, 1025, H100)["waves"] == 18
    assert grid_stream_plan(1, 64, 2112, H100)["groups"] == 2
    assert grid_stream_plan(1, 64, 2113, H100)["groups"] == 3
    plan = grid_stream_plan(1, 2, H100_CAP, H100)
    assert (plan["groups"], plan["blocks"], plan["stages"], plan["resident_depth"],
            plan["streamed_depth"]) == (10, 122, 3, 0, 9696)


def _owners(H, threads):
    """How many threads own each column when thread j owns j, j + threads,
    j + 2·threads, ... below H (gru_seq_wide.cu's loops)."""
    cols = np.concatenate([np.arange(j, H, threads) for j in range(threads)])
    return np.bincount(cols, minlength=H)


@pytest.mark.parametrize("nb,B", [(1, 1), (1, 2), (1, 64), (3, 64), (18, 63), (1, 600)])
def test_stream_tile_fits_every_width_to_the_cap(nb, B):
    """For every H from 1 to the cap: the streaming tile's rows are the
    fewest of 1, 2, 4 that give one tile per SM (else 4), halved while the
    backward's two (R, 3H) buffers of dhp do not fit a block; both halves'
    shared bytes fit a block; its blocks of R rows cover B; its threads are
    min(1024, H rounded up to a warp) and own ceil(H / threads) columns each,
    which cover H exactly once. One row more does not fit at the cap's H."""
    smem = H100["smem"]
    want = -(-nb * B // H100["sms"])
    for H in range(1, H100_CAP + 1):
        plan = stream_plan(nb, B, H, H100)
        R, threads, cols = plan["R"], plan["threads"], plan["cols"]
        assert R in STREAM_ROWS
        first = 1 if want <= 1 else 2 if want <= 2 else 4
        assert R <= first and (R == first or stream_smem(2 * R, H)[1] > smem)
        assert (plan["fwd_smem"], plan["bwd_smem"]) == stream_smem(R, H)
        assert plan["fwd_smem"] <= plan["bwd_smem"] <= smem
        assert plan["blocks"] * R >= B > (plan["blocks"] - 1) * R
        assert threads == min(STREAM_MAX_THREADS, -(-H // 32) * 32) and threads % 32 == 0
        assert cols * threads >= H > (cols - 1) * threads
    for H in (1, 31, 129, 1024, 1025, 1536, 2048, 4097, H100_CAP):
        threads = stream_plan(nb, B, H, H100)["threads"]
        assert (_owners(H, threads) == 1).all(), H
    assert stream_smem(1, H100_CAP)[1] <= smem < stream_smem(1, H100_CAP + 1)[1]


@pytest.mark.parametrize("half", ["forward", "backward", "tile"])
def test_wide_route_past_the_cap_names_the_cap(half):
    """Past the cap no route holds a step's dhp: the plans raise, and the
    error names the cap and why; the cap itself plans the grid forward past
    H 1024 (ten groups of 8 units a block) and the streaming backward (one
    row a block: R 4 and R 2 no longer fit)."""
    plan = {"forward": wide_plan, "backward": wide_bwd_plan, "tile": stream_plan}[half]
    at_cap = plan(1, 64, H100_CAP, H100)
    if half == "forward":
        assert at_cap["route"] == "grid_stream" and at_cap["groups"] == GRID_STREAM_MAX_GROUPS
    else:
        assert at_cap["route"] == "stream" and at_cap["R"] == 1
    with pytest.raises(ValueError, match=f"H={H100_CAP + 1} past the wide route's cap "
                                         f"H {H100_CAP}.*dhp"):
        plan(1, 64, H100_CAP + 1, H100)


def _sequential_product(a, w, chunk=64):
    """a (B, K) w (K, N) as the streaming kernels sum it, in numpy float32:
    each output's sum over the depth k in order, from zero, one float32
    addition a product (np.add.reduce down axis 0 adds row after row); each
    product is rounded to float32 before its addition, once more than the
    kernels' fmaf rounds. The depth goes in chunks that stay in cache; the
    float4 reads change no sum."""
    B, K = a.shape
    buf = np.empty((chunk + 1, B, w.shape[1]), np.float32)
    acc = np.zeros((B, w.shape[1]), np.float32)
    a_t = np.ascontiguousarray(a.T)
    for k0 in range(0, K, chunk):
        k1 = min(K, k0 + chunk)
        buf[0] = acc
        np.multiply(w[k0:k1, None, :], a_t[k0:k1, :, None], out=buf[1:k1 - k0 + 1])
        acc = np.add.reduce(buf[:k1 - k0 + 1], axis=0)
    return acc


def _stream_sum_order(xp, w, b, h0):
    """K1 streaming forward's arithmetic in its order
    (csrc/gru_seq_wide.cu), in numpy float32: h W_hhᵀ as
    _sequential_product, then b_hh and the gates with the kernel's sigmoid
    1/2 + tanh(x/2)/2. Which thread owns a column changes no sum."""
    T, B, G = xp.shape
    H = G // 3
    h = h0.astype(np.float32)
    ys = np.empty((T, B, H), np.float32)
    for t in range(T):
        acc = _sequential_product(h, w)
        x = xp[t]
        r = _sigmoid_fwd(x[:, :H] + (acc[:, :H] + b[0, :H]))
        z = _sigmoid_fwd(x[:, H:2 * H] + (acc[:, H:2 * H] + b[0, H:2 * H]))
        n = np.tanh(x[:, 2 * H:] + r * (acc[:, 2 * H:] + b[0, 2 * H:]))
        h = ((1 - z) * n + z * h).astype(np.float32)
        ys[t] = h
    return ys


# past the grids' 1024: two columns a thread from H 1025 (1056: the first H
# a bucket's grid blocks outnumber the SMs), and H 2048
@pytest.mark.parametrize("H", [1056, 2048])
def test_stream_sum_order_matches_reference(H):
    """The streaming forward's summation order (a chain over the whole depth
    a column; the kernel of the plan {"route": "stream"}, past H 1024 the
    planned route's comparison) stays within the card tests' 1e-4 of the
    plain recurrence over 768 dependent steps, W at its init scale
    (~1/sqrt(H)). The planned forward there is the grid that streams W's
    remainder, the planned backward the streaming kernel."""
    T, B = 768, 2
    inputs = list(_seq_inputs(np.random.default_rng(T + H), T, B, H))
    inputs[1] /= np.float32(0.3 * np.sqrt(H))
    assert wide_plan(1, B, H, H100)["route"] == "grid_stream"
    assert stream_plan(1, B, H, H100)["route"] == wide_bwd_plan(1, B, H, H100)["route"] == "stream"
    got = _stream_sum_order(*inputs)
    ref = gru_sequence_reference(*(torch.from_numpy(a) for a in inputs))
    assert np.isfinite(got).all()
    np.testing.assert_allclose(got, ref.numpy(), rtol=0, atol=1e-4)


def _grid_stream_product(w):
    """The grid forward past H 1024's product a ↦ a w
    (csrc/gru_seq_grid_stream.cu) in its order, in numpy float32, for W (K,
    N) with K a multiple of GRID_PAD (zeros in the padding) and a (B, K):
    the depth in _tf32_slices' k-slices, both sides split in TF32; each
    k-slice's 8 products of lo.hi, hi.lo and hi.hi summed in float32 (a
    wgmma's partial); warpgroup s takes the slices 2p + s and adds the
    partials into one float32 sum from zero in the kernel's order, slice by
    slice, lo.hi then hi.lo then hi.hi (np.add.accumulate); warpgroup 0's
    sum plus warpgroup 1's. Which block and group own a unit, the resident
    and the streamed rows and the ring change no sum."""
    w_hi, w_lo = (np.ascontiguousarray(x.transpose(0, 2, 1))    # (slices, 8, N)
                  for x in _tf32_slices(w.T))

    def product(a):
        a_hi, a_lo = _tf32_slices(a)
        passes = np.stack([a_lo @ w_hi, a_hi @ w_lo, a_hi @ w_hi], axis=1)  # (slices, 3, B, N)
        acc = None
        for s in (0, 1):
            terms = passes[s::2].reshape(-1, *passes.shape[2:])
            part = np.add.accumulate(terms, axis=0)[-1]
            acc = part if acc is None else acc + part
        return acc

    return product


def _grid_stream_sum_order(xp, w, b, h0):
    """K1 grid forward past H 1024's arithmetic in its order
    (csrc/gru_seq_grid_stream.cu), in numpy float32: h and W_hhᵀ padded with
    zeros to a depth of GRID_PAD, h W_hhᵀ as _grid_stream_product; then b_hh
    and the gates with the kernel's sigmoid 1/2 + tanh(x/2)/2."""
    T, B, G = xp.shape
    H = G // 3
    kp = -(-H // GRID_PAD) * GRID_PAD
    w_pad = np.zeros((kp, G), np.float32)
    w_pad[:H] = w
    product = _grid_stream_product(w_pad)
    h = h0.astype(np.float32)
    ys = np.empty((T, B, H), np.float32)
    for t in range(T):
        h_pad = np.zeros((B, kp), np.float32)
        h_pad[:, :H] = h
        acc = product(h_pad)
        x = xp[t]
        r = _sigmoid_fwd(x[:, :H] + (acc[:, :H] + b[0, :H]))
        z = _sigmoid_fwd(x[:, H:2 * H] + (acc[:, H:2 * H] + b[0, H:2 * H]))
        n = np.tanh(x[:, 2 * H:] + r * (acc[:, 2 * H:] + b[0, 2 * H:]))
        h = ((1 - z) * n + z * h).astype(np.float32)
        ys[t] = h
    return ys


# [timegan-wide]'s h1536 (96 blocks of 16 units) and H 1025 (129 blocks of
# 8, a depth padded by 31 zeros), at a short T
@pytest.mark.parametrize("T,B,H", [(96, 3, 1536), (96, 2, 1025)])
def test_grid_stream_sum_order_matches_reference(T, B, H):
    """The grid forward past H 1024's summation order (split-TF32 products,
    its k-slices, one sum a warpgroup) stays within the card tests' 1e-4 of
    the plain recurrence, W at its init scale (~1/sqrt(H))."""
    inputs = list(_seq_inputs(np.random.default_rng(T + H), T, B, H))
    inputs[1] /= np.float32(0.3 * np.sqrt(H))
    assert wide_plan(1, B, H, H100)["route"] == "grid_stream"
    got = _grid_stream_sum_order(*inputs)
    ref = gru_sequence_reference(*(torch.from_numpy(a) for a in inputs))
    assert np.isfinite(got).all()
    np.testing.assert_allclose(got, ref.numpy(), rtol=0, atol=1e-4)


def test_grid_stream_sum_order_matches_pallas_interpret():
    """The same order against the Pallas kernel in interpret mode at H 160
    (a multiple of 32: no padding)."""
    T, B, H = 16, 3, 160
    inputs = list(_seq_inputs(np.random.default_rng(T + 1), T, B, H))
    inputs[1] /= np.float32(0.3 * np.sqrt(H))
    ref = jax_gru_sequence(*(jnp.asarray(a) for a in inputs), True)
    np.testing.assert_allclose(_grid_stream_sum_order(*inputs), np.asarray(ref), rtol=0,
                               atol=1e-4)


def _stream_bwd_sum_order(xp, w, b, h0, ys, dy):
    """K1 streaming backward's arithmetic in its order
    (csrc/gru_seq_wide.cu), in numpy float32: the coefficients of
    _bwd_coefficients (staged in dxp and dhp, which changes no value); then
    the reverse chain, dh_{t-1} = d z + dhp_t W_hh with the sum over the 3H
    rows of W_hh in order (_sequential_product). Returns (dxp, dhp, dh0),
    dhp as (T, B, 3H)."""
    T, B, G = xp.shape
    coef = _bwd_coefficients(xp, w, b, h0, ys)
    w_hh = np.ascontiguousarray(w.T)                    # (3H, H)
    dxp = np.empty_like(xp)
    dhp = np.empty_like(xp)
    dh = np.zeros(h0.shape, np.float32)
    for t in range(T - 1, -1, -1):
        dxp[t], dhp[t], st = _bwd_step(dh, dy[t], coef, t)
        dh = (st + _sequential_product(dhp[t], w_hh)).astype(np.float32)
    return dxp, dhp, dh


@pytest.mark.parametrize("H", [1056, 2048])
def test_stream_bwd_sum_order_matches_reference(H):
    """The streaming backward's summation order stays within the card tests'
    1e-4 of the plain backward over 768 reverse steps, W at its init scale
    (~1/sqrt(H)): dxp and dh0, and dW and db (relative to their scale)
    through weight_grads."""
    T, B = 768, 2
    inputs, ys, dy = _bwd_inputs(T, B, H)
    assert wide_bwd_plan(1, B, H, H100)["route"] == "stream"
    got = _grads_of(inputs, ys, *_stream_bwd_sum_order(*inputs, ys, dy))
    ref = gru_sequence_bwd_reference(*(torch.from_numpy(a) for a in (*inputs, ys, dy)))
    _assert_grads_close(got, [t.numpy() for t in ref])


def test_plain_twins_match_pallas_past_1024():
    """Past the grids, the plain forward and backward (the CPU path and the
    streaming kernels' oracle) against the Pallas kernel in interpret mode
    and its custom VJP at H 1040, float32."""
    T, B, H = 8, 2, 1040
    inputs, ys, dy = _bwd_inputs(T, B, H)
    assert all(a.dtype == np.float32 for a in (*inputs, ys, dy))
    ys_jax, vjp = jax.vjp(lambda *a: jax_gru_sequence(*a, True),
                          *(jnp.asarray(a) for a in inputs))
    assert ys_jax.dtype == jnp.float32
    np.testing.assert_allclose(np.asarray(ys_jax), ys, rtol=0, atol=1e-5)
    ref = gru_sequence_bwd_reference(*(torch.from_numpy(a) for a in (*inputs, ys, dy)))
    _assert_grads_close([t.numpy() for t in ref], vjp(jnp.asarray(dy)))
