"""K1's wide forward and backward on thread-block clusters
(``csrc/gru_seq_cluster.cu``, ``csrc/gru_seq_cluster_bwd.cu``) and, past the
clusters' cap, the forward on one cooperative grid (``csrc/gru_seq_grid.cu``)
on the CPU: the route, cluster and rows that ``cluster_plan`` and
``cluster_bwd_plan`` pick at the H100's numbers and the grid plan above the
cap, and each kernel's summation order, emulated in numpy float32, against
the plain versions and the Pallas kernel (and its custom VJP) in interpret
mode. The kernels themselves run on the card (tests/test_torch_card.py,
chip_smoke.py)."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from test_torch_gru import _seq_inputs, _sigmoid_fwd
from test_torch_threads import one_thread_each  # noqa: F401

from eegsynth.nn.pallas_gru import gru_sequence as jax_gru_sequence
from eegsynth_torch.nn.gru_sequence import (
    CLUSTER_MAX_THREADS, CLUSTER_ROWS, GRID_CHUNK, GRID_PAD, GRID_STAGES, GRID_UNITS,
    MAX_HIDDEN, MAX_WIDE_HIDDEN, cluster_bwd_fits, cluster_bwd_plan, cluster_bwd_smem,
    cluster_fits, cluster_plan, cluster_smem, grid_plan, grid_resident, grid_smem,
    gru_sequence_bwd_reference, gru_sequence_reference, resident_clusters, weight_grads,
    wide_plan)

# The H100 SXM's numbers (132 SMs, 232,448 shared bytes a block, 233,472 an
# SM, 1,024 reserved a block) with the clusters resident at once for each C
# at one block an SM (cudaOccupancyMaxActiveClusters) and the grid
# forward's blocks an SM at no dynamic shared memory
# (cudaOccupancyMaxActiveBlocksPerMultiprocessor: its 256 threads' registers
# allow one) that the H100 80GB HBM3 reports; and the same card without
# clusters of 16.
H100 = {"sms": 132, "smem": 232448, "smem_sm": 233472, "smem_reserved": 1024,
        "resident": {2: 66, 4: 30, 8: 15, 16: 7}, "grid_blocks_sm": 1}
H100_PORTABLE = {**H100, "resident": {**H100["resident"], 16: 0}}
CAPS = {"16 blocks": (H100, 544), "8 blocks": (H100_PORTABLE, 384)}


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
        for H in range(MAX_HIDDEN + 1, MAX_WIDE_HIDDEN + 1):
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
        for H in range(cap + 1, MAX_WIDE_HIDDEN + 1):
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
    launches gets no grid plan, and the route past the cap raises there."""
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
        with pytest.raises(RuntimeError, match="grid forward"):
            wide_plan(1, 64, H, none)
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


def _grid_sum_order(xp, w, b, h0):
    """K1 grid forward's arithmetic in its order (csrc/gru_seq_grid.cu), in
    numpy float32: h and W padded with zeros to a depth of GRID_PAD, their
    depth taken in k-slices of 8 in the kernel's order (slice 2c + s, column
    j holds depth 16c + 4(j % 4) + 2s + j / 4), each split x = hi + lo in
    TF32; each k-slice's 8 products of lo.hi, hi.lo and hi.hi summed in
    float32 (a wgmma's partial); warpgroup s takes the slices 2c + s, each
    pass a chain for each part parity c mod 2 summed in slice order from
    zero; a warpgroup's sum is hh + (lh + hl) with the two sets added in
    order, warpgroup 0's plus warpgroup 1's; then b_hh and the gates with
    the kernel's sigmoid 1/2 + tanh(x/2)/2. Which block owns a unit, the
    chunk and the ring of stages change no sum."""
    T, B, G = xp.shape
    H = G // 3
    kp = -(-H // GRID_PAD) * GRID_PAD
    par = 2
    kl = np.arange(kp)
    kk, j = kl // 8, kl % 8
    phys = (kk // 2) * 16 + (j % 4) * 4 + (kk % 2) * 2 + j // 4
    w_pad = np.zeros((kp, G), np.float32)
    w_pad[:H] = w
    slices = kp // 8
    w_log = w_pad[phys]
    w_hi = _tf32(w_log)
    w_lo = _tf32(w_log - w_hi)
    w_hi, w_lo = (a.reshape(slices, 8, G) for a in (w_hi, w_lo))
    # chain set c of warpgroup s holds the slices s + 2c, s + 2c + 2 par, ..., in order

    def chain(p, s, c):
        acc = p[s + 2 * c].copy()
        for kg in range(s + 2 * c + 2 * par, slices, 2 * par):
            acc += p[kg]        # float32, one rounding a slice
        return acc

    h = h0.astype(np.float32)
    ys = np.empty((T, B, H), np.float32)
    for t in range(T):
        h_pad = np.zeros((B, kp), np.float32)
        h_pad[:, :H] = h
        a = h_pad[:, phys]
        a_hi = _tf32(a)
        a_lo = _tf32(a - a_hi)
        a_hi, a_lo = (x.reshape(B, slices, 8).transpose(1, 0, 2) for x in (a_hi, a_lo))
        parts = (a_lo @ w_hi, a_hi @ w_lo, a_hi @ w_hi)   # (slices, B, G) each
        acc = None
        for wg in (0, 1):
            sums = [[chain(p, wg, c) for p in parts] for c in range(par)]
            sl, sm, sh = sums[0]
            for c in range(1, par):
                sl, sm, sh = sl + sums[c][0], sm + sums[c][1], sh + sums[c][2]
            part = sh + (sl + sm)
            acc = part if acc is None else acc + part
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
    cap as the forward and the streaming backward above it; a plan's shared
    bytes fit a block, its tiles of R rows cover B, every block owns at
    least four units and C·U covers H (the last block's ragged slice
    masked), its S slices of KE entries (a multiple of 4) cover the block's
    3U entries, short of four entries a lane, a thread holds each of the R·U (row, unit) pairs,
    its blocks keep to their thread bound, and it runs in one wave wherever
    some C, S and R allow."""
    numbers, cap = CAPS[card]
    for nb in (1, 3):
        routes = {}
        for H in range(MAX_HIDDEN + 1, MAX_WIDE_HIDDEN + 1):
            plan = cluster_bwd_plan(nb, B, H, numbers)
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
        assert all(r == "stream" for H, r in routes.items() if H > cap)


def test_cluster_bwd_plan_at_the_headline_shapes():
    """The backward plans the card's main paths start from: (1, 64, 256) on
    sixteen blocks of four rows, two lanes a quad, three blocks an SM, one
    wave; (1, 64, 512) on sixteen blocks at one block an SM, four rows
    (eight do not fit), in three waves; the x14/z64/h256 TimeGAN's B 16 on
    eight clusters of two rows, four lanes a quad (not sixteen clusters of
    one row: two clusters sharing an SM ran slower); H 545 on the
    streaming kernel; nothing resident, no cluster."""
    plan = cluster_bwd_plan(1, 64, 256, H100)
    assert (plan["C"], plan["R"], plan["S"], plan["KE"], plan["U"], plan["threads"],
            plan["resident"], plan["waves"]) == (16, 4, 2, 24, 16, 128, 21, 1)
    plan = cluster_bwd_plan(1, 64, 512, H100)
    assert (plan["C"], plan["R"], plan["resident"], plan["waves"]) == (16, 4, 7, 3)
    plan = cluster_bwd_plan(1, 16, 256, H100)
    assert (plan["C"], plan["R"], plan["S"], plan["clusters"], plan["waves"]) == (16, 2, 4, 8, 1)
    assert cluster_bwd_plan(1, 64, 545, H100) == {"route": "stream"}
    none = {**H100, "resident": {c: 0 for c in H100["resident"]}}
    assert cluster_bwd_plan(1, 64, 256, none) == {"route": "stream"}


def _fma(a, b, c):
    """fmaf: a b + c rounded once to float32 (from float64: within double
    rounding)."""
    return (a * b + c).astype(np.float32)


def _cluster_bwd_sum_order(xp, w, b, h0, ys, dy, plan):
    """K1 cluster backward's arithmetic in its order
    (csrc/gru_seq_cluster_bwd.cu), in numpy float32: hp = h_prev W_hhᵀ as
    one float32 product, b_hh added in the kernel; the coefficients from
    xp, hp and h_prev with the sigmoid 1/2 + tanh(x/2)/2; then the reverse
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
    h_prev = np.concatenate([h0[None], ys[:T - 1]]).astype(f32)
    hp = (h_prev.reshape(T * B, H) @ w).reshape(T, B, G).astype(f32)
    hr, hz, hn = (hp[..., k * H:(k + 1) * H] + b[0, k * H:(k + 1) * H] for k in range(3))
    r = _sigmoid_fwd(xp[..., :H] + hr)
    z = _sigmoid_fwd(xp[..., H:2 * H] + hz)
    n = np.tanh(xp[..., 2 * H:] + r * hn).astype(f32)
    omz = f32(1) - z
    e = omz * (f32(1) - n * n)
    coef = ((e * hn) * (r * (f32(1) - r)), (h_prev - n) * (z * omz), e * r, e, z)
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
        d = (dh + dy[t]).astype(f32)
        d_r, d_z, d_n = (d * coef[k][t] for k in range(3))
        st = d * coef[4][t]
        dxp[t] = np.concatenate([d_r, d_z, d * coef[3][t]], axis=-1)
        dhp[t] = np.concatenate([d_r, d_z, d_n], axis=-1)
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
