"""K1's wide forward on a thread-block cluster (``csrc/gru_seq_cluster.cu``)
on the CPU: the route, cluster and rows that ``cluster_plan`` picks at the
H100's numbers, and the kernel's summation order, emulated in numpy float32,
against the plain recurrence and the Pallas kernel in interpret mode. The
kernel itself runs on the card (tests/test_torch_card.py, chip_smoke.py)."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from test_torch_gru import _seq_inputs, _sigmoid_fwd
from test_torch_threads import one_thread_each  # noqa: F401

from eegsynth.nn.pallas_gru import gru_sequence as jax_gru_sequence
from eegsynth_torch.nn.gru_sequence import (
    CLUSTER_MAX_THREADS, CLUSTER_ROWS, MAX_HIDDEN, MAX_WIDE_HIDDEN, cluster_fits,
    cluster_plan, cluster_smem, gru_sequence_reference, resident_clusters)

# The H100 SXM's numbers (132 SMs, 232,448 shared bytes a block, 233,472 an
# SM, 1,024 reserved a block) with the clusters resident at once for each C
# at one block an SM that the H100 80GB HBM3 reports
# (cudaOccupancyMaxActiveClusters); and the same card without clusters of 16.
H100 = {"sms": 132, "smem": 232448, "smem_sm": 233472, "smem_reserved": 1024,
        "resident": {2: 66, 4: 30, 8: 15, 16: 7}}
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
    the streaming kernel above it; a cluster plan's shared bytes fit a
    block, its tiles of R rows cover B, every block owns a unit and C·U
    covers H (the last block's ragged slice masked), its depth S·KL covers
    H in float4s, short of a float4 a lane, its blocks keep to their thread bound, and it runs in one
    wave wherever some C and R allow."""
    numbers, cap = CAPS[card]
    for nb in (1, 3):
        routes = {}
        for H in range(MAX_HIDDEN + 1, MAX_WIDE_HIDDEN + 1):
            plan = cluster_plan(nb, B, H, numbers)
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
        assert all(r == "stream" for H, r in routes.items() if H > cap)


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
