"""The IIR kernel's launch plan and lane-group design on the CPU: ``iir_plan``
gives a legal launch for every tap count n >= 1 (the lanes and column routes
where their templates are built, the runtime route past them), dtype and
column count, and raises for no taps; its constants agree with
``csrc/iir_filter.cu``'s; the bfloat16 and float16 arithmetic of the kernel
(each operation in float32, rounded to the dtype) equals the plain version
bit for bit; a
numpy emulation of a lane group's step (lane 0 forms y and its local state
elements with its own y, lane g ≥ 1 forms z_{L−1+g} = (b·x + z from lane
g + 1) − a·y with y broadcast) equals the plain recurrence bit for bit at a
60 s trial's padded length for both of preprocessing's filters, so spreading
the state over lanes changes no rounding. The card runs the kernel
(tests/test_torch_card.py, chip_smoke.py)."""

import re
from pathlib import Path

import numpy as np
import pytest
import scipy.signal as sig
import torch

from iir_cases import stable_taps
from test_torch_threads import one_thread_each  # noqa: F401

from eegsynth_torch.data import filters as tfilters
from eegsynth_torch.ops import filtering as tfilt

SOURCE = Path(tfilt.__file__).resolve().parent.parent / "csrc" / "iir_filter.cu"


def _constant(name: str) -> int:
    return int(re.search(rf"constexpr int {name} = (\d+);", SOURCE.read_text()).group(1))


def _assert_legal_launch(n, dtype, M):
    plan = tfilt.iir_plan(M, n, dtype)
    lanes, local = plan["lanes"], plan["local"]
    order = n - 1
    # a power of two dividing 32
    assert lanes in (1, 2, 4, 8, 16, 32)
    if plan["route"] == "runtime":
        # past the templates, and in bfloat16 and float16: one thread a
        # column, the whole state in memory
        assert lanes == 1 and local == 0
        if dtype == torch.float64:
            assert n > tfilt.IIR_MAX_LANE_TAPS
        elif dtype == torch.float32:
            assert n > tfilt.IIR_MAX_COLUMN_TAPS
        size = torch.empty((), dtype=dtype).element_size()
        shared = tfilt.IIR_THREADS * order * size <= tfilt.IIR_SHARED_STATE_BYTES
        assert plan["state"] == ("shared" if shared else "global")
    else:
        # lane 0's elements and one a lane after it hold the whole state
        assert min(local, order) + lanes - 1 >= order
        assert plan["route"] == ("column" if lanes == 1 else "lanes")
        if lanes == 1:
            assert local == order and n <= tfilt.IIR_MAX_COLUMN_TAPS
        else:
            assert local == tfilt.IIR_LOCAL < order and dtype == torch.float64
            assert n <= tfilt.IIR_MAX_LANE_TAPS
    assert plan["threads"] == tfilt.IIR_THREADS == plan["columns_per_block"] * lanes
    assert plan["threads"] % 32 == 0 and plan["chunk"] == tfilt.IIR_CHUNK
    # every column in exactly one group of one block
    owners = {}
    for block in range(plan["blocks"]):
        for thread in range(plan["threads"]):
            c = (block * plan["threads"] + thread) // lanes
            if c < M:
                owners.setdefault(c, set()).add(block)
    assert sorted(owners) == list(range(M))
    assert all(len(blocks) == 1 for blocks in owners.values())
    assert (plan["blocks"] - 1) * plan["columns_per_block"] < M


@pytest.mark.parametrize("M", [1, 14, 300, 5000])
@pytest.mark.parametrize("dtype", [torch.float32, torch.float64])
@pytest.mark.parametrize("n", range(1, 10))
def test_iir_plan_gives_a_legal_launch(n, dtype, M):
    _assert_legal_launch(n, dtype, M)


@pytest.mark.parametrize("n", [0, 10, 17])
def test_iir_plan_raises_past_max_taps(n):
    """No taps raise; 10 and 17 taps, past the nine the kernel once took,
    are legal launches (the lanes route in float64)."""
    if n == 0:
        with pytest.raises(ValueError, match="taps"):
            tfilt.iir_plan(14, n, torch.float64)
    else:
        _assert_legal_launch(n, torch.float64, 14)
        assert tfilt.iir_plan(14, n, torch.float64)["route"] == "lanes"


# the widest lanes route in float64 and column route in float32 (17), the
# first runtime ones (18), orders a warp would hold on the lanes (34, 35),
# 41 taps, and orders whose state leaves shared memory (200, 1000)
@pytest.mark.parametrize("M", [14, 300])
@pytest.mark.parametrize("dtype", [torch.float64, torch.float32, torch.bfloat16,
                                   torch.float16])
@pytest.mark.parametrize("n", [10, 17, 18, 34, 35, 41, 200, 1000])
def test_iir_plan_routes_every_order(n, dtype, M):
    _assert_legal_launch(n, dtype, M)
    plan = tfilt.iir_plan(M, n, dtype)
    if dtype == torch.float64:
        want = "lanes" if n <= 17 else "runtime"
    elif dtype == torch.float32:
        want = "column" if n <= 17 else "runtime"
    else:
        want = "runtime"
    assert plan["route"] == want


def test_iir_plan_routes_float32_to_one_thread_a_column():
    for M in (1, 14, 300, 5000):
        assert tfilt.iir_plan(M, 9, torch.float32)["route"] == "column"
        assert tfilt.iir_plan(M, 9, torch.float64)["route"] == "lanes"
    # preprocessing's filters over 14 channels in float64: the band-pass on
    # 8 lanes a column, the notch (two state elements) on one
    assert tfilt.iir_plan(14, 9, torch.float64)["lanes"] == 8
    assert tfilt.iir_plan(14, 3, torch.float64)["route"] == "column"


def test_plan_constants_agree_with_the_kernel_source():
    assert _constant("kMaxLaneTaps") == tfilt.IIR_MAX_LANE_TAPS
    assert _constant("kMaxColumnTaps") == tfilt.IIR_MAX_COLUMN_TAPS
    assert _constant("kSharedStateBytes") == tfilt.IIR_SHARED_STATE_BYTES
    assert _constant("kThreads") == tfilt.IIR_THREADS
    assert _constant("kChunk") == tfilt.IIR_CHUNK
    assert _constant("kLocal") == tfilt.IIR_LOCAL
    # lanes_for, as iir_lanes, for every tap count and both local counts
    for local in (1, 2):
        want = []
        for n in range(1, 35):
            order = n - 1
            need = order - min(local, order) + 1
            g = 1
            while g < need:
                g *= 2
            want.append(g)
        assert [tfilt.iir_lanes(n, local) for n in range(1, 35)] == want
    assert [tfilt.iir_lanes(n) for n in range(1, 10)] == [1, 1, 1, 2, 4, 4, 8, 8, 8]
    # the lanes route's last n takes 16 lanes; a warp would hold 34 taps
    assert tfilt.iir_lanes(tfilt.IIR_MAX_LANE_TAPS) == 16
    assert tfilt.iir_lanes(34) == 32 and tfilt.iir_lanes(35) == 64


def test_iir_variants_patches_find_their_targets():
    from eegsynth_torch.tools import iir_variants
    srcs = iir_variants._sources(None)
    assert "constexpr int kLocal = 1;" in srcs["local 1"]
    assert all("constexpr bool kLanesRoute = true;" in src for src in srcs.values())
    assert "constexpr bool kLanesRoute = sizeof(T) == 8;" in SOURCE.read_text()
    assert {lib for lib, _ in iir_variants.VARIANTS.values()} <= set(srcs)


def test_iir_chain_probe_needs_a_card():
    with pytest.raises(ValueError, match="no kernel"):
        tfilt.iir_chain_probe(10, torch.float64, device="cpu")


def _lane_group(b, a, x, zi, lanes, local):
    """A lane group's steps in numpy, every product and sum rounded on its
    own in x's dtype, in iir_filter.cu's order (Lane::step): arrays (lanes,
    M) hold each lane's value; the shuffles are shifts along the lanes."""
    T, M = x.shape
    order = len(b) - 1
    lc = min(local, order)
    zl = [zi[i].copy() for i in range(lc)]
    e = lc - 1 + np.arange(lanes)                  # lane g's element
    bo = np.array([b[k + 1] if 0 <= k < order else 0 for k in e], x.dtype)[:, None]
    ao = np.array([a[k + 1] if 0 <= k < order else 0 for k in e], x.dtype)[:, None]
    zo = np.zeros((lanes, M), x.dtype)
    for g in range(1, lanes):
        if e[g] < order:
            zo[g] = zi[e[g]]
    tail = np.array([lc >= order if g == 0 else e[g] + 1 >= order for g in range(lanes)])
    y = np.empty_like(x)
    for t in range(T):
        xt = x[t]
        # __shfl_down_sync: lane g reads lane g + 1's element of the step
        # before (the last lane's read is ignored: it is a tail)
        zn = np.where(tail[:, None], 0, np.concatenate([zo[1:], zo[-1:]])).astype(x.dtype)
        yt = b[0] * xt + (zl[0] if lc else zn[0])
        for i in range(lc):
            zl[i] = (b[i + 1] * xt + (zl[i + 1] if i + 1 < lc else zn[0])) - a[i + 1] * yt
        zo = (bo * xt + zn) - ao * yt                  # y broadcast from lane 0
        y[t] = yt
    return y


@pytest.mark.parametrize("local", [1, 2])
@pytest.mark.parametrize("dtype", [np.float64, np.float32])
@pytest.mark.parametrize("kind", ["bandpass", "notch"])
def test_lane_group_emulation_equals_plain_bit_for_bit(kind, dtype, local):
    """At (7734, 14), filtfilt's seed as zi: the lane group (8 lanes for the
    band-pass, lane 0 holding one or two elements; the notch on 2 lanes or
    on one) equals lfilter_reference and scipy's lfilter bit for bit."""
    (b_bp, a_bp), (b_n, a_n) = tfilters.design_filters(128.0)
    b, a = (b_bp, a_bp) if kind == "bandpass" else (b_n, a_n)
    x = np.random.default_rng(7).standard_normal((7734, 14)).cumsum(axis=0).astype(dtype)
    zi = (tfilt.lfilter_zi(b, a)[:, None] * x[0]).astype(dtype)
    tdtype = torch.float64 if dtype == np.float64 else torch.float32
    bt, at = tfilt._taps(b, a, tdtype)
    lanes = tfilt.iir_lanes(len(b), local)
    assert lanes == ({1: 8, 2: 8} if kind == "bandpass" else {1: 2, 2: 1})[local]
    ours = _lane_group(bt.numpy(), at.numpy(), x, zi, lanes, local)
    ref = tfilt.lfilter_reference(bt, at, torch.from_numpy(x), torch.from_numpy(zi)).numpy()
    np.testing.assert_array_equal(ours, ref)
    scipy_ref, _ = sig.lfilter(b.astype(dtype), a.astype(dtype), x, axis=0, zi=zi)
    np.testing.assert_array_equal(ours, scipy_ref)


def test_a_chunked_scan_over_time_breaks_the_kernels_tolerances():
    """Why the kernel stays serial in time: the chunked scan of
    tools/iir_scan_error.py (chunks from a zero state, states carried by the
    companion matrix's power) drifts from the serial recurrence past the
    tolerances the kernel is held to (1e-12 float64, 1e-5 float32) for the
    band-pass, whose poles lie near the unit circle."""
    from eegsynth_torch.tools import iir_scan_error
    rows = iir_scan_error.scan_errors(T=1000, chunks=(64,))
    rel = {(r["filter"], r["dtype"]): r["rel"] for r in rows}
    assert rel[("band-pass", "float64")] > 1e-12
    assert rel[("band-pass", "float32")] > 1e-5
    assert max(r["pole"] for r in rows) > 0.98


def _round_to(v, dtype):
    """float32 values rounded to bfloat16 (to nearest even, on the bits) or
    float16, as float32: what __float2bfloat16_rn / __float2half_rn give."""
    v = np.ascontiguousarray(v, np.float32)
    if dtype == torch.float16:
        return v.astype(np.float16).astype(np.float32)
    bits = v.view(np.uint32)
    bits = (bits + np.uint32(0x7FFF) + ((bits >> 16) & np.uint32(1))) & np.uint32(0xFFFF0000)
    return bits.view(np.float32)


def _half_steps(b, a, x, zi, dtype):
    """The kernel's step in bfloat16 or float16 (csrc/iir_filter.cu mul_rn,
    add_rn, sub_rn on those types), in numpy: each product and sum taken in
    float32 and rounded to the dtype, y = b0·x + z0, then z_i = (b_{i+1}·x +
    z_{i+1}) − a_{i+1}·y. Values travel as float32 holding the dtype's."""
    def op(f, p, q):
        return _round_to(f(p, q), dtype)
    order = len(b) - 1
    z = [zi[i] for i in range(order)]
    y = np.empty_like(x)
    for t in range(x.shape[0]):
        xt = x[t]
        yt = op(np.add, op(np.multiply, b[0], xt), z[0] if order else np.float32(0))
        for i in range(order):
            nxt = z[i + 1] if i + 1 < order else np.float32(0)
            z[i] = op(np.subtract, op(np.add, op(np.multiply, b[i + 1], xt), nxt),
                      op(np.multiply, a[i + 1], yt))
        y[t] = yt
    return y


@pytest.mark.parametrize("n", [3, 5, 20])
@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float16])
def test_half_kernel_arithmetic_equals_plain_bit_for_bit(dtype, n):
    """The kernel's bfloat16 / float16 arithmetic (each operation in float32,
    rounded to the dtype) equals the plain version in that dtype bit for
    bit, on a filter stable in those dtypes (the runtime route's arithmetic,
    which those dtypes take at every n) over 2000 steps: PyTorch rounds each
    of the plain version's operations the same way."""
    b, a = stable_taps(n, seed=n)
    bt, at = tfilt._taps(b, a, dtype)
    x = torch.from_numpy(np.random.default_rng(n).standard_normal((2000, 6))).to(dtype)
    zi = torch.from_numpy(np.random.default_rng(n + 1).standard_normal((n - 1, 6))).to(dtype)
    ref = tfilt.lfilter_reference(bt, at, x, zi)
    assert ref.dtype == dtype and torch.isfinite(ref).all()
    ours = _half_steps(bt.float().numpy(), at.float().numpy(), x.float().numpy(),
                       zi.float().numpy(), dtype)
    np.testing.assert_array_equal(ours, ref.float().numpy())
