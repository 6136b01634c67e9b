"""eegsynth_torch's zero-phase filtering and filter design against the JAX
package and scipy on the same numpy inputs: ``lfilter_zi``, the plain
``lfilter`` (the IIR kernel's CPU path and oracle) and ``filtfilt`` for the
band-pass and the notch in float64 and float32, the too-short input, the
designs, the mains detection and the fs estimate. The card runs the IIR
kernel (tests/test_torch_card.py, chip_smoke.py)."""

import jax.numpy as jnp
import numpy as np
import pytest
import scipy.signal as sig
import torch

from test_torch_threads import one_thread_each  # noqa: F401

from eegsynth.data import filters as jfilters
from eegsynth.ops import filtering as jfilt
from eegsynth_torch.data import filters as tfilters
from eegsynth_torch.ops import filtering as tfilt

FS = 128.0
# float64: relative to the largest output, as tests/test_ops_filtering.py
JAX_RTOL, SCIPY_RTOL = 1e-9, 1e-6
# float32 against JAX's float32 scan, relative to the largest output (see
# test_filtfilt_float32_matches_jax_float32)
F32_BP_RTOL, F32_NOTCH_RTOL = 3e-3, 1e-5


def _design(kind, notch_hz=60.0):
    (b_bp, a_bp), (b_n, a_n) = tfilters.design_filters(FS, 1.0, 45.0, notch_hz, 30.0)
    return (b_bp, a_bp) if kind == "bandpass" else (b_n, a_n)


def _walk(shape, seed=0):
    return np.cumsum(np.random.default_rng(seed).standard_normal(shape), axis=0)


@pytest.mark.parametrize("kind", ["bandpass", "notch"])
def test_lfilter_zi_matches_jax_and_scipy(kind):
    b, a = _design(kind)
    ours = tfilt.lfilter_zi(b, a)
    np.testing.assert_allclose(ours, jfilt.lfilter_zi(b, a), rtol=1e-12)
    np.testing.assert_allclose(ours, sig.lfilter_zi(b, a), rtol=1e-9)


@pytest.mark.parametrize("dtype", [np.float64, np.float32])
@pytest.mark.parametrize("kind", ["bandpass", "notch"])
def test_lfilter_plain_equals_scipy_bit_for_bit(kind, dtype):
    """The plain recurrence rounds every product and sum on its own, in the
    order of scipy's C loop: the outputs are equal, in both dtypes."""
    b, a = _design(kind)
    x = _walk((1500, 5), seed=1).astype(dtype)
    zi = (sig.lfilter_zi(b, a)[:, None] * x[0]).astype(dtype)
    ours = tfilt.lfilter(b, a, torch.from_numpy(x), zi=torch.from_numpy(zi)).numpy()
    ref, _ = sig.lfilter(b.astype(dtype), a.astype(dtype), x, axis=0, zi=zi)
    assert ours.dtype == dtype
    np.testing.assert_array_equal(ours, ref)


@pytest.mark.parametrize("kind", ["bandpass", "notch"])
def test_lfilter_and_filtfilt_match_jax_and_scipy(kind):
    b, a = _design(kind)
    x = _walk((2000, 14))
    zi = tfilt.lfilter_zi(b, a)[:, None] * x[0]
    ours = tfilt.lfilter(b, a, torch.from_numpy(x), zi=torch.from_numpy(zi)).numpy()
    ref = np.asarray(jfilt.lfilter(b, a, jnp.asarray(x), zi=jnp.asarray(zi)))
    np.testing.assert_allclose(ours, ref, atol=JAX_RTOL * np.abs(ref).max(), rtol=0)

    ours = tfilt.filtfilt(b, a, torch.from_numpy(x)).numpy()
    ref = np.asarray(jfilt.filtfilt(b, a, jnp.asarray(x), axis=0))
    np.testing.assert_allclose(ours, ref, atol=JAX_RTOL * np.abs(ref).max(), rtol=0)
    ref = sig.filtfilt(b, a, x, axis=0)
    np.testing.assert_allclose(ours, ref, atol=SCIPY_RTOL * np.abs(ref).max(), rtol=0)


@pytest.mark.parametrize("kind", ["bandpass", "notch"])
def test_filtfilt_float32_matches_jax_float32(kind):
    """Float32 rounding is amplified by the band-pass's poles near the unit
    circle (1 Hz at fs 128): each package's float32 output lies ~1e-3 of
    its largest value from the float64 result (the notch's ~1e-6), in
    another direction. So the two are held to each other within F32_BP_RTOL
    and the port's error against float64 to at most twice JAX's."""
    b, a = _design(kind)
    x = np.random.default_rng(2).standard_normal((768, 14)).astype(np.float32)
    ours = tfilt.filtfilt(b, a, torch.from_numpy(x)).numpy()
    ref = np.asarray(jfilt.filtfilt(b, a, jnp.asarray(x), axis=0))
    assert ours.dtype == ref.dtype == np.float32
    exact = sig.filtfilt(b, a, x.astype(np.float64), axis=0)
    scale = np.abs(exact).max()
    ours_err, ref_err = np.abs(ours - exact).max(), np.abs(ref - exact).max()
    assert ours_err <= 2 * ref_err, (ours_err / scale, ref_err / scale)
    tol = F32_BP_RTOL if kind == "bandpass" else F32_NOTCH_RTOL
    np.testing.assert_allclose(ours, ref, atol=tol * scale, rtol=0)


def test_filtfilt_along_another_axis_and_batch_dims():
    b, a = _design("notch")
    x = np.random.default_rng(3).standard_normal((3, 300, 40))   # time on axis 1
    ours = tfilt.filtfilt(b, a, torch.from_numpy(x), axis=1).numpy()
    np.testing.assert_allclose(ours, sig.filtfilt(b, a, x, axis=1),
                               atol=SCIPY_RTOL * np.abs(x).max(), rtol=0)


@pytest.mark.parametrize("kind", ["bandpass", "notch"])
def test_too_short_input_raises_in_both(kind):
    b, a = _design(kind)
    padlen = 3 * max(len(a), len(b))
    x = _walk((padlen, 2))
    with pytest.raises(ValueError, match="padlen"):
        tfilt.filtfilt(b, a, torch.from_numpy(x))
    with pytest.raises(ValueError, match="padlen"):
        jfilt.filtfilt(b, a, jnp.asarray(x))
    tfilt.filtfilt(b, a, torch.from_numpy(_walk((padlen + 1, 2))))


def test_lfilter_on_an_unknown_device_raises():
    b, a = _design("notch")
    with pytest.raises(ValueError, match="no kernel"):
        tfilt.lfilter(b, a, torch.zeros(8, 2, device="meta"))


@pytest.mark.parametrize("fs,low,high,notch", [(128.0, 1.0, 45.0, 60.0),
                                               (128.0, 1.0, 45.0, 50.0),
                                               (256.0, 0.5, 70.0, 60.0),
                                               (100.0, 1.0, 60.0, 50.0)])
def test_design_filters_equal_jax(fs, low, high, notch):
    ours = tfilters.design_filters(fs, low, high, notch, 30.0)
    ref = jfilters.design_filters(fs, low, high, notch, 30.0)
    for o, r in zip(ours, ref):
        for oc, rc in zip(o, r):
            np.testing.assert_array_equal(oc, rc)


def test_detect_line_freq_equals_jax():
    t = np.arange(int(FS * 25)) / FS
    x50 = np.sin(2 * np.pi * 50 * t) + 0.1 * np.random.RandomState(0).randn(len(t))
    x60 = np.sin(2 * np.pi * 60 * t) + 0.1 * np.random.RandomState(1).randn(len(t))
    for x, want in ((x50, 50.0), (x60, 60.0), (x50[: int(FS * 2)], 60.0)):
        assert tfilters.detect_line_freq(x, FS) == want
        assert tfilters.detect_line_freq(torch.from_numpy(x), FS) == want
        assert jfilters.detect_line_freq(x, FS) == want


def test_estimate_fs_equals_jax():
    jitter = 1e-5 * np.random.RandomState(0).randn(1000)
    for t in (np.arange(1000) / 128.0 + jitter, np.arange(1000) * 0.5 + jitter,
              np.arange(1000) * (1000.0 / 256.0), np.array([1.0, 2.0]),
              np.full(20, np.nan)):
        assert tfilters.estimate_fs(t) == jfilters.estimate_fs(t)
    assert abs(tfilters.estimate_fs(np.arange(1000) / 128.0 + jitter) - 128.0) < 0.5


@pytest.mark.parametrize("notch_hz", [None, 50.0])
def test_notch_then_bandpass_matches_jax(notch_hz):
    t = np.arange(int(FS * 25)) / FS
    x = _walk((len(t), 4), seed=4) + np.sin(2 * np.pi * 50 * t)[:, None]
    ours = tfilters.notch_then_bandpass(x, FS, notch_hz=notch_hz).numpy()
    ref = np.asarray(jfilters.notch_then_bandpass(x, FS, notch_hz=notch_hz))
    np.testing.assert_allclose(ours, ref, atol=JAX_RTOL * np.abs(ref).max(), rtol=0)
