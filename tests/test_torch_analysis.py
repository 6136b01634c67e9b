"""eegsynth_torch's fatigue analysis against the JAX package's on the same
numpy inputs: band powers, the fatigue and global indices, the workload ratio
with its fallback, the Welch-TBR matrix, the channel orders, the Welch and
paired t-tests with their logged degenerate channels, the display scales,
four_group_report's statistics and v4 CSV, the batched rFFT TBR against the
JAX package's per-epoch loop, the participant pipeline on a CSV tree and the
synthetic side with its count-matched draws. The spectra run on the CPU here
(float64 either way); tests/test_torch_card.py holds the card against the
CPU."""

import csv
import logging
import warnings

import numpy as np
import pytest

from test_torch_threads import one_thread_each  # noqa: F401

from eegsynth.analysis import bandpower as jbp
from eegsynth.analysis import fatigue as jfat
from eegsynth.analysis import participant_fatigue as jpf
from eegsynth.analysis import ttests as jtt
from eegsynth_torch.analysis import bandpower as tbp
from eegsynth_torch.analysis import fatigue as tfat
from eegsynth_torch.analysis import participant_fatigue as tpf
from eegsynth_torch.analysis import ttests as ttt
from eegsynth_torch.tools.raw_tree import write_raw_tree

RTOL = 1e-10       # float64 spectra: FFTs and sums in another order
CPU = "cpu"


def _close(ours, ref, rtol=RTOL):
    np.testing.assert_allclose(np.asarray(ours, dtype=np.float64),
                               np.asarray(ref, dtype=np.float64), rtol=rtol, atol=0)


def _epochs(n=6, T=256, C=14, seed=0):
    return np.random.default_rng(seed).standard_normal((n, T, C)).cumsum(axis=1)


@pytest.mark.parametrize("nperseg,noverlap", [(None, None), (64, 16)])
def test_band_powers_and_indices_match_jax(nperseg, noverlap):
    X = _epochs().astype(np.float32)
    ch = ["AF3", "F7", "F3", "FC5", "T7", "P7", "O1", "O2", "P8", "T8", "FC6",
          "F4", "F8", "AF4"]
    f, m, s = tbp.compute_psd_per_channel(X, 128.0, nperseg, noverlap, device=CPU)
    jf, jm, js = jbp.compute_psd_per_channel(X, 128.0, nperseg, noverlap)
    np.testing.assert_array_equal(f, jf)
    _close(m, jm)
    _close(s, js)
    bp, jbpw = tbp.band_powers(f, m), jbp.band_powers(jf, jm)
    assert list(bp) == list(jbpw) == list(tbp.BANDS)
    for k in bp:
        _close(bp[k], jbpw[k])
    for k, v in tfat.fatigue_indices(bp).items():
        _close(v, jfat.fatigue_indices(jbpw)[k])
    assert tfat.global_indices(bp).keys() == jfat.global_indices(jbpw).keys()
    for k, v in tfat.global_indices(bp).items():
        _close(v, jfat.global_indices(jbpw)[k])
    for names in (ch, [f"X{i}" for i in range(14)], ch[:7] + [f"X{i}" for i in range(7)]):
        _close(tfat.workload_ratio(bp, names), jfat.workload_ratio(jbpw, names))
    # an empty band integrates to zeros, in both
    _close(tbp.bandpower_from_psd(f, m, 200.0, 300.0),
           jbp.bandpower_from_psd(jf, jm, 200.0, 300.0))


def test_workload_ratio_falls_back_to_the_global_mean():
    bp = {"Theta": np.array([2.0, 4.0]), "Alpha": np.array([1.0, 3.0]),
          "Beta": np.array([1.0, 1.0])}
    assert tfat.workload_ratio(bp, ["AF3", "P7"]) == pytest.approx(2.0 / 3.0)
    assert tfat.workload_ratio(bp, ["X1", "X2"]) == pytest.approx(3.0 / 2.0)
    assert tfat.workload_ratio(bp, ["X1", "X2"]) == jfat.workload_ratio(bp, ["X1", "X2"])


@pytest.mark.parametrize("shape", [(5, 768, 14), (3, 200, 2)])
def test_tbr_matrix_matches_jax(shape):
    X = _epochs(*shape, seed=1).astype(np.float32)
    ours = tfat.tbr_matrix(X, 128.0, device=CPU)
    assert ours.shape == shape[::2] and ours.dtype == np.float64
    _close(ours, jfat.tbr_matrix(X, 128.0))


@pytest.mark.parametrize("names", [["O1", "AF3", "T7", "weird"],
                                   ["eeg.af3", "F8", "P7", "FC5", "O2", "T8", "AF4"],
                                   list(reversed(ttt.ORDERED_CH))])
def test_channel_orders_equal_jax(names):
    assert tbp.order_channels_grouped(names) == jbp.order_channels_grouped(names)
    arr = np.arange(len(names) * 2).reshape(len(names), 2)
    for a in (arr, arr[:, 0]):
        o_names, o_arr = ttt.reorder_by_region(names, a)
        j_names, j_arr = jtt.reorder_by_region(names, a)
        assert o_names == j_names
        np.testing.assert_array_equal(o_arr, j_arr)


def test_sig_stars_equal_jax():
    for p in (1e-4, 4e-3, 0.04, 0.5, np.nan):
        assert ttt.sig_stars(p) == jtt.sig_stars(p)


def _degenerate_pair(seed):
    rng = np.random.default_rng(seed)
    a = rng.standard_normal((6, 4))
    b = rng.standard_normal((6, 4)) + 2.0
    a[:, 0] = np.nan                     # all-NaN channel
    a[1:, 2] = np.nan                    # one valid sample
    b[:, 3] = 1.0
    a[:, 3] = 1.0                        # constant: zero variance
    return a, b


@pytest.mark.parametrize("test", ["welch", "paired"])
def test_ttests_match_jax_and_log_degenerate_channels(test, caplog):
    a, b = _degenerate_pair(3)
    ours_fn = (lambda x, y: ttt.welch_ttest_per_channel(x, y, 4)) if test == "welch" \
        else ttt.paired_ttest_real_vs_fake
    ref_fn = (lambda x, y: jtt.welch_ttest_per_channel(x, y, 4)) if test == "welch" \
        else jtt.paired_ttest_real_vs_fake
    with caplog.at_level(logging.WARNING, logger="eegsynth_torch.analysis.ttests"):
        with warnings.catch_warnings():
            warnings.simplefilter("ignore")
            t, p = ours_fn(a, b)
            jt, jp = ref_fn(a, b)
    np.testing.assert_allclose(t, jt, rtol=1e-12)
    np.testing.assert_allclose(p, jp, rtol=1e-12)
    assert np.isnan(p[0]) and np.isfinite(p[1])
    logged = [r.getMessage() for r in caplog.records
              if r.name == "eegsynth_torch.analysis.ttests"]
    for ci in np.flatnonzero(~np.isfinite(p)):
        assert any(f"channel {ci}" in m for m in logged), (ci, logged)
    if test == "welch":
        assert ttt.welch_ttest_per_channel(None, b, 4)[0].shape == (4,)


def test_welch_ttest_raise_path_logs_and_skips(caplog, monkeypatch):
    real = ttt.ttest_ind

    def raising(x, y, **kw):
        if np.isnan(x).all():
            raise ValueError("zero-size array")
        return real(x, y, **kw)
    monkeypatch.setattr(ttt, "ttest_ind", raising)
    a, b = _degenerate_pair(4)
    with caplog.at_level(logging.WARNING, logger="eegsynth_torch.analysis.ttests"):
        with warnings.catch_warnings():
            warnings.simplefilter("ignore")
            t, p = ttt.welch_ttest_per_channel(a, b, 4)
    assert np.isnan(t[0]) and np.isfinite(t[1])
    assert any("skipping channel 0" in r.getMessage() for r in caplog.records)


def _groups(seed=5, scale_syn=1.0, zero_rn=False):
    rng = np.random.default_rng(seed)
    g = {code: rng.gamma(2.0, 1.0 + i, (12 + i, 14)) for i, code in enumerate(ttt.GROUPS)}
    g["SN"] *= scale_syn
    g["SW"] *= scale_syn
    if zero_rn:
        g["RN"] = np.zeros_like(g["RN"])
    return g


@pytest.mark.parametrize("mode", ["none", "p95", "median"])
@pytest.mark.parametrize("variant", [{}, {"scale_syn": 40.0}, {"scale_syn": 1e4},
                                     {"zero_rn": True}])
def test_display_scales_equal_jax(mode, variant):
    g = _groups(**variant)
    assert ttt.display_scales(g, mode) == jtt.display_scales(g, mode)
    missing = {**g, "SW": None}
    assert ttt.display_scales(missing, mode) == jtt.display_scales(missing, mode)


def _read(path):
    with open(path, newline="") as fh:
        return list(csv.reader(fh))


def _hold_csv(ours, ref, rtol=1e-9, atol=1e-12):
    """Cell by cell: strings equal, numbers within rtol (atol near 0)."""
    assert len(ours) == len(ref)
    for ro, rr in zip(ours, ref):
        assert len(ro) == len(rr)
        for co, cr in zip(ro, rr):
            try:
                fo, fr = float(co), float(cr)
            except ValueError:
                assert co == cr
                continue
            if np.isnan(fr):
                assert np.isnan(fo), (co, cr)
            else:
                assert abs(fo - fr) <= atol + rtol * abs(fr), (co, cr)


@pytest.mark.parametrize("scaling", ["none", "p95", "median"])
def test_four_group_report_matches_jax(scaling, tmp_path, monkeypatch):
    import matplotlib.pyplot as plt
    monkeypatch.setattr(plt, "savefig", lambda *a, **k: None)   # JAX's figure
    g = _groups(scale_syn=40.0 if scaling == "p95" else 1.0)
    g["RW"] = None if scaling == "median" else g["RW"]
    names = list(reversed(ttt.ORDERED_CH))
    with warnings.catch_warnings():
        warnings.simplefilter("ignore")
        ours = ttt.four_group_report(g, names, 3, tmp_path / "ours.png",
                                     scaling=scaling,
                                     export_csv=tmp_path / "ours.csv")
        ref = jtt.four_group_report(g, names, 3, tmp_path / "fig.png", scaling=scaling,
                                    export_csv=tmp_path / "ref.csv")
    assert ours.keys() == ref.keys()
    assert ours["ch_names"] == ref["ch_names"] and ours["scales"] == ref["scales"]
    for k in ("t_R", "p_R", "t_S", "p_S"):
        np.testing.assert_allclose(ours[k], ref[k], rtol=1e-12)
    for code in ttt.GROUPS:
        np.testing.assert_allclose(ours["means"][code], ref["means"][code], rtol=1e-12)
    _hold_csv(_read(tmp_path / "ours.csv"), _read(tmp_path / "ref.csv"))
    assert _read(tmp_path / "ours.csv")[1][0] == "AF3"
    assert (tmp_path / "ours.png").read_bytes()[:8] == b"\x89PNG\r\n\x1a\n"


@pytest.mark.parametrize("shape", [(9, 768, 14), (4, 300, 3), (2, 3, 5)])
def test_compute_fatigue_tbr_batched_matches_jax_per_epoch(shape):
    X = _epochs(*shape, seed=6)
    ours = tpf.compute_fatigue_tbr(X, 128.0, device=CPU)
    ref = np.stack([jpf.compute_fatigue_tbr(ep, 128.0) for ep in X])
    assert ours.shape == shape[::2]
    _close(ours, ref)
    _close(tpf.compute_fatigue_tbr(X[0], 100.0, device=CPU),
           jpf.compute_fatigue_tbr(X[0], 100.0))


def test_remap_and_subsample_equal_jax():
    names = ["eeg.af3", "F8 (uV)", "p7_uv", "weird"]
    vals = np.array([1.0, 2.0, 3.0, 4.0])
    np.testing.assert_array_equal(tpf.remap_to_14_channels(vals, names),
                                  jpf.remap_to_14_channels(vals, names))
    M = np.random.default_rng(7).standard_normal((10, 3))
    M[4] = np.nan
    for k in (4, 50, 0):
        np.testing.assert_array_equal(
            tpf._subsample_to_count(M, k, np.random.RandomState(0)),
            jpf._subsample_to_count(M, k, np.random.RandomState(0)))


@pytest.fixture(scope="module")
def csv_tree(tmp_path_factory):
    root = tmp_path_factory.mktemp("raw")
    write_raw_tree(root, participants=3, postures=(1, 2), seconds=8.0, seed=3)
    return root


def test_collect_and_aggregate_real_match_jax(csv_tree):
    ours = tpf.collect_real(csv_tree, device=CPU)
    ref = jpf.collect_real(csv_tree)
    assert ours.keys() == ref.keys()
    for pid in ref:
        for p in range(1, 10):
            for cond in ("no_exo", "with_exo"):
                assert len(ours[pid][p][cond]) == len(ref[pid][p][cond])
                for a, b in zip(ours[pid][p][cond], ref[pid][p][cond]):
                    _close(a, b)
    # the 10-channel trial leaves 4 channels NaN; the short trial counts
    assert len(ours["protocol_outputs_1"][1]["no_exo"]) == 2
    assert len(ours["protocol_outputs_1"][2]["no_exo"]) == 2
    got, want = tpf.aggregate_real(ours), jpf.aggregate_real(ref)
    for o, r in zip(got[:3], want[:3]):
        for p in range(1, 10):
            for a, b in (zip(o[p].values(), r[p].values()) if isinstance(o[p], dict)
                         else [(o[p], r[p])]):
                _close(a, b)
    assert got[3] == want[3] and got[3][1]["paired"] == 3


def _synth_runs(root, real_dir, n=20, T=256, seed=8):
    rng = np.random.default_rng(seed)
    for p in (1, 2):
        for cond in ("no_exo", "with_exo"):
            run = root / f"posture{p}_{cond}"
            run.mkdir(parents=True)
            np.savez(run / "synthetic.npz", X=rng.uniform(0, 1, (n, T, 14))
                     .astype(np.float32), fs=np.float32(128.0))
            np.savez(real_dir / f"posture{p}_{cond}.npz",
                     X=np.zeros((1, T, 14), np.float32), fs=np.float32(128.0),
                     ch_names=np.array([f"eeg.{c.lower()}" for c in
                                        reversed(ttt.ORDERED_CH)], dtype=object),
                     scale_min=rng.normal(0, 5, 14).astype(np.float32),
                     scale_range=rng.uniform(1, 10, 14).astype(np.float32))


@pytest.mark.parametrize("inverse_scale", [False, True])
def test_synth_tbr_epochs_matches_jax(inverse_scale, tmp_path):
    real = tmp_path / "real"
    real.mkdir()
    _synth_runs(tmp_path / "runs", real)
    fp = tmp_path / "runs" / "posture1_no_exo" / "synthetic.npz"
    for real_npz in (None, real / "posture1_no_exo.npz"):
        ours = tpf.synth_tbr_epochs(fp, real_npz, inverse_scale, device=CPU)
        ref = jpf.synth_tbr_epochs(fp, real_npz, inverse_scale)
        assert ours.shape == ref.shape == (20, 14)
        _close(ours, ref)


def test_aggregate_fake_draws_the_jax_packages_rows(tmp_path, csv_tree):
    real = tmp_path / "real"
    real.mkdir()
    _synth_runs(tmp_path / "runs", real)
    counts = jpf.aggregate_real(jpf.collect_real(csv_tree))[3]
    for real_counts in (None, counts):
        got = tpf.aggregate_fake(tmp_path / "runs", real, True, real_counts, device=CPU)
        want = jpf.aggregate_fake(tmp_path / "runs", real, True, real_counts)
        for o, r in zip(got, want):
            for p in range(1, 10):
                for a, b in (zip(o[p].values(), r[p].values()) if isinstance(o[p], dict)
                             else [(o[p], r[p])]):
                    _close(a, b)
        assert np.isfinite(got[2][1]).all() and np.isnan(got[2][3]).all()
