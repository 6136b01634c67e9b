"""The port's figure families (``eegsynth_torch/viz``) against the JAX
package's ``eegsynth/viz``: the numpy helpers called directly on the same
inputs (equal, or within 1e-12 in float64), the colormaps against
matplotlib's, the spectrogram and resampling against scipy, and the file
names each figure function writes against those the JAX function saves (its
``savefig`` recorded instead of drawn, scikit-learn's t-SNE stubbed). The
JAX figure functions' drawing and t-SNE are not run: they cost minutes in
``tests/test_viz.py``."""

from pathlib import Path

import matplotlib
import numpy as np
import pytest
import torch
from scipy.signal import resample as sp_resample
from scipy.signal import spectrogram as sp_spectrogram

from test_torch_threads import one_thread_each  # noqa: F401

from eegsynth.viz import cluster as jcluster
from eegsynth.viz import prep_stages as jprep
from eegsynth.viz import traces as jtraces
from eegsynth_torch.ops.spectral import resample, spectrogram
from eegsynth_torch.viz import cluster as tcluster
from eegsynth_torch.viz import prep_stages as tprep
from eegsynth_torch.viz import traces as ttraces
from eegsynth_torch.viz.colors import get_cmap


class _Recorder:
    """Stands in for matplotlib's savefig and scikit-learn's TSNE."""

    def __init__(self):
        self.names = []

    def savefig(self, fig, path, *a, **k):
        self.names.append(Path(path).name)


class _FakeTSNE:
    def __init__(self, *a, **k):
        pass

    def fit_transform(self, X):
        return np.asarray(X)[:, :2] * 1.0


@pytest.fixture
def recorder(monkeypatch):
    """The JAX figure functions write no file: their savefig (the
    figure's, and pyplot's, which would also draw the canvas) records the
    name, their tight_layout does nothing (it would measure every text),
    their t-SNE returns the input's first two columns."""
    import matplotlib.figure
    import matplotlib.pyplot as plt
    import sklearn.manifold
    rec = _Recorder()
    monkeypatch.setattr(matplotlib.figure.Figure, "savefig",
                        lambda self, path, *a, **k: rec.savefig(self, path))
    monkeypatch.setattr(plt, "savefig", lambda path, *a, **k: rec.savefig(None, path))
    monkeypatch.setattr(matplotlib.figure.Figure, "tight_layout", lambda self, *a, **k: None)
    monkeypatch.setattr(sklearn.manifold, "TSNE", _FakeTSNE)
    yield rec
    plt.close("all")


def _pairs(rng, shapes):
    return {key: (rng.normal(size=(n_r, 16, 3)).astype(np.float32),
                  rng.normal(size=(n_f, 16, 3)).astype(np.float32))
            for key, (n_r, n_f) in shapes.items()}


# ----------------------------------------------------------------------
# numpy helpers
# ----------------------------------------------------------------------

@pytest.mark.parametrize("lo,hi", [(0.005, 0.995), (0.05, 0.95), (0.0, 1.0)])
def test_winsorize_matches_jax(lo, hi):
    X = np.random.default_rng(0).normal(size=(203, 9)) ** 3
    want = jcluster.winsorize(X, lo, hi)
    np.testing.assert_allclose(tcluster.winsorize(X, lo, hi), want, rtol=0, atol=1e-12)
    got_t = tcluster.winsorize(torch.as_tensor(X), lo, hi)
    assert isinstance(got_t, torch.Tensor)
    np.testing.assert_allclose(got_t.numpy(), want, rtol=0, atol=1e-12)


def test_zscore_matches_jax():
    X = np.random.default_rng(1).normal(3.0, 2.0, size=(300, 5))
    X[:, 2] = 4.25
    np.testing.assert_allclose(tcluster.zscore(X), jcluster.zscore(X), rtol=0, atol=1e-12)


@pytest.mark.parametrize("max_total", [30, 50, 1000])
def test_balanced_subsample_picks_the_same_rows(max_total):
    rng = np.random.default_rng(2)
    n = 240
    X = np.arange(n * 2, dtype=np.float64).reshape(n, 2)
    P = rng.integers(1, 4, n)
    D = rng.integers(0, 2, n)
    C = np.where(rng.random(n) < 0.5, "no_exo", "with_exo")
    want = jcluster.balanced_subsample(X, P, D, C, max_total=max_total, seed=3)
    got = tcluster.balanced_subsample(X, P, D, C, max_total=max_total, seed=3)
    for a, b in zip(got, want):
        np.testing.assert_array_equal(a, b)
    got_t = tcluster.balanced_subsample(torch.as_tensor(X), P, D, C,
                                        max_total=max_total, seed=3)
    np.testing.assert_array_equal(got_t[0].numpy(), want[0])


@pytest.mark.parametrize("scheme", ["36", "18"])
@pytest.mark.parametrize("dark", [None, 2, 7])
def test_cluster_id_matches_jax(scheme, dark):
    for p in range(1, 10):
        for c in ("no_exo", "with_exo"):
            for d in (0, 1):
                assert tcluster.cluster_id(p, c, d, scheme, dark) == \
                    jcluster.cluster_id(p, c, d, scheme, dark)


@pytest.mark.parametrize("k,t0", [(11, 5.0), (3, 2.0)])
def test_hampel_matches_jax(k, t0):
    rng = np.random.default_rng(4)
    x = rng.normal(size=500)
    x[rng.integers(0, 500, 20)] += 40.0
    x[:5] = 0.0
    np.testing.assert_array_equal(tprep.hampel(x, k, t0), jprep.hampel(x, k, t0))


@pytest.mark.parametrize("name", [
    "Posture-3-con-1-task-fatigue-with exo-Lifting overhead_EPOCPLUS_trial2.csv",
    "posture_12 noexo cognitiveload trial-7.csv",
    "Posture-1-con-1-task-stress-no exo-xx_EPOCPLUS_1_20250808_000000_trial1.csv",
    "recording.csv",
])
def test_parse_labels_matches_jax(name):
    assert tprep.parse_labels_from_filename(name) == jprep.parse_labels_from_filename(name)


@pytest.mark.parametrize("total", [60.0, 14.5, 0.0])
def test_default_segments_match_jax(total):
    assert tprep.make_default_btr_segments(total) == jprep.make_default_btr_segments(total)


def test_trace_helpers_match_jax():
    rng = np.random.default_rng(5)
    X = rng.normal(size=(6, 96, 4)).cumsum(1)
    X[:, :20] += 5.0
    np.testing.assert_array_equal(ttraces.standardize_per_seq(X),
                                  jtraces.standardize_per_seq(X))
    for k in (1, 4, 5):
        np.testing.assert_array_equal(ttraces.smooth_ma(X, k), jtraces.smooth_ma(X, k))
    for kw in ({}, {"use_first_C": 2}, {"base_win": 8, "max_trim": 10}):
        assert ttraces.estimate_prefix_to_trim(X, **kw) == \
            jtraces.estimate_prefix_to_trim(X, **kw)
    assert ttraces.estimate_prefix_to_trim(X[:, :2]) == jtraces.estimate_prefix_to_trim(X[:, :2])


# ----------------------------------------------------------------------
# colormaps and spectral ops
# ----------------------------------------------------------------------

@pytest.mark.parametrize("n", [36, 18])
def test_hsv_palette_matches_matplotlib(n):
    ours = np.array(tcluster.make_palette(n))
    ref = np.array([matplotlib.colormaps.get_cmap("hsv").resampled(n)(i) for i in range(n)])
    np.testing.assert_allclose(ours, ref, rtol=0, atol=1e-6)


@pytest.mark.parametrize("name", ["tab10", "viridis"])
def test_listed_colormaps_match_matplotlib(name):
    ours, ref = get_cmap(name), matplotlib.colormaps[name]
    np.testing.assert_allclose(ours(np.arange(ref.N)), ref(np.arange(ref.N)), rtol=0,
                               atol=1e-6)
    x = np.linspace(0, 1, 301)
    np.testing.assert_allclose(ours(x), ref(x), rtol=0, atol=1e-6)


@pytest.mark.parametrize("n,nperseg", [(7734, 256), (768, 96), (301, 37)])
def test_spectrogram_matches_scipy(n, nperseg):
    x = np.random.default_rng(6).normal(size=n)
    f, t, S = sp_spectrogram(x, fs=128.0, nperseg=nperseg)
    gf, gt, gS = spectrogram(torch.as_tensor(x), 128.0, nperseg)
    np.testing.assert_allclose(gf.numpy(), f, rtol=0, atol=1e-12)
    np.testing.assert_allclose(gt.numpy(), t, rtol=0, atol=1e-12)
    np.testing.assert_allclose(gS.numpy(), S, rtol=1e-9, atol=1e-15 * S.max())


@pytest.mark.parametrize("n_in,num", [(7734, 3867), (7733, 3866), (7734, 7734),
                                      (500, 1001), (501, 1000)])
def test_resample_matches_scipy(n_in, num):
    x = np.random.default_rng(7).normal(size=n_in)
    np.testing.assert_allclose(resample(torch.as_tensor(x), num).numpy(),
                               sp_resample(x, num), rtol=0, atol=1e-12)


# ----------------------------------------------------------------------
# file names against the JAX figure functions
# ----------------------------------------------------------------------

@pytest.mark.parametrize("opts", [{"zooms": True}, {"separate_legend": True},
                                  {"paired_legend": True, "color_scheme": "18"}])
def test_cluster_figures_write_the_jax_files(opts, tmp_path, recorder):
    rng = np.random.default_rng(8)
    pairs = _pairs(rng, {(1, "no_exo"): (12, 12), (2, "with_exo"): (12, 11),
                         (3, "no_exo"): (1, 0)})
    jcluster.cluster_figures(pairs, tmp_path / "jax", tsne_perplexity=5.0, tsne_max=40,
                             **opts)
    tcluster.cluster_figures(pairs, tmp_path / "port", tsne_perplexity=5.0, tsne_max=40,
                             device="cpu", **opts)
    got = sorted(p.name for p in (tmp_path / "port").iterdir())
    assert got == sorted(recorder.names)
    assert "pca_combined.png" in got and "tsne_combined.png" in got


@pytest.mark.parametrize("trim_both", [True, False])
def test_plot_pair_writes_the_jax_files(trim_both, tmp_path, recorder):
    rng = np.random.default_rng(9)
    real = rng.normal(size=(5, 96, 4)).astype(np.float32)
    fake = rng.normal(size=(6, 96, 4)).astype(np.float32)
    names = ["AF3", "F7", "F3", "FC5"]
    kw = dict(n_samples=2, auto_trim=False, fixed_trim=16, trim_both=trim_both)
    want = jtraces.plot_pair(real, fake, names, 128.0, tmp_path / "jax", "pt", **kw)
    got = ttraces.plot_pair(real, fake, names, 128.0, tmp_path / "port", "pt", **kw)
    assert got == want == 16
    assert sorted(p.name for p in (tmp_path / "port").iterdir()) == sorted(recorder.names)


@pytest.mark.parametrize("n_resampled", [None, 7680])
def test_label_figures_write_the_jax_files(n_resampled, tmp_path, recorder):
    sig = np.random.default_rng(10).normal(size=7680)
    meta = jprep.parse_labels_from_filename("Posture-2-task-fatigue-with exo_trial3.csv")
    segs = jprep.make_default_btr_segments(60.0)
    for d in ("jax", "port"):
        (tmp_path / d).mkdir()
    jprep.label_figures(sig, 128.0, meta, segs, tmp_path / "jax", n_resampled=n_resampled)
    tprep.label_figures(sig, 128.0, meta, segs, tmp_path / "port", n_resampled=n_resampled)
    assert sorted(p.name for p in (tmp_path / "port").iterdir()) == sorted(recorder.names)


def test_stage_figures_write_their_files(tmp_path, recorder):
    """plot_signal / _spectrogram / _psd / _bandpowers: each writes its one
    file, as the JAX functions do."""
    x = np.random.default_rng(11).normal(size=1536)
    for fn in ("plot_signal", "plot_spectrogram", "plot_psd", "plot_bandpowers"):
        getattr(jprep, fn)(x, 128.0, fn, tmp_path / f"j_{fn}.png")
        getattr(tprep, fn)(torch.as_tensor(x), 128.0, fn, tmp_path / f"{fn}.png")
    assert sorted(p.name for p in tmp_path.iterdir()) == \
        sorted(n[2:] for n in recorder.names)
