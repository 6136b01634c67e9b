"""eegsynth_torch's TimeGAN eval against the JAX package's on the same numpy
inputs: the Welch PSD (and scipy's), the lag correlations, the ACF feature
and its near-constant guard, the statistical similarity, the GRU(24)
scorers (initial weights carried across) and one corpus's metric row. The
drivers' runs and the whole slice are in tests/test_torch_eval_drivers.py. The port runs its plain versions
here; the card runs K1 (tests/test_torch_card.py, chip_smoke.py)."""

import warnings

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import scipy.signal
import torch

from test_torch_threads import one_thread_each  # noqa: F401

from eegsynth.eval import classifiers as jcls
from eegsynth.eval import drivers as jdrivers
from eegsynth.eval.stats import statistical_similarity as jax_similarity
from eegsynth.ops import acf as jacf
from eegsynth.ops import spectral as jspec
from eegsynth_torch.eval import classifiers as tcls
from eegsynth_torch.eval import drivers as tdrivers
from eegsynth_torch.eval.stats import statistical_similarity
from eegsynth_torch.ops import acf as tacf
from eegsynth_torch.ops import spectral as tspec

# Welch: relative to the largest PSD value (the DC bin cancels after the
# detrend); float32 sums in another order, or float64
PSD_RTOL = {np.float32: 1e-5, np.float64: 1e-12}
CORR_TOL = 1e-5       # lag correlations, float32
ACF_TOL = 1e-12       # the ACF feature, float64 on the host in both
STAT_RTOL, STAT_ACF_TOL = 1e-5, 1e-10   # psd and coh relative, acf absolute
SCORER_TOL = 1e-5     # one forward, float32
LOSS_TOL, PARAM_TOL = 1e-5, 1e-4        # 5 Adam epochs
OUT_TOL = 1e-4        # scorer outputs and AUC / RMSE / R² after training


def _jax_init(seed, input_dim, hidden, out_dim):
    """The JAX package's initial scorer weights as the port's tree."""
    with jax.enable_x64(False):
        tree = jcls._rnn_head_init(jax.random.key(seed), input_dim, hidden, out_dim)
    return tcls.scorer_params_from_jax(jax.device_get(tree))


# ---------------------------------------------------------------- spectral

@pytest.mark.parametrize("dtype", [np.float32, np.float64])
@pytest.mark.parametrize("shape,nperseg,axis", [((5, 768, 3), 256, 1),
                                                ((4, 100, 2), 256, 1),
                                                ((3, 2, 300), 101, -1)])
def test_welch_psd_matches_jax_and_scipy(dtype, shape, nperseg, axis):
    """The eval's shape on axis 1, T below nperseg, an odd nperseg on the
    last axis."""
    x = np.random.default_rng(shape[1]).standard_normal(shape).astype(dtype)
    f, p = tspec.welch_psd(torch.from_numpy(x), fs=128.0, nperseg=nperseg, axis=axis)
    jf, jp = jspec.welch_psd(jnp.asarray(x), fs=128.0, nperseg=nperseg, axis=axis)
    with warnings.catch_warnings():   # scipy warns where T < nperseg
        warnings.simplefilter("ignore", UserWarning)
        sf, sp = scipy.signal.welch(x, fs=128.0, nperseg=nperseg, axis=axis)
    assert p.dtype == torch.from_numpy(x).dtype and p.shape == sp.shape
    rtol = PSD_RTOL[dtype]
    for ref in (np.asarray(jp), sp):
        np.testing.assert_allclose(p.numpy(), ref, rtol=rtol,
                                   atol=rtol * np.abs(ref).max())
    np.testing.assert_allclose(f.numpy(), np.asarray(jf), rtol=rtol)
    np.testing.assert_allclose(f.numpy(), sf, rtol=rtol)


def test_welch_psd_rejects_other_detrends():
    x = torch.zeros(2, 64)
    with pytest.raises(ValueError, match="detrend"):
        tspec.welch_psd(x, nperseg=32, detrend="linear")
    _, p = tspec.welch_psd(x + 1.0, nperseg=32, detrend=False)
    assert p[..., 0].abs().max() > 0          # no detrend: the DC bin stays


def test_hann_and_trapezoid_match():
    for n in (2, 7, 256):
        np.testing.assert_allclose(tspec.hann_periodic(n).numpy(),
                                   scipy.signal.get_window("hann", n), atol=1e-15)
        np.testing.assert_array_equal(tspec.hann_periodic(n).numpy(),
                                      np.asarray(jspec.hann_periodic(n)))
    rng = np.random.default_rng(0)
    y, x = rng.standard_normal((3, 17, 4)), np.sort(rng.uniform(0, 5, 17))
    got = tspec.trapezoid(torch.from_numpy(y), torch.from_numpy(x), axis=1)
    np.testing.assert_allclose(got.numpy(), np.trapezoid(y, x, axis=1), rtol=1e-12)
    np.testing.assert_allclose(got.numpy(), np.asarray(
        jspec.trapezoid(jnp.asarray(y), jnp.asarray(x), axis=1)), rtol=1e-12)


# -------------------------------------------------------------------- acf

def test_pearson_lag_corrs_matches_jax():
    rng = np.random.default_rng(1)
    x = (rng.standard_normal((6, 3, 200)) * 0.05 + 1.0).astype(np.float32)
    got = tacf.pearson_lag_corrs(torch.from_numpy(x), 96)
    want = np.asarray(jacf.pearson_lag_corrs(jnp.asarray(x), 96))
    assert got.dtype == torch.float32 and got.shape == want.shape == (6, 3, 96)
    np.testing.assert_allclose(got.numpy(), want, atol=CORR_TOL)


def test_mean_acf_per_channel_matches_jax_with_the_guard():
    """Constant sequences and sequences whose std lies at 5e-9 (under the
    1e-8 guard: they count 0) and at 2e-8 (over it) give the same guard
    decisions in both packages."""
    rng = np.random.default_rng(2)
    x = rng.uniform(0, 1, (8, 300, 4)).astype(np.float32)
    x[0, :, 0] = 0.7
    for b, c, std in ((1, 1, 5e-9), (2, 2, 2e-8), (3, 3, 5e-9), (4, 0, 2e-8)):
        z = rng.standard_normal(300)
        x[b, :, c] = (std * (z - z.mean()) / z.std()).astype(np.float32)
    stds = np.moveaxis(x, 1, -1).std(axis=-1)
    assert stds[1, 1] < 1e-8 < stds[2, 2]
    got = tacf.mean_acf_per_channel(x, 96)
    want = jacf.mean_acf_per_channel(jnp.asarray(x), 96)
    assert got.dtype == np.float64
    np.testing.assert_allclose(got, want, rtol=0, atol=ACF_TOL)
    np.testing.assert_allclose(tacf._pearson_lag_corrs_np64(x[:2], 50),
                               jacf._pearson_lag_corrs_np64(x[:2], 50), atol=ACF_TOL)


def test_statistical_similarity_matches_jax():
    rng = np.random.default_rng(3)
    real = rng.uniform(0, 1, (12, 768, 14)).astype(np.float32)
    fake = (real * 0.8 + 0.2 * rng.uniform(0, 1, real.shape)).astype(np.float32)
    got = statistical_similarity(real, fake, 128.0, device="cpu")
    want = jax_similarity(real, fake, 128.0)
    assert got[0] == pytest.approx(want[0], rel=STAT_RTOL)
    assert got[1] == pytest.approx(want[1], rel=0, abs=STAT_ACF_TOL)
    assert got[2] == pytest.approx(want[2], rel=STAT_RTOL)


# ---------------------------------------------------------------- scorers

def test_forward_last_matches_jax():
    x = np.random.default_rng(4).standard_normal((3, 20, 5)).astype(np.float32)
    with jax.enable_x64(False):
        jp = jcls._rnn_head_init(jax.random.key(7), 5, 24, 2)
        want = np.asarray(jcls._forward_last(jp, jnp.asarray(x)))
    got = tcls._forward_last(tcls.scorer_params_from_jax(jax.device_get(jp)),
                             torch.from_numpy(x))
    np.testing.assert_allclose(got.numpy(), want, atol=SCORER_TOL)


@pytest.mark.parametrize("classify", [True, False])
def test_train_core_matches_jax(classify):
    rng = np.random.default_rng(5)
    X = rng.standard_normal((10, 12, 4)).astype(np.float32)
    y = (rng.integers(0, 2, (10, 1)) if classify
         else rng.standard_normal((10, 3))).astype(np.float32)
    with jax.enable_x64(False):
        jp = jcls._rnn_head_init(jax.random.key(0), 4, 24, y.shape[1])
        w = jnp.ones((10,), jnp.float32)
        jp2, jl = jcls._train_core(jp, jnp.asarray(X), jnp.asarray(y), w, 5, 1e-3,
                                   classify)
        jp2, jl = jax.device_get((jp2, jl))
    tp2, tl = tcls._train_core(tcls.scorer_params_from_jax(jax.device_get(jp)),
                               torch.from_numpy(X), torch.from_numpy(y), 5, 1e-3,
                               classify)
    np.testing.assert_allclose(tl.numpy(), jl, atol=LOSS_TOL)
    for (a, b) in zip(jax.tree.leaves(jp2),
                      jax.tree.leaves(jax.tree.map(lambda t: t.numpy(), tp2))):
        np.testing.assert_allclose(b, a, atol=PARAM_TOL)


def test_run_grouped_unpadded_matches_jax_padded():
    """Three tasks of one shape (one stack) and one of another: the port
    stacks them without padding, JAX pads rows to 64 and tasks to 4."""
    rng = np.random.default_rng(6)
    shapes = [(14, 6), (14, 6), (14, 6), (9, 4)]
    port, jtasks = [], []
    for i, (ntr, nte) in enumerate(shapes):
        Xtr = rng.standard_normal((ntr, 10, 3)).astype(np.float32)
        ytr = rng.integers(0, 2, (ntr, 1)).astype(np.float32)
        Xte = rng.standard_normal((nte, 10, 3)).astype(np.float32)
        with jax.enable_x64(False):
            jp = jcls._rnn_head_init(jax.random.key(i), 3, 24, 1)
        Xp, yp, w = jcls._pad_rows([Xtr, ytr])
        Xq, _ = jcls._pad_rows([Xte])
        jtasks.append({"params": jp, "Xtr": Xp, "ytr": yp, "w": w, "Xte": Xq})
        port.append({"params": tcls.scorer_params_from_jax(jax.device_get(jp)),
                     "Xtr": Xtr, "ytr": ytr, "Xte": Xte})
    with jax.enable_x64(False):
        want = jcls._run_grouped(jtasks, 3, 1e-3, True)
    got = tcls._run_grouped(port, 3, 1e-3, True, "cpu")
    for g, w_, (_, nte) in zip(got, want, shapes):
        assert g.shape == (nte, 1)
        np.testing.assert_allclose(g, w_[:nte], atol=OUT_TOL)


def _pairs(rng, sizes, T=12, C=3):
    return [(rng.normal(0.5, 0.2, (nr, T, C)).astype(np.float32),
             rng.normal(0.6, 0.2, (nf, T, C)).astype(np.float32)) for nr, nf in sizes]


def test_scores_batch_match_jax(monkeypatch):
    monkeypatch.setattr(tcls, "_rnn_head_init", _jax_init)
    pairs = _pairs(np.random.default_rng(7), [(12, 14), (13, 13), (30, 25)])
    with jax.enable_x64(False):
        want = jcls.discriminative_scores_batch(pairs, epochs=4)
    got = tcls.discriminative_scores_batch(pairs, epochs=4, device="cpu")
    for (acc, auc), (jacc, jauc) in zip(got, want):
        assert acc == jacc
        assert auc == pytest.approx(jauc, abs=OUT_TOL)
    tasks = [(f[:, :-1], f[:, -1], r[:, :-1], r[:, -1]) for r, f in pairs]
    with jax.enable_x64(False):
        want = jcls.predictive_scores_batch(tasks, epochs=4)
    got = tcls.predictive_scores_batch(tasks, epochs=4, device="cpu")
    np.testing.assert_allclose(np.array(got), np.array(want), atol=OUT_TOL)


def test_evaluate_pair_matches_jax(monkeypatch):
    """One corpus's metric row through the single-pair scorers."""
    monkeypatch.setattr(tcls, "_rnn_head_init", _jax_init)
    rng = np.random.default_rng(10)
    real = rng.normal(0.5, 0.1, size=(12, 16, 3)).astype(np.float32)
    fake = rng.normal(0.5, 0.1, size=(12, 16, 3)).astype(np.float32)
    want = jdrivers.evaluate_pair(real, fake, fs=128.0)
    got = tdrivers.evaluate_pair(real, fake, fs=128.0, device="cpu")
    assert list(got) == list(want) == jdrivers.METRIC_COLS
    for c in ("disc_acc", "n_real", "n_fake", "seq_len", "n_ch"):
        assert got[c] == want[c], c
    for c in ("disc_auc", "rmse_tstr", "r2_tstr", "rmse_trts", "r2_trts"):
        assert got[c] == pytest.approx(want[c], rel=OUT_TOL, abs=OUT_TOL), c
    for c in ("psd_diff", "coh_diff"):
        assert got[c] == pytest.approx(want[c], rel=STAT_RTOL), c
    assert got["acf_diff"] == pytest.approx(want["acf_diff"], rel=0, abs=STAT_ACF_TOL)
