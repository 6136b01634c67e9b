"""The CGAN eval of eegsynth_torch (features, linear models, the three
metric families and both CLIs) against the JAX package and scikit-learn on
the same numpy arrays.

Tolerances and their reasons:

- features: 5e-4 absolute on log-power values of order 1–10 (float32
  FFTs of two libraries; the log magnifies the rounding of the weakest
  bins);
- discriminative rows: the port's logistic fit is solved to its optimum,
  scikit-learn's lbfgs stops at ``tol=1e-4`` (its coefficients 1e-3 to
  1e-2 of their largest off the optimum here), so a test row near 0.5 may
  fall on the other side: accuracy within 2 test rows, AUC within 0.01 (6
  of the 576 ranked pairs of the global split);
- predictive rows: 1e-5 relative (scikit-learn's Ridge and scaler work in
  float32 on float32 input, the port in float64);
- statistics: 1e-5 relative, 1e-6 absolute (float32 FFTs).

Every JAX call runs under ``jax.enable_x64(False)``.
"""

import csv
from pathlib import Path

import jax
import numpy as np
import pytest
import torch
from sklearn.linear_model import LogisticRegression as SkLogisticRegression
from sklearn.linear_model import Ridge as SkRidge
from sklearn.preprocessing import StandardScaler as SkStandardScaler

from test_torch_threads import one_thread_each  # noqa: F401

from eegsynth.eval import cgan_eval as jeval
from eegsynth.eval.features import psd_features as jax_psd_features
from eegsynth_torch.convert import tree_to_numpy
from eegsynth_torch.data.datasets import (
    load_condition_dataset, load_posture_both_conditions,
)
from eegsynth_torch.eval import cgan_eval as teval
from eegsynth_torch.eval.cgan_drivers import main as cgan_eval_cli
from eegsynth_torch.eval.features import psd_features
from eegsynth_torch.eval.linear_models import LogisticRegression, Ridge, StandardScaler
from eegsynth_torch.train import cgan as tcgan
from eegsynth_torch.train.checkpoint import save_checkpoint

T = 256
FEAT_ATOL = 5e-4
STAT_RTOL, STAT_ATOL = 1e-5, 1e-6


def _corpus(counts: dict, shift: float, seed: int):
    """(N, 14, T) float32 windows, posture blocks in ascending order, a
    posture-dependent sine under the noise."""
    rng = np.random.default_rng(seed)
    X, y = [], []
    for p, n in counts.items():
        x = rng.standard_normal((n, 14, T)).astype(np.float32)
        x += shift * np.sin(np.arange(T) / (3 + p)).astype(np.float32)
        X.append(x)
        y.append(np.full(n, p, np.int64))
    return np.concatenate(X), np.concatenate(y)


@pytest.fixture(scope="module")
def corpora():
    """Real and generated corpora whose posture counts differ (so v2's
    positional selection misaligns), every posture over the 20-row and
    10-row guards."""
    Xr, yr = _corpus({1: 30, 3: 24, 5: 26}, 0.5, 0)
    Xg, yg = _corpus({1: 30, 3: 22, 5: 28}, 0.4, 1)
    return Xr, yr, Xg, yg


@pytest.mark.parametrize("t_len", [96, 256])
def test_psd_features_match_jax(t_len):
    """T 96: 49 bins edge-padded to 64; T 256: 129 bins mean-pooled by 2."""
    X = np.random.default_rng(t_len).standard_normal((6, 14, t_len)).astype(np.float32)
    X[0, 2] = 0.0                     # log(eps) on a silent channel
    with jax.enable_x64(False):
        ref = jax_psd_features(X)
    got = psd_features(X, device="cpu")
    assert got.dtype == np.float32 and got.shape == ref.shape == (6, 14 * 64)
    np.testing.assert_allclose(got, ref, rtol=0, atol=FEAT_ATOL)


def test_standard_scaler_matches_sklearn():
    X = np.random.default_rng(0).standard_normal((40, 9)) * 3 + 1
    X[:, 4] = 2.5                     # constant: scale 1
    ref = SkStandardScaler().fit(X)
    ours = StandardScaler().fit(torch.from_numpy(X))
    np.testing.assert_allclose(ours.scale_.numpy(), ref.scale_, rtol=1e-12)
    assert ours.scale_[4] == 1.0
    np.testing.assert_allclose(ours.transform(torch.from_numpy(X)).numpy(),
                               ref.transform(X), rtol=1e-12, atol=1e-12)


@pytest.mark.parametrize("n,d", [(30, 200), (200, 30)])
def test_ridge_matches_sklearn(n, d):
    """The dual (fewer samples than features) and the primal system."""
    rng = np.random.default_rng(n)
    X, Y = rng.standard_normal((n, d)), rng.standard_normal((n, 5))
    ref = SkRidge(alpha=1.0).fit(X, Y)
    ours = Ridge(1.0).fit(torch.from_numpy(X), torch.from_numpy(Y))
    np.testing.assert_allclose(ours.coef_.numpy(), ref.coef_.T, atol=1e-10)
    np.testing.assert_allclose(ours.intercept_.numpy(), ref.intercept_, atol=1e-10)
    Xt = rng.standard_normal((7, d))
    np.testing.assert_allclose(ours.predict(torch.from_numpy(Xt)).numpy(),
                               ref.predict(Xt), atol=1e-10)


def test_logistic_regression_matches_converged_sklearn():
    """Newton's optimum against lbfgs driven to ``tol=1e-10``: 1e-5 of the
    largest coefficient (lbfgs's own remaining gradient sets that gap; the
    port's gradient at its solution is ~1e-12)."""
    rng = np.random.default_rng(0)
    X = rng.standard_normal((150, 300))
    y = (rng.uniform(size=150) < 1 / (1 + np.exp(-X[:, 0] - 0.5 * X[:, 1]))).astype(np.int64)
    ref = SkLogisticRegression(tol=1e-10, max_iter=100000).fit(X, y)
    ours = LogisticRegression().fit(torch.from_numpy(X), torch.from_numpy(y))
    scale = np.abs(ref.coef_).max()
    np.testing.assert_allclose(ours.coef_.numpy(), ref.coef_[0], rtol=0,
                               atol=1e-5 * scale)
    assert abs(ours.intercept_.item() - ref.intercept_[0]) < 1e-5 * scale
    np.testing.assert_allclose(ours.predict_proba(torch.from_numpy(X)).numpy(),
                               ref.predict_proba(X)[:, 1], atol=1e-5)
    assert ours.n_iter_ < 30


def _rows_close(got, ref, tol: dict):
    assert len(got) == len(ref)
    for g, r in zip(got, ref):
        assert list(g) == list(r)
        for k, v in r.items():
            if isinstance(v, str) or k == "posture":
                assert g[k] == v
            else:
                atol = tol[k](r) if callable(tol[k]) else tol[k]
                assert abs(g[k] - v) <= atol, (k, g[k], v)


def _read(path):
    with open(path, newline="") as f:
        return list(csv.reader(f))


@pytest.mark.parametrize("v2_split", [False, True])
def test_discriminative_metrics_match_jax(corpora, tmp_path, v2_split):
    Xr, yr, Xg, yg = corpora
    with jax.enable_x64(False):
        ref = jeval.discriminative_metrics(Xr, Xg, yr, yg, tmp_path / "j.csv",
                                           v2_split=v2_split)
    got = teval.discriminative_metrics(Xr, Xg, yr, yg, tmp_path / "t.csv",
                                       v2_split=v2_split, device="cpu")
    # 2 of the split's test rows: ceil(0.3 n) of the level's n rows
    n_rows = {0: len(Xr) + len(Xg)}
    n_rows.update({p: int((yr == p).sum() + (yg == p).sum()) for p in (1, 3, 5)})
    tol = {"acc": lambda r: 2 / np.ceil(0.3 * n_rows[r["posture"]]), "auc": 0.01}
    _rows_close(got, ref, tol)
    assert [r["posture"] for r in got] == ([0, 3] if v2_split else [0, 1, 3, 5])
    assert _read(tmp_path / "t.csv")[0] == _read(tmp_path / "j.csv")[0]


def test_predictive_scores_match_jax(corpora, tmp_path):
    Xr, yr, Xg, yg = corpora
    with jax.enable_x64(False):
        ref = jeval.predictive_scores(Xr, Xg, yr, yg, tmp_path / "j.csv")
    got = teval.predictive_scores(Xr, Xg, yr, yg, tmp_path / "t.csv", device="cpu")
    rel = lambda k: lambda r: 1e-5 * abs(r[k])   # noqa: E731
    _rows_close(got, ref, {"rmse": rel("rmse"), "r2": rel("r2")})
    assert len(got) == 8
    assert _read(tmp_path / "t.csv")[0] == _read(tmp_path / "j.csv")[0]


def test_stats_similarity_matches_jax(corpora, tmp_path):
    Xr, yr, Xg, yg = corpora
    with jax.enable_x64(False):
        ref = jeval.stats_similarity(Xr, Xg, yr, yg, tmp_path / "j.csv")
    got = teval.stats_similarity(Xr, Xg, yr, yg, tmp_path / "t.csv", device="cpu")
    tol = lambda k: lambda r: STAT_ATOL + STAT_RTOL * abs(r[k])   # noqa: E731
    _rows_close(got, ref, {k: tol(k) for k in ("psd_l1", "acf_l1", "coh_l1")})
    assert _read(tmp_path / "t.csv")[0] == _read(tmp_path / "j.csv")[0]


# ---- the CLIs on port-written conv generators


def _write_generator(path: Path, num_classes: int, variant: str, seed: int):
    hp = tcgan.CGANHParams(variant=variant,
                           **({"proj_scale": 0.10} if variant == "v2" else {}))
    cfg = tcgan.build_cfg(hp, num_classes)
    G, bn = tcgan.generator_init(cfg, torch.Generator().manual_seed(seed), device="cpu")
    path.parent.mkdir(parents=True, exist_ok=True)
    save_checkpoint(path, {"model": tree_to_numpy(G), "bn": tree_to_numpy(bn)},
                    tcgan.generator_meta(hp, num_classes, path.parent.name))


@pytest.fixture(scope="module")
def cgan_runs(tmp_path_factory):
    """posture{1..9}_{no_exo,with_exo} buckets of 7–9 random windows
    (768, 14); a v1 conv generator for no_exo (``last`` only), v2 conv
    generators for postures 1 and 2."""
    root = tmp_path_factory.mktemp("cgan_eval")
    data = root / "data"
    data.mkdir()
    rng = np.random.default_rng(0)
    for p in range(1, 10):
        for cond in ("no_exo", "with_exo"):
            np.savez(data / f"posture{p}_{cond}.npz",
                     X=rng.uniform(0, 1, (7 + p % 3, 768, 14)).astype(np.float32),
                     posture=np.int64(p), scale_min=np.zeros(14, np.float32),
                     scale_range=np.ones(14, np.float32),
                     ch_names=np.array([f"c{i}" for i in range(14)]),
                     fs=np.float32(128.0))
    _write_generator(root / "v1" / "no_exo" / "CGAN_generator_no_exo_last.npz",
                     9, "v1", 1)
    for p in (1, 2):
        _write_generator(root / "v2" / f"posture{p}" / f"CGAN_generator_posture{p}_best.npz",
                         2, "v2", p)
    return root


def _generate(path, num_classes, variant, gen, n, label):
    G, bn, cfg, _ = tcgan.load_generator(path, num_classes=num_classes,
                                         variant=variant, device="cpu")
    return tcgan.generate_batch(G, bn, cfg, gen, n, label).numpy()


def _same_csvs(a: Path, b: Path):
    for name in ("metrics_discriminative.csv", "metrics_predictive.csv",
                 "metrics_stats.csv"):
        assert _read(a / name) == _read(b / name), name


def test_condition_cli_matches_direct_calls(cgan_runs):
    """``condition``: the real rows subsampled with numpy's seeded global
    generator, the generated ones from a torch generator seeded per
    condition; the CSVs equal evaluate_condition on the same arrays."""
    root = cgan_runs
    secs = cgan_eval_cli(["condition", "--data-dir", str(root / "data"),
                          "--runs-root", str(root / "v1"), "--save-root",
                          str(root / "e1"), "--condition", "no_exo",
                          "--samples-per-posture", "5", "--seed", "7",
                          "--device", "cpu"])
    assert set(secs["no_exo"]) == {"generation", "discriminative", "predictive",
                                   "statistics", "figures"}
    np.random.seed(7)
    Xr, yr, _ = load_condition_dataset(root / "data", "no_exo")
    keep = []
    for p in range(1, 10):
        idx = np.where(yr == p)[0]
        np.random.shuffle(idx)
        keep.append(idx[:5])
    keep = np.concatenate(keep)
    Xr, yr = Xr[keep], yr[keep]
    gen = torch.Generator().manual_seed(7)
    path = root / "v1" / "no_exo" / "CGAN_generator_no_exo_last.npz"
    Xg = np.concatenate([_generate(path, 9, "v1", gen, 5, p) for p in range(9)])
    yg = np.repeat(np.arange(1, 10), 5)
    assert Xg.shape == (45, 14, 768) and len(Xr) == 45
    teval.evaluate_condition(Xr, yr, Xg, yg, root / "direct1", seed=7, device="cpu")
    _same_csvs(root / "e1" / "no_exo", root / "direct1")
    assert [r[0] for r in _read(root / "e1" / "no_exo" / "metrics_stats.csv")] == \
        ["level", "global"]


def test_posture_cli_matches_direct_calls(cgan_runs, capsys):
    """``posture --v2-split`` with postures out of order (sorted, with the
    script's message) and one without a generator (skipped): per-posture
    CSVs and ``global/`` equal the metric functions on the same arrays."""
    root = cgan_runs
    done = cgan_eval_cli(["posture", "--data-dir", str(root / "data"),
                          "--runs-root", str(root / "v2"), "--save-root",
                          str(root / "e2"), "--postures", "3,2,1", "--v2-split",
                          "--samples-per-cond", "6", "--device", "cpu"])
    out = capsys.readouterr().out
    assert "--v2-split requires ascending posture order" in out
    assert "[posture 3] no generator found" in out and done == [1, 2]
    np.random.seed(123)
    gen = torch.Generator().manual_seed(123)
    glob = []
    for p in (1, 2):
        X, y, _ = load_posture_both_conditions(root / "data", p)
        real = {c: X[y == c] for c in (0, 1)}
        path = root / "v2" / f"posture{p}" / f"CGAN_generator_posture{p}_best.npz"
        fakes = {c: _generate(path, 2, "v2", gen, 6, c) for c in (0, 1)}
        n = min(len(real[0]), len(real[1]), 6)
        R = np.concatenate([real[0][:n], real[1][:n]])
        G = np.concatenate([fakes[0][:n], fakes[1][:n]])
        yr, yg = np.full(len(R), p), np.full(len(G), p)
        glob.append((R, G, yr, yg))
        _direct(root / f"direct2_{p}", R, G, yr, yg)
        _same_csvs(root / "e2" / f"posture{p}", root / f"direct2_{p}")
    R, G, yr, yg = (np.concatenate(a) for a in zip(*glob))
    _direct(root / "direct2_g", R, G, yr, yg)
    _same_csvs(root / "e2" / "global", root / "direct2_g")
    assert len(_read(root / "e2" / "global" / "metrics_predictive.csv")) == 7


def _direct(out: Path, R, G, yr, yg):
    out.mkdir()
    teval.discriminative_metrics(R, G, yr, yg, out / "metrics_discriminative.csv",
                                 123, v2_split=True, device="cpu")
    teval.predictive_scores(R, G, yr, yg, out / "metrics_predictive.csv", device="cpu")
    teval.stats_similarity(R, G, yr, yg, out / "metrics_stats.csv", device="cpu")
