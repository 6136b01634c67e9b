"""eegsynth_torch's TimeGAN eval drivers against the JAX package's: the
loaders and the synthetic-file preference (one test over both packages),
run_timegan_eval's CSVs on the same files, and the whole slice: the port's
tiny multi-bucket training, then both packages' eval of its outputs. The
port runs its plain versions here; the card runs K1 (chip_smoke.py)."""

import csv
import importlib
import subprocess
import sys
from pathlib import Path

import jax
import numpy as np
import pytest

from test_torch_threads import one_thread_each  # noqa: F401

from eegsynth.eval import classifiers as jcls
from eegsynth.eval import drivers as jdrivers
from eegsynth_torch.eval import classifiers as tcls
from eegsynth_torch.eval import drivers as tdrivers
from eegsynth_torch.train.timegan_multi import train_all_buckets

ROOT = Path(__file__).resolve().parent.parent
# as tests/test_torch_eval.py: AUC, RMSE and R² after training; psd and coh
# relative, acf absolute
OUT_TOL = 1e-4
STAT_RTOL, STAT_ACF_TOL = 1e-5, 1e-10


def _jax_init(seed, input_dim, hidden, out_dim):
    """The JAX package's initial scorer weights as the port's tree."""
    with jax.enable_x64(False):
        tree = jcls._rnn_head_init(jax.random.key(seed), input_dim, hidden, out_dim)
    return tcls.scorer_params_from_jax(jax.device_get(tree))


def _save(fp, X, **extra):
    fp.parent.mkdir(parents=True, exist_ok=True)
    np.savez(fp, X=X.astype(np.float32), **extra)


@pytest.mark.parametrize("package", ["eegsynth", "eegsynth_torch"])
def test_loaders_and_synth_file_preference(tmp_path, rng, package):
    """find_synth_npz's preference, load_pairs_by_condition's cut to the
    smaller count, load_posture_pairs' per-condition balance, in both
    packages."""
    drv = importlib.import_module(f"{package}.eval.drivers")
    X = rng.normal(size=(2, 8, 3))
    run = tmp_path / "run"
    _save(run / "aaa_other.npz", X)
    assert drv.find_synth_npz(run).name == "aaa_other.npz"
    _save(run / "synthetic.npz", X)
    assert drv.find_synth_npz(run).name == "synthetic.npz"
    _save(run / "synthetic_long.npz", X)
    assert drv.find_synth_npz(run).name == "synthetic_long.npz"
    assert drv.find_synth_npz(tmp_path / "empty") is None

    real_dir, synth_dir = tmp_path / "real", tmp_path / "runs"
    _save(real_dir / "posture1_no_exo.npz", rng.normal(size=(10, 8, 3)))
    _save(synth_dir / "posture1_no_exo" / "synthetic.npz", rng.normal(size=(7, 8, 3)))
    pairs = drv.load_pairs_by_condition(real_dir, synth_dir)
    assert set(pairs) == {(1, "no_exo")}
    assert len(pairs[(1, "no_exo")][0]) == len(pairs[(1, "no_exo")][1]) == 7

    for cond, n_r, n_f in (("no_exo", 6, 4), ("with_exo", 5, 9)):
        _save(real_dir / f"posture2_{cond}.npz", rng.normal(size=(n_r, 8, 3)))
        _save(synth_dir / f"posture2_{cond}" / "synthetic.npz",
              rng.normal(size=(n_f, 8, 3)))
    r, f = drv.load_posture_pairs(real_dir, synth_dir)[2]
    assert len(r) == len(f) == 4 + 5


def _read_csv(path):
    with open(path) as f:
        reader = csv.DictReader(f)
        return reader.fieldnames, list(reader)


def _assert_csvs_agree(got_dir, want_dir, per_csv, lead):
    """Counts, labels and accuracies equal; AUC, RMSE and R² within OUT_TOL
    of max(1, |value|) (R² of a target the tiny scorers barely fit reaches
    hundreds); psd and coh relative, acf absolute."""
    for name, keys in ((per_csv, lead), ("metrics_global.csv", [])):
        gcols, grows = _read_csv(got_dir / name)
        wcols, wrows = _read_csv(want_dir / name)
        assert gcols == wcols == keys + jdrivers.METRIC_COLS
        assert len(grows) == len(wrows) > 0
        for g, w in zip(grows, wrows):
            for c in keys + ["disc_acc", "n_real", "n_fake", "seq_len", "n_ch"]:
                assert g[c] == w[c], c
            for c in ("disc_auc", "rmse_tstr", "r2_tstr", "rmse_trts", "r2_trts"):
                assert float(g[c]) == pytest.approx(float(w[c]), rel=OUT_TOL,
                                                    abs=OUT_TOL), c
            for c in ("psd_diff", "coh_diff"):
                assert float(g[c]) == pytest.approx(float(w[c]), rel=STAT_RTOL), c
            assert float(g["acf_diff"]) == pytest.approx(float(w["acf_diff"]),
                                                         rel=0, abs=STAT_ACF_TOL)


def _both_evals(monkeypatch, real_dir, synth_dir, tmp_path, by_condition):
    """Both packages' run_timegan_eval on the same files, the port with
    JAX's initial scorer weights, JAX without its figures."""
    monkeypatch.setattr(tcls, "_rnn_head_init", _jax_init)
    monkeypatch.setattr(jdrivers, "pca_tsne_plots", lambda *a, **k: None)
    want = jdrivers.run_timegan_eval(real_dir, synth_dir, tmp_path / "jax",
                                     by_condition=by_condition)
    got = tdrivers.run_timegan_eval(real_dir, synth_dir, tmp_path / "port",
                                    by_condition=by_condition, device="cpu")
    per_csv = ("metrics_per_posture_condition.csv" if by_condition
               else "metrics_per_posture.csv")
    lead = ["posture", "condition"] if by_condition else ["posture"]
    _assert_csvs_agree(tmp_path / "port", tmp_path / "jax", per_csv, lead)
    assert set(got["seconds"]) == {"discriminative", "predictive", "statistics", "csv",
                                   "figures"}
    return got, want


@pytest.mark.parametrize("by_condition", [True, False])
def test_run_timegan_eval_matches_jax(tmp_path, monkeypatch, by_condition):
    """Three pairs (T 16, C 3), posture 2's synthetic corpus a step longer
    (the mixed-T cut): both packages write the same CSVs."""
    rng = np.random.default_rng(8)
    real_dir, synth_dir = tmp_path / "real", tmp_path / "runs"
    for (p, cond), t_f in zip(((1, "no_exo"), (1, "with_exo"), (2, "no_exo")),
                              (16, 16, 17)):
        X = rng.normal(0.5, 0.1, size=(10, 16, 3))
        _save(real_dir / f"posture{p}_{cond}.npz", X, fs=128.0)
        _save(synth_dir / f"posture{p}_{cond}" / "synthetic.npz",
              rng.normal(0.5, 0.1, size=(9, t_f, 3)))
    got, _ = _both_evals(monkeypatch, real_dir, synth_dir, tmp_path, by_condition)
    assert len(got["rows"]) == (3 if by_condition else 2)
    assert got["global"]["seq_len"] == 16


def test_slice_train_then_eval_matches_jax(tmp_path, monkeypatch):
    """The slice end to end on the CPU: the port's multi-bucket trainer at a
    tiny size writes synthetic.npz for two buckets, then both packages'
    eval of those outputs agree."""
    data, runs = tmp_path / "data", tmp_path / "runs"
    data.mkdir()
    rng = np.random.default_rng(9)
    for name in ("posture1_no_exo", "posture1_with_exo"):
        np.savez(data / f"{name}.npz", X=rng.uniform(0, 1, (8, 16, 5))
                 .astype(np.float32), fs=np.float32(128.0))
    train_all_buckets(data, runs, device="cpu", log_every=1, ae_epochs=1,
                      sup_epochs=1, gan_steps=3, batch_size=4, acf_max_lag=4)
    got, _ = _both_evals(monkeypatch, data, runs, tmp_path, True)
    assert [r["n_fake"] for r in got["rows"]] == [8, 8]
    assert got["global"]["n_real"] == 16
    assert all(np.isfinite(v) for v in got["global"].values())


def test_mesh_is_refused_with_a_reason(tmp_path):
    """``--mesh`` (``scripts/evaluate_18.py``, ``scripts/evaluation.py``) is
    taken and refused with the reason, not argparse's exit 2."""
    with pytest.raises(SystemExit, match="--mesh has no counterpart in eegsynth_torch: "
                                         "the scorer stacks run on one device"):
        tdrivers.main(["--mesh", "--out", str(tmp_path / "out"), "--device", "cpu"])
    assert not (tmp_path / "out").exists()


def test_eval_imports_neither_sklearn_nor_matplotlib():
    code = ("import sys, runpy\n"
            "import eegsynth_torch.eval, eegsynth_torch.eval.protocol\n"
            "sys.argv = ['drivers', '--help']\n"
            "try:\n"
            "    runpy.run_module('eegsynth_torch.eval.drivers', run_name='__main__')\n"
            "except SystemExit as e:\n"
            "    assert e.code == 0, e.code\n"
            "bad = [m for m in ('jax', 'sklearn', 'matplotlib') if m in sys.modules]\n"
            "assert not bad, bad\n")
    out = subprocess.run([sys.executable, "-c", code], cwd=ROOT, check=True,
                         timeout=120, capture_output=True, text=True).stdout
    assert "--by_condition" in out and "--device" in out
