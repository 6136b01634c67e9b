"""``python -m eegsynth_torch.fatigue_report`` against ``scripts/fatigue_report.py``:
each subcommand run in process over the same inputs (two postures of
buckets that the port preprocessed from a synthetic raw tree, count-matched
synthetic windows, synthetic runs), and every CSV the JAX CLI writes compared
cell by cell: the same files, header and row order, strings equal, numbers
within 1e-9 relative (1e-12 absolute). The JAX CLI's figure calls are
stubbed out here and record the paths they would write; the port must
write the same PNGs."""

import csv
import importlib.util
import sys
from pathlib import Path

import numpy as np
import pytest

from test_torch_threads import one_thread_each  # noqa: F401

from eegsynth_torch.data.preprocess import run_preprocess
from eegsynth_torch.fatigue_report import main as fatigue_cli
from eegsynth_torch.tools.raw_tree import write_raw_tree

REPO = Path(__file__).resolve().parent.parent
RTOL, ATOL = 1e-9, 1e-12


def _jax_cli(argv, monkeypatch) -> list[Path]:
    """Run the JAX CLI with its figures stubbed (recorded, not laid out or
    drawn); returns the PNG paths it would have written."""
    import matplotlib.figure
    import matplotlib.pyplot as plt

    import eegsynth.analysis.plots as plots
    pngs = []
    for name in ("grouped_bar_plot", "scalar_bar", "psd_mean_plot", "bandpower_bar_plot"):
        monkeypatch.setattr(plots, name, lambda *a, **k: pngs.append(Path(a[-1])))
    monkeypatch.setattr(plt, "savefig", lambda path, *a, **k: pngs.append(Path(path)))
    monkeypatch.setattr(matplotlib.figure.Figure, "tight_layout", lambda self, *a, **k: None)
    spec = importlib.util.spec_from_file_location(
        "jax_fatigue_report", REPO / "scripts" / "fatigue_report.py")
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    monkeypatch.setattr(sys, "argv", ["fatigue_report.py", *argv])
    mod.main()
    plt.close("all")
    return pngs


@pytest.fixture(scope="module")
def tree(tmp_path_factory):
    """raw/ (CSVs), root/real (the port's buckets), root/synthetic
    (count-matched random windows under the bucket names), runs/ (one
    synthetic.npz per bucket, for --synth-dir)."""
    base = tmp_path_factory.mktemp("fatigue")
    write_raw_tree(base / "raw", participants=3, postures=(1, 2), seconds=14.0,
                   seed=11)
    real = base / "root" / "real"
    run_preprocess(base / "raw", real, log=lambda *a: None, device="cpu")
    (real / "prep_index.csv").unlink()
    rng = np.random.default_rng(12)
    for fp in sorted(real.glob("*.npz")):
        with np.load(fp, allow_pickle=True) as z:
            n, T, C = z["X"].shape
            fs = z["fs"]
        X = rng.uniform(0, 1, (n, T, C)).astype(np.float32)
        for d in (base / "root" / "synthetic", base / "runs" / fp.stem):
            d.mkdir(parents=True, exist_ok=True)
        np.savez(base / "root" / "synthetic" / fp.name, X=X, fs=fs)
        np.savez(base / "runs" / fp.stem / "synthetic.npz", X=X, fs=fs)
    return base


def _read(path):
    with open(path, newline="") as fh:
        return list(csv.reader(fh))


def _hold_csv(ours: Path, ref: Path) -> int:
    a, b = _read(ours), _read(ref)
    assert len(a) == len(b), ours.name
    for ra, rb in zip(a, b):
        assert len(ra) == len(rb), ours.name
        for ca, cb in zip(ra, rb):
            try:
                fa, fb = float(ca), float(cb)
            except ValueError:
                assert ca == cb, (ours.name, ca, cb)
                continue
            if np.isnan(fb):
                assert np.isnan(fa), (ours.name, ca, cb)
            else:
                assert abs(fa - fb) <= ATOL + RTOL * abs(fb), (ours.name, ca, cb)
    return len(a)


def _hold_trees(ours: Path, ref: Path, ref_pngs: list[Path]) -> list[str]:
    ref_csvs = sorted(p.relative_to(ref) for p in ref.rglob("*.csv"))
    assert sorted(p.relative_to(ours) for p in ours.rglob("*.csv")) == ref_csvs
    assert sorted(p.relative_to(ours) for p in ours.rglob("*.png")) == \
        sorted(p.relative_to(ref) for p in ref_pngs)
    for rel in ref_csvs:
        _hold_csv(ours / rel, ref / rel)
    return [str(r) for r in ref_csvs]


@pytest.mark.parametrize("argv", [["bandpower"], ["indices"], ["paired"],
                                  ["ttest", "--export-csv"],
                                  ["ttest", "--export-csv", "--scaling", "p95"],
                                  ["ttest", "--export-csv", "--scaling", "median"]])
def test_subcommand_csvs_equal_jax(argv, tree, tmp_path, monkeypatch):
    root = ["--root", str(tree / "root")]
    fatigue_cli([*argv, *root, "--out", str(tmp_path / "ours"), "--device", "cpu"])
    pngs = _jax_cli([*argv, *root, "--out", str(tmp_path / "ref")], monkeypatch)
    csvs = _hold_trees(tmp_path / "ours", tmp_path / "ref", pngs)
    want = {"bandpower": 9, "indices": 24, "paired": 1, "ttest": 2}[argv[0]]
    assert len(csvs) == want, csvs


@pytest.mark.parametrize("inverse", [False, True])
def test_participants_csv_equals_jax(inverse, tree, tmp_path, monkeypatch):
    argv = ["participants", "--data-root", str(tree / "raw"), "--synth-dir",
            str(tree / "runs"), "--real-dir", str(tree / "root" / "real"),
            *(["--inverse-scale"] if inverse else [])]
    fatigue_cli([*argv, "--out", str(tmp_path / "ours"), "--device", "cpu"])
    pngs = _jax_cli([*argv, "--out", str(tmp_path / "ref")], monkeypatch)
    assert _hold_trees(tmp_path / "ours", tmp_path / "ref", pngs) == ["participant_ttests.csv"]
    rows = _read(tmp_path / "ours" / "participant_ttests.csv")
    assert len(rows) == 1 + 2 * 14 and rows[1][-1] == "3"


def test_cli_refuses_cuda_without_a_card(tree, tmp_path, monkeypatch):
    import torch
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(SystemExit, match="no CUDA device"):
        fatigue_cli(["bandpower", "--root", str(tree / "root"), "--out", str(tmp_path)])
