"""eegsynth_torch's preprocessing (CSV → bucket NPZs) against the JAX
package's on the same files: the name and header helpers, the native CSV
parser, ``run_preprocess`` and its CLI over a synthetic raw tree (a 50 Hz
participant, a rest file, a file shorter than an epoch, a 10-channel file),
the dry run, which errors of the filter propagate, and that the port's new
modules import without jax. The port filters with its plain recurrence here;
the card runs the IIR kernel (tests/test_torch_card.py, chip_smoke.py)."""

import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest
import torch

from test_torch_threads import one_thread_each  # noqa: F401

from eegsynth.data import fast_csv as jcsv
from eegsynth.data import preprocess as jpre
from eegsynth_torch import EPOC_CHANNELS
from eegsynth_torch.data import fast_csv as tcsv
from eegsynth_torch.data import preprocess as tpre
from eegsynth_torch.data.io import load_X
from eegsynth_torch.preprocess import main as preprocess_cli
from eegsynth_torch.tools.raw_tree import write_raw_tree

ROOT = Path(__file__).resolve().parent.parent
X_ATOL = 2e-6          # X in [0, 1], float32: filters that round apart by an ulp
SCALE_RTOL = 1e-6      # scale_min / scale_range, float32 from float64 filtering


def test_epoc_channels_are_the_jax_packages():
    import eegsynth
    assert EPOC_CHANNELS == eegsynth.EPOC_CHANNELS


@pytest.mark.parametrize("helper,arg", [
    ("match_epoc_columns", ["index", "timestamp"] + [f"eeg.{c.lower()}" for c in EPOC_CHANNELS]),
    ("match_epoc_columns", ["AF3", "f7 (uv)", "eeg.f3", "fc5_uv", "EEG_T7", "eeg.p7 (uv)"]),
    ("match_epoc_columns", ["x", "y"]),
    ("parse_meta_from_name",
     "Posture-3-con-1-deep squatting-fatigue-no exo-08 Aug_EPOC_451532_trial2.csv"),
    ("parse_meta_from_name", "posture-7-x-with exo-_trial11.csv"),
    ("parse_meta_from_name", "posture_4 withexo t3.csv"),
    ("parse_meta_from_name", "rest-1.csv"),
    ("find_time_col", ["index", "Timestamp", "eeg.af3"]),
    ("find_time_col", ["Counter", "eeg.af3"]),
    ("find_time_col", ["eeg.af3"]),
])
def test_name_and_header_helpers_equal_jax(helper, arg):
    assert getattr(tpre, helper)(arg) == getattr(jpre, helper)(arg)


def test_discover_csvs_equals_jax(tmp_path):
    write_raw_tree(tmp_path, participants=2, postures=(1, 2), seconds=1.0)
    (tmp_path / "protocol_outputs_2" / "sub").mkdir()
    (tmp_path / "protocol_outputs_2" / "sub" / "Posture-5-no exo_trial1.csv").write_text("a\n")
    (tmp_path / "elsewhere").mkdir()
    (tmp_path / "elsewhere" / "Posture-1-no exo_trial1.csv").write_text("a\n")
    got = tpre.discover_csvs(tmp_path)
    assert got == jpre.discover_csvs(tmp_path)
    assert len(got) == 2 * 2 * 2 + 2 + 1     # the rest file is not a trial


def _odd_csv(path: Path) -> None:
    path.write_bytes(
        "\ufefftimestamp,\"eeg.af3\", \"eeg.f7\",eeg.f3,label\r\n".encode()
        + b"0.0,+1.5,2,3.25,a\r\n"
        + b"0.0078125,,\"4.5\", 1e-3 ,b\r\n"
        + b"\r\n"
        + b"0.015625,abc,-0,nan,c\r\n"
        + b"0.0234375,1.0,2.0\r\n"
        + b"0.03125,7,8,9,d")


def test_csv_parser_matches_jax_bit_for_bit(tmp_path):
    fp = tmp_path / "odd.csv"
    _odd_csv(fp)
    header = tcsv.read_header(fp)
    assert header == jcsv.read_header(fp)
    assert header[:2] == ["timestamp", "eeg.af3"] and header[2] == ' "eeg.f7"'
    for cols in (header, ["eeg.f3", "timestamp"], ["label"]):
        ours = tcsv.read_columns(fp, cols)
        ref = jcsv.read_columns(fp, cols)
        assert ours.dtype == ref.dtype == np.float64
        np.testing.assert_array_equal(ours, ref)          # NaN where NaN
        np.testing.assert_array_equal(np.isnan(ours), np.isnan(ref))
    af3 = tcsv.read_columns(fp, ["eeg.af3", "eeg.f3"])
    np.testing.assert_array_equal(af3[:, 0], [1.5, np.nan, np.nan, 1.0, 7.0])
    np.testing.assert_array_equal(af3[:, 1], [3.25, 1e-3, np.nan, np.nan, 9.0])
    with pytest.raises(KeyError, match="missing"):
        tcsv.read_columns(fp, ["missing"])
    with pytest.raises(OSError):
        tcsv.read_header(tmp_path / "absent.csv")


def test_csv_parser_builds_into_build_native():
    path = tcsv.build()
    assert path.parent == ROOT / "build" / "native" and path.exists()
    assert tcsv.SOURCE == ROOT / "eegsynth_torch" / "native" / "csv_loader.cpp"


def _run_both(raw: Path, tmp_path: Path, **kw):
    jlog, tlog = [], []
    jrows = jpre.run_preprocess(raw, tmp_path / "jax", log=jlog.append, **kw)
    trows = tpre.run_preprocess(raw, tmp_path / "torch", log=tlog.append,
                                device="cpu", **kw)
    return (jrows, jlog), (trows, tlog)


def _without(lines, path):
    return [str(line).replace(str(path), "<out>") for line in lines]


def _hold_buckets(jdir: Path, tdir: Path) -> None:
    jfiles = sorted(p.name for p in jdir.glob("*.npz"))
    assert jfiles == sorted(p.name for p in tdir.glob("*.npz")) and jfiles
    for name in jfiles:
        with np.load(jdir / name, allow_pickle=True) as j, \
                np.load(tdir / name, allow_pickle=True) as t:
            assert j.files == t.files
            for key in j.files:
                a, b = j[key], t[key]
                assert a.dtype == b.dtype and a.shape == b.shape, key
                if key == "X":
                    np.testing.assert_allclose(b, a, atol=X_ATOL, rtol=0)
                elif key in ("scale_min", "scale_range"):
                    np.testing.assert_allclose(b, a, rtol=SCALE_RTOL)
                else:
                    np.testing.assert_array_equal(b, a)
    assert ((jdir / "prep_index.csv").read_text().replace(str(jdir), "<out>")
            == (tdir / "prep_index.csv").read_text().replace(str(tdir), "<out>"))


@pytest.fixture(scope="module")
def raw_tree(tmp_path_factory):
    root = tmp_path_factory.mktemp("raw")
    write_raw_tree(root, participants=2, postures=(1,), trials=3, seconds=14.0)
    return root


def test_run_preprocess_matches_jax(raw_tree, tmp_path):
    (jrows, jlog), (trows, tlog) = _run_both(raw_tree, tmp_path)
    assert _without(trows, tmp_path / "torch") == _without(jrows, tmp_path / "jax")
    assert _without(tlog, tmp_path / "torch") == _without(jlog, tmp_path / "jax")
    skips = [line for line in tlog if line.startswith("[SKIP]")]
    assert len(skips) == 2 and any("cannot concatenate" in s for s in skips) \
        and any("not enough samples" in s for s in skips)
    assert sum("notch 50Hz" in line for line in tlog) == 6      # participant 2
    assert sum("notch 60Hz" in line for line in tlog) == 6
    _hold_buckets(tmp_path / "jax", tmp_path / "torch")
    X = load_X(tmp_path / "torch" / "posture1_no_exo.npz")
    assert X.shape == (2 * 3 * 2, 768, 14) and X.dtype == np.float32


def test_cli_matches_jax_with_overlap(raw_tree, tmp_path):
    """The CLI's flags reach run_preprocess: 50 % overlap, 4 s epochs."""
    rows = preprocess_cli(["--root", str(raw_tree), "--out", str(tmp_path / "torch"),
                           "--epoch_sec", "4", "--overlap", "0.5", "--device", "cpu"])
    jrows = jpre.run_preprocess(raw_tree, tmp_path / "jax", epoch_sec=4.0, overlap=0.5,
                                log=lambda *a: None)
    assert _without(rows, tmp_path / "torch") == _without(jrows, tmp_path / "jax")
    _hold_buckets(tmp_path / "jax", tmp_path / "torch")


def test_dry_run_writes_nothing(raw_tree, tmp_path):
    out = tmp_path / "out"
    assert preprocess_cli(["--root", str(raw_tree), "--out", str(out), "--dry_run",
                           "--device", "cpu"]) == []
    assert list(out.iterdir()) == []


def test_cli_refuses_cuda_without_a_card(raw_tree, tmp_path, monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(SystemExit, match="no CUDA device"):
        preprocess_cli(["--root", str(raw_tree), "--out", str(tmp_path)])


def test_filter_errors_propagate(raw_tree, tmp_path, monkeypatch):
    """A failed build or launch on the card raises out of preprocess_file
    and run_preprocess: no handler on the path turns it into a skip or an
    unfiltered bucket."""
    def broken(*args, **kw):
        raise RuntimeError("iir_filter_f64: CUDA error 700")
    monkeypatch.setattr(tpre, "filtfilt", broken)
    fp = tpre.discover_csvs(raw_tree)[0]
    with pytest.raises(RuntimeError, match="CUDA error"):
        tpre.preprocess_file(fp, 128.0, 1.0, 45.0, 30.0, 10, 768, 0.0, "cpu")
    with pytest.raises(RuntimeError, match="CUDA error"):
        tpre.run_preprocess(raw_tree, tmp_path, log=lambda *a: None, device="cpu")
    assert not (tmp_path / "prep_index.csv").exists()


def test_too_short_notch_falls_back_to_unfiltered_as_in_jax(raw_tree, tmp_path,
                                                            monkeypatch):
    """The one failure the reference's notch handler means: a ValueError
    (an input too short for the notch's padding). The file is then
    band-passed alone, in both packages."""
    for module in (tpre, jpre):
        real = module.filtfilt

        def notch_too_short(b, a, x, axis=0, real=real):
            if len(b) == 3:
                raise ValueError("Input length 8 must exceed padlen 9.")
            return real(b, a, x, axis=axis)
        monkeypatch.setattr(module, "filtfilt", notch_too_short)
    fp = tpre.discover_csvs(raw_tree)[0]
    args = (fp, 128.0, 1.0, 45.0, 30.0, 10, 768, 0.0)
    ours, meta = tpre.preprocess_file(*args, device="cpu")
    ref, _ = jpre.preprocess_file(*args)
    # float32 windows of float64 filters that round apart: an ulp or two
    np.testing.assert_allclose(ours, ref, atol=1e-6 * np.abs(ref).max(), rtol=0)
    monkeypatch.undo()
    filtered, _ = tpre.preprocess_file(*args, device="cpu")
    assert np.abs(filtered - ours).max() > 1e-3 * np.abs(ours).max()
    assert meta["notch"] == 60.0


def test_new_modules_import_without_jax():
    """The port's new modules and CLIs import, and print their help, in a
    process where neither jax nor eegsynth can be imported."""
    code = """
import sys, runpy, importlib.abc
class Block(importlib.abc.MetaPathFinder):
    def find_spec(self, name, path=None, target=None):
        if name.split('.')[0] in ('jax', 'jaxlib', 'eegsynth'):
            raise ImportError('blocked: ' + name)
sys.meta_path.insert(0, Block())
import eegsynth_torch.ops.filtering, eegsynth_torch.data.filters
import eegsynth_torch.data.preprocess, eegsynth_torch.data.windowing
import eegsynth_torch.data.scaling, eegsynth_torch.data.fast_csv, eegsynth_torch.data.io
import eegsynth_torch.analysis.ttests, eegsynth_torch.analysis.participant_fatigue
import eegsynth_torch.analysis.fatigue, eegsynth_torch.analysis.bandpower
import eegsynth_torch.tools.raw_tree
for mod in ('eegsynth_torch.preprocess', 'eegsynth_torch.fatigue_report'):
    sys.argv = [mod, '--help']
    try:
        runpy.run_module(mod, run_name='__main__')
    except SystemExit as e:
        assert e.code == 0, e.code
bad = [m for m in sys.modules if m.split('.')[0] in ('jax', 'eegsynth', 'matplotlib')]
assert not bad, bad
"""
    out = subprocess.run([sys.executable, "-c", code], cwd=ROOT, check=True,
                         timeout=120, capture_output=True, text=True).stdout
    assert "--dry_run" in out and "--device" in out and "CSVs and figures" in out
