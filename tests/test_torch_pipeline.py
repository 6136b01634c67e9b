"""python -m eegsynth_torch.pipeline on the CPU, end to end: train → synth
→ eval → fatigue → viz on a tiny two-bucket corpus, each stage a
subprocess of the port's own CLI with ``--device cpu``; the artifacts and
the manifest that ``tests/test_pipeline.py`` checks of the JAX script, a
rerun that skips every stage, and ``--dry_run`` plans equal to
``scripts/pipeline.py --dry_run``'s for the same arguments (that script
imports no jax).
"""

import json
import os
import shutil
import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest

from eegsynth_torch.pipeline import main
from test_torch_threads import one_thread_each  # noqa: F401

REPO = Path(__file__).resolve().parent.parent
JAX_PIPELINE = REPO / "scripts" / "pipeline.py"
# one thread a stage process, as one_thread_each gives this one: the
# stages inherit the environment
ONE_THREAD = {**os.environ, **{k: "1" for k in ("OMP_NUM_THREADS", "MKL_NUM_THREADS",
                                                "OPENBLAS_NUM_THREADS")}}


def _port(args):
    r = subprocess.run([sys.executable, "-u", "-m", "eegsynth_torch.pipeline"] + args,
                       cwd=REPO, capture_output=True, text=True, timeout=600,
                       env=ONE_THREAD)
    if r.returncode != 0:
        raise AssertionError(f"pipeline failed:\nSTDOUT:\n{r.stdout}\nSTDERR:\n{r.stderr}")
    return r


@pytest.fixture(scope="module")
def corpus(tmp_path_factory):
    root = tmp_path_factory.mktemp("pipe")
    data = root / "prep"
    data.mkdir()
    rng = np.random.default_rng(0)
    for cond in ("no_exo", "with_exo"):
        X = rng.uniform(0, 1, (16, 128, 3)).astype(np.float32)
        np.savez_compressed(
            data / f"posture1_{cond}.npz", X=X, fs=np.float32(128.0),
            ch_names=np.array(["AF3", "F7", "F3"]),
            scale_min=np.zeros(3, np.float32), scale_range=np.ones(3, np.float32))
    cfg = root / "tiny.json"
    cfg.write_text(json.dumps({"ae_epochs": 1, "sup_epochs": 1, "gan_steps": 2,
                               "chunk": 2, "batch_size": 4, "acf_max_lag": 8}))
    return root, data, cfg


@pytest.fixture(scope="module")
def completed_run(corpus):
    root, data, cfg = corpus
    work = root / "work"
    _port(["--data_dir", str(data), "--work_dir", str(work), "--config", str(cfg),
           "--device", "cpu", "--gen_len", "128", "--n", "6",
           "--stage-arg", "eval:--tsne_max=40",
           "--stage-arg", "viz:--tsne_perplexity=5"])
    return work


def test_all_stage_artifacts(completed_run):
    work = completed_run
    for stem in ("posture1_no_exo", "posture1_with_exo"):
        run = work / "timegan_runs" / stem
        assert (run / "train_log.csv").exists()
        assert (run / "ckpt_latest.npz").exists()
        assert (run / "synthetic.npz").exists()
        long = np.load(run / "synthetic_long.npz")["X"]
        assert long.shape == (6, 128, 3) and np.isfinite(long).all()
    assert (work / "eval_out" / "metrics_global.csv").exists()
    assert (work / "eval_out" / "metrics_per_posture_condition.csv").exists()
    assert (work / "fatigue" / "posture1_tbr_4group.png").exists()
    assert (work / "fatigue" / "posture1_stats.csv").exists()
    assert (work / "figures" / "pca_combined.png").exists()


def test_manifest(completed_run):
    m = json.loads((completed_run / "pipeline_manifest.json").read_text())
    assert [s for s, v in m["stages"].items() if v["status"] == "ok"] == [
        "train", "synth", "eval", "fatigue", "viz"]
    assert all(v["seconds"] > 0 for v in m["stages"].values())
    assert 0.0 <= m["eval_global"]["disc_acc"] <= 1.0
    assert np.isfinite(m["eval_global"]["psd_diff"])
    assert m["total_seconds"] > 0


def test_fatigue_view_symlinks(completed_run):
    view = completed_run / "fatigue_view"
    for sub, name in (("real", "posture1_no_exo.npz"),
                      ("synthetic", "posture1_with_exo.npz")):
        fp = view / sub / name
        assert fp.is_symlink() and np.load(fp)["X"].ndim == 3
    tgt = (view / "synthetic" / "posture1_no_exo.npz").resolve()
    assert tgt.name == "synthetic_long.npz"


def test_rerun_skips_completed_stages(corpus, completed_run):
    root, data, cfg = corpus
    r = _port(["--data_dir", str(data), "--work_dir", str(completed_run),
               "--config", str(cfg), "--device", "cpu", "--gen_len", "128"])
    m = json.loads((completed_run / "pipeline_manifest.json").read_text())
    assert all(v["status"] == "skipped" for v in m["stages"].values())
    assert r.stdout.count("SKIP") == 5


def _jax_plan(args, cwd):
    r = subprocess.run([sys.executable, str(JAX_PIPELINE), *args], cwd=cwd,
                       capture_output=True, text=True, timeout=120)
    assert r.returncode == 0, r.stderr
    return r.stdout


def _port_plan(args, cwd, monkeypatch, capsys):
    monkeypatch.chdir(cwd)
    capsys.readouterr()
    main(args)
    return capsys.readouterr().out


@pytest.mark.parametrize("extra", [[], ["--gen_seconds", "12", "--sequential"],
                                   ["--stages", "viz,train", "--force"]])
def test_dry_run_plans_equal_the_jax_script(corpus, completed_run, tmp_path, extra,
                                            monkeypatch, capsys):
    """A fresh work dir given relative to the caller's cwd (every stage to
    run, the path resolved there), and the completed one (every stage
    skipped)."""
    root, data, cfg = corpus
    shutil.copytree(data, tmp_path / "data")
    for data_arg, work, cwd in (("data", "w", tmp_path),
                                (str(data), str(completed_run), REPO)):
        args = ["--data_dir", data_arg, "--work_dir", work, "--dry_run", *extra]
        ours = _port_plan(args, cwd, monkeypatch, capsys)
        assert ours == _jax_plan(args, cwd)
        assert "Pipeline plan:" in ours
        if work == "w":
            assert f"work_dir={tmp_path / 'w'}" in ours
    assert not (tmp_path / "w" / "pipeline_manifest.json").exists()


def test_bad_stage_and_mesh_are_refused(corpus, tmp_path):
    root, data, cfg = corpus
    with pytest.raises(SystemExit, match="Unknown stage"):
        main(["--data_dir", str(data), "--work_dir", str(tmp_path / "w"),
              "--stages", "nosuch"])
    with pytest.raises(SystemExit, match="--mesh has no counterpart"):
        main(["--data_dir", str(data), "--work_dir", str(tmp_path / "w"), "--mesh"])
