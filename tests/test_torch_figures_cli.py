"""The port's figure entry points against the JAX package's scripts on the
same files: ``python -m eegsynth_torch.visualization``,
``plot_real_vs_synth``, ``preprocessing_plots`` and ``visualization_cgan``
write the PNG names the JAX scripts save (their ``savefig`` recorded
instead of drawn, scikit-learn's t-SNE and the JAX CGAN generator stubbed),
the eval's ``pca_tsne_plots`` and the CGAN eval's ``scatter_plots`` the
same, ``--tsne_max`` reaches the eval, and the eval's t-SNE guard skips only
too few points."""

import importlib.util
import sys
from pathlib import Path

import numpy as np
import pytest
import torch

from test_torch_threads import one_thread_each  # noqa: F401

from eegsynth_torch.convert import tree_to_numpy
from eegsynth_torch.eval import cgan_eval as teval
from eegsynth_torch.eval import drivers as tdrivers
from eegsynth_torch.plot_real_vs_synth import main as traces_cli
from eegsynth_torch.preprocessing_plots import main as prep_cli
from eegsynth_torch.tools.raw_tree import write_raw_tree
from eegsynth_torch.train import cgan as tcgan
from eegsynth_torch.train.checkpoint import save_checkpoint
from eegsynth_torch.visualization import main as viz_cli
from eegsynth_torch.visualization_cgan import main as viz_cgan_cli
from eegsynth_torch.viz import embed

REPO = Path(__file__).resolve().parent.parent


class _FakeTSNE:
    def __init__(self, *a, **k):
        pass

    def fit_transform(self, X):
        return np.asarray(X)[:, :2] * 1.0


@pytest.fixture
def recorded(monkeypatch):
    """Every figure the JAX code saves is recorded (absolute path), not
    drawn (pyplot's savefig would also draw the canvas), and not laid out
    (tight_layout would measure every text); scikit-learn's t-SNE returns
    the input's first two columns."""
    import matplotlib.figure
    import matplotlib.pyplot as plt
    import sklearn.manifold
    paths = []
    monkeypatch.setattr(matplotlib.figure.Figure, "savefig",
                        lambda self, path, *a, **k: paths.append(Path(path)))
    monkeypatch.setattr(plt, "savefig", lambda path, *a, **k: paths.append(Path(path)))
    monkeypatch.setattr(matplotlib.figure.Figure, "tight_layout", lambda self, *a, **k: None)
    monkeypatch.setattr(sklearn.manifold, "TSNE", _FakeTSNE)
    yield paths
    plt.close("all")


def _script(name, argv, monkeypatch):
    spec = importlib.util.spec_from_file_location(f"jax_{name}", REPO / "scripts" / f"{name}.py")
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    monkeypatch.setattr(sys, "argv", [f"{name}.py", *argv])
    mod.main()


def _pngs(root: Path) -> list[Path]:
    return sorted(p.relative_to(root) for p in root.rglob("*.png"))


def _rel(paths, root: Path) -> list[Path]:
    return sorted(p.relative_to(root) for p in paths)


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    """real/posture{p}_{cond}.npz and runs/posture{p}_{cond}/synthetic.npz
    for three pairs of (12, 32, 3) windows."""
    root = tmp_path_factory.mktemp("figruns")
    rng = np.random.default_rng(0)
    for p, cond in ((1, "no_exo"), (1, "with_exo"), (3, "no_exo")):
        (root / "real").mkdir(exist_ok=True)
        (root / "runs" / f"posture{p}_{cond}").mkdir(parents=True)
        base = rng.normal(size=(1, 32, 3))
        np.savez(root / "real" / f"posture{p}_{cond}.npz",
                 X=(base + rng.normal(size=(12, 32, 3))).astype(np.float32),
                 fs=np.float32(128.0), ch_names=np.array(["AF3", "F7", "F3"]))
        np.savez(root / "runs" / f"posture{p}_{cond}" / "synthetic.npz",
                 X=(base + 0.5 + rng.normal(size=(12, 32, 3))).astype(np.float32))
    return root


@pytest.mark.parametrize("flags", [["--zooms", "--paired-legend"], ["--separate-legend"]])
def test_visualization_writes_the_jax_files(flags, runs, tmp_path, recorded, monkeypatch):
    common = ["--real_dir", str(runs / "real"), "--synth_dir", str(runs / "runs"),
              "--tsne_perplexity", "5", *flags]
    _script("visualization", [*common, "--out", str(tmp_path / "jax")], monkeypatch)
    viz_cli([*common, "--out", str(tmp_path / "port"), "--device", "cpu"])
    assert _pngs(tmp_path / "port") == _rel(recorded, tmp_path / "jax")


def test_plot_real_vs_synth_writes_the_jax_files(runs, tmp_path, recorded, monkeypatch):
    common = ["--real_dir", str(runs / "real"), "--synth_dir", str(runs / "runs"),
              "--n_samples", "2", "--fixed-trim", "4", "--no-auto-trim", "--first_k", "2"]
    _script("plot_real_vs_synth", [*common, "--out", str(tmp_path / "jax")], monkeypatch)
    traces_cli([*common, "--out", str(tmp_path / "port")])
    assert _pngs(tmp_path / "port") == _rel(recorded, tmp_path / "jax")
    assert len(recorded) == 6


def test_preprocessing_plots_write_the_jax_files(tmp_path, recorded, monkeypatch):
    csv = write_raw_tree(tmp_path / "raw", participants=1, postures=(2,), seconds=14.0,
                         extras=False)[0]
    _script("preprocessing_plots", ["--csv", str(csv), "--out", str(tmp_path / "jax")],
            monkeypatch)
    prep_cli(["--csv", str(csv), "--out", str(tmp_path / "port"), "--device", "cpu"])
    got = _pngs(tmp_path / "port")
    assert got == _rel(recorded, tmp_path / "jax") and len(got) == 23


def _write_v2_generator(path: Path, seed: int):
    hp = tcgan.CGANHParams(variant="v2", proj_scale=0.10)
    cfg = tcgan.build_cfg(hp, 2)
    G, bn = tcgan.generator_init(cfg, torch.Generator().manual_seed(seed), device="cpu")
    path.parent.mkdir(parents=True, exist_ok=True)
    save_checkpoint(path, {"model": tree_to_numpy(G), "bn": tree_to_numpy(bn)},
                    tcgan.generator_meta(hp, 2, path.parent.name))


def test_visualization_cgan_writes_the_jax_files(tmp_path, recorded, monkeypatch):
    """Postures 1 and 2 with both buckets and a v2 generator, posture 3
    without a generator (skipped by both). The JAX generator is stubbed by
    random windows of its shape: only the file names are compared."""
    data = tmp_path / "data"
    data.mkdir()
    rng = np.random.default_rng(1)
    for p in (1, 2, 3):
        for cond in ("no_exo", "with_exo"):
            np.savez(data / f"posture{p}_{cond}.npz",
                     X=rng.uniform(0, 1, (7, 768, 14)).astype(np.float32),
                     posture=np.int64(p), scale_min=np.zeros(14, np.float32),
                     scale_range=np.ones(14, np.float32),
                     ch_names=np.array([f"c{i}" for i in range(14)]), fs=np.float32(128.0))
    for p in (1, 2):
        _write_v2_generator(tmp_path / "runs" / f"posture{p}" /
                            f"CGAN_generator_posture{p}_best.npz", p)
    import eegsynth.train.cgan as jcgan
    monkeypatch.setattr(jcgan, "load_generator", lambda *a, **k: (None, None, None, None))
    monkeypatch.setattr(jcgan, "generate_batch", lambda G, bn, cfg, key, n, c:
                        rng.uniform(0, 1, (n, 14, 768)).astype(np.float32))
    common = ["--data-dir", str(data), "--runs-root", str(tmp_path / "runs"),
              "--postures", "1,2,3", "--tsne-perplexity", "5"]
    _script("visualization_cgan", [*common, "--out", str(tmp_path / "jax"), "--platform",
                                   "cpu"], monkeypatch)
    viz_cgan_cli([*common, "--out", str(tmp_path / "port"), "--device", "cpu"])
    got = _pngs(tmp_path / "port")
    assert got == _rel(recorded, tmp_path / "jax") and len(got) == 2 + 8


def _eval_corpus(n=40):
    rng = np.random.default_rng(2)
    R = rng.normal(size=(n, 24, 3)).astype(np.float32)
    F = rng.normal(size=(n, 24, 3)).astype(np.float32)
    labels = np.repeat([1, 2], n)
    labels = np.concatenate([labels[:n], labels[:n]])
    domain = np.array([1] * n + [0] * n)
    return R, F, labels, domain


@pytest.mark.parametrize("tsne_max", [None, 50])
def test_eval_figures_are_the_jax_files(tsne_max, tmp_path, recorded):
    from eegsynth.eval import drivers as jdrivers
    R, F, labels, domain = _eval_corpus()
    for d in ("jax", "port"):
        (tmp_path / d).mkdir()
    jdrivers.pca_tsne_plots(tmp_path / "jax", R, F, labels, domain, tsne_max)
    tdrivers.pca_tsne_plots(tmp_path / "port", R, F, labels, domain, tsne_max, device="cpu")
    assert _pngs(tmp_path / "port") == _rel(recorded, tmp_path / "jax")
    assert len(recorded) == 2


def test_eval_cli_passes_tsne_max(monkeypatch):
    seen = {}
    monkeypatch.setattr(tdrivers, "run_timegan_eval", lambda *a, **k: seen.update(k))
    tdrivers.main(["--by_condition", "--tsne_max", "6000", "--device", "cpu"])
    assert seen["tsne_max"] == 6000 and seen["by_condition"]


def test_eval_tsne_guard_skips_only_too_few_points(tmp_path, monkeypatch, capsys):
    R, F, labels, domain = _eval_corpus(n=10)          # 20 points < perplexity 30
    tdrivers.pca_tsne_plots(tmp_path, R, F, labels, domain, device="cpu")
    assert _pngs(tmp_path) == [Path("pca_global.png")]
    assert "t-SNE skipped" in capsys.readouterr().out
    for exc in (RuntimeError("CUDA error: an illegal memory access"),
                ValueError("not a perplexity problem")):
        def boom(*a, _exc=exc, **k):
            raise _exc
        monkeypatch.setattr(embed, "tsne", boom)
        R, F, labels, domain = _eval_corpus()
        with pytest.raises(type(exc), match=str(exc)):
            tdrivers.pca_tsne_plots(tmp_path, R, F, labels, domain, device="cpu")


def test_cgan_scatter_plots_are_the_jax_files(tmp_path, recorded):
    from eegsynth.eval import cgan_eval as jeval
    rng = np.random.default_rng(3)
    Xr = rng.normal(size=(27, 14, 96)).astype(np.float32)
    Xg = rng.normal(size=(27, 14, 96)).astype(np.float32)
    y = np.repeat(np.arange(1, 10), 3)
    for d in ("jax", "port"):
        (tmp_path / d).mkdir()
    jeval.scatter_plots(Xr, Xg, y, y, tmp_path / "jax", perplexity=10.0)
    teval.scatter_plots(Xr, Xg, y, y, tmp_path / "port", perplexity=10.0, device="cpu")
    got = _pngs(tmp_path / "port")
    assert got == _rel(recorded, tmp_path / "jax") and len(got) == 3
