"""The port's small tools on the CPU: ``eegsynth_torch.check_shape`` prints
what ``scripts/check_shape.py`` prints; ``tools.bench_serve.run_load``
(and the JAX script's own load client) drive the port's CPU server with
the hung half-open client held open, with 0 errors; the CLI's plans and
warm-up; ``tools.bench_synthesis``'s parity holds on the CPU (its asserts
at 5e-5 f32 and 5e-2 bf16) and its rows run; ``tools.bench_kernels``'
sweep prints its columns.
"""

import subprocess
import sys
import threading
from pathlib import Path

import numpy as np
import pytest
import torch

from eegsynth_torch import check_shape
from eegsynth_torch.convert import to_jax_params
from eegsynth_torch.models.timegan import TimeGAN, TimeGANConfig
from eegsynth_torch.serve import ModelRegistry, make_server
from eegsynth_torch.tools import bench_kernels, bench_serve, bench_synthesis
from eegsynth_torch.train.checkpoint import save_checkpoint
from test_torch_threads import one_thread_each  # noqa: F401

REPO = Path(__file__).resolve().parent.parent
SCRIPTS = REPO / "scripts"
RUNS = ("posture1_no_exo", "posture2_with_exo")


def test_check_shape_prints_what_the_jax_script_prints(tmp_path, capsys, monkeypatch):
    a, b = tmp_path / "real.npz", tmp_path / "synth.npz"
    np.savez(a, X=np.zeros((3, 8, 2), np.float32), fs=np.float32(128.0),
             ch_names=np.array(["AF3", "F7"]), posture=np.int64(2))
    np.savez_compressed(b, X=np.ones((4, 16, 2), np.float64))
    theirs = subprocess.run([sys.executable, str(SCRIPTS / "check_shape.py"), str(a), str(b)],
                            capture_output=True, text=True, timeout=60, check=True).stdout
    check_shape.main([str(a), str(b)])
    assert capsys.readouterr().out == theirs
    # the default path, from a directory that holds it
    (tmp_path / "preprocessed").mkdir()
    np.savez(tmp_path / "preprocessed" / "posture1_no_exo.npz", X=np.zeros((1, 2, 3)))
    theirs = subprocess.run([sys.executable, str(SCRIPTS / "check_shape.py")], cwd=tmp_path,
                            capture_output=True, text=True, timeout=60, check=True).stdout
    monkeypatch.chdir(tmp_path)
    check_shape.main([])
    assert capsys.readouterr().out == theirs


@pytest.fixture(scope="module")
def server(tmp_path_factory):
    """The port's server on the CPU over two tiny TimeGAN runs."""
    root = tmp_path_factory.mktemp("serve")
    runs, real = root / "runs", root / "real"
    real.mkdir()
    cfg = TimeGANConfig(x_dim=3, z_dim=8, h_dim=12)
    for i, name in enumerate(RUNS):
        (runs / name).mkdir(parents=True)
        model = TimeGAN(cfg, generator=torch.Generator().manual_seed(i), device="cpu")
        save_checkpoint(runs / name / "ckpt_best.npz", {"model": to_jax_params(model)},
                        {"npz": f"{name}.npz", "z_dim": 8, "h_dim": 12, "step": 1})
        np.savez(real / f"{name}.npz", X=np.random.default_rng(i).uniform(
            0, 1, (4, 32, 3)).astype(np.float32), fs=np.float32(128.0))
    srv = make_server(ModelRegistry(runs, real, False, device="cpu"), "127.0.0.1", 0,
                      8, 32)
    threading.Thread(target=srv.serve_forever, daemon=True).start()
    yield srv.server_address
    srv.shutdown()
    srv.server_close()


def test_run_load_with_the_hung_client(server):
    host, port = server
    plans = bench_serve.plans_from(",".join(RUNS), "", 4, 32)
    out = bench_serve.run_load(host, port, plans, clients=2, seconds=1.5, hold_hung=True)
    assert out["errors"] == 0 and out["requests"] >= 2
    assert out["p50_ms"] <= out["p95_ms"] <= out["p99_ms"] <= out["max_ms"]
    assert out["windows_per_s"] > 0


def test_run_load_reports_what_the_jax_client_reports(server):
    """The JAX script's load client against the same server: the same keys."""
    sys.path.insert(0, str(SCRIPTS))
    try:
        import bench_serve as jax_bench_serve
    finally:
        sys.path.remove(str(SCRIPTS))
    host, port = server
    plans = bench_serve.plans_from(RUNS[0], "", 4, 32)
    theirs = jax_bench_serve.run_load(host, port, plans, 1, 0.5, hold_hung=True)
    ours = bench_serve.run_load(host, port, plans, 1, 0.5, hold_hung=True)
    assert sorted(ours) == sorted(theirs)
    assert ours["errors"] == theirs["errors"] == 0


def test_bench_serve_cli(server, tmp_path, capsys):
    host, port = server
    out = bench_serve.main(["--host", host, "--port", str(port), "--clients", "2",
                            "--seconds", "1", "--n", "4", "--seq-len", "32",
                            "--timegan-runs", RUNS[1],
                            "--json-out", str(tmp_path / "load.json")])
    assert out["errors"] == 0 and (tmp_path / "load.json").exists()
    assert "warmed /synthesize posture2_with_exo -> 200" in capsys.readouterr().out
    with pytest.raises(SystemExit, match="at least one"):
        bench_serve.main(["--port", str(port)])


@pytest.mark.parametrize("precision", ["f32", "bf16"])
def test_bench_synthesis_parity_on_the_cpu(precision, capsys):
    bench_synthesis.main(["--parity", "--batch", "4", "--T", "48", "--time_chunk", "16",
                          "--precision", precision, "--device", "cpu"])
    assert f"chunk=16 {precision}: max|oneshot-chunked|=" in capsys.readouterr().out


def test_bench_synthesis_rows(capsys):
    bench_synthesis.main(["--batch", "2", "--T", "24", "--time_chunk", "8", "--iters", "1",
                          "--model", "timegan", "--device", "cpu"])
    out = capsys.readouterr().out
    assert "timegan synth  batch=    2 T=24 f32:" in out
    assert "timegan stream batch=    2 T=24 chunk=8 f32:" in out


@pytest.mark.parametrize("backward", [False, True])
def test_bench_kernels_sweep(backward, capsys):
    rows = bench_kernels.main(["--hs", "4,9", "--batch", "2", "--seq", "6", "--iters", "1",
                               "--device", "cpu"] + (["--backward"] if backward else []))
    assert [r["H"] for r in rows] == [4, 9]
    assert all(r[k] > 0 for r in rows for k in ("plain", "k1", "cudnn"))
    assert "plain ms" in capsys.readouterr().out
