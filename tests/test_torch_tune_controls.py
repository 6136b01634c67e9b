"""Per-bucket weight tuning and the discriminative-score controls of
eegsynth_torch, on the CPU at tiny widths, against the JAX scripts' numpy
protocol (no JAX program is compiled here).

- ``disc_controls``: the arms' pairs equal, bit for bit, those that
  ``scripts/disc_controls_timegan.py``'s numpy calls make from the same
  bucket and seed; the CLI writes ``controls.csv`` with the JAX header, one
  row per bucket, seed and arm, and each row's scores are the port's
  ``discriminative_scores_batch`` on those pairs (exact: the same calls);
- ``tune_bucket_weights``: the replica names, their copies, the stacked
  run's per-replica streams (two replicas of one candidate train apart),
  ``results.json`` against the port's statistics of each synthetic.npz
  (exact), the per-candidate median and the best-of-k selection against a
  numpy recomputation, and every replica's checkpoint read by the JAX
  package's loader into its own templates (strict).
"""

import json

import jax
import numpy as np
import pytest

from test_torch_threads import one_thread_each  # noqa: F401

from eegsynth.models.timegan import TimeGANConfig, timegan_init
from eegsynth.train import checkpoint as jck
from eegsynth.train import timegan as jtrain
from eegsynth_torch import tune_bucket_weights as tune
from eegsynth_torch.eval import disc_controls as dc
from eegsynth_torch.eval.classifiers import discriminative_scores_batch
from eegsynth_torch.eval.stats import statistical_similarity

T, C = 12, 5
GEN = ("generator", "supervisor", "embedder", "recovery")


def _bucket(path, n, seed):
    rng = np.random.default_rng(seed)
    np.savez(path, X=rng.uniform(0, 1, (n, T, C)).astype(np.float32),
             fs=np.float32(128.0))
    return path


def _jax_script_arms(X, sigmas, seed):
    """``scripts/disc_controls_timegan.py``'s arms of one bucket and seed,
    line for line."""
    N = len(X)
    arms = []
    for sig in sigmas:
        arms.append((f"noise_{sig:g}", None, sig))
    arms.append(("half", None, None))
    rng = np.random.default_rng(10_000 + seed)
    pairs, names = [], []
    for name, _, sig in arms:
        if name == "half":
            perm = rng.permutation(N)
            pairs.append((X[perm[: N // 2]], X[perm[N // 2:]]))
        else:
            fake = X + rng.normal(0.0, sig, X.shape).astype(np.float32)
            pairs.append((X, fake))
        names.append(name)
    return pairs, names


@pytest.mark.parametrize("sigmas,seed", [([0.001, 0.01], 0), ([0.05], 2)])
def test_control_pairs_match_the_jax_script(sigmas, seed):
    X = np.random.default_rng(seed).uniform(0, 1, (9, T, C)).astype(np.float32)
    got, names = dc.control_pairs(X, sigmas, seed)
    want, want_names = _jax_script_arms(X, sigmas, seed)
    assert names == want_names
    for (a, b), (c, d) in zip(got, want):
        np.testing.assert_array_equal(a, c)
        np.testing.assert_array_equal(b, d)


def test_disc_controls_cli_writes_the_csv(tmp_path, capsys):
    real = tmp_path / "real"
    real.mkdir()
    _bucket(real / "posture1_no_exo.npz", 8, 0)
    _bucket(real / "posture2_with_exo.npz", 6, 1)
    (real / "other.npz").write_bytes(b"")               # not a bucket: ignored
    rows = dc.main(["--real_dir", str(real), "--out", str(tmp_path / "out"),
                    "--sigmas", "0.01", "--seeds", "0", "1", "--epochs", "2",
                    "--device", "cpu"])
    lines = (tmp_path / "out" / "controls.csv").read_text().splitlines()
    assert lines[0] == "bucket,N,arm,seed,acc,auc" and len(lines) == 1 + 2 * 2 * 2
    assert [ln.split(",")[:4] for ln in lines[1:3]] == [
        ["posture1_no_exo", "8", "noise_0.01", "0"], ["posture1_no_exo", "8", "half", "0"]]
    with np.load(real / "posture2_with_exo.npz") as z:
        X = z["X"]
    pairs, _ = dc.control_pairs(X, [0.01], 1)
    want = discriminative_scores_batch(pairs, epochs=2, seed=1, device="cpu")
    assert [r[4:] for r in rows[-2:]] == [(float(a), float(u)) for a, u in want]
    assert all(0.0 <= r[4] <= 1.0 and 0.0 <= r[5] <= 1.0 for r in rows)
    table = dc.median_table(rows)
    assert table[("posture1_no_exo", 8)]["half"] == float(
        np.median([r[4] for r in rows if r[0] == "posture1_no_exo" and r[2] == "half"]))
    out = capsys.readouterr().out
    assert "noise_0.01" in out.splitlines()[-3] and "posture2_with_exo" in out


def test_tune_bucket_weights_cli(tmp_path):
    src = _bucket(tmp_path / "posture3_no_exo.npz", 6, 2)
    cfg = tmp_path / "cfg.json"
    cfg.write_text(json.dumps({"batch_size": 4, "ae_epochs": 1, "sup_epochs": 1,
                               "gan_steps": 2, "acf_max_lag": 4, "data_dir": "x"}))
    grid = [{}, {"gamma_acf": 0.5, "gamma_cov": 0.1}]
    out = tune.main(["--npz", str(src), "--out", str(tmp_path / "tune"),
                     "--grid", json.dumps(grid), "--replicas", "2", "--config",
                     str(cfg), "--metric", "psd", "--seed", "5", "--device", "cpu"])
    names = ["posture3_no_exo_c0r0", "posture3_no_exo_c0r1", "posture3_no_exo_c1r0",
             "posture3_no_exo_c1r1"]
    assert sorted(p.stem for p in (tmp_path / "tune" / "replicas_data").iterdir()) == names
    rows = json.loads((tmp_path / "tune" / "results.json").read_text())
    assert rows == out["rows"] and [r["name"] for r in rows] == names
    assert [(r["candidate"], r["replica"]) for r in rows] == [(0, 0), (0, 1), (1, 0),
                                                              (1, 1)]
    with np.load(src) as z:
        real = z["X"]
    runs = tmp_path / "tune" / "runs"
    fakes = []
    for r in rows:
        with np.load(runs / r["name"] / "synthetic.npz") as z:
            fakes.append(z["X"])
        psd, acf, coh = statistical_similarity(real, fakes[-1], 128.0, device="cpu")
        assert (r["psd"], r["acf"], r["coh"]) == (psd, acf, coh)
        assert r["overrides"] == grid[r["candidate"]]
    assert not np.array_equal(fakes[0], fakes[1])     # each replica its own stream
    psd = np.array([r["psd"] for r in rows]).reshape(2, 2)
    per, best = tune.select(rows, 2, "psd")
    np.testing.assert_array_equal([m for m, _ in per], np.median(psd, axis=1))
    assert best == rows[int(np.argmin(psd))] == out["best"]
    assert (runs / names[2] / "train_log.csv").read_text().count("\n") == 3

    with jax.enable_x64(False):
        template = timegan_init(jax.random.key(0), TimeGANConfig(x_dim=C, z_dim=16,
                                                                  h_dim=32))
        optD, optG = jtrain.make_gan_opts(jtrain.TimeGANHParams())
        templates = {"model": template,
                     "optG": optG.init({k: template[k] for k in GEN}),
                     "optD": optD.init(template["discriminator"])}
    for name in names:
        trees, meta = jck.load_checkpoint(runs / name / "ckpt_best.npz", templates)
        assert meta["npz"] == f"{name}.npz" and int(trees["optG"][1][0].count) == 2
