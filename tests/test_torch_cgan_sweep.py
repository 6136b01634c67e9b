"""The CGAN weight sweep of eegsynth_torch (``train/cgan_sweep.py``) and the
transformer's rematerialised discriminator blocks, on the CPU; no JAX
program is compiled here.

- ``weight_matrix`` against JAX's (numpy code: exact), its refusals too;
- a grid of two equal points: their generator files equal bit for bit, and
  a third point with other weights differs;
- each point's files as JAX writes them: ``hparams.json`` with the JAX
  keys, the best and last generators read by JAX's ``load_generator``;
- the CLI on a smoke set built from one bucket (``build_smoke_set``), conv
  and transformer with remat, scored into ``sweep_results.json``;
- ``tf_remat``: a transformer step with R1 firing equals the plain step bit
  for bit (the blocks recompute the same operations in the same order).

The transformer runs at dim 16, depth 1 or 2, 2 heads, patch 8, B 8.
"""

import dataclasses
import json

import jax
import numpy as np
import pytest
import torch

from test_torch_threads import one_thread_each  # noqa: F401

from eegsynth.train import cgan as J
from eegsynth.train.cgan_sweep import weight_matrix as jax_weight_matrix
from eegsynth_torch.data.datasets import build_label_table
from eegsynth_torch.train import cgan as P
from eegsynth_torch.train import cgan_sweep as S
from eegsynth_torch.tree import tree_leaves

T, C = 768, 14
TINY = dict(batch_size=8, arch="transformer", tf_dim=16, tf_depth=1, tf_heads=2)


def _write(root, n=3):
    data = root / "data"
    data.mkdir()
    rng = np.random.default_rng(0)
    for p in range(1, 10):
        np.savez(data / f"posture{p}_no_exo.npz",
                 X=rng.uniform(0, 1, (n, T, C)).astype(np.float32),
                 posture=np.int32(p), fs=np.float32(128.0),
                 scale_min=np.full(C, -2.0, np.float32),
                 scale_range=np.full(C, 4.0, np.float32),
                 ch_names=np.array([f"ch{i}" for i in range(C)]))
    return data


@pytest.mark.parametrize("variant,grid", [("v1", [{}, {"psd_weight": 4.0}]),
                                          ("v2", [{"amp_weight": 0.1, "fm_weight": 0}])])
def test_weight_matrix_matches_jax(variant, grid):
    got = S.weight_matrix(P.CGANHParams(variant=variant, coh_weight=0.3), grid)
    want = jax_weight_matrix(J.CGANHParams(variant=variant, coh_weight=0.3), grid)
    assert got.dtype == np.float32
    np.testing.assert_array_equal(got, want)


@pytest.mark.parametrize("grid,match", [([{"lr_g": 1.0}], "unsweepable"),
                                        ([{}, {"amp_weight": 0.5}], "amp_weight")])
def test_weight_matrix_refusals_match_jax(grid, match):
    for mod, fn in ((J, jax_weight_matrix), (P, S.weight_matrix)):
        with pytest.raises(ValueError, match=match):
            fn(mod.CGANHParams(), grid)


def _load(path):
    with np.load(path) as z:
        return {k: z[k] for k in z.files}


def test_sweep_points_and_their_files(tmp_path):
    data = _write(tmp_path)
    grid = [{}, {}, {"psd_weight": 3.0, "log_psd_weight": 0.5}]
    res = S.sweep_condition(data, tmp_path / "out", "no_exo", grid, device="cpu",
                            epochs=2, print_every=1, **TINY)
    assert [r["dir"] for r in res] == [str(tmp_path / "out" / f"sweep{i}")
                                       for i in range(3)]
    assert res[0]["best_g"] == res[1]["best_g"] != res[2]["best_g"]
    assert res[0]["last_g"] == res[1]["last_g"]
    assert res[2]["weights"]["psd_weight"] == 3.0
    for which in ("best", "last"):
        a, b, c = (_load(tmp_path / "out" / f"sweep{i}" /
                         f"CGAN_generator_sweep{i}_{which}.npz") for i in range(3))
        assert sorted(a) == sorted(b)
        assert all(np.array_equal(a[k], b[k]) for k in a if k != "__meta__")
        assert not all(np.array_equal(a[k], c[k]) for k in a if k != "__meta__")
    with jax.enable_x64(False):
        for i, overrides in enumerate(grid):
            d = tmp_path / "out" / f"sweep{i}"
            hp = json.loads((d / "hparams.json").read_text())
            assert hp["tag"] == f"sweep{i}" and hp["sweep_overrides"] == overrides
            assert set(hp) == {f.name for f in dataclasses.fields(J.CGANHParams)} | {
                "tag", "sweep_overrides"}
            for which in ("best", "last"):
                G, bn, cfg, meta = J.load_generator(
                    d / f"CGAN_generator_sweep{i}_{which}.npz")
                assert cfg.dim == 16 and meta["tag"] == f"sweep{i}"


def test_sweep_cli_on_a_smoke_set(tmp_path, monkeypatch):
    """``--smoke-from`` relabels one bucket as postures 1..9; conv (one point)
    and the transformer default with remat (two points), at a batch of 8
    and, for the transformer, dim 16."""
    src = tmp_path / "src"
    src.mkdir()
    rng = np.random.default_rng(2)
    np.savez(src / "posture4_no_exo.npz", X=rng.uniform(0, 1, (2, T, C)).astype(np.float32),
             posture=np.int32(4), fs=np.float32(128.0),
             scale_min=np.zeros(C, np.float32), scale_range=np.ones(C, np.float32),
             ch_names=np.array([f"ch{i}" for i in range(C)]))
    built = S.build_smoke_set(src, "no_exo", tmp_path / "smoke")
    for p in range(1, 10):
        with np.load(built / f"posture{p}_no_exo.npz") as z:
            assert int(z["posture"]) == p and z["X"].shape == (2, T, C)
    seen = {}
    sweep = S.sweep_condition

    def small(*args, **kw):
        seen.update(kw)
        return sweep(*args, **{**kw, "batch_size": 8, "tf_dim": 16, "tf_depth": 1,
                               "tf_heads": 2})

    monkeypatch.setattr(S, "sweep_condition", small)
    cli = ["--smoke-from", str(src), "--epochs", "1", "--samples-per-posture", "3",
           "--device", "cpu"]
    res = S.main([*cli, "--out", str(tmp_path / "tf"), "--grid", '[{}, {"fm_weight": 1}]'])
    assert seen["arch"] == "transformer" and seen["tf_remat"] is True
    saved = json.loads((tmp_path / "tf" / "sweep_results.json").read_text())
    assert saved == json.loads(json.dumps(res)) and len(saved) == 2
    for r in saved:
        assert r["stats"]["level"] == "global" and r["disc"]["level"] == "global"
        assert np.isfinite([r["stats"]["psd_l1"], r["disc"]["acc"]]).all()
        d = tmp_path / "tf" / f"sweep{saved.index(r)}"
        assert (d / "stats_similarity.csv").exists()
        assert (d / "metrics_discriminative.csv").exists()
    S.main([*cli, "--out", str(tmp_path / "conv"), "--grid", "[{}]", "--arch", "conv"])
    assert seen["arch"] == "conv" and seen["tf_remat"] is False
    hp = json.loads((tmp_path / "conv" / "sweep0" / "hparams.json").read_text())
    assert hp["arch"] == "conv" and not hp["tf_remat"]


@pytest.mark.parametrize("variant", ["v1", "v2"])
def test_remat_step_equals_the_plain_step(variant):
    """One step with R1 firing (``step_idx`` 0) at depth 2: every output of
    the remat step equals the plain step's bit for bit."""
    K, base = (9, 1) if variant == "v1" else (2, 0)
    over = {**(P.V2_OVERRIDES if variant == "v2" else {}), **TINY, "tf_depth": 2,
            "variant": variant}
    rng = np.random.default_rng(0)
    X = torch.from_numpy(rng.uniform(0, 1, (2 * K, C, T)).astype(np.float32))
    tab, cnt = build_label_table(np.repeat(np.arange(base, base + K), 2), K, base)
    outs = []
    for remat in (False, True):
        hp = P.CGANHParams(**over, tf_remat=remat)
        cfg = P.build_cfg(hp, K)
        assert cfg.remat is remat
        g = torch.Generator().manual_seed(3)
        G, bn = P.generator_init(cfg, g, device="cpu")
        D = {k: P.disc_init(cfg, g, device="cpu") for k in ("dg", "dl")}
        draws = P.draw_cgan_step(torch.Generator().manual_seed(4), hp, cfg,
                                 torch.from_numpy(tab.astype(np.int64)),
                                 torch.from_numpy(cnt.astype(np.float32)),
                                 prewarm=False, device="cpu")
        optG, optD = P.Adam(hp.lr_g, hp.beta1, hp.beta2), P.Adam(hp.lr_d, hp.beta1, hp.beta2)
        outs.append(P.cgan_step(G, bn, D, G, optG.init(G), optD.init(D), X, draws, 0,
                                0.1, cfg=cfg, hp=hp, optG=optG, optD=optD,
                                prewarm=False))
    (G0, _, D0, e0, g0, d0, l0), (G1, _, D1, e1, g1, d1, l1) = outs
    assert torch.equal(l0, l1) and l0[9] != 0
    for a, b in zip(tree_leaves((G0, D0, e0, g0.mu, d0.mu, d0.nu)),
                    tree_leaves((G1, D1, e1, g1.mu, d1.mu, d1.nu))):
        assert torch.equal(a, b)

