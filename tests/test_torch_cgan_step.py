"""One transformer-CGAN step of eegsynth_torch against
``make_cgan_epoch(..., 1, ...)`` of eegsynth, on JAX's replayed draws: v2
(condition-conditional, dropout on the head features, 24 random coherence
pairs, amplitude calibration) with and without prewarm, and the wgan-gp
objective with its gradient penalty. The helpers and tolerances are those of
``test_torch_cgan_train.py``. Then the port's R1 schedule on the step index,
the datasets' row order against JAX's, and the v2 training loop's prewarm epoch.
"""

import json

import numpy as np
import pytest
import torch

from test_torch_cgan_train import check_step, run_step_pair

from eegsynth_torch.train import cgan as P


@pytest.mark.parametrize("prewarm", [True, False])
def test_v2_step_matches_jax(prewarm):
    """A prewarm step updates no D (its logs are 0, its u still advances in
    the G step) and has no adversarial G loss."""
    got, want, hp = run_step_pair("v2", prewarm=prewarm)
    check_step(got, want, hp)
    logs = got[-1]
    if prewarm:
        assert torch.count_nonzero(logs[:8]) == 0 and logs[9] == 0


def test_wgan_gp_step_matches_jax():
    got, want, hp = run_step_pair("v1", gan_loss="wgan-gp")
    assert hp.r1_gamma == 0.0                   # GP replaces R1 by default
    check_step(got, want, hp)


def test_r1_fires_on_the_step_index_within_the_epoch():
    """step_idx % r1_every == 0 adds R1; any other index gives the step of
    r1_gamma = 0 exactly."""
    hp = P.CGANHParams(batch_size=4, arch="transformer", tf_dim=16, tf_depth=1,
                       tf_heads=2)
    cfg = P.build_cfg(hp, 9)
    X = torch.rand((18, 14, 768), generator=torch.Generator().manual_seed(0))
    table = torch.arange(18).reshape(9, 2)
    counts = torch.full((9,), 2.0)

    def step(step_idx, r1_gamma):
        h = P.CGANHParams(**{**vars(hp), "r1_gamma": r1_gamma})
        G, bn = P.generator_init(cfg, torch.Generator().manual_seed(1), device="cpu")
        D = {k: P.disc_init(cfg, torch.Generator().manual_seed(i), device="cpu")
             for i, k in enumerate(("dg", "dl"))}
        oG, oD = P.Adam(h.lr_g, h.beta1, h.beta2), P.Adam(h.lr_d, h.beta1, h.beta2)
        draws = P.draw_cgan_step(torch.Generator().manual_seed(2), h, cfg, table,
                                 counts, prewarm=False, device="cpu")
        return P.cgan_step(G, bn, D, G, oG.init(G), oD.init(D), X, draws, step_idx,
                           0.1, cfg=cfg, hp=h, optG=oG, optD=oD, prewarm=False)[-1]

    off = step(0, 0.0)
    assert torch.equal(step(3, 0.5), off) and torch.equal(step(9, 0.5), off)
    assert not np.isclose(step(8, 0.5)[9].item(), off[9].item(), rtol=0, atol=0)


def _buckets(root, n_no, n_with):
    rng = np.random.default_rng(0)
    for posture in (1, 2):
        for cond, n in (("no_exo", n_no), ("with_exo", n_with)):
            np.savez(root / f"posture{posture}_{cond}.npz",
                     X=rng.uniform(0, 1, (n, 768, 14)).astype(np.float32),
                     posture=np.int32(posture), fs=np.float32(128.0),
                     scale_min=np.zeros(14, np.float32),
                     scale_range=np.ones(14, np.float32),
                     ch_names=np.array([f"ch{i}" for i in range(14)]))


def test_datasets_match_jax(tmp_path):
    """The same rows in the same order after np.random.seed, and the same
    balanced-sampling table."""
    from eegsynth.data import datasets as jd
    from eegsynth_torch.data import datasets as pd

    _buckets(tmp_path, 5, 3)
    for load, arg in (("load_condition_dataset", "no_exo"),
                      ("load_posture_both_conditions", 2)):
        np.random.seed(7)
        X_j, y_j, _ = getattr(jd, load)(tmp_path, arg)
        np.random.seed(7)
        X_p, y_p, meta = getattr(pd, load)(tmp_path, arg)
        np.testing.assert_array_equal(X_p, X_j)
        np.testing.assert_array_equal(y_p, y_j)
        assert X_p.shape[1:] == (14, 768) and meta
    for got, want in zip(pd.build_label_table(y_p, 2, 0), jd.build_label_table(y_j, 2, 0)):
        np.testing.assert_array_equal(got, want)
    with pytest.raises(SystemExit):
        pd.build_label_table(np.zeros(3, np.int64), 2, 0)


def test_train_one_posture_prewarm_epoch(tmp_path):
    """v2: the prewarm epoch updates no D (its diagnostics and D loss are 0)
    and is not a best candidate; the adversarial epoch is."""
    _buckets(tmp_path, 4, 4)
    res = P.train_one_posture(tmp_path, tmp_path / "runs", 2, device="cpu",
                              arch="transformer", tf_dim=16, tf_depth=1, tf_heads=2,
                              batch_size=8, prewarm=1, epochs=1, save_every=100)
    run = tmp_path / "runs" / "posture2"
    lines = (run / "metrics.csv").read_text().splitlines()
    assert lines[0] + "\n" == P.METRICS_HEADER_V2 and len(lines) == 3
    first = [float(v) for v in lines[1].split(",")]
    assert first[0] == 1 and first[2] == 0.0 and not any(first[3:])
    second = [float(v) for v in lines[2].split(",")]
    assert res["best_g"] == second[1] and (run / "CGAN_generator_posture2_best.npz").exists()
    assert res["d_state"].count == 1 and res["g_state"].count == 2
    meta = json.loads((run / "hparams.json").read_text())
    assert meta["variant"] == "v2" and meta["tag"] == "posture2"
