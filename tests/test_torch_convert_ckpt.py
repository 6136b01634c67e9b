"""eegsynth_torch.convert_torch_ckpt against scripts/convert_torch_ckpt.py.

Both converters run on the same random reference-shaped state_dicts saved
as .pt / .pth files: TimeGAN at one and two layers, conv CGAN generators
(v1 and v2, with the reference loader's legacy keys) and discriminators.
Their NPZ files hold the same keys and bit-identical arrays, and the same
meta. ``--reverse`` round-trips bit for bit and writes what the JAX
script's reverse writes. A converted TimeGAN synthesizes, through the
port's model, within 1e-5 of JAX's synthesis from JAX's converted NPZ on
the same noise (float32 sums in another order over 32 steps).
"""

import json
import sys
from pathlib import Path

import jax
import numpy as np
import pytest
import torch

from test_torch_threads import one_thread_each  # noqa: F401

sys.path.insert(0, str(Path(__file__).resolve().parent.parent / "scripts"))

import convert_torch_ckpt as jax_conv  # noqa: E402
from eegsynth.models import timegan as jtg  # noqa: E402
from eegsynth.train import checkpoint as jax_ckpt  # noqa: E402
from eegsynth.train.timegan import synthesize as jax_synthesize  # noqa: E402
from eegsynth_torch import convert_torch_ckpt as conv  # noqa: E402
from eegsynth_torch.convert import from_jax_params  # noqa: E402
from eegsynth_torch.models.timegan import TimeGAN, TimeGANConfig  # noqa: E402
from eegsynth_torch.train.cgan import load_generator  # noqa: E402
from eegsynth_torch.train.checkpoint import load_checkpoint  # noqa: E402
from eegsynth_torch.train.timegan import synthesize_from_noise  # noqa: E402

SYNTH_TOL = 1e-5
K, NOISE = 9, 100


def _jax_cli(args: list) -> None:
    """scripts/convert_torch_ckpt.py's main() on ``args`` (it reads
    sys.argv), float32 as the script runs it."""
    saved = sys.argv
    sys.argv = ["convert_torch_ckpt.py", *map(str, args)]
    try:
        with jax.enable_x64(False):
            jax_conv.main()
    finally:
        sys.argv = saved


def _timegan_sd(layers: int, seed: int) -> dict:
    """A reference TimeGAN state_dict (the port's module names the arrays as
    the reference does), with nonzero biases."""
    cfg = TimeGANConfig(x_dim=3, z_dim=8, h_dim=12, num_layers=layers)
    sd = TimeGAN(cfg, generator=torch.Generator().manual_seed(seed), device="cpu").state_dict()
    g = torch.Generator().manual_seed(seed + 100)
    return {k: (v + 0.05 * torch.randn(v.shape, generator=g) if "bias" in k else v)
            for k, v in sd.items()}


def _save_timegan(root: Path, sd: dict, name: str, step: int) -> Path:
    path = root / name
    path.parent.mkdir(parents=True, exist_ok=True)
    torch.save({"step": step, "model": sd, "optG": {}, "optD": {},
                "meta": {"npz": "posture1_no_exo.npz", "z_dim": 8, "h_dim": 12}}, path)
    return path


def _gen_sd(num_classes: int, seed: int, legacy: bool) -> dict:
    """A reference conv generator's state_dict at full width; ``legacy``
    names it as older checkpoints do (u<i>., out., .cbn.emb.)."""
    g = torch.Generator().manual_seed(seed)
    chans = (512, 256, 128, 64, 32, 16)
    sd = {"proj.weight": torch.randn(512 * 24, NOISE + num_classes, generator=g) * 0.05,
          "proj.bias": torch.randn(512 * 24, generator=g) * 0.05}
    for i in range(1, 6):
        ci, co = chans[i - 1], chans[i]
        up, emb = (f"u{i}", "emb") if legacy else (f"up{i}", "embed")
        sd[f"{up}.conv.weight"] = torch.randn(co, ci, 3, generator=g) * 0.05
        sd[f"{up}.conv.bias"] = torch.randn(co, generator=g) * 0.05
        sd[f"{up}.cbn.{emb}.weight"] = torch.cat(
            [1 + 0.1 * torch.randn(num_classes, co, generator=g),
             0.1 * torch.randn(num_classes, co, generator=g)], dim=1)
        sd[f"{up}.cbn.bn.running_mean"] = 0.1 * torch.randn(co, generator=g)
        sd[f"{up}.cbn.bn.running_var"] = 1 + 0.3 * torch.rand(co, generator=g)
        sd[f"{up}.cbn.bn.num_batches_tracked"] = torch.tensor(7)
    out = "out" if legacy else "to_out"
    sd[f"{out}.weight"] = torch.randn(14, 16, 3, generator=g) * 0.05
    sd[f"{out}.bias"] = torch.randn(14, generator=g) * 0.05
    return sd


def _disc_sd(num_classes: int, seed: int) -> dict:
    g = torch.Generator().manual_seed(seed)
    sd = {}
    chans = (14, 32, 64, 128, 256, 512)
    for i in range(1, 6):
        sd[f"c{i}.weight_orig"] = torch.randn(chans[i], chans[i - 1], 5, generator=g)
        sd[f"c{i}.bias"] = torch.randn(chans[i], generator=g)
        sd[f"c{i}.weight_u"] = torch.randn(chans[i], generator=g)
        sd[f"c{i}.weight_v"] = torch.randn(chans[i - 1] * 5, generator=g)
    for head, out in (("fc", 1), ("cls", num_classes)):
        sd[f"{head}.weight_orig"] = torch.randn(out, 513, generator=g)
        sd[f"{head}.bias"] = torch.randn(out, generator=g)
        sd[f"{head}.weight_u"] = torch.randn(out, generator=g)
    sd["embed.weight"] = torch.randn(num_classes, 512, generator=g)
    sd["std_weight"] = torch.randn(1, generator=g)
    return sd


def _assert_same_npz(a: Path, b: Path) -> None:
    with np.load(a) as x, np.load(b) as y:
        assert sorted(x.files) == sorted(y.files)
        for k in x.files:
            if k == "__meta__":
                continue
            assert x[k].dtype == y[k].dtype and x[k].shape == y[k].shape, k
            assert np.array_equal(x[k], y[k]), k
        assert json.loads(bytes(x["__meta__"])) == json.loads(bytes(y["__meta__"]))


@pytest.fixture(scope="module")
def timegan_runs(tmp_path_factory):
    """A reference runs dir of two TimeGAN runs (1 and 2 layers), converted
    by both packages' CLIs."""
    root = tmp_path_factory.mktemp("tg")
    ref = root / "ref"
    for i, (run, layers) in enumerate((("posture1_no_exo", 1), ("posture2_with_exo", 2))):
        sd = _timegan_sd(layers, seed=i)
        _save_timegan(ref, sd, f"{run}/ckpt_best.pt", step=10 + i)
        _save_timegan(ref, sd, f"{run}/ckpt_latest.pt", step=20 + i)
    (ref / "not_a_run").mkdir()
    conv.main(["--runs_dir", str(ref), "--out_dir", str(root / "ours")])
    _jax_cli(["--runs_dir", ref, "--out_dir", root / "theirs"])
    return root


@pytest.mark.parametrize("run", ["posture1_no_exo", "posture2_with_exo"])
@pytest.mark.parametrize("which", ["ckpt_best", "ckpt_latest"])
def test_timegan_npz_equals_jax_script(timegan_runs, run, which):
    _assert_same_npz(timegan_runs / "ours" / run / f"{which}.npz",
                     timegan_runs / "theirs" / run / f"{which}.npz")


def test_timegan_reverse_round_trips_and_equals_jax_reverse(timegan_runs):
    root = timegan_runs
    conv.main(["--reverse", "--runs_dir", str(root / "ours"),
               "--out_dir", str(root / "ours_pt"), "--which", "latest"])
    _jax_cli(["--reverse", "--runs_dir", root / "ours", "--out_dir", root / "theirs_pt",
              "--which", "latest"])
    for run in ("posture1_no_exo", "posture2_with_exo"):
        ref = torch.load(root / "ref" / run / "ckpt_latest.pt", weights_only=True)
        ours = torch.load(root / "ours_pt" / run / "ckpt_latest.pt", weights_only=True)
        theirs = torch.load(root / "theirs_pt" / run / "ckpt_latest.pt", weights_only=True)
        assert ours["step"] == theirs["step"] == ref["step"]
        assert ours["meta"] == theirs["meta"] and ours["optG"] == ours["optD"] == {}
        assert sorted(ours["model"]) == sorted(theirs["model"])
        for k, v in ours["model"].items():
            assert torch.equal(v, theirs["model"][k]), k
            if k in ref["model"]:
                assert torch.equal(v, ref["model"][k]), k
        # the round trip back to NPZ is the same file's arrays
        conv.convert_file(root / "ours_pt" / run / "ckpt_latest.pt",
                          root / f"{run}_again.npz")
        again, _ = load_checkpoint(root / f"{run}_again.npz")
        first, _ = load_checkpoint(root / "ours" / run / "ckpt_latest.npz")
        assert jax.tree.all(jax.tree.map(np.array_equal, again, first))


def test_converted_timegan_synthesizes_as_jax(timegan_runs):
    """The port's model from the port's NPZ against JAX's synthesize from
    JAX's NPZ, on JAX's noise."""
    path = timegan_runs / "theirs" / "posture1_no_exo" / "ckpt_latest.npz"
    cfg = jtg.TimeGANConfig(x_dim=3, z_dim=8, h_dim=12)
    key = jax.random.key(4)
    with jax.enable_x64(False):
        template = jtg.timegan_init(jax.random.key(0), cfg)
        trees, _ = jax_ckpt.load_checkpoint(path, {"model": template})
        ref = np.asarray(jax_synthesize(trees["model"], cfg, key, 4, 32))
        z = np.asarray(jtg.sample_noise(key, 4, 32, cfg.z_dim))
    ours, _ = load_checkpoint(timegan_runs / "ours" / "posture1_no_exo" / "ckpt_latest.npz")
    model = from_jax_params(ours["model"], device="cpu").eval()
    with torch.inference_mode():
        x = synthesize_from_noise(model, torch.from_numpy(z.copy()))[0].numpy()
    assert x.shape == ref.shape == (4, 32, 3)
    assert np.abs(x - ref).max() <= SYNTH_TOL


@pytest.fixture(scope="module")
def cgan_runs(tmp_path_factory):
    """Reference CGAN runs: v1 (no_exo, 9 classes, legacy keys), v2
    (posture3, 2 classes), the discriminators, a legacy MLP-era file the
    converters skip; converted by both CLIs."""
    root = tmp_path_factory.mktemp("cg")
    ref = root / "ref"
    files = {"no_exo/CGAN_generator_no_exo_best.pth": _gen_sd(K, 0, legacy=True),
             "no_exo/CGAN_globalD_no_exo_best.pth": _disc_sd(K, 1),
             "posture3/CGAN_generator_posture3_epoch5.pth": _gen_sd(2, 2, legacy=False),
             "posture3/CGAN_localD_posture3_best.pth": _disc_sd(2, 3),
             "no_exo/CGAN_discriminator_legacy.pth": {"w": torch.zeros(2)}}
    for name, sd in files.items():
        (ref / name).parent.mkdir(parents=True, exist_ok=True)
        torch.save(sd, ref / name)
    conv.main(["--family", "cgan", "--runs_dir", str(ref), "--out_dir", str(root / "ours")])
    _jax_cli(["--family", "cgan", "--runs_dir", ref, "--out_dir", root / "theirs"])
    return root


@pytest.mark.parametrize("name", ["no_exo/CGAN_generator_no_exo_best",
                                  "no_exo/CGAN_globalD_no_exo_best",
                                  "posture3/CGAN_generator_posture3_epoch5",
                                  "posture3/CGAN_localD_posture3_best"])
def test_cgan_npz_equals_jax_script(cgan_runs, name):
    _assert_same_npz(cgan_runs / "ours" / f"{name}.npz",
                     cgan_runs / "theirs" / f"{name}.npz")


def test_cgan_variants_and_skips(cgan_runs):
    ours = cgan_runs / "ours"
    assert not (ours / "no_exo" / "CGAN_discriminator_legacy.npz").exists()
    for name, variant, classes in (("no_exo/CGAN_generator_no_exo_best", "v1", K),
                                   ("posture3/CGAN_generator_posture3_epoch5", "v2", 2)):
        G, bn, cfg, meta = load_generator(ours / f"{name}.npz", device="cpu")
        assert (meta["variant"], meta["num_classes"], cfg.num_classes) == \
            (variant, classes, classes)


def test_cgan_reverse_round_trips_and_equals_jax_reverse(cgan_runs):
    root = cgan_runs
    conv.main(["--reverse", "--family", "cgan", "--runs_dir", str(root / "ours"),
               "--out_dir", str(root / "ours_pth")])
    _jax_cli(["--reverse", "--family", "cgan", "--runs_dir", root / "ours",
              "--out_dir", root / "theirs_pth"])
    for name in ("no_exo/CGAN_generator_no_exo_best",
                 "posture3/CGAN_generator_posture3_epoch5"):
        ours = torch.load(root / "ours_pth" / f"{name}.pth", weights_only=True)
        theirs = torch.load(root / "theirs_pth" / f"{name}.pth", weights_only=True)
        ref = conv._legacy_cgan_renames(torch.load(root / "ref" / f"{name}.pth",
                                                   weights_only=True))
        assert sorted(ours) == sorted(theirs) == sorted(ref)
        for k, v in ours.items():
            assert torch.equal(v, theirs[k]), k
            if "num_batches_tracked" not in k:
                assert torch.equal(v, ref[k]), k
