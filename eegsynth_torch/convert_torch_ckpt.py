"""Convert reference PyTorch checkpoints (TimeGAN and CGAN) to the NPZ
checkpoints both packages share, and back: the CLI of
``scripts/convert_torch_ckpt.py``.

    python -m eegsynth_torch.convert_torch_ckpt --runs_dir <reference timegan_runs> \\
        --out_dir ./timegan_runs_converted [--which best|latest|both]
    python -m eegsynth_torch.convert_torch_ckpt --family cgan \\
        --runs_dir <reference cgan_runs> --out_dir ./cgan_runs_converted
    python -m eegsynth_torch.convert_torch_ckpt --reverse --runs_dir ./timegan_runs \\
        --out_dir ./timegan_runs_torch [--which latest]
    python -m eegsynth_torch.convert_torch_ckpt --reverse --family cgan \\
        --runs_dir ./cgan_runs --out_dir ./cgan_runs_torch

TimeGAN: the reference saves ``{"step", "model", "optG", "optD", "meta"}``
per run dir (``ckpt_best.pt`` / ``ckpt_latest.pt``). The weight layouts are
torch's in both packages, so converting is a key remap:

    <net>.rnn.rnn.{weight_ih_lK, weight_hh_lK, bias_*}  ->  <net>.gru[K].{w_ih,...}
    recovery.out.{weight,bias}                          ->  recovery.out.{w,b}
    {generator,supervisor}.proj.{weight,bias}           ->  ....proj.{w,b}
    discriminator.fc.{weight_orig,bias,weight_u}        ->  discriminator.fc.{w,b,u}

A converted run serves through ``eegsynth_torch.serve`` and
``eegsynth_torch.generate_long_synth`` as a trained one does.

CGAN (``--family cgan``): bare generator / discriminator state_dicts named
``CGAN_generator_<tag>_{best,epochN,last}.pth`` and
``CGAN_{globalD,localD}_<tag>_best.pth`` under ``<runs>/<tag>/`` (tag = the
condition for v1, ``posture<p>`` for v2), mapped onto the conv CGAN's
parameters after the reference loader's legacy renames (``u<i>.`` ->
``up<i>.``, ``out.`` -> ``to_out.``, ``.cbn.emb.`` -> ``.cbn.embed.``). A
converted generator loads through ``eegsynth_torch.train.cgan.load_generator``.

Optimizer state is not converted: the checkpoints are for synthesis and
evaluation. ``--reverse`` writes the port's NPZ checkpoints in the
reference's formats: TimeGAN ``ckpt_*.pt`` (optimizers empty) and conv
generator ``.pth`` state_dicts. It reads NPZ only (Orbax checkpoint
directories are not read by this package). Weights are read with
``torch.load(weights_only=True)``; a TimeGAN payload whose meta needs the
full unpickler falls back to it.
"""

from __future__ import annotations

import argparse
import re
from pathlib import Path

import numpy as np
import torch

from eegsynth_torch.convert import NETS, tree_to_numpy
from eegsynth_torch.train.checkpoint import (
    find_checkpoint, load_checkpoint, load_meta, save_checkpoint,
)

RUN_RE = re.compile(r"posture\d+_(with_exo|no_exo)$")


def _arr(t) -> np.ndarray:
    return np.asarray(t.detach().cpu().numpy() if hasattr(t, "detach") else t,
                      dtype=np.float32)


def convert_timegan_model(torch_model: dict) -> dict:
    """Reference TimeGAN state_dict (tensors or arrays) → the shared params
    tree (numpy float32)."""
    params: dict = {}
    for net in NETS:
        pref = f"{net}.rnn.rnn."
        layers = []
        for k in range(64):
            if f"{pref}weight_ih_l{k}" not in torch_model:
                break
            layers.append({
                "w_ih": _arr(torch_model[f"{pref}weight_ih_l{k}"]),
                "w_hh": _arr(torch_model[f"{pref}weight_hh_l{k}"]),
                "b_ih": _arr(torch_model[f"{pref}bias_ih_l{k}"]),
                "b_hh": _arr(torch_model[f"{pref}bias_hh_l{k}"]),
            })
        if not layers:
            raise KeyError(f"no GRU weights found for net '{net}'")
        params[net] = {"gru": layers}
    params["recovery"]["out"] = {"w": _arr(torch_model["recovery.out.weight"]),
                                 "b": _arr(torch_model["recovery.out.bias"])}
    for net in ("generator", "supervisor"):
        wk = f"{net}.proj.weight"
        params[net]["proj"] = ({"w": _arr(torch_model[wk]),
                                "b": _arr(torch_model[f"{net}.proj.bias"])}
                               if wk in torch_model else None)
    # spectral norm's v is re-derived from (W, u) when the layer is applied
    params["discriminator"]["fc"] = {
        "w": _arr(torch_model["discriminator.fc.weight_orig"]),
        "b": _arr(torch_model["discriminator.fc.bias"]),
        "u": _arr(torch_model["discriminator.fc.weight_u"]),
    }
    return params


def _legacy_cgan_renames(sd: dict) -> dict:
    """The reference loader's renames for older generators (u<i>. →
    up<i>., out. → to_out.) and v2's CBN attribute name (.cbn.emb. →
    .cbn.embed.)."""
    out = {}
    for k, v in sd.items():
        for i in range(1, 6):
            if k.startswith(f"u{i}."):
                k = f"up{i}." + k[len(f"u{i}."):]
                break
        if k.startswith("out."):
            k = "to_out." + k[len("out."):]
        out[k.replace(".cbn.emb.", ".cbn.embed.")] = v
    return out


def convert_cgan_generator(sd: dict):
    """Reference conv generator state_dict → (params, bn_state, num_classes,
    noise_dim); BatchNorm's running statistics become the bn state."""
    sd = _legacy_cgan_renames(sd)
    num_classes = int(sd["up1.cbn.embed.weight"].shape[0])
    noise_dim = int(sd["proj.weight"].shape[1]) - num_classes
    params = {"proj": {"w": _arr(sd["proj.weight"]), "b": _arr(sd["proj.bias"])}}
    bn_state = {}
    for i in range(1, 6):
        params[f"up{i}"] = {
            "conv": {"w": _arr(sd[f"up{i}.conv.weight"]),
                     "b": _arr(sd[f"up{i}.conv.bias"])},
            "cbn": {"embed": _arr(sd[f"up{i}.cbn.embed.weight"])},
        }
        bn_state[f"up{i}"] = {"mean": _arr(sd[f"up{i}.cbn.bn.running_mean"]),
                              "var": _arr(sd[f"up{i}.cbn.bn.running_var"])}
    params["to_out"] = {"w": _arr(sd["to_out.weight"]), "b": _arr(sd["to_out.bias"])}
    return params, bn_state, num_classes, noise_dim


def convert_cgan_disc(sd: dict):
    """Reference conv discriminator state_dict → (params, num_classes);
    spectral norm's v vectors are dropped."""
    params = {}
    for i in range(1, 6):
        params[f"c{i}"] = {"w": _arr(sd[f"c{i}.weight_orig"]),
                           "b": _arr(sd[f"c{i}.bias"]),
                           "u": _arr(sd[f"c{i}.weight_u"])}
    for head in ("fc", "cls"):
        params[head] = {"w": _arr(sd[f"{head}.weight_orig"]),
                        "b": _arr(sd[f"{head}.bias"]),
                        "u": _arr(sd[f"{head}.weight_u"])}
    params["embed"] = _arr(sd["embed.weight"])
    params["std_weight"] = _arr(sd["std_weight"])
    return params, int(params["embed"].shape[0])


def _infer_cgan_variant(tag: str, num_classes: int) -> str:
    """v1 trains one model per condition (9 posture classes), v2 one per
    posture (2 condition classes): the run dir's tag first, the class count
    as the fallback."""
    if re.fullmatch(r"posture\d+", tag):
        return "v2"
    if tag in ("no_exo", "with_exo"):
        return "v1"
    return "v1" if num_classes != 2 else "v2"


def convert_cgan_file(pt_path: Path, out_path: Path) -> dict:
    """Convert one CGAN .pth (generator or discriminator, by its name)."""
    sd = torch.load(pt_path, map_location="cpu", weights_only=True)
    if isinstance(sd, dict) and "state_dict" in sd:
        sd = sd["state_dict"]
    m = re.match(r"CGAN_(generator|globalD|localD|discriminator)_(.+?)"
                 r"_(best|last|epoch\d+)$", pt_path.stem)
    if not m:
        raise KeyError(f"unrecognized CGAN checkpoint name: {pt_path.name}")
    kind, tag = m.group(1), m.group(2)
    if kind == "generator":
        params, bn, num_classes, noise_dim = convert_cgan_generator(sd)
        variant = _infer_cgan_variant(tag, num_classes)
        meta = {"tag": tag, "variant": variant, "num_classes": num_classes,
                "noise_dim": noise_dim, "arch": "conv",
                "proj_scale": 0.25 if variant == "v1" else 0.10,
                "converted_from": pt_path.name, "model_only": True}
        save_checkpoint(out_path, {"model": params, "bn": bn}, meta)
    else:
        params, num_classes = convert_cgan_disc(sd)
        meta = {"tag": tag, "num_classes": num_classes,
                "converted_from": pt_path.name, "model_only": True}
        save_checkpoint(out_path, {"model": params}, meta)
    return meta


def convert_file(pt_path: Path, out_path: Path) -> dict:
    """Convert one reference TimeGAN checkpoint; returns its meta."""
    try:
        sd = torch.load(pt_path, map_location="cpu", weights_only=True)
    except Exception:
        # the reference's meta dict may need the full unpickler
        sd = torch.load(pt_path, map_location="cpu", weights_only=False)
    params = convert_timegan_model(sd["model"])
    meta = {**sd.get("meta", {}), "step": int(sd.get("step", 0)),
            "x_dim": int(params["embedder"]["gru"][0]["w_ih"].shape[1]),
            "layers": len(params["embedder"]["gru"]),
            "converted_from": pt_path.name, "model_only": True}
    save_checkpoint(out_path, {"model": params}, meta)
    return meta


def _t(a) -> torch.Tensor:
    return torch.from_numpy(np.asarray(a, np.float32).copy(order="C"))


def reverse_timegan_model(params: dict) -> dict:
    """Shared params tree → reference TimeGAN state_dict, loadable strictly
    by the reference model. torch's spectral norm also keeps ``weight_v``:
    it is re-derived as torch's power iteration does, v = normalize(Wᵀu)."""
    sd: dict = {}
    for net in NETS:
        for k, layer in enumerate(params[net]["gru"]):
            pref = f"{net}.rnn.rnn."
            sd[f"{pref}weight_ih_l{k}"] = _t(layer["w_ih"])
            sd[f"{pref}weight_hh_l{k}"] = _t(layer["w_hh"])
            sd[f"{pref}bias_ih_l{k}"] = _t(layer["b_ih"])
            sd[f"{pref}bias_hh_l{k}"] = _t(layer["b_hh"])
    sd["recovery.out.weight"] = _t(params["recovery"]["out"]["w"])
    sd["recovery.out.bias"] = _t(params["recovery"]["out"]["b"])
    for net in ("generator", "supervisor"):
        proj = params[net].get("proj")
        if proj is not None:
            sd[f"{net}.proj.weight"] = _t(proj["w"])
            sd[f"{net}.proj.bias"] = _t(proj["b"])
    fc = params["discriminator"]["fc"]
    W, u = _t(fc["w"]), _t(fc["u"])
    sd["discriminator.fc.weight_orig"] = W
    sd["discriminator.fc.bias"] = _t(fc["b"])
    sd["discriminator.fc.weight_u"] = u
    sd["discriminator.fc.weight_v"] = torch.nn.functional.normalize(W.t() @ u, dim=0,
                                                                    eps=1e-12)
    return sd


def reverse_cgan_generator(params: dict, bn_state: dict) -> dict:
    """Conv generator (params, bn_state) → reference Generator state_dict
    (``proj``, ``up<i>.conv``, ``up<i>.cbn.{bn,embed}``, ``to_out``)."""
    sd = {"proj.weight": _t(params["proj"]["w"]),
          "proj.bias": _t(params["proj"]["b"])}
    for i in range(1, 6):
        up = params[f"up{i}"]
        sd[f"up{i}.conv.weight"] = _t(up["conv"]["w"])
        sd[f"up{i}.conv.bias"] = _t(up["conv"]["b"])
        sd[f"up{i}.cbn.embed.weight"] = _t(up["cbn"]["embed"])
        sd[f"up{i}.cbn.bn.running_mean"] = _t(bn_state[f"up{i}"]["mean"])
        sd[f"up{i}.cbn.bn.running_var"] = _t(bn_state[f"up{i}"]["var"])
        sd[f"up{i}.cbn.bn.num_batches_tracked"] = torch.tensor(0, dtype=torch.long)
    sd["to_out.weight"] = _t(params["to_out"]["w"])
    sd["to_out.bias"] = _t(params["to_out"]["b"])
    return sd


def reverse_timegan_file(ckpt_path: Path, out_pt: Path) -> dict:
    """One NPZ TimeGAN checkpoint → a reference ``ckpt_*.pt`` ({step, model,
    optG, optD, meta}, optimizers empty)."""
    meta = load_meta(ckpt_path)
    trees, _ = load_checkpoint(ckpt_path)
    sd = reverse_timegan_model(trees["model"])
    ref_meta = {"npz": meta.get("npz", ""), "z_dim": int(meta["z_dim"]),
                "h_dim": int(meta["h_dim"])}
    if meta.get("best") is not None:
        ref_meta["best"] = meta["best"]
    torch.save({"step": int(meta.get("step", 0)), "model": sd,
                "optG": {}, "optD": {}, "meta": ref_meta}, out_pt)
    return ref_meta


def reverse_cgan_file(npz_path: Path, out_pth: Path) -> dict:
    """One conv generator NPZ → a reference bare state_dict ``.pth``. A
    transformer generator has no reference counterpart and is refused."""
    from eegsynth_torch.train.cgan import load_generator

    G, bn, _, meta = load_generator(npz_path, device="cpu")
    if meta.get("arch", "conv") != "conv":
        raise KeyError(f"arch={meta.get('arch')} has no reference torch "
                       "equivalent (conv only)")
    torch.save(reverse_cgan_generator(tree_to_numpy(G), tree_to_numpy(bn)), out_pth)
    return meta


def _reverse(runs_root: Path, out_root: Path, family: str, which: str) -> int:
    n = 0
    if family == "cgan":
        for src in sorted(runs_root.rglob("CGAN_generator_*.npz")):
            dst = out_root / src.parent.relative_to(runs_root) / (src.stem + ".pth")
            dst.parent.mkdir(parents=True, exist_ok=True)
            try:
                reverse_cgan_file(src, dst)
            except KeyError as e:
                print(f"[SKIP] {src.relative_to(runs_root)}: {e}", flush=True)
                continue
            print(f"[OK] {src.relative_to(runs_root)} -> {dst}", flush=True)
            n += 1
        return n
    stems = {"best": ["ckpt_best"], "latest": ["ckpt_latest"],
             "both": ["ckpt_best", "ckpt_latest"]}[which]
    for rd in sorted(runs_root.iterdir()):
        if not (rd.is_dir() and RUN_RE.match(rd.name)):
            continue
        for stem in stems:
            src = find_checkpoint(rd, stem)
            if src is None:
                continue
            dst_dir = out_root / rd.name
            dst_dir.mkdir(parents=True, exist_ok=True)
            dst = dst_dir / f"{stem}.pt"
            meta = reverse_timegan_file(src, dst)
            print(f"[OK] {rd.name}/{src.name} -> {dst}  "
                  f"(z={meta['z_dim']}, h={meta['h_dim']})", flush=True)
            n += 1
    return n


def _forward_cgan(runs_root: Path, out_root: Path) -> int:
    n = 0
    for src in sorted(runs_root.rglob("CGAN_*.pth")):
        dst = out_root / src.parent.relative_to(runs_root) / (src.stem + ".npz")
        dst.parent.mkdir(parents=True, exist_ok=True)
        try:
            meta = convert_cgan_file(src, dst)
        except KeyError as e:
            print(f"[SKIP] {src.relative_to(runs_root)}: {e}", flush=True)
            continue
        print(f"[OK] {src.relative_to(runs_root)} -> {dst}  "
              f"(classes={meta['num_classes']})", flush=True)
        n += 1
    return n


def _forward_timegan(runs_root: Path, out_root: Path, which: str) -> int:
    names = {"best": ["ckpt_best.pt"], "latest": ["ckpt_latest.pt"],
             "both": ["ckpt_best.pt", "ckpt_latest.pt"]}[which]
    n = 0
    for rd in sorted(runs_root.iterdir()):
        if not (rd.is_dir() and RUN_RE.match(rd.name)):
            continue
        for name in names:
            src = rd / name
            if not src.exists():
                continue
            dst_dir = out_root / rd.name
            dst_dir.mkdir(parents=True, exist_ok=True)
            dst = dst_dir / (src.stem + ".npz")
            meta = convert_file(src, dst)
            print(f"[OK] {rd.name}/{name} -> {dst}  "
                  f"(z={meta.get('z_dim')}, h={meta.get('h_dim')}, "
                  f"step={meta.get('step')})", flush=True)
            n += 1
    return n


def main(argv: list[str] | None = None) -> None:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0],
                                 formatter_class=argparse.ArgumentDefaultsHelpFormatter)
    ap.add_argument("--runs_dir", type=str, required=True,
                    help="reference timegan_runs/ with posture*_{no,with}_exo dirs, "
                         "or (--family cgan) cgan_runs/ with per-tag dirs; "
                         "with --reverse: a runs dir of NPZ checkpoints")
    ap.add_argument("--out_dir", type=str, required=True)
    ap.add_argument("--family", type=str, default="timegan",
                    choices=["timegan", "cgan"])
    ap.add_argument("--which", type=str, default="both",
                    choices=["best", "latest", "both"],
                    help="timegan family only; cgan converts every *.pth found")
    ap.add_argument("--reverse", action="store_true",
                    help="export NPZ checkpoints TO the reference's torch formats "
                         "(ckpt_*.pt / CGAN_generator_*.pth); reads NPZ only: "
                         "Orbax checkpoint directories are not supported")
    args = ap.parse_args(argv)
    runs_root, out_root = Path(args.runs_dir), Path(args.out_dir)

    if args.reverse:
        n = _reverse(runs_root, out_root, args.family, args.which)
        if n == 0:
            raise SystemExit(f"No checkpoints exported from {runs_root}")
        print(f"Exported {n} checkpoints into {out_root}")
    elif args.family == "cgan":
        n = _forward_cgan(runs_root, out_root)
        if n == 0:
            raise SystemExit(f"No CGAN checkpoints converted under {runs_root}")
        print(f"Converted {n} checkpoints into {out_root}")
    else:
        n = _forward_timegan(runs_root, out_root, args.which)
        if n == 0:
            raise SystemExit(f"No checkpoints found under {runs_root}")
        print(f"Converted {n} checkpoints into {out_root}")


if __name__ == "__main__":
    main()
