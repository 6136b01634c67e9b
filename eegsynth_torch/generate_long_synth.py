#!/usr/bin/env python3
"""Generate long synthetic EEG from trained TimeGAN checkpoints.

Counterpart of ``scripts/generate_long_synth.py``, with the same flags and
cases (``--platform cpu`` becomes ``--device cpu``; the default is
``cuda``): scans ``runs_dir/posture{p}_{with_exo|no_exo}/``, loads
``ckpt_best.npz`` (falling back to ``ckpt_latest.npz``; ``--prefer_latest``
flips the order), rebuilds the model from the checkpoint meta and the real
bucket NPZ (x_dim, fs, N and the scalers), draws U[0,1) noise at the
requested horizon (``--gen_seconds`` · fs, else ``--gen_len``, else the
training T), optionally denormalizes with the bucket's scalers, and writes
``synthetic_long.npz`` (``X`` float32, (N, T, C)) in each run directory,
the file the TimeGAN eval picks first. ``--time_chunk`` streams the sequence
axis with the GRU states carried, three K1 launches a chunk on the card.

Noise comes from one ``torch.Generator`` on the device, seeded from
``--seed`` and advanced run by run, so it does not reproduce the JAX
package's draws. ``--mesh`` (batch sharding over several devices) is
refused: the port runs on one card.

    python -m eegsynth_torch.generate_long_synth --runs_dir ./timegan_runs \\
        --real_dir ./preprocessed --gen_len 8192 --time_chunk 1024 --denorm
"""

from __future__ import annotations

import argparse
import re
from pathlib import Path

import numpy as np
import torch

from eegsynth_torch.convert import from_jax_params
from eegsynth_torch.models.timegan import TimeGANConfig
from eegsynth_torch.train.checkpoint import find_checkpoint, load_checkpoint, load_meta
from eegsynth_torch.train.timegan import synthesize

RUN_NAME = re.compile(r"posture(\d+)_(with_exo|no_exo)$")


def main(argv: list[str] | None = None) -> dict[str, Path]:
    """Write each run's long synthetic NPZ; returns run name → file written."""
    ap = argparse.ArgumentParser(formatter_class=argparse.ArgumentDefaultsHelpFormatter)
    ap.add_argument("--runs_dir", type=str, default="./timegan_runs")
    ap.add_argument("--real_dir", type=str, default="./preprocessed")
    ap.add_argument("--out_suffix", type=str, default="synthetic_long.npz",
                    help="output file name per run; '{T}' is replaced by "
                         "the horizon")
    ap.add_argument("--gen_seconds", type=float, default=None)
    ap.add_argument("--gen_len", type=int, default=None)
    ap.add_argument("--n", type=int, default=None)
    ap.add_argument("--prefer_latest", action="store_true")
    ap.add_argument("--denorm", action="store_true")
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--device", type=str, default="cuda",
                    help="cuda (the kernels) or cpu (their plain versions)")
    ap.add_argument("--batch", type=int, default=None,
                    help="optional synthesis micro-batch (memory cap for huge N·T)")
    ap.add_argument("--mesh", action="store_true",
                    help="refused: the port runs on one card")
    ap.add_argument("--precision", type=str, default="f32",
                    choices=["f32", "bf16"],
                    help="bf16 runs the cascade's projections in bfloat16 "
                         "around K1's float32 recurrences (f32 weights, f32 "
                         "outputs)")
    ap.add_argument("--time_chunk", type=int, default=None,
                    help="stream the sequence axis in fixed chunks, carrying "
                         "the GRU states")
    args = ap.parse_args(argv)

    if args.mesh:
        raise SystemExit("--mesh has no counterpart in eegsynth_torch: one "
                         "card, the batch is not sharded")
    device = torch.device(args.device)
    if device.type == "cuda" and not torch.cuda.is_available():
        raise SystemExit("--device cuda: no CUDA device is available")

    runs_root = Path(args.runs_dir)
    real_root = Path(args.real_dir)
    if not runs_root.is_dir():
        raise SystemExit(f"Runs dir not found: {runs_root}")
    run_dirs = [p for p in sorted(runs_root.iterdir())
                if p.is_dir() and RUN_NAME.match(p.name)]
    if not run_dirs:
        raise SystemExit(f"No run folders found under {runs_root}")

    generator = torch.Generator(device=device).manual_seed(args.seed)
    written = {}
    for rd in run_dirs:
        posture, cond = RUN_NAME.match(rd.name).groups()
        ckpt_best = find_checkpoint(rd, "ckpt_best")
        ckpt_last = find_checkpoint(rd, "ckpt_latest")
        ckpt = (ckpt_last if args.prefer_latest and ckpt_last is not None
                else (ckpt_best if ckpt_best is not None else ckpt_last))
        if ckpt is None:
            print(f"[SKIP] {rd.name}: no checkpoint found.")
            continue

        # the meta carries x_dim and layers, so a copied checkpoint generates
        # without its real NPZ; the real file refines fs and gives the
        # default N and the denorm scalers
        meta = load_meta(ckpt)
        real = None
        N_real, T_train, C = None, None, int(meta.get("x_dim", 14))
        fs = float(meta.get("fs", 128.0))
        real_npz = real_root / f"posture{posture}_{cond}.npz"
        if real_npz.exists():
            with np.load(real_npz) as z:
                real = {k: z[k] for k in ("X", "fs", "scale_min", "scale_range")
                        if k in z.files}
            N_real, T_train, C = real["X"].shape
            fs = float(real["fs"]) if "fs" in real else fs
        else:
            if args.gen_seconds is not None and "fs" not in meta:
                print(f"[WARN] {rd.name}: real file missing and checkpoint "
                      f"meta has no fs — assuming {fs:.0f} Hz for "
                      "--gen_seconds; pass --gen_len for an exact horizon")
            missing = [w for w, v in (("--n", args.n),
                                      ("--gen_seconds/--gen_len",
                                       args.gen_seconds or args.gen_len))
                       if v is None]
            if missing:
                print(f"[SKIP] {rd.name}: real file missing ({real_npz}) and "
                      f"{' and '.join(missing)} not given — cannot infer "
                      "N/T from the data.")
                continue
            if args.denorm:
                print(f"[WARN] {rd.name}: --denorm ignored, scalers live in "
                      f"the missing real file {real_npz}")

        cfg = TimeGANConfig(x_dim=C, z_dim=int(meta["z_dim"]), h_dim=int(meta["h_dim"]),
                            num_layers=int(meta.get("layers", 1)))
        trees, _ = load_checkpoint(ckpt)
        model = from_jax_params(trees["model"], device=device).eval()
        if model.cfg != cfg:
            raise SystemExit(f"{ckpt}: its arrays hold {model.cfg}, its meta and "
                             f"real file say {cfg}")

        if args.gen_seconds is not None:
            T_out = int(round(args.gen_seconds * fs))
        elif args.gen_len is not None:
            T_out = int(args.gen_len)
        else:
            T_out = int(T_train)
        N_out = int(args.n) if args.n is not None else int(N_real)

        print(f"[{rd.name}] N_out={N_out}  T_out={T_out}  C={C}  "
              f"z_dim={cfg.z_dim}  fs≈{fs:.2f}", flush=True)
        Xh = synthesize(model, N_out, T_out, generator=generator, batch=args.batch,
                        time_chunk=args.time_chunk, precision=args.precision)
        if args.denorm and real is not None and "scale_min" in real \
                and "scale_range" in real:
            mn = real["scale_min"].astype(np.float32)
            rg = real["scale_range"].astype(np.float32)
            Xh = Xh * rg[None, None, :] + mn[None, None, :]

        out_fp = rd / (args.out_suffix if "{" not in args.out_suffix
                       else args.out_suffix.format(T=T_out))
        np.savez_compressed(out_fp, X=Xh.astype(np.float32))
        written[rd.name] = out_fp
        print(f"[OK] wrote {out_fp}", flush=True)
    return written


if __name__ == "__main__":
    main()
