"""The CLI of ``scripts/train_cgan_posture.py``: the v2 CGAN, one
condition-conditional model per posture.

Postures that lack either condition's NPZ are skipped with a ``[skip]``
line. ``--parallel-postures`` trains the remaining postures as one stack
(``train.cgan_multi.train_all_postures``); otherwise ``train_one_posture``
runs once per posture. ``--mesh`` and ``--multihost`` are refused (one
card), and so are ``--ckpt-format`` / ``--async-ckpt`` under
``--parallel-postures``, as in the JAX script.

    python -m eegsynth_torch.train.cgan_posture --data-dir ./preprocessed \\
        --runs-root ./cgan_runs_posture --posture all --parallel-postures \\
        --device cuda
"""

from __future__ import annotations

import argparse
from pathlib import Path

from eegsynth_torch.train.cgan import _device, train_one_posture
from eegsynth_torch.train.cgan_multi import NUM_POSTURES, train_all_postures

HP_FLAGS = {
    "epochs": int, "prewarm": int, "batch_size": int, "noise_dim": int,
    "lr_g": float, "lr_d": float, "beta1": float, "beta2": float,
    "d_steps": int, "proj_scale": float, "r1_gamma": float, "r1_every": int,
    "inst_noise_start": float, "inst_noise_end": float, "diffaugment_p": float,
    "acgan_weight": float, "g_acgan_weight": float, "fm_weight": float,
    "psd_weight": float, "coh_weight": float, "cov_weight": float,
    "amp_weight": float, "coh_pairs": int, "ema_decay": float,
    "log_psd_weight": float, "save_every": int, "epochs_per_dispatch": int,
    "seed": int, "arch": str, "tf_dim": int, "tf_depth": int, "tf_heads": int,
    "tf_patch": int, "ckpt_format": str, "precision_d": str,
}
"""The hyperparameter flags of ``scripts/train_cgan_posture.py``."""


def complete_postures(data_dir, postures) -> tuple[list[int], list[int]]:
    """(postures with both condition NPZs under ``data_dir``, the others)."""
    data_dir = Path(data_dir)
    missing = [p for p in postures
               if not all((data_dir / f"posture{p}_{c}.npz").exists()
                          for c in ("no_exo", "with_exo"))]
    return [p for p in postures if p not in missing], missing


def main(argv: list[str] | None = None):
    """Returns the trainer's result: ``train_all_postures``'s, or
    ``{posture: train_one_posture's}``."""
    ap = argparse.ArgumentParser(
        formatter_class=argparse.ArgumentDefaultsHelpFormatter,
        description="v2 CGAN: one condition-conditional model per posture "
                    "(the port of scripts/train_cgan_posture.py)")
    ap.add_argument("--data-dir", type=str, default="./preprocessed")
    ap.add_argument("--runs-root", type=str, default="./cgan_runs_posture")
    for k, typ in HP_FLAGS.items():
        ap.add_argument(f"--{k.replace('_', '-')}", dest=k, type=typ, default=None)
    ap.add_argument("--posture", type=str, default="all", help="'all' or an int 1..9")
    ap.add_argument("--ema", action="store_true", default=True,
                    help="EMA generator (always on; disable with --no-ema)")
    ap.add_argument("--use-diffaugment", action="store_true", default=True,
                    help="DiffAugment-1D (always on; disable with --no-diffaugment)")
    ap.add_argument("--amp-d", action="store_true", default=True,
                    help="kept for CLI parity; --precision-d bf16 is the control")
    ap.add_argument("--no-ema", action="store_true")
    ap.add_argument("--no-diffaugment", action="store_true")
    ap.add_argument("--async-ckpt", dest="async_ckpt",
                    action=argparse.BooleanOptionalAction, default=None,
                    help="Orbax only: refused (NPZ checkpoints are synchronous)")
    ap.add_argument("--parallel-postures", "--parallel_postures",
                    dest="parallel_postures", action="store_true",
                    help="train every posture model as one stack")
    ap.add_argument("--mesh", action="store_true", help="not ported: refused")
    ap.add_argument("--multihost", action="store_true", help="not ported: refused")
    ap.add_argument("--device", type=str, default="cuda",
                    help="cuda (the kernels) or cpu (their plain versions)")
    args = ap.parse_args(argv)

    if args.mesh or args.multihost:
        raise SystemExit("--mesh / --multihost: eegsynth_torch trains on one card")
    hp = {k: getattr(args, k) for k in HP_FLAGS if getattr(args, k) is not None}
    if args.no_ema:
        hp["ema"] = False
    if args.no_diffaugment:
        hp["use_diffaugment"] = False
    if args.async_ckpt is not None:
        hp["async_ckpt"] = args.async_ckpt

    wanted = (range(1, NUM_POSTURES + 1) if args.posture == "all"
              else [int(args.posture)])
    postures, missing = complete_postures(args.data_dir, wanted)
    if missing:
        print(f"[skip] postures {missing}: missing condition NPZs under "
              f"{args.data_dir}", flush=True)
    if not postures:
        raise SystemExit("No postures with complete data to train.")
    if args.parallel_postures and ("ckpt_format" in hp or args.async_ckpt is not None):
        raise SystemExit("--ckpt-format/--async-ckpt apply to the sequential trainer "
                         "only (the stacked trainer writes NPZ at the end of epochs).")
    device = _device(args.device)
    if args.parallel_postures:
        return train_all_postures(args.data_dir, args.runs_root, postures=postures,
                                  device=device, **hp)
    return {p: train_one_posture(args.data_dir, args.runs_root, p, device=device, **hp)
            for p in postures}


if __name__ == "__main__":
    main()
