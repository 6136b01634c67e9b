"""Preprocess Emotiv EPOC+ EEG CSVs into fixed-length epochs per
posture × condition: the CLI of ``scripts/preprocess.py``, the same flags
and defaults, plus ``--device``.

    python -m eegsynth_torch.preprocess --root <dir of protocol_outputs_*> \\
        --out <dir> [--device cuda|cpu]

On the card the zero-phase filtering runs through the IIR kernel (four
launches a file); ``--device cpu`` runs its plain version.
"""

from __future__ import annotations

import argparse

import torch

from eegsynth_torch.data.preprocess import run_preprocess


def main(argv: list[str] | None = None) -> list[dict]:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0],
                                 formatter_class=argparse.ArgumentDefaultsHelpFormatter)
    ap.add_argument("--root", type=str, default="./6s_window",
                    help="Folder containing protocol_outputs_{1..4}")
    ap.add_argument("--out", type=str, default="./preprocessed")
    ap.add_argument("--fs", type=float, default=128.0,
                    help="Fallback sampling rate for filtering (Hz)")
    ap.add_argument("--epoch_sec", type=float, default=6.0)
    ap.add_argument("--overlap", type=float, default=0.0)
    ap.add_argument("--low_cut", type=float, default=1.0)
    ap.add_argument("--high_cut", type=float, default=45.0)
    ap.add_argument("--notch_q", type=float, default=30.0)
    ap.add_argument("--min_channels", type=int, default=10)
    ap.add_argument("--dry_run", action="store_true")
    ap.add_argument("--epoch_fs_target", type=float, default=128.0,
                    help="Target Hz used to compute the fixed epoch length")
    ap.add_argument("--device", type=str, default="cuda",
                    help="where the filtering runs (cuda: the IIR kernel)")
    args = ap.parse_args(argv)
    device = torch.device(args.device)
    if device.type == "cuda" and not torch.cuda.is_available():
        raise SystemExit("--device cuda: no CUDA device is available")
    return run_preprocess(args.root, args.out, fs=args.fs, epoch_sec=args.epoch_sec,
                          overlap=args.overlap, low_cut=args.low_cut,
                          high_cut=args.high_cut, notch_q=args.notch_q,
                          min_channels=args.min_channels,
                          epoch_fs_target=args.epoch_fs_target,
                          dry_run=args.dry_run, device=device)


if __name__ == "__main__":
    main()
