"""Write a synthetic raw-EEG tree shaped like the reference's ``6s_window/``:
``protocol_outputs_{1..P}/`` with one Emotiv-style trial CSV per posture and
condition, made from a seed.

Each trial holds a ``timestamp`` column (seconds at ``fs`` with a little
jitter) and the 14 ``eeg.xx`` channels: 4000 µV plus a random walk plus
mains hum at 60 Hz (50 Hz for the participants in ``mains_50``), so both
line-frequency detections run. ``extras`` adds the cases preprocessing has
to skip: a rest recording, a trial shorter than one 6 s epoch and a trial
with 10 channels (in the bucket of a 14-channel one).

    from eegsynth_torch.tools.raw_tree import write_raw_tree
    write_raw_tree(root, participants=4, postures=range(1, 10), seconds=60.0)

Used by ``chip_smoke.py`` and the CPU tests of preprocessing and of the
fatigue reports.
"""

from __future__ import annotations

from pathlib import Path

import numpy as np

from eegsynth_torch import EPOC_CHANNELS

CONDITIONS = ("no exo", "with exo")


def trial_name(posture: int, cond: str, trial: int, stamp: int = 0) -> str:
    return (f"Posture-{posture}-con-1-task-fatigue-{cond}-xx_EPOCPLUS_1_"
            f"20250808_{stamp:06d}_trial{trial}.csv")


def write_trial(path: Path, rng: np.random.Generator, seconds: float, fs: float = 128.0,
                mains: float = 60.0, channels=EPOC_CHANNELS) -> None:
    """One trial CSV of ``seconds`` at ``fs``: timestamp, then eeg.<channel>."""
    n = int(fs * seconds)
    t = 1723100000.0 + np.arange(n) / fs + 1e-6 * rng.standard_normal(n)
    sig = 0.1 * rng.standard_normal((n, len(channels))).cumsum(axis=0)
    sig += 2.0 * np.sin(2 * np.pi * mains * np.arange(n) / fs)[:, None]
    cols = np.concatenate([t[:, None], 4000.0 + sig], axis=1)
    header = ",".join(["timestamp"] + [f"eeg.{c.lower()}" for c in channels])
    row = ",".join(["%.7f"] + ["%.6f"] * len(channels))
    body = "\n".join(row % tuple(r) for r in cols.tolist())
    path.write_text(header + "\n" + body + "\n")


def write_raw_tree(root, participants: int = 4, postures=range(1, 10),
                   seconds: float = 60.0, fs: float = 128.0, trials: int = 1,
                   mains_50=(2,), extras: bool = True, seed: int = 0) -> list[Path]:
    """Write the tree under ``root``; returns the files written. Participant
    ``p`` lives in ``protocol_outputs_p``; every (posture, condition) gets
    ``trials`` trials."""
    root = Path(root)
    rng = np.random.default_rng(seed)
    written = []
    for part in range(1, participants + 1):
        d = root / f"protocol_outputs_{part}"
        d.mkdir(parents=True, exist_ok=True)
        mains = 50.0 if part in mains_50 else 60.0
        for posture in postures:
            for cond in CONDITIONS:
                for trial in range(1, trials + 1):
                    fp = d / trial_name(posture, cond, trial)
                    write_trial(fp, rng, seconds, fs, mains)
                    written.append(fp)
    if extras:
        d = root / "protocol_outputs_1"
        first = min(postures)
        cases = ((d / "Rest1-baseline-no exo-xx_EPOCPLUS_1_trial1.csv", seconds,
                  EPOC_CHANNELS),
                 (d / trial_name(max(postures), "no exo", trials + 1, stamp=1), 5.0,
                  EPOC_CHANNELS),
                 (d / trial_name(first, "no exo", trials + 1, stamp=2), seconds,
                  EPOC_CHANNELS[:10]))
        for fp, secs, channels in cases:
            write_trial(fp, rng, secs, fs, 60.0, channels)
            written.append(fp)
    return written
