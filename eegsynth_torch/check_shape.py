"""Print the keys, shapes and dtypes of NPZ files (a real bucket, a
synthetic.npz): the output of ``scripts/check_shape.py``, line for line.

    python -m eegsynth_torch.check_shape [file.npz ...]

With no file it reads ``preprocessed/posture1_no_exo.npz``.
"""

from __future__ import annotations

import sys

import numpy as np


def show(path) -> None:
    z = np.load(path, allow_pickle=True)
    print(path)
    for k in z.files:
        v = z[k]
        print(f"  {k}: shape={getattr(v, 'shape', None)} dtype={getattr(v, 'dtype', None)}")


def main(argv: list[str] | None = None) -> None:
    paths = sys.argv[1:] if argv is None else argv
    for p in paths or ["preprocessed/posture1_no_exo.npz"]:
        show(p)


if __name__ == "__main__":
    main()
