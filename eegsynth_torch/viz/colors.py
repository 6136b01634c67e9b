"""The colormaps and colour names the figures use, with matplotlib's values.

- ``hsv``: matplotlib's segment data and its lookup-table construction, so
  ``get_cmap("hsv").resampled(n)`` gives matplotlib's n colours
  (``make_palette``);
- ``tab10``: the ten qualitative colours, which are also the ``C0``-``C9``
  property cycle;
- ``viridis``: the 256-row table (``_viridis.py``, generated from
  matplotlib by ``eegsynth_torch/tools/make_glyph_atlas.py``).

A colormap called with integers indexes its table; with floats in [0, 1] it
takes row ``floor(x·N)`` (the last row at 1), as matplotlib's ``Colormap``
does. Colours are RGBA tuples of floats in [0, 1].
"""

from __future__ import annotations

import numpy as np

from eegsynth_torch.viz._viridis import VIRIDIS

HSV_SEGMENTS = {
    "red": ((0.0, 1.0, 1.0), (0.15873, 1.0, 1.0), (0.174603, 0.96875, 0.96875),
            (0.333333, 0.03125, 0.03125), (0.349206, 0.0, 0.0), (0.666667, 0.0, 0.0),
            (0.68254, 0.03125, 0.03125), (0.84127, 0.96875, 0.96875),
            (0.857143, 1.0, 1.0), (1.0, 1.0, 1.0)),
    "green": ((0.0, 0.0, 0.0), (0.15873, 0.9375, 0.9375), (0.174603, 1.0, 1.0),
              (0.507937, 1.0, 1.0), (0.666667, 0.0625, 0.0625), (0.68254, 0.0, 0.0),
              (1.0, 0.0, 0.0)),
    "blue": ((0.0, 0.0, 0.0), (0.333333, 0.0, 0.0), (0.349206, 0.0625, 0.0625),
             (0.507937, 1.0, 1.0), (0.84127, 1.0, 1.0), (0.857143, 0.9375, 0.9375),
             (1.0, 0.09375, 0.09375)),
}

TAB10 = (
    (0.12156862745098039, 0.4666666666666667, 0.7058823529411765),
    (1.0, 0.4980392156862745, 0.054901960784313725),
    (0.17254901960784313, 0.6274509803921569, 0.17254901960784313),
    (0.8392156862745098, 0.15294117647058825, 0.1568627450980392),
    (0.5803921568627451, 0.403921568627451, 0.7411764705882353),
    (0.5490196078431373, 0.33725490196078434, 0.29411764705882354),
    (0.8901960784313725, 0.4666666666666667, 0.7607843137254902),
    (0.4980392156862745, 0.4980392156862745, 0.4980392156862745),
    (0.7372549019607844, 0.7411764705882353, 0.13333333333333333),
    (0.09019607843137255, 0.7450980392156863, 0.8117647058823529),
)

NAMED = {"k": (0.0, 0.0, 0.0), "w": (1.0, 1.0, 1.0)}


def _segment_lut(n: int, data) -> np.ndarray:
    """matplotlib's ``_create_lookup_table`` for segment data at gamma 1."""
    a = np.asarray(data, dtype=np.float64)
    x, y0, y1 = a[:, 0], a[:, 1], a[:, 2]
    if n == 1:
        return np.array([y0[-1]])
    xind = np.linspace(0, 1, n)
    ind = np.searchsorted(x, xind)[1:-1]
    distance = (xind[1:-1] - x[ind - 1]) / (x[ind] - x[ind - 1])
    lut = np.concatenate([[y1[0]], distance * (y0[ind] - y1[ind - 1]) + y1[ind - 1],
                          [y0[-1]]])
    return np.clip(lut, 0.0, 1.0)


class Colormap:
    """A table of N RGBA rows, called like matplotlib's colormaps."""

    def __init__(self, name: str, table: np.ndarray, segments=None):
        self.name = name
        self.table = np.asarray(table, dtype=np.float64)
        self.N = len(self.table)
        self._segments = segments

    def resampled(self, n: int) -> "Colormap":
        """The same segment map at n rows (segment maps only: hsv)."""
        return Colormap(self.name, segment_table(self._segments, n), self._segments)

    def __call__(self, x):
        arr = np.asarray(x)
        if np.issubdtype(arr.dtype, np.integer):
            idx = arr.clip(0, self.N - 1)
        else:
            xa = arr.astype(np.float64) * self.N
            xa[xa == self.N] = self.N - 1
            idx = np.floor(np.nan_to_num(xa)).astype(int).clip(0, self.N - 1)
        out = self.table[idx]
        return tuple(float(v) for v in out) if out.ndim == 1 else out


def segment_table(segments: dict, n: int) -> np.ndarray:
    rgb = [_segment_lut(n, segments[c]) for c in ("red", "green", "blue")]
    return np.stack(rgb + [np.ones(n)], axis=1)


def get_cmap(name: str) -> Colormap:
    if name == "hsv":
        return Colormap("hsv", segment_table(HSV_SEGMENTS, 256), HSV_SEGMENTS)
    if name == "tab10":
        return Colormap("tab10", np.c_[np.asarray(TAB10), np.ones(10)])
    if name == "viridis":
        return Colormap("viridis", np.c_[np.asarray(VIRIDIS), np.ones(256)])
    raise ValueError(f"unknown colormap {name!r}")


def to_rgba(c) -> tuple:
    """A colour given as an RGB(A) tuple, ``"C0"``-``"C9"``, ``"#rrggbb"``,
    ``"k"`` or ``"w"``, as an RGBA tuple."""
    if isinstance(c, str):
        if len(c) == 2 and c[0] == "C" and c[1].isdigit():
            rgba = (*TAB10[int(c[1])], 1.0)
        elif c.startswith("#") and len(c) in (7, 9):
            vals = [int(c[i:i + 2], 16) / 255.0 for i in range(1, len(c), 2)]
            rgba = tuple(vals) + ((1.0,) if len(vals) == 3 else ())
        elif c in NAMED:
            rgba = (*NAMED[c], 1.0)
        else:
            raise ValueError(f"unknown colour {c!r}")
    else:
        vals = tuple(float(v) for v in c)
        rgba = vals if len(vals) == 4 else (*vals, 1.0)
    return rgba
