"""The drawing layer of the port's figures: a small figure / axes API over an
RGB numpy canvas, written as PNG by a standard-library encoder.

It stands in for the part of matplotlib the JAX package's figures use, so
the port draws them where matplotlib is not installed:

- ``subplots`` / ``figure``: figure sizes in inches, subplot grids with
  matplotlib's default subplot parameters, ``subplots_adjust``,
  ``tight_layout`` and ``suptitle``; ``savefig(path, dpi=...)`` writes
  ``int(w·dpi) × int(h·dpi)`` pixels, or with ``bbox_inches="tight"`` the
  ink's bounding box plus 0.1 inch;
- axes: linear axes and log-y (``semilogy``) with 5 % data margins,
  "nice" ticks (steps 1, 2, 2.5, 5, 10 a decade) and scalar tick labels
  with matplotlib's offset and order-of-magnitude rule; titles, axis
  labels, tick labels rotated by 45°, ``grid``, ``axis("off")``;
- marks: ``scatter`` (``o`` filled discs, ``x`` two strokes; sizes in pt²,
  alpha, one colour or one a point through a colormap), ``plot`` (solid
  and dashed), ``fill_between``, ``bar`` with ``yerr`` and caps,
  ``axvspan``, ``axvline``, ``Rectangle`` patches, ``text``,
  ``pcolormesh`` (gouraud shading as bilinear resampling) and
  ``colorbar``;
- legends in the axes (``loc`` codes, ``"best"``, ``bbox_to_anchor``,
  columns filled one after another) and in the figure.

Everything is drawn when the figure is saved, at the save's dpi: lengths in
points are ``dpi / 72`` pixels. Marks are anti-aliased by exact coverage
(distance to the disc, stroke or rectangle edge); text comes from a DejaVu
Sans glyph atlas (``_glyph_atlas.py``) resampled by area to the pixel size.
The figures carry the same marks at the same data positions, in the same
colours and with the same strings as matplotlib's; their pixels are not
matplotlib's.
"""

from __future__ import annotations

import base64
import json
import math
import struct
import time
import zlib
from dataclasses import dataclass
from functools import lru_cache
from pathlib import Path

import numpy as np

from eegsynth_torch.viz.colors import Colormap, get_cmap, to_rgba

FONT_SIZES = {"xx-small": 5.79, "x-small": 6.94, "small": 8.33, "medium": 10.0,
              "large": 12.0, "x-large": 14.4, "xx-large": 17.28}
MINUS = "−"
LINE_WIDTH = 1.5          # pt: lines.linewidth
AXES_WIDTH = 0.8          # pt: spines, ticks
TICK_SIZE, TICK_PAD = 3.5, 3.5
TITLE_PAD, LABEL_PAD = 6.0, 4.0
GRID_COLOR = "#b0b0b0"
PIECE = 12.0              # px: strokes are cut into pieces no longer than this
DEFLATE_LEVEL = 1         # zlib: figures are mostly flat colour, which level 1 packs well
DENSE = 256               # points: a longer x-sorted solid line is drawn by columns

STATS = {"draw_s": 0.0, "png_s": 0.0, "figures": 0}
"""Seconds spent drawing figures and encoding their PNGs, and the count of
figures saved, since ``reset_stats``."""


def reset_stats() -> None:
    STATS.update(draw_s=0.0, png_s=0.0, figures=0)


def _pts(size, default: float = 10.0) -> float:
    if size is None:
        return default
    return FONT_SIZES[size] if isinstance(size, str) else float(size)


# ----------------------------------------------------------------------
# PNG
# ----------------------------------------------------------------------

def _chunk(kind: bytes, data: bytes) -> bytes:
    return (struct.pack(">I", len(data)) + kind + data
            + struct.pack(">I", zlib.crc32(kind + data) & 0xFFFFFFFF))


def encode_png(img: np.ndarray) -> bytes:
    """An (H, W, 3) uint8 array as PNG bytes: 8-bit RGB, no interlace,
    filter 0 on every row, one zlib stream."""
    h, w, c = img.shape
    assert c == 3 and img.dtype == np.uint8
    rows = np.concatenate([np.zeros((h, 1), np.uint8), img.reshape(h, w * 3)], axis=1)
    return _png(rows, w, h)


def _png(rows: np.ndarray, w: int, h: int) -> bytes:
    """PNG bytes from (H, 1 + 3·W) rows that start with their filter byte."""
    return (b"\x89PNG\r\n\x1a\n"
            + _chunk(b"IHDR", struct.pack(">IIBBBBB", w, h, 8, 2, 0, 0, 0))
            + _chunk(b"IDAT", zlib.compress(memoryview(np.ascontiguousarray(rows)),
                                            DEFLATE_LEVEL))
            + _chunk(b"IEND", b""))


# ----------------------------------------------------------------------
# text
# ----------------------------------------------------------------------

@lru_cache(maxsize=1)
def _atlas() -> dict:
    from eegsynth_torch.viz._glyph_atlas import DATA
    blob = zlib.decompress(base64.b64decode("".join(DATA)))
    n = int.from_bytes(blob[:4], "little")
    meta = json.loads(blob[4:4 + n])
    pos = 4 + n
    out = {}
    for size, rows in meta:
        glyphs = {}
        for code, w, h, xo, d, adv in rows:
            img = np.frombuffer(blob, np.uint8, w * h, pos).reshape(h, w)
            pos += w * h
            glyphs[chr(code)] = (img.astype(np.float32) / 255.0, xo, d, adv)
        out[size] = glyphs
    return out


def _area_matrix(n_in: int, r: float) -> np.ndarray:
    """(n_out, n_in) weights of an area (box) resampling by factor r ≤ 1."""
    n_out = max(1, int(math.ceil(n_in * r)))
    lo = np.arange(n_out)[:, None] / r
    hi = lo + 1.0 / r
    j = np.arange(n_in)[None, :]
    return (np.clip(np.minimum(hi, j + 1) - np.maximum(lo, j), 0, None) * r).astype(np.float32)


@lru_cache(maxsize=4096)
def _glyph(ch: str, px: float):
    """(coverage, left, top, advance) of one character at ``px`` pixels per
    em: left and top of the bitmap relative to the pen and the baseline."""
    atlas = _atlas()
    base = 20 if px <= 20 else 40
    glyphs = atlas[base]
    if ch not in glyphs:
        ch = "?"
    img, xo, d, adv = glyphs[ch]
    r = px / base
    if img.size:
        img = _area_matrix(img.shape[0], r) @ img @ _area_matrix(img.shape[1], r).T
    h_in = glyphs[ch][0].shape[0]
    return img, xo * r, (h_in - d) * r, adv * r


@lru_cache(maxsize=64)
def _lp(px: float) -> tuple[float, float]:
    """Ascent of 'l' and descent of 'p' at ``px`` (matplotlib's line box)."""
    _, _, top_l, _ = _glyph("l", px)
    img, _, top_p, _ = _glyph("p", px)
    return top_l, img.shape[0] - top_p


@dataclass
class TextBlock:
    img: np.ndarray           # coverage
    box: tuple                # layout box (x0, y0, x1, y1) in img coordinates
    baseline: float           # first line's baseline, img coordinates


@lru_cache(maxsize=2048)
def layout(s: str, px: float, bold: bool = False) -> TextBlock:
    """One or more lines of text at ``px`` pixels per em, left-aligned."""
    asc, desc = _lp(px)
    step = (asc + desc) * 1.2
    lines = s.split("\n")
    widths = [sum(_glyph(c, px)[3] for c in line) for line in lines]
    pad = int(math.ceil(px))
    W = int(math.ceil(max(widths + [1.0]))) + 2 * pad
    H = int(math.ceil(asc + desc + step * (len(lines) - 1))) + 2 * pad
    img = np.zeros((H, W), np.float32)
    for k, line in enumerate(lines):
        pen, base = float(pad), pad + asc + k * step
        for c in line:
            g, left, top, adv = _glyph(c, px)
            if g.size:
                x0, y0 = int(round(pen + left)), int(round(base - top))
                h, w = g.shape
                ys, xs = max(0, y0), max(0, x0)
                ye, xe = min(H, y0 + h), min(W, x0 + w)
                if ye > ys and xe > xs:
                    region = img[ys:ye, xs:xe]
                    np.maximum(region, g[ys - y0:ye - y0, xs - x0:xe - x0], out=region)
            pen += adv
    if bold:
        sh = max(1, int(round(px / 24)))
        img[:, sh:] = np.maximum(img[:, sh:], img[:, :-sh])
    box = (float(pad), float(pad), pad + max(widths + [0.0]),
           pad + asc + desc + step * (len(lines) - 1))
    return TextBlock(img, box, pad + asc)


def _rotate(img: np.ndarray, deg: float):
    """Rotate coverage counterclockwise (as seen) by ``deg``; returns the
    image and the function mapping old image coordinates to new ones."""
    h, w = img.shape
    if deg % 360 == 90:
        return np.ascontiguousarray(np.rot90(img)), lambda x, y: (y, w - x)
    t = math.radians(deg)
    c, s = math.cos(t), math.sin(t)

    def fwd(x, y):
        return x * c + y * s, -x * s + y * c

    corners = np.array([fwd(x, y) for x, y in ((0, 0), (w, 0), (0, h), (w, h))])
    mn = corners.min(0)
    W, H = (np.ceil(corners.max(0) - mn)).astype(int)
    yy, xx = np.mgrid[0:H, 0:W].astype(np.float32)
    u, v = xx + mn[0] + 0.5, yy + mn[1] + 0.5
    sx, sy = u * c - v * s - 0.5, u * s + v * c - 0.5     # inverse rotation
    x0, y0 = np.floor(sx).astype(int), np.floor(sy).astype(int)
    fx, fy = sx - x0, sy - y0
    pad = np.pad(img, 1)

    def at(yi, xi):
        return pad[np.clip(yi + 1, 0, h + 1), np.clip(xi + 1, 0, w + 1)]

    out = ((1 - fx) * (1 - fy) * at(y0, x0) + fx * (1 - fy) * at(y0, x0 + 1)
           + (1 - fx) * fy * at(y0 + 1, x0) + fx * fy * at(y0 + 1, x0 + 1))
    return out.astype(np.float32), lambda x, y: tuple(np.subtract(fwd(x, y), mn))


def text_extent(s: str, px: float, rotation: float = 0.0, bold: bool = False):
    """(width, height) of a text's layout box, rotated."""
    blk = layout(s, px, bold)
    w, h = blk.box[2] - blk.box[0], blk.box[3] - blk.box[1]
    t = math.radians(rotation)
    return (abs(w * math.cos(t)) + abs(h * math.sin(t)),
            abs(w * math.sin(t)) + abs(h * math.cos(t)))


# ----------------------------------------------------------------------
# canvas
# ----------------------------------------------------------------------

class Canvas:
    """RGB uint8 pixels, white, kept as PNG rows (``rows``: a filter byte,
    then the row's pixels) so that saving needs no copy; every drawing call
    composites coverage times alpha over what is there (in float32, on the
    pixels it touches), inside an optional clip box."""

    def __init__(self, w: int, h: int):
        self.w, self.h = w, h
        self.rows = np.full((h, 1 + 3 * w), 255, np.uint8)
        self.rows[:, 0] = 0
        self.rgb = self.rows[:, 1:].reshape(h, w, 3)

    def _clip(self, clip):
        if clip is None:
            return 0, 0, self.w, self.h
        x0, y0, x1, y1 = clip
        return (max(0, int(math.floor(x0))), max(0, int(math.floor(y0))),
                min(self.w, int(math.ceil(x1))), min(self.h, int(math.ceil(y1))))

    def composite(self, cov: np.ndarray, x0: int, y0: int, color, alpha: float = 1.0,
                  clip=None) -> None:
        """cov (h, w) placed with its corner at pixel (x0, y0)."""
        cx0, cy0, cx1, cy1 = self._clip(clip)
        h, w = cov.shape
        xs, ys = max(x0, cx0), max(y0, cy0)
        xe, ye = min(x0 + w, cx1), min(y0 + h, cy1)
        if xe <= xs or ye <= ys:
            return
        a = cov[ys - y0:ye - y0, xs - x0:xe - x0] * np.float32(alpha)
        region = self.rgb[ys:ye, xs:xe]
        rgb = np.asarray(color[:3], np.float32) * 255.0
        for c in range(3):      # channel by channel: no (h, w, 3) broadcast of a
            ch = region[..., c]
            px = ch.astype(np.float32)
            px += (rgb[c] - px) * a
            px += 0.5
            ch[...] = px

    def transmit(self, trans: np.ndarray, x0: int, y0: int, color, clip=None) -> None:
        """Blend toward ``color`` by 1 − trans (trans: the product of the
        marks' transparencies, so overlapping marks of one colour compose as
        they would one after another)."""
        self.composite(1.0 - trans, x0, y0, color, 1.0, clip)

    def fill_rect(self, x0, y0, x1, y1, color, alpha: float = 1.0, clip=None) -> None:
        """Axis-aligned rectangle, edges anti-aliased by area."""
        if x1 < x0:
            x0, x1 = x1, x0
        if y1 < y0:
            y0, y1 = y1, y0
        if not all(map(math.isfinite, (x0, y0, x1, y1))):
            return
        cx0, cy0, cx1, cy1 = self._clip(clip)
        ix0, iy0 = max(cx0, int(math.floor(x0))), max(cy0, int(math.floor(y0)))
        ix1, iy1 = min(cx1, int(math.ceil(x1))), min(cy1, int(math.ceil(y1)))
        if ix1 <= ix0 or iy1 <= iy0:
            return
        cols = np.arange(ix0, ix1)
        rows = np.arange(iy0, iy1)
        cx = np.clip(np.minimum(cols + 1, x1) - np.maximum(cols, x0), 0, 1)
        cy = np.clip(np.minimum(rows + 1, y1) - np.maximum(rows, y0), 0, 1)
        if alpha >= 1.0 and ix1 - ix0 > 2 and iy1 - iy0 > 2:
            # opaque: the interior is the colour, only the edge pixels blend
            rgb = (np.asarray(color[:3], np.float64) * 255.0 + 0.5).astype(np.uint8)
            # one row of the colour, copied into each PNG row's bytes
            self.rows[iy0 + 1:iy1 - 1, 1 + 3 * (ix0 + 1):1 + 3 * (ix1 - 1)] = \
                np.tile(rgb, ix1 - ix0 - 2)
            cx[1:-1], cy[1:-1] = 1.0, 1.0
            edge = np.outer(cy, cx).astype(np.float32)
            for part, c0, r0 in ((edge[:1], ix0, iy0), (edge[-1:], ix0, iy1 - 1),
                                 (edge[1:-1, :1], ix0, iy0 + 1),
                                 (edge[1:-1, -1:], ix1 - 1, iy0 + 1)):
                self.composite(part, c0, r0, color, 1.0, clip)
            return
        self.composite(np.outer(cy, cx).astype(np.float32), ix0, iy0, color, alpha, clip)

    def stroke(self, xs, ys, width: float, color, alpha: float = 1.0, dashes=None,
               clip=None) -> None:
        """A polyline of ``width`` pixels (NaN breaks it); ``dashes`` (on,
        off) in pixels. Overlaps within the line do not darken it."""
        if len(xs) == 2 and (xs[0] == xs[1] or ys[0] == ys[1]):
            self._straight(float(xs[0]), float(ys[0]), float(xs[1]), float(ys[1]), width,
                           color, alpha, dashes, clip)
            return
        cov = self.stroke_coverage(xs, ys, width, dashes, clip)
        if cov is not None:
            self.composite(cov[0], cov[1], cov[2], color, alpha, clip)

    def _straight(self, x0, y0, x1, y1, width, color, alpha, dashes, clip):
        """A vertical or horizontal segment: the coverage along it (the dash
        pattern's "on" length inside each pixel) times the coverage across
        it, composited once."""
        vertical = x0 == x1
        lo, hi = sorted((y0, y1) if vertical else (x0, x1))
        mid, h = (x0 if vertical else y0), width / 2.0
        if dashes is None:
            self.fill_rect(mid - h, lo, mid + h, hi, color, alpha, clip) if vertical else \
                self.fill_rect(lo, mid - h, hi, mid + h, color, alpha, clip)
            return
        on, period = dashes[0], dashes[0] + dashes[1]
        start = y0 if vertical else x0          # the pattern starts at the first point
        sign = 1.0 if (y1 if vertical else x1) >= start else -1.0

        def on_length(t):                        # "on" length from the start to t
            d = np.clip((t - start) * sign, 0.0, hi - lo)
            return np.floor(d / period) * on + np.minimum(np.mod(d, period), on)

        cx0, cy0, cx1, cy1 = self._clip(clip)
        a0, a1 = (cy0, cy1) if vertical else (cx0, cx1)
        b0, b1 = (cx0, cx1) if vertical else (cy0, cy1)
        i0, i1 = max(a0, int(math.floor(lo))), min(a1, int(math.ceil(hi)))
        j0, j1 = max(b0, int(math.floor(mid - h))), min(b1, int(math.ceil(mid + h)))
        if i1 <= i0 or j1 <= j0:
            return
        edges = np.arange(i0, i1 + 1, dtype=np.float64)
        along = np.abs(np.diff(on_length(edges)))
        js = np.arange(j0, j1)
        across = np.clip(np.minimum(js + 1, mid + h) - np.maximum(js, mid - h), 0, 1)
        cov = np.outer(along, across) if vertical else np.outer(across, along)
        self.composite(cov.astype(np.float32), j0 if vertical else i0,
                       i0 if vertical else j0, color, alpha, clip)

    def stroke_coverage(self, xs, ys, width: float, dashes=None, clip=None):
        xs = np.asarray(xs, np.float64)
        ys = np.asarray(ys, np.float64)
        if (dashes is None and len(xs) >= DENSE and np.isfinite(xs).all()
                and np.isfinite(ys).all() and (np.diff(xs) >= 0).all()):
            return _column_coverage(xs, ys, width / 2.0, self._clip(clip))
        ok = np.isfinite(xs[:-1]) & np.isfinite(ys[:-1]) & np.isfinite(xs[1:]) & np.isfinite(ys[1:])
        p0 = np.stack([xs[:-1], ys[:-1]], 1)[ok]
        p1 = np.stack([xs[1:], ys[1:]], 1)[ok]
        if not len(p0):
            return None
        seg = p1 - p0
        length = np.hypot(seg[:, 0], seg[:, 1])
        if dashes is not None:
            # pieces of at most half a pixel, kept where their midpoint's arc
            # length falls in an "on" phase
            n = np.maximum(1, np.ceil(length / 0.5)).astype(int)
        else:
            n = np.maximum(1, np.ceil(length / PIECE)).astype(int)
        idx = np.repeat(np.arange(len(p0)), n)
        k = np.arange(len(idx)) - np.repeat(np.cumsum(n) - n, n)
        t0, t1 = k / n[idx], (k + 1) / n[idx]
        a = p0[idx] + seg[idx] * t0[:, None]
        b = p0[idx] + seg[idx] * t1[:, None]
        if dashes is not None:
            start = np.concatenate([[0.0], np.cumsum(length)[:-1]])
            mid = start[idx] + length[idx] * (t0 + t1) / 2
            keep = np.mod(mid, dashes[0] + dashes[1]) < dashes[0]
            a, b = a[keep], b[keep]
        if not len(a):
            return None
        return _capsules(a, b, width / 2.0, self._clip(clip))


def _column_coverage(xs: np.ndarray, ys: np.ndarray, r: float, clip):
    """Coverage of a long x-sorted polyline of half width r, column by
    column: each pixel column covers the line's vertical extent over the
    columns within r of it, widened by r (a signal trace's strokes are
    mostly vertical, so this is their union up to the columns' edges)."""
    cx0, cy0, cx1, cy1 = clip
    c0 = max(cx0, int(math.floor(xs[0] - r)))
    c1 = min(cx1, int(math.ceil(xs[-1] + r)))
    if c1 <= c0:
        return None
    n = c1 - c0
    # each column spans the line between its two edges (interpolated) and
    # the vertices inside it
    edges = np.arange(c0, c1 + 1, dtype=np.float64)
    ye = np.where((edges >= xs[0]) & (edges <= xs[-1]), np.interp(edges, xs, ys), np.nan)
    with np.errstate(invalid="ignore"):
        lo = np.fmin(ye[:-1], ye[1:])
        hi = np.fmax(ye[:-1], ye[1:])
    lo = np.where(np.isnan(lo), np.inf, lo)
    hi = np.where(np.isnan(hi), -np.inf, hi)
    ci = np.clip(np.floor(xs).astype(int) - c0, 0, n - 1)
    np.minimum.at(lo, ci, ys)
    np.maximum.at(hi, ci, ys)
    k = int(math.ceil(r))
    if k > 0:        # columns within r of a column see its extent
        plo, phi = np.pad(lo, k, constant_values=np.inf), np.pad(hi, k, constant_values=-np.inf)
        for d in range(1, k + 1):
            lo = np.minimum(lo, np.minimum(plo[k - d:k - d + n], plo[k + d:k + d + n]))
            hi = np.maximum(hi, np.maximum(phi[k - d:k - d + n], phi[k + d:k + d + n]))
    top, bot = lo - r, hi + r
    ok = np.isfinite(top) & np.isfinite(bot)
    if not ok.any():
        return None
    r0 = max(cy0, int(math.floor(top[ok].min())))
    r1 = min(cy1, int(math.ceil(bot[ok].max())))
    if r1 <= r0:
        return None
    rows = np.arange(r0, r1, dtype=np.float64)[:, None]
    cov = np.clip(np.minimum(rows + 1, bot[None]) - np.maximum(rows, top[None]), 0, 1)
    cov[:, ~ok] = 0
    return cov.astype(np.float32), c0, r0


def _ragged_boxes(lo: np.ndarray, hi: np.ndarray):
    """Every integer pixel (x, y) of each box [lo, hi) and its box index."""
    wh = np.maximum(hi - lo, 0)
    count = wh[:, 0] * wh[:, 1]
    box = np.repeat(np.arange(len(lo)), count)
    k = np.arange(count.sum()) - np.repeat(np.cumsum(count) - count, count)
    w = np.maximum(wh[box, 0], 1)
    return lo[box, 0] + k % w, lo[box, 1] + k // w, box


def _capsules(a: np.ndarray, b: np.ndarray, r: float, clip):
    """Coverage of the union of segments a→b of radius r: (cov, x0, y0)."""
    cx0, cy0, cx1, cy1 = clip
    lo = np.floor(np.minimum(a, b) - r - 1).astype(int)
    hi = np.ceil(np.maximum(a, b) + r + 1).astype(int) + 1
    lo = np.maximum(lo, [cx0, cy0])
    hi = np.minimum(hi, [cx1, cy1])
    px, py, box = _ragged_boxes(lo, hi)
    if not len(px):
        return None
    pa = np.stack([px + 0.5, py + 0.5], 1) - a[box]
    ab = (b - a)[box]
    ll = (ab * ab).sum(1)
    t = np.clip(np.where(ll > 0, (pa * ab).sum(1) / np.where(ll > 0, ll, 1), 0), 0, 1)
    d = np.hypot(pa[:, 0] - t * ab[:, 0], pa[:, 1] - t * ab[:, 1])
    cov = np.clip(r + 0.5 - d, 0, 1).astype(np.float32)
    x0, y0 = px.min(), py.min()
    out = np.zeros((py.max() - y0 + 1, px.max() - x0 + 1), np.float32)
    np.maximum.at(out, (py - y0, px - x0), cov)
    return out, int(x0), int(y0)


def mark_transmittance(xs, ys, marker: str, radius: float, lw: float, alpha: float,
                       clip, filled_edge: float = 0.0):
    """Product over marks of (1 − alpha·coverage) on a box: (trans, x0, y0).
    ``o``: a disc of ``radius`` (+ ``filled_edge``/2); ``x``: two strokes
    of width ``lw`` from corner to corner of the square of half side
    ``radius``."""
    xs, ys = np.asarray(xs, np.float64), np.asarray(ys, np.float64)
    ok = np.isfinite(xs) & np.isfinite(ys)
    xs, ys = xs[ok], ys[ok]
    cx0, cy0, cx1, cy1 = clip
    if not len(xs):
        return None
    r_out = (radius + filled_edge / 2.0) if marker == "o" else (radius + lw / 2.0)
    R = int(math.ceil(r_out + 1))
    off = np.arange(-R, R + 1)
    gx = np.floor(xs).astype(int)[:, None, None] + off[None, None, :]
    gy = np.floor(ys).astype(int)[:, None, None] + off[None, :, None]
    dx = gx + 0.5 - xs[:, None, None]
    dy = gy + 0.5 - ys[:, None, None]
    if marker == "o":
        cov = np.clip(r_out + 0.5 - np.hypot(dx, dy), 0, 1)
    else:
        cov = np.zeros(np.broadcast_shapes(dx.shape, dy.shape))
        h = lw / 2.0
        for sgn in (1.0, -1.0):
            # distance to the diagonal segment from (-r, -sgn r) to (r, sgn r)
            t = np.clip((dx + sgn * dy) / 2.0, -radius, radius)
            d = np.hypot(dx - t, dy - sgn * t)
            cov = np.maximum(cov, np.clip(h + 0.5 - d, 0, 1))
    gx, gy = np.broadcast_arrays(gx, gy)
    keep = (gx >= cx0) & (gx < cx1) & (gy >= cy0) & (gy < cy1) & (cov > 0)
    gx, gy, cov = gx[keep], gy[keep], cov[keep]
    if not len(gx):
        return None
    x0, y0 = gx.min(), gy.min()
    trans = np.ones((gy.max() - y0 + 1, gx.max() - x0 + 1), np.float64)
    np.multiply.at(trans, (gy - y0, gx - x0), 1.0 - alpha * cov)
    return trans.astype(np.float32), int(x0), int(y0)


@lru_cache(maxsize=1024)
def _placed(s: str, px: float, bold: bool, rotation: float):
    """A text's coverage, layout box and baseline, rotated."""
    blk = layout(s, px, bold)
    img, (bx0, by0, bx1, by1) = blk.img, blk.box
    if rotation:
        img, fwd = _rotate(img, rotation)
        pts = np.array([fwd(px_, py_) for px_, py_ in
                        ((bx0, by0), (bx1, by0), (bx0, by1), (bx1, by1))])
        (bx0, by0), (bx1, by1) = pts.min(0), pts.max(0)
    return img, (bx0, by0, bx1, by1), blk.baseline


def draw_text(canvas: Canvas, s: str, x: float, y: float, px: float, color="k",
              ha: str = "left", va: str = "baseline", rotation: float = 0.0,
              bold: bool = False):
    """Draw ``s`` anchored at pixel (x, y); returns its layout box in canvas
    pixels (x0, y0, x1, y1). The box of the rotated text is aligned."""
    if not s:
        return (x, y, x, y)
    img, (bx0, by0, bx1, by1), base = _placed(s, px, bold, float(rotation % 360))
    if rotation % 360 and va == "baseline":
        va = "center"
    ax = {"left": bx0, "center": (bx0 + bx1) / 2, "right": bx1}[ha]
    ay = {"top": by0, "center": (by0 + by1) / 2, "bottom": by1, "baseline": base}[va]
    ox, oy = int(round(x - ax)), int(round(y - ay))
    canvas.composite(img, ox, oy, to_rgba(color))
    return (ox + bx0, oy + by0, ox + bx1, oy + by1)


# ----------------------------------------------------------------------
# ticks and their labels
# ----------------------------------------------------------------------

def nice_ticks(vmin: float, vmax: float, nbins: int) -> np.ndarray:
    """MaxNLocator(nbins, steps=[1, 2, 2.5, 5, 10]): the smallest step whose
    ticks inside [vmin, vmax] number at most nbins + 1."""
    if not (math.isfinite(vmin) and math.isfinite(vmax)) or vmax <= vmin:
        return np.array([vmin])
    nbins = max(1, nbins)
    raw = (vmax - vmin) / nbins
    scale = 10.0 ** math.floor(math.log10(raw))
    for s in (1.0, 2.0, 2.5, 5.0, 10.0, 20.0):
        step = s * scale
        lo = math.ceil(vmin / step - 1e-9)
        hi = math.floor(vmax / step + 1e-9)
        if hi - lo <= nbins:
            break
    ticks = np.arange(lo, hi + 1) * step
    ticks[np.abs(ticks) < step * 1e-10] = 0.0
    return ticks


def _fmt_minus(s: str) -> str:
    return s.replace("-", MINUS)


def scalar_labels(locs: np.ndarray) -> tuple[list[str], str]:
    """Tick labels and the axis's offset text, as matplotlib's
    ScalarFormatter (offset threshold 4, power limits (-5, 6))."""
    locs = np.asarray(locs, np.float64)
    if not len(locs):
        return [], ""
    offset = 0.0
    lmin, lmax = float(locs.min()), float(locs.max())
    if lmin != lmax and not (lmin <= 0 <= lmax):
        abs_min, abs_max = sorted([abs(lmin), abs(lmax)])
        sign = math.copysign(1, lmin)
        oom_max = math.ceil(math.log10(abs_max))
        oom = oom_max
        while oom > oom_max - 40 and abs_min // 10 ** oom == abs_max // 10 ** oom:
            oom -= 1
        oom += 1
        if (abs_max - abs_min) / 10 ** oom <= 1e-2:
            oom = oom_max
            while oom > oom_max - 40 and not abs_max - abs_min > 10 ** oom:
                oom -= 1
            oom += 1
        offset = sign * (abs_max // 10 ** oom) * 10 ** oom if abs_max // 10 ** oom >= 1000 else 0.0
    rel = locs - offset
    big = np.abs(rel).max()
    oom = math.floor(math.log10(big)) if big > 0 else 0
    order = oom if (oom <= -5 or oom >= 6) else 0
    vals = rel / 10.0 ** order
    rng = float(np.ptp(vals)) or float(np.abs(vals).max()) or 1.0
    rng_oom = math.floor(math.log10(rng))
    sig = max(0, 3 - rng_oom)
    thresh = 1e-3 * 10.0 ** rng_oom
    while sig >= 0 and np.abs(vals - np.round(vals, sig)).max() < thresh:
        sig -= 1
    sig += 1
    labels = [_fmt_minus(f"{v:.{sig}f}") for v in vals]
    labels = [("0" if lab.strip(MINUS + "0.") == "" else lab) for lab in labels]
    off = ""
    if order:
        off = _fmt_minus(f"1e{order}")
    if offset:
        o = f"{offset:+.{max(0, 3)}g}".replace("e+0", "e").replace("e-0", "e-")
        off = _fmt_minus(o) + ((" " + off) if off else "")
    return labels, off


# ----------------------------------------------------------------------
# artists
# ----------------------------------------------------------------------

@dataclass
class Handle:
    """What a legend entry draws: a marker, a line or a patch."""
    kind: str                 # "marker", "line", "patch"
    color: tuple
    marker: str = "o"
    size: float = 6.0         # marker diameter, pt
    lw: float = LINE_WIDTH
    alpha: float = 1.0
    dashed: bool = False
    edge: float = 0.0         # marker edge width, pt (filled 'o')


@dataclass
class Rectangle:
    xy: tuple
    width: float
    height: float
    color: object = "C0"
    alpha: float | None = None
    lw: float = 0.0

    def handle(self) -> Handle:
        return Handle("patch", to_rgba(self.color), alpha=1.0 if self.alpha is None else self.alpha)


class Line2D:
    """A legend handle made by hand (``matplotlib.lines.Line2D([], [], ...)``)."""

    def __init__(self, xdata=(), ydata=(), linestyle="-", marker=None, markersize=6.0,
                 color="C0", lw=LINE_WIDTH):
        self.marker, self.markersize, self.color = marker, markersize, color
        self.linestyle, self.lw = linestyle, lw

    def handle(self) -> Handle:
        if self.marker:
            return Handle("marker", to_rgba(self.color), self.marker, self.markersize,
                          lw=1.0, edge=1.0)
        return Handle("line", to_rgba(self.color), lw=self.lw,
                      dashed=self.linestyle == "--")


@dataclass
class _Artist:
    kind: str
    data: dict
    z: float
    label: str | None = None
    handle: Handle | None = None


class ScalarMappable:
    def __init__(self, cmap: Colormap, vmin: float, vmax: float):
        self.cmap, self.vmin, self.vmax = cmap, vmin, vmax

    def norm(self, v):
        span = self.vmax - self.vmin
        return (np.asarray(v, np.float64) - self.vmin) / (span if span else 1.0)


# ----------------------------------------------------------------------
# axes
# ----------------------------------------------------------------------

class Axes:
    def __init__(self, fig: "Figure", cell=None, rect=None):
        self.fig, self.cell, self.rect = fig, cell, rect
        self.artists: list[_Artist] = []
        self.title = self.xlabel = self.ylabel = None
        self.title_size = 12.0
        self.xlabel_size = self.ylabel_size = 10.0
        self.xlim = self.ylim = None
        self.xticks = self.yticks = None          # (locs, labels or None)
        self.xtick_style = {"rotation": 0.0, "ha": "center", "fontsize": 10.0}
        self.ytick_style = {"fontsize": 10.0}
        self.yscale = "linear"
        self.xmargin = self.ymargin = 0.05
        self.grid_alpha = None
        self.axis_on = True
        self.legend_spec = None
        self.show_xticklabels = True
        self.sharex: list[Axes] | None = None
        self.colorbar_of = None                     # for a colorbar's own axes
        self.cbar = None                            # (mappable, label) drawn at the right
        self._nline = self._npatch = 0
        self.box = None

    # -- the colour cycles (lines and patches have one each) --
    def _next(self, kind: str):
        if kind == "line":
            c = f"C{self._nline % 10}"
            self._nline += 1
        else:
            c = f"C{self._npatch % 10}"
            self._npatch += 1
        return c

    # -- marks --
    def scatter(self, x, y, s=None, c=None, marker="o", alpha=None, label=None,
                cmap=None, edgecolors=None):
        x = np.asarray(x, np.float64).ravel()
        y = np.asarray(y, np.float64).ravel()
        s = 36.0 if s is None else float(s)
        alpha = 1.0 if alpha is None else float(alpha)
        mappable = None
        if c is None:
            colors = [to_rgba(self._next("patch"))]
        elif cmap is not None:
            v = np.asarray(c, np.float64).ravel()
            mappable = ScalarMappable(get_cmap(cmap) if isinstance(cmap, str) else cmap,
                                      float(v.min()), float(v.max()))
            colors = [tuple(row) for row in mappable.cmap(mappable.norm(v))]
        elif isinstance(c, str):
            colors = [to_rgba(c)]
        else:
            colors = [to_rgba(cc) for cc in c] if np.ndim(c) == 2 else [to_rgba(c)]
        lw = LINE_WIDTH
        edge = 0.0 if (edgecolors == "none" or marker != "o") else lw
        self.artists.append(_Artist("scatter", dict(x=x, y=y, s=s, colors=colors,
                                                    marker=marker, alpha=alpha, lw=lw,
                                                    edge=edge), 1.0, label,
                                    Handle("marker", colors[0], marker, math.sqrt(s),
                                           lw, alpha, edge=edge)))
        return mappable

    def plot(self, x, y, lw=None, alpha=None, linestyle="-", color=None, label=None):
        lw = float(lw or LINE_WIDTH)
        color = to_rgba(color if color is not None else self._next("line"))
        self.artists.append(_Artist("line", dict(
            x=np.asarray(x, np.float64), y=np.asarray(y, np.float64), lw=lw,
            alpha=1.0 if alpha is None else alpha, dashed=linestyle in ("--", "dashed"),
            color=color), 2.0, label, Handle("line", color, lw=lw,
                                            dashed=linestyle in ("--", "dashed"))))

    def semilogy(self, x, y, **kw):
        self.yscale = "log"
        self.plot(x, y, **kw)

    def fill_between(self, x, y1, y2, alpha=None, color=None, label=None):
        color = to_rgba(color if color is not None else self._next("patch"))
        self.artists.append(_Artist("fill", dict(
            x=np.asarray(x, np.float64), y1=np.asarray(y1, np.float64) * np.ones(len(x)),
            y2=np.asarray(y2, np.float64) * np.ones(len(x)),
            alpha=1.0 if alpha is None else alpha, color=color), 1.0, label,
            Handle("patch", color, alpha=1.0 if alpha is None else alpha)))

    def bar(self, x, height, width=0.8, yerr=None, capsize=None, label=None, color=None):
        x = np.atleast_1d(np.asarray(x))
        height = np.atleast_1d(np.asarray(height, np.float64))
        if x.dtype.kind in "US":        # categorical: one slot a label
            self.xticks = (np.arange(len(x), dtype=np.float64), [str(v) for v in x])
            x = np.arange(len(x), dtype=np.float64)
        x = x.astype(np.float64)
        color = to_rgba(color if color is not None else self._next("patch"))
        err = None if yerr is None else np.atleast_1d(np.asarray(yerr, np.float64)) * np.ones(len(x))
        self.artists.append(_Artist("bar", dict(x=x, h=height, w=float(width), err=err,
                                                capsize=0.0 if capsize is None else capsize,
                                                color=color), 1.0, label,
                                    Handle("patch", color)))

    def axvspan(self, x0, x1, color=None, alpha=None):
        self.artists.append(_Artist("vspan", dict(x0=float(x0), x1=float(x1),
                                                  color=to_rgba(color or "C0"),
                                                  alpha=1.0 if alpha is None else alpha), 1.0))

    def axvline(self, x, linestyle="-", alpha=None, color=None, lw=None):
        self.artists.append(_Artist("vline", dict(x=float(x), dashed=linestyle == "--",
                                                  color=to_rgba(color or "C0"),
                                                  alpha=1.0 if alpha is None else alpha,
                                                  lw=lw or LINE_WIDTH), 2.0))

    def add_patch(self, rect: Rectangle):
        self.artists.append(_Artist("rect", dict(rect=rect), 1.0))

    def text(self, x, y, s, ha="left", va="baseline", fontsize=None, color="k",
             weight=None):
        self.artists.append(_Artist("text", dict(x=float(x), y=float(y), s=str(s), ha=ha,
                                                 va=va, size=_pts(fontsize), color=color,
                                                 bold=weight == "bold"), 3.0))

    def pcolormesh(self, x, y, C, shading="gouraud", cmap="viridis"):
        C = np.asarray(C, np.float64)
        m = ScalarMappable(get_cmap(cmap), float(np.nanmin(C)), float(np.nanmax(C)))
        self.artists.append(_Artist("mesh", dict(x=np.asarray(x, np.float64),
                                                 y=np.asarray(y, np.float64), C=C, m=m), 1.0))
        self.xmargin = self.ymargin = 0.0
        return m

    # -- decorations --
    def set_title(self, s, fontsize=None):
        self.title = s
        self.title_size = _pts(fontsize, 12.0)

    def set_xlabel(self, s, fontsize=None):
        self.xlabel, self.xlabel_size = s, _pts(fontsize)

    def set_ylabel(self, s, fontsize=None):
        self.ylabel, self.ylabel_size = s, _pts(fontsize)

    def set_xlim(self, a, b):
        self.xlim = (float(a), float(b))

    def set_ylim(self, a, b):
        self.ylim = (float(a), float(b))

    def set_xticks(self, locs, labels=None, rotation=None, ha=None, fontsize=None):
        self.xticks = (np.asarray(locs, np.float64), labels)
        self._tick_style(rotation, ha, fontsize)

    def set_xticklabels(self, labels, rotation=None, ha=None, fontsize=None):
        locs = self.xticks[0] if self.xticks is not None else np.arange(len(labels))
        self.xticks = (locs, [str(v) for v in labels])
        self._tick_style(rotation, ha, fontsize)

    def _tick_style(self, rotation, ha, fontsize):
        if rotation is not None:
            self.xtick_style["rotation"] = float(rotation)
        if ha is not None:
            self.xtick_style["ha"] = ha
        if fontsize is not None:
            self.xtick_style["fontsize"] = _pts(fontsize)

    def set_yticks(self, locs):
        self.yticks = (np.asarray(locs, np.float64), None)

    def set_yticklabels(self, labels):
        self.yticks = (self.yticks[0], [str(v) for v in labels])

    def grid(self, on=True, alpha=None):
        self.grid_alpha = (1.0 if alpha is None else alpha) if on else None

    def margins(self, x):
        self.xmargin = x

    def axis(self, what):
        if what == "off":
            self.axis_on = False

    def get_legend_handles_labels(self):
        items = [(a.handle, a.label) for a in self.artists
                 if a.label and not a.label.startswith("_") and a.handle is not None]
        return [h for h, _ in items], [lab for _, lab in items]

    def legend(self, handles=None, labels=None, loc="best", fontsize=None, ncol=1,
               frameon=True, bbox_to_anchor=None, borderaxespad=0.5, columnspacing=2.0,
               handlelength=2.0, handletextpad=0.8, markerscale=1.0):
        if handles is None:
            handles, labels = self.get_legend_handles_labels()
        else:
            handles = [h.handle() if hasattr(h, "handle") and callable(h.handle) else h
                       for h in handles]
        self.legend_spec = dict(handles=list(handles), labels=list(labels), loc=loc,
                                fontsize=_pts(fontsize), ncol=ncol, frameon=frameon,
                                anchor=bbox_to_anchor, borderaxespad=borderaxespad,
                                columnspacing=columnspacing, handlelength=handlelength,
                                handletextpad=handletextpad, markerscale=markerscale)

    # -- limits --
    def _data_limits(self, axis: str):
        lo, hi = [], []
        sticky = []
        for a in self.artists:
            d = a.data
            if a.kind in ("scatter", "line"):
                v = d[axis]
                if axis == "y" and self.yscale == "log":
                    v = v[v > 0]
                v = v[np.isfinite(v)]
                if len(v):
                    lo.append(v.min())
                    hi.append(v.max())
            elif a.kind == "fill":
                v = d["x"] if axis == "x" else np.concatenate([d["y1"], d["y2"]])
                v = v[np.isfinite(v)]
                if len(v):
                    lo.append(v.min())
                    hi.append(v.max())
            elif a.kind == "bar":
                if axis == "x":
                    lo.append(float(np.min(d["x"] - d["w"] / 2)))
                    hi.append(float(np.max(d["x"] + d["w"] / 2)))
                else:
                    h = np.nan_to_num(d["h"])
                    e = 0 if d["err"] is None else np.nan_to_num(d["err"])
                    lo.append(float(min(0.0, np.min(h - e))))
                    hi.append(float(max(0.0, np.max(h + e))))
                    sticky.append(0.0)
            elif a.kind in ("vspan", "vline") and axis == "x":
                xs = [d["x0"], d["x1"]] if a.kind == "vspan" else [d["x"]]
                lo.append(min(xs))
                hi.append(max(xs))
            elif a.kind == "rect":
                r = a.data["rect"]
                v = (r.xy[0], r.xy[0] + r.width) if axis == "x" else (r.xy[1], r.xy[1] + r.height)
                lo.append(min(v))
                hi.append(max(v))
            elif a.kind == "mesh":
                v = d[axis]
                lo.append(v.min())
                hi.append(v.max())
        if not lo:
            return None, sticky
        return (float(min(lo)), float(max(hi))), sticky

    def _limits(self, axis: str):
        fixed = self.xlim if axis == "x" else self.ylim
        if fixed is not None:
            return fixed
        if axis == "x" and self.sharex:
            lims = [ax._data_limits("x")[0] for ax in self.sharex]
            lims = [v for v in lims if v is not None]
            lim = (min(v[0] for v in lims), max(v[1] for v in lims)) if lims else None
            sticky = []
        else:
            lim, sticky = self._data_limits(axis)
        log = axis == "y" and self.yscale == "log"
        if lim is None:
            return (1.0, 10.0) if log else (0.0, 1.0)
        a, b = (math.log10(lim[0]), math.log10(lim[1])) if log else lim
        if a == b:
            d = abs(a) * 0.05 if a else (0.5 if log else 0.055)
            a, b = a - d, b + d
        m = self.xmargin if axis == "x" else self.ymargin
        lo, hi = a - m * (b - a), b + m * (b - a)
        for s in sticky:      # bars: no margin past 0
            if a >= s > lo:
                lo = s
            if b <= s < hi:
                hi = s
        return (10 ** lo, 10 ** hi) if log else (lo, hi)

    # -- transforms (pixels) --
    def _tx(self, x):
        (x0, _, x1, _), (a, b) = self.box, self._xl
        return x0 + (np.asarray(x, np.float64) - a) / (b - a) * (x1 - x0)

    def _ty(self, y):
        (_, y0, _, y1), (a, b) = self.box, self._yl
        y = np.asarray(y, np.float64)
        if self.yscale == "log":
            with np.errstate(divide="ignore", invalid="ignore"):
                y = np.log10(np.where(y > 0, y, 1e-300))
            a, b = math.log10(a), math.log10(b)
        return y1 - (y - a) / (b - a) * (y1 - y0)

    def _ticks(self, axis: str, scale: float):
        given = self.xticks if axis == "x" else self.yticks
        lim = self._xl if axis == "x" else self._yl
        if given is not None:
            locs, labels = given
            if labels is None:
                labels, off = scalar_labels(locs)
                return locs, labels, off
            return locs, list(labels), ""
        if axis == "y" and self.yscale == "log":
            lo, hi = math.log10(lim[0]), math.log10(lim[1])
            k0, k1 = math.ceil(lo - 1e-9), math.floor(hi + 1e-9)
            step = max(1, int(math.ceil((k1 - k0 + 1) / 9)))
            ks = np.arange(k0, k1 + 1, step)
            return 10.0 ** ks, [("10^" + _fmt_minus(str(int(k)))) for k in ks], ""
        x0, y0, x1, y1 = self.box
        length_pt = ((x1 - x0) if axis == "x" else (y1 - y0)) / scale
        fs = self.xtick_style["fontsize"] if axis == "x" else self.ytick_style["fontsize"]
        nbins = max(1, min(9, int(length_pt // (fs * (3 if axis == "x" else 2)))))
        locs = nice_ticks(min(lim), max(lim), nbins)
        lo, hi = min(lim), max(lim)
        locs = locs[(locs >= lo - 1e-9 * (hi - lo)) & (locs <= hi + 1e-9 * (hi - lo))]
        labels, off = scalar_labels(locs)
        return locs, labels, off

    # -- layout --
    def _decorations(self, scale: float) -> tuple[float, float, float, float]:
        """Pixels the axes' labels, ticks and title take beyond its box:
        (left, top, right, bottom)."""
        self._prepare(scale)
        if not self.axis_on:
            return 0.0, 0.0, 0.0, 0.0
        tick = (TICK_SIZE + TICK_PAD) * scale
        left = bottom = tick
        top = right = 0.0
        xs = self.xtick_style
        xpx = xs["fontsize"] * scale
        if self.show_xticklabels:
            hs = [text_extent(_lab_text(lab), xpx, xs["rotation"])[1]
                  for lab in self._xtk[1]] or [0.0]
            bottom += max(hs)
            if xs["rotation"] == 0 and len(self._xtk[0]):
                last_w = text_extent(_lab_text(self._xtk[1][-1]), xpx)[0]
                over = self._tx(self._xtk[0][-1]) + last_w / 2 - self.box[2]
                right = max(right, over)
        ypx = self.ytick_style["fontsize"] * scale
        ws = [text_extent(_lab_text(lab), ypx)[0] for lab in self._ytk[1]] or [0.0]
        left += max(ws)
        if self.xlabel and self.show_xticklabels:
            bottom += LABEL_PAD * scale + text_extent(self.xlabel, self.xlabel_size * scale)[1]
        if self.ylabel:
            left += LABEL_PAD * scale + text_extent(self.ylabel, self.ylabel_size * scale, 90)[0]
        if self.title:
            top += TITLE_PAD * scale + text_extent(self.title, self.title_size * scale)[1]
        if self._ytk[2]:
            top = max(top, text_extent(self._ytk[2], ypx)[1] + 2 * scale)
        if self.legend_spec is not None:
            lw, lh, lx, ly = self._legend_box(scale)
            right = max(right, lx + lw - self.box[2])
            bottom = max(bottom, ly + lh - self.box[3])
            top = max(top, self.box[1] - ly)
        if self.cbar is not None:
            right = max(right, self.cbar_extent)
        return left, top, max(right, 0.0), bottom

    def _prepare(self, scale: float):
        self._xl = self._limits("x")
        self._yl = self._limits("y")
        self._xtk = self._ticks("x", scale)
        self._ytk = self._ticks("y", scale)
        if self.cbar is not None:
            m, label = self.cbar
            fs = 10.0 * scale
            locs = nice_ticks(m.vmin, m.vmax, 7) if m.vmax > m.vmin else np.array([m.vmin])
            locs = locs[(locs >= m.vmin - 1e-9) & (locs <= m.vmax + 1e-9)]
            labels, _ = scalar_labels(locs)
            self._cbar_ticks = (locs, labels)
            w = max([text_extent(lab, fs)[0] for lab in labels] or [0.0])
            self.cbar_extent = ((TICK_SIZE + TICK_PAD) * scale + w
                                + (LABEL_PAD * scale + text_extent(label, fs, 90)[0]
                                   if label else 0.0))

    def _legend_box(self, scale: float):
        """(width, height, x, y) of the legend in pixels."""
        spec = self.legend_spec
        fs = spec["fontsize"] * scale
        n = len(spec["labels"])
        ncol = max(1, spec["ncol"])
        nrow = int(math.ceil(n / ncol)) if n else 0
        asc, desc = _lp(fs)
        row_h = max(asc + desc, 0.7 * fs)
        hl = spec["handlelength"] * fs
        col_w = []
        for c in range(ncol):
            labs = spec["labels"][c * nrow:(c + 1) * nrow]
            tw = max([text_extent(lab, fs)[0] for lab in labs] or [0.0])
            col_w.append(hl + spec["handletextpad"] * fs + tw)
        pad = 0.4 * fs
        w = sum(col_w) + spec["columnspacing"] * fs * (ncol - 1) + 2 * pad
        h = nrow * row_h + max(0, nrow - 1) * 0.5 * fs + 2 * pad
        spec["_geom"] = (col_w, row_h, nrow, ncol, pad, hl)
        x0, y0, x1, y1 = self.box
        gap = spec["borderaxespad"] * fs
        if spec["anchor"] is not None:
            ax_, ay_ = spec["anchor"]
            px = x0 + ax_ * (x1 - x0)
            py = y1 - ay_ * (y1 - y0)
            loc = spec["loc"]
            lx = px + gap if "left" in loc else (px - w - gap if "right" in loc else px - w / 2)
            ly = py + gap if "upper" in loc else (py - h - gap if "lower" in loc else py - h / 2)
            return w, h, lx, ly
        loc = spec["loc"]
        if loc == "best":
            loc = self._best_loc(w, h, gap)
        horiz = "right" if "right" in loc else ("left" if "left" in loc else "center")
        vert = "upper" if "upper" in loc else ("lower" if "lower" in loc else "center")
        lx = {"left": x0 + gap, "right": x1 - gap - w, "center": (x0 + x1 - w) / 2}[horiz]
        ly = {"upper": y0 + gap, "lower": y1 - gap - h, "center": (y0 + y1 - h) / 2}[vert]
        return w, h, lx, ly

    def _best_loc(self, w, h, gap) -> str:
        """matplotlib's candidate order; the first with the fewest data
        points under the legend."""
        pts = []
        for a in self.artists:
            if a.kind in ("scatter", "line"):
                pts.append(np.stack([self._tx(a.data["x"]), self._ty(a.data["y"])], 1))
        pts = np.concatenate(pts) if pts else np.zeros((0, 2))
        x0, y0, x1, y1 = self.box
        best, best_n = "upper right", None
        for loc in ("upper right", "upper left", "lower left", "lower right", "right",
                    "center left", "center right", "lower center", "upper center",
                    "center"):
            horiz = "right" if "right" in loc else ("left" if "left" in loc else "center")
            vert = "upper" if "upper" in loc else ("lower" if "lower" in loc else "center")
            lx = {"left": x0 + gap, "right": x1 - gap - w, "center": (x0 + x1 - w) / 2}[horiz]
            ly = {"upper": y0 + gap, "lower": y1 - gap - h, "center": (y0 + y1 - h) / 2}[vert]
            n = int(((pts[:, 0] >= lx) & (pts[:, 0] <= lx + w)
                     & (pts[:, 1] >= ly) & (pts[:, 1] <= ly + h)).sum())
            if best_n is None or n < best_n:
                best, best_n = loc, n
        return best

    # -- drawing --
    def draw(self, cv: Canvas, scale: float):
        self._prepare(scale)
        x0, y0, x1, y1 = self.box
        clip = self.box
        lw_ax = AXES_WIDTH * scale
        order = sorted(range(len(self.artists)), key=lambda i: (self.artists[i].z, i))
        grid_drawn = False
        for i in order:
            a = self.artists[i]
            if a.z > 1.0 and not grid_drawn:
                self._draw_grid(cv, scale)
                grid_drawn = True
            self._draw_artist(cv, a, scale, clip)
        if not grid_drawn:
            self._draw_grid(cv, scale)
        if not self.axis_on:
            return
        for ex0, ey0, ex1, ey1 in ((x0, y0, x1, y0), (x0, y1, x1, y1),
                                   (x0, y0, x0, y1), (x1, y0, x1, y1)):
            cv.fill_rect(ex0 - lw_ax / 2, ey0 - lw_ax / 2, ex1 + lw_ax / 2, ey1 + lw_ax / 2, to_rgba("k"))
        tick = TICK_SIZE * scale
        pad = TICK_PAD * scale
        xs = self.xtick_style
        locs, labels, off = self._xtk
        lab_bottom = y1 + tick + pad
        for v, lab in zip(locs, labels):
            px = float(self._tx(v))
            if px < x0 - 0.5 or px > x1 + 0.5:
                continue
            cv.fill_rect(px - lw_ax / 2, y1, px + lw_ax / 2, y1 + tick, to_rgba("k"))
            if self.show_xticklabels:
                box = _draw_label(cv, lab, px, y1 + tick + pad, xs["fontsize"] * scale,
                                  ha=xs["ha"] if xs["rotation"] else "center", va="top",
                                  rotation=xs["rotation"])
                lab_bottom = max(lab_bottom, box[3])
        if off and self.show_xticklabels:
            draw_text(cv, off, x1, lab_bottom + 2 * scale, xs["fontsize"] * scale,
                      ha="right", va="top")
        locs, labels, off = self._ytk
        lab_left = x0 - tick - pad
        ypx = self.ytick_style["fontsize"] * scale
        for v, lab in zip(locs, labels):
            py = float(self._ty(v))
            if py < y0 - 0.5 or py > y1 + 0.5:
                continue
            cv.fill_rect(x0 - tick, py - lw_ax / 2, x0, py + lw_ax / 2, to_rgba("k"))
            box = _draw_label(cv, lab, x0 - tick - pad, py, ypx, ha="right", va="center")
            lab_left = min(lab_left, box[0])
        if off:
            draw_text(cv, off, x0, y0 - 2 * scale, ypx, ha="left", va="bottom")
        if self.xlabel and self.show_xticklabels:
            draw_text(cv, self.xlabel, (x0 + x1) / 2, lab_bottom + LABEL_PAD * scale,
                      self.xlabel_size * scale, ha="center", va="top")
        if self.ylabel:
            draw_text(cv, self.ylabel, lab_left - LABEL_PAD * scale, (y0 + y1) / 2,
                      self.ylabel_size * scale, ha="right", va="center", rotation=90)
        if self.title:
            draw_text(cv, self.title, (x0 + x1) / 2, y0 - TITLE_PAD * scale,
                      self.title_size * scale, ha="center", va="bottom")
        if self.legend_spec is not None:
            w, h, lx, ly = self._legend_box(scale)
            draw_legend(cv, self.legend_spec, lx, ly, w, h, scale)
        if self.cbar is not None:
            self._draw_colorbar(cv, scale)

    def _draw_grid(self, cv: Canvas, scale: float):
        if self.grid_alpha is None or not self.axis_on:
            return
        x0, y0, x1, y1 = self.box
        w = 0.8 * scale
        color = to_rgba(GRID_COLOR)
        for v in self._xtk[0]:
            px = float(self._tx(v))
            if x0 <= px <= x1:
                cv.fill_rect(px - w / 2, y0, px + w / 2, y1, color, self.grid_alpha)
        for v in self._ytk[0]:
            py = float(self._ty(v))
            if y0 <= py <= y1:
                cv.fill_rect(x0, py - w / 2, x1, py + w / 2, color, self.grid_alpha)

    def _draw_artist(self, cv: Canvas, a: _Artist, scale: float, clip):
        d = a.data
        x0, y0, x1, y1 = self.box
        if a.kind == "scatter":
            px, py = self._tx(d["x"]), self._ty(d["y"])
            radius = math.sqrt(d["s"]) / 2 * scale
            cols = d["colors"]
            groups = ([(cols[0], np.ones(len(px), bool))] if len(cols) == 1 else
                      [(c, np.array([cc == c for cc in cols]))
                       for c in dict.fromkeys(cols)])
            for color, m in groups:
                tr = mark_transmittance(px[m], py[m], d["marker"], radius, d["lw"] * scale,
                                        d["alpha"], cv._clip(clip), d["edge"] * scale)
                if tr is not None:
                    cv.transmit(tr[0], tr[1], tr[2], color, clip)
        elif a.kind == "line":
            lw = d["lw"] * scale
            dashes = (3.7 * d["lw"] * scale, 1.6 * d["lw"] * scale) if d["dashed"] else None
            cv.stroke(self._tx(d["x"]), self._ty(d["y"]), lw, d["color"], d["alpha"],
                      dashes, clip)
        elif a.kind == "fill":
            self._fill(cv, d, clip)
        elif a.kind == "bar":
            for xi, hi, ei in zip(d["x"], d["h"], d["err"] if d["err"] is not None
                                  else [None] * len(d["x"])):
                if not np.isfinite(hi):
                    continue
                cv.fill_rect(float(self._tx(xi - d["w"] / 2)), float(self._ty(0.0)),
                             float(self._tx(xi + d["w"] / 2)), float(self._ty(hi)),
                             d["color"], 1.0, clip)
            if d["err"] is not None:
                black = to_rgba("k")
                for xi, hi, ei in zip(d["x"], d["h"], d["err"]):
                    if not (np.isfinite(hi) and np.isfinite(ei)):
                        continue
                    px = float(self._tx(xi))
                    lo_y, hi_y = float(self._ty(hi - ei)), float(self._ty(hi + ei))
                    cv.stroke([px, px], [lo_y, hi_y], LINE_WIDTH * scale, black, 1.0,
                              None, clip)
                    cap = d["capsize"] * scale
                    for yy in (lo_y, hi_y):
                        if cap > 0:
                            cv.fill_rect(px - cap, yy - 0.5 * scale, px + cap,
                                         yy + 0.5 * scale, black, 1.0, clip)
        elif a.kind == "vspan":
            cv.fill_rect(float(self._tx(d["x0"])), y0, float(self._tx(d["x1"])), y1,
                         d["color"], d["alpha"], clip)
        elif a.kind == "vline":
            px = float(self._tx(d["x"]))
            dashes = (3.7 * d["lw"] * scale, 1.6 * d["lw"] * scale) if d["dashed"] else None
            cv.stroke([px, px], [y0, y1], d["lw"] * scale, d["color"], d["alpha"], dashes,
                      clip)
        elif a.kind == "rect":
            r = d["rect"]
            cv.fill_rect(float(self._tx(r.xy[0])), float(self._ty(r.xy[1])),
                         float(self._tx(r.xy[0] + r.width)),
                         float(self._ty(r.xy[1] + r.height)), to_rgba(r.color),
                         1.0 if r.alpha is None else r.alpha, clip)
        elif a.kind == "text":
            tx, ty = float(self._tx(d["x"])), float(self._ty(d["y"]))
            draw_text(cv, d["s"], tx, ty, d["size"] * scale, d["color"], d["ha"], d["va"],
                      bold=d["bold"])
        elif a.kind == "mesh":
            self._mesh(cv, d)

    def _fill(self, cv: Canvas, d: dict, clip):
        """The region between two curves, column by column."""
        x = d["x"]
        if len(x) < 2:
            return
        px = self._tx(x)
        order = np.argsort(px)
        px = px[order]
        ya, yb = self._ty(d["y1"])[order], self._ty(d["y2"])[order]
        cx0, cy0, cx1, cy1 = cv._clip(clip)
        c0 = max(cx0, int(math.floor(px[0])))
        c1 = min(cx1, int(math.ceil(px[-1])))
        if c1 <= c0:
            return
        cols = np.arange(c0, c1) + 0.5
        inside = (cols >= px[0]) & (cols <= px[-1])
        ta, tb = np.interp(cols, px, ya), np.interp(cols, px, yb)
        top, bot = np.minimum(ta, tb), np.maximum(ta, tb)
        rows = np.arange(cy0, cy1)[:, None]
        cov = np.clip(np.minimum(rows + 1, bot[None]) - np.maximum(rows, top[None]), 0, 1)
        cov *= inside[None]
        cv.composite(cov.astype(np.float32), c0, cy0, d["color"], d["alpha"], clip)

    def _mesh(self, cv: Canvas, d: dict):
        """Gouraud-shaded mesh as bilinear resampling of the values."""
        x, y, C, m = d["x"], d["y"], d["C"], d["m"]
        cx0, cy0, cx1, cy1 = cv._clip(self.box)
        px0, px1 = sorted((float(self._tx(x[0])), float(self._tx(x[-1]))))
        py0, py1 = sorted((float(self._ty(y[0])), float(self._ty(y[-1]))))
        c0, c1 = max(cx0, int(math.floor(px0))), min(cx1, int(math.ceil(px1)))
        r0, r1 = max(cy0, int(math.floor(py0))), min(cy1, int(math.ceil(py1)))
        if c1 <= c0 or r1 <= r0:
            return
        xa, xb = self._xl
        ya, yb = self._yl
        (bx0, by0, bx1, by1) = self.box
        xd = xa + (np.arange(c0, c1) + 0.5 - bx0) / (bx1 - bx0) * (xb - xa)
        yd = ya + (by1 - (np.arange(r0, r1) + 0.5)) / (by1 - by0) * (yb - ya)
        fx = np.interp(xd, x, np.arange(len(x)))
        fy = np.interp(yd, y, np.arange(len(y)))
        ix = np.clip(np.floor(fx).astype(int), 0, max(0, len(x) - 2))
        iy = np.clip(np.floor(fy).astype(int), 0, max(0, len(y) - 2))
        tx = (fx - ix)[None, :]
        ty = (fy - iy)[:, None]
        ix1 = np.minimum(ix + 1, len(x) - 1)
        iy1 = np.minimum(iy + 1, len(y) - 1)
        v = ((1 - tx) * (1 - ty) * C[iy][:, ix] + tx * (1 - ty) * C[iy][:, ix1]
             + (1 - tx) * ty * C[iy1][:, ix] + tx * ty * C[iy1][:, ix1])
        rgb = (m.cmap(np.clip(m.norm(v), 0, 1))[..., :3] * 255.0 + 0.5).astype(np.uint8)
        inside = ((np.arange(c0, c1) + 0.5 >= px0) & (np.arange(c0, c1) + 0.5 <= px1))[None, :] \
            & ((np.arange(r0, r1) + 0.5 >= py0) & (np.arange(r0, r1) + 0.5 <= py1))[:, None]
        region = cv.rgb[r0:r1, c0:c1]
        region[inside] = rgb[inside]

    def _draw_colorbar(self, cv: Canvas, scale: float):
        m, label = self.cbar
        bx0, by0, bx1, by1 = self.cbar_box
        # the colormap's N bands from vmin (bottom) to vmax, one per pixel row
        r0, r1 = int(round(by0)), int(round(by1))
        c0, c1 = int(round(bx0)), int(round(bx1))
        if r1 > r0 and c1 > c0:
            frac = (r1 - (np.arange(r0, r1) + 0.5)) / (r1 - r0)
            band = np.minimum((frac * m.cmap.N).astype(int), m.cmap.N - 1)
            cv.rgb[r0:r1, c0:c1] = (m.cmap.table[band, None, :3] * 255.0 + 0.5).astype(np.uint8)
        lw_ax = AXES_WIDTH * scale
        for ex0, ey0, ex1, ey1 in ((bx0, by0, bx1, by0), (bx0, by1, bx1, by1),
                                   (bx0, by0, bx0, by1), (bx1, by0, bx1, by1)):
            cv.fill_rect(ex0 - lw_ax / 2, ey0 - lw_ax / 2, ex1 + lw_ax / 2, ey1 + lw_ax / 2, to_rgba("k"))
        locs, labels = self._cbar_ticks
        tick, pad, fs = TICK_SIZE * scale, TICK_PAD * scale, 10.0 * scale
        right = bx1 + tick + pad
        span = (m.vmax - m.vmin) or 1.0
        for v, lab in zip(locs, labels):
            py = by1 - (v - m.vmin) / span * (by1 - by0)
            cv.fill_rect(bx1, py - lw_ax / 2, bx1 + tick, py + lw_ax / 2, to_rgba("k"))
            box = _draw_label(cv, lab, bx1 + tick + pad, py, fs, ha="left", va="center")
            right = max(right, box[2])
        if label:
            draw_text(cv, label, right + LABEL_PAD * scale, (by0 + by1) / 2, fs,
                      ha="left", va="center", rotation=90)


def _lab_text(lab: str) -> str:
    """The plain string a tick label measures as (10^k drawn with a raised
    exponent takes about the width of '10' and the exponent)."""
    return lab.replace("^", "") if lab.startswith("10^") else lab


def _draw_label(cv: Canvas, lab: str, x: float, y: float, px: float, ha="center",
                va="top", rotation=0.0):
    """A tick label; ``10^k`` is drawn as 10 with a raised, smaller k."""
    if not lab.startswith("10^"):
        return draw_text(cv, lab, x, y, px, ha=ha, va=va, rotation=rotation)
    exp = lab[3:]
    w_base = text_extent("10", px)[0]
    w_exp = text_extent(exp, px * 0.7)[0]
    w, h = w_base + w_exp, text_extent("10", px)[1]
    left = {"left": x, "center": x - w / 2, "right": x - w}[ha]
    top = {"top": y, "center": y - h / 2, "bottom": y - h}.get(va, y - h / 2)
    b = draw_text(cv, "10", left, top + h * 0.15, px, ha="left", va="top")
    draw_text(cv, exp, left + w_base, top, px * 0.7, ha="left", va="top")
    return (left, top, left + w, b[3])


def _draw_handle(cv: Canvas, hd: Handle, cx: float, cy: float, length: float, fs: float,
                 scale: float, markerscale: float):
    if hd.kind == "marker":
        r = hd.size / 2 * scale * markerscale
        tr = mark_transmittance([cx], [cy], hd.marker, r, hd.lw * scale, hd.alpha,
                                cv._clip(None), hd.edge * scale)
        if tr is not None:
            cv.transmit(tr[0], tr[1], tr[2], hd.color)
    elif hd.kind == "line":
        dashes = (3.7 * hd.lw * scale, 1.6 * hd.lw * scale) if hd.dashed else None
        cv.stroke([cx - length / 2, cx + length / 2], [cy, cy], hd.lw * scale, hd.color,
                  hd.alpha, dashes)
    else:
        h = 0.7 * fs
        cv.fill_rect(cx - length / 2, cy - h / 2, cx + length / 2, cy + h / 2, hd.color,
                     hd.alpha)


def draw_legend(cv: Canvas, spec: dict, lx: float, ly: float, w: float, h: float,
                scale: float):
    col_w, row_h, nrow, ncol, pad, hl = spec["_geom"]
    fs = spec["fontsize"] * scale
    if spec["frameon"]:
        cv.fill_rect(lx, ly, lx + w, ly + h, to_rgba("w"), 0.8)
        e = 1.0 * scale
        for ex0, ey0, ex1, ey1 in ((lx, ly, lx + w, ly), (lx, ly + h, lx + w, ly + h),
                                   (lx, ly, lx, ly + h), (lx + w, ly, lx + w, ly + h)):
            cv.fill_rect(ex0 - e / 2, ey0 - e / 2, ex1 + e / 2, ey1 + e / 2,
                         to_rgba("#cccccc"), 0.8)
    x = lx + pad
    for c in range(ncol):
        for r in range(nrow):
            i = c * nrow + r
            if i >= len(spec["labels"]):
                break
            cy = ly + pad + r * (row_h + 0.5 * fs) + row_h / 2
            _draw_handle(cv, spec["handles"][i], x + hl / 2, cy, hl, fs, scale,
                         spec["markerscale"])
            draw_text(cv, spec["labels"][i], x + hl + spec["handletextpad"] * fs, cy, fs,
                      ha="left", va="center")
        x += col_w[c] + spec["columnspacing"] * fs


# ----------------------------------------------------------------------
# figure
# ----------------------------------------------------------------------

class Figure:
    def __init__(self, figsize=(6.4, 4.8)):
        self.figsize = (float(figsize[0]), float(figsize[1]))
        self.axes: list[Axes] = []
        self.grid = (1, 1)
        self.params = dict(left=0.125, right=0.9, bottom=0.11, top=0.88, wspace=0.2,
                           hspace=0.2)
        self.tight = False
        self.suptitle_spec = None
        self.legend_spec = None
        self.cbars: list[Axes] = []

    def subplots(self, nrows=1, ncols=1, sharex=False):
        self.grid = (nrows, ncols)
        axs = np.empty((nrows, ncols), dtype=object)
        for r in range(nrows):
            for c in range(ncols):
                axs[r, c] = Axes(self, cell=(r, c))
                self.axes.append(axs[r, c])
        if sharex:
            flat = list(axs.ravel())
            for ax in flat:
                ax.sharex = flat
                ax.show_xticklabels = ax.cell[0] == nrows - 1
        return axs

    def subplots_adjust(self, **kw):
        self.params.update(kw)

    def tight_layout(self):
        self.tight = True

    def suptitle(self, s, fontsize=None):
        self.suptitle_spec = (s, _pts(fontsize, 12.0))

    def colorbar(self, mappable: ScalarMappable, ax: Axes, label: str = ""):
        ax.cbar = (mappable, label)

    def legend(self, handles, labels, loc="center", ncol=1, fontsize=None, frameon=True):
        handles = [h.handle() if hasattr(h, "handle") and callable(h.handle) else h
                   for h in handles]
        self.legend_spec = dict(handles=handles, labels=list(labels), loc=loc,
                                fontsize=_pts(fontsize), ncol=ncol, frameon=frameon,
                                columnspacing=2.0, handlelength=2.0, handletextpad=0.8,
                                markerscale=1.0)

    # -- layout --
    def _boxes(self, W: int, H: int, scale: float):
        p = dict(self.params)
        nrows, ncols = self.grid
        if self.tight and self.axes:
            pad = 1.08 * 10.0 * scale
            self._place(p, W, H)
            decs = {ax.cell: ax._decorations(scale) for ax in self.axes}
            sup = 0.0
            if self.suptitle_spec:
                sup = text_extent(self.suptitle_spec[0], self.suptitle_spec[1] * scale)[1] \
                    + 0.02 * H
            left = max(decs[(r, 0)][0] for r in range(nrows)) + pad
            right = max(decs[(r, ncols - 1)][2] for r in range(nrows)) + pad
            top = max(decs[(0, c)][1] for c in range(ncols)) + pad + sup
            bottom = max(decs[(nrows - 1, c)][3] for c in range(ncols)) + pad
            p["left"], p["right"] = left / W, 1 - right / W
            p["top"], p["bottom"] = 1 - top / H, bottom / H
            if ncols > 1:
                gap = max(decs[(r, c)][2] + decs[(r, c + 1)][0]
                          for r in range(nrows) for c in range(ncols - 1)) + pad
                cell = (p["right"] - p["left"]) * W
                aw = (cell - gap * (ncols - 1)) / ncols
                p["wspace"] = gap / max(aw, 1.0)
            if nrows > 1:
                gap = max(decs[(r, c)][3] + decs[(r + 1, c)][1]
                          for r in range(nrows - 1) for c in range(ncols)) + pad
                cell = (p["top"] - p["bottom"]) * H
                ah = (cell - gap * (nrows - 1)) / nrows
                p["hspace"] = gap / max(ah, 1.0)
            if p["right"] - p["left"] < 0.05:
                p["left"], p["right"] = 0.05, 0.95
            if p["top"] - p["bottom"] < 0.05:
                p["bottom"], p["top"] = 0.05, 0.95
        self._place(p, W, H)
        return p

    def _place(self, p, W, H):
        nrows, ncols = self.grid
        tw = (p["right"] - p["left"]) * W
        th = (p["top"] - p["bottom"]) * H
        cw = tw / (ncols + p["wspace"] * (ncols - 1))
        ch = th / (nrows + p["hspace"] * (nrows - 1))
        for ax in self.axes:
            r, c = ax.cell
            x0 = p["left"] * W + c * cw * (1 + p["wspace"])
            y0 = (1 - p["top"]) * H + r * ch * (1 + p["hspace"])
            x1, y1 = x0 + cw, y0 + ch
            if ax.cbar is not None:
                # matplotlib's colorbar(ax=...): fraction 0.15, pad 0.05, aspect 20
                w = x1 - x0
                slot = x0 + (1 - 0.15) * w
                bw = min(0.15 * w, (y1 - y0) / 20)
                ax.cbar_box = (slot, y0, slot + bw, y1)
                x1 = x0 + (1 - 0.15 - 0.05) * w
            ax.box = (x0, y0, x1, y1)

    def savefig(self, path, dpi: float = 100, bbox_inches=None) -> tuple[int, int]:
        """Draw at ``dpi`` and write a PNG; returns its (width, height)."""
        t0 = time.perf_counter()
        W, H = int(self.figsize[0] * dpi), int(self.figsize[1] * dpi)
        scale = dpi / 72.0
        cv = Canvas(W, H)
        self._boxes(W, H, scale)
        for ax in self.axes:
            ax.draw(cv, scale)
        if self.suptitle_spec:
            s, size = self.suptitle_spec
            draw_text(cv, s, W / 2, 0.02 * H, size * scale, ha="center", va="top")
        if self.legend_spec is not None:
            spec = self.legend_spec
            dummy = Axes(self)
            dummy.box = (0.0, 0.0, float(W), float(H))
            dummy.legend_spec = dict(spec, anchor=None, borderaxespad=0.0)
            w, h, lx, ly = dummy._legend_box(scale)
            draw_legend(cv, dummy.legend_spec, lx, ly, w, h, scale)
        t1 = time.perf_counter()
        ink = None
        if bbox_inches == "tight":
            ink = np.nonzero((cv.rgb < 255).any(axis=2))
        if ink is not None and len(ink[0]):
            pad = int(round(0.1 * dpi))
            y0, y1 = ink[0].min(), ink[0].max() + 1
            x0, x1 = ink[1].min(), ink[1].max() + 1
            img = np.pad(cv.rgb[y0:y1, x0:x1], ((pad, pad), (pad, pad), (0, 0)),
                         constant_values=255)
            data, (W, H) = encode_png(img), img.shape[1::-1]
        else:
            data = _png(cv.rows, W, H)
        Path(path).write_bytes(data)
        STATS["draw_s"] += t1 - t0
        STATS["png_s"] += time.perf_counter() - t1
        STATS["figures"] += 1
        return W, H


def subplots(nrows: int = 1, ncols: int = 1, figsize=(6.4, 4.8), sharex: bool = False,
             squeeze: bool = True):
    fig = Figure(figsize)
    axs = fig.subplots(nrows, ncols, sharex=sharex)
    if squeeze:
        axs = axs.item() if axs.size == 1 else axs.squeeze()
    return fig, axs
