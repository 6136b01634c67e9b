"""The port's drawing layer (``eegsynth_torch/viz/raster.py``): PNGs that
decode (with a decoder written here on zlib, and with matplotlib's
``imread``), figures of figsize × dpi pixels, scatter marks at the pixels
the axes transform gives, text that leaves ink, and a figure family drawn
with matplotlib and scikit-learn made unimportable."""

import re
import struct
import subprocess
import sys
import zlib
from pathlib import Path

import numpy as np
import pytest

from test_torch_threads import one_thread_each  # noqa: F401

from eegsynth_torch.viz import raster

REPO = Path(__file__).resolve().parent.parent


def decode_png(data: bytes) -> np.ndarray:
    """An 8-bit RGB, non-interlaced PNG whose rows all use filter 0 (as the
    port writes them), checking every chunk's CRC."""
    assert data[:8] == b"\x89PNG\r\n\x1a\n"
    pos, idat, ihdr = 8, b"", None
    while pos < len(data):
        n, = struct.unpack(">I", data[pos:pos + 4])
        kind, body = data[pos + 4:pos + 8], data[pos + 8:pos + 8 + n]
        crc, = struct.unpack(">I", data[pos + 8 + n:pos + 12 + n])
        assert zlib.crc32(kind + body) & 0xFFFFFFFF == crc, kind
        if kind == b"IHDR":
            ihdr = struct.unpack(">IIBBBBB", body)
        elif kind == b"IDAT":
            idat += body
        pos += 12 + n
    w, h, depth, ctype, _, _, interlace = ihdr
    assert (depth, ctype, interlace) == (8, 2, 0)
    raw = np.frombuffer(zlib.decompress(idat), np.uint8).reshape(h, 1 + 3 * w)
    assert (raw[:, 0] == 0).all()
    return raw[:, 1:].reshape(h, w, 3)


def test_png_round_trip(tmp_path):
    rng = np.random.default_rng(0)
    img = rng.integers(0, 256, (13, 17, 3), dtype=np.uint8)
    data = raster.encode_png(img)
    np.testing.assert_array_equal(decode_png(data), img)
    import matplotlib.image
    (tmp_path / "x.png").write_bytes(data)
    np.testing.assert_array_equal(
        np.round(matplotlib.image.imread(tmp_path / "x.png") * 255).astype(np.uint8), img)


@pytest.mark.parametrize("figsize,dpi", [((8.6, 5.8), 170), ((6.0, 4.6), 180),
                                         ((7, 5), 160), ((10, 3), 200), ((14, 6), 200),
                                         ((9.8, 15.8), 150)])
def test_figure_pixel_size_is_figsize_times_dpi(figsize, dpi, tmp_path):
    fig, ax = raster.subplots(figsize=figsize)
    ax.plot([0, 1, 2], [1, 3, 2])
    ax.set_title("t")
    fig.tight_layout()
    size = fig.savefig(tmp_path / "f.png", dpi=dpi)
    img = decode_png((tmp_path / "f.png").read_bytes())
    assert size == (int(figsize[0] * dpi), int(figsize[1] * dpi)) == img.shape[1::-1]


def test_scatter_marks_land_on_the_transformed_pixels(tmp_path):
    fig, ax = raster.subplots(figsize=(4, 3))
    pts = np.array([[0.0, 0.0], [10.0, 5.0], [3.0, 1.0], [7.0, 4.0]])
    ax.scatter(pts[:2, 0], pts[:2, 1], s=30, c="C3")
    ax.scatter(pts[2:, 0], pts[2:, 1], s=30, c="C0", marker="x")
    fig.savefig(tmp_path / "s.png", dpi=100)
    img = decode_png((tmp_path / "s.png").read_bytes()).astype(int)
    px, py = ax._tx(pts[:, 0]), ax._ty(pts[:, 1])
    assert abs(ax._xl[0] - (-0.5)) < 1e-9 and abs(ax._xl[1] - 10.5) < 1e-9
    for (x, y), color in zip(zip(px, py), ("C3", "C3", "C0", "C0")):
        want = np.round(np.array(raster.to_rgba(color)[:3]) * 255)
        got = img[int(y), int(x)]
        assert np.abs(got - want).max() <= 2, (x, y, got, want)
    # a blank pixel between the marks stays white
    assert (img[int(py[0]) - 20, int(px[0]) + 30] == 255).all()


@pytest.mark.parametrize("s,rotation", [("Dim 1 – P2 (●R, ×G) θf/αp −3", 0),
                                        ("AF3", 45), ("Amplitude", 90)])
def test_text_draws_ink(s, rotation):
    cv = raster.Canvas(400, 300)
    box = raster.draw_text(cv, s, 200, 150, 20.0, ha="center", va="center",
                           rotation=rotation)
    ink = np.argwhere((cv.rgb < 128).any(axis=2))
    assert len(ink) > 20
    (y0, x0), (y1, x1) = ink.min(0), ink.max(0)
    assert box[0] - 2 <= x0 and x1 <= box[2] + 2 and box[1] - 2 <= y0 and y1 <= box[3] + 2
    if rotation == 90:
        assert (y1 - y0) > 2 * (x1 - x0)


def test_tight_bbox_crops_to_the_ink(tmp_path):
    fig = raster.Figure(figsize=(8, 2))
    fig.legend([raster.Line2D(marker="o", color="C1")], ["one"], fontsize=7, frameon=False)
    w, h = fig.savefig(tmp_path / "l.png", dpi=170, bbox_inches="tight")
    assert w < 8 * 170 and h < 2 * 170
    img = decode_png((tmp_path / "l.png").read_bytes())
    assert img.shape[:2] == (h, w) and (img < 200).any()


def test_no_matplotlib_or_sklearn_needed(tmp_path):
    """A fresh interpreter with matplotlib, scikit-learn, PIL and pandas made
    unimportable draws the cluster and trace families."""
    code = f"""
import sys
for m in ("matplotlib", "sklearn", "PIL", "pandas", "jax"):
    sys.modules[m] = None
import numpy as np
from eegsynth_torch.viz.cluster import cluster_figures
from eegsynth_torch.viz.traces import plot_pair
rng = np.random.default_rng(0)
pairs = {{(1, "no_exo"): (rng.normal(size=(9, 8, 2)).astype(np.float32),
                        rng.normal(size=(9, 8, 2)).astype(np.float32))}}
cluster_figures(pairs, {str(tmp_path)!r}, tsne_perplexity=3.0, device="cpu")
plot_pair(pairs[(1, "no_exo")][0], pairs[(1, "no_exo")][1], ["a", "b"], 128.0,
          {str(tmp_path)!r}, "p", n_samples=2)
"""
    proc = subprocess.run([sys.executable, "-c", code], cwd=REPO, capture_output=True,
                          text=True)
    assert proc.returncode == 0, proc.stderr
    assert sorted(p.name for p in tmp_path.iterdir()) == [
        "pca_combined.png", "samples_p.png", "summary_p.png", "tsne_combined.png"]


def test_the_port_imports_no_plotting_or_jax_package():
    pat = re.compile(r"^\s*(import|from) (matplotlib|sklearn|PIL|pandas|jax|eegsynth)\b")
    offenders = []
    for path in [*sorted((REPO / "eegsynth_torch").rglob("*.py")), REPO / "chip_smoke.py"]:
        if path.name == "make_glyph_atlas.py":
            continue
        for i, line in enumerate(path.read_text().splitlines(), 1):
            if pat.match(line):
                offenders.append(f"{path.relative_to(REPO)}:{i}")
    assert offenders == []
