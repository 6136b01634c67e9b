"""Generate the raster layer's tables from matplotlib: the DejaVu Sans glyph
atlas (``eegsynth_torch/viz/_glyph_atlas.py``) and the viridis colormap
(``eegsynth_torch/viz/_viridis.py``).

A development tool, run once where matplotlib is installed:

    python -m eegsynth_torch.tools.make_glyph_atlas

Nothing at run time imports it; the port draws its figures without
matplotlib. The atlas holds every character the figures print (ASCII 32-126
and ``CHARS_EXTRA``) rendered by FreeType at each of ``SIZES`` pixels per em
as 8-bit coverage, with each glyph's bitmap offset, descent and advance, in a
zlib-compressed, base64-encoded string.

DejaVu Sans is under the Bitstream Vera Fonts license (with the DejaVu
changes in the public domain): the glyphs may be used, copied, modified and
redistributed provided the copyright and license notice stays with them, as
it does in the generated module's header.
"""

from __future__ import annotations

import base64
import json
import zlib
from pathlib import Path

import numpy as np

SIZES = (20, 40)
CHARS_EXTRA = "–●×θα−"   # – ● × θ α −
VIZ = Path(__file__).resolve().parent.parent / "viz"

LICENSE = """\
Glyphs of DejaVu Sans (matplotlib's bundled DejaVuSans.ttf).
Fonts are (c) Bitstream (see below). DejaVu changes are in public domain.
Bitstream Vera Fonts Copyright (c) 2003 by Bitstream, Inc. All Rights
Reserved. Bitstream Vera is a trademark of Bitstream, Inc. Permission is
hereby granted, free of charge, to any person obtaining a copy of the fonts
accompanying this license ("Fonts") and associated documentation files, to
reproduce and distribute the Font Software, including without limitation the
rights to use, copy, merge, publish, distribute, and/or sell copies of the
Font Software, and to permit persons to whom the Font Software is furnished
to do so, subject to the following conditions: The above copyright and
trademark notices and this permission notice shall be included in all copies
of one or more of the Font Software typefaces. The Font Software may be
modified, altered, or added to, and in particular the designs of glyphs or
characters in the Fonts may be modified and additional glyphs or characters
may be added to the Fonts, only if the fonts are renamed to names not
containing either the words "Bitstream" or the word "Vera". THE FONT
SOFTWARE IS PROVIDED "AS IS", WITHOUT WARRANTY OF ANY KIND."""


def render_atlas() -> tuple[list, bytes]:
    """Per size, [code, width, height, x offset, descent, advance] of every
    glyph, and their bitmaps concatenated in that order."""
    from matplotlib import font_manager
    from matplotlib.ft2font import FT2Font, LoadFlags

    font = FT2Font(font_manager.findfont("DejaVu Sans"))
    chars = [chr(c) for c in range(32, 127)] + list(CHARS_EXTRA)
    meta, blobs = [], []
    for size in SIZES:
        font.set_size(size, 72)
        rows = []
        for ch in chars:
            glyph = font.load_char(ord(ch), flags=LoadFlags.DEFAULT)
            font.set_text(ch, 0.0, flags=LoadFlags.DEFAULT)
            font.draw_glyphs_to_bitmap(antialiased=True)
            img = np.asarray(font.get_image(), dtype=np.uint8)
            if ch == " ":
                img = np.zeros((0, 0), np.uint8)
            xo = font.get_bitmap_offset()[0] / 64.0
            rows.append([ord(ch), int(img.shape[1]), int(img.shape[0]), xo,
                         font.get_descent() / 64.0, glyph.linearHoriAdvance / 65536.0])
            blobs.append(np.ascontiguousarray(img).tobytes())
        meta.append([size, rows])
    return meta, b"".join(blobs)


def write_atlas(path: Path = VIZ / "_glyph_atlas.py") -> None:
    meta, bitmaps = render_atlas()
    head = json.dumps(meta, separators=(",", ":")).encode()
    blob = len(head).to_bytes(4, "little") + head + bitmaps
    text = base64.b64encode(zlib.compress(blob, 9)).decode()
    lines = [text[i:i + 76] for i in range(0, len(text), 76)]
    header = "\n".join("# " + line if line else "#" for line in LICENSE.splitlines())
    path.write_text(
        '"""DejaVu Sans glyph atlas of the raster layer (generated by\n'
        "``python -m eegsynth_torch.tools.make_glyph_atlas``; do not edit).\n\n"
        "``DATA`` is base64 of zlib of: a 4-byte little-endian length, a JSON list\n"
        "[[pixels per em, [[code, width, height, x offset, descent, advance],\n"
        '...]], ...], then every glyph\'s 8-bit coverage bitmap in that order."""\n\n'
        f"{header}\n\n"
        "DATA = (\n" + "\n".join(f'    "{line}"' for line in lines) + "\n)\n")


def write_viridis(path: Path = VIZ / "_viridis.py") -> None:
    import matplotlib

    lut = matplotlib.colormaps["viridis"].colors
    rows = "\n".join(f"    ({r!r}, {g!r}, {b!r})," for r, g, b in lut)
    path.write_text(
        '"""matplotlib\'s viridis colormap, its 256 RGB rows (generated by\n'
        '``python -m eegsynth_torch.tools.make_glyph_atlas``; do not edit)."""\n\n'
        f"VIRIDIS = (\n{rows}\n)\n")


if __name__ == "__main__":
    write_atlas()
    write_viridis()
