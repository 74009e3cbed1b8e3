"""Build ``dejavu.npz``, the glyph table that ``utils/chart.py`` draws text with.

Run once, on a machine with matplotlib, from the repository root::

    python -m fce_yolo_tpu_torch.utils.fonts.make_table

It reads DejaVu Sans and DejaVu Sans Bold from the TTF files matplotlib
bundles (``mpl-data/fonts/ttf``; licence in ``LICENSE_DEJAVU`` beside this
file) through ``matplotlib.ft2font``, and also writes ``colormaps.npz``: the
``Blues``, ``viridis`` and ``gray`` colormaps as 256 float64 RGB entries
each. The package never imports this module.

For each face and each character of ``CHARS`` (printable ASCII, U+2212 MINUS
SIGN, and the face's missing-glyph box last) the table holds:

- ``{face}_pts`` / ``{face}_ends`` / ``{face}_first``: the unhinted outline in
  font units (2048 an em) times 2, quadratic arcs flattened to within
  ``TOLERANCE`` font units; ``_ends`` closes each contour, ``_first[g]`` is
  glyph ``g``'s first contour.
- ``{face}_kern``: the pairs of character indices that the face kerns.
- ``{face}_hinted`` (size, dpi, glyph, [advance, ymin, ymax]) and
  ``{face}_hkern`` (size, dpi, pair): what matplotlib's Agg text layout uses,
  in 1/64 px: ``FT2Font.set_size(size, dpi)`` with hinting factor 8, each glyph
  loaded with ``FORCE_AUTOHINT`` (its advance after the 1/8 x transform, its
  control box's y range) and ``get_kerning(..., Kerning.DEFAULT)`` per pair,
  at every ``SIZES`` x ``DPIS``. These are the only text sizes and dpis the
  renderer lays out; a figure that needs another adds it here.
"""

from __future__ import annotations

from pathlib import Path

import numpy as np

CHARS = [chr(c) for c in range(32, 127)] + ["−"]
SIZES = [5, 5.79, 6, 6.94, 7, 8, 8.33, 9, 10, 11, 12, 13, 14, 14.4, 15, 16, 17.28, 18, 20]
DPIS = [72, 100, 120, 150, 200]
TOLERANCE = 1.0
FACES = {"regular": "DejaVuSans.ttf", "bold": "DejaVuSans-Bold.ttf"}
OUT = Path(__file__).with_name("dejavu.npz")
CMAPS_OUT = Path(__file__).with_name("colormaps.npz")
CMAPS = ("Blues", "viridis", "gray")


def _flatten(verts: np.ndarray, codes: np.ndarray) -> list[np.ndarray]:
    """MOVETO/LINETO/CURVE3/CLOSEPOLY path -> closed polygons (font units)."""
    contours, cur, i = [], [], 0
    while i < len(codes):
        c = codes[i]
        if c == 1:  # MOVETO
            if len(cur) > 2:
                contours.append(np.array(cur))
            cur = [verts[i]]
            i += 1
        elif c == 2:  # LINETO
            cur.append(verts[i])
            i += 1
        elif c == 3:  # CURVE3: control point, end point
            p0, p1, p2 = np.asarray(cur[-1]), verts[i], verts[i + 1]
            bend = np.hypot(*(p0 - 2 * p1 + p2))
            n = int(min(32, max(1, np.ceil(np.sqrt(bend / (8 * TOLERANCE))))))
            for t in np.arange(1, n + 1) / n:
                cur.append((1 - t) ** 2 * p0 + 2 * (1 - t) * t * p1 + t * t * p2)
            i += 2
        else:  # CLOSEPOLY (its vertex is ignored) or STOP
            i += 1
    if len(cur) > 2:
        contours.append(np.array(cur))
    return contours


def build() -> dict[str, np.ndarray]:
    import matplotlib
    from matplotlib import ft2font

    ttf = Path(matplotlib.get_data_path()) / "fonts" / "ttf"
    flags = ft2font.LoadFlags.FORCE_AUTOHINT  # matplotlib's text.hinting default
    out: dict[str, np.ndarray] = {
        "chars": np.array([ord(c) for c in CHARS], np.int32),
        "sizes": np.array(SIZES, np.float64),
        "dpis": np.array(DPIS, np.int32),
    }
    for face, fname in FACES.items():
        outline = ft2font.FT2Font(str(ttf / fname), hinting_factor=1)
        outline.set_size(outline.units_per_EM, 72)  # 1 px = 1 font unit
        gids = [outline.get_char_index(ord(c)) for c in CHARS] + [0]
        pts, ends, first = [], [], [0]
        for gid in gids:
            outline.load_glyph(gid, ft2font.LoadFlags.NO_HINTING)
            verts, codes = outline.get_path()
            for poly in _flatten(np.asarray(verts, np.float64), np.asarray(codes)):
                pts.append(np.round(poly * 2).astype(np.int16))
                ends.append(sum(len(p) for p in pts))
            first.append(len(ends))
        out[f"{face}_pts"] = np.concatenate(pts)
        out[f"{face}_ends"] = np.array(ends, np.int32)
        out[f"{face}_first"] = np.array(first, np.int32)

        pairs = [(i, j) for i, a in enumerate(gids[:-1]) for j, b in enumerate(gids[:-1])
                 if a and b and outline.get_kerning(a, b, ft2font.Kerning.UNSCALED)]
        out[f"{face}_kern"] = np.array(pairs, np.int16).reshape(-1, 2)

        font = ft2font.FT2Font(str(ttf / fname), hinting_factor=8)
        hinted = np.zeros((len(SIZES), len(DPIS), len(gids), 3), np.int16)
        hkern = np.zeros((len(SIZES), len(DPIS), len(pairs)), np.int16)
        for si, size in enumerate(SIZES):
            for di, dpi in enumerate(DPIS):
                font.set_size(size, dpi)
                for g, gid in enumerate(gids):
                    glyph = font.load_glyph(gid, flags)
                    # FT_MulFix(advance, 1/8): the advance after the hinting-factor transform
                    hinted[si, di, g] = ((glyph.horiAdvance * 8192 + 0x8000) >> 16, glyph.bbox[1], glyph.bbox[3])
                hkern[si, di] = [font.get_kerning(gids[i], gids[j], ft2font.Kerning.DEFAULT) for i, j in pairs]
        out[f"{face}_hinted"] = hinted
        out[f"{face}_hkern"] = hkern
    return out


def colormaps() -> dict[str, np.ndarray]:
    """The 256-entry RGB tables of ``CMAPS`` as matplotlib builds them (float64)."""
    import matplotlib

    return {name: matplotlib.colormaps[name](np.arange(256))[:, :3] for name in CMAPS}


def main() -> None:
    np.savez_compressed(OUT, **build())
    np.savez_compressed(CMAPS_OUT, **colormaps())
    for f in (OUT, CMAPS_OUT):
        print(f"wrote {f} ({f.stat().st_size} bytes)")


if __name__ == "__main__":
    main()
