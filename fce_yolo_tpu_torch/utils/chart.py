"""Charts without matplotlib or PIL: the subset of matplotlib's API that the
reference's figures call, laid out by matplotlib's rules and drawn with numpy.

The reference draws its figures with matplotlib (``fce_yolo_tpu/utils/plotting.py``,
``experiments/figures.py``, ``utils/annotator.py``); the card machine has
neither matplotlib nor PIL. This module carries matplotlib 3.10's layout rules
across, so that a figure built through it has matplotlib's content and layout:

- text metrics: DejaVu Sans / DejaVu Sans Bold from ``fonts/dejavu.npz``
  (``fonts/make_table.py``). At the sizes and resolutions it tabulates, a
  string's width, height and descent equal the Agg backend's (hinted advances,
  kerning and control boxes, as ``FT2Font.set_text`` sums them); elsewhere
  they come from the unhinted outlines;
- ``Text._get_layout`` (alignment, rotation, multi-line text), the Axis tick
  label and axis label placement, the title offset;
- ``AutoLocator`` (``MaxNLocator`` with steps 1, 2, 2.5, 5, 10), ``ScalarFormatter``
  (offset, order of magnitude, unicode minus), ``FixedLocator``/``FixedFormatter``;
- autoscaling with 5 % margins, sticky edges and ``nonsingular``;
- ``GridSpec`` positions, ``tight_layout``, ``apply_aspect``, the colorbar's
  ``make_axes_gridspec``, ``bbox_inches="tight"``;
- the legend's box packing and its ``loc="best"`` search;
- the tab10 colour cycle and the ``Blues``, ``viridis`` and ``gray``
  colormaps (``fonts/colormaps.npz``).

Pixels are drawn on the host: strokes by their distance to each segment
(anti-aliased, round joins, projecting caps), filled outlines (glyphs, marker
crosses) by exact horizontal coverage on sub-sampled rows, axis-aligned lines
and bars snapped to the pixel grid as Agg snaps them. Glyphs are filled from
the unhinted outlines, so text pixels differ from FreeType's hinted ones
within a pixel. ``Figure.savefig`` writes PNG through ``utils/patches.py``.

Coordinates: display pixels with y up (matplotlib's), figure fractions, axes
fractions and data; a canvas row is ``height - y``.
"""

from __future__ import annotations

import itertools
import math
import warnings
from functools import lru_cache
from pathlib import Path

import numpy as np

__all__ = ["Figure", "Axes", "Text", "subplots", "sca", "gca", "scatter", "close", "to_rgba",
           "colormap", "text_extent", "draw_text"]

_DATA = Path(__file__).with_name("fonts")
MINUS = "\N{MINUS SIGN}"

# --------------------------------------------------------------------------- colours

TAB10 = ("#1f77b4", "#ff7f0e", "#2ca02c", "#d62728", "#9467bd", "#8c564b", "#e377c2", "#7f7f7f", "#bcbd22",
         "#17becf")
_NAMED = {
    "b": (0.0, 0.0, 1.0), "g": (0.0, 0.5, 0.0), "r": (1.0, 0.0, 0.0), "c": (0.0, 0.75, 0.75),
    "m": (0.75, 0.0, 0.75), "y": (0.75, 0.75, 0.0), "k": (0.0, 0.0, 0.0), "w": (1.0, 1.0, 1.0),
    "blue": "#0000FF", "black": "#000000", "white": "#FFFFFF", "grey": "#808080", "gray": "#808080",
}


def to_rgba(c, alpha: float | None = None) -> tuple[float, float, float, float]:
    """matplotlib's ``to_rgba`` for the colours the figures use: ``"none"``,
    ``#rrggbb``, a gray level string, ``"C<n>"``, the one-letter names and
    blue, black, white and grey, or an RGB(A) tuple. ``alpha`` replaces the
    colour's own."""
    if isinstance(c, str):
        s = c.strip()
        low = s.lower()
        if low == "none":
            return (0.0, 0.0, 0.0, 0.0)
        if len(s) == 2 and s[0] == "C" and s[1].isdigit():
            s = TAB10[int(s[1])]
        elif low in _NAMED:
            v = _NAMED[low]
            s = v if isinstance(v, str) else None
            if s is None:
                return (*v, 1.0 if alpha is None else float(alpha))
        if s.startswith("#"):
            h = s[1:]
            rgba = [int(h[i:i + 2], 16) / 255 for i in range(0, len(h), 2)]
            if len(rgba) == 3:
                rgba.append(1.0)
        else:
            try:
                g = float(s)
            except ValueError:
                raise ValueError(f"unknown colour {c!r}") from None
            if not 0 <= g <= 1:
                raise ValueError(f"gray level {c!r} is outside 0-1")
            rgba = [g, g, g, 1.0]
    else:
        rgba = [float(v) for v in c]
        if len(rgba) == 3:
            rgba.append(1.0)
    if alpha is not None:
        rgba[3] = float(alpha)
    return tuple(rgba)


@lru_cache(None)
def _cmap_lut(name: str) -> np.ndarray:
    with np.load(_DATA / "colormaps.npz") as d:
        if name not in d.files:
            raise ValueError(f"unknown colormap {name!r}; the renderer has {', '.join(d.files)}")
        return d[name].astype(np.float64)


def colormap(name: str, x: np.ndarray, bytes: bool = False) -> np.ndarray:
    """``matplotlib.colormaps[name](x)`` for floats in [0, 1] (RGBA; NaN is
    transparent, below 0 and above 1 clip to the ends). ``bytes``: uint8
    as matplotlib truncates them."""
    lut = np.concatenate([_cmap_lut(name), np.ones((256, 1))], 1)
    x = np.asarray(x, np.float64)
    xa = x * 256
    xa[xa == 256] = 255
    bad = np.isnan(xa)
    idx = np.clip(np.where(bad, 0, xa), -1, 256).astype(int)
    idx = np.clip(idx, 0, 255)
    out = lut[idx]
    out[bad] = 0.0
    return (out * 255).astype(np.uint8) if bytes else out


# --------------------------------------------------------------------------- fonts


class _Face:
    """One face of the glyph table (``fonts/make_table.py``)."""

    def __init__(self, d, face: str):
        self.chars = {int(c): i for i, c in enumerate(d["chars"])}
        self.notdef = len(self.chars)
        self.pts = d[f"{face}_pts"].astype(np.float64) / 2 / 2048  # em units
        self.ends = d[f"{face}_ends"]
        self.first = d[f"{face}_first"]
        kern = d[f"{face}_kern"]
        self.kern_index = {(int(a), int(b)): k for k, (a, b) in enumerate(kern)}
        self.hinted = d[f"{face}_hinted"].astype(np.int64)
        self.hkern = d[f"{face}_hkern"].astype(np.int64)
        self.sizes = d["sizes"]
        self.dpis = d["dpis"]

    def glyph(self, ch: str) -> int:
        return self.chars.get(ord(ch), self.notdef)

    def contours(self, g: int) -> list[np.ndarray]:
        out = []
        for c in range(self.first[g], self.first[g + 1]):
            start = self.ends[c - 1] if c else 0
            out.append(self.pts[start:self.ends[c]])
        return out

    def _table(self, size: float, dpi: float) -> tuple[int, int]:
        si = np.nonzero(np.abs(self.sizes - size) < 1e-6)[0]
        di = np.nonzero(self.dpis == dpi)[0]
        if not (len(si) and len(di)):
            raise ValueError(f"text at {size} pt and {dpi} dpi is not in the font table: add the size to SIZES "
                             "and the dpi to DPIS in fce_yolo_tpu_torch/utils/fonts/make_table.py and rebuild it")
        return int(si[0]), int(di[0])

    def layout(self, s: str, size: float, dpi: float) -> tuple[list[float], int, int, int]:
        """``FT2Font.set_text(s)`` after ``set_size(size, dpi)``: the pen x of
        each glyph and the string's advance, ymin and ymax (1/64 px)."""
        si, di = self._table(size, dpi)
        pen, ymin, ymax, prev = 0, None, None, None
        xs = []
        for ch in s:
            g = self.glyph(ch)
            if prev is not None and prev != self.notdef and g != self.notdef:
                k = self.kern_index.get((prev, g))
                if k is not None:
                    pen += int(self.hkern[si, di, k])
            adv, y0, y1 = (int(v) for v in self.hinted[si, di, g])
            ymin = y0 if ymin is None else min(ymin, y0)
            ymax = y1 if ymax is None else max(ymax, y1)
            xs.append(pen)
            pen += adv
            prev = g
        return xs, pen, ymin or 0, ymax or 0


@lru_cache(None)
def _faces() -> dict[str, _Face]:
    with np.load(_DATA / "dejavu.npz") as d:
        return {"normal": _Face(d, "regular"), "bold": _Face(d, "bold")}


def _face(weight) -> _Face:
    return _faces()["bold" if weight in ("bold", "heavy", "semibold", "demibold", "extra bold", "black")
                    or (isinstance(weight, (int, float)) and weight >= 600) else "normal"]


@lru_cache(4096)
def text_extent(s: str, size: float, weight: str, dpi: float) -> tuple[float, float, float]:
    """(width, height, descent) of one line in px, as the Agg renderer's
    ``get_text_width_height_descent``."""
    _, adv, ymin, ymax = _face(weight).layout(s, size, dpi)
    return adv / 64.0, (ymax - ymin) / 64.0, -ymin / 64.0


_FONT_SCALINGS = {"xx-small": 0.579, "x-small": 0.694, "small": 0.833, "medium": 1.0, "large": 1.2,
                  "x-large": 1.44, "xx-large": 1.728, "larger": 1.2, "smaller": 0.833}


def _points(size) -> float:
    return float(_FONT_SCALINGS[size] * 10.0) if isinstance(size, str) else float(size)


# --------------------------------------------------------------------------- bboxes


class Bbox:
    """x0, y0, x1, y1 (display px or figure fractions)."""

    __slots__ = ("x0", "y0", "x1", "y1")

    def __init__(self, x0, y0, x1, y1):
        self.x0, self.y0, self.x1, self.y1 = float(x0), float(y0), float(x1), float(y1)

    @classmethod
    def from_bounds(cls, x, y, w, h) -> Bbox:
        return cls(x, y, x + w, y + h)

    @property
    def width(self) -> float:
        return self.x1 - self.x0

    @property
    def height(self) -> float:
        return self.y1 - self.y0

    @property
    def bounds(self) -> tuple[float, float, float, float]:
        return self.x0, self.y0, self.width, self.height

    def translated(self, dx, dy) -> Bbox:
        return Bbox(self.x0 + dx, self.y0 + dy, self.x1 + dx, self.y1 + dy)

    def padded(self, p) -> Bbox:
        return Bbox(self.x0 - p, self.y0 - p, self.x1 + p, self.y1 + p)

    @staticmethod
    def union(boxes) -> Bbox:
        boxes = list(boxes)
        return Bbox(min(b.x0 for b in boxes), min(b.y0 for b in boxes), max(b.x1 for b in boxes),
                    max(b.y1 for b in boxes))

    def anchored(self, c, container: Bbox) -> Bbox:
        cx, cy = _ANCHORS[c] if isinstance(c, str) else c
        l, b, w, h = container.bounds
        return self.translated((l + cx * (w - self.width)) - self.x0, (b + cy * (h - self.height)) - self.y0)

    def shrunk_to_aspect(self, box_aspect: float, fig_aspect: float) -> Bbox:
        w, h = self.width, self.height
        H = w * box_aspect / fig_aspect
        if H <= h:
            W = w
        else:
            W, H = h * fig_aspect / box_aspect, h
        return Bbox(self.x0, self.y0, self.x0 + W, self.y0 + H)


_ANCHORS = {"C": (0.5, 0.5), "SW": (0, 0), "S": (0.5, 0), "SE": (1.0, 0), "E": (1.0, 0.5), "NE": (1.0, 1.0),
            "N": (0.5, 1.0), "NW": (0, 1.0), "W": (0, 0.5)}


# --------------------------------------------------------------------------- text


class Text:
    """A text artist: its string, font, colour and alignment, and where its
    anchor is (``coords``: "data", "axes", "figure" or "display", plus an
    ``offset`` in points)."""

    zorder = 3.0

    def __init__(self, x=0.0, y=0.0, text="", *, fontsize=10.0, fontweight="normal", color="black", ha="left",
                 va="baseline", rotation=0.0, rotation_mode="default", coords="data", offset=(0.0, 0.0),
                 alpha=None, ma=None, owner=None):
        self.x, self.y = x, y
        self.text = str(text)
        self.fontsize = _points(fontsize)
        self.fontweight = fontweight
        self.color = color
        self.ha, self.va = ha, va
        self.rotation = self.normalize_rotation(rotation)
        self.rotation_mode = rotation_mode
        self.coords = coords
        self.offset = offset
        self.alpha = alpha
        self.ma = ma
        self.owner = owner  # the Axes or Figure that places "data"/"axes"/"figure" anchors
        self.visible = True

    @staticmethod
    def normalize_rotation(r) -> float:
        if r in (None, "horizontal"):
            return 0.0
        if r == "vertical":
            return 90.0
        return float(r) % 360

    def get_text(self) -> str:
        return self.text

    def get_color(self):
        return self.color

    def anchor(self, dpi: float) -> tuple[float, float]:
        if self.coords == "display":
            x, y = self.x, self.y
        elif self.coords == "figure":
            fw, fh = self.owner.display_size(dpi)
            x, y = self.x * fw, self.y * fh
        elif self.coords == "axes":
            b = self.owner.bbox(dpi)
            x, y = b.x0 + self.x * b.width, b.y0 + self.y * b.height
        else:
            x, y = self.owner.data_to_display(np.array([[self.x, self.y]], np.float64), dpi)[0]
        return x + self.offset[0] * dpi / 72, y + self.offset[1] * dpi / 72

    def layout(self, dpi: float):
        """``Text._get_layout``: the rotated bbox relative to the anchor, each
        line with its (width, height) and baseline-left point, and the last
        line's descent."""
        lines = self.text.split("\n")
        _, lp_h, lp_d = text_extent("lp", self.fontsize, self.fontweight, dpi)
        min_dy = (lp_h - lp_d) * 1.2
        ws, hs, xs, ys = [], [], [], []
        thisy = 0.0
        baseline = d = 0.0
        for i, line in enumerate(lines):
            w, h, d = text_extent(line, self.fontsize, self.fontweight, dpi) if line else (0.0, 0.0, 0.0)
            h, d = max(h, lp_h), max(d, lp_d)
            ws.append(w)
            hs.append(h)
            baseline = (h - d) - thisy
            thisy = -(h - d) if i == 0 else thisy - max(min_dy, (h - d) * 1.2)
            xs.append(0.0)
            ys.append(thisy)
            thisy -= d
        descent = d
        width = max(ws)
        xmin, xmax, ymax, ymin = 0.0, width, 0.0, ys[-1] - descent
        theta = math.radians(self.rotation)
        c, s = math.cos(theta), math.sin(theta)

        def rot(px, py):
            return px * c - py * s, px * s + py * c

        malign = self.ma or self.ha
        if malign == "center":
            offs = [(x + width / 2 - w / 2, y) for x, y, w in zip(xs, ys, ws)]
        elif malign == "right":
            offs = [(x + width - w, y) for x, y, w in zip(xs, ys, ws)]
        else:
            offs = list(zip(xs, ys))
        corners_h = [(xmin, ymin), (xmin, ymax), (xmax, ymax), (xmax, ymin)]
        corners = [rot(*p) for p in corners_h]
        xmin = min(p[0] for p in corners)
        xmax = max(p[0] for p in corners)
        ymin = min(p[1] for p in corners)
        ymax = max(p[1] for p in corners)
        width, height = xmax - xmin, ymax - ymin
        ha, va = self.ha, self.va
        if self.rotation_mode != "anchor":
            offsetx = (xmin + xmax) / 2 if ha == "center" else xmax if ha == "right" else xmin
            offsety = {"center": (ymin + ymax) / 2, "top": ymax, "baseline": ymin + descent,
                       "center_baseline": ymin + height - baseline / 2.0}.get(va, ymin)
        else:
            (xmin1, ymin1), (xmax1, ymax1) = corners_h[0], corners_h[2]
            offsetx = (xmin1 + xmax1) / 2.0 if ha == "center" else xmax1 if ha == "right" else xmin1
            offsety = {"center": (ymin1 + ymax1) / 2.0, "top": ymax1, "baseline": ymax1 - baseline,
                       "center_baseline": ymax1 - baseline / 2.0}.get(va, ymin1)
            offsetx, offsety = rot(offsetx, offsety)
        bbox = Bbox.from_bounds(xmin - offsetx, ymin - offsety, width, height)
        info = []
        for line, w, h, (ox, oy) in zip(lines, ws, hs, offs):
            rx, ry = rot(ox, oy)
            info.append((line, (w, h), rx - offsetx, ry - offsety))
        return bbox, info, descent

    def window_extent(self, dpi: float) -> Bbox:
        x, y = self.anchor(dpi)
        if not self.text:
            return Bbox(x, y, x, y)
        return self.layout(dpi)[0].translated(x, y)

    def draw(self, canvas: _Canvas, dpi: float) -> None:
        if not self.text or not self.visible:
            return
        rgba = to_rgba(self.color, self.alpha)
        if rgba[3] == 0:
            return
        ax, ay = self.anchor(dpi)
        _, info, _ = self.layout(dpi)
        face = _face(self.fontweight)
        ppem = self.fontsize * dpi / 72
        theta = math.radians(self.rotation)
        c, s = math.cos(theta), math.sin(theta)
        polys = []
        for line, _, lx, ly in info:
            if not line:
                continue
            pens, _, _, _ = face.layout(line, self.fontsize, dpi)
            # the Agg backend puts a line's bitmap at whole pixels (canvas rows top down)
            ox, oy = round(ax + lx), round(canvas.hf - (ay + ly))
            for ch, pen in zip(line, pens):
                for cont in face.contours(face.glyph(ch)):
                    px = cont[:, 0] * ppem + pen / 64.0
                    py = cont[:, 1] * ppem
                    polys.append(np.stack([ox + px * c - py * s, oy - (px * s + py * c)], 1))
        canvas.fill(polys, rgba)


# --------------------------------------------------------------------------- ticks


def _nonsingular(vmin, vmax, expander=0.001, tiny=1e-15, increasing=True):
    if not np.isfinite(vmin) or not np.isfinite(vmax):
        return -expander, expander
    swapped = False
    if vmax < vmin:
        vmin, vmax, swapped = vmax, vmin, True
    vmin, vmax = float(vmin), float(vmax)
    maxabsvalue = max(abs(vmin), abs(vmax))
    if maxabsvalue < (1e6 / tiny) * np.finfo(float).tiny:
        vmin, vmax = -expander, expander
    elif vmax - vmin <= maxabsvalue * tiny:
        if vmax == 0 and vmin == 0:
            vmin, vmax = -expander, expander
        else:
            vmin -= expander * abs(vmin)
            vmax += expander * abs(vmax)
    if swapped and not increasing:
        vmin, vmax = vmax, vmin
    return vmin, vmax


def _scale_range(vmin, vmax, n=1, threshold=100):
    dv = abs(vmax - vmin)
    meanv = (vmax + vmin) / 2
    offset = 0 if abs(meanv) / dv < threshold else math.copysign(10 ** (math.log10(abs(meanv)) // 1), meanv)
    return 10 ** (math.log10(dv / n) // 1), offset


class _EdgeInteger:
    def __init__(self, step, offset):
        self.step, self._offset = step, abs(offset)

    def closeto(self, ms, edge):
        if self._offset > 0:
            tol = min(0.4999, max(1e-10, 10 ** (np.log10(self._offset / self.step) - 12)))
        else:
            tol = 1e-10
        return abs(ms - edge) < tol

    def le(self, x):
        """The largest n with n * step <= x."""
        d, m = divmod(x, self.step)
        return d + 1 if self.closeto(m / self.step, 1) else d

    def ge(self, x):
        """The smallest n with n * step >= x."""
        d, m = divmod(x, self.step)
        return d if self.closeto(m / self.step, 0) else d + 1


_STEPS = np.array([1, 2, 2.5, 5, 10])
_EXTENDED_STEPS = np.concatenate([0.1 * _STEPS[:-1], _STEPS, [10 * _STEPS[1]]])


def auto_ticks(vmin: float, vmax: float, nbins: int, min_n_ticks: int = 2) -> np.ndarray:
    """``AutoLocator().tick_values(vmin, vmax)`` with ``nbins`` bins."""
    vmin, vmax = _nonsingular(vmin, vmax, expander=1e-13, tiny=1e-14)
    scale, offset = _scale_range(vmin, vmax, nbins)
    _vmin, _vmax = vmin - offset, vmax - offset
    steps = _EXTENDED_STEPS * scale
    raw_step = (_vmax - _vmin) / nbins
    large = steps >= raw_step
    istep = np.nonzero(large)[0][0] if large.any() else len(steps) - 1
    ticks = np.zeros(0)
    for step in steps[:istep + 1][::-1]:
        best_vmin = (_vmin // step) * step
        edge = _EdgeInteger(step, offset)
        low = edge.le(_vmin - best_vmin)
        high = edge.ge(_vmax - best_vmin)
        ticks = np.arange(low, high + 1) * step + best_vmin
        if ((ticks <= _vmax) & (ticks >= _vmin)).sum() >= min_n_ticks:
            break
    return ticks + offset


def _fix_minus(s: str) -> str:
    return s.replace("-", MINUS)


class ScalarFormatter:
    """matplotlib's default tick formatter (offset threshold 4, power limits
    (-5, 6), unicode minus, no mathtext)."""

    def __init__(self):
        self.locs: list[float] = []
        self.offset = 0.0
        self.orderOfMagnitude = 0
        self.format = ""

    def set_locs(self, locs, view) -> None:
        self.locs = list(locs)
        if len(self.locs):
            self._compute_offset(view)
            self._set_order_of_magnitude(view)
            self._set_format(view)

    def _compute_offset(self, view) -> None:
        vmin, vmax = sorted(view)
        locs = np.asarray(self.locs)
        locs = locs[(vmin <= locs) & (locs <= vmax)]
        if not len(locs):
            self.offset = 0
            return
        lmin, lmax = locs.min(), locs.max()
        if lmin == lmax or lmin <= 0 <= lmax:
            self.offset = 0
            return
        abs_min, abs_max = sorted([abs(float(lmin)), abs(float(lmax))])
        sign = math.copysign(1, lmin)
        oom_max = np.ceil(math.log10(abs_max))
        oom = 1 + next(o for o in itertools.count(oom_max, -1) if abs_min // 10 ** o != abs_max // 10 ** o)
        if (abs_max - abs_min) / 10 ** oom <= 1e-2:
            oom = 1 + next(o for o in itertools.count(oom_max, -1) if abs_max // 10 ** o - abs_min // 10 ** o > 1)
        self.offset = sign * (abs_max // 10 ** oom) * 10 ** oom if abs_max // 10 ** oom >= 10 ** 3 else 0

    def _set_order_of_magnitude(self, view) -> None:
        vmin, vmax = sorted(view)
        locs = np.asarray(self.locs)
        locs = np.abs(locs[(vmin <= locs) & (locs <= vmax)])
        if not len(locs):
            self.orderOfMagnitude = 0
            return
        if self.offset:
            oom = math.floor(math.log10(vmax - vmin))
        else:
            val = locs.max()
            oom = 0 if val == 0 else math.floor(math.log10(val))
        self.orderOfMagnitude = oom if (oom <= -5 or oom >= 6) else 0

    def _set_format(self, view) -> None:
        _locs = [*self.locs, *view] if len(self.locs) < 2 else self.locs
        locs = (np.asarray(_locs) - self.offset) / 10. ** self.orderOfMagnitude
        loc_range = np.ptp(locs)
        if loc_range == 0:
            loc_range = np.max(np.abs(locs))
        if loc_range == 0:
            loc_range = 1
        if len(self.locs) < 2:
            locs = locs[:-2]
        loc_range_oom = int(math.floor(math.log10(loc_range)))
        sigfigs = max(0, 3 - loc_range_oom)
        thresh = 1e-3 * 10 ** loc_range_oom
        while sigfigs >= 0:
            if np.abs(locs - np.round(locs, decimals=sigfigs)).max() < thresh:
                sigfigs -= 1
            else:
                break
        self.format = f"%1.{sigfigs + 1}f"

    def __call__(self, x, pos=None) -> str:
        if not len(self.locs):
            return ""
        xp = (x - self.offset) / (10. ** self.orderOfMagnitude)
        if abs(xp) < 1e-8:
            xp = 0
        return _fix_minus(self.format % xp)

    @staticmethod
    def _format_data(value) -> str:
        e = math.floor(math.log10(abs(value)))
        s = round(value / 10 ** e, 10)
        significand = _fix_minus(("%d" if s % 1 == 0 else "%1.10g") % s)
        return significand if e == 0 else f"{significand}e{_fix_minus('%d' % e)}"

    def get_offset(self) -> str:
        if not len(self.locs) or not (self.orderOfMagnitude or self.offset):
            return ""
        offset_str = sci = ""
        if self.offset:
            offset_str = self._format_data(self.offset)
            if self.offset > 0:
                offset_str = "+" + offset_str
        if self.orderOfMagnitude:
            sci = "1e%d" % self.orderOfMagnitude
        return _fix_minus(sci + offset_str)


class _Axis:
    """One axis of an Axes: ticks, tick labels, the axis label and the offset text."""

    def __init__(self, axes: Axes, name: str):
        self.axes, self.name = axes, name
        self.fixed_locs: list[float] | None = None
        self.fixed_labels: list[str] | None = None
        self.formatter = ScalarFormatter()
        self.labelsize: float | None = None  # tick_params(labelsize=...)
        self.ticklabel_kw: dict = {}  # set_*ticklabels(fontsize=, rotation=)
        self.label = Text(0.5 if name == "x" else 0.0, 0.0, "", coords="display", ha="center",
                          va="top" if name == "x" else "bottom", rotation=0 if name == "x" else 90,
                          rotation_mode="default" if name == "x" else "anchor")
        self.labelpad = 4.0
        self.side = "bottom" if name == "x" else "left"
        self.ticks_on = True
        self.grid_kw: dict | None = None
        self.inverted = False
        self.categories: dict[str, int] = {}  # a categorical axis: each string's position

    # --- locations and labels
    def tick_label_size(self) -> float:
        return _points(self.labelsize) if self.labelsize is not None else 10.0

    def tick_space(self) -> int:
        b = self.axes.bbox(72.0)  # 1 px = 1 pt
        length = b.width if self.name == "x" else b.height
        size = self.tick_label_size() * (3 if self.name == "x" else 2)
        return int(np.floor(length / size)) if size > 0 else 2 ** 31 - 1

    def view(self) -> tuple[float, float]:
        return self.axes.get_xlim() if self.name == "x" else self.axes.get_ylim()

    def locs(self) -> np.ndarray:
        if self.fixed_locs is not None:
            return np.asarray(self.fixed_locs, np.float64)
        vmin, vmax = self.view()
        nbins = int(np.clip(self.tick_space(), 1, 9))
        return auto_ticks(vmin, vmax, nbins)

    def ticklabels(self) -> list[str]:
        """The label of every tick the locator gives, as ``get_*ticklabels``."""
        locs = self.locs()
        if self.fixed_labels is not None:
            return [self.fixed_labels[i] if i < len(self.fixed_labels) else "" for i in range(len(locs))]
        self.formatter.set_locs(locs, self.view())
        return [self.formatter(x, i) for i, x in enumerate(locs)]

    def ticks(self) -> list[tuple[float, str]]:
        """The ticks drawn: (location, label) within the view interval."""
        locs = self.locs()
        view = self.view()
        labels = self.ticklabels()
        a, b = sorted(view)
        tol = (b - a) * 1e-10
        return [(float(x), s) for x, s in zip(locs, labels) if a - tol <= x <= b + tol]

    def offset_text(self) -> str:
        if self.fixed_labels is not None:
            return ""
        self.ticks()
        return self.formatter.get_offset()

    # --- placement
    def _pad_px(self, dpi: float) -> float:
        return (3.5 + (3.5 if self.ticks_on else 0.0)) * dpi / 72

    def tick_label_texts(self, dpi: float) -> list[Text]:
        ax = self.axes
        b = ax.bbox(dpi)
        out = []
        size = self.ticklabel_kw.get("fontsize", self.tick_label_size())
        rot = self.ticklabel_kw.get("rotation", 0)
        pad = self._pad_px(dpi)
        ticks = self.ticks()
        for (_, label), at in zip(ticks, self.display_locs([loc for loc, _ in ticks], dpi)):
            if self.name == "x":
                out.append(Text(at, b.y0 - pad, label, coords="display", fontsize=size, ha="center", va="top",
                                rotation=rot))
            elif self.side == "left":
                out.append(Text(b.x0 - pad, at, label, coords="display", fontsize=size, ha="right",
                                va="center_baseline", rotation=rot))
            else:
                out.append(Text(b.x1 + pad, at, label, coords="display", fontsize=size, ha="left",
                                va="center_baseline", rotation=rot))
        return out

    def display_locs(self, locs: list[float], dpi: float) -> np.ndarray:
        """Display x (x axis) or y (y axis) of data locations along this axis."""
        xy = np.zeros((len(locs), 2))
        xy[:, 0 if self.name == "x" else 1] = locs
        return self.axes.data_to_display(xy, dpi)[:, 0 if self.name == "x" else 1]

    def spine_extent(self, dpi: float) -> Bbox:
        b = self.axes.bbox(dpi)
        t = 3.5 * dpi / 72 if self.ticks_on and self.ticks() else 0.0
        if self.name == "x":
            return Bbox(b.x0, b.y0 - t, b.x1, b.y0)
        if self.side == "left":
            return Bbox(b.x0 - t, b.y0, b.x0, b.y1)
        return Bbox(b.x1, b.y0, b.x1 + t, b.y1)

    def layout(self, dpi: float) -> tuple[list[Text], Text | None]:
        """Tick label texts and the offset text, with the axis label placed."""
        labels = self.tick_label_texts(dpi)
        boxes = [t.window_extent(dpi) for t in labels if t.text]
        b = self.axes.bbox(dpi)
        spine = self.spine_extent(dpi)
        u = Bbox.union([*boxes, spine])
        pad = self.labelpad * dpi / 72
        if self.name == "x":
            self.label.x, self.label.y = (b.x0 + b.x1) / 2, u.y0 - pad
        else:
            self.label.x, self.label.y = u.x0 - pad, (b.y0 + b.y1) / 2
        off = self.offset_text()
        offset = None
        if off:
            if self.name == "x":
                bottom = Bbox.union(boxes).y0 if boxes else b.y0
                offset = Text(b.x1, bottom - 3 * dpi / 72, off, coords="display", ha="right", va="top")
            else:
                offset = Text(b.x0, b.y1 + 3 * dpi / 72, off, coords="display", ha="left", va="baseline")
        return labels, offset

    def tightbbox(self, dpi: float, for_layout_only: bool) -> Bbox | None:
        labels, offset = self.layout(dpi)
        boxes = [t.window_extent(dpi) for t in labels if t.text]
        if offset is not None:
            boxes.append(offset.window_extent(dpi))
        if self.label.text:
            bb = self.label.window_extent(dpi)
            if for_layout_only:
                if self.name == "x" and bb.width > 0:
                    bb.x0 = (bb.x0 + bb.x1) / 2 - 0.5
                    bb.x1 = bb.x0 + 1.0
                if self.name == "y" and bb.height > 0:
                    bb.y0 = (bb.y0 + bb.y1) / 2 - 0.5
                    bb.y1 = bb.y0 + 1.0
            boxes.append(bb)
        boxes = [bb for bb in boxes if 0 < bb.width < np.inf and 0 < bb.height < np.inf]
        return Bbox.union(boxes) if boxes else None


# --------------------------------------------------------------------------- artists


class Line2D:
    zorder = 2.0

    def __init__(self, x, y, *, color, lw, alpha=None, marker=None, ms=6.0, label="", ls="-", zorder=2.0):
        self.x = np.asarray(x, np.float64).ravel()
        self.y = np.asarray(y, np.float64).ravel()
        self.color, self.lw, self.alpha = color, float(lw), alpha
        self.marker, self.ms, self.label, self.ls = marker, float(ms), str(label), ls
        self.zorder = zorder

    def get_xdata(self) -> np.ndarray:
        return self.x

    def get_ydata(self) -> np.ndarray:
        return self.y

    def get_label(self) -> str:
        return self.label

    def get_color(self):
        return self.color


class Rectangle:
    zorder = 1.0

    label = "_nolegend_"

    def __init__(self, x, y, w, h, color):
        self.x, self.y, self.w, self.h, self.color = float(x), float(y), float(w), float(h), color
        self.sticky_y = [y]

    def set_label(self, label) -> None:
        self.label = str(label)

    def get_label(self) -> str:
        return self.label

    def get_x(self) -> float:
        return self.x

    def get_width(self) -> float:
        return self.w

    def get_height(self) -> float:
        return self.h


class PathCollection:
    """Scatter markers: circles of area ``s`` pt^2 at ``offsets``."""

    zorder = 1.0

    def __init__(self, offsets, s, facecolors, edgecolors, linewidth, alpha):
        self.offsets = offsets
        self.s = s
        self.facecolors = facecolors  # (N, 4) float
        self.edgecolors = edgecolors  # "face", "none" or a colour
        self.linewidth = linewidth
        self.alpha = alpha

    def get_offsets(self) -> np.ndarray:
        return self.offsets

    def get_facecolors(self) -> np.ndarray:
        return self.facecolors


class PolyCollection:
    """``fill_between``'s polygon (closed, in data coordinates): filled and
    edged in one colour with ``alpha``, edge 1 pt."""

    zorder = 1.0

    def __init__(self, verts: np.ndarray, color, alpha):
        self.verts, self.color, self.alpha = verts, color, alpha
        self.label = "_nolegend_"

    def get_facecolor(self):
        return to_rgba(self.color, self.alpha)


class Wedge:
    """A pie wedge: its outline as matplotlib's ``Wedge`` path (``Path.arc``'s
    cubic Beziers, the centre, closed), filled without an edge."""

    zorder = 1.0

    def __init__(self, center, r: float, theta1, theta2, color, label: str = ""):
        self.center, self.r, self.theta1, self.theta2, self.color = center, r, theta1, theta2, color
        self.label = str(label)
        self.segments = _wedge_segments(center, r, theta1, theta2)

    def get_label(self) -> str:
        return self.label

    def get_facecolor(self):
        return to_rgba(self.color)

    def datalim_points(self) -> np.ndarray:
        """What ``Axes._update_patch_limits`` adds: each segment's ends and
        its axis-aligned extrema (``BezierSegment.axis_aligned_extrema``)."""
        pts = []
        for cp in self.segments:
            ts = [0.0, *_bezier_extrema(cp), 1.0] if len(cp) > 2 else [0.0, 1.0]
            pts.append(_bezier_eval(cp, np.asarray(ts)))
        return np.vstack(pts)

    def outline(self, steps: int = 24) -> np.ndarray:
        """The closed outline, each cubic at ``steps`` points."""
        pts = [self.segments[0][:1]]
        for cp in self.segments:
            pts.append(_bezier_eval(cp, np.linspace(0, 1, steps + 1)[1:] if len(cp) > 2 else np.ones(1)))
        return np.vstack(pts)


def _arc_vertices(theta1, theta2) -> np.ndarray:
    """``Path.arc(theta1, theta2)``'s vertices (MOVETO + 3 n CURVE4), in the
    same numpy operations, so in the same precision."""
    halfpi = np.pi * 0.5
    eta1 = theta1
    eta2 = theta2 - 360 * np.floor((theta2 - theta1) / 360)
    if theta2 != theta1 and eta2 <= eta1:
        eta2 += 360
    eta1, eta2 = np.deg2rad([eta1, eta2])
    n = int(2 ** np.ceil((eta2 - eta1) / halfpi))
    deta = (eta2 - eta1) / n
    t = np.tan(0.5 * deta)
    alpha = np.sin(deta) * (np.sqrt(4.0 + 3.0 * t * t) - 1) / 3.0
    steps = np.linspace(eta1, eta2, n + 1, True)
    cos_eta, sin_eta = np.cos(steps), np.sin(steps)
    xa, ya = cos_eta[:-1], sin_eta[:-1]
    xb, yb = cos_eta[1:], sin_eta[1:]
    v = np.zeros((n * 3 + 1, 2), float)
    v[0] = [xa[0], ya[0]]
    v[1::3, 0], v[1::3, 1] = xa + alpha * -ya, ya + alpha * xa
    v[2::3, 0], v[2::3, 1] = xb - alpha * -yb, yb - alpha * xb
    v[3::3, 0], v[3::3, 1] = xb, yb
    return v


def _wedge_segments(center, r: float, theta1, theta2) -> list[np.ndarray]:
    """``Wedge._recompute_path`` as Bezier control points, segment by segment
    (``Path.iter_bezier``): the arc's cubics, the line to the centre and the
    line back."""
    if abs((theta2 - theta1) - 360) <= 1e-12:
        theta1, theta2 = 0, 360
    arc = _arc_vertices(theta1, theta2)
    v = np.concatenate([arc, [(0, 0), arc[0], (0, 0)]]) * r + center
    segs = [v[:1]]
    n = (len(arc) - 1) // 3
    for i in range(n):
        segs.append(v[3 * i: 3 * i + 4])
    c, a0 = v[len(arc)], v[len(arc) + 1]
    full = theta1 == 0 and theta2 == 360
    if not full:
        segs.append(np.array([v[len(arc) - 1], c]))
    segs.append(np.array([c, a0]))
    segs.append(np.array([a0, v[0]]))  # CLOSEPOLY: back to the first vertex
    return segs


def _bezier_eval(cp: np.ndarray, t: np.ndarray) -> np.ndarray:
    """``BezierSegment.__call__``."""
    n = len(cp)
    orders = np.arange(n)
    coeff = [math.factorial(n - 1) // (math.factorial(i) * math.factorial(n - 1 - i)) for i in range(n)]
    px = (cp.T * coeff).T
    t = np.asarray(t)
    return (np.power.outer(1 - t, orders[::-1]) * np.power.outer(t, orders)) @ px


def _bezier_extrema(cp: np.ndarray) -> list[float]:
    """``BezierSegment.axis_aligned_extrema``'s t values of a cubic."""
    from math import comb

    n = len(cp) - 1
    j = np.arange(n + 1)[:, None]
    i = np.arange(n + 1)[None, :]
    comb_ji = np.vectorize(comb)(j, i) * (i <= j)
    cj = np.vectorize(comb)(n, j) * ((-1.0) ** (i + j) * comb_ji) @ cp
    dcj = np.arange(1, n + 1)[:, None] * cj[1:]
    roots = np.concatenate([np.roots(pi[::-1]) for pi in dcj.T])
    ok = np.isreal(roots) & (roots >= 0) & (roots <= 1)
    return list(np.real(roots)[ok])


class AxesImage:
    zorder = 0.0

    def __init__(self, data, cmap, vmin, vmax):
        self.data = np.asarray(data, np.float64)
        self.cmap = cmap
        self.vmin = float(np.nanmin(self.data)) if vmin is None else float(vmin)
        self.vmax = float(np.nanmax(self.data)) if vmax is None else float(vmax)
        h, w = self.data.shape[:2]
        self.extent = (-0.5, w - 0.5, h - 0.5, -0.5)

    def get_array(self) -> np.ndarray:
        return self.data

    def normalized(self) -> np.ndarray:
        if self.vmin == self.vmax:
            return np.zeros_like(self.data)
        return (self.data - self.vmin) / (self.vmax - self.vmin)

    def rgba_bytes(self) -> np.ndarray:
        return colormap(self.cmap, self.normalized(), bytes=True)


class BarContainer(list):
    """The bars of one ``Axes.bar`` call."""


class Legend:
    zorder = 5.0
    codes = ("best", "upper right", "upper left", "lower left", "lower right", "right", "center left",
             "center right", "lower center", "upper center", "center")
    _CODE_ANCHOR = (None, "NE", "NW", "SW", "SE", "E", "W", "E", "S", "N", "C")

    def __init__(self, axes: Axes, handles: list, labels: list[str], fontsize=None, loc="best", title=None,
                 bbox_to_anchor=None):
        self.axes = axes
        self.handles, self.labels = handles, [str(s) for s in labels]
        self.fontsize = _points("medium" if fontsize is None else fontsize)
        self.loc = self.codes.index(loc) if isinstance(loc, str) else int(loc)
        self.title = None if title is None else str(title)  # at the rc title size ("medium")
        self.bbox_to_anchor = bbox_to_anchor  # (x, y, w, h) in axes fractions
        self.loc_used: int | None = None  # the location code "best" chose

    def get_texts(self) -> list[str]:
        return self.labels

    # --- the packed box (offsetbox.VPacker/HPacker/DrawingArea/TextArea)
    @staticmethod
    def _text_area(label: str, fontsize: float, dpi: float) -> tuple[float, float, float]:
        """``TextArea.get_bbox`` of one line: (width, -descent, height - descent)."""
        _, lp_h, lp_d = text_extent("lp", fontsize, "normal", dpi)
        t = Text(0, 0, label, fontsize=fontsize, coords="display")
        bbox, info, yd = t.layout(dpi)
        h = max(lp_h - lp_d, bbox.height - yd) + yd
        return bbox.width, -yd, h - yd

    def _rows(self, dpi: float):
        fs = self.fontsize
        pt = dpi / 72
        da_w, da_h = 2.0 * fs * pt, 0.7 * fs * pt
        rows = []
        for label in self.labels:
            w, yd0, y1 = self._text_area(label, fs, dpi)
            rows.append((da_w + 0.8 * fs * pt + w, min(0.0, yd0), max(da_h, y1), w))
        return rows, da_w, da_h

    def _title_box(self, dpi: float) -> tuple[float, float, float] | None:
        return None if self.title is None else self._text_area(self.title, 10.0, dpi)

    def _entries_size(self, dpi: float) -> tuple[float, float]:
        rows, _, _ = self._rows(dpi)
        sep = 0.5 * self.fontsize * dpi / 72
        return max(w for w, _, _, _ in rows), sum(y1 - y0 for _, y0, y1, _ in rows) + sep * (len(rows) - 1)

    def size(self, dpi: float) -> tuple[float, float]:
        pt = dpi / 72
        sep, pad = 0.5 * self.fontsize * pt, 0.4 * self.fontsize * pt
        width, height = self._entries_size(dpi)
        tb = self._title_box(dpi)
        if tb is not None:
            width, height = max(width, tb[0]), height + sep + tb[2] - tb[1]
        return width + 2 * pad, height + 2 * pad

    def _parent(self, dpi: float) -> Bbox:
        if self.bbox_to_anchor is None:
            return self.axes.bbox(dpi)
        b = self.axes.bbox(dpi)
        x, y, w, h = self.bbox_to_anchor
        return Bbox.from_bounds(b.x0 + x * b.width, b.y0 + y * b.height, w * b.width, h * b.height)

    def _anchored(self, code: int, w: float, h: float, parent: Bbox, dpi: float) -> tuple[float, float]:
        pad = 0.5 * self.fontsize * dpi / 72
        container = parent.padded(-pad)
        b = Bbox.from_bounds(0, 0, w, h).anchored(self._CODE_ANCHOR[code], container)
        return b.x0, b.y0

    def position(self, dpi: float) -> Bbox:
        """The legend frame in display px: at ``loc``, or where ``loc="best"``
        puts it (``_find_best_position``)."""
        w, h = self.size(dpi)
        parent = self._parent(dpi)
        if self.loc:
            self.loc_used = self.loc
            return Bbox.from_bounds(*self._anchored(self.loc, w, h, parent, dpi), w, h)
        lines, offsets, boxes = self.axes._legend_obstacles(dpi)
        candidates = []
        for code in range(1, len(self.codes)):
            l, b = self._anchored(code, w, h, parent, dpi)
            box = Bbox.from_bounds(l, b, w, h)
            badness = (sum(_count_inside(box, v) for v in lines) + _count_inside(box, offsets)
                       + sum(1 for o in boxes if not (o.x1 <= box.x0 or o.y1 <= box.y0 or o.x0 >= box.x1
                                                      or o.y0 >= box.y1))
                       + sum(_path_hits_box(v, box) for v in lines))
            candidates.append((badness, code, (l, b)))
            if badness == 0:
                break
        _, code, (l, b) = min(candidates)
        self.loc_used = code
        return Bbox.from_bounds(l, b, w, h)

    def draw(self, canvas: _Canvas, dpi: float) -> None:
        box = self.position(dpi)
        fs_px = self.fontsize * dpi / 72
        canvas.round_rect(box, 0.2 * fs_px, to_rgba("white", 0.8), to_rgba("0.8", 0.8), 1.0 * dpi / 72)
        rows, da_w, da_h = self._rows(dpi)
        pt = dpi / 72
        sep, pad = 0.5 * self.fontsize * pt, 0.4 * self.fontsize * pt
        top = box.y1 - pad
        x0 = box.x0 + pad
        tb = self._title_box(dpi)
        if tb is not None:  # the title and the entries centred in the packed width (VPacker align="center")
            inner = box.width - 2 * pad
            Text(x0 + (inner - tb[0]) / 2, top - tb[2], self.title, coords="display",
                 fontsize=10.0).draw(canvas, dpi)
            top -= tb[2] - tb[1] + sep
            x0 += (inner - self._entries_size(dpi)[0]) / 2
        for handle, label, (_, y0, y1, _) in zip(self.handles, self.labels, rows):
            base = top - y1
            ymid = base + da_h / 2
            if isinstance(handle, Line2D):
                canvas.polyline(np.array([[x0, ymid], [x0 + da_w, ymid]]), handle.lw * pt,
                                to_rgba(handle.color, handle.alpha), display=True)
                if handle.marker:
                    _draw_markers(canvas, np.array([[x0 + da_w / 2, ymid]]), handle, dpi)
            else:  # a patch (bar, wedge): HandlerPatch's rectangle over the handle's box
                canvas.rect(Bbox(x0, base, x0 + da_w, base + da_h), to_rgba(handle.color), snap=True)
            Text(x0 + da_w + 0.8 * self.fontsize * pt, base, label, coords="display",
                 fontsize=self.fontsize).draw(canvas, dpi)
            top -= (y1 - y0) + sep


def _count_inside(box: Bbox, v: np.ndarray) -> int:
    if not len(v):
        return 0
    with np.errstate(invalid="ignore"):
        return int(((v[:, 0] > box.x0) & (v[:, 0] < box.x1) & (v[:, 1] > box.y0) & (v[:, 1] < box.y1)).sum())


def _path_hits_box(v: np.ndarray, box: Bbox) -> int:
    """``Path.intersects_bbox(box, filled=False)``: does a segment of the
    polyline ``v`` meet the box (separating-axis test, matplotlib's _path.h)."""
    if len(v) < 2:
        return 0
    cx, cy = (box.x0 + box.x1) / 2, (box.y0 + box.y1) / 2
    w, h = box.width, box.height
    m1x, m1y, m2x, m2y = v[:-1, 0], v[:-1, 1], v[1:, 0], v[1:, 1]
    with np.errstate(invalid="ignore"):
        hit = ((np.abs(m1x + m2x - 2.0 * cx) < np.abs(m1x - m2x) + w)
               & (np.abs(m1y + m2y - 2.0 * cy) < np.abs(m1y - m2y) + h)
               & (2.0 * np.abs((m1x - cx) * (m1y - m2y) - (m1y - cy) * (m1x - m2x))
                  < w * np.abs(m1y - m2y) + h * np.abs(m1x - m2x)))
    return int(hit.any())


# --------------------------------------------------------------------------- grid specs


class SubplotParams:
    def __init__(self, left=0.125, bottom=0.11, right=0.9, top=0.88, wspace=0.2, hspace=0.2):
        self.left, self.bottom, self.right, self.top, self.wspace, self.hspace = left, bottom, right, top, wspace, hspace


class GridSpec:
    """A grid of nrows x ncols cells placed by the figure's subplot params,
    or inside ``parent`` (``GridSpecFromSubplotSpec``)."""

    def __init__(self, nrows, ncols, figure: Figure, parent: SubplotSpec | None = None, wspace=None, hspace=None,
                 width_ratios=None, height_ratios=None):
        self.nrows, self.ncols, self.figure, self.parent = nrows, ncols, figure, parent
        self.wspace, self.hspace = wspace, hspace
        self.width_ratios = width_ratios or [1] * ncols
        self.height_ratios = height_ratios or [1] * nrows

    def params(self) -> SubplotParams:
        sp = self.figure.subplotpars
        wspace = self.wspace if self.wspace is not None else sp.wspace
        hspace = self.hspace if self.hspace is not None else sp.hspace
        if self.parent is not None:
            b = self.parent.get_position()
            return SubplotParams(b.x0, b.y0, b.x1, b.y1, wspace, hspace)
        return SubplotParams(sp.left, sp.bottom, sp.right, sp.top, wspace, hspace)

    def grid_positions(self):
        p = self.params()
        tot_w, tot_h = p.right - p.left, p.top - p.bottom
        cell_h = tot_h / (self.nrows + p.hspace * (self.nrows - 1))
        norm = cell_h * self.nrows / sum(self.height_ratios)
        cell_hs = np.cumsum(np.column_stack([[0] + [p.hspace * cell_h] * (self.nrows - 1),
                                             [r * norm for r in self.height_ratios]]).flat)
        cell_w = tot_w / (self.ncols + p.wspace * (self.ncols - 1))
        norm = cell_w * self.ncols / sum(self.width_ratios)
        cell_ws = np.cumsum(np.column_stack([[0] + [p.wspace * cell_w] * (self.ncols - 1),
                                             [r * norm for r in self.width_ratios]]).flat)
        tops, bottoms = (p.top - cell_hs).reshape((-1, 2)).T
        lefts, rights = (p.left + cell_ws).reshape((-1, 2)).T
        return bottoms, tops, lefts, rights

    def __getitem__(self, key) -> SubplotSpec:
        r, c = key

        def span(k, n):
            if isinstance(k, slice):
                start, stop, _ = k.indices(n)
                return start, stop
            return k, k + 1

        return SubplotSpec(self, span(r, self.nrows), span(c, self.ncols))


class SubplotSpec:
    def __init__(self, gs: GridSpec, rows: tuple[int, int], cols: tuple[int, int]):
        self.gs, self.rows, self.cols = gs, rows, cols

    def get_position(self) -> Bbox:
        bottoms, tops, lefts, rights = self.gs.grid_positions()
        r = slice(*self.rows)
        c = slice(*self.cols)
        return Bbox(lefts[c].min(), bottoms[r].min(), rights[c].max(), tops[r].max())

    def topmost(self) -> SubplotSpec:
        return self.gs.parent.topmost() if self.gs.parent is not None else self


# --------------------------------------------------------------------------- axes


class Axes:
    """One plotting area: artists in data coordinates, two axes, a title, a
    legend; matplotlib's autoscaling, aspect and tight-bbox rules."""

    def __init__(self, figure: Figure, ss: SubplotSpec):
        self.figure, self.ss = figure, ss
        self.children: list = []  # lines, patches, collections, images, texts in order of addition
        self.xaxis, self.yaxis = _Axis(self, "x"), _Axis(self, "y")
        self.title = Text(0.5, 1.0, "", coords="axes", offset=(0.0, 6.0), fontsize="large", ha="center",
                          va="baseline", owner=self)
        self.legend_: Legend | None = None
        self.axison = True
        self._xlim, self._ylim = (0.0, 1.0), (0.0, 1.0)
        self._autox = self._autoy = True
        self._datalim = [np.inf, np.inf, -np.inf, -np.inf]  # x0, y0, x1, y1
        self._aspect: str | float = "auto"
        self._datalim_aspect = False  # axis("equal"): the limits, not the box, take the aspect
        self._scale_requested = False  # a drawing call without data still asks for autoscaling
        self._box_aspect: float | None = None
        self._anchor = "C"
        self._line_color = itertools.cycle(TAB10)
        self._patch_color = itertools.cycle(TAB10)
        self.spine_sides = ("left", "right", "bottom", "top")
        self.colorbar_of: AxesImage | None = None  # set on a colorbar's axes
        self.facecolor = "white"
        self.frame_on = True  # the axes patch and the spines (pie turns them off)

    # --- geometry
    def get_position(self) -> Bbox:
        """The active position (figure fractions) after ``apply_aspect``."""
        pos = self.ss.get_position()
        fw, fh = self.figure.get_size_inches()
        fig_aspect = fh / fw
        if self._aspect == "equal" and not self._datalim_aspect:
            (x0, x1), (y0, y1) = sorted(self.get_xlim()), sorted(self.get_ylim())
            ratio = max(abs(y1 - y0), 1e-30) / max(abs(x1 - x0), 1e-30)
            return pos.shrunk_to_aspect(ratio, fig_aspect).anchored(self._anchor, pos)
        if self._box_aspect is not None:
            return pos.shrunk_to_aspect(self._box_aspect, fig_aspect).anchored(self._anchor, pos)
        return pos

    def bbox(self, dpi: float) -> Bbox:
        p = self.get_position()
        fw, fh = self.figure.display_size(dpi)
        return Bbox(p.x0 * fw, p.y0 * fh, p.x1 * fw, p.y1 * fh)

    def data_to_display(self, xy: np.ndarray, dpi: float) -> np.ndarray:
        b = self.bbox(dpi)
        (x0, x1), (y0, y1) = self.get_xlim(), self.get_ylim()
        xy = np.asarray(xy, np.float64)
        return np.stack([b.x0 + (xy[:, 0] - x0) / (x1 - x0) * b.width,
                         b.y0 + (xy[:, 1] - y0) / (y1 - y0) * b.height], 1)

    # --- limits
    def _update_datalim(self, x, y) -> None:
        x, y = np.asarray(x, np.float64).ravel(), np.asarray(y, np.float64).ravel()
        ok = np.isfinite(x) & np.isfinite(y)
        if not ok.any():
            return
        x, y = x[ok], y[ok]
        d = self._datalim
        self._datalim = [min(d[0], x.min()), min(d[1], y.min()), max(d[2], x.max()), max(d[3], y.max())]

    def _stickies(self, axis: str) -> np.ndarray:
        out = []
        for a in self.children:
            if isinstance(a, Rectangle) and axis == "y":
                out += a.sticky_y
            elif isinstance(a, AxesImage):
                e = a.extent
                out += [e[0], e[1]] if axis == "x" else [e[2], e[3]]
        return np.sort(np.array(out, np.float64))

    def _autoscale(self, axis: str) -> tuple[float, float]:
        d = self._datalim
        lo, hi = (d[0], d[2]) if axis == "x" else (d[1], d[3])
        if not (np.isfinite(lo) and np.isfinite(hi)):
            lo, hi = -np.inf, np.inf
            if (axis == "x" and not self._autox) or (axis == "y" and not self._autoy):
                return self._xlim if axis == "x" else self._ylim
            if not self._scale_requested and not any(
                    isinstance(a, (Line2D, Rectangle, PathCollection, AxesImage)) for a in self.children):
                return (0.0, 1.0)
        x0, x1 = _nonsingular(lo, hi, expander=0.05)
        stickies = self._stickies(axis)
        tol = 1e-5 * max(abs(x0), abs(x1), abs(x1 - x0))
        i0 = stickies.searchsorted(x0 + tol) - 1
        x0bound = stickies[i0] if i0 != -1 else None
        i1 = stickies.searchsorted(x1 - tol)
        x1bound = stickies[i1] if i1 != len(stickies) else None
        delta = (x1 - x0) * 0.05
        if not np.isfinite(delta):
            delta = 0
        x0, x1 = x0 - delta, x1 + delta
        if x0bound is not None:
            x0 = max(x0, x0bound)
        if x1bound is not None:
            x1 = min(x1, x1bound)
        return _nonsingular(x0, x1, expander=1e-12, tiny=1e-13)

    def get_xlim(self) -> tuple[float, float]:
        if self._datalim_aspect:
            return self._aspect_limits()[0]
        return self._view_xlim()

    def get_ylim(self) -> tuple[float, float]:
        if self._datalim_aspect:
            return self._aspect_limits()[1]
        return self._view_ylim()

    def _view_xlim(self) -> tuple[float, float]:
        if self._autox:
            lo, hi = self._autoscale("x")
            self._xlim = (hi, lo) if self.xaxis.inverted else (lo, hi)
        return self._xlim

    def _view_ylim(self) -> tuple[float, float]:
        if self._autoy:
            lo, hi = self._autoscale("y")
            self._ylim = (hi, lo) if self.yaxis.inverted else (lo, hi)
        return self._ylim

    def _aspect_limits(self) -> tuple[tuple[float, float], tuple[float, float]]:
        """``apply_aspect`` with ``adjustable="datalim"`` and aspect 1: the
        autoscaled view widened along x or y to the box's shape."""
        (xmin, xmax), (ymin, ymax) = self._view_xlim(), self._view_ylim()
        xlim, ylim = (xmin, xmax), (ymin, ymax)
        fw, fh = self.figure.get_size_inches()
        pos = self.ss.get_position()
        xsize, ysize = max(abs(xmax - xmin), 1e-30), max(abs(ymax - ymin), 1e-30)
        data_ratio = (fh / fw) * (pos.height / pos.width)
        y_expander = data_ratio * xsize / ysize - 1
        if abs(y_expander) < 0.005:
            return xlim, ylim
        d = self._datalim
        xr, yr = 1.05 * (d[2] - d[0]), 1.05 * (d[3] - d[1])
        xmarg, ymarg = xsize - xr, ysize - yr
        ysize2, xsize2 = data_ratio * xsize, ysize / data_ratio
        xmarg2, ymarg2 = xsize2 - xr, ysize2 - yr
        if xmarg > 0 and ymarg > 0:
            adjust_y = (ymarg2 > 0 and y_expander < 0) or (xmarg2 < 0 and y_expander > 0)
        else:
            adjust_y = y_expander > 0
        if adjust_y:
            yc = 0.5 * (ymin + ymax)
            ylim = (yc - ysize2 / 2.0, yc + ysize2 / 2.0)
        else:
            xc = 0.5 * (xmin + xmax)
            xlim = (xc - xsize2 / 2.0, xc + xsize2 / 2.0)
        return xlim, ylim

    def set_xlim(self, left=None, right=None) -> tuple[float, float]:
        if right is None and np.iterable(left):
            left, right = left
        old = self.get_xlim()
        left = old[0] if left is None else float(left)
        right = old[1] if right is None else float(right)
        self._xlim, self._autox = _nonsingular(left, right, increasing=False), False
        return self._xlim

    def set_ylim(self, bottom=None, top=None) -> tuple[float, float]:
        if top is None and np.iterable(bottom):
            bottom, top = bottom
        old = self.get_ylim()
        bottom = old[0] if bottom is None else float(bottom)
        top = old[1] if top is None else float(top)
        self._ylim, self._autoy = _nonsingular(bottom, top, increasing=False), False
        return self._ylim

    # --- drawing calls
    def plot(self, *args, color=None, lw=None, linewidth=None, alpha=None, marker=None, ms=None, markersize=None,
             label=None, zorder=2.0) -> list[Line2D]:
        """``plot(y)``, ``plot(x, y)`` or ``plot(x, y, fmt)``; 2-D ``y`` draws a
        line per column."""
        fmt = None
        if args and isinstance(args[-1], str):
            fmt, args = args[-1], args[:-1]
        if len(args) == 1:
            y = np.atleast_1d(np.asarray(args[0], np.float64))
            x = np.arange(y.shape[0], dtype=np.float64)
        else:
            x, y = (np.atleast_1d(np.array(a, dtype=np.float64)) for a in args)
        ls = "-"
        if fmt:
            for ch in fmt:
                if ch in "bgrcmykw":
                    color = ch
                elif ch in ".o+":
                    marker = ch
            ls = "-" if "-" in fmt or not any(ch in ".o+" for ch in fmt) else "None"
        lw = lw if lw is not None else linewidth if linewidth is not None else 1.5
        ms = ms if ms is not None else markersize if markersize is not None else 6.0
        ys = y.reshape(len(y), -1) if y.ndim > 1 else y[:, None]
        xs = x.reshape(len(x), -1) if x.ndim > 1 else x[:, None]
        n = max(ys.shape[1], xs.shape[1])
        lines = []
        for i in range(n):
            c = color if color is not None else next(self._line_color)
            line = Line2D(xs[:, min(i, xs.shape[1] - 1)], ys[:, min(i, ys.shape[1] - 1)], color=c, lw=lw,
                          alpha=alpha, marker=marker, ms=ms,
                          label=label if label is not None else f"_child{len(self.children)}",
                          ls=ls, zorder=zorder)
            self.children.append(line)
            self._update_datalim(line.x, line.y)
            lines.append(line)
        return lines

    def scatter(self, x, y, s=None, c=None, cmap=None, alpha=None, edgecolors=None) -> PathCollection:
        x, y = np.asarray(x, np.float64).ravel(), np.asarray(y, np.float64).ravel()
        s = 36.0 if s is None else s
        if c is None:
            colors = np.tile(to_rgba(next(self._patch_color)), (len(x), 1))
        else:
            cv = np.asarray(c, np.float64).ravel()
            lo, hi = (np.nanmin(cv), np.nanmax(cv)) if cv.size else (0.0, 1.0)
            norm = np.zeros_like(cv) if hi == lo else (cv - lo) / (hi - lo)
            colors = colormap(cmap or "viridis", norm)
        if alpha is not None:
            colors[:, 3] = alpha
        pc = PathCollection(np.stack([x, y], 1), float(s), colors, "face" if edgecolors is None else edgecolors,
                            1.5, alpha)
        self.children.append(pc)
        self._update_datalim(x, y)
        return pc

    def bar(self, x, height, width=0.8, color=None, bottom=0.0) -> BarContainer:
        """Bars at ``x``: numbers, or strings on a categorical axis (each new
        string the next integer, ticked and labelled with the string)."""
        if len(x) and isinstance(list(x)[0], str):
            cats = self.xaxis.categories
            for c in x:
                cats.setdefault(str(c), len(cats))
            self.xaxis.fixed_locs = [float(v) for v in cats.values()]
            self.xaxis.fixed_labels = list(cats)
            x = [cats[str(c)] for c in x]
        x = np.atleast_1d(np.asarray(x, np.float64))
        self._scale_requested = True
        height = np.broadcast_to(np.asarray(height, np.float64), x.shape)
        if color is None:
            colors = [next(self._patch_color)] * len(x)
        elif isinstance(color, str) or (np.ndim(color) == 1 and len(color) in (3, 4)
                                        and not isinstance(color[0], str)):
            colors = [color] * len(x)
        else:
            colors = list(color)
        bars = BarContainer()
        for xi, hi, ci in zip(x, height, colors):
            r = Rectangle(xi - width / 2, bottom, width, hi, ci)
            self.children.append(r)
            if r.w or r.h:
                self._update_datalim([r.x, r.x + r.w], [r.y, r.y + r.h])
            bars.append(r)
        return bars

    def fill_between(self, x, y1, y2=0.0, color=None, alpha=None) -> PolyCollection:
        """The area between ``y1`` and ``y2`` over ``x`` (one region):
        ``_make_verts_for_region``'s polygon."""
        x = np.asarray(x, np.float64)
        y1 = np.broadcast_to(np.asarray(y1, np.float64), x.shape)
        y2 = np.broadcast_to(np.asarray(y2, np.float64), x.shape)
        if not len(x):
            verts = np.zeros((0, 2))
        else:
            verts = np.concatenate([[(x[0], y2[0])], np.stack([x, y1], -1), [(x[-1], y2[-1])],
                                    np.stack([x, y2], -1)[::-1]])
        pc = PolyCollection(verts, color if color is not None else next(self._patch_color), alpha)
        self.children.append(pc)
        if len(verts):
            self._update_datalim(verts[:, 0], verts[:, 1])
        return pc

    def pie(self, x, labels=None, startangle=0.0):
        """``Axes.pie`` (radius 1 at the origin, no frame): wedges from
        ``startangle`` counterclockwise in the patch colour cycle, each label
        at 1.1 radii; the view +-1.25 without ticks. Returns (wedges, texts)."""
        self._aspect = "equal"
        x = np.asarray(x, np.float32)
        x = x / x.sum()
        labels = [""] * len(x) if labels is None else labels
        theta1 = startangle / 360
        wedges, texts = [], []
        for frac, label in zip(x, labels):
            theta2 = theta1 + frac
            thetam = 2 * np.pi * 0.5 * (theta1 + theta2)
            w = Wedge((0.0, 0.0), 1, 360. * min(theta1, theta2), 360. * max(theta1, theta2),
                      next(self._patch_color), label)
            self.children.append(w)
            pts = w.datalim_points()
            self._update_datalim(pts[:, 0], pts[:, 1])
            wedges.append(w)
            xt, yt = 1.1 * math.cos(thetam), 1.1 * math.sin(thetam)
            texts.append(self.text(xt, yt, label, ha="left" if xt > 0 else "right", va="center", fontsize=10.0))
            theta1 = theta2
        self.frame_on = False
        self.set_xticks([])
        self.set_yticks([])
        self.set_xlim(-1.25, 1.25)
        self.set_ylim(-1.25, 1.25)
        return wedges, texts

    def hist(self, x, bins=10, rwidth=None):
        x = np.asarray(x, np.float64).ravel()
        n, edges = np.histogram(x, bins)
        color = next(self._line_color)
        totwidth = np.diff(edges)
        width = (rwidth if rwidth is not None else 1.0) * totwidth
        bars = BarContainer()
        for left, tw, w, h in zip(edges[:-1], totwidth, width, n):
            r = Rectangle(left + 0.5 * tw - w / 2, 0.0, w, float(h), color)
            self.children.append(r)
            self._update_datalim([r.x, r.x + r.w], [r.y, r.y + r.h])
            bars.append(r)
        return n.astype(np.float64), edges, bars

    def imshow(self, data, cmap="viridis", vmin=None, vmax=None) -> AxesImage:
        im = AxesImage(data, cmap, vmin, vmax)
        self.children.append(im)
        self._aspect = "equal"
        e = im.extent
        self._update_datalim([e[0], e[1]], [e[2], e[3]])
        self.yaxis.inverted = True
        return im

    def text(self, x, y, s, ha="left", va="baseline", fontsize=10, color="black", rotation=0,
             fontweight="normal", **kw) -> Text:
        ha = kw.pop("horizontalalignment", ha)
        va = kw.pop("verticalalignment", va)
        if kw:
            raise TypeError(f"Axes.text does not take {sorted(kw)}")
        t = Text(x, y, s, fontsize=fontsize, color=color, ha=ha, va=va, rotation=rotation, fontweight=fontweight,
                 coords="data", owner=self)
        self.children.append(t)
        return t

    def legend(self, handles=None, labels=None, *, fontsize=None, loc="best", title=None,
               bbox_to_anchor=None) -> Legend:
        """A legend of ``handles`` with ``labels``, or of the labelled lines
        and patches in the order they were added."""
        if handles is None:
            handles = [a for a in self.children if isinstance(a, (Line2D, Rectangle, Wedge))
                       and a.label and not a.label.startswith("_")]
            labels = [h.label for h in handles]
        self.legend_ = Legend(self, list(handles), list(labels), fontsize=fontsize, loc=loc, title=title,
                              bbox_to_anchor=bbox_to_anchor)
        return self.legend_

    def get_legend(self) -> Legend | None:
        return self.legend_

    def set_title(self, label, fontsize=None, fontweight="normal", color="black"):
        self.title.text = str(label)
        self.title.fontsize = _points("large" if fontsize is None else fontsize)
        self.title.fontweight = fontweight
        self.title.color = color
        return self.title

    def set_xlabel(self, label, fontsize=None, fontweight="normal", color="black"):
        self.xaxis.label.text, self.xaxis.label.fontsize = str(label), _points(fontsize or 10)
        self.xaxis.label.fontweight, self.xaxis.label.color = fontweight, color
        return self.xaxis.label

    def set_ylabel(self, label, fontsize=None, fontweight="normal", color="black"):
        self.yaxis.label.text, self.yaxis.label.fontsize = str(label), _points(fontsize or 10)
        self.yaxis.label.fontweight, self.yaxis.label.color = fontweight, color
        return self.yaxis.label

    def set_facecolor(self, color) -> None:
        self.facecolor = color

    def get_title(self) -> str:
        return self.title.text

    def get_xlabel(self) -> str:
        return self.xaxis.label.text

    def get_ylabel(self) -> str:
        return self.yaxis.label.text

    def set_xticks(self, ticks) -> None:
        self.xaxis.fixed_locs = [float(t) for t in ticks]
        self._expand_to_ticks("x")

    def set_yticks(self, ticks) -> None:
        self.yaxis.fixed_locs = [float(t) for t in ticks]
        self._expand_to_ticks("y")

    def _expand_to_ticks(self, axis: str) -> None:
        """``Axis.set_ticks`` widens the current view to take in the ticks
        (keeping an inversion); the view then stays as set."""
        locs = (self.xaxis if axis == "x" else self.yaxis).fixed_locs
        if not locs:
            return
        lo, hi = self.get_xlim() if axis == "x" else self.get_ylim()
        if lo <= hi:
            lim = (min(min(locs), lo), max(max(locs), hi))
        else:
            lim = (max(max(locs), lo), min(min(locs), hi))
        if axis == "x":
            self._xlim, self._autox = lim, False
        else:
            self._ylim, self._autoy = lim, False

    def set_xticklabels(self, labels, rotation=None, fontsize=None) -> None:
        self._set_ticklabels(self.xaxis, labels, rotation, fontsize)

    def set_yticklabels(self, labels, rotation=None, fontsize=None) -> None:
        self._set_ticklabels(self.yaxis, labels, rotation, fontsize)

    @staticmethod
    def _set_ticklabels(axis: _Axis, labels, rotation, fontsize) -> None:
        axis.fixed_labels = [str(s) for s in labels]
        if rotation is not None:
            axis.ticklabel_kw["rotation"] = rotation
        if fontsize is not None:
            axis.ticklabel_kw["fontsize"] = _points(fontsize)

    def get_xticks(self) -> np.ndarray:
        return self.xaxis.locs()

    def get_yticks(self) -> np.ndarray:
        return self.yaxis.locs()

    def get_xticklabels(self) -> list[str]:
        return self.xaxis.ticklabels()

    def get_yticklabels(self) -> list[str]:
        return self.yaxis.ticklabels()

    def tick_params(self, axis="both", labelsize=None) -> None:
        for a in ((self.xaxis, self.yaxis) if axis == "both" else (self.xaxis if axis == "x" else self.yaxis,)):
            if labelsize is not None:
                a.labelsize = labelsize

    def grid(self, visible=True, alpha=None, linestyle="-", linewidth=0.8) -> None:
        """Major grid lines (``grid.color``), solid or dashed ("--")."""
        if linestyle not in ("-", "--"):
            raise ValueError(f"grid linestyle {linestyle!r} is not supported")
        kw = {"alpha": alpha, "ls": linestyle, "lw": float(linewidth)} if visible else None
        self.xaxis.grid_kw = self.yaxis.grid_kw = kw

    def axis(self, arg) -> None:
        """"off", "on", or "equal": autoscaling on again and aspect 1 taken by
        the data limits (``set_aspect("equal", adjustable="datalim")``)."""
        if arg == "off":
            self.axison = False
        elif arg == "on":
            self.axison = True
        elif arg == "equal":
            self._autox = self._autoy = self._scale_requested = True
            self._aspect, self._datalim_aspect = "equal", True
        else:
            raise ValueError(f"axis({arg!r}) is not supported")

    def set_anchor(self, anchor) -> None:
        self._anchor = anchor

    # --- layout
    def get_tightbbox(self, dpi: float, for_layout_only: bool = False) -> Bbox:
        bb = []
        if self.axison:
            for axis in (self.xaxis, self.yaxis):
                ba = axis.tightbbox(dpi, for_layout_only)
                if ba is not None:
                    bb.append(ba)
        bb.append(self.bbox(dpi))
        if self.title.text:
            bt = self.title.window_extent(dpi)
            if for_layout_only and bt.width > 0:
                bt.x0 = (bt.x0 + bt.x1) / 2 - 0.5
                bt.x1 = bt.x0 + 1.0
            bb.append(bt)
        extra = [t.window_extent(dpi) for t in self.children if isinstance(t, Text) and t.text]
        if self.legend_ is not None:
            extra.append(self.legend_.position(dpi))
        if self.axison:
            extra += [self._spine_extent(side, dpi) for side in self.spine_sides]
        bb += [b for b in extra if 0 < b.width < np.inf and 0 < b.height < np.inf]
        return Bbox.union([b for b in bb if b.width != 0 or b.height != 0])

    def _spine_extent(self, side: str, dpi: float) -> Bbox:
        b = self.bbox(dpi)
        if side == self.xaxis.side:
            return self.xaxis.spine_extent(dpi)
        if side == self.yaxis.side:
            return self.yaxis.spine_extent(dpi)
        return {"left": Bbox(b.x0, b.y0, b.x0, b.y1), "right": Bbox(b.x1, b.y0, b.x1, b.y1),
                "bottom": Bbox(b.x0, b.y0, b.x1, b.y0), "top": Bbox(b.x0, b.y1, b.x1, b.y1)}[side]

    def _legend_obstacles(self, dpi: float):
        lines, offsets, boxes = [], [], []
        for a in self.children:
            if isinstance(a, Line2D):
                lines.append(self.data_to_display(np.stack([a.x, a.y], 1), dpi))
            elif isinstance(a, Rectangle):
                p = self.data_to_display(np.array([[a.x, a.y], [a.x + a.w, a.y + a.h]]), dpi)
                boxes.append(Bbox(p[:, 0].min(), p[:, 1].min(), p[:, 0].max(), p[:, 1].max()))
            elif isinstance(a, PathCollection):
                offsets.append(self.data_to_display(a.offsets, dpi))
            elif isinstance(a, Text):
                boxes.append(a.window_extent(dpi))
        offsets = np.concatenate(offsets) if offsets else np.zeros((0, 2))
        return lines, offsets, boxes

    # --- rendering
    def draw(self, canvas: _Canvas, dpi: float) -> None:
        clip = self.bbox(dpi)
        if self.axison and self.frame_on and to_rgba(self.facecolor) != (1.0, 1.0, 1.0, 1.0):
            canvas.rect(clip, to_rgba(self.facecolor), snap=True)  # the axes patch (white draws nothing)
        items = [(a.zorder, i, a) for i, a in enumerate(self.children)]
        items.append((1.5, -1, "axis"))
        items.append((2.5, -1, "spines"))
        for _, _, a in sorted(items, key=lambda t: (t[0], t[1])):
            if a == "axis":
                if self.axison:
                    self._draw_axes_furniture(canvas, dpi)
            elif a == "spines":
                if self.axison and self.frame_on:
                    self._draw_spines(canvas, dpi)
            elif isinstance(a, AxesImage):
                self._draw_image(canvas, a, dpi)
            elif isinstance(a, Rectangle):
                p = self.data_to_display(np.array([[a.x, a.y], [a.x + a.w, a.y + a.h]]), dpi)
                canvas.rect(Bbox(p[:, 0].min(), p[:, 1].min(), p[:, 0].max(), p[:, 1].max()), to_rgba(a.color),
                            snap=True, clip=clip)
            elif isinstance(a, PathCollection):
                _draw_scatter(canvas, self.data_to_display(a.offsets, dpi), a, dpi, clip)
            elif isinstance(a, PolyCollection):
                if len(a.verts):
                    pts = self.data_to_display(a.verts, dpi)
                    canvas.fill([pts], a.get_facecolor(), display=True, clip=clip)
                    canvas.polyline(np.concatenate([pts, pts[:1]]), 1.0 * dpi / 72, a.get_facecolor(),
                                    display=True, clip=clip, caps="round")
            elif isinstance(a, Wedge):  # clip_on=False
                canvas.fill([self.data_to_display(a.outline(), dpi)], a.get_facecolor(), display=True)
            elif isinstance(a, Line2D):
                pts = self.data_to_display(np.stack([a.x, a.y], 1), dpi)
                if a.ls != "None" and a.lw > 0:
                    canvas.polyline(pts, a.lw * dpi / 72, to_rgba(a.color, a.alpha), display=True, clip=clip)
                if a.marker:
                    _draw_markers(canvas, pts, a, dpi, clip)
            elif isinstance(a, Text):
                a.draw(canvas, dpi)
        self.title.draw(canvas, dpi)
        if self.legend_ is not None:
            self.legend_.draw(canvas, dpi)

    def _draw_image(self, canvas: _Canvas, im: AxesImage, dpi: float) -> None:
        e = im.extent
        p = self.data_to_display(np.array([[e[0], e[2]], [e[1], e[3]]]), dpi)
        box = Bbox(p[:, 0].min(), p[:, 1].min(), p[:, 0].max(), p[:, 1].max())
        canvas.image(im.rgba_bytes(), box, self.bbox(dpi))

    def _draw_axes_furniture(self, canvas: _Canvas, dpi: float) -> None:
        b = self.bbox(dpi)
        for axis in (self.xaxis, self.yaxis):
            at = axis.display_locs([loc for loc, _ in axis.ticks()], dpi)
            if axis.grid_kw is not None:
                kw = axis.grid_kw
                color = to_rgba("#b0b0b0", kw.get("alpha"))
                lw = kw.get("lw", 0.8) * dpi / 72
                for v in at:
                    seg = np.array([[v, b.y0], [v, b.y1]] if axis.name == "x" else [[b.x0, v], [b.x1, v]])
                    if kw.get("ls", "-") == "--":  # lines.dashed_pattern, scaled by the width
                        canvas.dashed(seg, lw, color, (3.7 * lw, 1.6 * lw), clip=b)
                    else:
                        canvas.polyline(seg, lw, color, display=True, snap=True, clip=b, caps="projecting")
            if axis.ticks_on:
                t = 3.5 * dpi / 72
                for v in at:
                    if axis.name == "x":
                        seg = np.array([[v, b.y0], [v, b.y0 - t]])
                    elif axis.side == "left":
                        seg = np.array([[b.x0, v], [b.x0 - t, v]])
                    else:
                        seg = np.array([[b.x1, v], [b.x1 + t, v]])
                    canvas.polyline(seg, 0.8 * dpi / 72, to_rgba("black"), display=True, snap=True, caps="butt")
            labels, offset = axis.layout(dpi)
            for t in labels:
                t.draw(canvas, dpi)
            if offset is not None:
                offset.draw(canvas, dpi)
            axis.label.draw(canvas, dpi)

    def _draw_spines(self, canvas: _Canvas, dpi: float) -> None:
        b = self.bbox(dpi)
        lw = 0.8 * dpi / 72
        segs = {"left": [[b.x0, b.y0], [b.x0, b.y1]], "right": [[b.x1, b.y0], [b.x1, b.y1]],
                "bottom": [[b.x0, b.y0], [b.x1, b.y0]], "top": [[b.x0, b.y1], [b.x1, b.y1]]}
        for side in self.spine_sides:
            canvas.polyline(np.array(segs[side]), lw, to_rgba("black"), display=True, snap=True, caps="projecting")


class Colorbar:
    """``Figure.colorbar(im, ax=ax)``: a vertical bar right of ``ax``
    (``make_axes_gridspec``: fraction 0.15, pad 0.05, aspect 20)."""

    def __init__(self, fig: Figure, im: AxesImage, ax: Axes):
        fraction, pad, aspect = 0.15, 0.05, 20.0
        gs = GridSpec(3, 2, fig, parent=ax.ss, wspace=2 * pad / (1 - pad), hspace=0,
                      height_ratios=[0.0, 1.0, 0.0], width_ratios=[1 - fraction - pad, fraction])
        ax.ss = gs[:, 0]
        ax.set_anchor((1.0, 0.5))
        cax = Axes(fig, gs[1, 1])
        cax.set_anchor((0.0, 0.5))
        cax._box_aspect = aspect
        vmin, vmax = _nonsingular(im.vmin, im.vmax, expander=0.1)
        cax._xlim, cax._autox = (0.0, 1.0), False
        cax._ylim, cax._autoy = (vmin, vmax), False
        cax.yaxis.side = "right"
        cax.xaxis.ticks_on = False
        cax.xaxis.fixed_locs = []
        cax.spine_sides = ("left", "right", "bottom", "top")
        cax.colorbar_of = im
        self.im, self.ax, self.cax = im, ax, cax
        fig.axes.append(cax)
        fig._colorbars.append(self)

    def draw_solids(self, canvas: _Canvas, dpi: float) -> None:
        b = self.cax.bbox(dpi)
        vmin, vmax = self.cax.get_ylim()
        levels = (np.arange(256) + 0.5) / 256
        rgba = colormap(self.im.cmap, levels, bytes=True)[::-1][:, None, :]
        canvas.image(rgba, b, b)


# --------------------------------------------------------------------------- figure


class Figure:
    """A figure of ``figsize`` inches; laid out at 100 dpi (matplotlib's
    ``figure.dpi``) and drawn at ``savefig``'s dpi."""

    def __init__(self, figsize=(6.4, 4.8), dpi: float = 100.0, tight_layout: bool = False, facecolor="white"):
        self.figsize = (float(figsize[0]), float(figsize[1]))
        self.dpi = float(dpi)
        self.facecolor = facecolor
        self.axes: list[Axes] = []
        self.subplotpars = SubplotParams()
        self._suptitle: Text | None = None
        self._tight = bool(tight_layout)
        self._colorbars: list[Colorbar] = []

    def get_size_inches(self) -> tuple[float, float]:
        return self.figsize

    def display_size(self, dpi: float) -> tuple[float, float]:
        return self.figsize[0] * dpi, self.figsize[1] * dpi

    def pixel_size(self, dpi: float) -> tuple[int, int]:
        """(width, height) of the PNG ``savefig(dpi=dpi)`` writes (matplotlib truncates)."""
        w, h = self.display_size(dpi)
        return int(w), int(h)

    def add_gridspec(self, nrows, ncols) -> GridSpec:
        return GridSpec(nrows, ncols, self)

    def add_subplot(self, ss: SubplotSpec) -> Axes:
        ax = Axes(self, ss)
        self.axes.append(ax)
        return ax

    def subplots(self, nrows=1, ncols=1, squeeze=True):
        gs = self.add_gridspec(nrows, ncols)
        axs = np.empty((nrows, ncols), object)
        for r in range(nrows):
            for c in range(ncols):
                axs[r, c] = self.add_subplot(gs[r, c])
        if squeeze:
            return axs.item() if axs.size == 1 else axs.squeeze()
        return axs

    def suptitle(self, t, fontsize=None, fontweight="normal") -> Text:
        self._suptitle = Text(0.5, 0.98, t, coords="figure", fontsize="large" if fontsize is None else fontsize,
                              fontweight=fontweight, ha="center", va="top", owner=self)
        return self._suptitle

    def colorbar(self, im: AxesImage, ax: Axes) -> Colorbar:
        return Colorbar(self, im, ax)

    def subplots_adjust(self, **kw) -> None:
        for k, v in kw.items():
            setattr(self.subplotpars, k, v)

    # --- tight layout (matplotlib _tight_layout.py)
    def _tight_layout_params(self, dpi: float, pad=1.08) -> dict | None:
        groups: dict[int, tuple[SubplotSpec, list[Axes]]] = {}
        for ax in self.axes:
            top = ax.ss.topmost()
            key = (id(top.gs), top.rows, top.cols)
            groups.setdefault(key, (top, []))[1].append(ax)
        if not groups:
            return None
        gs0 = next(iter(groups.values()))[0].gs
        rows, cols = gs0.nrows, gs0.ncols
        fw, fh = self.get_size_inches()
        W, H = self.display_size(dpi)
        pad_inch = pad * 10.0 / 72
        vspaces = np.zeros((rows + 1, cols))
        hspaces = np.zeros((rows, cols + 1))
        for ss, axs in groups.values():
            ax_bbox = ss.get_position()
            raw = Bbox.union([a.get_tightbbox(dpi, for_layout_only=True) for a in axs])
            tb = Bbox(raw.x0 / W, raw.y0 / H, raw.x1 / W, raw.y1 / H)
            r0, r1 = ss.rows
            c0, c1 = ss.cols
            hspaces[r0:r1, c0] += ax_bbox.x0 - tb.x0
            hspaces[r0:r1, c1] += tb.x1 - ax_bbox.x1
            vspaces[r0, c0:c1] += tb.y1 - ax_bbox.y1
            vspaces[r1, c0:c1] += ax_bbox.y0 - tb.y0
        margin_left = max(hspaces[:, 0].max(), 0) + pad_inch / fw
        margin_right = max(hspaces[:, -1].max(), 0) + pad_inch / fw
        margin_top = max(vspaces[0, :].max(), 0) + pad_inch / fh
        if self._suptitle is not None and self._suptitle.text:
            margin_top += self._suptitle.window_extent(dpi).height / H + pad_inch / fh
        margin_bottom = max(vspaces[-1, :].max(), 0) + pad_inch / fh
        if margin_left + margin_right >= 1 or margin_bottom + margin_top >= 1:
            warnings.warn("Tight layout not applied: the margins cannot hold the axes' decorations", stacklevel=3)
            return None
        kw = dict(left=margin_left, right=1 - margin_right, bottom=margin_bottom, top=1 - margin_top)
        if cols > 1:
            hspace = hspaces[:, 1:-1].max() + pad_inch / fw
            h_axes = (1 - margin_right - margin_left - hspace * (cols - 1)) / cols
            if h_axes < 0:
                return None
            kw["wspace"] = hspace / h_axes
        if rows > 1:
            vspace = vspaces[1:-1, :].max() + pad_inch / fh
            v_axes = (1 - margin_top - margin_bottom - vspace * (rows - 1)) / rows
            if v_axes < 0:
                return None
            kw["hspace"] = vspace / v_axes
        return kw

    def tight_layout(self) -> None:
        kw = self._tight_layout_params(self.dpi)
        if kw:
            self.subplots_adjust(**kw)

    def get_tightbbox(self, dpi: float) -> Bbox:
        boxes = [ax.get_tightbbox(dpi) for ax in self.axes]
        if self._suptitle is not None and self._suptitle.text:
            boxes.append(self._suptitle.window_extent(dpi))
        return Bbox.union(boxes)

    # --- output
    def render(self, dpi: float | None = None, bbox_inches=None) -> np.ndarray:
        """The figure as an RGB uint8 array, as ``savefig(dpi=dpi)`` draws it."""
        dpi = self.dpi if dpi is None else float(dpi)
        if self._tight:
            kw = self._tight_layout_params(dpi)
            if kw:
                self.subplots_adjust(**kw)
        saved = None
        if bbox_inches == "tight":
            tb = self.get_tightbbox(dpi)
            pad = 0.1 * dpi
            x0, y0, x1, y1 = tb.x0 - pad, tb.y0 - pad, tb.x1 + pad, tb.y1 + pad
            saved = (self.figsize, [ax.ss for ax in self.axes])
            positions = [ax.get_position() for ax in self.axes]
            W, H = self.display_size(dpi)
            new_size = ((x1 - x0) / dpi, (y1 - y0) / dpi)
            self.figsize = new_size
            for ax, p in zip(self.axes, positions):
                box = Bbox((p.x0 * W - x0) / (new_size[0] * dpi), (p.y0 * H - y0) / (new_size[1] * dpi),
                           (p.x1 * W - x0) / (new_size[0] * dpi), (p.y1 * H - y0) / (new_size[1] * dpi))
                ax.ss = _FixedSpec(box)
        elif bbox_inches is not None:
            raise ValueError(f"bbox_inches={bbox_inches!r} is not supported")
        try:
            w, h = self.pixel_size(dpi)
            canvas = _Canvas(w, h, self.display_size(dpi)[1], to_rgba(self.facecolor))
            for ax in self.axes:
                ax.draw(canvas, dpi)
                for cb in self._colorbars:
                    if cb.cax is ax:
                        cb.draw_solids(canvas, dpi)
                        ax._draw_spines(canvas, dpi)
            if self._suptitle is not None:
                self._suptitle.draw(canvas, dpi)
            return canvas.to_uint8()
        finally:
            if saved is not None:
                self.figsize = saved[0]
                for ax, ss in zip(self.axes, saved[1]):
                    ax.ss = ss

    def savefig(self, fname, dpi: float | None = None, bbox_inches=None) -> None:
        """Write the figure as PNG (``utils/patches.py``)."""
        from fce_yolo_tpu_torch.utils.patches import imwrite

        rgb = self.render(dpi, bbox_inches)
        if Path(str(fname)).suffix.lower() != ".png":
            raise ValueError(f"the renderer writes PNG only, not {fname}")
        imwrite(str(fname), np.ascontiguousarray(rgb[..., ::-1]), device="cpu")


class _FixedSpec:
    """A fixed position (figure fractions) standing in for a subplot spec."""

    def __init__(self, box: Bbox):
        self.box = box
        self.gs = None
        self.rows = self.cols = (0, 1)

    def get_position(self) -> Bbox:
        return self.box

    def topmost(self):
        return self


# --------------------------------------------------------------------------- pyplot-style state

# pyplot's current axes: ``plt_color_scatter`` (the reference's signature) draws on it after ``sca``
_current: dict[str, Axes | None] = {"axes": None}


def subplots(nrows=1, ncols=1, figsize=(6.4, 4.8), squeeze=True, tight_layout=False, dpi=100.0, facecolor="white"):
    """``plt.subplots``: a new figure and its axes."""
    fig = Figure(figsize, dpi=dpi, tight_layout=tight_layout, facecolor=facecolor)
    axs = fig.subplots(nrows, ncols, squeeze)
    _current["axes"] = fig.axes[-1]
    return fig, axs


def sca(ax: Axes) -> None:
    _current["axes"] = ax


def gca() -> Axes:
    if _current["axes"] is None:
        _, ax = subplots()
        _current["axes"] = ax
    return _current["axes"]


def scatter(*args, **kwargs) -> PathCollection:
    return gca().scatter(*args, **kwargs)


def close(fig: Figure | None = None) -> None:
    if fig is None or (_current["axes"] is not None and _current["axes"].figure is fig):
        _current["axes"] = None


def draw_text(img: np.ndarray, xy, text: str, fontsize: float = 11.0, color="black") -> np.ndarray:
    """Draw ``text`` onto an (H, W, 3) uint8 image in place, the top-left
    corner of its box at ``xy`` (pixels, rows down), at 72 dpi (``fontsize``
    points are pixels). ``color`` is taken in the image's channel order."""
    h, w = img.shape[:2]
    canvas = _Canvas(w, h, float(h))
    canvas.px = img.astype(np.float32) / 255
    Text(xy[0], h - xy[1], text, fontsize=fontsize, color=color, va="top", coords="display").draw(canvas, 72.0)
    img[...] = canvas.to_uint8()
    return img


# --------------------------------------------------------------------------- raster


def _draw_markers(canvas: _Canvas, pts: np.ndarray, line: Line2D, dpi: float, clip: Bbox | None = None) -> None:
    ok = np.isfinite(pts).all(1)
    pts = pts[ok]
    if not len(pts):
        return
    pt = dpi / 72
    rgba = to_rgba(line.color, line.alpha)
    mew = 1.0 * pt
    if line.marker in (".", "o"):
        r = line.ms * pt * (0.25 if line.marker == "." else 0.5)
        canvas.disks(pts, r + mew / 2, rgba, clip=clip)
    elif line.marker == "*":  # unit_regular_star(5, 0.381966) at half the size, filled and edged (bevel joins)
        theta = 2 * np.pi / 10 * np.arange(11) + np.pi / 2
        r = np.ones(11)
        r[1::2] = 0.381966
        unit = (r * np.vstack((np.cos(theta), np.sin(theta)))).T * 0.5 * line.ms * pt
        canvas.fill([p + unit for p in pts], rgba, display=True, clip=clip)
        for p in pts:
            canvas.polyline(p + unit, mew, rgba, display=True, clip=clip, caps="round")
    elif line.marker == "+":
        half = line.ms * pt / 2
        polys = []
        for x, y in pts:
            polys.append(np.array([[x - half, y - mew / 2], [x + half, y - mew / 2], [x + half, y + mew / 2],
                                   [x - half, y + mew / 2]]))
            polys.append(np.array([[x - mew / 2, y - half], [x + mew / 2, y - half], [x + mew / 2, y + half],
                                   [x - mew / 2, y + half]]))
        canvas.fill(polys, rgba, display=True, clip=clip)


def _draw_scatter(canvas: _Canvas, pts: np.ndarray, pc: PathCollection, dpi: float, clip: Bbox) -> None:
    pt = dpi / 72
    r = math.sqrt(pc.s) / 2 * pt
    ok = np.isfinite(pts).all(1)
    pts, colors = pts[ok], pc.facecolors[ok]
    if not len(pts):
        return
    canvas.disks(pts, r, colors, clip=clip)
    if isinstance(pc.edgecolors, str) and pc.edgecolors == "face":
        lw = pc.linewidth * pt
        canvas.disks(pts, r + lw / 2, colors, clip=clip, inner=max(r - lw / 2, 0.0))
    elif not (isinstance(pc.edgecolors, str) and pc.edgecolors == "none"):
        lw = pc.linewidth * pt
        ec = np.tile(to_rgba(pc.edgecolors, pc.alpha), (len(pts), 1))
        canvas.disks(pts, r + lw / 2, ec, clip=clip, inner=max(r - lw / 2, 0.0))


def _snap(v: np.ndarray, lw_px: float) -> np.ndarray:
    snap_value = 0.5 if int(math.floor(lw_px + 0.5)) % 2 else 0.0
    return np.floor(v + 0.5) + snap_value


class _Canvas:
    """An RGB float image (rows top down) that artists composite onto."""

    SUBROWS = 5

    def __init__(self, w: int, h: int, height_f: float, background=(1.0, 1.0, 1.0)):
        self.w, self.h, self.hf = w, h, height_f
        self.px = np.empty((h, w, 3), np.float32)
        self.px[...] = np.asarray(background[:3], np.float32)

    def to_uint8(self) -> np.ndarray:
        v = self.px * np.float32(255)
        v += np.float32(0.5)
        np.clip(v, 0, 255, out=v)
        return v.astype(np.uint8)

    def _yflip(self, pts: np.ndarray) -> np.ndarray:
        out = np.array(pts, np.float64, copy=True)
        out[:, 1] = self.hf - out[:, 1]
        return out

    def _clip_px(self, clip: Bbox | None) -> tuple[int, int, int, int]:
        if clip is None:
            return 0, 0, self.w, self.h
        x0 = max(int(math.floor(clip.x0 + 0.5)), 0)
        x1 = min(int(math.floor(clip.x1 + 0.5)), self.w)
        y0 = max(int(math.floor(self.hf - clip.y1 + 0.5)), 0)
        y1 = min(int(math.floor(self.hf - clip.y0 + 0.5)), self.h)
        return x0, y0, x1, y1

    def _blend(self, x0: int, y0: int, cov: np.ndarray, rgba, clip: Bbox | None, colors: np.ndarray | None = None):
        """Composite ``cov`` (rows from y0, cols from x0) of colour ``rgba``
        (or per-pixel ``colors``) over the canvas within ``clip``."""
        cx0, cy0, cx1, cy1 = self._clip_px(clip)
        h, w = cov.shape
        ax0, ay0 = max(x0, cx0), max(y0, cy0)
        ax1, ay1 = min(x0 + w, cx1), min(y0 + h, cy1)
        if ax1 <= ax0 or ay1 <= ay0:
            return
        c = cov[ay0 - y0:ay1 - y0, ax0 - x0:ax1 - x0]
        if colors is None and c.all() and c.min() == 1:  # a solid box
            a = rgba[3]
            dst = self.px[ay0:ay1, ax0:ax1]
            dst *= 1 - a
            dst += a * np.asarray(rgba[:3])
            return
        yy, xx = np.nonzero(c)  # shapes touch few of their box's pixels: update only those
        self._blend_at(yy + ay0, xx + ax0, c[yy, xx], rgba,
                       None if colors is None else colors[ay0 - y0 + yy, ax0 - x0 + xx])

    def _blend_at(self, yy: np.ndarray, xx: np.ndarray, cov: np.ndarray, rgba, colors: np.ndarray | None = None):
        """Composite coverage ``cov`` at the distinct pixels (yy, xx) in
        colour ``rgba`` (or per-pixel RGBA ``colors``)."""
        a = cov[:, None]
        if colors is None:
            a = a * rgba[3]
            col = np.asarray(rgba[:3])
        else:
            a = a * colors[:, 3:4]
            col = colors[:, :3]
        self.px[yy, xx] = self.px[yy, xx] * (1 - a) + a * col

    # --- primitives
    def rect(self, b: Bbox, rgba, snap: bool = False, clip: Bbox | None = None) -> None:
        if rgba[3] == 0:
            return
        x0, x1 = sorted((b.x0, b.x1))
        y0, y1 = sorted((self.hf - b.y1, self.hf - b.y0))
        if snap:
            x0, x1, y0, y1 = (math.floor(v + 0.5) for v in (x0, x1, y0, y1))
            if x1 <= x0 or y1 <= y0:
                return
            self._blend(int(x0), int(y0), np.ones((int(y1 - y0), int(x1 - x0))), rgba, clip)
            return
        self.fill([np.array([[x0, y0], [x1, y0], [x1, y1], [x0, y1]])], rgba, clip=clip)

    def round_rect(self, b: Bbox, radius: float, face, edge, lw: float) -> None:
        """A rounded box (the legend frame): ``face`` fill, ``edge`` stroke."""
        x0, x1 = b.x0, b.x1
        y0, y1 = self.hf - b.y1, self.hf - b.y0
        r = min(radius, (x1 - x0) / 2, (y1 - y0) / 2)
        t = np.linspace(0, np.pi / 2, 9)
        corners = [(x1 - r, y1 - r, 0), (x0 + r, y1 - r, 1), (x0 + r, y0 + r, 2), (x1 - r, y0 + r, 3)]
        pts = []
        for cx, cy, k in corners:
            a = t + k * np.pi / 2
            pts.append(np.stack([cx + r * np.cos(a), cy + r * np.sin(a)], 1))
        poly = np.concatenate(pts)
        self.fill([poly], face)
        self.polyline(np.concatenate([poly, poly[:1]]), lw, edge, caps="butt")

    def fill(self, polys: list[np.ndarray], rgba, display: bool = False, clip: Bbox | None = None) -> None:
        """Fill closed polygons by the nonzero rule, anti-aliased: each
        sub-row's exact horizontal coverage, ``SUBROWS`` sub-rows a pixel."""
        polys = [self._yflip(p) if display else np.asarray(p, np.float64) for p in polys if len(p) > 2]
        if not polys or rgba[3] == 0:
            return
        allp = np.concatenate(polys)
        x0 = int(math.floor(allp[:, 0].min()))
        y0 = int(math.floor(allp[:, 1].min()))
        x1 = int(math.ceil(allp[:, 0].max())) + 1
        y1 = int(math.ceil(allp[:, 1].max())) + 1
        cx0, cy0, cx1, cy1 = self._clip_px(clip)
        if x1 <= cx0 or y1 <= cy0 or x0 >= cx1 or y0 >= cy1:
            return
        ss = self.SUBROWS
        W, H = x1 - x0, y1 - y0
        a = np.concatenate(polys)
        b = np.concatenate([np.roll(p, -1, 0) for p in polys])
        ya, yb = (a[:, 1] - y0) * ss, (b[:, 1] - y0) * ss
        xa, xb = a[:, 0] - x0, b[:, 0] - x0
        lo, hi = np.minimum(ya, yb), np.maximum(ya, yb)
        r0 = np.ceil(lo - 0.5).astype(np.int64)
        r1 = np.ceil(hi - 0.5).astype(np.int64)
        n = np.maximum(r1 - r0, 0)
        if n.sum() == 0:
            return
        e = np.repeat(np.arange(len(a)), n)
        r = r0[e] + (np.arange(n.sum()) - np.repeat(np.cumsum(n) - n, n))
        t = (r + 0.5 - ya[e]) / (yb[e] - ya[e])
        x = xa[e] + t * (xb[e] - xa[e])
        d = np.sign(yb[e] - ya[e])
        x = np.clip(x, 0, W)
        xi = np.floor(x).astype(np.int64)
        frac = x - xi
        acc = np.zeros((H * ss, W + 2))
        np.add.at(acc, (r, xi), d * (1 - frac))
        np.add.at(acc, (r, xi + 1), d * frac)
        wind = np.cumsum(acc, 1)[:, :W]
        cov = np.clip(np.abs(wind), 0, 1).reshape(H, ss, W).mean(1)
        self._blend(x0, y0, cov, rgba, clip)

    def polyline(self, pts: np.ndarray, lw: float, rgba, display: bool = False, clip: Bbox | None = None,
                 snap: bool = False, caps: str = "projecting") -> None:
        """Stroke a polyline (NaN breaks it) of width ``lw`` px: coverage from
        each pixel centre's distance to the nearest segment."""
        if rgba[3] == 0 or lw <= 0:
            return
        p = self._yflip(pts) if display else np.asarray(pts, np.float64)
        if snap:
            p = _snap(p, lw)
        half = lw / 2
        finite = np.isfinite(p).all(1)
        segs = []
        start = None
        for i in range(len(p) + 1):
            ok = i < len(p) and finite[i]
            if ok and start is None:
                start = i
            elif not ok and start is not None:
                run = p[start:i]
                if len(run) == 1:
                    run = np.concatenate([run, run])
                run = run.copy()
                if caps == "projecting":
                    for end, nb in ((0, 1), (-1, -2)):
                        v = run[end] - run[nb]
                        norm = np.hypot(*v)
                        if norm > 0:
                            run[end] = run[end] + v / norm * half
                segs.append(np.concatenate([run[:-1], run[1:]], 1))
                start = None
        if not segs:
            return
        s = np.concatenate(segs)
        # split long segments so that their pixel boxes stay small
        length = np.hypot(s[:, 2] - s[:, 0], s[:, 3] - s[:, 1])
        k = np.maximum(np.ceil(length / 16), 1).astype(np.int64)
        e = np.repeat(np.arange(len(s)), k)
        j = np.arange(k.sum()) - np.repeat(np.cumsum(k) - k, k)
        t0, t1 = j / k[e], (j + 1) / k[e]
        P, Q = s[e, :2], s[e, 2:]
        A = P + (Q - P) * t0[:, None]
        B = P + (Q - P) * t1[:, None]
        butt = caps == "butt"
        self._stroke_segments(A, B, half, rgba, clip, butt=butt)

    def dashed(self, seg: np.ndarray, lw: float, rgba, pattern: tuple[float, float], clip: Bbox | None = None) -> None:
        """A straight display segment, snapped as Agg snaps it, stroked in
        butt-capped dashes of ``pattern`` (on, off) px from its first point."""
        p = _snap(self._yflip(seg), lw)
        d = p[1] - p[0]
        length = float(np.hypot(*d))
        if length == 0 or rgba[3] == 0:
            return
        on, off = pattern
        starts = np.arange(0.0, length, on + off)
        ends = np.minimum(starts + on, length)
        u = d / length
        self._stroke_segments(p[0] + starts[:, None] * u, p[0] + ends[:, None] * u, lw / 2, rgba, clip, butt=True)

    def _stroke_segments(self, A, B, half, rgba, clip, butt=False) -> None:
        reach = half + 1.0
        bx0 = np.floor(np.minimum(A[:, 0], B[:, 0]) - reach).astype(np.int64)
        by0 = np.floor(np.minimum(A[:, 1], B[:, 1]) - reach).astype(np.int64)
        bx1 = np.ceil(np.maximum(A[:, 0], B[:, 0]) + reach).astype(np.int64)
        by1 = np.ceil(np.maximum(A[:, 1], B[:, 1]) + reach).astype(np.int64)
        cx0, cy0, cx1, cy1 = self._clip_px(clip)
        bx0, by0 = np.maximum(bx0, cx0), np.maximum(by0, cy0)
        bx1, by1 = np.minimum(bx1, cx1), np.minimum(by1, cy1)
        nw, nh = np.maximum(bx1 - bx0, 0), np.maximum(by1 - by0, 0)
        cnt = nw * nh
        if cnt.sum() == 0:
            return
        e = np.repeat(np.arange(len(A)), cnt)
        j = np.arange(cnt.sum()) - np.repeat(np.cumsum(cnt) - cnt, cnt)
        px = bx0[e] + j % np.maximum(nw[e], 1)
        py = by0[e] + j // np.maximum(nw[e], 1)
        cxp, cyp = px + 0.5, py + 0.5
        ax_, ay_ = A[e, 0], A[e, 1]
        dx, dy = B[e, 0] - ax_, B[e, 1] - ay_
        ll = dx * dx + dy * dy
        with np.errstate(invalid="ignore", divide="ignore"):
            t = np.where(ll > 0, ((cxp - ax_) * dx + (cyp - ay_) * dy) / ll, 0.0)
        if butt:
            along = np.where(ll > 0, np.maximum(-t, t - 1) * np.sqrt(ll), 0.0)
            tc = np.clip(t, 0, 1)
            dist = np.hypot(cxp - (ax_ + tc * dx), cyp - (ay_ + tc * dy))
            perp = np.where(ll > 0, np.abs((cxp - ax_) * dy - (cyp - ay_) * dx) / np.sqrt(np.maximum(ll, 1e-30)),
                            dist)
            cov = np.clip(half + 0.5 - perp, 0, min(1.0, 2 * half)) * np.clip(0.5 - along, 0, 1)
        else:
            tc = np.clip(t, 0, 1)
            dist = np.hypot(cxp - (ax_ + tc * dx), cyp - (ay_ + tc * dy))
            cov = np.clip(half + 0.5 - dist, 0, min(1.0, 2 * half))
        # a pixel that several segments reach takes the largest coverage
        idx = py * self.w + px
        order = np.argsort(idx, kind="stable")
        idx, cov = idx[order], cov[order]
        first = np.flatnonzero(np.concatenate([[True], idx[1:] != idx[:-1]]))
        idx, cov = idx[first], np.maximum.reduceat(cov, first)
        hit = cov > 0
        self._blend_at(idx[hit] // self.w, idx[hit] % self.w, cov[hit], rgba)

    def disks(self, centers: np.ndarray, radius: float, colors, clip: Bbox | None = None, inner: float = 0.0) -> None:
        """Anti-aliased disks (or rings ``inner`` < r < ``radius``) at display
        ``centers``; ``colors`` is one RGBA or one per disk."""
        c = self._yflip(centers)
        per = np.ndim(colors) == 2
        cols = np.asarray(colors, np.float64) if per else np.tile(np.asarray(colors, np.float64), (len(c), 1))
        reach = radius + 1.0
        bx0 = np.floor(c[:, 0] - reach).astype(np.int64)
        by0 = np.floor(c[:, 1] - reach).astype(np.int64)
        n = int(math.ceil(2 * reach)) + 1
        cx0, cy0, cx1, cy1 = self._clip_px(clip)
        jj = np.arange(n * n)
        e = np.repeat(np.arange(len(c)), n * n)
        px = bx0[e] + np.tile(jj % n, len(c))
        py = by0[e] + np.tile(jj // n, len(c))
        keep = (px >= cx0) & (px < cx1) & (py >= cy0) & (py < cy1)
        e, px, py = e[keep], px[keep], py[keep]
        if not len(e):
            return
        d = np.hypot(px + 0.5 - c[e, 0], py + 0.5 - c[e, 1])
        cov = np.clip(radius + 0.5 - d, 0, 1)
        if inner > 0:
            cov = np.minimum(cov, np.clip(d - inner + 0.5, 0, 1))
        a = cov * cols[e, 3]
        gx0, gy0 = int(px.min()), int(py.min())
        gx1, gy1 = int(px.max()) + 1, int(py.max()) + 1
        # composite disk by disk: the transmittance multiplies, the last colour drawn wins
        logt = np.zeros((gy1 - gy0, gx1 - gx0))
        np.add.at(logt, (py - gy0, px - gx0), np.log1p(-np.minimum(a, 1 - 1e-12)))
        col = np.zeros((gy1 - gy0, gx1 - gx0, 3))
        order = np.argsort(e, kind="stable")
        col[py[order] - gy0, px[order] - gx0] = cols[e[order], :3]
        alpha = 1 - np.exp(logt)
        dst = self.px[gy0:gy1, gx0:gx1]
        dst *= 1 - alpha[..., None]
        dst += alpha[..., None] * col

    def image(self, rgba_u8: np.ndarray, extent: Bbox, clip: Bbox) -> None:
        """Draw an (h, w, 4) uint8 image, first row at the top of the display
        box ``extent``, as Agg's ``_make_image`` does: resampled onto a grid
        of ceil(width) x ceil(height) pixels spanning the part inside
        ``clip`` (nearest when magnified, area average when shrunk), pasted
        at the rounded corner."""
        h, w = rgba_u8.shape[:2]
        cb = Bbox(max(extent.x0, clip.x0), max(extent.y0, clip.y0), min(extent.x1, clip.x1),
                  min(extent.y1, clip.y1))
        if cb.width <= 0 or cb.height <= 0:
            return
        wc, hc = int(math.ceil(cb.width)), int(math.ceil(cb.height))
        src = rgba_u8.astype(np.float64) / 255
        xs = cb.x0 + np.arange(wc + 1) * (cb.width / wc)  # output pixel edges, display
        ys = cb.y1 - np.arange(hc + 1) * (cb.height / hc)
        ce = (xs - extent.x0) / extent.width * w  # in source columns / rows
        re = (extent.y1 - ys) / extent.height * h
        if wc >= w and hc >= h:
            ci = np.clip(np.floor((ce[:-1] + ce[1:]) / 2).astype(int), 0, w - 1)
            ri = np.clip(np.floor((re[:-1] + re[1:]) / 2).astype(int), 0, h - 1)
            img = src[ri][:, ci]
        else:
            img = _area_resample(src, np.clip(re, 0, h), np.clip(ce, 0, w))
        left = int(math.floor(cb.x0 + 0.5))
        top = self.h - (int(math.floor(cb.y0 + 0.5)) + hc)
        self._blend(left, top, np.ones((hc, wc)), None, None, colors=img)


def _area_resample(src: np.ndarray, row_edges: np.ndarray, col_edges: np.ndarray) -> np.ndarray:
    def weights(edges, n):
        lo, hi = np.minimum(edges[:-1], edges[1:]), np.maximum(edges[:-1], edges[1:])
        k = np.arange(n)
        wgt = np.clip(np.minimum(hi[:, None], k[None, :] + 1) - np.maximum(lo[:, None], k[None, :]), 0, None)
        s = wgt.sum(1, keepdims=True)
        return wgt / np.where(s > 0, s, 1)

    wr = weights(row_edges, src.shape[0])
    wc = weights(col_edges, src.shape[1])
    return np.einsum("ij,jkc,lk->ilc", wr, src, wc)
