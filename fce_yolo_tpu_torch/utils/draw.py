"""The cv2 drawing calls of the JAX package's plotting (``engine/results.py``
``Results.plot``, ``utils/annotator.py``), on numpy uint8 images in place,
without cv2.

Each primitive follows OpenCV's own ``drawing.cpp`` step by step, in its
16-bit fixed point (``XY_SHIFT``), so that it sets the pixels cv2 sets:

- ``line``, ``rectangle``, ``polylines`` and ``circle`` at thickness 1 with
  ``LINE_8`` (Bresenham, ``Line``; the midpoint ``Circle``), filled
  rectangles (``FillConvexPoly``) and filled ``LINE_8`` circles;
- thicker ``LINE_8`` strokes: ``ThickLine``, a quad of half-width
  ``(thickness + odd) / 2`` filled by ``FillConvexPoly`` with its edges
  drawn by ``Line2``, and a filled ``Circle`` of radius ``(thickness + 1)
  // 2`` on each joint; a stroke in whole pixels is first clipped to the
  image widened by its thickness (a stroke of thickness 1 is ``Line``
  between its end points rounded to pixels, whatever the shift);
- ``add_weighted``: ``a * alpha + b * beta + gamma`` as cv2's AVX2 build
  takes it (two fused multiply-adds in float32), rounded half to even and
  saturated;
- ``get_text_size``: cv2 5.0 renders ``FONT_HERSHEY_SIMPLEX`` with a
  TrueType face. Its size in pixels is ``round(scale / 0.037)``; a string's
  width is the sum of its characters' advances + 1 and its baseline the
  largest of their descents. ``_METRICS`` holds the advances and descents
  of the 95 printable characters, measured from ``cv2.getTextSize`` at the
  sizes the port's labels use (9 ``lw`` for ``lw`` 1 to 9, and 14, the
  default of ``Results.plot``), regular (thickness 1) and bold (2 or more);
  other sizes scale the 27-pixel row and may differ from cv2 by a pixel.

Not equal to cv2, and bounded by the tests instead:

- ``LINE_AA``: cv2's anti-aliased edges come from filter tables this module
  does not hold; ``_aa_coverage`` spreads each edge over the two nearest
  pixels across it, and a shape's edges blend once, together;
- the glyphs: cv2 5.0 draws an anti-aliased TrueType face. ``put_text``
  draws this module's own 5 x 7 dot font, each glyph spread over cv2's
  advance and a cap height of 20/27 of the size, bolder with the thickness.
"""

from __future__ import annotations

import math

import numpy as np

from fce_yolo_tpu_torch.ops.geometry import _clip_line, _line_pixels

__all__ = ["LINE_8", "LINE_AA", "FONT_HERSHEY_SIMPLEX", "line", "rectangle", "circle", "polylines", "add_weighted",
           "get_text_size", "put_text"]

LINE_8, LINE_AA = 8, 16
FONT_HERSHEY_SIMPLEX = 0
XY_SHIFT = 16
XY_ONE = 1 << XY_SHIFT


def _trunc_div(a: int, b: int) -> int:
    """C's integer division (toward zero)."""
    q = abs(a) // abs(b)
    return q if (a >= 0) == (b >= 0) else -q


def _color(img: np.ndarray, color) -> np.ndarray:
    c = np.atleast_1d(np.asarray(color, np.float64))
    n = 1 if img.ndim == 2 else img.shape[2]
    c = np.resize(c, n) if len(c) >= n else np.concatenate([c, np.zeros(n - len(c))])
    return np.clip(np.rint(c), 0, 255).astype(img.dtype)


def _put(img: np.ndarray, xs, ys, color: np.ndarray) -> None:
    xs, ys = np.asarray(xs, np.int64), np.asarray(ys, np.int64)
    keep = (xs >= 0) & (xs < img.shape[1]) & (ys >= 0) & (ys < img.shape[0])
    img[ys[keep], xs[keep]] = color


def _hline(img: np.ndarray, y: int, x1: int, x2: int, color: np.ndarray) -> None:
    img[y, x1: x2 + 1] = color


# ---------------------------------------------------------------- lines
def _line8(img: np.ndarray, p0, p1, color: np.ndarray) -> None:
    """OpenCV's ``Line`` (8-connected), integer end points."""
    h, w = img.shape[:2]
    xs, ys = _line_pixels(w, h, int(p0[0]), int(p0[1]), int(p1[0]), int(p1[1]))
    img[ys, xs] = color


def _line2(img: np.ndarray, p0, p1, color: np.ndarray) -> None:
    """OpenCV's ``Line2``: an 8-connected line between fixed-point end points."""
    h, w = img.shape[:2]
    ok, x1, y1, x2, y2 = _clip_line(w << XY_SHIFT, h << XY_SHIFT, int(p0[0]), int(p0[1]), int(p1[0]), int(p1[1]))
    if not ok:
        return
    dx, dy = x2 - x1, y2 - y1
    ax, ay = abs(dx), abs(dy)
    if ax > ay:
        if dx < 0:
            dy, x1, y1, x2, y2 = -dy, x2, y2, x1, y1
        y_step = _trunc_div(dy << XY_SHIFT, ax | 1)
        ecount = (x2 - x1) >> XY_SHIFT
    else:
        if dy < 0:
            dx, x1, y1, x2, y2 = -dx, x2, y2, x1, y1
        x_step = _trunc_div(dx << XY_SHIFT, ay | 1)
        ecount = (y2 - y1) >> XY_SHIFT
    x1 += XY_ONE >> 1
    y1 += XY_ONE >> 1
    _put(img, [(x2 + (XY_ONE >> 1)) >> XY_SHIFT], [(y2 + (XY_ONE >> 1)) >> XY_SHIFT], color)
    if ecount < 0:
        return
    k = np.arange(ecount + 1, dtype=np.int64)
    if ax > ay:
        _put(img, (x1 >> XY_SHIFT) + k, (y1 + k * y_step) >> XY_SHIFT, color)
    else:
        _put(img, (x1 + k * x_step) >> XY_SHIFT, (y1 >> XY_SHIFT) + k, color)


def _aa_coverage(h: int, w: int, segments) -> tuple[np.ndarray, np.ndarray]:
    """The pixels (flat indices) that anti-aliased lines between fixed-point
    end points cover, with their coverage: along each line's major axis the
    two pixels nearest the line share it, and a pixel two lines cover keeps
    the larger share (a stand-in for OpenCV's ``LineAA``, whose filter
    tables differ)."""
    rows = []
    for p0, p1 in segments:
        ok, x1, y1, x2, y2 = _clip_line(w << XY_SHIFT, h << XY_SHIFT, int(p0[0]), int(p0[1]), int(p1[0]),
                                        int(p1[1]))
        if not ok:
            continue
        fx1, fy1, fx2, fy2 = x1 / XY_ONE, y1 / XY_ONE, x2 / XY_ONE, y2 / XY_ONE
        steep = abs(fy2 - fy1) > abs(fx2 - fx1)
        if steep:
            fx1, fy1, fx2, fy2 = fy1, fx1, fy2, fx2
        if fx2 < fx1:
            fx1, fy1, fx2, fy2 = fx2, fy2, fx1, fy1
        first, last = math.floor(fx1 + 0.5), math.floor(fx2 + 0.5)
        rows.append((first, last - first + 1, fx1, fy1, (fy2 - fy1) / (fx2 - fx1) if fx2 > fx1 else 0.0, steep))
    if not rows:
        return np.zeros(0, np.int64), np.zeros(0)
    first, n, fx1, fy1, slope, steep = (np.array(c) for c in zip(*rows))
    seg = np.repeat(np.arange(len(rows)), n)
    major = first[seg] + np.arange(len(seg)) - np.repeat(np.cumsum(n) - n, n)
    minor = fy1[seg] + (major - fx1[seg]) * slope[seg]
    base = np.floor(minor).astype(np.int64)
    frac = minor - base
    st = steep[seg]
    idx, cov = [], []
    for off, c in ((0, 1 - frac), (1, frac)):
        xs, ys = np.where(st, base + off, major), np.where(st, major, base + off)
        keep = (xs >= 0) & (xs < w) & (ys >= 0) & (ys < h) & (c > 0)
        idx.append(ys[keep] * w + xs[keep])
        cov.append(c[keep])
    idx, cov = np.concatenate(idx), np.concatenate(cov)
    if not len(idx):
        return idx, cov
    order = np.lexsort((-cov, idx))  # per pixel, the largest coverage first
    idx, cov = idx[order], cov[order]
    first_of = np.r_[True, idx[1:] != idx[:-1]]
    return idx[first_of], cov[first_of]


def _line_aa(img: np.ndarray, p0, p1, color: np.ndarray) -> None:
    """An anti-aliased line between fixed-point end points (``_aa_coverage``)."""
    _blend(img, *_aa_coverage(img.shape[0], img.shape[1], [(p0, p1)]), color)


def _blend(img: np.ndarray, idx: np.ndarray, cov: np.ndarray, color: np.ndarray) -> None:
    """dst += (color - dst) * coverage, rounded, at the flat pixel indices ``idx``."""
    ys, xs = np.divmod(idx, img.shape[1])
    c = np.minimum(cov, 1.0)
    if img.ndim == 3:
        c = c[:, None]
    dst = img[ys, xs].astype(np.float64)
    img[ys, xs] = np.clip(np.rint(dst + (color.astype(np.float64) - dst) * c), 0, 255).astype(img.dtype)


def _edge(img: np.ndarray, p0, p1, color: np.ndarray, shift: int) -> None:
    """A polygon's 8-connected edge between fixed-point end points."""
    if shift == 0:
        _line8(img, (p0[0] >> XY_SHIFT, p0[1] >> XY_SHIFT), (p1[0] >> XY_SHIFT, p1[1] >> XY_SHIFT), color)
    else:
        _line2(img, p0, p1, color)


# ---------------------------------------------------------------- polygons
def _fill_convex_poly(img: np.ndarray, v: list[tuple[int, int]], color: np.ndarray, line_type: int, shift: int) -> None:
    """OpenCV's ``FillConvexPoly``: the outline (``Line`` / ``Line2`` /
    anti-aliased), then a scanline fill between the two edge chains that
    leave the top vertex, x in 16-bit fixed point."""
    h, w = img.shape[:2]
    npts = len(v)
    delta = 1 << shift >> 1
    delta1, delta2 = (XY_ONE >> 1, XY_ONE >> 1) if line_type < LINE_AA else (XY_ONE - 1, 0)
    up = XY_SHIFT - shift
    p0 = (v[-1][0] << up, v[-1][1] << up)
    xmin = xmax = v[0][0]
    ymin = ymax = v[0][1]
    imin = 0
    aa_edges = []
    for i, (x, y) in enumerate(v):
        if y < ymin:
            ymin, imin = y, i
        ymax, xmax, xmin = max(ymax, y), max(xmax, x), min(xmin, x)
        p = (x << up, y << up)
        if line_type == LINE_AA:
            aa_edges.append((p0, p))
        else:
            _edge(img, p0, p, color, shift)
        p0 = p
    if aa_edges:  # the outline's edges blend once, together
        _blend(img, *_aa_coverage(h, w, aa_edges), color)
    xmin, xmax, ymin, ymax = ((c + delta) >> shift for c in (xmin, xmax, ymin, ymax))
    if npts < 3 or xmax < 0 or ymax < 0 or xmin >= w or ymin >= h:
        return
    ymax = min(ymax, h - 1)
    edges = npts
    # per chain: [idx, di, x, dx, ye]
    edge = [[imin, 1, -XY_ONE, 0, ymin], [imin, npts - 1, -XY_ONE, 0, ymin]]
    runs = []  # (first row, rows, x and dx of each chain): x moves by dx a row between the chains' vertices
    y = ymin
    while True:
        if line_type < LINE_AA or y < ymax or y == ymin:
            for e in edge:
                if y >= e[4]:
                    idx0, di = e[0], e[1]
                    idx = idx0 + di
                    if idx >= npts:
                        idx -= npts
                    while edges > 0:
                        edges -= 1
                        ty = (v[idx][1] + delta) >> shift
                        if ty > y:
                            xs, xe = v[idx0][0] << up, v[idx][0] << up
                            e[4] = ty
                            e[3] = _trunc_div((xe - xs) * 2 + (ty - y), 2 * (ty - y))
                            e[2] = xs
                            e[0] = idx
                            break
                        idx0 = idx
                        idx += di
                        if idx >= npts:
                            idx -= npts
                    else:
                        edges -= 1
        if edges < 0:
            break
        end = min([ymax + 1] + [e[4] for e in edge if e[4] > y])  # the next row a chain may turn
        if line_type == LINE_AA and end == ymax:  # the last row takes no turn
            end = ymax + 1
        runs.append((y, end - y, edge[0][2], edge[0][3], edge[1][2], edge[1][3]))
        for e in edge:
            e[2] += (end - y) * e[3]
        y = end
        if y > ymax:
            break
    if not runs:
        return
    y0, n, xa, dxa, xb, dxb = (np.array(c, np.int64) for c in zip(*runs))
    run = np.repeat(np.arange(len(runs)), n)
    k = np.arange(len(run)) - np.repeat(np.cumsum(n) - n, n)
    ys, a, b = y0[run] + k, xa[run] + k * dxa[run], xb[run] + k * dxb[run]
    xx1, xx2 = (np.minimum(a, b) + delta1) >> XY_SHIFT, (np.maximum(a, b) + delta2) >> XY_SHIFT
    keep = (ys >= 0) & (xx2 >= 0) & (xx1 < w)
    ys, xx1, xx2 = ys[keep], np.maximum(xx1[keep], 0), np.minimum(xx2[keep], w - 1)
    count = np.maximum(xx2 - xx1 + 1, 0)
    row = np.repeat(np.arange(len(ys)), count)
    img[ys[row], xx1[row] + np.arange(len(row)) - np.repeat(np.cumsum(count) - count, count)] = color


def _circle(img: np.ndarray, center, radius: int, color: np.ndarray, fill: bool) -> None:
    """OpenCV's midpoint ``Circle`` (integer centre and radius)."""
    h, w = img.shape[:2]
    cx, cy = int(center[0]), int(center[1])
    err, dx, dy, plus, minus = 0, radius, 0, 1, (radius << 1) - 1
    pts = []  # (dx, dy) of each step: rows cy -+ dy span cx -+ dx, rows cy -+ dx span cx -+ dy
    while dx >= dy:
        pts.append((dx, dy))
        dy += 1
        err += plus
        plus += 2
        mask = (err <= 0) - 1
        err -= minus & mask
        dx += mask
        minus -= mask & 2
    for a, b in pts:
        for yy, half in ((cy - b, a), (cy + b, a), (cy - a, b), (cy + a, b)):
            if not 0 <= yy < h:
                continue
            x1, x2 = cx - half, cx + half
            if fill:
                if x2 >= 0 and x1 < w:
                    _hline(img, yy, max(x1, 0), min(x2, w - 1), color)
            else:
                for xx in (x1, x2):
                    if 0 <= xx < w:
                        img[yy, xx] = color


# OpenCV's SinTable: sin of whole degrees 0-450, seven decimals, as float32
_SIN = np.round(np.sin(np.deg2rad(np.arange(451))), 7).astype(np.float32).astype(np.float64)


def _ellipse_poly(center, axes, angle: int, arc_start: int, arc_end: int, delta: int) -> list[tuple[float, float]]:
    """OpenCV's ``ellipse2Poly`` (double centre and axes)."""
    angle %= 360
    if arc_start > arc_end:
        arc_start, arc_end = arc_end, arc_start
    while arc_start < 0:
        arc_start, arc_end = arc_start + 360, arc_end + 360
    while arc_end > 360:
        arc_start, arc_end = arc_start - 360, arc_end - 360
    if arc_end - arc_start > 360:
        arc_start, arc_end = 0, 360
    alpha, beta = _SIN[450 - angle], _SIN[angle]
    pts = []
    for i in range(arc_start, arc_end + delta, delta):
        a = min(i, arc_end)
        if a < 0:
            a += 360
        x, y = axes[0] * _SIN[450 - a], axes[1] * _SIN[a]
        pts.append((center[0] + x * alpha - y * beta, center[1] + x * beta + y * alpha))
    if len(pts) == 1:
        pts = [tuple(center)] * 2
    return pts


def _ellipse_ex(img: np.ndarray, center, axes, color: np.ndarray, thickness: int, line_type: int) -> None:
    """OpenCV's ``EllipseEx`` for a whole ellipse, centre and axes fixed-point."""
    axes = (abs(axes[0]), abs(axes[1]))
    delta = (max(axes) + (XY_ONE >> 1)) >> XY_SHIFT
    delta = 90 if delta < 3 else 30 if delta < 10 else 18 if delta < 15 else 5
    v = []
    for x, y in _ellipse_poly((float(center[0]), float(center[1])), (float(axes[0]), float(axes[1])), 0, 0, 360, delta):
        px, py = round(x / XY_ONE) << XY_SHIFT, round(y / XY_ONE) << XY_SHIFT
        pt = (px + round(x - px), py + round(y - py))
        if not v or pt != v[-1]:
            v.append(pt)
    if len(v) == 1:
        v = [tuple(center)] * 2
    if thickness >= 0:
        _poly_line(img, v, False, color, thickness, line_type, XY_SHIFT)
    else:
        _fill_convex_poly(img, v, color, line_type, XY_SHIFT)


def _thick_line(img: np.ndarray, p0, p1, color: np.ndarray, thickness: int, line_type: int, flags: int,
                shift: int) -> None:
    """OpenCV's ``ThickLine``: ``flags`` bit 0 caps the first end, bit 1 the second."""
    up = XY_SHIFT - shift
    if thickness > 1 and shift == 0:  # cv2 5.0 clips a pixel stroke to the image widened by the thickness
        h, w = img.shape[:2]
        ok, x0, y0, x1, y1 = _clip_line(w + 2 * thickness, h + 2 * thickness, p0[0] + thickness, p0[1] + thickness,
                                        p1[0] + thickness, p1[1] + thickness)
        if not ok:
            return
        p0, p1 = (x0 - thickness, y0 - thickness), (x1 - thickness, y1 - thickness)
    p0, p1 = (p0[0] << up, p0[1] << up), (p1[0] << up, p1[1] << up)
    if thickness <= 1:
        if line_type < LINE_AA:
            r = XY_ONE >> 1  # cv2 5.0 rounds the end points to pixels here whatever the shift
            _line8(img, ((p0[0] + r) >> XY_SHIFT, (p0[1] + r) >> XY_SHIFT),
                   ((p1[0] + r) >> XY_SHIFT, (p1[1] + r) >> XY_SHIFT), color)
        else:
            _line_aa(img, p0, p1, color)
        return
    dx, dy = (p0[0] - p1[0]) / XY_ONE, (p1[1] - p0[1]) / XY_ONE
    r = dx * dx + dy * dy
    odd = thickness & 1
    thickness <<= XY_SHIFT - 1
    if abs(r) > np.finfo(np.float64).eps:
        r = (thickness + odd * XY_ONE * 0.5) / math.sqrt(r)
        dpx, dpy = round(dy * r), round(dx * r)
        pts = [(p0[0] + dpx, p0[1] + dpy), (p0[0] - dpx, p0[1] - dpy), (p1[0] - dpx, p1[1] - dpy),
               (p1[0] + dpx, p1[1] + dpy)]
        _fill_convex_poly(img, pts, color, line_type, XY_SHIFT)
    for i in range(2):
        if flags & (i + 1):
            if line_type < LINE_AA:
                c = ((p0[0] + (XY_ONE >> 1)) >> XY_SHIFT, (p0[1] + (XY_ONE >> 1)) >> XY_SHIFT)
                _circle(img, c, (thickness + (XY_ONE >> 1)) >> XY_SHIFT, color, True)
            else:
                _ellipse_ex(img, p0, (thickness, thickness), color, -1, line_type)
        p0 = p1


def _poly_line(img: np.ndarray, v: list, closed: bool, color: np.ndarray, thickness: int, line_type: int,
               shift: int) -> None:
    """OpenCV's ``PolyLine``."""
    if not len(v):
        return
    i = len(v) - 1 if closed else 0
    flags = 2 + (not closed)
    p0 = v[i]
    for i in range(0 if closed else 1, len(v)):
        _thick_line(img, p0, v[i], color, thickness, line_type, flags, shift)
        p0 = v[i]
        flags = 2


def _pt(p) -> tuple[int, int]:
    return int(p[0]), int(p[1])


def line(img: np.ndarray, pt1, pt2, color, thickness: int = 1, line_type: int = LINE_8) -> np.ndarray:
    """``cv2.line``."""
    _thick_line(img, _pt(pt1), _pt(pt2), _color(img, color), thickness, line_type, 3, 0)
    return img


def rectangle(img: np.ndarray, pt1, pt2, color, thickness: int = 1, line_type: int = LINE_8) -> np.ndarray:
    """``cv2.rectangle`` (a negative thickness fills)."""
    (x1, y1), (x2, y2) = _pt(pt1), _pt(pt2)
    v = [(x1, y1), (x2, y1), (x2, y2), (x1, y2)]
    c = _color(img, color)
    if thickness >= 0:
        _poly_line(img, v, True, c, thickness, line_type, 0)
    else:
        _fill_convex_poly(img, v, c, line_type, 0)
    return img


def circle(img: np.ndarray, center, radius: int, color, thickness: int = 1, line_type: int = LINE_8) -> np.ndarray:
    """``cv2.circle`` (a negative thickness fills)."""
    c = _color(img, color)
    if thickness > 1 or line_type != LINE_8:
        cx, cy = _pt(center)
        _ellipse_ex(img, (cx << XY_SHIFT, cy << XY_SHIFT), (int(radius) << XY_SHIFT, int(radius) << XY_SHIFT), c,
                    thickness, line_type)
    else:
        _circle(img, _pt(center), int(radius), c, thickness < 0)
    return img


def polylines(img: np.ndarray, pts: list, is_closed: bool, color, thickness: int = 1,
              line_type: int = LINE_8) -> np.ndarray:
    """``cv2.polylines``: each (n, 2) or (n, 1, 2) integer polygon."""
    c = _color(img, color)
    for p in pts:
        v = [tuple(q) for q in np.asarray(p, np.int64).reshape(-1, 2).tolist()]
        _poly_line(img, v, is_closed, c, thickness, line_type, 0)
    return img


def add_weighted(src1: np.ndarray, alpha: float, src2: np.ndarray, beta: float, gamma: float) -> np.ndarray:
    """``cv2.addWeighted`` of two uint8 images: ``fma(a, alpha, fma(b, beta,
    gamma))`` in float32, rounded half to even, saturated."""
    a, b = np.asarray(src1), np.asarray(src2)
    if a.shape != b.shape or a.dtype != np.uint8 or b.dtype != np.uint8:
        raise ValueError("add_weighted takes two uint8 images of one shape")
    f32 = np.float32
    # float32 operands; each fused multiply-add is exact in float64 and rounds once to float32
    t = (b.astype(np.float64) * f32(beta).astype(np.float64) + f32(gamma).astype(np.float64)).astype(f32)
    s = (a.astype(np.float64) * f32(alpha).astype(np.float64) + t.astype(np.float64)).astype(f32)
    return np.clip(np.rint(s), 0, 255).astype(np.uint8)


# ---------------------------------------------------------------- text
# size in pixels -> (regular, bold) x (advance, descent) of chr(32) .. chr(126), hex bytes (cv2 5.0's
# getTextSize, FONT_HERSHEY_SIMPLEX, measured at scale = size * 0.037)
_METRICS_HEX = {
    (9, 0): ("0202030605070602050504050204020405050505050505050505020204050405080606060605050606020605050706060606060505060607060605030403040703050505050503050502020402080505050503040305050705050403020305",
              "0000000001010100020200000100000101000001000101000100000100000000020000010000000100000100000000010001000100010000000000020102000100010101010100030000020000000001020200010001000000020002020200"),
    (9, 1): ("0202040606070702060604050204020506060606060606060606020204050405080606060606050607020606050706060606060605060607060606030503040703050505050504060602020502080605050504050406050705050503020305",
              "0000000001010100020200000100000101000001000101000100000100000000020000010000000100000100000000010001000100010000000000020102000100010101010100030000020000000001020200010001000000020002020200"),
    (14, 0): ("0303050a090b0a030909060903070307090909090909090909090304070807070c0a0a090a09080a0a040909080b0a0a090a0909080a090b090908040704060b050808080808050809030307030d0908080805070509080c08080705030508",
              "0000000002010100020200000200000201000001000101000100000200000000020000010000000100000100000000010001000100010000000000030203000100010101010100040000030000000001030300010001000000030003040300"),
    (14, 1): ("0304060a090b0a030909060904070407090909090909090909090404070807080c0a0a0a0a09090a0b040909080c0a0a090a0a09090a0a0c0a0a09050705060b050809080908060909040408040d0909090906080609080c08080806030608",
              "0000000002010100020200000200000201000001000101000100000200000000020000010000000100000100000000010001000100010000000000030203000100010101010100040000030000000001030300010001000000030003040300"),
    (18, 0): ("0404070d0b0e0d040b0b080b040904090b0b0b0b0b0b0b0b0b0b0405090a090a100c0c0c0d0b0b0d0d050c0b0a0f0d0d0c0d0c0b0b0d0c0f0c0c0b060906080e060a0b0a0b0a070b0b04040904110b0b0b0b0709070b0a0f0a0a090704070a",
              "0000000002010100030300000200000201000001000101000100000200000000030000010000000100000100000000010002000100010000000000040204000100010101010100050000040000000001040400010001000000040004050400"),
    (18, 1): ("0405080d0c0f0e040c0c080b0509050a0c0c0c0c0c0c0c0c0c0c0505090a090b100d0d0d0d0c0b0d0e050c0c0b0f0d0d0c0d0d0c0b0d0d0f0d0c0c070907080e070b0b0b0b0b080c0c05050a05110c0b0b0b080a080c0b0f0b0b0a0704070a",
              "0000000002010100030300000200000201000001000101000100000200000000030000010000000100000100000000010002000100010000000000040204000200010101010100050000040000000001040400010001000000040004050400"),
    (27, 0): ("07070a141115140611110c11070d070d1111111111111111111107070e100e0f181313131311101314071211101614131213121110141217121211090d090c15090f110f11100b111106070e0719111011110a0e0b110f170f0f0e0a060a10",
              "0000000003010100040400000300000301000001000101000100000300000000040000010000000100000100000000010002000100010000000000050305000200010101010100070000060000000001060600010001000000060005070500"),
    (27, 1): ("07080c131216150612120c11070d070f1212121212121212121208080e100e101814141414121114150813121017141413141312111413171313120a0e0a0d150b10111011100c1212070810071a121111110c0f0c12101710100f0b070b10",
              "0000000003010100040400000300000301000001000101000100000300000000040000010000000100000100000000010002000100010000000000050305000200010101010100070000060000000001060600010001000000060005070500"),
    (36, 0): ("09090e1a171d1a08171711170912091217171717171717171717090a12151214201919191a17161a1b0a1817151e1a1a181a1917161a191e1818170c120c101c0c15161516150e16170909130922171616160e130f17151e1415130e080e15",
              "0000000004010100050500000300000401000001000101000100000300000000050000010000000100000100000000010003000100010000000000070407000200010101010100090000080000000001080800010001000000080007090700"),
    (36, 1): ("090a101a191e1c09191911170a120a14191919191919191919190a0b13151316201b1a1a1b18171b1c0b1918161f1b1b191b1a19171b1a1f1919180e130e111c0e16171617161018180a0b150a221817171710141118161f1616140f090f15",
              "0000000004010100050500000300000401000001000101000100000300000000050000010000000100000100000000010003000100010000000000070407000300010101010100090000080000000001080800010001000000080007090700"),
    (45, 0): ("0c0b11211d24210a1d1d151d0b170c171d1d1d1d1d1d1d1d1d1d0c0d171b171928202020211d1c20220d1e1c1b2621201e201f1d1b211f261e1f1c0f170f1423101a1c1a1c1a121c1d0b0c180b2a1d1b1c1c1218121c1a26191a18110b111a",
              "00000000050101000606000004000005010000010001010001000004000000000600000100000001000001000000000100040001000100000000000805080003000101010101000b00000a00000000010a0a000100010000000a00080b0800"),
    (45, 1): ("0c0d14211f26230b1f1f151d0d170d191f1f1f1f1f1f1f1f1f1f0d0e181b181b28212121221e1d22230e1f1f1c2722212021201f1d22202720201e1118111523121b1d1b1d1c141e1e0d0d1b0d2b1e1c1d1d141a151e1c271b1c1a130c131a",
              "00000000050101000606000004000005010000010001010001000004000000000700000100000001000001000000000100040001000100000000000805080004000101010101000b00000a00000000010a0a000100010000000a00080b0800"),
    (54, 0): ("0e0e1528232b280c232319230e1b0e1b232323232323232323230e0f1c201c1e3026262627232127290f2422202d2827252725232128252e242522121b12182b131f221f22201622230d0e1d0e3322212222151d16221f2e1f1f1d150d1520",
              "00000000060101000707000005000005010000010001010001000005000000000700000100000001000001000000000100040001000100000000000a050a0003000101010101000d00000b00000000010b0b000100010000000b000a0d0a00"),
    (54, 1): ("0e101827252d2a0d252519230f1b0f1e2525252525252525252510101d201d2130282828282423282a112625212f2928262827252329272f262624151d151a2a1621232123211824240f10200f3424222323191f1924212f21211f170e1720",
              "00000000060101000707000005000005010000010001010001000005000000000800000100000001000001000000000100040001000100000000000a050a0004000101010101000d00000b00000000010b0b000100010000000b000a0d0a00"),
    (63, 0): ("1110192e29332e0e29291d291020102029292929292929292929111221262123382d2d2c2e28272d30122a2825352e2d2b2d2c29262f2c352a2b281520151d32162528252825192828101122103b2826282819221a282535242522180f1825",
              "00000000070101000808000006000006010000010001010001000006000000000900000100000001000001000000000100050001000100000000000b060b0003000101010101000f00000d00000000010d0d000100010000000d000b0f0b00"),
    (63, 1): ("11121d2e2c35310f2b2b1d29122012232b2b2b2b2b2b2b2b2b2b131322262227382f2e2e2f2a282f31142c2b27372f2f2c2f2d2b29302e372d2d2a1822181e311927292729271c2a2b121326123d2a2829291d241e2a27372627241b111b25",
              "00000000070101000808000006000006010000010001010001000006000000000900000100000001000001000000000100050001000100000000000b060b0005000101010101000f00000d00000000010d0d000100010000000d000b0f0b00"),
    (72, 0): ("13121c352f3a35102f2f222f132513252f2f2f2f2f2f2f2f2f2f1314252b25283f333333342e2c343614302e2b3d35343134322f2c35323d30312e1925192139192a2d2a2d2b1d2d2e12132712442e2c2d2d1d271e2e2a3d292a271c111c2b",
              "00000000080101000909000006000007010000010001010001000006000000000a00000100000001000001000000000100060001000100000000000d070d0004000101010101001100000f00000000010f0f000100010000000f000d110d00"),
    (72, 1): ("13152134323d38123232222e14241528323232323232323232321516272b272c4036353536302e36381732312d3e3636333634322f37343f3333311c271c23381d2c2f2c2f2d20303115162b1545302e2f2f212922302c3f2c2d291f131f2a",
              "00000000080101000909000006000007010000010001010001000006000000000a00000100000001000001000000000100060001000100000000000d070d0005000101010101001100000f00000000010f0f000100010000000f000d110d00"),
    (81, 0): ("1615203c35413c1235352635152915293535353535353535353516172a312a2e473939393b34323a3d17363430443c3a373a3835323c38453637331c291c25401d2f332f333021333414162c154d34313333202c21342f452e2f2c1f141f30",
              "00000000090101000b0b000007000008010000010001010001000007000000000b00000100000001000001000000000100060001000100000000000e080e00040001010101010014000011000000000111110001000100000011000e130e00"),
    (81, 1): ("1618253b38443f14383826341729172d3838383838383838383818192c312c32483c3c3c3d36343d3f1a393732463d3c393c3b38353e3b473a3a371f2c1f273f213235323532243637171931174e36343535252e2636324731322e23162330",
              "00000000090101000b0b000007000008010000010002010001000007000000000c00000100000001000001000000000100060001000100000000000e080e00060001010101010014000011000000000111110001000100000011000e130e00")
}
_METRICS = {k: tuple(np.frombuffer(bytes.fromhex(s), np.uint8).astype(np.int64) for s in v)
            for k, v in _METRICS_HEX.items()}
# the classic 5 x 7 dot font of chr(32) .. chr(126): 5 columns a glyph, bit 0 the top row
_GLYPHS = bytes.fromhex(
    "0000000000" "00005f0000" "0007000700" "147f147f14" "242a7f2a12" "2313086462" "3649552250" "0005030000"
    "001c224100" "0041221c00" "082a1c2a08" "08083e0808" "0050300000" "0808080808" "0060600000" "2010080402"
    "3e5149453e" "00427f4000" "4261514946" "2141454b31" "1814127f10" "2745454539" "3c4a494930" "0171090503"
    "3649494936" "064949291e" "0036360000" "0056360000" "0008142241" "1414141414" "4122140800" "0201510906"
    "3249794f3e" "7e1111117e" "7f49494936" "3e41414122" "7f4141221c" "7f49494941" "7f09090101" "3e41415132"
    "7f0808087f" "00417f4100" "2040413f01" "7f08142241" "7f40404040" "7f0204027f" "7f0408107f" "3e4141413e"
    "7f09090906" "3e4151215e" "7f09192946" "4649494931" "01017f0101" "3f4040403f" "1f2040201f" "7f2018207f"
    "6314081463" "0304780403" "6151494543" "00007f4141" "0204081020" "41417f0000" "0402010204" "4040404040"
    "0001020400" "2054545478" "7f48444438" "3844444420" "384444487f" "3854545418" "087e090102" "081454543c"
    "7f08040478" "00447d4000" "2040443d00" "007f102844" "00417f4000" "7c04180478" "7c08040478" "3844444438"
    "7c14141408" "081414187c" "7c08040408" "4854545420" "043f444020" "3c4040207c" "1c2040201c" "3c4030403c"
    "4428102844" "0c5050503c" "4464544c44" "0008364100" "00007f0000" "0041360800" "08082a1c08")


def _text_px(scale: float) -> int:
    return int(math.floor(scale / 0.037 + 0.5))


def _metrics(size: int, bold: bool) -> tuple[np.ndarray, np.ndarray]:
    if (size, bold) in _METRICS:
        return _METRICS[(size, bold)]
    adv, desc = _METRICS[(27, bold)]
    return np.rint(adv * size / 27).astype(np.int64), np.rint(desc * size / 27).astype(np.int64)


def _codes(text: str) -> np.ndarray:
    c = np.frombuffer(text.encode("ascii", "replace"), np.uint8).astype(np.int64) - 32
    return np.where((c < 0) | (c > 94), ord("?") - 32, c)


def get_text_size(text: str, font_face: int, font_scale: float, thickness: int) -> tuple[tuple[int, int], int]:
    """``cv2.getTextSize``: ((width, height), baseline)."""
    c = _codes(text)
    if not len(c):
        return (0, 0), 0
    size = _text_px(font_scale)
    adv, desc = _metrics(size, thickness > 1)
    return (int(adv[c].sum()) + 1, size), int(desc[c].max())


def put_text(img: np.ndarray, text: str, org, font_face: int, font_scale: float, color, thickness: int = 1,
             line_type: int = LINE_8) -> np.ndarray:
    """``cv2.putText`` with this module's dot font: the baseline at ``org``,
    each glyph over its cv2 advance. ``LINE_AA`` blends by coverage;
    ``LINE_8`` sets the pixels whose centre a dot covers."""
    size = _text_px(font_scale)
    adv, _ = _metrics(size, thickness > 1)
    cap = size * 20 / 27
    dot_h, grow = cap / 7, (max(thickness, 1) - 1) * 0.5
    x0, base = float(org[0]), float(org[1])
    rects = []
    for code in _codes(text).tolist():
        a = float(adv[code])
        dot_w = a / 6
        cols = _GLYPHS[5 * code: 5 * code + 5]
        for i, bits in enumerate(cols):
            for r in range(7):
                if bits >> r & 1:
                    left = x0 + dot_w * (i + 0.5)
                    top = base - cap + dot_h * r
                    rects.append((left - grow, top - grow, left + dot_w + grow, top + dot_h + grow))
        x0 += a
    if not rects:
        return img
    r = np.array(rects)
    h, w = img.shape[:2]
    ya, yb = max(int(math.floor(r[:, 1].min())), 0), min(int(math.ceil(r[:, 3].max())), h)
    xa, xb = max(int(math.floor(r[:, 0].min())), 0), min(int(math.ceil(r[:, 2].max())), w)
    if ya >= yb or xa >= xb:
        return img
    px, py = np.arange(xa, xb), np.arange(ya, yb)
    if line_type == LINE_AA:  # the share of each pixel's square that the dots cover
        cx = np.clip(np.minimum(px + 1, r[:, 2:3]) - np.maximum(px, r[:, 0:1]), 0, 1)
        cy = np.clip(np.minimum(py + 1, r[:, 3:4]) - np.maximum(py, r[:, 1:2]), 0, 1)
    else:  # the pixel centres inside a dot
        cx = ((px + 0.5 >= r[:, 0:1]) & (px + 0.5 < r[:, 2:3])).astype(np.float64)
        cy = ((py + 0.5 >= r[:, 1:2]) & (py + 0.5 < r[:, 3:4])).astype(np.float64)
    cov = np.minimum(np.einsum("ky,kx->yx", cy, cx), 1.0)
    yy, xx = np.nonzero(cov)
    _blend(img, (yy + ya) * w + xx + xa, cov[yy, xx], _color(img, color))
    return img
