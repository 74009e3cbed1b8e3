"""Polygon and rotated-box geometry on the host, in numpy (reference
``fce_yolo_tpu/ops/geometry.py:88, 165`` and the cv2 calls of
``fce_yolo_tpu/data/dataset.py:480-495``).

``fill_poly`` and ``min_area_rect`` stand in for ``cv2.fillPoly`` and
``cv2.minAreaRect`` without cv2: each follows OpenCV's own algorithm step
by step (OpenCV's ``drawing.cpp``, ``convhull.cpp`` and ``rotcalipers.cpp``)
so that it gives OpenCV's answer, not merely a correct one.
``tests/test_torch_task_data.py`` holds both against cv2.

``masks2segments`` (reference ``fce_yolo_tpu/ops/geometry.py:177``) traces
mask outlines with ``ops/contours.py`` in place of ``cv2.findContours``;
``merge_multi_segment`` and ``min_index`` are copies of the reference's
``fce_yolo_tpu/data/converter.py:53-71``.
"""

from __future__ import annotations

import math

import numpy as np

__all__ = ["fill_poly", "min_area_rect", "convex_hull", "xywhr2xyxyxyxy", "regularize_rboxes", "min_index",
           "merge_multi_segment", "masks2segments"]

XY_SHIFT = 16  # OpenCV's fixed-point x of polygon edges
XY_ONE = 1 << XY_SHIFT
_f32 = np.float32


# ------------------------------------------------------------ fillPoly
def _clip_line(w: int, h: int, x1: int, y1: int, x2: int, y2: int) -> tuple[bool, int, int, int, int]:
    """OpenCV's ``clipLine`` (Cohen-Sutherland on the image rectangle, the
    cut points truncated toward zero from a double)."""
    right, bottom = w - 1, h - 1
    if w <= 0 or h <= 0:
        return False, x1, y1, x2, y2
    c1 = (x1 < 0) + (x1 > right) * 2 + (y1 < 0) * 4 + (y1 > bottom) * 8
    c2 = (x2 < 0) + (x2 > right) * 2 + (y2 < 0) * 4 + (y2 > bottom) * 8
    if (c1 & c2) == 0 and (c1 | c2) != 0:
        if c1 & 12:
            a = 0 if c1 < 8 else bottom
            x1 += int(float(a - y1) * (x2 - x1) / (y2 - y1))
            y1 = a
            c1 = (x1 < 0) + (x1 > right) * 2
        if c2 & 12:
            a = 0 if c2 < 8 else bottom
            x2 += int(float(a - y2) * (x2 - x1) / (y2 - y1))
            y2 = a
            c2 = (x2 < 0) + (x2 > right) * 2
        if (c1 & c2) == 0 and (c1 | c2) != 0:
            if c1:
                a = 0 if c1 == 1 else right
                y1 += int(float(a - x1) * (y2 - y1) / (x2 - x1))
                x1 = a
                c1 = 0
            if c2:
                a = 0 if c2 == 1 else right
                y2 += int(float(a - x2) * (y2 - y1) / (x2 - x1))
                x2 = a
                c2 = 0
    return (c1 | c2) == 0, x1, y1, x2, y2


def _line_pixels(w: int, h: int, x1: int, y1: int, x2: int, y2: int) -> tuple[np.ndarray, np.ndarray]:
    """The pixels OpenCV's 8-connected ``Line`` sets (``LineIterator``, left
    to right, clipped to the image): Bresenham with the minor step taken
    where the error is negative."""
    if not (0 <= x1 < w and 0 <= x2 < w and 0 <= y1 < h and 0 <= y2 < h):
        ok, x1, y1, x2, y2 = _clip_line(w, h, x1, y1, x2, y2)
        if not ok:
            return np.zeros(0, np.int64), np.zeros(0, np.int64)
    if x2 < x1:
        x1, y1, x2, y2 = x2, y2, x1, y1
    dx, dy, sy = x2 - x1, abs(y2 - y1), 1 if y2 >= y1 else -1
    vert = dy > dx
    if vert:
        dx, dy = dy, dx
    n = np.arange(dx + 1)
    # err_k = dx - 2dy - 2dy*k + 2dx*m_k, and the minor step k -> k+1 is taken where err_k < 0:
    # m_k (minor steps before pixel k) = the count of j < k with err_j < 0, which is floor((2dy*k + dx - 1) / 2dx)
    # for dx > 0 (the error stays in [-2dy, 2dx - 2dy) after each step)
    minor = (2 * dy * n + dx - 1) // (2 * dx) if dx else n * 0
    major = n
    if vert:
        return x1 + minor, y1 + sy * major
    return x1 + major, y1 + sy * minor


def fill_poly(img: np.ndarray, polygons: list[np.ndarray], color: float = 1.0) -> np.ndarray:
    """``cv2.fillPoly(img, polygons, color)`` on a 2-D ``img`` in place, with
    OpenCV's defaults (8-connected, ``shift`` 0): each polygon's (n, 2)
    int32 vertices give its outline, drawn with ``Line``, and its edges (an
    edge that leaves the image runs through its clipped end points); the
    even-odd scanline fill of all the polygons' edges together
    (``FillEdgeCollection``) spans from the left crossing rounded up to the
    right one rounded down, in 16-bit fixed point. Returns ``img``."""
    h, w = img.shape
    edges = []  # (y0, y1, x at y0, dx), x in XY_SHIFT fixed point
    for poly in polygons:
        pts = np.asarray(poly, np.int64).reshape(-1, 2)
        for i in range(len(pts)):
            (x0, y0), (x1, y1) = pts[i - 1].tolist(), pts[i].tolist()
            px, py = _line_pixels(w, h, x0, y0, x1, y1)
            img[py, px] = color
            # an edge that leaves the image runs through its clipped end points (their x always, their y
            # unless the clipped line is flat)
            p0x, p0y, p1x, p1y = x0 << XY_SHIFT, y0, x1 << XY_SHIFT, y1
            if not (0 <= x0 < w and 0 <= x1 < w and 0 <= y0 < h and 0 <= y1 < h):
                _, t0x, t0y, t1x, t1y = _clip_line(w, h, x0, y0, x1, y1)
                p0x, p1x = t0x << XY_SHIFT, t1x << XY_SHIFT
                if t0y != t1y:
                    p0y, p1y = t0y, t1y
            if y0 == y1:
                continue
            dx = _trunc_div(p1x - p0x, p1y - p0y)
            if y0 < y1:
                edges.append((y0, y1, p0x + (y0 - p0y) * dx, dx))
            else:
                edges.append((y1, y0, p1x + (y1 - p1y) * dx, dx))
    if len(edges) < 2:
        return img
    e = np.array(edges, np.int64)
    ends = e[:, 2] + (e[:, 1] - e[:, 0]) * e[:, 3]
    if (e[:, 1].max() < 0 or e[:, 0].min() >= h or max(e[:, 2].max(), ends.max()) < 0
            or min(e[:, 2].min(), ends.min()) >= w << XY_SHIFT):
        return img
    # every (row, edge) crossing of the rows the fill visits, sorted by x within a row
    y_max = min(int(e[:, 1].max()), h)
    rows_per = np.clip(np.minimum(e[:, 1], y_max) - e[:, 0], 0, None)
    edge_of = np.repeat(np.arange(len(e)), rows_per)
    start = np.cumsum(rows_per) - rows_per
    k = np.arange(len(edge_of)) - np.repeat(start, rows_per)
    ys = e[edge_of, 0] + k
    xs = e[edge_of, 2] + k * e[edge_of, 3]
    order = np.lexsort((xs, ys))
    ys, xs = ys[order], xs[order]
    first = np.r_[0, np.flatnonzero(np.diff(ys)) + 1]
    pos = np.arange(len(ys)) - np.repeat(first, np.diff(np.r_[first, len(ys)]))
    left = pos % 2 == 0
    yl, xl, xr = ys[left], (xs[left] + XY_ONE - 1) >> XY_SHIFT, xs[np.flatnonzero(left) + 1] >> XY_SHIFT
    keep = (yl >= 0) & (xl < w) & (xr >= 0)
    for y, a, b in zip(yl[keep].tolist(), np.clip(xl[keep], 0, None).tolist(), np.clip(xr[keep], None, w - 1).tolist()):
        img[y, a: b + 1] = color
    return img


def _trunc_div(a: int, b: int) -> int:
    """C's integer division (toward zero)."""
    q = abs(a) // abs(b)
    return q if (a >= 0) == (b >= 0) else -q


# ------------------------------------------------------------ minAreaRect
def _sklansky(pts: np.ndarray, start: int, end: int, nsign: int, sign2: int) -> list[int]:
    """OpenCV's ``Sklansky_``: one chain of the hull over x-sorted points, as indices into them."""
    incr = 1 if end > start else -1
    if start == end or (pts[start] == pts[end]).all():
        return [start]
    pprev, pcur, pnext = start, start + incr, start + 2 * incr
    stack = [pprev, pcur, pnext]
    end += incr
    while pnext != end:
        cury, nexty = pts[pcur, 1], pts[pnext, 1]
        by = nexty - cury
        if int(np.sign(by)) != nsign:
            ax, bx = pts[pcur, 0] - pts[pprev, 0], pts[pnext, 0] - pts[pcur, 0]
            ay = cury - pts[pprev, 1]
            convexity = float(ay) * float(bx) - float(ax) * float(by)
            if int(np.sign(convexity)) == sign2 and (ax != 0 or ay != 0):
                pprev, pcur = pcur, pnext
                pnext += incr
                stack.append(pnext)
            elif pprev == start:
                pcur = pnext
                stack[1] = pcur
                pnext += incr
                stack[2] = pnext
            else:
                stack[-2] = pnext
                pcur = pprev
                pprev = stack[-4]
                stack.pop()
        else:
            pnext += incr
            stack[-1] = pnext
    return stack[:-1]


def convex_hull(points: np.ndarray) -> np.ndarray:
    """``cv2.convexHull(points, clockwise=False, returnPoints=False)`` for
    (n, 2) float32 points: the hull's indices, in OpenCV's order and start."""
    pts = np.asarray(points, _f32).reshape(-1, 2)
    n = len(pts)
    if n == 0:
        return np.zeros(0, np.int64)
    order = np.lexsort((pts[:, 1], pts[:, 0]))  # by x, then y (a stable sort: OpenCV's sort ties are equal points)
    s = pts[order]
    if n == 1 or (s[0] == s[-1]).all():
        return order[:1]
    miny = maxy = 0
    for i in range(1, n):
        if s[miny, 1] > s[i, 1]:
            miny = i
        if s[maxy, 1] < s[i, 1]:
            maxy = i
    tl = _sklansky(s, 0, maxy, -1, 1)
    tr = _sklansky(s, n - 1, maxy, -1, -1)
    tl, tr = tr, tl  # counter-clockwise (clockwise=False)
    out = [order[i] for i in tl[:-1]] + [order[tr[i]] for i in range(len(tr) - 1, 0, -1)]
    stop = tr[1] if len(tr) > 2 else tl[-2] if len(tl) > 2 else -1
    bl = _sklansky(s, 0, miny, 1, -1)
    br = _sklansky(s, n - 1, miny, 1, 1)
    if stop >= 0:
        check = bl[1] if len(bl) > 2 else br[2 - len(bl)] if len(bl) + len(br) > 2 else -1
        if check == stop or (check >= 0 and (s[check] == s[stop]).all()):
            bl, br = bl[:2], br[:2]  # collinear points: the lower chain mirrors the upper one
    out += [order[i] for i in bl[:-1]] + [order[br[i]] for i in range(len(br) - 1, 0, -1)]
    return np.asarray(_ascending_shift(out), np.int64)


def _ascending_shift(hull: list[int]) -> list[int]:
    """OpenCV's cyclic shift of the hull that makes its indices ascend or
    descend, where one shift can."""
    nout = len(hull)
    if nout < 3:
        return hull
    min_i = max_i = lt = 0
    for i in range(1, nout):
        idx = hull[i]
        lt += hull[i - 1] < idx
        if 1 < lt <= i - 2:
            break
        if idx < hull[min_i]:
            min_i = i
        if idx > hull[max_i]:
            max_i = i
    if abs(max_i - min_i) not in (1, nout - 1) or not (lt <= 1 or lt >= nout - 2):
        return hull
    ascending = (max_i + 1) % nout == min_i
    j = min_i if ascending else max_i
    if j == 0:
        return hull
    shifted = []
    for i in range(nout):
        cur, nj = hull[j], (j + 1) % nout
        shifted.append(cur)
        if i < nout - 1 and ascending != (cur < hull[nj]):
            return hull
        j = nj
    return shifted


def min_area_rect(points: np.ndarray) -> tuple[tuple[float, float], tuple[float, float], float]:
    """``cv2.minAreaRect`` for (n, 2) float32 points: ((cx, cy), (w, h),
    angle in degrees in [-90, 0)), from OpenCV's rotating calipers on its
    convex hull (the side that turns least chosen by a cross product's
    sign), in its float32 and float64 steps; the angle brought to OpenCV 5's
    range by quarter turns in float64 that swap w and h."""
    pts = np.asarray(points, _f32).reshape(-1, 2)
    hp = pts[convex_hull(pts)]
    n = len(hp)
    if n > 2:
        o0, o1, o2 = _calipers(hp)
        cx = _f32(o0[0] + (o1[0] + o2[0]) * _f32(0.5))
        cy = _f32(o0[1] + (o1[1] + o2[1]) * _f32(0.5))
        bw = _f32(math.sqrt(float(o1[0]) * float(o1[0]) + float(o1[1]) * float(o1[1])))
        bh = _f32(math.sqrt(float(o2[0]) * float(o2[0]) + float(o2[1]) * float(o2[1])))
        angle = math.atan2(float(o1[1]), float(o1[0]))
    elif n == 2:
        cx = _f32((hp[0, 0] + hp[1, 0]) * _f32(0.5))
        cy = _f32((hp[0, 1] + hp[1, 1]) * _f32(0.5))
        dx, dy = float(hp[1, 0] - hp[0, 0]), float(hp[1, 1] - hp[0, 1])
        bw, bh = _f32(math.sqrt(dx * dx + dy * dy)), _f32(0)
        angle = math.atan2(dy, dx)
    else:
        cx, cy = (hp[0, 0], hp[0, 1]) if n == 1 else (_f32(0), _f32(0))
        bw = bh = _f32(0)
        angle = 0.0
    while angle >= 0:  # OpenCV 5's range [-90, 0) degrees: a quarter turn at a time, w and h swapped
        angle, bw, bh = angle - math.pi / 2, bh, bw
    while angle < -math.pi / 2:
        angle, bw, bh = angle + math.pi / 2, bh, bw
    return (float(cx), float(cy)), (float(bw), float(bh)), float(_f32(angle * 180 / math.pi))


def _cw(v: np.ndarray) -> np.ndarray:
    return np.array([v[1], -v[0]], _f32)


def _ccw(v: np.ndarray) -> np.ndarray:
    return np.array([-v[1], v[0]], _f32)


def _is_right(v1: np.ndarray, v2: np.ndarray) -> bool:
    """Whether ``v1`` lies clockwise of ``v2`` (OpenCV's ``firstVecIsRight``)."""
    t = _cw(v1)
    return bool(t[0] * v2[0] + t[1] * v2[1] < 0)


def _calipers(p: np.ndarray) -> tuple[np.ndarray, np.ndarray, np.ndarray]:
    """OpenCV's ``rotatingCalipers`` in its minimum-area mode: the corner
    and the two side vectors of the smallest rectangle."""
    n = len(p)
    vect = np.empty((n, 2), _f32)
    inv_len = np.empty(n, _f32)
    left = bottom = right = top = 0
    left_x = right_x = p[0, 0]
    top_y = bottom_y = p[0, 1]
    for i in range(n):
        x, y = p[i]
        if x < left_x:
            left_x, left = x, i
        if x > right_x:
            right_x, right = x, i
        if y > top_y:
            top_y, top = y, i
        if y < bottom_y:
            bottom_y, bottom = y, i
        nxt = p[(i + 1) % n]
        dx, dy = float(nxt[0] - x), float(nxt[1] - y)
        vect[i] = (dx, dy)
        inv_len[i] = _f32(1.0 / math.sqrt(dx * dx + dy * dy))
    orientation = _f32(0)
    ax, ay = float(vect[n - 1, 0]), float(vect[n - 1, 1])
    for i in range(n):
        bx, by = float(vect[i, 0]), float(vect[i, 1])
        convexity = ax * by - ay * bx
        if convexity != 0:
            orientation = _f32(1) if convexity > 0 else _f32(-1)
            break
        ax, ay = bx, by
    if orientation == 0:
        raise ValueError("min_area_rect: the hull has no turn")
    base_a, base_b = orientation, _f32(0)
    seq = [bottom, right, top, left]
    minarea = _f32(np.finfo(_f32).max)
    best = None
    for _ in range(n):
        # the caliper whose edge turns least: each side's edge brought to the bottom caliper's frame,
        # compared by the sign of a cross product (``firstVecIsRight``)
        rot = [vect[seq[0]], _cw(vect[seq[1]]), -vect[seq[2]], _ccw(vect[seq[3]])]
        main = 0
        for i in range(1, 4):
            if _is_right(rot[i], rot[main]):
                main = i
        pi = seq[main]
        lead_x, lead_y = vect[pi, 0] * inv_len[pi], vect[pi, 1] * inv_len[pi]
        base_a, base_b = ((lead_x, lead_y), (lead_y, -lead_x), (-lead_x, -lead_y), (-lead_y, lead_x))[main]
        seq[main] = (seq[main] + 1) % n
        dx, dy = p[seq[1], 0] - p[seq[3], 0], p[seq[1], 1] - p[seq[3], 1]
        width = dx * base_a + dy * base_b
        dx, dy = p[seq[2], 0] - p[seq[0], 0], p[seq[2], 1] - p[seq[0], 1]
        height = -dx * base_b + dy * base_a
        area = width * height
        if area <= minarea:
            minarea = area
            best = (seq[3], base_a, width, base_b, height, seq[0])
    i_left, a1, width, b1, height, i_bottom = best
    a2, b2 = -b1, a1
    c1 = a1 * p[i_left, 0] + p[i_left, 1] * b1
    c2 = a2 * p[i_bottom, 0] + p[i_bottom, 1] * b2
    idet = _f32(1) / (a1 * b2 - a2 * b1)
    px = (c1 * b2 - c2 * b1) * idet
    py = (a1 * c2 - a2 * c1) * idet
    return np.array([px, py], _f32), np.array([a1 * width, b1 * width], _f32), np.array([a2 * height, b2 * height], _f32)


# ------------------------------------------------------------ rotated boxes
def xywhr2xyxyxyxy(x: np.ndarray) -> np.ndarray:
    """(N, 5) cx cy w h rad -> (N, 4, 2) float32 corner polygons (reference geometry.py:88)."""
    x = np.asarray(x, np.float32)
    cx, cy, w, h, a = (x[:, i] for i in range(5))
    cos, sin = np.cos(a), np.sin(a)
    dx1, dy1 = w / 2 * cos, w / 2 * sin
    dx2, dy2 = -h / 2 * sin, h / 2 * cos
    return np.stack([
        np.stack([cx + dx1 + dx2, cy + dy1 + dy2], -1),
        np.stack([cx + dx1 - dx2, cy + dy1 - dy2], -1),
        np.stack([cx - dx1 - dx2, cy - dy1 - dy2], -1),
        np.stack([cx - dx1 + dx2, cy - dy1 + dy2], -1),
    ], 1).astype(np.float32)


def regularize_rboxes(rboxes: np.ndarray) -> np.ndarray:
    """Canonical rotated boxes: w >= h (w and h swapped, the angle turned a
    quarter where w < h) and the angle in [0, pi) (reference geometry.py:165)."""
    r = np.asarray(rboxes, np.float32).copy()
    w, h, a = r[..., 2].copy(), r[..., 3].copy(), r[..., 4].copy()
    swap = w < h
    r[..., 2] = np.where(swap, h, w)
    r[..., 3] = np.where(swap, w, h)
    r[..., 4] = np.where(swap, a + np.pi / 2, a) % np.pi
    return r


def min_index(arr1: np.ndarray, arr2: np.ndarray) -> tuple[int, int]:
    """The index pair of the closest points of two (N, 2) / (M, 2) point sets."""
    dis = ((arr1[:, None, :] - arr2[None, :, :]) ** 2).sum(-1)
    return tuple(int(i) for i in np.unravel_index(np.argmin(dis, axis=None), dis.shape))


def merge_multi_segment(segments: list) -> list[np.ndarray]:
    """One closed traversal through every part of a multi-part polygon: each
    part is spliced in at its point closest to the outline so far, and the
    walk returns to the splice point."""
    parts = [np.asarray(s, np.float64).reshape(-1, 2) for s in segments]
    merged = parts[0]
    for nxt in parts[1:]:
        i, j = min_index(merged, nxt)
        nxt_rot = np.roll(nxt, -j, axis=0)
        merged = np.concatenate([merged[: i + 1], nxt_rot, nxt_rot[:1], merged[i: i + 1], merged[i + 1:]])
    return [merged]


def masks2segments(masks: np.ndarray, strategy: str = "all", device="cuda") -> list[np.ndarray]:
    """(N, H, W) binary masks -> one float32 (n, 2) polygon a mask: with
    ``strategy="all"`` every outer outline spliced into one
    (``merge_multi_segment``), with ``"largest"`` the outline of the most
    points (the first of equals); (0, 2) for an empty mask. The outlines
    come from ``find_contours_external`` on ``device``."""
    from fce_yolo_tpu_torch.ops.contours import find_contours_external

    if strategy not in ("all", "largest"):
        raise ValueError(f"masks2segments strategy must be 'all' or 'largest', not {strategy!r}")
    out = []
    for m in np.asarray(masks, np.uint8):
        contours = find_contours_external(m, device)
        if not contours:
            out.append(np.zeros((0, 2), np.float32))
            continue
        if strategy == "largest":
            c = max(contours, key=len).reshape(-1, 2)
        elif len(contours) > 1:
            c = np.concatenate(merge_multi_segment([x.reshape(-1, 2) for x in contours]))
        else:
            c = contours[0].reshape(-1, 2)
        out.append(c.astype(np.float32))
    return out
