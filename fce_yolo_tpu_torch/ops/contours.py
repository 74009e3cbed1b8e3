"""The outer outlines of a binary mask without cv2: ``find_contours_external``
and ``contour_area`` return what ``cv2.findContours(mask, RETR_EXTERNAL,
CHAIN_APPROX_SIMPLE)[0]`` and ``cv2.contourArea`` return (the reference
traces mask outlines with them: ``fce_yolo_tpu/engine/results.py:76-84``,
``fce_yolo_tpu/ops/geometry.py:177-200``).

The tracer is Suzuki and Abe's border following as OpenCV writes it
(``contours.cpp`` ``icvFetchContour`` and the scanner around it), so the
points, each outline's start point and direction and the order of the list
are cv2's:

- the mask is padded with a frame of zeros (cv2 pads by one and shifts the
  points back);
- rows are scanned top to bottom, left to right. A 0 -> 1 step starts an
  outer border unless the last labelled run of the row before it is
  positive (the step lies inside a traced object); 1 -> 0 steps (holes) are
  not traced, so holes and what lies in them drop out;
- a trace looks for the first nonzero neighbour clockwise from the left
  (up-left, up, ...), then walks counter-clockwise: from each border pixel
  the search starts one step past the direction it came from. The pixel is
  labelled -126 when the search passed its zero right neighbour, else 2
  where it was 1; a point is kept where the direction changes
  (CHAIN_APPROX_SIMPLE); a lone pixel is one point;
- the list holds the outlines in the reverse of the order found.

Two paths give the same outlines: ``device="cuda"`` (the default) runs
``fce_find_contours``, host C++ of ``csrc/contours.cu`` built into the
card's kernel libraries; ``device="cpu"`` runs ``find_contours_reference``,
the plain version in Python (the scan over the rows and columns that hold
the mask's pixels, the walk along border pixels only; some ms a mask).
"""

from __future__ import annotations

import numpy as np

__all__ = ["find_contours_external", "find_contours_reference", "contour_area"]

# direction s -> (dx, dy): right, up-right, up, up-left, left, down-left, down, down-right
_CODE_DELTAS = ((1, 0), (1, -1), (0, -1), (-1, -1), (-1, 0), (-1, 1), (0, 1), (1, 1))
_RIGHT_BOUND, _BORDER = -126, 2  # OpenCV's labels: nbd | -128 and nbd, with nbd 2
_GROW = -13  # fce_find_contours: the caller's buffers are too small (the sizes come back)


def _trace(img: list[int], step: int, i0: int, x: int, y: int) -> list[tuple[int, int]]:
    """Follow the outer border that starts at flat index ``i0`` (pixel
    (x, y) of the mask), labelling it in ``img``; the CHAIN_APPROX_SIMPLE points."""
    deltas = (1, 1 - step, -step, -step - 1, -1, step - 1, step, step + 1) * 2
    s = s_end = 4
    while True:
        s = (s - 1) & 7
        i1 = i0 + deltas[s]
        if img[i1] != 0 or s == s_end:
            break
    if s == s_end:  # a lone pixel
        img[i0] = _RIGHT_BOUND
        return [(x, y)]
    pts = []
    i3, prev_s = i0, s ^ 4
    while True:
        s_end = s
        while s < 15:
            s += 1
            i4 = i3 + deltas[s]
            if img[i4] != 0:
                break
        s &= 7
        if 1 <= s <= s_end:  # the search passed the zero right neighbour
            img[i3] = _RIGHT_BOUND
        elif img[i3] == 1:
            img[i3] = _BORDER
        if s != prev_s:
            pts.append((x, y))
            prev_s = s
        x += _CODE_DELTAS[s][0]
        y += _CODE_DELTAS[s][1]
        if i4 == i0 and i3 == i1:
            return pts
        i3 = i4
        s = (s + 4) & 7


def find_contours_external(mask: np.ndarray, device="cuda") -> list[np.ndarray]:
    """The outer outlines of the nonzero pixels of a 2-D mask, each an
    (n, 1, 2) int32 array of (x, y) points, in cv2's order. ``device="cuda"``:
    the host C++ walk of the card's kernel libraries (``fce_find_contours``;
    raises where they cannot be built); ``"cpu"``: ``find_contours_reference``."""
    import torch

    m = np.asarray(mask)
    if m.ndim != 2:
        raise ValueError(f"find_contours_external takes a 2-D mask, not shape {m.shape}")
    device = torch.device(device)
    if device.type == "cpu":
        return find_contours_reference(m)
    if device.type != "cuda":
        raise ValueError(f"no contour walk for device {device}")
    from fce_yolo_tpu_torch.kernels import build as kbuild

    u8 = (m if m.dtype == bool else m != 0).view(np.uint8) if m.flags.c_contiguous else np.ascontiguousarray(m != 0).view(np.uint8)
    n = np.zeros(2, np.int64)
    pts, counts = np.empty((256, 2), np.int32), np.empty(16, np.int32)
    while (err := kbuild.library().fce_find_contours(u8.ctypes.data, u8.shape[0], u8.shape[1], u8.strides[0],
                                                     pts.ctypes.data, len(pts), counts.ctypes.data, len(counts),
                                                     n.ctypes.data)) == _GROW:
        pts, counts = np.empty((int(n[1]), 2), np.int32), np.empty(int(n[0]), np.int32)
    if err:
        raise RuntimeError(f"fce_find_contours: error {err}")
    if not n[0]:
        return []
    ends = np.cumsum(counts[: int(n[0])])
    return [c.reshape(-1, 1, 2) for c in np.split(pts[: int(n[1])].copy(), ends[:-1])]


def find_contours_reference(mask: np.ndarray) -> list[np.ndarray]:
    """The plain version of ``find_contours_external`` (Python)."""
    m = np.asarray(mask)
    if m.ndim != 2:
        raise ValueError(f"find_contours_reference takes a 2-D mask, not shape {m.shape}")
    nz = m != 0
    rows = np.flatnonzero(nz.any(1))
    if not len(rows):
        return []
    cols = np.flatnonzero(nz.any(0))
    r0, r1, c0, c1 = rows[0], rows[-1] + 1, cols[0], cols[-1] + 1
    crop = np.zeros((r1 - r0 + 2, c1 - c0 + 2), np.int8)  # the frame of zeros around the mask's box
    crop[1:-1, 1:-1] = nz[r0:r1, c0:c1]
    step = crop.shape[1]
    img = crop.ravel().tolist()
    busy = crop.any(1).tolist()
    out = []
    for y in range(1, crop.shape[0] - 1):
        if not busy[y]:
            continue
        base = y * step
        prev, lnbd = 0, base  # lnbd: the last labelled run of this row (its value decides)
        for x in range(1, step - 1):
            p = img[base + x]
            if p == prev:
                continue
            if prev == 0 and p == 1:  # an outer border starts here, unless inside a traced object
                if img[lnbd] <= 0:
                    pts = _trace(img, step, base + x, x - 1 + c0, y - 1 + r0)
                    out.append(np.array(pts, np.int32).reshape(-1, 1, 2))
                    prev = img[base + x]
                    continue
            elif p == 0 and prev >= 1 and prev != 1:  # a hole starts after a labelled pixel
                lnbd = base + x - 1
            prev = p
            if p not in (0, 1):
                lnbd = base + x
    return out[::-1]  # cv2 lists the outlines last found first


def contour_area(contour: np.ndarray) -> float:
    """``cv2.contourArea(contour)``: the shoelace area of an integer polygon, unsigned."""
    p = np.asarray(contour).reshape(-1, 2).astype(np.int64)
    if len(p) == 0:
        return 0.0
    q = np.roll(p, 1, 0)
    return abs(float((q[:, 0] * p[:, 1] - q[:, 1] * p[:, 0]).sum())) * 0.5
