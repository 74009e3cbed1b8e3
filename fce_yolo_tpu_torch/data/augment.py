"""Letterbox, the val transform and the train augment (reference
``fce_yolo_tpu/data/augment.py``) with no cv2.

The cv2 calls of the reference are numpy functions here, each computing
what OpenCV 5 computes for uint8 BGR images:

- ``resize_linear`` (``cv2.resize`` INTER_LINEAR): float32 source
  positions, 11-bit fixed-point weights, the horizontal pass in integers and
  the vertical one as OpenCV's vector code does it (``(s >> 4) * b >> 16``,
  then ``+ 2 >> 2``);
- ``warp_affine`` / ``warp_perspective`` (``cv2.warpAffine`` /
  ``warpPerspective``, INTER_LINEAR, constant border 114): the inverse map in
  float32 with fused multiply-adds along a row, bilinear as three fused
  lerps, rounded to nearest; neighbours outside the image take the border;
- ``bgr_to_hsv`` / ``hsv_to_bgr`` (``cv2.cvtColor`` BGR<->HSV, H in
  [0, 180)): the integer-table forward conversion and the float32 backward
  one, which truncates.

Fused multiply-adds are computed in float64 and rounded to float32 (exact
products; the sum may round twice where OpenCV's rounds once). The tests
hold each function against cv2 pixel for pixel.

The train augment (``mosaic4``/``mosaic9`` -> ``random_perspective``, or a
letterbox then ``random_perspective``; then ``copy_paste``, ``mixup``,
``cutmix``, ``random_hsv``, ``random_flip``) draws from its
``np.random.Generator`` in the reference's order, so one generator state
gives the reference's geometry and labels. The reference's Albumentations
bridge is a no-op that draws nothing when the package is absent, and the
port has none. Two differences from the reference, on purpose:
``random_flip`` reorders keypoints by ``flip_idx`` after a left-right flip,
and ``mixup`` and ``cutmix`` keep polygons and keypoints.

Sample contract: {"img": (H, W, 3) uint8 BGR, "cls": (n,) float, "bboxes":
(n, 4) float pixel xyxy}, and for the task heads "segments" (n polygons
(k, 2), pixels; an OBB's four corners ride here) or "keypoints" (n arrays
(nk, 3): pixel x, y and the visibility), index-aligned with "cls".
"""

from __future__ import annotations

import math
from dataclasses import dataclass, replace

import numpy as np

__all__ = ["AugmentCfg", "resize_linear", "warp_affine", "warp_perspective", "bgr_to_hsv", "hsv_to_bgr",
           "get_rotation_matrix_2d", "letterbox", "box_candidates", "random_perspective", "mosaic4", "mosaic9",
           "random_hsv", "random_flip", "mixup", "cutmix", "copy_paste", "train_augment", "val_transform"]

_f32 = np.float32
BORDER = 114


@dataclass(frozen=True)
class AugmentCfg:
    """Hyperparameters, the reference's defaults (``augment.py:41-59``)."""

    hsv_h: float = 0.015
    hsv_s: float = 0.7
    hsv_v: float = 0.4
    degrees: float = 0.0
    translate: float = 0.1
    scale: float = 0.5
    shear: float = 0.0
    perspective: float = 0.0
    flipud: float = 0.0
    fliplr: float = 0.5
    mosaic: float = 1.0
    mosaic9: float = 0.0  # fraction of mosaic draws that use the 9-grid
    mixup: float = 0.0
    cutmix: float = 0.0
    copy_paste: float = 0.0


# ------------------------------------------------------------- cv2 in numpy
def _fma(a, b, c) -> np.ndarray:
    """float32 a * b + c with one rounding of an exact product (see the module docstring)."""
    return (np.asarray(a, np.float64) * np.asarray(b, np.float64) + np.asarray(c, np.float64)).astype(_f32)


def _linear_taps(src: int, dst: int, clamp: bool) -> tuple[np.ndarray, np.ndarray, np.ndarray]:
    """Per output position: the first source index and the two 11-bit weights."""
    fx = ((np.arange(dst) + 0.5) * (1.0 / (dst / src)) - 0.5).astype(_f32)
    sx = np.floor(fx).astype(np.int64)
    fx = fx - sx.astype(_f32)
    if clamp:  # columns: the edges take one source pixel
        low, high = sx < 0, sx >= src - 1
        fx = np.where(low | high, _f32(0), fx)
        sx = np.where(low, 0, np.where(high, src - 1, sx))
    c0 = np.rint((_f32(1) - fx) * _f32(2048)).astype(np.int64)
    c1 = np.rint(fx * _f32(2048)).astype(np.int64)
    return sx, c0, c1


def resize_linear(img: np.ndarray, size: tuple[int, int]) -> np.ndarray:
    """``cv2.resize(img, size, interpolation=cv2.INTER_LINEAR)`` for uint8
    (H, W, C); ``size`` is (width, height)."""
    w, h = size
    H, W, C = img.shape
    if (w, h) == (W, H):
        return img.copy()
    sx, a0, a1 = _linear_taps(W, w, clamp=True)
    sy, b0, b1 = _linear_taps(H, h, clamp=False)
    y0, y1 = np.clip(sy, 0, H - 1), np.clip(sy + 1, 0, H - 1)
    rows = np.union1d(y0, y1)  # only the source rows the output reads
    flat = img.reshape(H, W * C)[rows]
    ch = np.arange(C)
    i0 = (sx[:, None] * C + ch).ravel()
    i1 = (np.minimum(sx + 1, W - 1)[:, None] * C + ch).ravel()
    hor = flat[:, i0].astype(np.int32) * np.repeat(a0, C).astype(np.int32)
    hor += flat[:, i1].astype(np.int32) * np.repeat(a1, C).astype(np.int32)
    hor >>= 4
    pos = np.searchsorted(rows, np.stack([y0, y1]))
    out = (hor[pos[0]] * b0[:, None].astype(np.int32)) >> 16
    out += (hor[pos[1]] * b1[:, None].astype(np.int32)) >> 16
    out += 2
    out >>= 2
    return np.clip(out, 0, 255).astype(np.uint8).reshape(h, w, C)


def resize_linear_f32(img: np.ndarray, size: tuple[int, int]) -> np.ndarray:
    """``cv2.resize(img, size, interpolation=cv2.INTER_LINEAR)`` for a float32
    (H, W) image: float32 taps ``1 - f`` and ``f``, columns past an edge
    clamped, rows read at the clamped source row with their weights kept.
    ``size`` is (width, height)."""
    w, h = size
    src = np.asarray(img, _f32)
    H, W = src.shape
    if (w, h) == (W, H):
        return src.copy()

    def taps(n_src, n_dst, clamp):
        f = ((np.arange(n_dst) + 0.5) * (1.0 / (n_dst / n_src)) - 0.5).astype(_f32)
        s = np.floor(f).astype(np.int64)
        f = f - s.astype(_f32)
        if clamp:
            low, high = s < 0, s >= n_src - 1
            f = np.where(low | high, _f32(0), f)
            s = np.where(low, 0, np.where(high, n_src - 1, s))
        return s, _f32(1) - f, f

    sx, a0, a1 = taps(W, w, True)
    sy, b0, b1 = taps(H, h, False)
    hor = src[:, sx] * a0 + src[:, np.minimum(sx + 1, W - 1)] * a1
    return hor[np.clip(sy, 0, H - 1)] * b0[:, None] + hor[np.clip(sy + 1, 0, H - 1)] * b1[:, None]


def _sample_bilinear(img: np.ndarray, sx: np.ndarray, sy: np.ndarray, border: int) -> np.ndarray:
    """Bilinear samples of uint8 BGR ``img`` at float32 positions (OpenCV's
    lerp order: along x on both rows, then along y), rounded to nearest."""
    H, W = img.shape[:2]
    ix, iy = np.floor(sx), np.floor(sy)
    ax, ay = (sx - ix)[..., None], (sy - iy)[..., None]
    ix, iy = ix.astype(np.int64), iy.astype(np.int64)
    # pixels packed in 32 bits, the border pixel appended: one gather a tap
    packed = np.full((H * W + 1, 4), border, np.uint8)
    packed[:-1, :3] = img.reshape(-1, 3)
    packed = packed.view(np.uint32).ravel()

    def tap(dx: int, dy: int) -> np.ndarray:
        x, y = ix + dx, iy + dy
        idx = np.where((x >= 0) & (x < W) & (y >= 0) & (y < H), y * W + x, H * W)
        return np.take(packed, idx).view(np.uint8).reshape(*idx.shape, 4)[..., :3].astype(np.float64)

    p00, p01, p10, p11 = tap(0, 0), tap(1, 0), tap(0, 1), tap(1, 1)
    top = (ax * (p01 - p00) + p00).astype(_f32)
    bottom = (ax * (p11 - p10) + p10).astype(_f32)
    return np.clip(np.rint(_fma(ay, bottom - top, top)), 0, 255).astype(np.uint8)


def warp_affine(img: np.ndarray, M: np.ndarray, dsize: tuple[int, int], border: int = BORDER) -> np.ndarray:
    """``cv2.warpAffine(img, M, dsize, borderValue=(border,) * 3)`` for uint8
    BGR, INTER_LINEAR; ``M`` (2, 3) maps source to destination, ``dsize`` is
    (width, height)."""
    m = np.asarray(M, np.float64)
    det = m[0, 0] * m[1, 1] - m[0, 1] * m[1, 0]
    det = 1.0 / det if det else 0.0
    a11, a22, a12, a21 = m[1, 1] * det, m[0, 0] * det, -m[0, 1] * det, -m[1, 0] * det
    b1, b2 = -a11 * m[0, 2] - a12 * m[1, 2], -a21 * m[0, 2] - a22 * m[1, 2]
    inv = np.array([[a11, a12, b1], [a21, a22, b2]]).astype(_f32)
    w, h = dsize
    xs, ys = np.arange(w, dtype=_f32)[None, :], np.arange(h, dtype=_f32)[:, None]
    sx = _fma(xs, inv[0, 0], inv[0, 1] * ys + inv[0, 2])
    sy = _fma(xs, inv[1, 0], inv[1, 1] * ys + inv[1, 2])
    return _sample_bilinear(img, sx, sy, border)


def warp_perspective(img: np.ndarray, M: np.ndarray, dsize: tuple[int, int], border: int = BORDER) -> np.ndarray:
    """``cv2.warpPerspective(img, M, dsize, borderValue=(border,) * 3)`` for
    uint8 BGR, INTER_LINEAR; ``M`` (3, 3) maps source to destination."""
    inv = np.linalg.inv(np.asarray(M, np.float64)).astype(_f32)
    w, h = dsize
    xs, ys = np.arange(w, dtype=_f32)[None, :], np.arange(h, dtype=_f32)[:, None]
    num_x = _fma(xs, inv[0, 0], inv[0, 1] * ys + inv[0, 2])
    num_y = _fma(xs, inv[1, 0], inv[1, 1] * ys + inv[1, 2])
    den = _fma(xs, inv[2, 0], inv[2, 1] * ys + inv[2, 2])
    return _sample_bilinear(img, num_x / den, num_y / den, border)


_HSV_SHIFT = 12
_SDIV = np.zeros(256, np.int32)
_HDIV = np.zeros(256, np.int32)
_SDIV[1:] = np.rint((255 << _HSV_SHIFT) / np.arange(1, 256, dtype=np.float64))
_HDIV[1:] = np.rint((180 << _HSV_SHIFT) / (6.0 * np.arange(1, 256, dtype=np.float64)))
_SECTORS = np.array([[1, 3, 0], [1, 0, 2], [3, 0, 1], [0, 2, 1], [0, 1, 3], [2, 1, 0]])


def bgr_to_hsv(img: np.ndarray) -> np.ndarray:
    """``cv2.cvtColor(img, cv2.COLOR_BGR2HSV)`` for uint8: H in [0, 180)."""
    b, g, r = (img[..., i].astype(np.int32) for i in range(3))
    v = np.maximum(np.maximum(b, g), r)
    diff = v - np.minimum(np.minimum(b, g), r)
    rnd = 1 << (_HSV_SHIFT - 1)
    s = (diff * _SDIV[v] + rnd) >> _HSV_SHIFT
    h = np.where(v == r, g - b, np.where(v == g, b - r + 2 * diff, r - g + 4 * diff))
    h = (h * _HDIV[diff] + rnd) >> _HSV_SHIFT
    h = np.where(h < 0, h + 180, h)
    return np.stack([h, s, v], -1).astype(np.uint8)


def hsv_to_bgr(hsv: np.ndarray) -> np.ndarray:
    """``cv2.cvtColor(hsv, cv2.COLOR_HSV2BGR)`` for uint8 with H in [0, 180)."""
    h = hsv[..., 0].astype(_f32) * (_f32(6.0) / _f32(180))
    s = hsv[..., 1].astype(_f32) * _f32(1.0 / 255.0)
    v = hsv[..., 2].astype(_f32) * _f32(1.0 / 255.0)
    sector = np.trunc(h)
    f = h - sector
    one = _f32(1)
    tab = np.stack([v, v * (one - s), v * _fma(-s, f, one), v * _fma(-s, one - f, one)], -1)
    bgr = np.take_along_axis(tab, _SECTORS[sector.astype(np.int64) % 6], -1)
    return np.clip(np.trunc(bgr * _f32(255)), 0, 255).astype(np.uint8)


def get_rotation_matrix_2d(angle: float, center: tuple[float, float], scale: float) -> np.ndarray:
    """``cv2.getRotationMatrix2D``: (2, 3) float64."""
    a = angle * math.pi / 180
    alpha, beta = math.cos(a) * scale, math.sin(a) * scale
    cx, cy = center
    return np.array([[alpha, beta, (1 - alpha) * cx - beta * cy], [-beta, alpha, beta * cx + (1 - alpha) * cy]])


# ------------------------------------------------------------- letterbox, val
def letterbox(img: np.ndarray, new_shape: int | tuple[int, int] = 640,
              scaleup: bool = True) -> tuple[np.ndarray, float, tuple[int, int]]:
    """Aspect-preserving resize + centred pad (value 114) to ``new_shape``
    (reference ``augment.py:61-92``).

    Returns (padded uint8 image, scale ratio, (padw, padh)); boxes map as
    ``new = old * ratio + pad``.
    """
    if isinstance(new_shape, int):
        new_shape = (new_shape, new_shape)
    h0, w0 = img.shape[:2]
    r = min(new_shape[0] / h0, new_shape[1] / w0)
    if not scaleup:
        r = min(r, 1.0)
    new_w, new_h = round(w0 * r), round(h0 * r)
    dw, dh = (new_shape[1] - new_w) / 2, (new_shape[0] - new_h) / 2
    if (w0, h0) != (new_w, new_h):
        img = resize_linear(img, (new_w, new_h))
    top, bottom = round(dh - 0.1), round(dh + 0.1)
    left, right = round(dw - 0.1), round(dw + 0.1)
    out = np.full((new_h + top + bottom, new_w + left + right, img.shape[2]), BORDER, np.uint8)
    out[top: top + new_h, left: left + new_w] = img
    return out, r, (left, top)


def _apply_letterbox_boxes(bboxes: np.ndarray, r: float, pad: tuple[int, int]) -> np.ndarray:
    """Pixel xyxy boxes through the letterbox: ``box * r + pad``."""
    if bboxes.size == 0:
        return bboxes
    out = bboxes * r
    out[:, [0, 2]] += pad[0]
    out[:, [1, 3]] += pad[1]
    return out


def val_transform(sample: dict, imgsz: int) -> dict:
    """Val path: letterbox only (``scaleup=False``); records ratio, pad and
    the original shape for box scale-back. Pixel ``segments`` (polygons) and
    ``keypoints`` (x, y, visibility) go through the letterbox too."""
    img, r, pad = letterbox(sample["img"], imgsz, scaleup=False)
    out = {
        "img": img,
        "cls": sample["cls"],
        "bboxes": _apply_letterbox_boxes(sample["bboxes"].copy(), r, pad),
        "ratio": r,
        "pad": pad,
        "orig_shape": sample["img"].shape[:2],
    }
    if "segments" in sample:
        out["segments"] = [s * r + np.array(pad, np.float32) for s in sample["segments"]]
    if "keypoints" in sample:
        out["keypoints"] = [k * np.array([r, r, 1], np.float32) + np.array([*pad, 0], np.float32)
                            for k in sample["keypoints"]]
    return out


# ------------------------------------------------------------- train augment
def box_candidates(before: np.ndarray, after: np.ndarray, wh_thr: float = 2.0, ar_thr: float = 100.0,
                   area_thr: float = 0.1, eps: float = 1e-16) -> np.ndarray:
    """Boxes that survive a warp: wider and taller than ``wh_thr`` px, at
    least ``area_thr`` of their area left, aspect ratio below ``ar_thr``."""
    w1, h1 = before[:, 2] - before[:, 0], before[:, 3] - before[:, 1]
    w2, h2 = after[:, 2] - after[:, 0], after[:, 3] - after[:, 1]
    ar = np.maximum(w2 / (h2 + eps), h2 / (w2 + eps))
    return (w2 > wh_thr) & (h2 > wh_thr) & (w2 * h2 / (w1 * h1 + eps) > area_thr) & (ar < ar_thr)


def _with_labels(out: dict, segments: list | None, keypoints: list | None) -> dict:
    """``out`` with the ``segments`` and ``keypoints`` that are not None."""
    if segments is not None:
        out["segments"] = segments
    if keypoints is not None:
        out["keypoints"] = keypoints
    return out


def random_perspective(sample: dict, rng: np.random.Generator, cfg: AugmentCfg,
                       border: tuple[int, int] = (0, 0), pre_letterbox: int | None = None) -> dict:
    """Random perspective, rotation, scale, shear and translation of the image
    and its labels about the image centre (reference ``augment.py:120-204``):
    M = T @ S @ R @ P @ C, output size = input + 2 * border, fill 114.
    Polygons are warped and clipped to the canvas; keypoints are warped and
    lose their visibility off the canvas; both follow the boxes' filter."""
    img, cls, bboxes = sample["img"], sample["cls"], sample["bboxes"]
    segments, keypoints = sample.get("segments"), sample.get("keypoints")
    if pre_letterbox is not None:
        img, r, pad = letterbox(img, pre_letterbox)
        bboxes = _apply_letterbox_boxes(bboxes, r, pad)
        if segments is not None:
            segments = [s * r + np.array(pad, _f32) for s in segments]
        if keypoints is not None:
            keypoints = [k * np.array([r, r, 1], _f32) + np.array([*pad, 0], _f32) for k in keypoints]
    h, w = img.shape[:2]
    out_w, out_h = w + border[0] * 2, h + border[1] * 2

    C = np.eye(3, dtype=_f32)
    C[0, 2], C[1, 2] = -w / 2, -h / 2
    P = np.eye(3, dtype=_f32)
    P[2, 0] = rng.uniform(-cfg.perspective, cfg.perspective)
    P[2, 1] = rng.uniform(-cfg.perspective, cfg.perspective)
    R = np.eye(3, dtype=_f32)
    a = rng.uniform(-cfg.degrees, cfg.degrees)
    s = rng.uniform(1 - cfg.scale, 1 + cfg.scale)
    R[:2] = get_rotation_matrix_2d(angle=a, center=(0, 0), scale=s)
    S = np.eye(3, dtype=_f32)
    S[0, 1] = math.tan(rng.uniform(-cfg.shear, cfg.shear) * math.pi / 180)
    S[1, 0] = math.tan(rng.uniform(-cfg.shear, cfg.shear) * math.pi / 180)
    T = np.eye(3, dtype=_f32)
    T[0, 2] = rng.uniform(0.5 - cfg.translate, 0.5 + cfg.translate) * out_w
    T[1, 2] = rng.uniform(0.5 - cfg.translate, 0.5 + cfg.translate) * out_h
    M = T @ S @ R @ P @ C

    if cfg.perspective:
        img = warp_perspective(img, M, (out_w, out_h))
    else:
        img = warp_affine(img, M[:2], (out_w, out_h))

    def warp(pts: np.ndarray) -> np.ndarray:
        p = np.concatenate([pts, np.ones((len(pts), 1), _f32)], 1) @ M.T
        return p[:, :2] / p[:, 2:3] if cfg.perspective else p[:, :2]

    if len(bboxes):
        n = len(bboxes)
        pts = np.ones((n * 4, 3), _f32)
        pts[:, :2] = bboxes[:, [0, 1, 2, 3, 0, 3, 2, 1]].reshape(n * 4, 2)
        pts = pts @ M.T
        xy = (pts[:, :2] / pts[:, 2:3] if cfg.perspective else pts[:, :2]).reshape(n, 8)
        x, y = xy[:, 0::2], xy[:, 1::2]
        new = np.stack([x.min(1), y.min(1), x.max(1), y.max(1)], 1)
        new[:, [0, 2]] = new[:, [0, 2]].clip(0, out_w)
        new[:, [1, 3]] = new[:, [1, 3]].clip(0, out_h)
        keep = box_candidates(bboxes * s, new, area_thr=0.1)
        bboxes, cls = new[keep], cls[keep]
        kept = np.nonzero(keep)[0]
        if segments is not None:
            warped = []
            for seg in segments:
                q = warp(seg)
                q[:, 0] = q[:, 0].clip(0, out_w)
                q[:, 1] = q[:, 1].clip(0, out_h)
                warped.append(q.astype(_f32))
            segments = [warped[i] for i in kept]
        if keypoints is not None:
            warped_k = []
            for kp in keypoints:
                q = warp(kp[:, :2])
                vis = kp[:, 2].copy()
                vis[(q[:, 0] < 0) | (q[:, 0] > out_w) | (q[:, 1] < 0) | (q[:, 1] > out_h)] = 0.0
                warped_k.append(np.concatenate([q, vis[:, None]], 1).astype(_f32))
            keypoints = [warped_k[i] for i in kept]
    return _with_labels({"img": img, "cls": cls, "bboxes": bboxes}, segments, keypoints)


def _prescale(img: np.ndarray, s: int) -> tuple[np.ndarray, float]:
    """Resize so the long side is ``s`` (the reference's load_image)."""
    h0, w0 = img.shape[:2]
    r = s / max(h0, w0)
    if r != 1:
        img = resize_linear(img, (min(round(w0 * r), s), min(round(h0 * r), s)))
    return img, r


def _box_polygons(bboxes: np.ndarray) -> list[np.ndarray]:
    """Pixel xyxy boxes as 4-point polygons (a sample without polygons in a polygon batch)."""
    return [np.array([[b[0], b[1]], [b[2], b[1]], [b[2], b[3]], [b[0], b[3]]], _f32) for b in bboxes]


class _Tiles:
    """The labels of a mosaic's tiles, shifted as they are placed."""

    def __init__(self, samples: list[dict]):
        self.cls, self.boxes = [], []
        self.segs = [] if any("segments" in x for x in samples) else None
        self.kpts = [] if any("keypoints" in x for x in samples) else None

    def add(self, sample: dict, r: float, offx, offy) -> None:
        if not len(sample["bboxes"]):
            return
        b = sample["bboxes"] * r
        b[:, [0, 2]] += offx
        b[:, [1, 3]] += offy
        self.boxes.append(b)
        self.cls.append(sample["cls"])
        if self.segs is not None:
            off = np.array([offx, offy], _f32)
            segs = sample.get("segments") or _box_polygons(sample["bboxes"])
            self.segs.extend([sg * r + off for sg in segs])
        if self.kpts is not None:
            offk = np.array([offx, offy, 0], _f32)
            self.kpts.extend(kp * np.array([r, r, 1], _f32) + offk for kp in sample.get("keypoints", []))

    def sample(self, img: np.ndarray, limit: int) -> dict:
        """The canvas with its labels clipped to [0, limit], empty boxes dropped."""
        if not self.boxes:
            return _with_labels({"img": img, "cls": np.zeros((0,), np.float32), "bboxes": np.zeros((0, 4), np.float32)},
                                None if self.segs is None else [], None if self.kpts is None else [])
        boxes = np.concatenate(self.boxes, 0).clip(0, limit)
        cls = np.concatenate(self.cls, 0)
        ok = (boxes[:, 2] > boxes[:, 0]) & (boxes[:, 3] > boxes[:, 1])
        segs = None if self.segs is None else [np.clip(sg, 0, limit) for sg, k in zip(self.segs, ok) if k]
        kpts = None if self.kpts is None else [kp for kp, k in zip(self.kpts, ok) if k]
        return _with_labels({"img": img, "cls": cls[ok], "bboxes": boxes[ok]}, segs, kpts)


def mosaic4(samples: list[dict], imgsz: int, rng: np.random.Generator) -> dict:
    """Four samples on a (2 * imgsz)^2 canvas around a random centre in
    [imgsz/2, 3 * imgsz/2), fill 114 (reference ``augment.py:207-279``). A
    sample without polygons in a polygon batch gives its boxes as 4-point
    polygons. The caller follows with ``random_perspective(border=(-imgsz // 2,) * 2)``."""
    s = imgsz
    yc = int(rng.uniform(s // 2, 2 * s - s // 2))
    xc = int(rng.uniform(s // 2, 2 * s - s // 2))
    canvas = np.full((2 * s, 2 * s, 3), BORDER, np.uint8)
    tiles = _Tiles(samples[:4])
    for i, sample in enumerate(samples[:4]):
        img, r = _prescale(sample["img"], s)
        h, w = img.shape[:2]
        if i == 0:  # top-left
            x1a, y1a, x2a, y2a = max(xc - w, 0), max(yc - h, 0), xc, yc
            x1b, y1b, x2b, y2b = w - (x2a - x1a), h - (y2a - y1a), w, h
        elif i == 1:  # top-right
            x1a, y1a, x2a, y2a = xc, max(yc - h, 0), min(xc + w, 2 * s), yc
            x1b, y1b, x2b, y2b = 0, h - (y2a - y1a), min(w, x2a - x1a), h
        elif i == 2:  # bottom-left
            x1a, y1a, x2a, y2a = max(xc - w, 0), yc, xc, min(2 * s, yc + h)
            x1b, y1b, x2b, y2b = w - (x2a - x1a), 0, w, min(y2a - y1a, h)
        else:  # bottom-right
            x1a, y1a, x2a, y2a = xc, yc, min(xc + w, 2 * s), min(2 * s, yc + h)
            x1b, y1b, x2b, y2b = 0, 0, min(w, x2a - x1a), min(y2a - y1a, h)
        canvas[y1a:y2a, x1a:x2a] = img[y1b:y2b, x1b:x2b]
        tiles.add(sample, r, x1a - x1b, y1a - y1b)
    return tiles.sample(canvas, 2 * s)


def mosaic9(samples: list[dict], imgsz: int, rng: np.random.Generator) -> dict:
    """Nine samples in a 3x3 ring around a centre tile, cropped to a
    (2 * imgsz)^2 canvas (reference ``augment.py:412-494``); followed by the
    same ``random_perspective`` as ``mosaic4``. Draws nothing itself."""
    s = imgsz
    canvas = np.full((3 * s, 3 * s, 3), BORDER, np.uint8)
    tiles = _Tiles(samples[:9])
    hp = wp = h0 = w0 = 0
    for i, sample in enumerate(samples[:9]):
        img, r = _prescale(sample["img"], s)
        h, w = img.shape[:2]
        if i == 0:  # center
            h0, w0 = h, w
            c = s, s, s + w, s + h
        elif i == 1:  # top
            c = s, s - h, s + w, s
        elif i == 2:  # top right
            c = s + wp, s - h, s + wp + w, s
        elif i == 3:  # right
            c = s + w0, s, s + w0 + w, s + h
        elif i == 4:  # bottom right
            c = s + w0, s + hp, s + w0 + w, s + hp + h
        elif i == 5:  # bottom
            c = s + w0 - w, s + h0, s + w0, s + h0 + h
        elif i == 6:  # bottom left
            c = s + w0 - wp - w, s + h0, s + w0 - wp, s + h0 + h
        elif i == 7:  # left
            c = s - w, s + h0 - h, s, s + h0
        else:  # top left
            c = s - w, s + h0 - hp - h, s, s + h0 - hp
        padw, padh = c[:2]
        x1, y1, x2, y2 = (max(v, 0) for v in c)
        x2, y2 = min(x2, 3 * s), min(y2, 3 * s)
        canvas[y1:y2, x1:x2] = img[y1 - padh: y2 - padh, x1 - padw: x2 - padw]
        hp, wp = h, w
        tiles.add(sample, r, padw - s // 2, padh - s // 2)  # the tile origin minus the s // 2 crop
    return tiles.sample(canvas[s // 2: s // 2 + 2 * s, s // 2: s // 2 + 2 * s], 2 * s)


def random_hsv(img: np.ndarray, rng: np.random.Generator, cfg: AugmentCfg) -> np.ndarray:
    """Random hue, saturation and value gains through lookup tables
    (reference ``augment.py:282-293``); no draw when all gains are 0."""
    if not (cfg.hsv_h or cfg.hsv_s or cfg.hsv_v):
        return img
    r = rng.uniform(-1, 1, 3) * [cfg.hsv_h, cfg.hsv_s, cfg.hsv_v] + 1
    x = np.arange(256, dtype=r.dtype)
    luts = [((x * r[0]) % 180).astype(img.dtype), np.clip(x * r[1], 0, 255).astype(img.dtype),
            np.clip(x * r[2], 0, 255).astype(img.dtype)]
    hsv = bgr_to_hsv(img)
    return hsv_to_bgr(np.stack([lut[hsv[..., i]] for i, lut in enumerate(luts)], -1))


def random_flip(sample: dict, rng: np.random.Generator, cfg: AugmentCfg, flip_idx=None) -> dict:
    """Vertical then horizontal flip with their probabilities; a zero
    probability draws nothing (reference ``augment.py:296-325``). Polygons
    and keypoints flip with the image; after a left-right flip each
    keypoint array is reordered by ``flip_idx`` (left and right swap), as
    the Ultralytics ``RandomFlip`` does. The JAX package never reorders
    (``augment.py:318-319``), so its pose samples keep a left shoulder's
    label on the right one (ROADMAP queue 3)."""
    img, bboxes = sample["img"], sample["bboxes"]
    segments, keypoints = sample.get("segments"), sample.get("keypoints")
    h, w = img.shape[:2]
    if cfg.flipud and rng.random() < cfg.flipud:
        img = np.flipud(img)
        if len(bboxes):
            bboxes = bboxes.copy()
            bboxes[:, [1, 3]] = h - bboxes[:, [3, 1]]
        if segments is not None:
            segments = [np.stack([s[:, 0], h - s[:, 1]], 1) for s in segments]
        if keypoints is not None:
            keypoints = [np.stack([k[:, 0], h - k[:, 1], k[:, 2]], 1) for k in keypoints]
    if cfg.fliplr and rng.random() < cfg.fliplr:
        img = np.fliplr(img)
        if len(bboxes):
            bboxes = bboxes.copy()
            bboxes[:, [0, 2]] = w - bboxes[:, [2, 0]]
        if segments is not None:
            segments = [np.stack([w - s[:, 0], s[:, 1]], 1) for s in segments]
        if keypoints is not None:
            keypoints = [np.stack([w - k[:, 0], k[:, 1], k[:, 2]], 1) for k in keypoints]
            if flip_idx is not None:
                keypoints = [k[np.asarray(flip_idx)] for k in keypoints]
    return _with_labels({"img": np.ascontiguousarray(img), "cls": sample["cls"], "bboxes": bboxes}, segments,
                        keypoints)


def _joined(parts: list[tuple[dict, np.ndarray | None]], key: str) -> list | None:
    """The ``key`` labels ("segments" or "keypoints") of samples put
    together, each taking the rows ``keep`` (None: all), or None when no
    sample has any. A sample without polygons gives its boxes as polygons,
    as in ``mosaic4``; a pose sample without keypoints has no labels."""
    if not any(key in s for s, _ in parts):
        return None
    out = []
    for s, keep in parts:
        rows = s[key] if key in s else _box_polygons(s["bboxes"]) if key == "segments" else []
        out += [rows[i] for i in (range(len(rows)) if keep is None else np.flatnonzero(keep))]
    return out


def mixup(a: dict, b: dict, rng: np.random.Generator) -> dict:
    """Beta(32, 32) blend of two images, their labels together (reference
    ``augment.py:328-336``), polygons and keypoints too: the JAX package
    returns boxes only, so its masks and keypoints of such a sample are
    empty (ROADMAP queue 3)."""
    lam = rng.beta(32.0, 32.0)
    img = (a["img"].astype(np.float32) * lam + b["img"].astype(np.float32) * (1 - lam)).astype(np.uint8)
    out = {"img": img, "cls": np.concatenate([a["cls"], b["cls"]], 0),
           "bboxes": np.concatenate([a["bboxes"], b["bboxes"]], 0)}
    parts = [(a, None), (b, None)]
    return _with_labels(out, _joined(parts, "segments"), _joined(parts, "keypoints"))


def cutmix(a: dict, b: dict, rng: np.random.Generator, beta: float = 1.0) -> dict:
    """Paste a random rectangle of b into a, with b's labels whose centres
    fall inside it (reference ``augment.py:339-370``); their polygons and
    keypoints come along, scaled as their boxes (the JAX package drops
    them, ROADMAP queue 3)."""
    h, w = a["img"].shape[:2]
    lam = rng.beta(beta, beta)
    cut = math.sqrt(1 - lam)
    cw, ch = int(w * cut), int(h * cut)
    cx, cy = rng.integers(0, max(w - cw, 1)), rng.integers(0, max(h - ch, 1))
    img = a["img"].copy()
    bh, bw = b["img"].shape[:2]
    patch = resize_linear(b["img"], (w, h)) if (bh, bw) != (h, w) else b["img"]
    img[cy: cy + ch, cx: cx + cw] = patch[cy: cy + ch, cx: cx + cw]
    sx, sy = w / bw, h / bh
    bb = b["bboxes"] * np.array([sx, sy, sx, sy]) if len(b["bboxes"]) else b["bboxes"]
    inside = np.zeros(len(bb), bool)
    if len(bb):
        cx_c = (bb[:, 0] + bb[:, 2]) / 2
        cy_c = (bb[:, 1] + bb[:, 3]) / 2
        inside = (cx_c >= cx) & (cx_c < cx + cw) & (cy_c >= cy) & (cy_c < cy + ch)
        bb, bcls = bb[inside], b["cls"][inside]
    else:
        bcls = b["cls"]
    out = {"img": img, "cls": np.concatenate([a["cls"], bcls], 0),
           "bboxes": np.concatenate([a["bboxes"], bb], 0) if len(bb) else a["bboxes"]}
    scaled = dict(b)
    if "segments" in b:
        scaled["segments"] = [sg * np.array([sx, sy], _f32) for sg in b["segments"]]
    if "keypoints" in b:
        scaled["keypoints"] = [kp * np.array([sx, sy, 1], _f32) for kp in b["keypoints"]]
    parts = [(a, None), (scaled, inside)]
    return _with_labels(out, _joined(parts, "segments"), _joined(parts, "keypoints"))


def copy_paste(a: dict, b: dict, rng: np.random.Generator, p: float = 0.5) -> dict:
    """Paste each polygon instance of b into a with probability ``p``: the
    pixels inside the polygon (``fill_poly`` of its rounded vertices, as
    ``cv2.fillPoly``), when they are 16 or more, with its class, its extent
    as the box and the polygon (reference ``augment.py:368-409``, the
    cross-image form). No-op, drawing nothing, when b has no polygons or no
    labels. Like the reference, the result carries no keypoints."""
    from fce_yolo_tpu_torch.ops.geometry import fill_poly

    if "segments" not in b or not len(b.get("cls", [])):
        return a
    h, w = a["img"].shape[:2]
    bh, bw = b["img"].shape[:2]
    img = a["img"].copy()
    new_cls, new_boxes = list(a["cls"]), list(a["bboxes"])
    new_segs = list(a["segments"]) if "segments" in a else None
    sx, sy = w / bw, h / bh
    for cls_v, seg in zip(b["cls"], b["segments"]):
        if rng.random() > p:
            continue
        pts = (seg * np.array([sx, sy], _f32)).astype(_f32)
        mask = fill_poly(np.zeros((h, w), np.uint8), [np.round(pts).astype(np.int32)], 1)
        if mask.sum() < 16:
            continue
        donor = resize_linear(b["img"], (w, h)) if (bh, bw) != (h, w) else b["img"]
        img[mask > 0] = donor[mask > 0]
        lo, hi = pts.min(0), pts.max(0)
        new_cls.append(float(cls_v))
        new_boxes.append(np.array([lo[0], lo[1], hi[0], hi[1]], _f32))
        if new_segs is not None:
            new_segs.append(pts)
    out = {"img": img, "cls": np.asarray(new_cls, np.float32),
           "bboxes": np.asarray(new_boxes, np.float32).reshape(-1, 4)}
    return _with_labels(out, new_segs, None)


def train_augment(get_sample, index: int, n_total: int, imgsz: int, cfg: AugmentCfg, rng: np.random.Generator,
                  mosaic_enabled: bool = True, flip_idx=None) -> dict:
    """The train pipeline for one output sample (reference ``augment.py:547-588``).

    ``get_sample(i)`` returns a fresh sample of image i (pixel xyxy boxes,
    and pixel polygons or keypoints). ``copy_paste``, ``mixup`` and
    ``cutmix`` each take a donor sample made by this pipeline without them;
    ``flip_idx`` goes to ``random_flip``.
    """
    use_mosaic = mosaic_enabled and cfg.mosaic > 0 and rng.random() < cfg.mosaic
    if use_mosaic:
        nine = cfg.mosaic9 > 0 and rng.random() < cfg.mosaic9
        idxs = [index] + [int(rng.integers(0, n_total)) for _ in range(8 if nine else 3)]
        sample = (mosaic9 if nine else mosaic4)([get_sample(i) for i in idxs], imgsz, rng)
        sample = random_perspective(sample, rng, cfg, border=(-imgsz // 2, -imgsz // 2))
    else:
        sample = random_perspective(get_sample(index), rng, cfg, pre_letterbox=imgsz)
    no_mix = replace(cfg, mixup=0.0, cutmix=0.0, copy_paste=0.0)

    def donor() -> dict:
        return train_augment(get_sample, int(rng.integers(0, n_total)), n_total, imgsz, no_mix, rng, mosaic_enabled,
                             flip_idx)

    if cfg.copy_paste > 0 and rng.random() < cfg.copy_paste:
        sample = copy_paste(sample, donor(), rng, p=0.5)
    if cfg.mixup > 0 and rng.random() < cfg.mixup:
        sample = mixup(sample, donor(), rng)
    if cfg.cutmix > 0 and rng.random() < cfg.cutmix:
        sample = cutmix(sample, donor(), rng)
    sample["img"] = random_hsv(sample["img"], rng, cfg)
    return random_flip(sample, rng, cfg, flip_idx)
