"""The cv2 image operations of the solutions layer without cv2
(``fce_yolo_tpu_torch/utils/imgproc.py``) against cv2 5.0, bit for bit, on
seeded images:

- ``gaussian_blur`` = ``cv2.GaussianBlur(img, (k, k), 0)``: k 3, 25 and 49
  on crops from 1 x 1 to 300 x 400 (crops narrower than the radius reflect
  more than once), views of a larger frame as ``ObjectBlurrer`` passes them,
  gray images, and every odd k up to 99 on a small image;
- ``apply_color_map`` = ``cv2.applyColorMap``: all 22 colormaps on all 256
  levels and on a random image; the committed table re-derived from cv2;
- ``normalize_minmax`` = ``cv2.normalize(acc, None, 0, 255, NORM_MINMAX)``
  on flat, spiky and heatmap-like float32 accumulators, then ``astype(uint8)``;
- ``calc_hist_hsv`` = ``cv2.calcHist([hsv], [0, 1, 2], None, [8, 8, 8],
  [0, 180, 0, 256, 0, 256])``, on HSV images and on raw bytes (H >= 180
  not counted).
"""

import cv2
import numpy as np
import pytest

from fce_yolo_tpu_torch.data.augment import bgr_to_hsv
from fce_yolo_tpu_torch.utils import imgproc as P

CROPS = [(1, 1), (1, 9), (7, 1), (2, 3), (5, 30), (13, 11), (24, 25), (31, 17), (77, 120), (300, 400)]


@pytest.mark.parametrize("k", [3, 25, 49])
def test_gaussian_blur_equals_cv2(k):
    rng = np.random.RandomState(k)
    for h, w in CROPS:
        img = rng.randint(0, 256, (h, w, 3), np.uint8)
        np.testing.assert_array_equal(P.gaussian_blur(img, k), cv2.GaussianBlur(img, (k, k), 0), err_msg=f"{h}x{w}")
    frame = rng.randint(0, 256, (120, 160, 3), np.uint8)
    for y1, y2, x1, x2 in [(10, 40, 20, 90), (0, 120, 150, 160), (60, 61, 0, 160)]:
        crop = frame[y1:y2, x1:x2]  # a view: cv2 sees no parent ROI, the border stays inside the crop
        np.testing.assert_array_equal(P.gaussian_blur(crop, k), cv2.GaussianBlur(crop, (k, k), 0))
    gray = rng.randint(0, 256, (37, 53), np.uint8)
    np.testing.assert_array_equal(P.gaussian_blur(gray, k), cv2.GaussianBlur(gray, (k, k), 0))


def test_gaussian_blur_every_odd_size_equals_cv2():
    rng = np.random.RandomState(1)
    img = rng.randint(0, 256, (19, 23, 3), np.uint8)
    for k in range(1, 100, 2):
        taps = P.gaussian_kernel_fixed(k)
        assert sum(taps) == 256 and taps == taps[::-1]
        np.testing.assert_array_equal(P.gaussian_blur(img, k), cv2.GaussianBlur(img, (k, k), 0), err_msg=f"k={k}")
    with pytest.raises(ValueError, match="odd"):
        P.gaussian_blur(img, 4)


def test_apply_color_map_equals_cv2():
    levels = np.arange(256, dtype=np.uint8).reshape(16, 16)
    img = np.random.RandomState(2).randint(0, 256, (45, 67), np.uint8)
    assert len(P.COLORMAP_NAMES) == 22 and P.COLORMAP_JET == cv2.COLORMAP_JET == 2
    for i, name in enumerate(P.COLORMAP_NAMES):
        assert getattr(P, f"COLORMAP_{name}") == getattr(cv2, f"COLORMAP_{name}") == i
        np.testing.assert_array_equal(P.apply_color_map(levels, i), cv2.applyColorMap(levels, i), err_msg=name)
        np.testing.assert_array_equal(P.apply_color_map(img, i), cv2.applyColorMap(img, i), err_msg=name)
    with pytest.raises(ValueError, match="colormap id"):
        P.apply_color_map(levels, 22)


def test_colormap_table_rederived_from_cv2():
    """``fonts/cv2_colormaps.npz`` is what ``fonts/make_cv2_colormaps.py`` writes from this cv2."""
    levels = np.arange(256, dtype=np.uint8)[:, None]
    with np.load(P._COLORMAPS) as d:
        assert sorted(d.files) == sorted(P.COLORMAP_NAMES)
        for i, name in enumerate(P.COLORMAP_NAMES):
            np.testing.assert_array_equal(d[name], cv2.applyColorMap(levels, i)[:, 0])


def _accumulators():
    rng = np.random.RandomState(3)
    spiky = np.zeros((90, 120), np.float32)
    spiky[rng.randint(0, 90, 40), rng.randint(0, 120, 40)] = rng.randint(1, 3000, 40) * 2.0
    heat = np.zeros((120, 160), np.float32)
    for _ in range(25):  # Heatmap's +2 inside inscribed circles
        cy, cx, r = rng.randint(0, 120), rng.randint(0, 160), rng.randint(2, 30)
        yy, xx = np.mgrid[:120, :160]
        heat[(yy - cy) ** 2 + (xx - cx) ** 2 <= r * r] += 2.0
    return {"flat_zero": np.zeros((20, 30), np.float32), "flat": np.full((20, 30), 6.0, np.float32),
            "spiky": spiky, "heat": heat, "offset": heat + 7.0,
            "noise": (rng.rand(64, 48) * 1e3).astype(np.float32),
            "narrow": (rng.rand(40, 30) * 1e-3 + 7).astype(np.float32)}


@pytest.mark.parametrize("name", ["flat_zero", "flat", "spiky", "heat", "offset", "noise", "narrow"])
def test_normalize_minmax_equals_cv2(name):
    acc = _accumulators()[name]
    ref = cv2.normalize(acc, None, 0, 255, cv2.NORM_MINMAX)
    out = P.normalize_minmax(acc)
    assert out.dtype == ref.dtype == np.float32
    np.testing.assert_array_equal(out, ref)
    np.testing.assert_array_equal(out.astype(np.uint8), ref.astype(np.uint8))


def test_calc_hist_hsv_equals_cv2():
    rng = np.random.RandomState(4)
    for h, w in [(1, 1), (2, 5), (37, 53), (240, 320)]:
        img = rng.randint(0, 256, (h, w, 3), np.uint8)
        hsv = bgr_to_hsv(img)
        np.testing.assert_array_equal(hsv, cv2.cvtColor(img, cv2.COLOR_BGR2HSV))
        for arr in (hsv, img, hsv[h // 2:, : w // 2 + 1]):  # raw bytes: H >= 180 falls outside the range
            ref = cv2.calcHist([arr], [0, 1, 2], None, [8, 8, 8], [0, 180, 0, 256, 0, 256])
            out = P.calc_hist_hsv(arr)
            assert out.dtype == ref.dtype == np.float32 and out.shape == ref.shape == (8, 8, 8)
            np.testing.assert_array_equal(out, ref)
    edges = np.array([[[h, 0, 255] for h in range(180)]], np.uint8)  # every H bin edge
    np.testing.assert_array_equal(P.calc_hist_hsv(edges),
                                  cv2.calcHist([edges], [0, 1, 2], None, [8, 8, 8], [0, 180, 0, 256, 0, 256]))
