"""The cv2 image operations of the solutions layer, without cv2 (the JAX
package's ``solutions/visuals.py``, ``heatmap.py`` and ``search.py`` call
them). Each is bit-equal to cv2 5.0 on the CPU:

- ``gaussian_blur``: ``cv2.GaussianBlur(img, (k, k), 0)`` on uint8, cv2's
  bit-exact fixed-point path: the kernel derived in double precision as
  ``getGaussianKernelBitExact`` does (the tabulated 3-, 5- and 7-tap kernels,
  else sigma = 0.15 k + 0.35), rounded to 8 fraction bits by error diffusion
  so that it sums to one, a horizontal then a vertical pass in integers and
  one rounding at the end; the border ``BORDER_REFLECT_101`` inside the image
  alone (reflected again where the image is narrower than the radius);
- ``apply_color_map``: ``cv2.applyColorMap`` of a gray uint8 image for the
  22 colormap ids, from ``fonts/cv2_colormaps.npz``
  (``fonts/make_cv2_colormaps.py``);
- ``normalize_minmax``: ``cv2.normalize(acc, None, 0, 255, cv2.NORM_MINMAX)``
  on float32 (the scale and shift rounded to float32, one fused
  multiply-add a value, as cv2's AVX2 ``convertTo`` takes it);
- ``calc_hist_hsv``: ``cv2.calcHist([hsv], [0, 1, 2], None, [8, 8, 8],
  [0, 180, 0, 256, 0, 256])`` of a uint8 HSV image (``data/augment.py::
  bgr_to_hsv`` makes it), float32 counts.
"""

from __future__ import annotations

import math
from fractions import Fraction
from functools import lru_cache
from pathlib import Path

import numpy as np

__all__ = ["gaussian_blur", "gaussian_kernel_fixed", "apply_color_map", "normalize_minmax", "calc_hist_hsv",
           "COLORMAP_NAMES"] + [f"COLORMAP_{n}" for n in (
               "AUTUMN", "BONE", "JET", "WINTER", "RAINBOW", "OCEAN", "SUMMER", "SPRING", "COOL", "HSV", "PINK",
               "HOT", "PARULA", "MAGMA", "INFERNO", "PLASMA", "VIRIDIS", "CIVIDIS", "TWILIGHT", "TWILIGHT_SHIFTED",
               "TURBO", "DEEPGREEN")]

COLORMAP_NAMES = ("AUTUMN", "BONE", "JET", "WINTER", "RAINBOW", "OCEAN", "SUMMER", "SPRING", "COOL", "HSV", "PINK",
                  "HOT", "PARULA", "MAGMA", "INFERNO", "PLASMA", "VIRIDIS", "CIVIDIS", "TWILIGHT", "TWILIGHT_SHIFTED",
                  "TURBO", "DEEPGREEN")  # cv2's ids 0-21, in order
(COLORMAP_AUTUMN, COLORMAP_BONE, COLORMAP_JET, COLORMAP_WINTER, COLORMAP_RAINBOW, COLORMAP_OCEAN, COLORMAP_SUMMER,
 COLORMAP_SPRING, COLORMAP_COOL, COLORMAP_HSV, COLORMAP_PINK, COLORMAP_HOT, COLORMAP_PARULA, COLORMAP_MAGMA,
 COLORMAP_INFERNO, COLORMAP_PLASMA, COLORMAP_VIRIDIS, COLORMAP_CIVIDIS, COLORMAP_TWILIGHT, COLORMAP_TWILIGHT_SHIFTED,
 COLORMAP_TURBO, COLORMAP_DEEPGREEN) = range(len(COLORMAP_NAMES))

_COLORMAPS = Path(__file__).with_name("fonts") / "cv2_colormaps.npz"
_FRACTION_BITS = 8  # ufixedpoint16: the kernel's taps in 8.8 fixed point

# getGaussianKernelBitExact's tables for sigma <= 0 (small_gaussian_tab)
_SMALL = {1: (1.0,), 3: (0.25, 0.5, 0.25), 5: (0.0625, 0.25, 0.375, 0.25, 0.0625),
          7: (0.03125, 0.109375, 0.21875, 0.28125, 0.21875, 0.109375, 0.03125)}


@lru_cache(None)
def gaussian_kernel_fixed(k: int) -> tuple[int, ...]:
    """The ``k`` taps (odd ``k``, sigma from ``k``) that cv2's 8-bit
    ``GaussianBlur`` filters with, in units of 1/256: the double-precision
    kernel of ``getGaussianKernelBitExact``, then
    ``getGaussianKernelFixedPoint_ED``'s rounding with the error carried
    from tap to tap and the centre tap taking what is left of 256."""
    if k < 1 or k % 2 == 0:
        raise ValueError(f"the Gaussian kernel size must be odd and positive, not {k}")
    if k in _SMALL:
        kern = list(_SMALL[k])
    else:
        # sigma = fma(k, 0.15, 0.35) in one rounding; every later step rounds as IEEE double does
        sigma = float(Fraction(k) * Fraction(0.15) + Fraction(0.35))
        scale2 = -0.125 / (sigma * sigma)
        half = (k - 1) // 2
        values, total = [], 0.0
        for i in range(half):
            x = i * 2 + 1 - k
            t = math.exp(float(x * x) * scale2)
            values.append(t)
            total += t
        total = total * 2.0 + 1.0
        mul = 1.0 / total
        kern = [v * mul for v in values] + [mul] + [v * mul for v in values[::-1]]
    one = 1 << _FRACTION_BITS
    half = k // 2
    out = [0] * k
    err, acc = 0.0, 0
    for i in range(half):
        adj = kern[i] * one + err
        v = int(np.rint(adj))  # cvRound: half to even
        err = adj - v
        out[i] = out[k - 1 - i] = v
        acc += v
    out[half] = one - 2 * acc
    return tuple(out)


def _reflect101(n: int, r: int) -> np.ndarray:
    """``borderInterpolate(p, n, BORDER_REFLECT_101)`` for p in [-r, n + r)."""
    p = np.arange(-r, n + r)
    if n == 1:
        return np.zeros_like(p)
    period = 2 * n - 2
    p = np.abs(p) % period
    return np.where(p >= n, period - p, p)


def gaussian_blur(img: np.ndarray, k: int) -> np.ndarray:
    """``cv2.GaussianBlur(img, (k, k), 0)`` of a uint8 (H, W) or (H, W, C)
    image, bit for bit (see the module's notes); a new array."""
    img = np.asarray(img)
    if img.dtype != np.uint8 or img.ndim not in (2, 3) or 0 in img.shape:
        raise ValueError(f"gaussian_blur takes a non-empty uint8 (H, W[, C]) image, not {img.dtype} {img.shape}")
    if k == 1:
        return img.copy()
    taps = np.asarray(gaussian_kernel_fixed(k), np.int64)
    r = k // 2
    h, w = img.shape[:2]
    src = img.astype(np.int64)
    cols = src[:, _reflect101(w, r)]
    row = np.zeros(src.shape, np.int64)  # the horizontal pass: 8 fraction bits, exact
    for j, c in enumerate(taps):
        row += c * cols[:, j: j + w]
    rows = row[_reflect101(h, r)]
    acc = np.zeros(src.shape, np.int64)  # the vertical pass: 16 fraction bits, exact
    for i, c in enumerate(taps):
        acc += c * rows[i: i + h]
    return ((acc + (1 << 15)) >> 16).astype(np.uint8)


@lru_cache(None)
def _luts() -> np.ndarray:
    with np.load(_COLORMAPS) as d:
        return np.stack([d[name] for name in COLORMAP_NAMES])  # (22, 256, 3) BGR


def apply_color_map(gray: np.ndarray, colormap: int) -> np.ndarray:
    """``cv2.applyColorMap(gray, colormap)`` of a uint8 (H, W) image: a BGR
    (H, W, 3) uint8 image."""
    gray = np.asarray(gray)
    if gray.dtype != np.uint8 or gray.ndim != 2:
        raise ValueError(f"apply_color_map takes a uint8 (H, W) image, not {gray.dtype} {gray.shape}")
    if not 0 <= int(colormap) < len(COLORMAP_NAMES):
        raise ValueError(f"unknown colormap id {colormap}: cv2's are 0-{len(COLORMAP_NAMES) - 1}")
    return _luts()[int(colormap)][gray]


def normalize_minmax(acc: np.ndarray) -> np.ndarray:
    """``cv2.normalize(acc, None, 0, 255, cv2.NORM_MINMAX)`` of a float32
    array: float32, the minimum at 0 and the maximum at 255 (all 0 where the
    array is flat)."""
    a = np.asarray(acc)
    if a.dtype != np.float32:
        raise ValueError(f"normalize_minmax takes float32, not {a.dtype}")
    smin, smax = float(a.min()), float(a.max())
    scale = 255.0 * (1.0 / (smax - smin) if smax - smin > np.finfo(np.float64).eps else 0.0)
    scale = float(np.float32(scale))
    shift = -float(np.float32(smin * scale))
    a32, b32 = np.float32(scale), np.float32(shift)
    # fma(x, a, b) in float32: the product is exact in float64, the sum rounds once more there
    return (a.astype(np.float64) * np.float64(a32) + np.float64(b32)).astype(np.float32)


_BINS = 8


def _hist_bins(high: float) -> np.ndarray:
    """``calcHistLookupTables_8u``: each byte's bin, floor(j * 8 / high) in double."""
    j = np.arange(256, dtype=np.float64)
    return np.clip(np.floor(j * (_BINS / float(high))), 0, _BINS - 1).astype(np.int64)


def calc_hist_hsv(hsv: np.ndarray) -> np.ndarray:
    """The joint 8 x 8 x 8 histogram of a uint8 HSV image over H in [0, 180),
    S and V in [0, 256): ``cv2.calcHist`` as float32."""
    hsv = np.asarray(hsv)
    if hsv.dtype != np.uint8 or hsv.ndim != 3 or hsv.shape[2] != 3:
        raise ValueError(f"calc_hist_hsv takes a uint8 (H, W, 3) image, not {hsv.dtype} {hsv.shape}")
    h, s, v = (hsv[..., i].reshape(-1) for i in range(3))
    hb, sb = _hist_bins(180.0), _hist_bins(256.0)
    ok = h < 180  # bytes outside the H range are not counted
    idx = (hb[h[ok]] * _BINS + sb[s[ok]]) * _BINS + sb[v[ok]]
    return np.bincount(idx, minlength=_BINS ** 3).astype(np.float32).reshape(_BINS, _BINS, _BINS)
