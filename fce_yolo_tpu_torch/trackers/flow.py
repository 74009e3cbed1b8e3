"""The cv2 calls of BoT-SORT's camera-motion compensation (reference
``fce_yolo_tpu/trackers/bot_sort.py:30-58``), in numpy.

Each function follows OpenCV's own algorithm step by step (``color_rgb``,
``resize``, ``featureselect.cpp``, ``lkpyramid.cpp``, ``ptsetreg.cpp``,
``levmarq.cpp``) so that it gives OpenCV's answer on uint8 frames:

- ``bgr_to_gray`` (``cv2.cvtColor(img, cv2.COLOR_BGR2GRAY)``) is
  bit-equal (the /2 downscale is ``data/augment.py::resize_linear``, which
  is bit-equal to ``cv2.resize`` on one channel too);
- ``good_features_to_track`` computes ``cornerMinEigenVal`` as OpenCV's
  AVX2 code does on x86 (fused multiply-adds in the Sobel passes, the box
  sums exact), so the corners come out in OpenCV's order;
- ``calc_optical_flow_pyr_lk`` has OpenCV's pyramid, Scharr derivatives and
  14-bit bilinear weights in integers; the window sums are exact before
  they are rounded to float32 (OpenCV adds them up in float32 lanes), so a
  point may differ from OpenCV's by a float32 rounding, or by one Newton
  step where the stop test falls on the other side;
- ``estimate_affine_partial_2d`` draws its RANSAC pairs from an explicit
  ``numpy.random.Generator`` (OpenCV draws from its own ``cv::RNG``), then
  refines on the inliers with OpenCV's Levenberg-Marquardt.

Each takes the arguments the reference's GMC passes (module constants
here) and cv2's defaults for the rest. ``tests/test_torch_flow.py`` holds
each against cv2. Points are (N, 1, 2) float32 arrays, as cv2 gives them.
"""

from __future__ import annotations

import math

import numpy as np

from fce_yolo_tpu_torch.data.augment import _fma

__all__ = ["bgr_to_gray", "corner_min_eigen_val", "good_features_to_track", "pyr_down", "calc_optical_flow_pyr_lk",
           "estimate_affine_partial_2d"]

_f32 = np.float32
FLT_EPSILON = float(np.finfo(np.float32).eps)
DBL_EPSILON = float(np.finfo(np.float64).eps)
# goodFeaturesToTrack as the reference's GMC calls it
MAX_CORNERS, QUALITY_LEVEL, MIN_DISTANCE, BLOCK_SIZE = 200, 0.01, 7, 7
# calcOpticalFlowPyrLK's defaults: window, pyramid levels, iterations, step to stop at, smallest eigenvalue
LK_WIN, LK_LEVELS, LK_ITERS, LK_EPS, LK_MIN_EIG = 21, 3, 30, 0.01, 1e-4
# estimateAffinePartial2D's defaults: RANSAC threshold (px), iterations, confidence; refinement iterations
RANSAC_THRESH, RANSAC_ITERS, RANSAC_CONFIDENCE, REFINE_ITERS = 3.0, 2000, 0.99, 10


# ------------------------------------------------------------ gray, resize
def bgr_to_gray(img: np.ndarray) -> np.ndarray:
    """``cv2.cvtColor(img, cv2.COLOR_BGR2GRAY)`` for uint8 (H, W, 3): OpenCV's
    15-bit fixed-point weights (3735, 19235, 9798), rounded."""
    b, g, r = (img[..., i].astype(np.int32) for i in range(3))
    return ((b * 3735 + g * 19235 + r * 9798 + (1 << 14)) >> 15).astype(np.uint8)


# ------------------------------------------------------------ corners
def _box_sum(a: np.ndarray, k: int) -> np.ndarray:
    """``cv2.boxFilter(a, -1, (k, k), normalize=False)`` for float32 with
    BORDER_REFLECT_101: OpenCV sums float rows in float64, exactly here."""
    p = k // 2
    c = np.cumsum(np.pad(a.astype(np.float64), p, mode="reflect"), 0)
    rows = np.concatenate([c[k - 1: k], c[k:] - c[:-k]], 0)
    c = np.cumsum(rows, 1)
    return np.concatenate([c[:, k - 1: k], c[:, k:] - c[:, :-k]], 1).astype(_f32)


def corner_min_eigen_val(gray: np.ndarray) -> np.ndarray:
    """``cv2.cornerMinEigenVal(gray, BLOCK_SIZE, ksize=3)`` for uint8: the
    3x3 Sobel derivatives scaled by 1 / (4 * BLOCK_SIZE * 255) (BORDER_REFLECT_101),
    their products summed over a BLOCK_SIZE box, the smaller eigenvalue of
    each 2x2 sum. float32 (H, W).

    The Sobel passes round as OpenCV's AVX2 code does: the x derivative's
    column pass is one fused multiply-add; the y derivative's row pass is a
    chain of them on the columns OpenCV's 32-wide vector loop covers and
    plain products and sums on the tail."""
    scale = 1.0 / ((1 << 2) * BLOCK_SIZE * 255.0)
    s1, s2 = _f32(scale), _f32(2 * scale)
    g = np.pad(gray.astype(_f32), 1, mode="reflect")
    diff = g[:, 2:] - g[:, :-2]  # row pass [-1, 0, 1], exact
    dx = _fma(diff[:-2] + diff[2:], s1, diff[1:-1] * s2)  # column pass [s, 2s, s]
    g0, g1, g2 = g[:, :-2], g[:, 1:-1], g[:, 2:]
    smooth = _fma(g2, s1, _fma(g1, s2, g0 * s1))  # row pass [s, 2s, s]
    tail = gray.shape[1] // 32 * 32
    smooth[:, tail:] = (g0[:, tail:] * s1 + g1[:, tail:] * s2) + g2[:, tail:] * s1
    dy = smooth[2:] - smooth[:-2]  # column pass [-1, 0, 1]
    a = _box_sum(dx * dx, BLOCK_SIZE) * _f32(0.5)
    b = _box_sum(dx * dy, BLOCK_SIZE)
    c = _box_sum(dy * dy, BLOCK_SIZE) * _f32(0.5)
    return (a + c) - np.sqrt((a - c) * (a - c) + b * b)


def good_features_to_track(gray: np.ndarray) -> np.ndarray | None:
    """``cv2.goodFeaturesToTrack(gray, maxCorners=200, qualityLevel=0.01,
    minDistance=7, blockSize=7)`` with its other defaults (3x3 Sobel, no
    Harris, no mask): ``corner_min_eigen_val``; values at or below
    QUALITY_LEVEL times the largest set to 0; the non-zero 3x3 local maxima
    off the one-pixel border; sorted by value, descending, equal values by
    position, later first; taken greedily, each at least MIN_DISTANCE from
    every point taken, up to MAX_CORNERS. (N, 1, 2) float32 (x, y), or None
    when there is none, as cv2 returns."""
    eig = corner_min_eigen_val(gray)
    eig = np.where(eig > _f32(float(eig.max()) * QUALITY_LEVEL), eig, _f32(0))
    h, w = eig.shape
    if h < 3 or w < 3:
        return None
    peak = np.maximum(np.maximum(eig[:-2], eig[1:-1]), eig[2:])
    peak = np.maximum(np.maximum(peak[:, :-2], peak[:, 1:-1]), peak[:, 2:])
    inner = eig[1:-1, 1:-1]
    ys, xs = np.nonzero((inner != 0) & (inner == peak))
    ys, xs = ys + 1, xs + 1
    order = np.lexsort((-(ys * w + xs), -eig[ys, xs]))
    r = MIN_DISTANCE
    oy, ox = np.mgrid[-r: r + 1, -r: r + 1]
    disk = oy * oy + ox * ox < MIN_DISTANCE * MIN_DISTANCE  # the offsets a taken point excludes
    taken = np.zeros((h + 2 * r, w + 2 * r), bool)
    out: list[tuple[int, int]] = []
    for y, x in zip(ys[order].tolist(), xs[order].tolist()):
        if taken[y + r, x + r]:
            continue
        out.append((x, y))
        if len(out) == MAX_CORNERS:
            break
        taken[y: y + 2 * r + 1, x: x + 2 * r + 1] |= disk
    return np.array(out, _f32).reshape(-1, 1, 2) if out else None


# ------------------------------------------------------------ pyramidal Lucas-Kanade
def pyr_down(img: np.ndarray) -> np.ndarray:
    """``cv2.pyrDown(img)`` for uint8 (H, W): the 5x5 [1 4 6 4 1]^2 / 256
    kernel at every other pixel, BORDER_REFLECT_101, rounded; ((H+1)//2, (W+1)//2)."""
    h, w = img.shape
    dh, dw = (h + 1) // 2, (w + 1) // 2
    p = np.pad(img.astype(np.int32), 2, mode="reflect")

    def taps(a: np.ndarray, n: int, axis: int) -> np.ndarray:
        def at(k: int) -> np.ndarray:
            return a[:, k: k + 2 * n: 2] if axis else a[k: k + 2 * n: 2]
        return at(0) + at(4) + 4 * (at(1) + at(3)) + 6 * at(2)

    return (taps(taps(p, dw, 1), dh, 0) + 128 >> 8).astype(np.uint8)


def _build_pyramid(gray: np.ndarray) -> list[np.ndarray]:
    """``cv2.buildOpticalFlowPyramid(gray, (LK_WIN, LK_WIN), LK_LEVELS)``:
    levels by ``pyr_down`` until a level's next size is within the window."""
    pyr = [gray]
    for _ in range(LK_LEVELS):
        h, w = pyr[-1].shape
        if (w + 1) // 2 <= LK_WIN or (h + 1) // 2 <= LK_WIN:
            break
        pyr.append(pyr_down(pyr[-1]))
    return pyr


def _scharr(img: np.ndarray) -> tuple[np.ndarray, np.ndarray]:
    """OpenCV's ``calcSharrDeriv``: int32 (H, W) dx and dy with the [3 10 3]
    smoothing and the [-1 0 1] difference, rows and columns reflected."""
    g = np.pad(img.astype(np.int32), 1, mode="reflect")
    smooth = (g[:-2] + g[2:]) * 3 + g[1:-1] * 10  # vertical [3 10 3]
    diff = g[2:] - g[:-2]  # vertical [-1 0 1]
    return smooth[:, 2:] - smooth[:, :-2], (diff[:, 2:] + diff[:, :-2]) * 3 + diff[:, 1:-1] * 10


def _bilinear_weights(frac_x: np.ndarray, frac_y: np.ndarray) -> np.ndarray:
    """The 14-bit weights (iw00, iw01, iw10, iw11) of OpenCV's LK: (N, 4, 1, 1) int32."""
    frac_x, frac_y = frac_x.astype(_f32), frac_y.astype(_f32)  # exact: the fraction of a float32
    one, s = _f32(1), _f32(1 << 14)
    w00 = np.rint((one - frac_x) * (one - frac_y) * s).astype(np.int32)
    w01 = np.rint(frac_x * (one - frac_y) * s).astype(np.int32)
    w10 = np.rint((one - frac_x) * frac_y * s).astype(np.int32)
    return np.stack([w00, w01, w10, (1 << 14) - w00 - w01 - w10], 1)[:, :, None, None]


def _interp(flat: np.ndarray, idx: np.ndarray, wts: np.ndarray, shift: int) -> np.ndarray:
    """OpenCV's bilinear window samples: ``idx`` (N, win+1, win+1) the flat
    indices of each window and its extra row and column in a padded image
    flattened to ``flat``, weights from ``_bilinear_weights``; the rounded
    right shift by ``shift``. (N, win, win) int32."""
    p = flat.take(idx)
    s = p[:, :-1, :-1] * wts[:, 0] + p[:, :-1, 1:] * wts[:, 1] + p[:, 1:, :-1] * wts[:, 2] + p[:, 1:, 1:] * wts[:, 3]
    return (s + (1 << (shift - 1))) >> shift


def _window_sum(a: np.ndarray, b: np.ndarray) -> np.ndarray:
    """Per point sum of a * b over the window, exact, rounded to float32 and
    scaled by 2^-20 as OpenCV's ``FLT_SCALE``."""
    return np.einsum("nij,nij->n", a.astype(np.int64), b).astype(_f32) * _f32(1.0 / (1 << 20))


def calc_optical_flow_pyr_lk(prev: np.ndarray, nxt: np.ndarray, prev_pts: np.ndarray) -> tuple[np.ndarray, np.ndarray]:
    """``cv2.calcOpticalFlowPyrLK(prev, nxt, prev_pts, None)`` with its
    defaults (a 21x21 window, 3 pyramid levels, 30 iterations or a step under
    0.01, no initial flow) for uint8 gray frames.

    From the coarsest level down, each point's window of ``prev`` and its
    Scharr derivatives (14-bit bilinear weights, the image part kept with 5
    fraction bits) gives the 2x2 gradient matrix; a point whose smallest
    eigenvalue per pixel is under LK_MIN_EIG stops there; else Newton steps
    on ``nxt``'s window move it, until a step is under LK_EPS or two steps
    cancel (then it goes back half the last). The image is reflected LK_WIN
    pixels past its edge, the derivatives
    are 0 there; a window that leaves that margin stops the point. A point
    that stops on level 0 has status 0. Returns (next points (N, 1, 2)
    float32, status (N, 1) uint8)."""
    pts = np.asarray(prev_pts, _f32).reshape(-1, 2)
    status = np.ones(len(pts), bool)
    next_pts = pts.copy()
    half = _f32((LK_WIN - 1) * 0.5)
    pyr_a, pyr_b = _build_pyramid(prev), _build_pyramid(nxt)
    top = min(len(pyr_a), len(pyr_b)) - 1
    grid = np.arange(LK_WIN + 1)
    win_area = _f32(2 * LK_WIN * LK_WIN)
    m = LK_WIN  # the margin around each level

    def inside(ip: np.ndarray, h: int, w: int) -> np.ndarray:
        return (ip[:, 0] >= -m) & (ip[:, 0] < w) & (ip[:, 1] >= -m) & (ip[:, 1] < h)

    for level in range(top, -1, -1):
        h, w = pyr_a[level].shape
        flat_a = np.pad(pyr_a[level], m, mode="reflect").astype(np.int32).ravel()
        flat_b = np.pad(pyr_b[level], m, mode="reflect").astype(np.int32).ravel()
        flat_dx, flat_dy = (np.pad(d, m).ravel() for d in _scharr(pyr_a[level]))
        stride = w + 2 * m
        offsets = grid[:, None] * stride + grid[None, :] + m * stride + m

        scaled = pts * _f32(1.0 / (1 << level))
        next_pts = scaled.copy() if level == top else next_pts * _f32(2)
        p = scaled - half
        ip = np.floor(p).astype(np.int64)
        ok = inside(ip, h, w)
        if level == 0:
            status &= ok
        live = np.nonzero(ok)[0]
        if not len(live):
            continue
        wts = _bilinear_weights(p[live, 0] - ip[live, 0], p[live, 1] - ip[live, 1])
        idx = (ip[live, 1] * stride + ip[live, 0])[:, None, None] + offsets
        patch = _interp(flat_a, idx, wts, 14 - 5)
        gx, gy = _interp(flat_dx, idx, wts, 14), _interp(flat_dy, idx, wts, 14)
        a11, a12, a22 = _window_sum(gx, gx), _window_sum(gx, gy), _window_sum(gy, gy)
        det = a11 * a22 - a12 * a12
        min_eig = (a22 + a11 - np.sqrt((a11 - a22) * (a11 - a22) + _f32(4) * a12 * a12)) / win_area
        good = (min_eig >= _f32(LK_MIN_EIG)) & (det >= _f32(FLT_EPSILON))
        if level == 0:
            status[live[~good]] = False
        live, patch, gx, gy = live[good], patch[good], gx[good], gy[good]
        a11, a12, a22, inv_det = a11[good], a12[good], a22[good], _f32(1) / det[good]

        pos = next_pts[live] - half
        prev_delta = np.zeros((len(live), 2), _f32)
        active = np.arange(len(live))
        for it in range(LK_ITERS):
            iq = np.floor(pos[active]).astype(np.int64)
            ok = inside(iq, h, w)
            if level == 0:
                status[live[active[~ok]]] = False
            active, iq = active[ok], iq[ok]
            if not len(active):
                break
            q = pos[active]
            wts = _bilinear_weights(q[:, 0] - iq[:, 0], q[:, 1] - iq[:, 1])
            idx = (iq[:, 1] * stride + iq[:, 0])[:, None, None] + offsets
            diff = _interp(flat_b, idx, wts, 14 - 5) - patch[active]
            b1, b2 = _window_sum(diff, gx[active]), _window_sum(diff, gy[active])
            delta = np.stack([(a12[active] * b2 - a22[active] * b1) * inv_det[active],
                              (a12[active] * b1 - a11[active] * b2) * inv_det[active]], 1)
            q = q + delta
            pos[active] = q
            out = q + half
            small = (delta.astype(np.float64) ** 2).sum(1) <= LK_EPS * LK_EPS
            swing = np.zeros_like(small) if it == 0 else (
                (np.abs((delta + prev_delta[active]).astype(np.float64)) < 0.01).all(1) & ~small)
            out[swing] -= delta[swing] * _f32(0.5)
            next_pts[live[active]] = out
            prev_delta[active] = delta
            active = active[~(small | swing)]
    return next_pts.reshape(-1, 1, 2), status.astype(np.uint8).reshape(-1, 1)


# ------------------------------------------------------------ similarity
def _similarity_from_pairs(src: np.ndarray, dst: np.ndarray) -> np.ndarray:
    """OpenCV's ``AffinePartial2DEstimatorCallback::runKernel`` on many
    2-point subsets at once: src, dst (S, 2, 2) float64 -> (S, 2, 3)
    [[a, -b, tx], [b, a, ty]]."""
    x1, y1, x2, y2 = src[:, 0, 0], src[:, 0, 1], src[:, 1, 0], src[:, 1, 1]
    X1, Y1, X2, Y2 = dst[:, 0, 0], dst[:, 0, 1], dst[:, 1, 0], dst[:, 1, 1]
    with np.errstate(divide="ignore", invalid="ignore"):
        d = 1.0 / ((x1 - x2) * (x1 - x2) + (y1 - y2) * (y1 - y2))
        s0 = d * ((X1 - X2) * (x1 - x2) + (Y1 - Y2) * (y1 - y2))
        s1 = d * ((Y1 - Y2) * (x1 - x2) - (X1 - X2) * (y1 - y2))
        s2 = d * ((Y1 - Y2) * (x1 * y2 - x2 * y1) - (X1 * y2 - X2 * y1) * (y1 - y2) - (X1 * x2 - X2 * x1) * (x1 - x2))
        s3 = d * (-(X1 - X2) * (x1 * y2 - x2 * y1) - (Y1 * x2 - Y2 * x1) * (x1 - x2) - (Y1 * y2 - Y2 * y1) * (y1 - y2))
    return np.stack([np.stack([s0, -s1, s2], 1), np.stack([s1, s0, s3], 1)], 1)


def _sq_errors(models: np.ndarray, src: np.ndarray, dst: np.ndarray) -> np.ndarray:
    """OpenCV's ``Affine2DEstimatorCallback::computeError`` in float32: (S, 2, 3) x (N, 2) -> (S, N)."""
    f = models.astype(_f32)
    x, y = src[None, :, 0], src[None, :, 1]
    a = f[:, 0, 0, None] * x + f[:, 0, 1, None] * y + f[:, 0, 2, None] - dst[None, :, 0]
    b = f[:, 1, 0, None] * x + f[:, 1, 1, None] * y + f[:, 1, 2, None] - dst[None, :, 1]
    return a * a + b * b


def _ransac_update_num_iters(p: float, ep: float, model_points: int, max_iters: int) -> int:
    """OpenCV's ``RANSACUpdateNumIters``."""
    num = math.log(max(1.0 - p, np.finfo(np.float64).tiny))
    denom = 1.0 - (1.0 - min(max(ep, 0.0), 1.0)) ** model_points
    if denom < np.finfo(np.float64).tiny:
        return 0
    denom = math.log(denom)
    return max_iters if denom >= 0 or -num >= max_iters * (-denom) else int(np.rint(num / denom))


def _lm_refine(src: np.ndarray, dst: np.ndarray, param: np.ndarray, max_iters: int) -> np.ndarray:
    """OpenCV's ``LMSolver`` (``createLMSolver(cb, max_iters)``, eps
    FLT_EPSILON) on ``AffinePartial2DRefineCallback``: param (a, b, tx, ty),
    residuals ``[a -b; b a] src + t - dst`` in float64."""
    x0, y0 = src[:, 0].astype(np.float64), src[:, 1].astype(np.float64)
    tx, ty = dst[:, 0].astype(np.float64), dst[:, 1].astype(np.float64)
    jac = np.zeros((2 * len(src), 4))
    jac[0::2] = np.stack([x0, -y0, np.ones_like(x0), np.zeros_like(x0)], 1)
    jac[1::2] = np.stack([y0, x0, np.zeros_like(x0), np.ones_like(x0)], 1)

    def residuals(h: np.ndarray) -> np.ndarray:
        r = np.empty(2 * len(src))
        r[0::2] = h[0] * x0 - h[1] * y0 + h[2] - tx
        r[1::2] = h[1] * x0 + h[0] * y0 + h[3] - ty
        return r

    def solve_eig(a: np.ndarray, b: np.ndarray) -> np.ndarray:  # DECOMP_EIG: the pseudo-inverse by eigenvalues
        vals, vecs = np.linalg.eigh(a)
        keep = np.abs(vals) > np.abs(vals).max() * DBL_EPSILON * len(vals)
        inv = np.where(keep, 1.0 / np.where(keep, vals, 1.0), 0.0)
        return vecs @ (inv * (vecs.T @ b))

    x = np.asarray(param, np.float64).copy()
    r = residuals(x)
    s = float(r @ r)
    a = jac.T @ jac
    v = jac.T @ r
    diag = a.diagonal().copy()
    lam, lc = 1.0, 0.75
    it = 0
    while True:
        d = solve_eig(a + np.diag(lam * diag), v)
        xd = x - d
        rd = residuals(xd)
        sd = float(rd @ rd)
        ds = float(d @ (2 * v - a @ d))
        ratio = (s - sd) / (ds if abs(ds) > DBL_EPSILON else 1.0)
        if ratio > 0.75:
            lam *= 0.5
            if lam < lc:
                lam = 0.0
        elif ratio < 0.25:
            t = float(d @ v)
            nu = min(max((sd - s) / (t if abs(t) > DBL_EPSILON else 1.0) + 2, 2.0), 10.0)
            if lam == 0:
                inv_diag = np.abs(solve_eig(a, np.eye(4)).diagonal())
                lam = lc = 1.0 / max(DBL_EPSILON, float(inv_diag.max()))
                nu *= 0.5
            lam *= nu
        if sd < s:
            s, x = sd, xd
            v = jac.T @ rd
        it += 1
        if not (it < max_iters and float(np.abs(d).max()) >= FLT_EPSILON and s >= FLT_EPSILON * FLT_EPSILON):
            return x


def estimate_affine_partial_2d(src_pts: np.ndarray, dst_pts: np.ndarray) -> tuple[np.ndarray | None, np.ndarray]:
    """``cv2.estimateAffinePartial2D(src, dst, method=cv2.RANSAC)`` with its
    defaults: a 4-DoF similarity by RANSAC over 2-point subsets (a point is
    an inlier when its squared float32 error is at most RANSAC_THRESH^2; a
    model replaces the best only with more inliers; the iteration count
    shrinks with the inlier share at RANSAC_CONFIDENCE), then OpenCV's
    Levenberg-Marquardt on the best model's inliers. Subsets are drawn from
    a ``numpy.random.default_rng(0)`` made for the call, so a call is
    deterministic as cv2's is. Returns (the (2, 3) float64 matrix or None,
    inlier mask (N, 1) uint8)."""
    src = np.asarray(src_pts, _f32).reshape(-1, 2)
    dst = np.asarray(dst_pts, _f32).reshape(-1, 2)
    n = len(src)
    mask = np.zeros((n, 1), np.uint8)
    if n < 2:
        return None, mask
    rng = np.random.default_rng(0)
    t = _f32(RANSAC_THRESH * RANSAC_THRESH)
    if n == 2:
        best = _similarity_from_pairs(src[None].astype(np.float64), dst[None].astype(np.float64))[0]
        best_mask = np.ones(n, bool)
    else:
        niters, it, best_count = RANSAC_ITERS, 0, 0
        best, best_mask = None, None
        while it < niters:
            k = min(niters - it, 256)
            i = rng.integers(0, n, k)
            j = rng.integers(0, n - 1, k)
            j += j >= i  # a second, distinct point
            models = _similarity_from_pairs(np.stack([src[i], src[j]], 1).astype(np.float64),
                                            np.stack([dst[i], dst[j]], 1).astype(np.float64))
            with np.errstate(invalid="ignore", over="ignore"):
                inl = _sq_errors(models, src, dst) <= t
            counts = inl.sum(1)
            for s in range(k):
                if it >= niters:
                    break
                if counts[s] > max(best_count, 1):
                    best, best_mask, best_count = models[s], inl[s], int(counts[s])
                    niters = _ransac_update_num_iters(RANSAC_CONFIDENCE, (n - best_count) / n, 2, niters)
                it += 1
        if best is None:
            return None, mask
    mask[:, 0] = best_mask
    if n > 2:
        a, b, tx, ty = _lm_refine(src[best_mask], dst[best_mask], np.array([best[0, 0], best[1, 0], best[0, 2],
                                                                              best[1, 2]]), REFINE_ITERS)
        best = np.array([[a, -b, tx], [b, a, ty]])
    return best, mask
