"""The port's stand-ins for the cv2 calls of BoT-SORT's camera-motion
compensation (``fce_yolo_tpu_torch/trackers/flow.py``) against OpenCV, and
the port's ``GMC`` and ``BOTSORT`` against the JAX package's, which call
cv2.

Tolerances: gray, the /2 resize and ``pyrDown`` bit-equal; corners the
same points in the same order but where two responses are within 1e-5
relative of each other (a tie that a float rounding of the response can
turn), each within 1e-3 px; Lucas-Kanade: the same status and points within
0.01 px wherever cv2 follows them (the window sums are rounded once, where
cv2 adds them in float32 lanes); the similarity's 2x2 part within 1e-3 and
its translation within 0.05 px (RANSAC draws from another generator, then
both refine on the inliers); ``BOTSORT`` with the GMC gives JAX's ids, and
its boxes within 1e-3 px of JAX's.
"""

import cv2
import numpy as np
import pytest

from fce_yolo_tpu.trackers import BOTSORT as JaxBOTSORT
from fce_yolo_tpu.trackers import GMC as JaxGMC
from fce_yolo_tpu.trackers import TrackerArgs as JaxArgs
from fce_yolo_tpu_torch.data.augment import resize_linear
from fce_yolo_tpu_torch.trackers import BOTSORT, GMC, TrackerArgs
from fce_yolo_tpu_torch.trackers import flow as F


def _texture(h: int, w: int, seed: int, cell: int = 6) -> np.ndarray:
    """A smooth BGR texture with a little noise: random colours every
    ``cell`` pixels, interpolated."""
    rng = np.random.default_rng(seed)
    coarse = rng.integers(0, 256, (h // cell + 2, w // cell + 2, 3), dtype=np.uint8)
    img = cv2.resize(coarse, (w, h), interpolation=cv2.INTER_LINEAR).astype(np.int32)
    return np.clip(img + rng.integers(-4, 5, img.shape), 0, 255).astype(np.uint8)


def _warp_pair(seed: int, dx: float, dy: float, angle: float, scale: float, h: int = 240, w: int = 320,
               movers: int = 0):
    """A frame and the same scene moved by a similarity about its centre,
    both cut from a larger texture so that no border shows; ``movers``
    flat squares that move on their own (their corners are outliers)."""
    big = _texture(h + 80, w + 80, seed)
    m = cv2.getRotationMatrix2D(((w + 80) / 2, (h + 80) / 2), angle, scale)
    m[:, 2] += (dx, dy)
    moved = cv2.warpAffine(big, m, (w + 80, h + 80))
    a, b = big[40: 40 + h, 40: 40 + w].copy(), moved[40: 40 + h, 40: 40 + w].copy()
    rng = np.random.default_rng(seed + 100)
    for _ in range(movers):
        x, y = rng.integers(40, w - 140), rng.integers(40, h - 140)
        ox, oy = rng.integers(12, 24, 2) * rng.choice([-1, 1], 2)
        color = rng.integers(0, 256, 3).tolist()
        cv2.rectangle(a, (x, y), (x + 90, y + 90), color, -1)
        cv2.rectangle(b, (x + ox, y + oy), (x + ox + 90, y + oy + 90), color, -1)
    return a, b


WARPS = [(1, 0, 0, 1.0), (3, -2, 0, 1.0), (8, 5, 0, 1.0), (-4, 6, 2.0, 1.0), (2, 3, -2.0, 1.02),
         (-6, -1, 1.0, 0.98), (5, -7, -1.5, 1.01), (1.5, 0.5, 0.5, 0.99)]


def test_bgr_to_gray_is_bit_equal():
    v = np.arange(256, dtype=np.uint8)
    every = np.stack(np.meshgrid(v, v, v, indexing="ij"), -1).reshape(4096, 4096, 3)
    np.testing.assert_array_equal(F.bgr_to_gray(every), cv2.cvtColor(every, cv2.COLOR_BGR2GRAY))
    odd = _texture(37, 53, 1)
    np.testing.assert_array_equal(F.bgr_to_gray(odd), cv2.cvtColor(odd, cv2.COLOR_BGR2GRAY))


@pytest.mark.parametrize("shape", [(720, 1280), (240, 320), (97, 131), (101, 64)])
def test_resize_gray_and_pyr_down_are_bit_equal(shape):
    h, w = shape
    gray = np.random.default_rng(h).integers(0, 256, shape, dtype=np.uint8)
    np.testing.assert_array_equal(resize_linear(gray[..., None], (w // 2, h // 2))[..., 0],
                                  cv2.resize(gray, (w // 2, h // 2)))
    np.testing.assert_array_equal(F.pyr_down(gray), cv2.pyrDown(gray))


@pytest.mark.parametrize("seed,shape", [(0, (240, 320)), (1, (360, 640)), (2, (61, 83)), (3, (120, 161))])
def test_corners_match_cv2(seed, shape):
    """``cornerMinEigenVal`` within 1e-6 of the largest response, and
    ``goodFeaturesToTrack``'s points in cv2's order."""
    gray = cv2.cvtColor(_texture(*shape, seed), cv2.COLOR_BGR2GRAY)
    ref_eig = cv2.cornerMinEigenVal(gray, 7, 3)
    eig = F.corner_min_eigen_val(gray)
    assert np.abs(eig - ref_eig).max() <= 1e-6 * ref_eig.max()
    assert (eig == ref_eig).mean() > 0.99
    ref = cv2.goodFeaturesToTrack(gray, maxCorners=200, qualityLevel=0.01, minDistance=7, blockSize=7)
    pts = F.good_features_to_track(gray)
    assert pts.shape == ref.shape and pts.dtype == np.float32
    for (p,), (r,) in zip(pts, ref):
        if np.abs(p - r).max() > 1e-3:  # only a near-tie may swap
            a, b = ref_eig[int(p[1]), int(p[0])], ref_eig[int(r[1]), int(r[0])]
            assert abs(a - b) <= 1e-5 * max(a, b), (p, r)


def test_corners_none_on_a_flat_image():
    flat = np.full((40, 50), 7, np.uint8)
    assert F.good_features_to_track(flat) is None
    assert cv2.goodFeaturesToTrack(flat, maxCorners=200, qualityLevel=0.01, minDistance=7, blockSize=7) is None


@pytest.mark.parametrize("warp", WARPS[::2])
def test_optical_flow_matches_cv2(warp):
    a, b = (cv2.cvtColor(x, cv2.COLOR_BGR2GRAY) for x in _warp_pair(7, *warp))
    pts = cv2.goodFeaturesToTrack(a, maxCorners=200, qualityLevel=0.01, minDistance=7, blockSize=7)
    # and points whose window leaves the image, or starts outside it
    pts = np.concatenate([pts, np.float32([[[-5, 10]], [[318.7, 239.2]], [[100.3, -15]], [[-40, 5]]])])
    ref, ref_status, _ = cv2.calcOpticalFlowPyrLK(a, b, pts, None)
    out, status = F.calc_optical_flow_pyr_lk(a, b, pts)
    np.testing.assert_array_equal(status, ref_status)
    found = ref_status[:, 0] == 1
    assert found.sum() > 150
    np.testing.assert_allclose(out[found], ref[found], rtol=0, atol=0.01)


@pytest.mark.parametrize("case", range(4))
def test_affine_partial_matches_cv2(case):
    """A similarity of 1-8 px, +-2 degrees and scale 0.98-1.02 on 150 points
    with 0.2 px noise and 10% of them moved far off."""
    rng = np.random.default_rng(case)
    ang, s = np.deg2rad(rng.uniform(-2, 2)), rng.uniform(0.98, 1.02)
    m = np.array([[s * np.cos(ang), -s * np.sin(ang), rng.uniform(1, 8)],
                  [s * np.sin(ang), s * np.cos(ang), rng.uniform(-8, 8)]])
    src = rng.uniform(0, 320, (150, 1, 2)).astype(np.float32)
    dst = (src @ m[:, :2].T + m[:, 2] + rng.normal(0, 0.2, src.shape)).astype(np.float32)
    out = rng.choice(150, 15, replace=False)
    dst[out] += rng.uniform(20, 60, (15, 1, 2)).astype(np.float32) * rng.choice([-1, 1], (15, 1, 2))
    ref, ref_inl = cv2.estimateAffinePartial2D(src, dst, method=cv2.RANSAC)
    got, inl = F.estimate_affine_partial_2d(src, dst)
    np.testing.assert_allclose(got[:, :2], ref[:, :2], rtol=0, atol=1e-3)
    np.testing.assert_allclose(got[:, 2], ref[:, 2], rtol=0, atol=0.05)
    assert not inl[out].any() and not ref_inl[out].any()
    assert inl.sum() >= 130 and got[0, 0] == got[1, 1] and got[0, 1] == -got[1, 0]


def test_affine_partial_too_few_points():
    assert F.estimate_affine_partial_2d(np.zeros((1, 1, 2), np.float32), np.zeros((1, 1, 2), np.float32))[0] is None
    src = np.float32([[[0, 0]], [[10, 0]]])
    m, inl = F.estimate_affine_partial_2d(src, src + 2)
    np.testing.assert_allclose(m, [[1, 0, 2], [0, 1, 2]], atol=1e-12)
    assert inl.all()


@pytest.mark.parametrize("warp", WARPS)
def test_gmc_matches_jax(warp):
    """``GMC.apply`` on two frames (480x640, downscaled by 2) against the JAX
    GMC's cv2 pipeline: the warp's 2x2 part within 1e-3, its translation
    within 0.05 px. Six flat squares move on their own: 2-22% of the
    points followed (9% on average) are outliers."""
    a, b = _warp_pair(11, *warp, h=480, w=640, movers=6)
    port, ref = GMC(), JaxGMC()
    for img in (a, b):
        h_port, h_ref = port.apply(img), ref.apply(img)
    assert h_port.dtype == np.float32
    np.testing.assert_allclose(h_port[:, :2], h_ref[:, :2], rtol=0, atol=1e-3)
    np.testing.assert_allclose(h_port[:, 2], h_ref[:, 2], rtol=0, atol=0.05)
    np.testing.assert_array_equal(port.prev_gray, ref.prev_gray)
    np.testing.assert_array_equal(port.prev_pts, ref.prev_pts)


def test_gmc_first_frame_and_none():
    img = _texture(96, 128, 3)
    np.testing.assert_array_equal(GMC().apply(img), np.eye(2, 3, dtype=np.float32))
    none = GMC(method="none")
    none.apply(img)
    np.testing.assert_array_equal(none.apply(np.roll(img, 3, 1)), np.eye(2, 3, dtype=np.float32))
    assert none.prev_gray is None


def _jax_camera_motion_sequence():
    """tests/test_trackers.py::test_botsort_with_camera_motion's frames."""
    rng = np.random.RandomState(0)
    base = rng.randint(0, 255, (240, 320, 3), np.uint8)
    for t in range(6):
        img = cv2.warpAffine(base, np.float32([[1, 0, 2 * t], [0, 1, 0]]), (320, 240))
        yield np.array([[50 + 2 * t, 50, 90 + 2 * t, 90]], float), np.array([0.9]), np.array([0]), img


def _panning_sequence(n: int = 24):
    """A textured scene panned 3 px a frame under 4 flat rectangles of their
    own motion: two cross, one leaves the frame for 6 frames and comes back."""
    big = _texture(360, 480 + 3 * n, 5)
    colors = [(40, 40, 230), (40, 230, 40), (230, 40, 40), (230, 230, 40)]
    for t in range(n):
        img = big[:, 3 * t: 3 * t + 480].copy()
        boxes = [(40 + 6 * t, 60, 120 + 6 * t, 140), (300 - 6 * t, 70, 380 - 6 * t, 150),
                 (200, 220 + 2 * t, 260, 290 + 2 * t), (-150 + 10 * t if t >= 12 else 400 + 12 * t, 250,
                                                        -90 + 10 * t if t >= 12 else 460 + 12 * t, 320)]
        keep = [k for k, b in enumerate(boxes) if b[0] >= 0 and b[2] <= 480]
        for k in keep:
            x1, y1, x2, y2 = boxes[k]
            img[y1:y2, x1:x2] = colors[k]
        yield (np.array([boxes[k] for k in keep], float), np.full(len(keep), 0.9), np.array(keep, float), img)


@pytest.mark.parametrize("sequence", [_jax_camera_motion_sequence, _panning_sequence])
def test_botsort_with_gmc_gives_jax_ids(sequence):
    port, ref = BOTSORT(TrackerArgs(tracker_type="botsort")), JaxBOTSORT(JaxArgs(tracker_type="botsort"))
    n_out = 0
    for boxes, scores, classes, img in sequence():
        out = port.update(boxes, scores, classes, img=img)
        exp = ref.update(boxes, scores, classes, img=img)
        assert out.shape == exp.shape
        np.testing.assert_array_equal(out[:, 4:], exp[:, 4:])  # ids, scores, classes
        np.testing.assert_allclose(out[:, :4], exp[:, :4], rtol=0, atol=1e-3)
        n_out += len(out)
    assert n_out > 0
