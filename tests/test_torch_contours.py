"""Mask outlines without cv2 (``ops/contours.py``, ``csrc/contours.cu``)
against cv2 5.0's ``findContours(RETR_EXTERNAL, CHAIN_APPROX_SIMPLE)`` and
``contourArea``, and the port's ``masks2segments``, ``Masks.xy``,
``Results.summary`` and ``to_json`` against the JAX package's, which call
cv2.

Tolerance: none. The outlines (points, start point, direction and the
order of the list) equal cv2's on 200 seeded masks (noise at five
densities, blobs, rings with nested islands, rings touching the edges,
masks touching every edge) and the hand cases, through the Python walk
(``device="cpu"``) and through the host C++ walk, which g++ builds here
from the card library's source; the areas equal cv2's; the segments,
outlines and summaries equal the JAX package's.
"""

import ctypes
import json
import shutil
import subprocess
from types import SimpleNamespace

import cv2
import numpy as np
import pytest

from fce_yolo_tpu.engine.results import Results as JaxResults
from fce_yolo_tpu.ops.geometry import masks2segments as jax_masks2segments
from fce_yolo_tpu_torch.engine.results import Results
from fce_yolo_tpu_torch.kernels import build as kbuild
from fce_yolo_tpu_torch.ops.contours import contour_area, find_contours_external
from fce_yolo_tpu_torch.ops.geometry import masks2segments

KINDS = ["noise", "blobs", "nested", "edges", "rings"]


def masks(kind: str, n: int = 40):
    rng = np.random.RandomState(KINDS.index(kind))
    for i in range(n):
        h, w = (int(v) for v in rng.randint(1, 48, 2))
        if kind == "noise":
            m = (rng.rand(h, w) < [0.05, 0.2, 0.5, 0.8, 0.95][i % 5]).astype(np.uint8)
        elif kind == "blobs":
            m = np.zeros((h, w), np.uint8)
            for _ in range(rng.randint(1, 6)):
                cv2.circle(m, (int(rng.randint(0, w)), int(rng.randint(0, h))), int(rng.randint(1, 12)), 1, -1)
        elif kind == "nested":  # a ring, an island in its hole, noise in the island's hole
            m = np.zeros((h + 14, w + 14), np.uint8)
            hh, ww = m.shape
            cv2.rectangle(m, (1, 1), (ww - 2, hh - 2), 1, -1)
            cv2.rectangle(m, (3, 3), (ww - 4, hh - 4), 0, -1)
            cv2.rectangle(m, (5, 5), (ww - 6, hh - 6), 1, -1)
            m[7: hh - 7, 7: ww - 7] = rng.rand(hh - 14, ww - 14) < 0.5
        elif kind == "edges":  # touching every edge
            m = (rng.rand(h, w) < 0.6).astype(np.uint8)
            m[0], m[-1], m[:, 0], m[:, -1] = 1, rng.rand(w) < 0.5, 1, rng.rand(h) < 0.5
        else:  # a 1-px ring on the image's frame around noise
            m = np.zeros((h + 6, w + 6), np.uint8)
            cv2.rectangle(m, (0, 0), (m.shape[1] - 1, m.shape[0] - 1), 1, 1)
            m[2:-2, 2:-2] = rng.rand(h + 2, w + 2) < 0.4
        yield m


HAND = {
    "empty": np.zeros((5, 7), np.uint8),
    "all": np.ones((5, 7), np.uint8),
    "pixel": np.pad(np.ones((1, 1), np.uint8), 3),
    "corner pixel": np.pad(np.ones((1, 1), np.uint8), ((0, 3), (3, 0))),
    "h line": np.pad(np.ones((1, 6), np.uint8), 2),
    "v line": np.pad(np.ones((6, 1), np.uint8), 2),
    "diagonal": np.eye(6, dtype=np.uint8),
    "anti-diagonal": np.eye(6, dtype=np.uint8)[::-1].copy(),
    "diagonal join": np.array([[1, 1, 0, 0], [1, 1, 0, 0], [0, 0, 1, 1], [0, 0, 1, 1]], np.uint8),
    "hole": np.pad(np.pad(np.zeros((2, 3), np.uint8), 1, constant_values=1), 1),
    "island in hole": np.pad(np.pad(np.pad(np.ones((1, 1), np.uint8), 1), 1, constant_values=1), 1),
    "two blobs": np.array([[1, 1, 0, 1], [1, 0, 0, 1], [0, 0, 0, 1]], np.uint8),
    "values 255": np.pad(np.full((3, 4), 255, np.uint8), 1),
}


def cv2_contours(m: np.ndarray) -> list[np.ndarray]:
    return list(cv2.findContours(np.asarray(m, np.uint8), cv2.RETR_EXTERNAL, cv2.CHAIN_APPROX_SIMPLE)[0])


def assert_same(out, ref):
    assert len(out) == len(ref)
    for a, b in zip(out, ref):
        assert a.dtype == np.int32 and a.shape == b.shape
        np.testing.assert_array_equal(a, b)


@pytest.fixture(scope="module")
def native(tmp_path_factory):
    """The card library's contour walk (``csrc/contours.cu``, host C++
    only), built here with g++ and typed as ``kernels/build.py`` types it."""
    gxx = shutil.which("g++")
    if gxx is None:
        pytest.skip("needs g++ to build the host C++ walk")
    lib = tmp_path_factory.mktemp("contours") / "libcontours.so"
    res = subprocess.run([gxx, "-x", "c++", "-std=c++17", "-O2", "-shared", "-fPIC", "-o", str(lib),
                          str(kbuild.CSRC / "contours.cu")], capture_output=True, text=True, timeout=300)
    assert res.returncode == 0, res.stderr[-2000:]
    fn = ctypes.CDLL(str(lib)).fce_find_contours
    fn.argtypes, fn.restype = kbuild.SIGNATURES["fce_find_contours"], ctypes.c_int
    return SimpleNamespace(fce_find_contours=fn)


@pytest.fixture(params=["cpu", "cuda"])
def device(request, monkeypatch):
    """Each walk: the plain Python one, and the C++ one the card's library holds."""
    if request.param == "cuda":
        lib = request.getfixturevalue("native")
        monkeypatch.setattr(kbuild, "library", lambda: lib)
    return request.param


@pytest.mark.parametrize("kind", KINDS)
def test_contours_match_cv2(kind, device):
    for m in masks(kind):
        assert_same(find_contours_external(m, device), cv2_contours(m))
        assert_same(find_contours_external(m.astype(bool), device), cv2_contours(m))


@pytest.mark.parametrize("name", list(HAND))
def test_contours_hand_cases(name, device):
    m = HAND[name]
    assert_same(find_contours_external(m, device), cv2_contours(m))


def test_contours_of_a_strided_mask_and_the_room_asked_for(native, monkeypatch):
    """A view into a larger array, and more outlines and points than the
    wrapper's first buffers hold (it asks for the room and calls again)."""
    monkeypatch.setattr(kbuild, "library", lambda: native)
    big = (np.random.RandomState(9).rand(90, 120) < 0.5).astype(np.uint8)
    view = big[5:80, 7:110]
    ref = cv2_contours(np.ascontiguousarray(view))
    assert len(ref) > 16 and sum(len(c) for c in ref) > 256
    assert_same(find_contours_external(view, "cuda"), ref)


@pytest.mark.parametrize("kind", KINDS)
def test_contour_area_matches_cv2(kind):
    for m in masks(kind, 20):
        for c in cv2_contours(m):
            assert contour_area(c) == cv2.contourArea(c)
    assert contour_area(np.zeros((0, 1, 2), np.int32)) == 0.0


def _seg_masks(n: int = 6, h: int = 60, w: int = 80) -> np.ndarray:
    """Detection masks: filled blobs, some in two parts, one empty."""
    rng = np.random.RandomState(3)
    out = np.zeros((n, h, w), bool)
    for i in range(n - 1):
        m = np.zeros((h, w), np.uint8)
        for _ in range(1 + i % 3):
            cv2.ellipse(m, (int(rng.randint(5, w - 5)), int(rng.randint(5, h - 5))),
                        (int(rng.randint(2, 15)), int(rng.randint(2, 15))), float(rng.randint(0, 180)), 0, 360, 1, -1)
        out[i] = m > 0
    return out


@pytest.mark.parametrize("strategy", ["all", "largest"])
def test_masks2segments_match_jax(strategy):
    m = _seg_masks()
    out, ref = masks2segments(m, strategy, device="cpu"), jax_masks2segments(m, strategy)
    assert len(out) == len(ref)
    for a, b in zip(out, ref):
        assert a.dtype == np.float32
        np.testing.assert_array_equal(a, b)


def test_masks_outlines_and_summary_match_jax():
    m = _seg_masks()
    rng = np.random.RandomState(4)
    boxes = np.concatenate([rng.rand(len(m), 4) * 50, rng.rand(len(m), 1), rng.randint(0, 2, (len(m), 1))], 1)
    boxes = boxes.astype(np.float32)
    img = np.zeros((60, 80, 3), np.uint8)
    names = {0: "a", 1: "b"}
    ref = JaxResults(img, "x", names, boxes=boxes, masks=m)
    out = Results(img, "x", names, boxes=boxes, masks=m, device="cpu")
    for a, b in zip(out.masks.xy, ref.masks.xy):
        assert a.dtype == np.float32
        np.testing.assert_array_equal(a, b)
    assert len(out.masks.xy[-1]) == 0
    for normalize in (False, True):
        assert out.summary(normalize=normalize) == ref.summary(normalize=normalize)
    assert out.to_json() == ref.to_json()
    assert "segments" in json.loads(out.to_json())[0]
