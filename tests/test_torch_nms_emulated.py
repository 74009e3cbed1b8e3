"""The CUDA NMS kernels' own source (``csrc/nms.cu``) run on the CPU: g++
compiles it against a stand-in for the CUDA runtime (``tests/cuda_emu``)
that runs one thread per CUDA thread, with the warp votes and shuffles
emulated and the float intrinsics as plain float operations (no FMA
contraction), so the sort, the IoU bitmask and the one-warp scan are held
against ``pick_suppress_reference`` without a card. The cp.async helpers are
swapped for copies. idx and ok must be equal, element for element.
"""

import re
import subprocess
from pathlib import Path

import numpy as np
import pytest
import torch

from cuda_emu.emulate import CSRC, build, emulated
from fce_yolo_tpu_torch.ops.nms import K_MAX, mask_words, pick_suppress_reference


def _candidates(rng, b, k):
    """tests/test_pallas_nms.py's generator: random boxes, sorted scores, valid > 0.3."""
    centers = rng.uniform(50, 500, (b, k, 2))
    wh = rng.uniform(10, 80, (b, k, 2))
    boxes = np.concatenate([centers - wh / 2, centers + wh / 2], -1).astype(np.float32)
    scores = np.sort(rng.rand(b, k).astype(np.float32), axis=1)[:, ::-1].copy()
    return boxes, scores, scores > 0.3


def _ties(rng, b, k):
    """Duplicate boxes with equal scores, and unsorted scores full of ties."""
    boxes, scores, _ = _candidates(rng, b, k)
    boxes[:, 1::2] = boxes[:, 0:k - 1:2]  # each odd slot copies its even neighbour
    scores = np.round(rng.rand(b, k) * 8).astype(np.float32) / 8
    return boxes, scores, scores > 0.2


def _signed_zeros(rng, b, k):
    """Scores of -0.0 and +0.0 (equal to argmax, apart in their bits) among a
    few others, on boxes that overlap heavily."""
    boxes, _, _ = _candidates(rng, b, k)
    boxes = boxes * np.float32(0.3)
    scores = rng.choice(np.array([-0.0, 0.0, 0.25, -0.5], np.float32), (b, k), p=[0.4, 0.4, 0.1, 0.1])
    return boxes, scores, rng.rand(b, k) > 0.1


def _no_valid(rng, b, k):
    return np.zeros((b, k, 4), np.float32), np.zeros((b, k), np.float32), np.zeros((b, k), bool)


def _few_valid(rng, b, k):
    """Unsorted scores with only the 32 highest valid (a trained model at conf 0.25)."""
    boxes, _, _ = _candidates(rng, b, k)
    scores = rng.rand(b, k).astype(np.float32)
    return boxes, scores, scores >= np.sort(scores, axis=1)[:, -32:-31]


def _all_valid(rng, b, k):
    boxes, scores, _ = _candidates(rng, b, k)
    return boxes, scores, np.ones((b, k), bool)


# name: (generator, B, K, max_det)
CASES = {
    "random": (_candidates, 3, 300, 300),
    "ties": (_ties, 3, 300, 300),
    "signed_zeros": (_signed_zeros, 2, 64, 64),
    "no_valid": (_no_valid, 2, 100, 300),
    "few_valid": (_few_valid, 3, 300, 300),
    "k1": (_candidates, 2, 1, 300),
    "k37": (_candidates, 3, 37, 300),
    "max_det_below_kept": (_candidates, 2, 300, 5),
    # more than 32 bitset words: each lane holds a second word
    "k1100_all_valid": (_all_valid, 1, 1100, 1100),
}


def _emulated_source() -> str:
    src = emulated((CSRC / "nms.cu").read_text(), {
        "cp_async4": "std::memcpy(g_smem + dst, src, 4);",
        "cp_async16": "std::memcpy(g_smem + dst, src, 16);",
    })
    return re.sub(r"(\w+)<<<(\w+), (\w+), (\w+), (\w+)>>>\(", r"emu_launch(\2, \3, \4, \1, ", src)


@pytest.fixture(scope="module")
def emulator(tmp_path_factory):
    return build(tmp_path_factory.mktemp("nms_emu"), "nms_main.cpp", "nms", _emulated_source())


def _run(exe: Path, boxes, scores, valid, iou: float, max_det: int, words: int | None = None):
    d = exe.parent
    b, k = scores.shape
    boxes.astype(np.float32).tofile(d / "boxes.bin")
    scores.astype(np.float32).tofile(d / "scores.bin")
    valid.astype(np.uint8).tofile(d / "valid.bin")
    args = [b, k, max_det, repr(float(iou)), mask_words(k) if words is None else words]
    res = subprocess.run([str(exe), *map(str, args), *(str(d / f) for f in
                          ("boxes.bin", "scores.bin", "valid.bin", "idx.bin", "ok.bin"))],
                         capture_output=True, text=True, timeout=600)
    if res.returncode != 0:
        return res, None, None
    idx = np.fromfile(d / "idx.bin", np.int32).reshape(b, max_det)
    ok = np.fromfile(d / "ok.bin", np.uint8).reshape(b, max_det)
    return res, idx, ok


def _assert_matches_reference(exe, boxes, scores, valid, iou, max_det):
    res, idx, ok = _run(exe, boxes, scores, valid, iou, max_det)
    assert res.returncode == 0, res.stderr[-3000:]
    ref_idx, ref_ok = pick_suppress_reference(*(torch.from_numpy(a) for a in (boxes, scores, valid)), iou, max_det)
    np.testing.assert_array_equal(ok, ref_ok.numpy().astype(np.uint8))
    np.testing.assert_array_equal(idx, ref_idx.numpy())
    return int(ref_ok.sum())


@pytest.mark.parametrize("iou", [0.45, 0.7])
@pytest.mark.parametrize("case", list(CASES))
def test_emulated_kernel_matches_reference(emulator, case, iou):
    make, b, k, max_det = CASES[case]
    kept = _assert_matches_reference(emulator, *make(np.random.RandomState(k), b, k), iou, max_det)
    if case == "max_det_below_kept":
        assert kept == b * max_det
    if case == "k1100_all_valid":
        assert kept > 1024 // 3  # the walk goes well past the first 32 bitset words


@pytest.mark.parametrize("iou", [0.0, -0.5])
def test_emulated_kernel_thresholds_at_and_below_zero(emulator, iou):
    """At thres 0 any overlap kills and a zero intersection does not; below 0
    every candidate dies with the first pick (0 / den > thres), so the
    division is skipped only for thres >= 0."""
    kept = _assert_matches_reference(emulator, *_candidates(np.random.RandomState(5), 2, 200), iou, 300)
    if iou < 0:
        assert kept == 2


def at_threshold(seed: int, below: bool, k: int = 64):
    """Boxes 0 and 1 overlap each other and nothing else (the rest sit apart
    on a grid); the threshold is their IoU as the plain version rounds it, so
    box 1 survives, or one float below it, so box 1 is killed."""
    rng = np.random.RandomState(seed)
    cells = np.arange(k, dtype=np.float32) * 100
    boxes = np.stack([cells, cells, cells + 20, cells + 20], -1)[None].astype(np.float32)
    wh = rng.uniform(20, 60, (2, 2)).astype(np.float32)
    corner = np.float32(9000) + np.concatenate([[0, 0], rng.uniform(-8, 8, 2)]).astype(np.float32).reshape(2, 2)
    boxes[0, :2] = np.concatenate([corner, corner + wh], -1)
    scores = np.linspace(1, 0.5, k, dtype=np.float32)[None]
    (a, b) = boxes[0, :2]
    area = [np.maximum(v[2] - v[0], np.float32(0)) * np.maximum(v[3] - v[1], np.float32(0)) for v in (a, b)]
    iw = np.maximum(np.minimum(a[2], b[2]) - np.maximum(a[0], b[0]), np.float32(0))
    ih = np.maximum(np.minimum(a[3], b[3]) - np.maximum(a[1], b[1]), np.float32(0))
    inter = iw * ih
    thr = inter / (area[0] + area[1] - inter + np.float32(1e-7))
    assert 0.05 < thr < 0.95
    if below:
        thr = np.nextafter(thr, np.float32(0))
    return boxes, scores, np.ones((1, k), bool), float(thr)


@pytest.mark.parametrize("below", [False, True])
@pytest.mark.parametrize("seed", [0, 1, 2])
def test_emulated_kernel_iou_at_the_threshold(emulator, seed, below):
    """A threshold equal to a pair's rounded IoU, or one float below it: the
    kernel takes the exact division there and keeps, or kills, the second."""
    boxes, scores, valid, thr = at_threshold(seed, below)
    kept = _assert_matches_reference(emulator, boxes, scores, valid, thr, 64)
    assert kept == 63 if below else kept == 64


def test_emulated_kernel_refuses_out_of_range(emulator):
    """Past the scan's bitset (K > 10240) the entry point returns an error
    before any launch; a mask row length other than the kernel's is caught
    by the driver."""
    boxes, scores, valid = _candidates(np.random.RandomState(0), 1, K_MAX + 1)
    res, _, _ = _run(emulator, boxes, scores, valid, 0.45, 300)
    assert res.returncode == 3
    boxes, scores, valid = _candidates(np.random.RandomState(0), 1, 40)
    res, _, _ = _run(emulator, boxes, scores, valid, 0.45, 300, words=mask_words(40) + 4)
    assert res.returncode == 4
