"""The port's CUDA kernels vs their plain versions on a card. Every test
here needs a CUDA device and skips without one. The file imports no JAX (the
GPU machine has none), so it runs there on its own:

    python -m pytest tests/test_torch_cuda.py --noconftest -p no:cacheprovider -q

Tolerances: the stem kernel within 0.02 * max|ref| of the f32 plain
version with a uniform per-row error (bf16 between stages, the JAX kernel
test's bound); the NMS kernel's idx/ok exactly equal to the plain version's.
"""

import numpy as np
import pytest
import torch

from fce_yolo_tpu_torch import YOLO
from fce_yolo_tpu_torch.ops import stem as S
from fce_yolo_tpu_torch.ops.nms import pick_suppress, pick_suppress_reference
from test_torch_nms_emulated import at_threshold

SHAPES = [  # the JAX kernel test's five shapes (test_pallas_stem.py:41-47)
    (64, 64, False, 1), (64, 64, True, 1), (128, 128, False, 1), (128, 192, False, 2), (128, 128, True, 2),
]


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: run on the GPU machine")
    return torch.device("cuda")


def _stem_case(spec, device, batch=2):
    rng = np.random.RandomState(0)
    folded = [torch.from_numpy(rng.normal(0, 0.1, s).astype(np.float32)).to(torch.bfloat16).to(device)
              for s in S.folded_shapes(spec)]
    x = torch.from_numpy(rng.randint(0, 256, (batch, spec.H, spec.W, 3)).astype(np.uint8)).to(device)
    return S.stem_weights(folded, spec), x


def _assert_stem_matches_reference(spec, weights, x):
    before = S.fused_stem.launches
    out = S.fused_stem(x, weights, spec)
    torch.cuda.synchronize()
    assert S.fused_stem.launches == before + 1 and out.dtype == torch.bfloat16
    ref = S.stem_reference(x.cpu(), [w.cpu() for w in weights.arrays], spec).numpy()
    d = np.abs(out.float().cpu().numpy() - ref)
    scale = np.abs(ref).max()
    assert d.max() / scale < 0.02
    per_row = d.max(axis=(0, 2, 3)) / scale
    assert per_row.max() < 3 * max(np.median(per_row), 1e-6)


@pytest.mark.cuda
@pytest.mark.parametrize("H,W,c3k,n", SHAPES)
def test_stem_kernel_matches_reference(cuda, H, W, c3k, n):
    spec = S.StemSpec(H=H, W=W, c0=16, c1=32, c2=64, ch=16, n=n, c3k=c3k)
    _assert_stem_matches_reference(spec, *_stem_case(spec, cuda))


# (H, W, c3k, n, batch): widths that are no multiple of the 32-column strip,
# images shorter than one step (2 output rows), B = 1 and B = 3
EDGES = [
    (64, 200, False, 1, 1), (64, 200, True, 1, 3), (4, 96, False, 1, 3), (8, 64, True, 1, 1),
    (40, 136, False, 2, 3),
]


@pytest.mark.cuda
@pytest.mark.parametrize("H,W,c3k,n,batch", EDGES)
def test_stem_kernel_edges(cuda, H, W, c3k, n, batch):
    spec = S.StemSpec(H=H, W=W, c0=16, c1=32, c2=64, ch=16, n=n, c3k=c3k)
    _assert_stem_matches_reference(spec, *_stem_case(spec, cuda, batch=batch))


@pytest.mark.cuda
@pytest.mark.parametrize("spec", [
    S.StemSpec(H=640, W=640, c0=32, c1=64, c2=128, ch=32, n=1, c3k=False),  # s: weights resident
    S.StemSpec(H=640, W=640, c0=64, c1=128, c2=256, ch=64, n=1, c3k=True),  # m: partly read from global
], ids=["s", "m"])
def test_stem_kernel_full_width(cuda, spec):
    _assert_stem_matches_reference(spec, *_stem_case(spec, cuda, batch=2))


@pytest.mark.cuda
def test_stem_kernel_tile_choice(cuda):
    """The kernel picks its strip from the device's shared memory: the m form
    at 640 px (C3k, halo 4) runs at a 16-column strip and matches the plain
    version; the l form (two C3k repeats, halo 8) fits no strip and raises
    without a launch."""
    m = S.StemSpec(H=640, W=640, c0=64, c1=128, c2=256, ch=64, n=1, c3k=True)
    _assert_stem_matches_reference(m, *_stem_case(m, cuda, batch=1))
    big = S.StemSpec(H=640, W=640, c0=64, c1=128, c2=256, ch=64, n=2, c3k=True)
    weights, x = _stem_case(big, cuda, batch=1)
    before = S.fused_stem.launches
    with pytest.raises(RuntimeError, match="fce_fused_stem"):
        S.fused_stem(x, weights, big)
    assert S.fused_stem.launches == before


def _candidates(rng, b, k):
    centers = rng.uniform(50, 500, (b, k, 2))
    wh = rng.uniform(10, 80, (b, k, 2))
    boxes = np.concatenate([centers - wh / 2, centers + wh / 2], -1).astype(np.float32)
    scores = np.sort(rng.rand(b, k).astype(np.float32), axis=1)[:, ::-1].copy()
    return boxes, scores, scores > 0.3


def _ties(rng, b, k):
    boxes, scores, _ = _candidates(rng, b, k)
    boxes[:, 1::2] = boxes[:, 0:k - 1:2]  # each odd slot copies its even neighbour
    scores = np.round(rng.rand(b, k) * 8).astype(np.float32) / 8
    return boxes, scores, scores > 0.2


def _no_valid(rng, b, k):
    return np.zeros((b, k, 4), np.float32), np.zeros((b, k), np.float32), np.zeros((b, k), bool)


def _few_valid(rng, b, k):
    """Only the 32 highest scores valid (a trained model at conf 0.25)."""
    boxes, scores, valid = _candidates(rng, b, k)
    valid[:, 32:] = False
    return boxes, scores, valid


def _signed_zeros(rng, b, k):
    """Scores of -0.0 and +0.0 (equal to argmax, apart in their bits) on boxes that overlap heavily."""
    boxes, _, _ = _candidates(rng, b, k)
    boxes *= np.float32(0.3)
    scores = rng.choice(np.array([-0.0, 0.0, 0.25, -0.5], np.float32), (b, k), p=[0.4, 0.4, 0.1, 0.1])
    return boxes, scores, rng.rand(b, k) > 0.1


def _assert_nms_matches_reference(cuda, boxes, scores, valid, iou, max_det=300):
    args = [torch.from_numpy(a) for a in (boxes, scores, valid)]
    ref = pick_suppress_reference(*args, iou, max_det)
    before = pick_suppress.launches
    out = pick_suppress(*(a.to(cuda) for a in args), iou_thres=iou, max_det=max_det)
    assert pick_suppress.launches == before + 1
    for r, o in zip(ref, out):
        np.testing.assert_array_equal(o.cpu().numpy(), r.numpy())


@pytest.mark.cuda
@pytest.mark.parametrize("make", [_candidates, _ties, _no_valid, _few_valid, _signed_zeros])
@pytest.mark.parametrize("k", [1024, 1000, 37, 4096])
@pytest.mark.parametrize("b", [1, 4, 64])
def test_nms_kernel_matches_reference(cuda, make, k, b):
    boxes, scores, valid = make(np.random.RandomState(k + b), b, k)
    for iou in (0.45, 0.7):
        _assert_nms_matches_reference(cuda, boxes, scores, valid, iou)


@pytest.mark.cuda
@pytest.mark.parametrize("below", [False, True])
@pytest.mark.parametrize("seed", [0, 1, 2])
def test_nms_kernel_iou_at_the_threshold(cuda, seed, below):
    """A threshold equal to a pair's rounded IoU, or one float below it: the
    kernel's exact division decides, as compiled for the card."""
    boxes, scores, valid, thr = at_threshold(seed, below)
    _assert_nms_matches_reference(cuda, boxes, scores, valid, thr, max_det=64)


@pytest.mark.cuda
def test_nms_kernel_top_of_range(cuda):
    """K = 9685 (the range of the one-block-per-image kernel this design
    replaced) and K = 10240 (the top of the range: the scan's bitset of 10
    words a lane), every candidate valid so the walk reaches the last words;
    beyond it the wrapper raises before any launch."""
    for k in (9685, 10240):
        boxes, scores, _ = _candidates(np.random.RandomState(k), 2, k)
        _assert_nms_matches_reference(cuda, boxes, scores, np.ones((2, k), bool), 0.7, max_det=k)
    boxes, scores, valid = (torch.from_numpy(a).to(cuda) for a in _candidates(np.random.RandomState(0), 1, 10241))
    before = pick_suppress.launches
    with pytest.raises(ValueError, match="outside the kernel's range"):
        pick_suppress(boxes, scores, valid)
    assert pick_suppress.launches == before


@pytest.mark.cuda
def test_predict_on_card_takes_both_kernels(cuda):
    y = YOLO("yolo11s-fce.yaml", device=cuda).to(torch.bfloat16)
    rng = np.random.RandomState(0)
    imgs = [rng.randint(0, 256, s, np.uint8) for s in ((96, 128, 3), (128, 80, 3), (160, 160, 3))] * 2
    stem0, nms0 = S.fused_stem.launches, pick_suppress.launches
    res = y.predict(imgs, imgsz=160, batch=4)
    assert S.fused_stem.launches == stem0 + 2 and pick_suppress.launches == nms0 + 2
    assert len(res) == 6 and all(np.isfinite(r.boxes.data).all() for r in res)
