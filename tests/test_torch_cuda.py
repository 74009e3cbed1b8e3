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


@pytest.mark.cuda
def test_stem_kernel_tile_choice(cuda):
    """The kernel picks its tile from the device's shared memory: the m form
    at 640 px (C3k, halo 4) runs at a 4 x 4 tile and matches the plain
    version; the l form (two C3k repeats, halo 8) fits no tile and raises
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


@pytest.mark.cuda
@pytest.mark.parametrize("make", [_candidates, _ties, _no_valid])
@pytest.mark.parametrize("k", [1024, 1000, 37])
def test_nms_kernel_matches_reference(cuda, make, k):
    args = [torch.from_numpy(a) for a in make(np.random.RandomState(k), 4, k)]
    for iou in (0.45, 0.7):
        ref = pick_suppress_reference(*args, iou, 300)
        before = pick_suppress.launches
        out = pick_suppress(*(a.to(cuda) for a in args), iou_thres=iou, max_det=300)
        assert pick_suppress.launches == before + 1
        for r, o in zip(ref, out):
            np.testing.assert_array_equal(o.cpu().numpy(), r.numpy())


@pytest.mark.cuda
def test_predict_on_card_takes_both_kernels(cuda):
    y = YOLO("yolo11s-fce.yaml", device=cuda).to(torch.bfloat16)
    rng = np.random.RandomState(0)
    imgs = [rng.randint(0, 256, s, np.uint8) for s in ((96, 128, 3), (128, 80, 3), (160, 160, 3))] * 2
    stem0, nms0 = S.fused_stem.launches, pick_suppress.launches
    res = y.predict(imgs, imgsz=160, batch=4)
    assert S.fused_stem.launches == stem0 + 2 and pick_suppress.launches == nms0 + 2
    assert len(res) == 6 and all(np.isfinite(r.boxes.data).all() for r in res)
