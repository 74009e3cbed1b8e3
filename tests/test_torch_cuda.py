"""The port's CUDA kernels vs their plain versions on a card, and the
validator and the loss on the card. Every test here needs a CUDA device and
skips without one. The file imports no JAX (the GPU machine has none), so it
runs there on its own:

    python -m pytest tests/test_torch_cuda.py --noconftest -p no:cacheprovider -q

Tolerances: the stem kernel within 0.02 * max|ref| of the f32 plain
version with a uniform per-row error (bf16 between stages, the JAX kernel
test's bound); the NMS kernel's idx/ok exactly equal to the plain version's,
and so the validator's metrics too; the loss on the card within 1e-4
relative of the CPU's (float32, sums in another order, the assigner's
overlaps stored in float32) and its gradient within 1e-4 of the largest; a
float32 train step (TF32 off) on the card within 1e-4 of the CPU's on the
loss parts and the BN statistics, and within 1e-3 of each leaf's largest
update on the parameters; training BatchNorm's running statistics on the
card within 1e-5 of flax's rule applied in float64; the segment, pose and
OBB heads on the card (float32, TF32 off) within 1e-3 of the largest CPU
output, and their NMS kernel's outputs in val (masks, keypoints) equal to
the plain version's; their losses on the card within 1e-3 relative of the
CPU's and their gradients within 1e-3 of the largest; ``YOLO.track`` on
the card launching both kernels once a frame, its tracks bit-equal with
the plain NMS; an MJPEG AVI's frames decoded on the card byte-equal to the
plain path; yolo11n-cls on the card (float32, TF32 off) within 1e-3 of the
largest CPU logit and its probabilities on an AVI within 1e-4; the JPEG
writer's forward-DCT kernel's coefficients exactly equal to its plain
version's and its files byte-equal to the plain writer's; the card
library's contour walk equal to the plain walk; yolov10n's ``preds6`` on
the card within 1e-4 of the CPU's scores, classes in the same order where
no two scores lie within 1e-5, with no NMS launched; the NMS kernel's
detections on test-time augmentation's candidates equal to the plain
version's; yolo11-cls-resnet18's logits within 1e-3 of the CPU's; every
committed WebP fixture decoded on the card with the SHA-256 of cv2's decode,
and the WebP colour kernel exactly equal to its plain version; the NMS
custom op (``torch.ops.fce_yolo_tpu_torch.pick_suppress``) exactly equal to
the plain version, and a ``torch_export`` program with NMS inside, exported
on the CPU and loaded on the card, launching the kernel once a call with
idx/ok equal to the plain version's on the candidates it gave.
"""

import struct
import zlib

import numpy as np
import pytest
import torch

from fce_yolo_tpu_torch import YOLO
from fce_yolo_tpu_torch.engine.validator import DetectionValidator
from fce_yolo_tpu_torch.nn.model import init_weights
from fce_yolo_tpu_torch.ops import nms as nms_ops
from fce_yolo_tpu_torch.ops import stem as S
from fce_yolo_tpu_torch.ops.nms import pick_suppress, pick_suppress_reference
from fce_yolo_tpu_torch.train.loss import DetectionLossCfg, LossState, detection_loss
from fce_yolo_tpu_torch.utils.metrics import ConfusionMatrix, DetMetrics
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


@pytest.mark.cuda
@pytest.mark.parametrize("tracker", ["bytetrack.yaml", "botsort.yaml", "reid"])
def test_track_on_card_takes_both_kernels_each_frame(cuda, tracker, monkeypatch, tmp_path):
    """``YOLO.track`` of a bf16 model on the card: the stem and the NMS kernel
    once a frame (B=1), and the same tracks bit for bit with the plain NMS
    swapped into ``ops.nms``."""
    if tracker == "reid":
        tracker = str(tmp_path / "reid.yaml")
        (tmp_path / "reid.yaml").write_text("tracker_type: botsort\nwith_reid: True\n")
    y = YOLO("yolo11s-fce.yaml", device=cuda)
    init_weights(y.model, torch.Generator().manual_seed(0), bias_prior=False)  # scores near 0.5: detections
    y.to(torch.bfloat16)
    rng = np.random.RandomState(0)
    base = rng.randint(0, 256, (150, 220, 3), np.uint8)
    frames = [np.ascontiguousarray(base[:, 3 * t: 3 * t + 200]) for t in range(5)]
    stem0, nms0 = S.fused_stem.launches, pick_suppress.launches
    out = y.track(frames, tracker=tracker, imgsz=160)
    assert S.fused_stem.launches == stem0 + 5 and pick_suppress.launches == nms0 + 5
    assert len(out) == 5 and all(t.shape[1] == 7 and np.isfinite(t).all() for _, t in out)
    assert sum(len(t) for _, t in out) > 0
    monkeypatch.setattr(nms_ops, "pick_suppress", lambda b, s, v, iou_thres, max_det:
                        pick_suppress_reference(b, s, v, iou_thres, max_det))
    plain = y.track(frames, tracker=tracker, imgsz=160)
    for (_, a), (_, b) in zip(out, plain):
        np.testing.assert_array_equal(a, b)


def _write_png(path, rgb):
    """An 8-bit RGB PNG, no row filter, written with zlib."""
    h, w, _ = rgb.shape

    def chunk(kind, body):
        return struct.pack(">I", len(body)) + kind + body + struct.pack(">I", zlib.crc32(kind + body))

    raw = np.concatenate([np.zeros((h, 1), np.uint8), rgb.reshape(h, -1)], 1).tobytes()
    path.write_bytes(b"\x89PNG\r\n\x1a\n" + chunk(b"IHDR", struct.pack(">IIBBBBB", w, h, 8, 2, 0, 0, 0))
                     + chunk(b"IDAT", zlib.compress(raw)) + chunk(b"IEND", b""))


def _val_dataset(root, n=6, nc=80):
    """n PNG images of 120-200 px with rectangles of classes 0-2; nc class names."""
    rng = np.random.RandomState(0)
    (root / "images" / "val").mkdir(parents=True)
    (root / "labels" / "val").mkdir(parents=True)
    for i in range(n):
        h, w = rng.randint(120, 201, 2)
        img = np.full((h, w, 3), 60, np.uint8)
        lines = []
        for _ in range(rng.randint(1, 4)):
            k = rng.randint(0, 3)
            bw, bh = rng.uniform(0.2, 0.4), rng.uniform(0.2, 0.4)
            cx, cy = rng.uniform(bw / 2, 1 - bw / 2), rng.uniform(bh / 2, 1 - bh / 2)
            img[int((cy - bh / 2) * h): int((cy + bh / 2) * h), int((cx - bw / 2) * w): int((cx + bw / 2) * w)] = 200
            lines.append(f"{k} {cx:.6f} {cy:.6f} {bw:.6f} {bh:.6f}")
        _write_png(root / "images" / "val" / f"{i}.png", img)
        (root / "labels" / "val" / f"{i}.txt").write_text("\n".join(lines) + "\n")
    names = "".join(f"  - c{i}\n" for i in range(nc))
    (root / "data.yaml").write_text(f"path: {root}\nval: images/val\nnames:\n{names}")
    return str(root / "data.yaml")


@pytest.mark.cuda
def test_val_with_the_nms_kernel_matches_the_plain_version(cuda, tmp_path, monkeypatch):
    """YOLO.val on the card launches the NMS kernel once per batch at K=4096
    (525 anchors x 80 classes at 160 px); on the same candidates the kernel
    and the plain version give the same idx/ok and the same metrics."""
    data = _val_dataset(tmp_path)
    y = YOLO("yolo11n-fce.yaml", device=cuda)
    init_weights(y.model, torch.Generator().manual_seed(0), bias_prior=False)
    before = pick_suppress.launches
    res = y.val(data=data, imgsz=160, batch=4, verbose=False)
    assert pick_suppress.launches == before + 2 and len(res["metrics"].stats["conf"]) == 6

    val = DetectionValidator(y.model, y.names, imgsz=160, batch_size=4)
    sets = {k: (DetMetrics(names=y.names), ConfusionMatrix(names=y.names)) for k in ("kernel", "plain")}
    seen = {}

    def plain(boxes, scores, valid, iou_thres, max_det):
        seen["k"] = boxes.shape[1]
        return pick_suppress_reference(boxes, scores, valid, iou_thres, max_det)

    n = 0
    y.model.eval()
    for batch in val.get_dataloader(data):
        preds = val.forward(torch.from_numpy(batch["img"]).to(cuda))
        outs = {}
        for name, fn in (("kernel", pick_suppress), ("plain", plain)):
            monkeypatch.setattr(nms_ops, "pick_suppress", fn)
            outs[name] = {k: v.cpu().numpy() for k, v in val.nms(preds).items()}
        assert seen["k"] == 4096
        for k in outs["kernel"]:
            np.testing.assert_array_equal(outs["kernel"][k], outs["plain"][k], err_msg=k)
        for name, (m, cm) in sets.items():
            val._update_metrics(outs[name], batch, m, cm, None, n)
        n += batch["n_valid"]
    for m, _ in sets.values():
        m.process(nc=val.nc)
    assert sets["kernel"][0].mean_results() == sets["plain"][0].mean_results()
    np.testing.assert_array_equal(sets["kernel"][1].matrix, sets["plain"][1].matrix)


def _loss_case(seed, b=2, imgsz=256, nc=80, m=8):
    rng = np.random.RandomState(seed)
    feats = [rng.normal(0, 1.5, (b, 64 + nc, imgsz // s, imgsz // s)).astype(np.float32) for s in (8, 16, 32)]
    bboxes = np.concatenate([rng.uniform(0.2, 0.8, (b, m, 2)), rng.uniform(0.1, 0.4, (b, m, 2))], -1).astype(np.float32)
    mask = np.ones((b, m), bool)
    mask[0, m // 2:] = False
    bboxes[~mask] = 0
    return feats, {"cls": rng.randint(0, 3, (b, m)).astype(np.float32), "bboxes": bboxes, "mask": mask}


@pytest.mark.cuda
@pytest.mark.parametrize("iou_type", ["CIoU", "WIoU"])
def test_loss_on_the_card_matches_the_cpu(cuda, iou_type):
    cfg = DetectionLossCfg(nc=80, iou_type=iou_type, tal_dtype="float32")
    devices = {"cpu": torch.device("cpu"), "card": cuda}
    states = {k: LossState.init(d) for k, d in devices.items()}
    for step in range(3 if iou_type == "WIoU" else 1):
        feats, batch = _loss_case(step)
        out = {}
        for name, dev in devices.items():
            fs = [torch.from_numpy(f).to(dev).requires_grad_() for f in feats]
            targets = {k: torch.from_numpy(v).to(dev) for k, v in batch.items()}
            total, parts, states[name] = detection_loss(fs, targets, cfg, states[name])
            total.backward()
            out[name] = ({k: float(v.detach()) for k, v in parts.items()}, [f.grad.cpu().numpy() for f in fs])
        (p_cpu, g_cpu), (p_card, g_card) = out["cpu"], out["card"]
        assert p_card["fg_count"] == p_cpu["fg_count"] > 0
        for k in ("box", "cls", "dfl"):
            assert abs(p_card[k] - p_cpu[k]) <= 1e-4 * abs(p_cpu[k]), (k, p_card[k], p_cpu[k])
        for gc, gg in zip(g_card, g_cpu):
            np.testing.assert_allclose(gc, gg, rtol=0, atol=1e-4 * np.abs(gg).max())
        np.testing.assert_allclose(float(states["card"].wiou_loss_mean), float(states["cpu"].wiou_loss_mean),
                                   rtol=1e-5)


def _train_case(device, bf16=False, nbs=4, tal_dtype="bfloat16"):
    """yolo11n-fce at 128 px, B=4: SGD without warmup (every parameter moves), one step fires."""
    from fce_yolo_tpu_torch.train.optim import OptimCfg, Optimizer
    from fce_yolo_tpu_torch.train.trainer import create_train_state, make_train_step

    yolo = YOLO("yolo11n-fce.yaml", device=device)
    opt = Optimizer(OptimCfg(optimizer="SGD", batch_size=4, nbs=nbs, warmup_epochs=0.0, epochs=2,
                             steps_per_epoch=4, nc=80), yolo.model)
    state = create_train_state(yolo.model, opt)
    step = make_train_step(yolo.model, opt, DetectionLossCfg(nc=80, strides=tuple(yolo.strides), tal_dtype=tal_dtype),
                           bf16=bf16)
    return yolo, state, step


def _train_batch(device, seed=0):
    rng = np.random.RandomState(seed)
    cls, boxes, mask = np.zeros((4, 8), np.float32), np.zeros((4, 8, 4), np.float32), np.zeros((4, 8), bool)
    for i in range(4):
        k = rng.randint(1, 4)
        cls[i, :k] = rng.randint(0, 80, k)
        boxes[i, :k] = np.concatenate([rng.uniform(0.3, 0.7, (k, 2)), rng.uniform(0.1, 0.4, (k, 2))], 1)
        mask[i, :k] = True
    img = rng.randint(0, 256, (4, 128, 128, 3), np.uint8)
    return {k: torch.from_numpy(v).to(device) for k, v in (("img", img), ("cls", cls), ("bboxes", boxes),
                                                              ("mask", mask))}



@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("shape", [(2, 16, 3, 3), (16, 64, 80, 80)])
def test_batchnorm_on_the_card_keeps_flax_running_statistics(cuda, shape, dtype):
    """Training mode on the card, channels-last, as the bf16 train step
    feeds it: the running statistics are 0.97 * running + 0.03 * the biased
    batch statistics of the same input values (float64) within 1e-5 (the
    mean against the running standard deviation; the unbiased variance
    would be 1/17 of the batch term off at 2 x 3 x 3), the output within
    1e-5 (float32) or 1e-2 (bfloat16) of its largest value."""
    from fce_yolo_tpu_torch.nn.modules import BN_EPS, BN_MOMENTUM, BatchNorm2d

    x = (0.5 + 2.0 * torch.randn(shape, generator=torch.Generator().manual_seed(0))).to(dtype)
    m = BatchNorm2d(shape[1], eps=BN_EPS, momentum=BN_MOMENTUM).to(cuda).train()
    with torch.no_grad():
        m.running_mean.fill_(0.1)
        m.running_var.fill_(2.0)
    y = m(x.to(cuda).contiguous(memory_format=torch.channels_last))
    xd = x.double()
    var, mean = torch.var_mean(xd, dim=(0, 2, 3), correction=0)
    want_mean, want_var = 0.97 * 0.1 + 0.03 * mean, 0.97 * 2.0 + 0.03 * var
    assert float((m.running_mean.cpu().double() - want_mean).abs().max() / want_var.sqrt().min()) <= 1e-5
    assert float(((m.running_var.cpu().double() - want_var).abs() / want_var).max()) <= 1e-5
    ref = (xd - mean[:, None, None]) / (var[:, None, None] + BN_EPS).sqrt()
    assert y.dtype == dtype
    tol = 1e-5 if dtype == torch.float32 else 1e-2
    assert float((y.cpu().double() - ref).abs().max()) <= tol * float(ref.abs().max())

@pytest.mark.cuda
def test_bf16_train_step_on_the_card_moves_the_parameters(cuda):
    yolo, state, step = _train_case(cuda, bf16=True)
    before = [p.detach().clone() for p in state.params]
    state, m = step(state, _train_batch(cuda))
    assert m["finite"] and np.isfinite(float(m["loss"])) and state.optimizer.count == 1
    assert all(p.dtype == torch.float32 for p in state.params)  # float32 master weights
    moved = sum(not torch.equal(a, b) for a, b in zip(before, state.params))
    assert moved > 0.9 * len(before)
    assert all(bool(torch.isfinite(p).all()) for p in state.params)


@pytest.mark.cuda
def test_f32_train_step_on_the_card_matches_the_cpu(cuda):
    """One SGD step, training BN, TF32 off: loss parts within 1e-4 relative,
    each parameter's update within 1e-3 of its leaf's largest CPU update
    (plus one float32 ulp of the leaf's largest value, as both sides round
    p + update, and 1e-9), BN running statistics within 1e-4 (the mean
    against the running standard deviation)."""
    tf32 = torch.backends.cudnn.allow_tf32, torch.backends.cuda.matmul.allow_tf32
    torch.backends.cudnn.allow_tf32 = torch.backends.cuda.matmul.allow_tf32 = False
    try:
        out = {}
        for name, dev in (("cpu", torch.device("cpu")), ("card", cuda)):
            yolo, state, step = _train_case(dev, tal_dtype="float32")
            before = {k: v.detach().cpu().clone() for k, v in yolo.model.state_dict().items()}
            state, m = step(state, _train_batch(dev))
            out[name] = ({k: float(m[k]) for k in ("box", "cls", "dfl")},
                         {k: v.detach().cpu() for k, v in yolo.model.state_dict().items()})
    finally:
        torch.backends.cudnn.allow_tf32, torch.backends.cuda.matmul.allow_tf32 = tf32
    (p_cpu, s_cpu), (p_card, s_card) = out["cpu"], out["card"]
    for k in p_cpu:
        assert abs(p_card[k] - p_cpu[k]) <= 1e-4 * abs(p_cpu[k]), k
    for k, c in s_cpu.items():
        if k.endswith("num_batches_tracked"):
            continue
        a = s_card[k]
        if k.endswith("running_mean"):
            assert float((a - c).abs().max() / s_cpu[k.replace("mean", "var")].sqrt().min()) <= 1e-4, k
        elif k.endswith("running_var"):
            assert float(((a - c).abs() / c).max()) <= 1e-4, k
        else:  # both sides store p + update rounded to float32: one ulp of the largest |p| on top
            dp = float((c - before[k]).abs().max())
            ulp = float(torch.finfo(torch.float32).eps * before[k].abs().max())
            assert float((a - c).abs().max()) <= 1e-3 * dp + ulp + 1e-9, k


@pytest.mark.cuda
def test_rolled_back_step_leaves_the_card_state_untouched(cuda):
    yolo, state, step = _train_case(cuda)
    state, _ = step(state, _train_batch(cuda, seed=1))
    snap = ({k: v.clone() for k, v in yolo.model.state_dict().items()},
            [t.clone() for ts in state.optimizer.state.values() for t in ts], [t.clone() for t in state.ema.params],
            state.loss_state.wiou_loss_mean.clone(), state.optimizer.count)
    bad = _train_batch(cuda, seed=2)
    bad["img"] = bad["img"].float() / 255
    bad["img"][0, 5, 5, 0] = float("nan")
    state, m = step(state, bad)
    assert not m["finite"] and state.step == 2 and state.optimizer.count == snap[4]
    for k, v in yolo.model.state_dict().items():
        assert torch.equal(v, snap[0][k]), k
    assert all(torch.equal(a, b) for a, b in zip(snap[1], [t for ts in state.optimizer.state.values() for t in ts]))
    assert all(torch.equal(a, b) for a, b in zip(snap[2], state.ema.params))
    assert torch.equal(snap[3], state.loss_state.wiou_loss_mean)


@pytest.mark.cuda
def test_experiment_trainer_on_the_card_takes_the_nms_kernel(cuda, tmp_path, monkeypatch):
    """``ExperimentTrainer`` (fce_wiou, n, 64 px, B=4) with stage 1 and stage
    2 of one epoch each, on the card by default: each stage's val launches
    the NMS kernel once per batch, stage 2 starts from stage 1's best, and
    the best checkpoint echoes WIoU."""
    from dataclasses import replace

    from fce_yolo_tpu_torch.experiments import MODEL_CONFIGS, StageConfig, TrainConfig, validate_run
    from fce_yolo_tpu_torch.experiments.trainer import ExperimentTrainer

    data = _val_dataset(tmp_path / "data", n=8, nc=3)
    text = (tmp_path / "data" / "data.yaml").read_text()
    (tmp_path / "data" / "data.yaml").write_text(text.replace("val: images/val", "train: images/val\nval: images/val"))
    stage = StageConfig(epochs=1, patience=50, lr0=0.001, cos_lr=True, close_mosaic=0)
    mc = replace(MODEL_CONFIGS["fce_wiou"], stage1=stage, stage2=stage)
    cfg = TrainConfig(data=data, batch=4, imgsz=64, workers=2, project=str(tmp_path / "runs"), verbose=False,
                      extra_args={"mosaic": 0.0, "warmup_epochs": 0.0})
    before = pick_suppress.launches
    out = ExperimentTrainer(mc, scale="n", train_cfg=cfg).train()
    assert pick_suppress.launches == before + 2 * 2  # 8 val images at B=4, one val a stage
    assert out["stage1"]["save_dir"].endswith("fce_wiou_n_stage1") and out["save_dir"].endswith("fce_wiou_n_stage2")
    assert validate_run(out["save_dir"], 1, "WIoU") == []
    assert all(np.isfinite(out["stage2"]["results"][0][k]) for k in ("train/box_loss", "train/cls_loss"))


def _jpeg_writer():
    """chip_smoke.py's baseline JPEG writer (the card machine has no encoder)."""
    import sys
    from pathlib import Path

    sys.path.insert(0, str(Path(__file__).resolve().parent.parent))
    import chip_smoke

    return chip_smoke.jpeg_bytes


def _jpeg_image(rng, h, w):
    y, x = np.mgrid[:h, :w]
    img = np.stack([x * 255 // max(w - 1, 1), y * 255 // max(h - 1, 1), (x + y) * 9 % 256], 2)
    return np.clip(img + rng.randint(-30, 31, img.shape), 0, 255).astype(np.uint8)


JPEG_CASES = [(s, q, r, hw) for s in ("444", "422", "420", "440", "411", "gray")
              for q, r, hw in ((50, 0, (1, 1)), (75, 1, (7, 9)), (95, 7, (17, 33)), (100, 0, (33, 47)))]
# non-interleaved scans of components sampled above 1x1: gray at 2x2 and 4x1, a scan per component
JPEG_CASES += [("gray420", 90, 0, (64, 64)), ("gray411", 75, 7, (17, 33)), ("sep420", 90, 7, (33, 47)),
               ("sep411", 95, 0, (64, 64))]


@pytest.mark.cuda
@pytest.mark.parametrize("sampling,quality,restart,hw", JPEG_CASES)
def test_jpeg_kernels_match_the_plain_path(cuda, sampling, quality, restart, hw):
    """decode_jpeg on the card (host entropy decode, both kernels) equals
    the plain path byte for byte, and launches each kernel once."""
    from fce_yolo_tpu_torch.data import jpeg as J

    rgb = _jpeg_image(np.random.RandomState(quality), *hw)
    buf = _jpeg_writer()(rgb[..., 0] if sampling.startswith("gray") else rgb, quality,
                         sampling[-3:] if sampling[-3:].isdigit() else "444", restart, 6,
                         interleave=not sampling.startswith("sep"))
    before = (J.jpeg_idct.launches, J.jpeg_color.launches)
    out = J.decode_jpeg(buf, "case.jpg", cuda)
    assert (J.jpeg_idct.launches, J.jpeg_color.launches) == (before[0] + 1, before[1] + 1)
    np.testing.assert_array_equal(out, J.decode_jpeg_reference(buf, "case.jpg"))


@pytest.mark.cuda
def test_jpeg_kernel_wrappers_match_the_plain_stages(cuda):
    """The two kernels alone, on the C decoder's coefficients of a 480 x 641
    4:2:0 image: planes equal to jpeg_idct_reference, pixels to
    jpeg_color_reference."""
    from fce_yolo_tpu_torch.data import jpeg as J

    buf = _jpeg_writer()(_jpeg_image(np.random.RandomState(1), 480, 641), 90, "420", 0)
    info, planes, qt = J.jpeg_coefficients(buf)
    flat = torch.from_numpy(np.concatenate([p.ravel() for p in planes])).to(cuda)
    dev_planes = J.jpeg_idct(flat, qt, info)
    ref_planes = J.jpeg_idct(flat.cpu(), qt, info)
    np.testing.assert_array_equal(dev_planes.cpu().numpy(), ref_planes.numpy())
    bgr = J.jpeg_color(dev_planes, info)
    np.testing.assert_array_equal(bgr.cpu().numpy(), J.jpeg_color(ref_planes, info).numpy())
    hdr = J.parse_jpeg(buf)
    np.testing.assert_array_equal(bgr.cpu().numpy(), J.jpeg_color_reference(
        [J.jpeg_idct_reference(p, hdr.qt[c.tq]) for p, c in zip(J.entropy_decode(hdr), hdr.comps)], hdr))


@pytest.mark.cuda
def test_jpeg_decode_from_eight_threads(cuda):
    """Eight threads decode at once (each its own stream and buffers; the
    C decoder keeps no globals): every image equals its single-threaded
    decode, and the counts add up."""
    from concurrent.futures import ThreadPoolExecutor

    from fce_yolo_tpu_torch.data import jpeg as J

    write = _jpeg_writer()
    rng = np.random.RandomState(2)
    bufs = [write(_jpeg_image(rng, int(rng.randint(60, 200)), int(rng.randint(60, 200))), 85, s, r)
            for s, r in (("420", 0), ("422", 3), ("444", 1), ("411", 0)) * 8]
    want = [J.decode_jpeg(b, f"{i}.jpg", cuda) for i, b in enumerate(bufs)]
    before = J.jpeg_idct.launches
    with ThreadPoolExecutor(8) as pool:
        got = list(pool.map(lambda ib: J.decode_jpeg(ib[1], f"{ib[0]}.jpg", cuda), enumerate(bufs)))
    for a, b in zip(got, want):
        np.testing.assert_array_equal(a, b)
    assert J.jpeg_idct.launches == before + len(bufs)


@pytest.mark.cuda
def test_jpeg_on_the_card_refuses_and_reads_through_imread(cuda, tmp_path):
    """imread on the card: a JPEG file and a progressive one equal the plain
    path; a file cut off before EOI and a progressive one whose scans leave
    coefficients unfinished raise ValueError naming the file."""
    from fce_yolo_tpu_torch.data import jpeg as J
    from fce_yolo_tpu_torch.data.imread import imread

    buf = _jpeg_writer()(_jpeg_image(np.random.RandomState(3), 50, 70), 90, "420", 0)
    (tmp_path / "a.jpg").write_bytes(buf)
    np.testing.assert_array_equal(imread(tmp_path / "a.jpg", cuda), J.decode_jpeg_reference(buf))
    (tmp_path / "cut.jpg").write_bytes(buf[:-2])
    with pytest.raises(ValueError, match="cut.jpg: JPEG data that ends"):
        imread(tmp_path / "cut.jpg", cuda)
    sof = buf.index(b"\xff\xc0")
    prog = _jpeg_writer()(_jpeg_image(np.random.RandomState(3), 50, 70), 90, "420", 2, progressive=True)
    (tmp_path / "p.jpg").write_bytes(prog)  # a progressive file decodes on the card as the plain path decodes it
    np.testing.assert_array_equal(imread(tmp_path / "p.jpg", cuda), J.decode_jpeg_reference(prog))
    cut = prog[: [i for i in range(len(prog)) if prog.startswith(b"\xff\xda", i)][2]] + b"\xff\xd9"
    (tmp_path / "u.jpg").write_bytes(cut)
    with pytest.raises(ValueError, match="u.jpg: a progressive JPEG whose scans leave coefficients unfinished"):
        imread(tmp_path / "u.jpg", cuda)
    (tmp_path / "big.jpg").write_bytes(buf[:sof + 5] + b"\xff\xff\xff\xff" + buf[sof + 9:])  # 65535 x 65535
    with pytest.raises(ValueError, match="big.jpg: a JPEG over 2.30 pixels"):
        imread(tmp_path / "big.jpg", cuda)


@pytest.mark.cuda
def test_still_formats_on_the_card_read_as_on_the_cpu(cuda, tmp_path):
    """imread with the card's device: TIFF's LZW and PackBits through the
    host C++ of the kernel libraries, BMP, 16-bit and Adam7 PNG: the same
    pixels as the plain readers (``device="cpu"``) and as written."""
    from fce_yolo_tpu_torch.data.imread import imread

    _jpeg_writer()  # puts the repository's root, and chip_smoke.py's writers, on the path
    import chip_smoke

    rgb = np.random.RandomState(4).randint(0, 256, (67, 91, 3)).astype(np.uint8)
    files = {"a.tif": chip_smoke.tiff_bytes(rgb, 5, 2), "b.tif": chip_smoke.tiff_bytes(rgb, 32773, tile=(32, 32)),
             "c.bmp": chip_smoke.bmp_bytes(rgb), "d.png": chip_smoke.png_bytes(rgb, 16, True)}
    for name, data in files.items():
        (tmp_path / name).write_bytes(data)
        out = imread(tmp_path / name, cuda)
        np.testing.assert_array_equal(out, imread(tmp_path / name, "cpu"))
        np.testing.assert_array_equal(out, rgb[..., ::-1])


# ------------------------------------------------------------ task heads
TASK_MODELS = {"segment": "yolo11n-seg.yaml", "pose": "yolo11n-pose.yaml", "obb": "yolo11n-obb.yaml"}


@pytest.mark.cuda
@pytest.mark.parametrize("task", sorted(TASK_MODELS))
def test_task_head_on_the_card_matches_the_cpu(cuda, task, monkeypatch):
    """Each task model (n, seed weights, float32 with TF32 off) on the card
    against the same model on the CPU: preds (and the prototypes) within
    1e-3 of the largest."""
    monkeypatch.setattr(torch.backends.cudnn, "allow_tf32", False)
    monkeypatch.setattr(torch.backends.cuda.matmul, "allow_tf32", False)
    cpu = YOLO(TASK_MODELS[task], device="cpu").model.eval()
    card = YOLO(TASK_MODELS[task], device=cuda).model.eval()
    card.load_state_dict(cpu.state_dict())
    x = torch.from_numpy(np.random.RandomState(1).uniform(0, 1, (2, 3, 160, 128)).astype(np.float32))
    with torch.inference_mode():
        ref, out = cpu(x), card(x.to(cuda))
    for key in ("preds", "proto") if task == "segment" else ("preds",):
        r, o = ref[key].numpy(), out[key].cpu().numpy()
        assert np.abs(o - r).max() <= 1e-3 * np.abs(r).max(), key


def _task_dataset(root, task: str, n: int = 6):
    """``_val_dataset``'s images with segment (the rectangle's corners) or
    pose (its box and 17 keypoints inside) labels."""
    data = _val_dataset(root, n)
    rng = np.random.RandomState(1)
    for lbl in sorted((root / "labels" / "val").glob("*.txt")):
        rows = []
        for line in lbl.read_text().split("\n"):
            if not line:
                continue
            k, cx, cy, bw, bh = line.split()
            cx, cy, bw, bh = (float(v) for v in (cx, cy, bw, bh))
            x1, y1, x2, y2 = cx - bw / 2, cy - bh / 2, cx + bw / 2, cy + bh / 2
            if task == "segment":
                rows.append(f"{k} {x1:.6f} {y1:.6f} {x2:.6f} {y1:.6f} {x2:.6f} {y2:.6f} {x1:.6f} {y2:.6f}")
            else:
                kp = " ".join(f"{x:.6f} {y:.6f} 2" for x, y in zip(rng.uniform(x1, x2, 17), rng.uniform(y1, y2, 17)))
                rows.append(f"{line} {kp}")
        lbl.write_text("\n".join(rows) + "\n")
    return data


@pytest.mark.cuda
@pytest.mark.parametrize("task", ["segment", "pose"])
def test_task_val_nms_kernel_matches_the_plain_version(cuda, task, tmp_path, monkeypatch):
    """Segment and pose val on the card: the NMS kernel once per batch at
    K=4096, and on each batch the kernel and the plain version give the
    same outputs (masks, keypoints) and the same metrics."""
    data = _task_dataset(tmp_path, task)
    y = YOLO(TASK_MODELS[task], device=cuda)
    init_weights(y.model, torch.Generator().manual_seed(0), bias_prior=False)
    before = pick_suppress.launches
    res = y.val(data=data, imgsz=160, batch=4, verbose=False)
    assert pick_suppress.launches == before + 2 and len(res["metrics"]["box"].stats["conf"]) == 6

    val = y._validator(imgsz=160, batch_size=4)
    sets = {k: {t: DetMetrics(names=y.names) for t in val.families} for k in ("kernel", "plain")}
    seen = {}

    def plain(boxes, scores, valid, iou_thres, max_det):
        seen["k"] = boxes.shape[1]
        return pick_suppress_reference(boxes, scores, valid, iou_thres, max_det)

    y.model.eval()
    for batch in val.get_dataloader(data):
        out = val.forward(torch.from_numpy(batch["img"]).to(cuda))
        outs = {}
        for name, fn in (("kernel", pick_suppress), ("plain", plain)):
            monkeypatch.setattr(nms_ops, "pick_suppress", fn)
            outs[name] = val.to_host(val.nms(out))
        assert seen["k"] == 4096
        for k, v in outs["kernel"].items():
            for a, b in zip(v if isinstance(v, list) else [v], outs["plain"][k] if isinstance(v, list) else
                            [outs["plain"][k]]):
                np.testing.assert_array_equal(a, b, err_msg=k)
        for name, metrics in sets.items():
            val.update_metrics(outs[name], batch, metrics)
    for name in sets:
        for m in sets[name].values():
            m.process(nc=val.nc)
    assert all(sets["kernel"][t].mean_results() == sets["plain"][t].mean_results() for t in val.families)


def _task_loss_case(task: str, seed: int = 0, b: int = 2, imgsz: int = 256, nc: int = 3, m: int = 8):
    """Random train-mode outputs of a task head (NCHW maps, anchor-major
    extras) and a padded batch with its masks, keypoints or rotated boxes."""
    feats, batch = _loss_case(seed, b, imgsz, nc, m)
    rng = np.random.RandomState(seed + 100)
    a = sum((imgsz // s) ** 2 for s in (8, 16, 32))
    out = {"feats": feats}
    if task == "segment":
        out["mask_coefs"] = rng.normal(0, 1, (b, a, 32)).astype(np.float32)
        out["proto"] = rng.normal(0, 1, (b, 32, imgsz // 4, imgsz // 4)).astype(np.float32)
        batch["masks"] = (rng.rand(b, m, imgsz // 4, imgsz // 4) > 0.5).astype(np.float32) * batch["mask"][..., None,
                                                                                                           None]
    elif task == "pose":
        out["kpts"] = rng.normal(0, 1, (b, a, 51)).astype(np.float32)
        kp = np.concatenate([rng.uniform(0.1, 0.9, (b, m, 17, 2)), rng.randint(0, 3, (b, m, 17, 1))], -1)
        batch["keypoints"] = (kp * batch["mask"][..., None, None]).astype(np.float32)
    else:
        out["angle"] = rng.uniform(-np.pi / 4, 3 * np.pi / 4, (b, a, 1)).astype(np.float32)
        ang = rng.uniform(-np.pi / 4, 3 * np.pi / 4, (b, m, 1)).astype(np.float32)
        batch["bboxes"] = np.concatenate([batch["bboxes"], ang * batch["mask"][..., None]], -1)
    return out, batch


@pytest.mark.cuda
@pytest.mark.parametrize("task", ["segment", "pose", "obb"])
def test_task_loss_on_the_card_matches_the_cpu(cuda, task):
    """The segment, pose and OBB losses (float32, the assigner's overlaps in
    float32) on the card against the CPU: parts within 1e-3 relative, the
    gradient of every head output within 1e-3 of its largest."""
    from fce_yolo_tpu_torch.train import task_losses as T

    cfg = DetectionLossCfg(nc=3, tal_dtype="float32")
    fn = {"segment": T.segmentation_loss, "obb": T.obb_loss,
          "pose": lambda o, b, c, s: T.pose_loss(o, b, T.PoseLossCfg(det=c), s)}[task]
    out_np, batch = _task_loss_case(task)
    res = {}
    for name, dev in (("cpu", torch.device("cpu")), ("card", cuda)):
        out = {k: [torch.from_numpy(f).to(dev).requires_grad_() for f in v] if k == "feats"
               else torch.from_numpy(v).to(dev).requires_grad_() for k, v in out_np.items()}
        total, parts, _ = fn(out, {k: torch.from_numpy(v).to(dev) for k, v in batch.items()}, cfg, LossState.init(dev))
        total.backward()
        leaves = [*out["feats"], *(v for k, v in out.items() if k != "feats")]
        res[name] = ({k: float(v.detach()) for k, v in parts.items()}, [t.grad.cpu().numpy() for t in leaves])
    (p_cpu, g_cpu), (p_card, g_card) = res["cpu"], res["card"]
    assert p_card["fg_count"] == p_cpu["fg_count"] > 0
    for k, v in p_cpu.items():
        assert abs(p_card[k] - v) <= 1e-3 * abs(v), (k, p_card[k], v)
    for gc, gg in zip(g_card, g_cpu):
        assert np.isfinite(gc).all()
        np.testing.assert_allclose(gc, gg, rtol=0, atol=1e-3 * np.abs(gg).max())


# ------------------------------------------------------------ video and classify
def _avi_file(tmp_path, n: int = 6, h: int = 96, w: int = 128):
    """An MJPEG AVI written with chip_smoke.py's writers: frame 0 without
    DHT, frames 1-2 in a ``rec `` list, a dropped frame, moving rectangles."""
    import chip_smoke  # _jpeg_writer put the repository on the path

    write = _jpeg_writer()
    rng = np.random.RandomState(2)
    frames = []
    for t in range(n):
        img = _jpeg_image(rng, h, w)
        img[10:40, 5 + 8 * t: 35 + 8 * t] = (230, 40, 40)
        frames.append(write(img, 90, "420", 0))
    items = [chip_smoke.strip_dht(frames[0]), frames[1:3], b"", *frames[3:]]
    path = tmp_path / "clip.avi"
    path.write_bytes(chip_smoke.avi_bytes(items, w, h))
    return path


@pytest.mark.cuda
def test_avi_frames_on_the_card_match_the_plain_path(cuda, tmp_path):
    """Each frame of an MJPEG AVI decoded on the card (both JPEG kernels
    once a frame) is byte-equal to the plain path's."""
    from fce_yolo_tpu_torch.data import jpeg as J
    from fce_yolo_tpu_torch.data.avi import avi_frames

    path = _avi_file(tmp_path)
    before = (J.jpeg_idct.launches, J.jpeg_color.launches)
    card = list(avi_frames(path, cuda))
    assert len(card) == 6 and (J.jpeg_idct.launches, J.jpeg_color.launches) == (before[0] + 6, before[1] + 6)
    for a, b in zip(card, avi_frames(path, "cpu")):
        np.testing.assert_array_equal(a, b)


@pytest.mark.cuda
def test_classify_on_the_card_matches_the_cpu(cuda, tmp_path, monkeypatch):
    """yolo11n-cls (seed weights, float32, TF32 off) on the card against the
    CPU: logits within 1e-3 of the largest; ``predict`` on an AVI decodes
    each frame with both JPEG kernels and gives the CPU's probabilities
    within 1e-4; ``track`` gives empty tracks."""
    from fce_yolo_tpu_torch.data import jpeg as J

    monkeypatch.setattr(torch.backends.cudnn, "allow_tf32", False)
    monkeypatch.setattr(torch.backends.cuda.matmul, "allow_tf32", False)
    cpu = YOLO("yolo11n-cls.yaml", device="cpu", nc=3)
    card = YOLO("yolo11n-cls.yaml", device=cuda, nc=3)
    card.model.load_state_dict(cpu.model.state_dict())
    x = torch.from_numpy(np.random.RandomState(3).uniform(0, 1, (2, 3, 128, 96)).astype(np.float32))
    with torch.inference_mode():
        ref, out = cpu.model.eval()(x)["logits"].numpy(), card.model.eval()(x.to(cuda))["logits"].cpu().numpy()
    assert np.abs(out - ref).max() <= 1e-3 * np.abs(ref).max()
    path = _avi_file(tmp_path)
    before = J.jpeg_color.launches
    res = card.predict(str(path), imgsz=64, batch=4)
    assert J.jpeg_color.launches == before + 6
    exp = cpu.predict(str(path), imgsz=64, batch=4)
    np.testing.assert_allclose(np.stack([r.probs.data for r in res]), np.stack([r.probs.data for r in exp]),
                               rtol=0, atol=1e-4)
    assert all(t.shape == (0, 7) for _, t in card.track(str(path), imgsz=64))


@pytest.mark.cuda
@pytest.mark.parametrize("h,w,c", [(1, 1, 3), (37, 53, 3), (480, 640, 3), (721, 1281, 3), (33, 47, 1)])
def test_jpeg_fdct_kernel_matches_reference(cuda, h, w, c):
    """``jpeg_fdct_kernel``'s coefficients equal ``jpeg_fdct_reference``'s
    exactly, one launch a call; the card's file equals the plain writer's."""
    from fce_yolo_tpu_torch.data import jpeg_write as JW

    rng = np.random.RandomState(h + w)
    img = rng.randint(0, 256, (h, w, c) if c == 3 else (h, w), np.uint8)
    img[: h // 2, : w // 2] = 77  # a flat part: long zero runs
    before = JW.jpeg_fdct.launches
    coef = JW.jpeg_fdct(torch.from_numpy(img).to(cuda))
    torch.cuda.synchronize()
    assert JW.jpeg_fdct.launches == before + 1
    np.testing.assert_array_equal(coef.cpu().numpy(), JW.jpeg_fdct_reference(img))
    for q in (95, 50):
        assert JW.encode_jpeg(img, q, device="cuda") == JW.encode_jpeg_reference(img, q)


@pytest.mark.cuda
def test_outlines_and_save_on_the_card_match_the_plain_path(cuda, tmp_path):
    """The card library's contour walk gives the plain walk's outlines;
    ``Results`` on the card save the plain writer's bytes."""
    from fce_yolo_tpu_torch.data.jpeg_write import encode_jpeg_reference
    from fce_yolo_tpu_torch.engine.results import Results
    from fce_yolo_tpu_torch.ops.contours import find_contours_external, find_contours_reference

    rng = np.random.RandomState(0)
    for _ in range(50):
        m = rng.rand(*rng.randint(1, 60, 2)) < rng.uniform(0.1, 0.9)
        out, ref = find_contours_external(m, "cuda"), find_contours_reference(m)
        assert len(out) == len(ref) and all(np.array_equal(a, b) for a, b in zip(out, ref))
    masks = np.zeros((2, 90, 120), bool)
    masks[0, 10:40, 20:70] = masks[1, 50:80, 60:110] = True
    boxes = np.array([[20, 10, 70, 40, 0.9, 0], [60, 50, 110, 80, 0.6, 1]], np.float32)
    img = rng.randint(0, 256, (90, 120, 3), np.uint8)
    r = Results(img, "x", {0: "a", 1: "b"}, boxes=boxes, masks=masks, device="cuda")
    ref = Results(img, "x", {0: "a", 1: "b"}, boxes=boxes, masks=masks, device="cpu")
    assert all(np.array_equal(a, b) for a, b in zip(r.masks.xy, ref.masks.xy)) and r.summary() == ref.summary()
    r.save(str(tmp_path / "a.jpg"))
    assert (tmp_path / "a.jpg").read_bytes() == encode_jpeg_reference(r.plot())


@pytest.mark.cuda
def test_v10_preds6_on_the_card_match_the_cpu(cuda):
    """yolov10n (float32, TF32 off) on the card: ``preds6`` scores within
    1e-4 of the CPU's and classes in the same order where no scores lie
    within 1e-5 of each other; ``YOLO.predict`` and ``YOLO.val`` launch no
    NMS kernel."""
    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_tf32 = False
    card, cpu = YOLO("yolov10n.yaml", device=cuda), YOLO("yolov10n.yaml", device="cpu")
    init_weights(card.model, torch.Generator().manual_seed(0))
    cpu.model.load_state_dict(card.model.state_dict())
    x = torch.rand(2, 3, 160, 160, generator=torch.Generator().manual_seed(1))
    with torch.inference_mode():
        a = card.model.eval()(x.to(cuda))["preds6"].cpu().numpy()
        b = cpu.model.eval()(x)["preds6"].numpy()
    assert np.abs(a[..., 4] - b[..., 4]).max() <= 1e-4
    apart = np.concatenate([np.diff(b[..., 4], axis=1) < -1e-5, np.ones((2, 1), bool)], axis=1)
    apart &= np.concatenate([np.ones((2, 1), bool), apart[:, :-1]], axis=1)  # apart from both neighbours
    np.testing.assert_array_equal(a[..., 5][apart], b[..., 5][apart])
    pick_suppress.launches = 0
    card.predict([np.full((96, 128, 3), 90, np.uint8)] * 2, imgsz=160, batch=2)
    assert pick_suppress.launches == 0


@pytest.mark.cuda
def test_tta_nms_kernel_matches_the_plain_version(cuda):
    """yolov8n's ``predict_augment`` candidates at 320 px (B=4) through
    ``batched_nms``: the kernel's detections equal those of the plain NMS
    on the same candidates."""
    from fce_yolo_tpu_torch.nn.tta import predict_augment

    yolo = YOLO("yolov8n.yaml", device=cuda)
    init_weights(yolo.model, torch.Generator().manual_seed(0), bias_prior=False)
    x = torch.rand(4, 3, 320, 320, generator=torch.Generator().manual_seed(2)).to(cuda)
    with torch.inference_mode():
        merged = predict_augment(yolo.model.eval(), x)
        kw = dict(conf_thres=0.25, iou_thres=0.7, max_det=300, multi_label=False)
        out = nms_ops.batched_nms(merged, **kw)
        real = nms_ops.pick_suppress
        try:
            nms_ops.pick_suppress = lambda b, s, v, iou_thres, max_det: pick_suppress_reference(b, s, v, iou_thres,
                                                                                             max_det)
            ref = nms_ops.batched_nms(merged, **kw)
        finally:
            nms_ops.pick_suppress = real
    assert int(out["valid"].sum()) > 0
    for k in out:
        assert torch.equal(out[k], ref[k]), k


@pytest.mark.cuda
def test_cls_resnet18_on_the_card_matches_the_cpu(cuda):
    """yolo11-cls-resnet18 (float32, TF32 off): logits on the card within
    1e-3 of the largest CPU logit."""
    torch.backends.cudnn.allow_tf32 = False
    card, cpu = YOLO("yolo11-cls-resnet18.yaml", device=cuda), YOLO("yolo11-cls-resnet18.yaml", device="cpu")
    cpu.model.load_state_dict(card.model.state_dict())
    x = torch.rand(2, 3, 224, 224, generator=torch.Generator().manual_seed(3))
    with torch.inference_mode():
        a = card.model.eval()(x.to(cuda))["logits"].cpu()
        b = cpu.model.eval()(x)["logits"]
    assert float((a - b).abs().max()) <= 1e-3 * float(b.abs().max())


@pytest.mark.cuda
def test_webp_decode_on_the_card_matches_the_recorded_cv2_decodes(cuda):
    """Every committed WebP fixture (``tests/fixtures/make_webp.py``) read on
    the card (host C++ and, for a lossy one, ``webp_color_kernel`` once)
    gives the SHA-256 of cv2's decode recorded beside it; on each lossy one
    the kernel alone equals ``webp_color_reference`` of the same planes."""
    import hashlib
    import json
    from pathlib import Path

    from fce_yolo_tpu_torch.data import webp as W

    folder = Path(__file__).resolve().parent / "fixtures" / "webp"
    recorded = json.loads((folder / "decodes.json").read_text())
    assert len(recorded) >= 30
    for name, rec in sorted(recorded.items()):
        buf = (folder / name).read_bytes()
        before = W.webp_color.launches
        out = W.decode_webp(buf, name, "cuda")
        info, flat, planes = W.webp_decode_host(buf, name)
        assert W.webp_color.launches - before == int(info[0] == 1), name
        assert list(out.shape) == rec["shape"], name
        assert hashlib.sha256(np.ascontiguousarray(out).tobytes()).hexdigest() == rec["sha256"], name
        if info[0] == 1:
            bgr = W.webp_color(torch.from_numpy(flat).cuda(), info).cpu().numpy()
            np.testing.assert_array_equal(bgr, W.webp_color_reference(planes["y"], planes["u"], planes["v"]))


@pytest.mark.cuda
@pytest.mark.parametrize("make", [_candidates, _ties, _few_valid])
def test_nms_custom_op_matches_reference(cuda, make):
    """``torch.ops.fce_yolo_tpu_torch.pick_suppress`` on CUDA tensors is the
    kernel (one launch counted) and equals the plain version; on CPU tensors
    it is the plain version."""
    args = [torch.from_numpy(a) for a in make(np.random.RandomState(3), 4, 1024)]
    ref = pick_suppress_reference(*args, 0.7, 300)
    before = pick_suppress.launches
    out = torch.ops.fce_yolo_tpu_torch.pick_suppress(*(a.to(cuda) for a in args), 0.7, 300)
    assert pick_suppress.launches == before + 1
    cpu = torch.ops.fce_yolo_tpu_torch.pick_suppress(*args, 0.7, 300)
    assert pick_suppress.launches == before + 1
    for r, o, c in zip(ref, out, cpu):
        assert torch.equal(o.cpu(), r) and torch.equal(c, r)


@pytest.mark.cuda
def test_torch_export_program_with_nms_runs_on_the_card(cuda, tmp_path):
    """A ``.pt2`` with NMS inside, exported on the CPU and loaded on the
    card: the NMS kernel is launched from inside the program (once a call),
    its idx/ok equal to the plain version's on the candidates the program
    gave it (kept by a dispatch mode)."""
    from torch.utils._python_dispatch import TorchDispatchMode

    from fce_yolo_tpu_torch.nn.autobackend import AutoBackend

    yolo = YOLO("yolo11n.yaml", device="cpu", nc=3)
    with torch.no_grad():
        for branch in yolo.model.detect.cv3:
            branch[-1].bias[:3] += 10.0  # scores above the baked conf
    path = yolo.export(format="torch_export", imgsz=64, batch=2, nms=True, out_dir=tmp_path)
    x = np.random.RandomState(0).randint(0, 255, (2, 64, 64, 3)).astype(np.uint8)
    op, calls = torch.ops.fce_yolo_tpu_torch.pick_suppress.default, []

    class Keep(TorchDispatchMode):
        def __torch_dispatch__(self, func, types, args=(), kwargs=None):
            out = func(*args, **(kwargs or {}))
            if func is op:
                calls.append((args, out))
            return out

    backend = AutoBackend(path, device=cuda)
    before = pick_suppress.launches
    with Keep():
        out = backend(x)
    assert pick_suppress.launches == before + 1 and len(calls) == 1 and out["boxes"].device.type == "cuda"
    (boxes, scores, valid, iou, max_det), (idx, ok) = calls[0]
    assert boxes.device.type == "cuda" and int(out["valid"].sum()) > 0
    ref = pick_suppress_reference(boxes.cpu(), scores.cpu(), valid.cpu(), iou, max_det)
    assert torch.equal(idx.cpu(), ref[0]) and torch.equal(ok.cpu(), ref[1])


@pytest.mark.cuda
def test_yoloe_text_predict_on_card_takes_the_stem_with_the_text(cuda):
    """``YOLOE("yoloe-11s.yaml").set_classes`` then a bf16 predict: the stem
    and NMS kernels once a batch, and the kernel path's scores follow the
    bound text (the text is a buffer of the model, carried into the
    predictor's folded copy)."""
    from fce_yolo_tpu_torch import YOLOE

    y = YOLOE("yoloe-11s.yaml", device=cuda)
    y.set_classes(["cat", "dog", "bird"])
    y.to(torch.bfloat16)
    rng = np.random.RandomState(0)
    imgs = [rng.randint(0, 256, (160, 160, 3), np.uint8) for _ in range(4)]
    stem0, nms0 = S.fused_stem.launches, pick_suppress.launches
    res = y.predict(imgs, imgsz=160, batch=2, conf=0.0, max_det=5)
    assert S.fused_stem.launches == stem0 + 2 and pick_suppress.launches == nms0 + 2
    assert len(res) == 4 and all(set(r.boxes.cls.astype(int)) <= {0, 1, 2} for r in res)
    model = y._inference_model()
    spec = S.stem_spec_from_model(model.spec, (160, 160))
    w = S.stem_weights(S.fold_stem_params(model, spec), spec)
    batch = torch.from_numpy(np.stack(imgs[:2])).to(cuda)
    with torch.inference_mode():
        a = S.apply_with_fused_stem(model, batch, spec, w)["preds"][..., 4:].float()
        model.txt_feats = model.txt_feats.flip(1)
        b = S.apply_with_fused_stem(model, batch, spec, w)["preds"][..., 4:].float()
    torch.testing.assert_close(a, b.flip(-1), rtol=0, atol=0.02)


@pytest.mark.cuda
def test_yoloe_visual_prompt_predict_on_card_takes_the_nms_kernel(cuda):
    from fce_yolo_tpu_torch import YOLOE

    y = YOLOE("yoloe-11s.yaml", device=cuda)
    img = np.random.RandomState(1).randint(0, 256, (120, 160, 3), np.uint8)
    vp = {"bboxes": np.array([[10, 10, 60, 60], [70, 20, 150, 110]], np.float32), "cls": np.array([3, 8])}
    nms0 = pick_suppress.launches
    r = y.predict(img, visual_prompts=vp, imgsz=160, conf=0.0, max_det=10)[0]
    assert pick_suppress.launches == nms0 + 1 and len(r) == 10 and set(r.boxes.cls.astype(int)) <= {3, 8}


@pytest.mark.cuda
def test_clip_towers_on_the_card_match_the_cpu(cuda, monkeypatch):
    """Two-layer towers at ViT-B/32 width, float32 (TF32 off), within 1e-4 of the CPU."""
    monkeypatch.setattr(torch.backends.cudnn, "allow_tf32", False)
    monkeypatch.setattr(torch.backends.cuda.matmul, "allow_tf32", False)
    from fce_yolo_tpu_torch.nn.clip_vision import CLIPVisionCfg, CLIPVisionTower
    from fce_yolo_tpu_torch.nn.text_model import CLIPTextCfg, CLIPTextTower

    text = CLIPTextTower(CLIPTextCfg(layers=2)).reset_parameters(0)
    vision = CLIPVisionTower(CLIPVisionCfg(layers=2)).reset_parameters(0)
    tokens = torch.randint(1, 49406, (3, 77), generator=torch.Generator().manual_seed(0))
    tokens[:, 10] = 49407
    imgs = torch.randn(2, 3, 224, 224, generator=torch.Generator().manual_seed(1))
    for tower, x in ((text, tokens), (vision, imgs)):
        with torch.inference_mode():
            ref = tower(x)
            got = tower.to(cuda)(x.to(cuda)).cpu()
        torch.testing.assert_close(got, ref, rtol=0, atol=1e-4)
