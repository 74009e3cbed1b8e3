"""The port's IoU family, task-aligned assigner and detection loss against
the JAX package on the same inputs (numpy, from a seed; feats NHWC for JAX,
NCHW for the port), all in float32 on the CPU.

Tolerances: the IoU functions within 1e-6 absolute (elementwise float32;
atan and exp may differ by an ulp); the assigner's labels, boxes and fg mask
equal and its norm within 1e-6 relative to its largest value, on inputs
without ties; the loss parts within 1e-5 relative (sums over ~10^4 terms in
another order); the gradient of the total within 1e-4 of its largest
magnitude (float32 backward through log-sum-exp, atan and the DFL).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from fce_yolo_tpu.ops import iou as jiou
from fce_yolo_tpu.train import loss as jloss
from fce_yolo_tpu.train import tal as jtal
from fce_yolo_tpu_torch.ops import iou as piou
from fce_yolo_tpu_torch.ops.anchors import bbox2dist
from fce_yolo_tpu_torch.train import loss as ploss
from fce_yolo_tpu_torch.train import tal as ptal

torch.set_num_threads(1)

NC, REG_MAX, STRIDES, IMGSZ = 5, 16, (8, 16, 32), 128


def _boxes(rng, shape, lo=0.0, hi=100.0):
    """xyxy boxes of positive size."""
    xy = rng.uniform(lo, hi, shape + (2,))
    wh = rng.uniform(2.0, 40.0, shape + (2,))
    return np.concatenate([xy, xy + wh], -1).astype(np.float32)


@pytest.mark.parametrize("mode", ["IoU", "GIoU", "DIoU", "CIoU", "WIoU"])
@pytest.mark.parametrize("xywh", [False, True])
def test_iou_family_matches_jax(mode, xywh):
    rng = np.random.RandomState(0)
    b1, b2 = _boxes(rng, (64, 1)), _boxes(rng, (1, 48))
    b1[:8, 0] = b2[0, :8]  # some identical boxes (v = 0, iou ~ 1)
    if mode == "WIoU":
        ref = jiou.bbox_wiou(jnp.asarray(b1), jnp.asarray(b2), xywh=xywh)
        out = piou.bbox_wiou(torch.from_numpy(b1), torch.from_numpy(b2), xywh=xywh)
    else:
        ref = jiou.bbox_iou(jnp.asarray(b1), jnp.asarray(b2), xywh=xywh, mode=mode)
        out = piou.bbox_iou(torch.from_numpy(b1), torch.from_numpy(b2), xywh=xywh, mode=mode)
    assert out.shape == ref.shape == (64, 48)
    np.testing.assert_allclose(out.numpy(), np.asarray(ref), rtol=0, atol=1e-6)


def test_pairwise_iou_and_bbox2dist_match_jax():
    from fce_yolo_tpu.ops.anchors import bbox2dist as jbbox2dist

    rng = np.random.RandomState(1)
    a, b = _boxes(rng, (30,)), _boxes(rng, (20,))
    np.testing.assert_allclose(piou.box_iou_pairwise(torch.from_numpy(a), torch.from_numpy(b)).numpy(),
                               np.asarray(jiou.box_iou_pairwise(jnp.asarray(a), jnp.asarray(b))), rtol=0, atol=1e-6)
    pts = rng.uniform(0, 100, (30, 2)).astype(np.float32)
    np.testing.assert_array_equal(bbox2dist(torch.from_numpy(pts), torch.from_numpy(a), REG_MAX).numpy(),
                                  np.asarray(jbbox2dist(jnp.asarray(pts), jnp.asarray(a), REG_MAX)))


def _assign_inputs(seed, b=2, m=5, a_side=16):
    rng = np.random.RandomState(seed)
    xs = (np.arange(a_side) + 0.5) * 8
    anc = np.stack(np.meshgrid(xs, xs), -1).reshape(-1, 2).astype(np.float32)
    a = anc.shape[0]
    scores = rng.normal(0, 2, (b, a, NC)).astype(np.float32)
    centers = anc[None] + rng.uniform(-4, 4, (b, a, 2))
    wh = rng.uniform(8, 48, (b, a, 2))
    pd = np.concatenate([centers - wh / 2, centers + wh / 2], -1).astype(np.float32)
    gt = _boxes(rng, (b, m), 0, 80) * np.float32(1.5)
    labels = rng.randint(0, NC, (b, m)).astype(np.int32)
    mask = np.ones((b, m), bool)
    mask[1, 3:] = False  # padded gts
    return scores, pd, anc, labels, gt, mask


@pytest.mark.parametrize("metric_dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("seed", [0, 1])
def test_assign_matches_jax(seed, metric_dtype):
    scores, pd, anc, labels, gt, mask = _assign_inputs(seed)
    ref = jtal.assign(*(jnp.asarray(x) for x in (scores, pd, anc, labels, gt, mask)), topk=10, num_classes=NC,
                      scores_logits=True, metric_dtype=jnp.dtype(metric_dtype))
    out = ptal.assign(*(torch.from_numpy(x) for x in (scores, pd, anc, labels, gt, mask)), topk=10,
                      scores_logits=True, metric_dtype=getattr(torch, metric_dtype))
    fg = np.asarray(ref.fg_mask)
    assert fg.sum() > 20
    np.testing.assert_array_equal(out.fg_mask.numpy(), fg)
    np.testing.assert_array_equal(out.target_labels.numpy(), np.asarray(ref.target_labels))
    np.testing.assert_array_equal(out.target_bboxes.numpy(), np.asarray(ref.target_bboxes))
    norm_ref = np.asarray(ref.target_norm)
    np.testing.assert_allclose(out.target_norm.numpy(), norm_ref, rtol=0, atol=1e-6 * norm_ref.max())


def _loss_inputs(seed, b=2, m=6, empty=False):
    """Seeded head maps at IMGSZ (16x16 + 8x8 + 4x4 = 336 anchors) and a padded batch."""
    rng = np.random.RandomState(seed)
    feats = [rng.normal(0, 1.5, (b, IMGSZ // s, IMGSZ // s, 4 * REG_MAX + NC)).astype(np.float32) for s in STRIDES]
    cls = rng.randint(0, NC, (b, m)).astype(np.float32)
    cxcy = rng.uniform(0.2, 0.8, (b, m, 2))
    wh = rng.uniform(0.1, 0.4, (b, m, 2))
    bboxes = np.concatenate([cxcy, wh], -1).astype(np.float32)
    mask = np.ones((b, m), bool)
    mask[0, 4:] = False  # padding
    bboxes[0, 4:] = 0
    if empty:
        mask[1] = False  # the second image has no ground truth
        bboxes[1] = 0
    return feats, {"cls": cls, "bboxes": bboxes, "mask": mask}


_jax_detection_loss = jax.jit(jloss.detection_loss, static_argnums=(2,))


def _jax_loss(feats, batch, cfg, state):
    jb = {k: jnp.asarray(v) for k, v in batch.items()}
    return _jax_detection_loss([jnp.asarray(f) for f in feats], jb, cfg, state)


def _port_loss(feats, batch, cfg, state, grad=False):
    pf = [torch.from_numpy(f.transpose(0, 3, 1, 2).copy()).requires_grad_(grad) for f in feats]
    pb = {k: torch.from_numpy(v) for k, v in batch.items()}
    return pf, ploss.detection_loss(pf, pb, cfg, state)


@pytest.mark.parametrize("empty", [False, True], ids=["gt", "one-image-without-gt"])
@pytest.mark.parametrize("iou_type", ["CIoU", "DIoU", "GIoU", "WIoU"])
def test_detection_loss_parts_match_jax(iou_type, empty):
    feats, batch = _loss_inputs(3, empty=empty)
    jcfg = jloss.DetectionLossCfg(nc=NC, iou_type=iou_type, tal_dtype="float32")
    pcfg = ploss.DetectionLossCfg(nc=NC, iou_type=iou_type, tal_dtype="float32")
    jtotal, jparts, _ = _jax_loss(feats, batch, jcfg, jloss.LossState.init())
    _, (ptotal, pparts, _) = _port_loss(feats, batch, pcfg, ploss.LossState.init("cpu"))
    assert float(jparts["fg_count"]) > 10
    assert float(pparts["fg_count"]) == float(jparts["fg_count"])
    for k in ("box", "cls", "dfl"):
        np.testing.assert_allclose(float(pparts[k]), float(jparts[k]), rtol=1e-5, err_msg=k)
    np.testing.assert_allclose(float(ptotal), float(jtotal), rtol=1e-5)


def test_detection_loss_without_any_gt_matches_jax():
    feats, batch = _loss_inputs(4)
    batch["mask"][:] = False
    batch["bboxes"][:] = 0
    jtotal, jparts, jstate = _jax_loss(feats, batch, jloss.DetectionLossCfg(nc=NC, iou_type="WIoU"),
                                       jloss.LossState.init())
    _, (ptotal, pparts, pstate) = _port_loss(feats, batch, ploss.DetectionLossCfg(nc=NC, iou_type="WIoU"),
                                             ploss.LossState.init("cpu"))
    assert float(pparts["fg_count"]) == 0 == float(jparts["fg_count"])
    assert float(pparts["box"]) == 0 == float(pparts["dfl"])
    np.testing.assert_allclose(float(ptotal), float(jtotal), rtol=1e-5)
    assert float(pstate.wiou_loss_mean) == float(jstate.wiou_loss_mean) == -1.0  # no foreground: unchanged


def test_wiou_state_matches_jax_over_three_steps():
    jstate, pstate = jloss.LossState.init(), ploss.LossState.init("cpu")
    jcfg, pcfg = jloss.DetectionLossCfg(nc=NC, iou_type="WIoU"), ploss.DetectionLossCfg(nc=NC, iou_type="WIoU")
    for step in range(3):
        feats, batch = _loss_inputs(10 + step)
        _, jparts, jstate = _jax_loss(feats, batch, jcfg, jstate)
        _, (_, pparts, pstate) = _port_loss(feats, batch, pcfg, pstate)
        assert float(pstate.wiou_loss_mean) > 0
        np.testing.assert_allclose(float(pstate.wiou_loss_mean), float(jstate.wiou_loss_mean), rtol=1e-6)
        np.testing.assert_allclose(float(pparts["box"]), float(jparts["box"]), rtol=1e-5)


@pytest.mark.parametrize("iou_type", ["CIoU", "WIoU"])
def test_detection_loss_gradient_matches_jax(iou_type):
    feats, batch = _loss_inputs(5)
    jcfg = jloss.DetectionLossCfg(nc=NC, iou_type=iou_type, tal_dtype="float32")
    pcfg = ploss.DetectionLossCfg(nc=NC, iou_type=iou_type, tal_dtype="float32")
    jb = {k: jnp.asarray(v) for k, v in batch.items()}
    jgrads = jax.jit(jax.grad(lambda fs: jloss.detection_loss(fs, jb, jcfg, jloss.LossState.init())[0]))(
        [jnp.asarray(f) for f in feats])
    pf, (ptotal, _, _) = _port_loss(feats, batch, pcfg, ploss.LossState.init("cpu"), grad=True)
    ptotal.backward()
    for g_port, g_jax in zip(pf, jgrads):
        g_jax = np.asarray(g_jax).transpose(0, 3, 1, 2)
        scale = np.abs(g_jax).max()
        assert scale > 0
        np.testing.assert_allclose(g_port.grad.numpy(), g_jax, rtol=0, atol=1e-4 * scale)


def test_loss_state_defaults_to_the_card():
    if torch.cuda.is_available():
        pytest.skip("checks the no-card raise")
    with pytest.raises((RuntimeError, AssertionError)):
        ploss.LossState.init()
