"""The port's rotated assigner and its segment, pose and OBB losses against
the JAX package on the same random head outputs (numpy, from a seed; maps
NHWC for JAX, NCHW for the port; prototypes (B, H, W, nm) against
(B, nm, H, W)), all in float32 on the CPU, with no model.

Tolerances: the assigner's labels, gt indices, boxes and fg mask equal and
its norm within 1e-6 of its largest value; the loss parts within 1e-5
relative (masked sums over ~10^4 terms in another order); the gradient of
the total with respect to every head output within 1e-4 of that output's
largest gradient magnitude.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from fce_yolo_tpu.train import loss as jloss
from fce_yolo_tpu.train import tal as jtal
from fce_yolo_tpu.train import task_losses as jtask
from fce_yolo_tpu_torch.train import loss as ploss
from fce_yolo_tpu_torch.train import tal as ptal
from fce_yolo_tpu_torch.train import task_losses as ptask

torch.set_num_threads(1)

NC, REG_MAX, STRIDES, IMGSZ, NM = 3, 16, (8, 16, 32), 128, 8
HP = IMGSZ // 4  # prototype resolution
A = sum((IMGSZ // s) ** 2 for s in STRIDES)  # 336 anchors


# ------------------------------------------------------------------ assigner
def _rotated_inputs(seed, b=2, m=5, a_side=16):
    rng = np.random.RandomState(seed)
    xs = (np.arange(a_side) + 0.5) * 8
    anc = np.stack(np.meshgrid(xs, xs), -1).reshape(-1, 2).astype(np.float32)
    a = anc.shape[0]
    scores = rng.normal(0, 2, (b, a, NC)).astype(np.float32)
    pd = np.concatenate([anc[None] + rng.uniform(-4, 4, (b, a, 2)), rng.uniform(8, 48, (b, a, 2)),
                         rng.uniform(-np.pi / 4, 3 * np.pi / 4, (b, a, 1))], -1).astype(np.float32)
    gt = np.concatenate([rng.uniform(20, 108, (b, m, 2)), rng.uniform(12, 60, (b, m, 2)),
                         rng.uniform(-np.pi / 4, 3 * np.pi / 4, (b, m, 1))], -1).astype(np.float32)
    labels = rng.randint(0, NC, (b, m)).astype(np.int32)
    mask = np.ones((b, m), bool)
    mask[1, 3:] = False  # padded gts
    return scores, pd, anc, labels, gt, mask


@pytest.mark.parametrize("metric_dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("seed", [0, 1])
def test_assign_rotated_matches_jax(seed, metric_dtype):
    ins = _rotated_inputs(seed)
    ref = jtal.assign_rotated(*(jnp.asarray(x) for x in ins), topk=10, num_classes=NC, scores_logits=True,
                              metric_dtype=jnp.dtype(metric_dtype))
    out = ptal.assign_rotated(*(torch.from_numpy(x) for x in ins), topk=10, scores_logits=True,
                              metric_dtype=getattr(torch, metric_dtype))
    fg = np.asarray(ref.fg_mask)
    assert fg.sum() > 20 and out.target_bboxes.shape == (2, 256, 5)
    np.testing.assert_array_equal(out.fg_mask.numpy(), fg)
    np.testing.assert_array_equal(out.target_labels.numpy(), np.asarray(ref.target_labels))
    np.testing.assert_array_equal(out.target_gt_idx.numpy()[fg], np.asarray(ref.target_gt_idx)[fg])
    np.testing.assert_array_equal(out.target_bboxes.numpy(), np.asarray(ref.target_bboxes))
    norm_ref = np.asarray(ref.target_norm)
    np.testing.assert_allclose(out.target_norm.numpy(), norm_ref, rtol=0, atol=1e-6 * norm_ref.max())


# ------------------------------------------------------------------ losses
def _inputs(seed, task, b=2, m=6, empty=False, kpt_shape=(17, 3), mask_hw=(HP, HP)):
    """Seeded train-mode head outputs of ``task`` and a padded batch; the
    second image has no gt when ``empty``."""
    rng = np.random.RandomState(seed)
    out = {"feats": [rng.normal(0, 1.5, (b, IMGSZ // s, IMGSZ // s, 4 * REG_MAX + NC)).astype(np.float32)
                     for s in STRIDES]}
    cls = rng.randint(0, NC, (b, m)).astype(np.float32)
    mask = np.ones((b, m), bool)
    mask[0, 4:] = False
    if empty:
        mask[1] = False
    if task == "obb":
        bboxes = np.concatenate([rng.uniform(0.25, 0.75, (b, m, 2)), rng.uniform(0.1, 0.4, (b, m, 2)),
                                 rng.uniform(-np.pi / 4, 3 * np.pi / 4, (b, m, 1))], -1).astype(np.float32)
        out["angle"] = ((1 / (1 + np.exp(-rng.normal(0, 1, (b, A, 1)))) - 0.25) * np.pi).astype(np.float32)
    else:
        bboxes = np.concatenate([rng.uniform(0.2, 0.8, (b, m, 2)), rng.uniform(0.1, 0.4, (b, m, 2))],
                                -1).astype(np.float32)
    bboxes[~mask] = 0
    batch = {"cls": cls, "bboxes": bboxes, "mask": mask}
    if task == "segment":
        out["mask_coefs"] = rng.normal(0, 1, (b, A, NM)).astype(np.float32)
        out["proto"] = rng.normal(0, 1, (b, HP, HP, NM)).astype(np.float32)
        hm, wm = mask_hw
        ys, xs = np.mgrid[:hm, :wm]
        masks = np.zeros((b, m, hm, wm), np.float32)
        for i in range(b):
            for j in range(m):
                if mask[i, j]:
                    cx, cy, w, h = bboxes[i, j] * [wm, hm, wm, hm]
                    inside = (abs(xs + 0.5 - cx) < w / 2) & (abs(ys + 0.5 - cy) < h / 2)
                    masks[i, j] = inside & (rng.rand(hm, wm) > 0.2)  # a box with holes
        batch["masks"] = masks
    if task == "pose":
        nk, nd = kpt_shape
        kp = np.concatenate([rng.uniform(0.1, 0.9, (b, m, nk, 2)), rng.randint(0, 3, (b, m, nk, 1))], -1)
        if nd == 2:
            kp[..., 2] = 1.0
        kp[~mask] = 0
        batch["keypoints"] = kp.astype(np.float32)
        out["kpts"] = rng.normal(0, 1, (b, A, nk * nd)).astype(np.float32)
    return out, batch


def _to_port(out: dict) -> dict:
    """The JAX layout's arrays as the port's leaf tensors (NCHW maps and prototypes)."""
    res = {}
    for k, v in out.items():
        if k == "feats":
            res[k] = [torch.from_numpy(f.transpose(0, 3, 1, 2).copy()).requires_grad_() for f in v]
        elif k == "proto":
            res[k] = torch.from_numpy(v.transpose(0, 3, 1, 2).copy()).requires_grad_()
        else:
            res[k] = torch.from_numpy(v.copy()).requires_grad_()
    return res


def _grads_to_jax_layout(pout: dict) -> dict:
    res = {}
    for k, v in pout.items():
        if k == "feats":
            res[k] = [f.grad.numpy().transpose(0, 2, 3, 1) for f in v]
        elif k == "proto":
            res[k] = v.grad.numpy().transpose(0, 2, 3, 1)
        else:
            res[k] = v.grad.numpy()
    return res


def _losses(task, kpt_shape=(17, 3)):
    """(JAX loss, port loss, JAX cfg, port cfg) of ``task``, assigner overlaps in float32."""
    jdet = jloss.DetectionLossCfg(nc=NC, tal_dtype="float32")
    pdet = ploss.DetectionLossCfg(nc=NC, tal_dtype="float32")
    if task == "pose":
        return (jtask.pose_loss, ptask.pose_loss, jtask.PoseLossCfg(det=jdet, kpt_shape=kpt_shape),
                ptask.PoseLossCfg(det=pdet, kpt_shape=kpt_shape))
    if task == "segment":
        return jtask.segmentation_loss, ptask.segmentation_loss, jdet, pdet
    return jtask.obb_loss, ptask.obb_loss, jdet, pdet


def _run(task, out, batch, kpt_shape=(17, 3), jit=True):
    """Both losses on the same inputs: (JAX parts, port parts, JAX grads, port grads)."""
    jfn, pfn, jcfg, pcfg = _losses(task, kpt_shape)

    def jtotal(o):
        total, parts, _ = jfn(o, {k: jnp.asarray(v) for k, v in batch.items()}, jcfg, jloss.LossState.init())
        return total, parts

    jgrad = jax.value_and_grad(jtotal, has_aux=True)
    (_, jparts), jg = (jax.jit(jgrad) if jit else jgrad)(jax.tree_util.tree_map(jnp.asarray, out))
    pout = _to_port(out)
    ptotal, pparts, _ = pfn(pout, {k: torch.from_numpy(v) for k, v in batch.items()}, pcfg,
                            ploss.LossState.init("cpu"))
    ptotal.backward()
    return ({k: float(v) for k, v in jparts.items()}, {k: float(v.detach()) for k, v in pparts.items()},
            jax.tree_util.tree_map(np.asarray, jg), _grads_to_jax_layout(pout))


def _assert_match(jparts, pparts, jg, pg):
    assert set(jparts) == set(pparts)
    assert jparts["fg_count"] == pparts["fg_count"] > 0
    for k, r in jparts.items():
        assert abs(pparts[k] - r) <= 1e-5 * abs(r) + 1e-12, (k, pparts[k], r)
    for (path, r), (_, g) in zip(jax.tree_util.tree_flatten_with_path(jg)[0],
                                 jax.tree_util.tree_flatten_with_path(pg)[0]):
        assert g.shape == r.shape and np.isfinite(g).all(), path
        scale = np.abs(r).max()
        assert scale > 0, path
        assert np.abs(g - r).max() <= 1e-4 * scale, (path, np.abs(g - r).max(), scale)


CASES = [("segment", (17, 3)), ("pose", (17, 3)), ("pose", (4, 2)), ("obb", (17, 3))]


@pytest.mark.parametrize("empty", [False, True], ids=["gt", "one-image-without-gt"])
@pytest.mark.parametrize("task,kpt_shape", CASES, ids=["segment", "pose17x3", "pose4x2", "obb"])
def test_task_loss_parts_and_gradients_match_jax(task, kpt_shape, empty):
    out, batch = _inputs(2, task, empty=empty, kpt_shape=kpt_shape)
    jparts, pparts, jg, pg = _run(task, out, batch, kpt_shape)
    _assert_match(jparts, pparts, jg, pg)
    extra = {"segment": ("seg",), "pose": ("kpt", "kobj"), "obb": ()}[task]
    for k in extra:
        assert k in pparts and (pparts[k] != 0 or (k == "kobj" and kpt_shape[1] == 2))
    if task == "pose" and kpt_shape[1] == 2:
        assert pparts["kobj"] == 0.0


@pytest.mark.parametrize("mask_hw", [(64, 64), (48, 40)])
def test_segmentation_loss_resizes_masks_as_jax(mask_hw):
    """Masks off the prototypes' resolution: ``jax.image.resize`` "nearest"
    (half-pixel centres) is ``F.interpolate`` "nearest-exact"; at 48x40 ->
    32x32 plain "nearest" picks other rows."""
    out, batch = _inputs(4, "segment", mask_hw=mask_hw)
    _assert_match(*_run("segment", out, batch))
    m = torch.from_numpy(batch["masks"])
    ref = np.asarray(jax.image.resize(jnp.asarray(batch["masks"]), (*m.shape[:2], HP, HP), method="nearest"))
    exact = torch.nn.functional.interpolate(m, size=(HP, HP), mode="nearest-exact").numpy()
    np.testing.assert_array_equal(exact, ref)
    if mask_hw == (48, 40):
        assert not np.array_equal(torch.nn.functional.interpolate(m, size=(HP, HP), mode="nearest").numpy(), ref)


def _tied_assignment(batch, b, fg_rows):
    """An assignment with ``fg_rows[i]`` foreground anchors of one equal norm
    in image i (and a few of a larger one in image 0), their gts cycling
    over the image's real gts: numpy arrays of ``AssignResult``'s fields."""
    m = batch["cls"].shape[1]
    fg = np.zeros((b, A), bool)
    norm = np.zeros((b, A), np.float32)
    gt_idx = np.zeros((b, A), np.int32)
    rng = np.random.RandomState(9)
    for i, n in enumerate(fg_rows):
        if n:
            rows = np.sort(rng.choice(A, n, replace=False))
            fg[i, rows] = True
            norm[i, rows] = 0.25
            norm[i, rows[::17]] = 0.5  # a few above the tie
            real = np.flatnonzero(batch["mask"][i])
            gt_idx[i, rows] = real[np.arange(n) % len(real)]
    xywh = batch["bboxes"] * IMGSZ
    xyxy = np.concatenate([xywh[..., :2] - xywh[..., 2:] / 2, xywh[..., :2] + xywh[..., 2:] / 2], -1)
    take = lambda x: np.take_along_axis(x, gt_idx.reshape(b, A, *([1] * (x.ndim - 2))), axis=1)
    labels = np.where(fg, take(batch["cls"]).astype(np.int32), 0)
    boxes = np.where(fg[..., None], take(xyxy), 0).astype(np.float32)
    assert m >= 1
    return labels, boxes, norm, fg, gt_idx


@pytest.mark.parametrize("task", ["segment", "pose"])
def test_foreground_cap_breaks_ties_as_lax_top_k(task, monkeypatch):
    """An image with 90 foreground anchors, most of one equal norm, above the
    cap of 64: both sides keep the same 64 (the lower index first among equal
    scores, ``lax.top_k``'s rule), shown on ``_topk_fg`` and through the
    whole loss with the same assignment forced on both assigners."""
    out, batch = _inputs(6, task)
    labels, boxes, norm, fg, gt_idx = _tied_assignment(batch, 2, (90, 30))
    jres = jtal.AssignResult(*(jnp.asarray(x) for x in (labels, boxes, norm, fg, gt_idx)))
    pres = ptal.AssignResult(*(torch.from_numpy(x).long() if x.dtype == np.int32 else torch.from_numpy(x)
                               for x in (labels, boxes, norm, fg, gt_idx)))
    jidx, jvalid = jtask._topk_fg({"assign": jres}, 64)
    pidx, pvalid = ptask._topk_fg(pres, 64)
    np.testing.assert_array_equal(pidx.numpy(), np.asarray(jidx))
    np.testing.assert_array_equal(pvalid.numpy(), np.asarray(jvalid))
    assert np.asarray(jvalid)[0].all() and np.asarray(jvalid)[1].sum() == 30
    # without the stable sort the kept set could differ: torch.topk is free to break ties otherwise
    monkeypatch.setattr(jtal, "assign", lambda *a, **k: jres)
    monkeypatch.setattr(ptal, "assign", lambda *a, **k: pres)
    _assert_match(*_run(task, out, batch, jit=False))


def test_obb_loss_gradients_are_finite_with_padding_rows():
    """Padded gt rows and anchors off the foreground: the unit-box guard keeps
    probiou's backward finite (without it the zero target boxes give NaN)."""
    out, batch = _inputs(5, "obb")
    batch["mask"][:, 3:] = False
    batch["bboxes"][:, 3:] = 0
    pout = _to_port(out)
    cfg = ploss.DetectionLossCfg(nc=NC)
    total, parts, _ = ptask.obb_loss(pout, {k: torch.from_numpy(v) for k, v in batch.items()}, cfg,
                                     ploss.LossState.init("cpu"))
    total.backward()
    assert torch.isfinite(total) and parts["fg_count"] > 0
    for t in [*pout["feats"], pout["angle"]]:
        assert torch.isfinite(t.grad).all()
    # the guard is what keeps them finite: probiou against a zero box has a NaN gradient
    box = torch.tensor([[1.0, 1.0, 2.0, 1.0, 0.3]], requires_grad=True)
    from fce_yolo_tpu_torch.ops.iou import probiou
    probiou(box, torch.zeros(1, 5)).sum().backward()
    assert not torch.isfinite(box.grad).all()


def test_detection_loss_aux_matches_jax():
    """``return_aux``: the assignment and the anchor grid equal JAX's; the
    detect outputs are unchanged by asking for them."""
    out, batch = _inputs(7, "segment")
    cfg = ploss.DetectionLossCfg(nc=NC, tal_dtype="float32")
    feats = [torch.from_numpy(f.transpose(0, 3, 1, 2).copy()) for f in out["feats"]]
    tb = {k: torch.from_numpy(v) for k, v in batch.items()}
    t1, p1, _ = ploss.detection_loss(feats, tb, cfg, ploss.LossState.init("cpu"))
    t2, p2, _, aux = ploss.detection_loss(feats, tb, cfg, ploss.LossState.init("cpu"), return_aux=True)
    assert float(t1) == float(t2) and all(float(p1[k]) == float(p2[k]) for k in p1)
    _, _, _, jaux = jloss.detection_loss([jnp.asarray(f) for f in out["feats"]],
                                         {k: jnp.asarray(v) for k, v in batch.items()},
                                         jloss.DetectionLossCfg(nc=NC, tal_dtype="float32"),
                                         jloss.LossState.init(), return_aux=True)
    assert aux["imgsz"] == jaux["imgsz"] == (IMGSZ, IMGSZ)
    np.testing.assert_array_equal(aux["anchor_points"].numpy(), np.asarray(jaux["anchor_points"]))
    np.testing.assert_array_equal(aux["stride_tensor"].numpy(), np.asarray(jaux["stride_tensor"]))
    np.testing.assert_array_equal(aux["assign"].fg_mask.numpy(), np.asarray(jaux["assign"].fg_mask))
    assert abs(float(aux["target_scores_sum"]) - float(jaux["target_scores_sum"])) <= 1e-5 * float(
        jaux["target_scores_sum"])
