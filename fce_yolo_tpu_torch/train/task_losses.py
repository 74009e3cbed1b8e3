"""Task losses beyond detect: segment, pose, OBB, classify and YOLOv10's
dual assignment (reference ``fce_yolo_tpu/train/task_losses.py:36-316``).

- Segment and pose add their terms to ``detection_loss`` on a fixed subset
  of foreground anchors per image: the first ``max_fg`` by assignment
  weight (``_topk_fg``), ties to the lower anchor index as ``lax.top_k``
  breaks them, so every shape is fixed and the terms are masked sums.
- Mask targets come as padded per-instance bitmaps (B, M, Hm, Wm), index
  aligned with the labels (``data/dataset.py::collate``).
- The head outputs are the port's train-mode dict (``nn/heads.py``):
  ``feats`` NCHW per level, ``mask_coefs``/``kpts``/``angle`` anchor-major in
  ``detection_loss``'s anchor order, ``proto`` (B, nm, Hp, Wp).

Each box loss returns (total, parts, state) with total = B times the sum of
the parts, as the JAX package does; the classification loss is the batch
mean.
"""

from __future__ import annotations

from typing import NamedTuple

import torch
import torch.nn.functional as F

from fce_yolo_tpu_torch.ops.anchors import bbox2dist, dfl_expectation, dist2rbox, make_anchors
from fce_yolo_tpu_torch.ops.iou import probiou
from fce_yolo_tpu_torch.train import tal
from fce_yolo_tpu_torch.train.loss import DetectionLossCfg, LossState, _dfl_loss, bce_with_logits, detection_loss

__all__ = ["OKS_SIGMA", "PoseLossCfg", "segmentation_loss", "pose_loss", "obb_loss", "classification_loss",
           "e2e_detect_loss", "task_loss_for"]

# COCO keypoint sigmas (reference task_losses.py:37-42)
OKS_SIGMA = torch.tensor([0.26, 0.25, 0.25, 0.35, 0.35, 0.79, 0.79, 0.72, 0.72, 0.62, 0.62, 1.07, 1.07, 0.87, 0.87,
                          0.89, 0.89], dtype=torch.float32) / 10.0


def _topk_fg(assign: tal.AssignResult, k: int) -> tuple[torch.Tensor, torch.Tensor]:
    """The first ``k`` anchors of each image by ``target_norm + fg_mask``,
    (idx (B, K) int64, valid (B, K) bool = those that are foreground). A
    stable descending sort keeps equal scores in index order, the tie rule
    of ``lax.top_k``; ``torch.topk`` promises none."""
    score = assign.target_norm + assign.fg_mask.float()
    idx = torch.sort(score, dim=1, descending=True, stable=True).indices[:, : min(k, score.shape[1])]
    return idx, torch.gather(assign.fg_mask, 1, idx)


def _take(x: torch.Tensor, idx: torch.Tensor) -> torch.Tensor:
    """Rows ``idx`` (B, K) along axis 1 of ``x`` (B, N, ...) -> (B, K, ...)."""
    return x[torch.arange(x.shape[0], device=x.device)[:, None], idx]


def _crop_weight(h: int, w: int, xyxy: torch.Tensor) -> torch.Tensor:
    """Inside-box indicator grid: xyxy (..., 4) in mask pixels -> (..., h, w)."""
    ys = torch.arange(h, dtype=xyxy.dtype, device=xyxy.device)[:, None]
    xs = torch.arange(w, dtype=xyxy.dtype, device=xyxy.device)[None, :]
    x1, y1, x2, y2 = (xyxy[..., i][..., None, None] for i in range(4))
    return ((xs >= x1) & (xs < x2) & (ys >= y1) & (ys < y2)).to(xyxy.dtype)


def segmentation_loss(out: dict, batch: dict[str, torch.Tensor], cfg: DetectionLossCfg, state: LossState,
                      max_fg: int = 64) -> tuple[torch.Tensor, dict[str, torch.Tensor], LossState]:
    """Detection loss + per-instance mask BCE inside the target box, divided
    by the box's normalized area (reference ``task_losses.py:67-111``).

    ``batch`` adds "masks" (B, M, Hm, Wm) binary; masks not at the
    prototypes' resolution are resized there by nearest neighbour with
    half-pixel centres (``jax.image.resize``'s "nearest" is
    ``F.interpolate``'s "nearest-exact"). parts adds "seg" (times the box gain).
    """
    total, parts, state, aux = detection_loss(out["feats"], batch, cfg, state, return_aux=True)
    proto = out["proto"]
    b, _, hm, wm = proto.shape
    imgsz_h, imgsz_w = aux["imgsz"]

    masks = batch["masks"].float()
    if masks.shape[-2:] != (hm, wm):
        masks = F.interpolate(masks, size=(hm, wm), mode="nearest-exact")

    assign = aux["assign"]
    idx, valid = _topk_fg(assign, max_fg)
    coefs = _take(out["mask_coefs"], idx)  # (B, K, nm)
    gt_mask = _take(masks, torch.gather(assign.target_gt_idx, 1, idx))  # (B, K, hm, wm)
    tbox = _take(assign.target_bboxes, idx)  # (B, K, 4) pixels

    tbox_n = tbox / torch.tensor([imgsz_w, imgsz_h, imgsz_w, imgsz_h], dtype=tbox.dtype, device=tbox.device)
    area = ((tbox_n[..., 2] - tbox_n[..., 0]) * (tbox_n[..., 3] - tbox_n[..., 1])).clamp(min=1e-4)
    mxyxy = tbox_n * torch.tensor([wm, hm, wm, hm], dtype=tbox.dtype, device=tbox.device)

    pred_mask = torch.einsum("bkn,bnhw->bkhw", coefs, proto)
    bce = bce_with_logits(pred_mask, gt_mask)
    per_anchor = (bce * _crop_weight(hm, wm, mxyxy)).mean(dim=(-2, -1)) / area  # (B, K)
    loss_seg = (per_anchor * valid).sum() / valid.sum().clamp(min=1)

    parts = dict(parts)
    parts["seg"] = loss_seg * cfg.box_gain
    return total + parts["seg"] * b, parts, state


class PoseLossCfg(NamedTuple):
    det: DetectionLossCfg = DetectionLossCfg(nc=1)
    kpt_shape: tuple[int, int] = (17, 3)
    pose_gain: float = 12.0
    kobj_gain: float = 1.0


def pose_loss(out: dict, batch: dict[str, torch.Tensor], cfg: PoseLossCfg, state: LossState,
              max_fg: int = 64) -> tuple[torch.Tensor, dict[str, torch.Tensor], LossState]:
    """Detection loss + OKS-style keypoint loss + visibility BCE (reference
    ``task_losses.py:114-182``).

    ``batch`` adds "keypoints" (B, M, nkpt, 3): x, y normalized, visibility.
    The sigmas are COCO's at 17 keypoints, else 1 / nkpt each; the keypoint
    loss is divided by (valid foreground anchors) * nkpt, not by the visible
    keypoints; with 2 values a keypoint there is no visibility term
    ("kobj" is 0). parts adds "kpt" and "kobj" (times their gains).
    """
    total, parts, state, aux = detection_loss(out["feats"], batch, cfg.det, state, return_aux=True)
    kpts_out = out["kpts"]
    b = kpts_out.shape[0]
    nkpt, ndim = cfg.kpt_shape
    imgsz_h, imgsz_w = aux["imgsz"]
    anchors, stride_t = aux["anchor_points"], aux["stride_tensor"]

    assign = aux["assign"]
    idx, valid = _topk_fg(assign, max_fg)
    raw = _take(kpts_out, idx).reshape(b, -1, nkpt, ndim)
    anc, strd = anchors[idx], stride_t[idx]  # (B, K, 2), (B, K, 1)
    pred_xy = (raw[..., :2] * 2.0 + (anc[:, :, None, :] - 0.5)) * strd[:, :, None, :]

    gt_k = _take(batch["keypoints"].float(), torch.gather(assign.target_gt_idx, 1, idx))  # (B, K, nkpt, 3)
    gt_xy = gt_k[..., :2] * torch.tensor([imgsz_w, imgsz_h], dtype=torch.float32, device=gt_k.device)
    kpt_mask = (gt_k[..., 2] != 0) & valid[..., None]  # (B, K, nkpt)

    tbox = _take(assign.target_bboxes, idx)
    area = ((tbox[..., 2] - tbox[..., 0]) * (tbox[..., 3] - tbox[..., 1])).clamp(min=1e-9)

    sigmas = (OKS_SIGMA if nkpt == 17 else torch.full((nkpt,), 1.0 / nkpt)).to(gt_k.device)
    d2 = ((pred_xy - gt_xy) ** 2).sum(-1)
    e = d2 / (2 * sigmas) ** 2 / (area[..., None] + 1e-9) / 2
    kpt_loss_factor = nkpt / kpt_mask.sum(-1, keepdim=True).clamp(min=1)
    n_terms = (valid.sum() * nkpt).clamp(min=1)
    loss_kpt = ((1 - torch.exp(-e)) * kpt_mask * kpt_loss_factor).sum() / n_terms
    if ndim == 3:
        bce = bce_with_logits(raw[..., 2], kpt_mask.float())
        loss_kobj = (bce * valid[..., None]).sum() / n_terms
    else:
        loss_kobj = torch.zeros((), device=gt_k.device)

    parts = dict(parts)
    parts["kpt"] = loss_kpt * cfg.pose_gain
    parts["kobj"] = loss_kobj * cfg.kobj_gain
    return total + (parts["kpt"] + parts["kobj"]) * b, parts, state


def obb_loss(out: dict, batch: dict[str, torch.Tensor], cfg: DetectionLossCfg,
             state: LossState) -> tuple[torch.Tensor, dict[str, torch.Tensor], LossState]:
    """Rotated-box loss (reference ``task_losses.py:185-286``).

    ``batch``: "cls" (B, M), "bboxes" (B, M, 5) normalized xywh + angle
    (radians), "mask" (B, M). The rotated assigner ranks by ``probiou``; the
    box loss is 1 - probiou; the DFL targets are the distances to the
    axis-aligned box of the target's centre, width and height.
    """
    feats, angle = out["feats"], out["angle"]
    nc, reg_max = cfg.nc, cfg.reg_max
    b = feats[0].shape[0]
    dtype, device = feats[0].dtype, feats[0].device
    flat = torch.cat([f.flatten(2).transpose(1, 2) for f in feats], dim=1)
    pred_distri, pred_scores = flat[..., : reg_max * 4], flat[..., reg_max * 4:]
    shapes = [(f.shape[2], f.shape[3]) for f in feats]
    anchor_points, stride_tensor = make_anchors(shapes, list(cfg.strides), 0.5, dtype=dtype, device=device)
    imgsz_h, imgsz_w = feats[0].shape[2] * cfg.strides[0], feats[0].shape[3] * cfg.strides[0]

    gt = batch["bboxes"].to(dtype)  # (B, M, 5)
    gt_rb = gt * torch.tensor([imgsz_w, imgsz_h, imgsz_w, imgsz_h, 1.0], dtype=dtype, device=device)
    mask_gt = batch["mask"] & (gt[..., 2] * gt[..., 3] > 0)

    angle = angle.to(dtype)
    pred_dist4 = pred_distri.reshape(b, -1, 4, reg_max)
    pred_rb = dist2rbox(dfl_expectation(pred_distri, reg_max), angle, anchor_points[None])  # grid units
    with torch.no_grad():
        pred_rb_px = torch.cat([pred_rb * stride_tensor[None], angle], dim=-1)
        assigned = tal.assign_rotated(pred_scores, pred_rb_px, anchor_points * stride_tensor, batch["cls"].long(),
                                      gt_rb, mask_gt, topk=cfg.tal_topk, alpha=cfg.tal_alpha, beta=cfg.tal_beta,
                                      scores_logits=True, metric_dtype=getattr(torch, cfg.tal_dtype))
    norm, fg = assigned.target_norm, assigned.fg_mask
    target_scores_sum = norm.sum().clamp(min=1.0)

    x_at_label = torch.gather(pred_scores, 2, assigned.target_labels[..., None])[..., 0]
    loss_cls = (F.softplus(pred_scores).sum() - (norm * x_at_label).sum()) / target_scores_sum

    tb = torch.cat([assigned.target_bboxes[..., :4] / stride_tensor[None], assigned.target_bboxes[..., 4:]], dim=-1)
    # off the foreground the targets are zero boxes, where probiou's backward
    # takes 0/0 even under a zero weight (NaN * 0 = NaN): a unit box stands there
    safe = torch.tensor([0.0, 0.0, 1.0, 1.0, 0.0], dtype=tb.dtype, device=device)
    tb = torch.where(fg[..., None], tb, safe)
    iou = probiou(torch.cat([pred_rb, angle], dim=-1), tb)
    loss_box = ((1.0 - iou) * norm).sum() / target_scores_sum

    half = tb[..., 2:4] / 2
    tb_xyxy = torch.cat([tb[..., :2] - half, tb[..., :2] + half], dim=-1)
    dfl = _dfl_loss(pred_dist4, bbox2dist(anchor_points[None], tb_xyxy, reg_max), reg_max)
    loss_dfl = (dfl * norm).sum() / target_scores_sum

    parts = {
        "box": loss_box * cfg.box_gain,
        "cls": loss_cls * cfg.cls_gain,
        "dfl": loss_dfl * cfg.dfl_gain,
        "fg_count": fg.sum().float(),
    }
    return (parts["box"] + parts["cls"] + parts["dfl"]) * b, parts, state


def classification_loss(logits: torch.Tensor, labels: torch.Tensor) -> tuple[torch.Tensor, dict]:
    """Cross-entropy (reference ``task_losses.py:289-293``): the batch mean of
    -log softmax at each label, in float32; (loss, {"cls": loss})."""
    nll = -torch.log_softmax(logits.float(), -1).gather(-1, labels.long()[:, None]).mean()
    return nll, {"cls": nll}


def _classify_task_loss(out: dict, batch: dict, _cfg, state: LossState):
    """``classification_loss`` as the train step's ``task_loss``: the labels come as the batch's "cls"."""
    loss, parts = classification_loss(out["logits"], batch["cls"])
    return loss, parts, state


def e2e_detect_loss(out: dict, batch: dict[str, torch.Tensor], cfg: DetectionLossCfg,
                    state: LossState) -> tuple[torch.Tensor, dict[str, torch.Tensor], LossState]:
    """YOLOv10's dual-assignment loss (reference ``task_losses.py:296-316``,
    Ultralytics ``E2EDetectLoss``): ``detection_loss`` on the one-to-many
    ``feats`` with top-10 TAL, then on ``one2one_feats`` with top-1 TAL;
    the totals and the box/cls/dfl parts summed, each branch's parts kept
    as ``one2many_*`` and ``one2one_*``. The WIoU v3 running mean goes
    through both calls, one-to-many first. The one-to-one maps come from
    detached inputs (``V10Detect``), so that loss trains its own head only."""
    many_total, many, state = detection_loss(out["feats"], batch, cfg._replace(tal_topk=10), state)
    one_total, one, state = detection_loss(out["one2one_feats"], batch, cfg._replace(tal_topk=1), state)
    parts = {**{f"one2many_{k}": v for k, v in many.items()}, **{f"one2one_{k}": v for k, v in one.items()}}
    parts.update({k: many[k] + one[k] for k in ("box", "cls", "dfl")})
    return many_total + one_total, parts, state


def task_loss_for(task: str, cfg: DetectionLossCfg, kpt_shape: tuple[int, int] = (17, 3), end2end: bool = False):
    """The train step's ``task_loss`` of a task and the batch keys it reads
    beyond the boxes (reference ``api.py:656-677``): (None, ()) for detect,
    which takes ``detection_loss``, and ``e2e_detect_loss`` for a detect
    model whose head is V10Detect (``end2end``); pose takes
    ``PoseLossCfg(det=cfg, kpt_shape=kpt_shape)``; classify reads the labels
    as "cls"."""
    if task == "classify":
        return _classify_task_loss, ()
    if task == "segment":
        return segmentation_loss, ("masks",)
    if task == "obb":
        return obb_loss, ()
    if task == "pose":
        pose_cfg = PoseLossCfg(det=cfg, kpt_shape=tuple(kpt_shape))
        return (lambda out, batch, _cfg, state: pose_loss(out, batch, pose_cfg, state)), ("keypoints",)
    return (e2e_detect_loss if end2end else None), ()
