"""Detection training loss (reference ``fce_yolo_tpu/train/loss.py:32-241``):
BCE on the classes, an IoU-family box loss (CIoU, DIoU, GIoU, or WIoU v3
with its dynamic focusing) and DFL, against task-aligned targets.

- Ground truths come padded, (B, M) with a validity mask, as the JAX batch.
- Every term is dense over the anchors, weighted by the target norm, which
  is zero off the foreground.
- The WIoU v3 running mean is explicit state: ``LossState`` goes in and a
  new one comes out; nothing is kept on a module.
- The assigner runs under ``torch.no_grad()``.
"""

from __future__ import annotations

from typing import NamedTuple

import torch
import torch.nn.functional as F

from fce_yolo_tpu_torch.ops.anchors import bbox2dist, dfl_expectation, dist2bbox, make_anchors
from fce_yolo_tpu_torch.ops.boxes import xywh2xyxy
from fce_yolo_tpu_torch.ops.iou import bbox_iou, bbox_wiou
from fce_yolo_tpu_torch.train import tal

__all__ = ["LossState", "DetectionLossCfg", "wiouv3_focusing", "detection_loss", "bce_with_logits"]


class LossState(NamedTuple):
    """State carried from step to step: the WIoU v3 running mean."""

    wiou_loss_mean: torch.Tensor  # scalar float32; < 0 until the first batch with foreground

    @staticmethod
    def init(device: torch.device | str = "cuda") -> "LossState":
        return LossState(wiou_loss_mean=torch.tensor(-1.0, device=device))


def wiouv3_focusing(loss_iou: torch.Tensor, fg: torch.Tensor, state: LossState, delta: float = 3.0,
                    alpha: float = 1.9, momentum: float = 0.9, eps: float = 1e-7) -> tuple[torch.Tensor, LossState]:
    """WIoU v3 focusing coefficient r = beta / (delta * alpha^(beta - delta)),
    beta = L_i / running mean of L over the foreground (reference ``loss.py:42-80``).

    The new mean weights the batch's mean by ``momentum`` (0.9), as the
    reference does; a batch without foreground leaves it as it was. Returns
    (r (B, A), 0 off the foreground; the new state). No gradient flows
    through r.
    """
    loss_iou = loss_iou.detach().clamp(0.0, 4.0)
    n_fg = fg.sum()
    batch_mean = ((loss_iou * fg).sum() / n_fg.clamp(min=1)).clamp(min=eps)
    mean = torch.where(state.wiou_loss_mean < 0, batch_mean, state.wiou_loss_mean)
    beta = loss_iou / (mean + eps)
    r = (beta / (delta * torch.pow(alpha, beta - delta))).clamp(0.0, 4.0)
    new_mean = torch.where(n_fg > 0, (1 - momentum) * mean + momentum * batch_mean, state.wiou_loss_mean)
    return torch.where(fg, r, 0.0), LossState(wiou_loss_mean=new_mean)


def _dfl_loss(pred_dist: torch.Tensor, target: torch.Tensor, reg_max: int) -> torch.Tensor:
    """Distribution focal loss: (B, A, 4, reg_max) logits against (B, A, 4)
    distances -> (B, A), the mean over the sides of
    wl * CE(floor) + wr * CE(floor + 1) = logsumexp - (wl * x_l + wr * x_r)."""
    target = target.clamp(0, reg_max - 1 - 0.01)
    tl = target.floor().long()
    tr = (tl + 1).clamp(0, reg_max - 1)
    wl = (tl + 1).to(target.dtype) - target
    wr = 1.0 - wl
    lse = torch.logsumexp(pred_dist, dim=-1)
    x_l = torch.gather(pred_dist, -1, tl[..., None])[..., 0]
    x_r = torch.gather(pred_dist, -1, tr[..., None])[..., 0]
    return (lse - (wl * x_l + wr * x_r)).mean(dim=-1)


class DetectionLossCfg(NamedTuple):
    nc: int = 80
    reg_max: int = 16
    strides: tuple[int, ...] = (8, 16, 32)
    box_gain: float = 7.5
    cls_gain: float = 0.5
    dfl_gain: float = 1.5
    iou_type: str = "CIoU"  # CIoU | DIoU | GIoU | WIoU
    tal_topk: int = 10
    tal_alpha: float = 0.5
    tal_beta: float = 6.0
    tal_dtype: str = "bfloat16"  # storage type of the assigner's overlaps


def detection_loss(feats: list[torch.Tensor], batch: dict[str, torch.Tensor], cfg: DetectionLossCfg,
                   state: LossState, return_aux: bool = False):
    """Summed detection loss of one batch (reference ``loss.py:121-241``).

    Args:
        feats: the train-mode head maps, (B, 4 * reg_max + nc, H, W) per level.
        batch: "cls" (B, M), "bboxes" (B, M, 4) xywh normalized to [0, 1],
            "mask" (B, M) bool, on the feats' device.
        cfg: hyperparameters; state: the WIoU running mean (passed through
            unchanged by the other IoU types).

    Returns (total, parts {"box", "cls", "dfl", "fg_count"}, new state);
    total = (box + cls + dfl) * B, each part already times its gain. With
    ``return_aux`` a fourth item holds what the task losses build on:
    "assign" (the ``AssignResult``), "target_scores_sum", "stride_tensor",
    "anchor_points" and "imgsz" (h, w).
    """
    nc, reg_max = cfg.nc, cfg.reg_max
    b = feats[0].shape[0]
    dtype, device = feats[0].dtype, feats[0].device
    # NCHW -> (B, H*W, no): anchors in row-major (y, x) order per level, as the JAX NHWC reshape
    flat = torch.cat([f.flatten(2).transpose(1, 2) for f in feats], dim=1)
    pred_distri, pred_scores = flat[..., : reg_max * 4], flat[..., reg_max * 4:]

    shapes = [(f.shape[2], f.shape[3]) for f in feats]
    anchor_points, stride_tensor = make_anchors(shapes, list(cfg.strides), 0.5, dtype=dtype, device=device)
    imgsz_h, imgsz_w = feats[0].shape[2] * cfg.strides[0], feats[0].shape[3] * cfg.strides[0]

    scale = torch.tensor([imgsz_w, imgsz_h, imgsz_w, imgsz_h], dtype=dtype, device=device)
    gt_bboxes = xywh2xyxy(batch["bboxes"] * scale)  # (B, M, 4) pixel xyxy
    gt_labels = batch["cls"].long()
    mask_gt = batch["mask"] & (batch["bboxes"].sum(-1) > 0)

    pred_dist4 = pred_distri.reshape(b, -1, 4, reg_max)
    pred_bboxes = dist2bbox(dfl_expectation(pred_distri, reg_max), anchor_points[None], xywh=False)  # grid units

    with torch.no_grad():
        assigned = tal.assign(pred_scores, pred_bboxes * stride_tensor[None], anchor_points * stride_tensor,
                              gt_labels, gt_bboxes, mask_gt, topk=cfg.tal_topk, alpha=cfg.tal_alpha,
                              beta=cfg.tal_beta, scores_logits=True, metric_dtype=getattr(torch, cfg.tal_dtype))
    norm, fg = assigned.target_norm, assigned.fg_mask
    target_scores_sum = norm.sum().clamp(min=1.0)

    # BCE against one_hot(label) * norm in closed form: sum softplus(x) - sum norm * x[label]
    x_at_label = torch.gather(pred_scores, 2, assigned.target_labels[..., None])[..., 0]
    loss_cls = (F.softplus(pred_scores).sum() - (norm * x_at_label).sum()) / target_scores_sum

    tb = assigned.target_bboxes / stride_tensor[None]
    if cfg.iou_type == "WIoU":
        li = 1.0 - bbox_wiou(pred_bboxes, tb, xywh=False)
        r, state = wiouv3_focusing(li, fg, state)
        loss_box = (r * li * norm).sum() / target_scores_sum
    else:
        iou = bbox_iou(pred_bboxes, tb, xywh=False, mode=cfg.iou_type)
        loss_box = ((1.0 - iou) * norm).sum() / target_scores_sum

    dfl = _dfl_loss(pred_dist4, bbox2dist(anchor_points[None], tb, reg_max), reg_max)
    loss_dfl = (dfl * norm).sum() / target_scores_sum

    parts = {
        "box": loss_box * cfg.box_gain,
        "cls": loss_cls * cfg.cls_gain,
        "dfl": loss_dfl * cfg.dfl_gain,
        "fg_count": fg.sum().float(),
    }
    total = (parts["box"] + parts["cls"] + parts["dfl"]) * b
    if return_aux:
        aux = {"assign": assigned, "target_scores_sum": target_scores_sum, "stride_tensor": stride_tensor,
               "anchor_points": anchor_points, "imgsz": (imgsz_h, imgsz_w)}
        return total, parts, state, aux
    return total, parts, state


def bce_with_logits(logits: torch.Tensor, targets: torch.Tensor) -> torch.Tensor:
    """Elementwise binary cross-entropy with logits, in the JAX package's
    form (``loss.py:244-246``): max(x, 0) - x * t + log1p(exp(-|x|))."""
    return logits.clamp(min=0) - logits * targets + torch.log1p(torch.exp(-logits.abs()))
