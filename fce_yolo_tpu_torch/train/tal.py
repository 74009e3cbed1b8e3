"""Task-aligned assigner (reference ``fce_yolo_tpu/train/tal.py:51-281``),
axis-aligned (``assign``) and rotated (``assign_rotated``).

For each ground truth: align metric = score(gt class)^alpha * CIoU^beta
over the anchors whose centres lie inside its box; its candidates are the
anchors whose metric reaches its K-th largest (a threshold, not the indices
of a ``torch.topk``, so anchors tied at the K-th value all count, as in the
JAX form, and the foreground mask matches it on ties too) and is positive.
An anchor claimed by several goes to the one it overlaps most. The target
weight is the metric rescaled per ground truth so its best anchor gets its
best overlap.

Two (B, M, A) tensors are kept: the float32 ranking metric and the
overlaps, stored in ``metric_dtype`` (bf16 by default, rounded to nearest
even as XLA does) while all arithmetic stays float32. Per-anchor lookups
are gathers along the ground-truth axis. The caller runs this without
gradient.
"""

from __future__ import annotations

from typing import NamedTuple

import torch

from fce_yolo_tpu_torch.ops.iou import bbox_iou, probiou

__all__ = ["AssignResult", "assign", "assign_rotated"]


class AssignResult(NamedTuple):
    target_labels: torch.Tensor  # (B, A) int64, 0 outside fg
    target_bboxes: torch.Tensor  # (B, A, 4) xyxy (5, xywhr, when rotated), 0 outside fg
    target_norm: torch.Tensor  # (B, A) float32 = dense target_scores.sum(-1), 0 outside fg
    fg_mask: torch.Tensor  # (B, A) bool
    target_gt_idx: torch.Tensor  # (B, A) int64


def _kth_value(metric: torch.Tensor, topk: int) -> torch.Tensor:
    """K-th largest value along the last axis, (B, M, 1); duplicates count
    separately (the multiset order of ``lax.top_k``). With fewer than K
    anchors it is the smallest, which admits every positive one, as the JAX
    knockout's -inf does."""
    return torch.topk(metric, min(topk, metric.shape[-1]), dim=-1).values[..., -1:]


def _finalize(metric: torch.Tensor, overlaps: torch.Tensor, live: torch.Tensor, kth: torch.Tensor,
              labels: torch.Tensor, gt_bboxes: torch.Tensor, eps: float) -> AssignResult:
    """Claims, multi-claim resolution and the targets (reference ``tal.py:85-157``)."""
    m = metric.shape[1]
    # ``> 0``: a gt whose in-box metrics are all zero claims nothing (its
    # kth would be 0 and take every live anchor)
    mask_pos = live & (metric >= kth) & (metric > 0)
    count = mask_pos.sum(dim=1)  # (B, A) claims per anchor
    single_gt = mask_pos.to(torch.uint8).argmax(dim=1)  # first claimant
    max_overlap_gt = overlaps.argmax(dim=1)  # first of the largest overlap, claimant or not
    fg_mask = count > 0
    target_gt_idx = torch.where(count > 1, max_overlap_gt, single_gt)

    assigned = fg_mask[:, None, :] & (target_gt_idx[:, None, :] == torch.arange(m, device=metric.device)[None, :, None])
    metric_sel = torch.where(assigned, metric, 0.0)
    pos_align = metric_sel.amax(dim=2)  # (B, M) best metric among a gt's anchors
    pos_overlap = torch.where(assigned, overlaps.float(), 0.0).amax(dim=2)  # (B, M) best overlap
    gt_scale = pos_overlap / (pos_align + eps)
    metric_at = metric_sel.sum(dim=1)  # (B, A): the assigned gt's metric (one term)
    norm = metric_at * torch.gather(gt_scale, 1, target_gt_idx)

    target_labels = torch.where(fg_mask, torch.gather(labels, 1, target_gt_idx), 0)
    idx4 = target_gt_idx[..., None].expand(-1, -1, gt_bboxes.shape[-1])
    target_bboxes = torch.where(fg_mask[..., None], torch.gather(gt_bboxes, 1, idx4), 0.0)
    return AssignResult(
        target_labels=target_labels,
        target_bboxes=target_bboxes,
        target_norm=torch.where(fg_mask, norm, 0.0),
        fg_mask=fg_mask,
        target_gt_idx=target_gt_idx,
    )


def assign(
    pd_scores: torch.Tensor,  # (B, A, nc) sigmoid scores, or logits with scores_logits
    pd_bboxes: torch.Tensor,  # (B, A, 4) xyxy pixels
    anc_points: torch.Tensor,  # (A, 2) anchor centres, pixels
    gt_labels: torch.Tensor,  # (B, M) int
    gt_bboxes: torch.Tensor,  # (B, M, 4) xyxy pixels
    mask_gt: torch.Tensor,  # (B, M) bool: real (not padded) gts
    topk: int = 10,
    alpha: float = 0.5,
    beta: float = 6.0,
    eps: float = 1e-9,
    scores_logits: bool = False,
    metric_dtype: torch.dtype = torch.bfloat16,
) -> AssignResult:
    """Task-aligned one-to-many assignment (reference ``tal.py:160-222``).

    ``scores_logits``: ``pd_scores`` are logits; the sigmoid is taken after
    the per-gt class gather. ``metric_dtype``: storage type of the overlaps.
    """
    b, a_n, nc = pd_scores.shape
    m = gt_labels.shape[1]
    labels = gt_labels.long().clamp(0, nc - 1)  # (B, M)

    gx1, gy1, gx2, gy2 = (gt_bboxes[..., i][:, :, None] for i in range(4))
    ax, ay = anc_points[None, None, :, 0], anc_points[None, None, :, 1]
    in_gts = (ax - gx1 > eps) & (ay - gy1 > eps) & (gx2 - ax > eps) & (gy2 - ay > eps)  # centre strictly inside
    live = in_gts & mask_gt[:, :, None]  # (B, M, A)

    cls_sc = torch.gather(pd_scores, 2, labels[:, None, :].expand(b, a_n, m)).transpose(1, 2)  # (B, M, A)
    if scores_logits:
        cls_sc = torch.sigmoid(cls_sc)
    ov = bbox_iou(gt_bboxes[:, :, None, :], pd_bboxes[:, None, :, :], xywh=False, mode="CIoU").clamp(min=0)
    overlaps = torch.where(live, ov, 0.0).to(metric_dtype)
    # the ranking metric stays float32: rounded, K-th-value ties would be common early in training
    metric = torch.where(live, cls_sc**alpha * ov**beta, 0.0)
    kth = _kth_value(metric, topk)
    return _finalize(metric, overlaps, live, kth, labels, gt_bboxes, eps)


def assign_rotated(
    pd_scores: torch.Tensor,  # (B, A, nc) sigmoid scores, or logits with scores_logits
    pd_rboxes: torch.Tensor,  # (B, A, 5) xywhr pixels
    anc_points: torch.Tensor,  # (A, 2) anchor centres, pixels
    gt_labels: torch.Tensor,  # (B, M) int
    gt_rboxes: torch.Tensor,  # (B, M, 5) xywhr pixels
    mask_gt: torch.Tensor,  # (B, M) bool
    topk: int = 10,
    alpha: float = 0.5,
    beta: float = 6.0,
    eps: float = 1e-9,
    scores_logits: bool = False,
    metric_dtype: torch.dtype = torch.bfloat16,
) -> AssignResult:
    """Rotated task-aligned assignment (reference ``tal.py:224-281``): the
    candidates are the anchors inside the rotated gt box (the projections
    of corner A -> anchor on the box's two edge vectors lie within the
    edges, bounds included), the overlaps are ``probiou`` clipped at 0; the
    rest is ``assign``'s. The targets are the gts' xywhr boxes."""
    b, a_n, nc = pd_scores.shape
    m = gt_labels.shape[1]
    labels = gt_labels.long().clamp(0, nc - 1)

    cx, cy, w, h, r = gt_rboxes.unbind(-1)
    cos, sin = torch.cos(r), torch.sin(r)
    dx1, dy1 = w / 2 * cos, w / 2 * sin  # half-width vector
    dx2, dy2 = -h / 2 * sin, h / 2 * cos  # half-height vector
    a_x, a_y = (cx - dx1 - dx2)[:, :, None], (cy - dy1 - dy2)[:, :, None]  # corner A
    abx, aby = (2 * dx1)[:, :, None], (2 * dy1)[:, :, None]
    adx, ady = (2 * dx2)[:, :, None], (2 * dy2)[:, :, None]
    norm_ab, norm_ad = abx * abx + aby * aby, adx * adx + ady * ady
    apx, apy = anc_points[None, None, :, 0] - a_x, anc_points[None, None, :, 1] - a_y
    ap_ab, ap_ad = apx * abx + apy * aby, apx * adx + apy * ady
    inside = (ap_ab >= 0) & (ap_ab <= norm_ab) & (ap_ad >= 0) & (ap_ad <= norm_ad)
    live = inside & mask_gt[:, :, None]  # (B, M, A)

    cls_sc = torch.gather(pd_scores, 2, labels[:, None, :].expand(b, a_n, m)).transpose(1, 2)
    if scores_logits:
        cls_sc = torch.sigmoid(cls_sc)
    ov = probiou(gt_rboxes[:, :, None, :], pd_rboxes[:, None, :, :]).clamp(min=0)
    overlaps = torch.where(live, ov, 0.0).to(metric_dtype)
    metric = torch.where(live, cls_sc**alpha * ov**beta, 0.0)  # float32 ranking, as in assign
    kth = _kth_value(metric, topk)
    return _finalize(metric, overlaps, live, kth, labels, gt_rboxes, eps)
