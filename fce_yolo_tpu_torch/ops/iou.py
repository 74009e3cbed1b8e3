"""IoU family (reference ``fce_yolo_tpu/ops/iou.py:21-169``): IoU, GIoU,
DIoU and CIoU between broadcastable box tensors, Wise-IoU v1, the
pairwise (N, M) IoU, and the probabilistic IoU of rotated boxes. Each function consumes the trailing 4-axis; the CIoU
aspect-ratio weight is taken without gradient, as the JAX package's
``stop_gradient`` does."""

from __future__ import annotations

import math

import torch

__all__ = ["bbox_iou", "bbox_wiou", "box_iou_pairwise", "probiou"]


def _corners(box: torch.Tensor, xywh: bool):
    if xywh:
        x, y, w, h = box.unbind(-1)
        hw, hh = w * 0.5, h * 0.5
        return x - hw, y - hh, x + hw, y + hh, w, h
    x1, y1, x2, y2 = box.unbind(-1)
    return x1, y1, x2, y2, x2 - x1, y2 - y1


def bbox_iou(box1: torch.Tensor, box2: torch.Tensor, xywh: bool = True, mode: str = "IoU",
             eps: float = 1e-7) -> torch.Tensor:
    """Elementwise IoU of broadcastable (..., 4) boxes; ``mode`` one of
    "IoU", "GIoU", "DIoU", "CIoU". With ``xywh=False`` the heights get
    ``+ eps`` as in the JAX package."""
    b1_x1, b1_y1, b1_x2, b1_y2, w1, h1 = _corners(box1, xywh)
    b2_x1, b2_y1, b2_x2, b2_y2, w2, h2 = _corners(box2, xywh)
    if not xywh:
        h1 = h1 + eps
        h2 = h2 + eps
    inter = (torch.minimum(b1_x2, b2_x2) - torch.maximum(b1_x1, b2_x1)).clamp(min=0) * (
        torch.minimum(b1_y2, b2_y2) - torch.maximum(b1_y1, b2_y1)).clamp(min=0)
    union = w1 * h1 + w2 * h2 - inter + eps
    iou = inter / union
    if mode == "IoU":
        return iou
    cw = torch.maximum(b1_x2, b2_x2) - torch.minimum(b1_x1, b2_x1)  # enclosing width
    ch = torch.maximum(b1_y2, b2_y2) - torch.minimum(b1_y1, b2_y1)  # enclosing height
    if mode == "GIoU":
        c_area = cw * ch + eps
        return iou - (c_area - union) / c_area
    c2 = cw * cw + ch * ch + eps  # enclosing diagonal squared
    rho2 = ((b2_x1 + b2_x2 - b1_x1 - b1_x2) ** 2 + (b2_y1 + b2_y2 - b1_y1 - b1_y2) ** 2) / 4
    if mode == "DIoU":
        return iou - rho2 / c2
    if mode == "CIoU":
        v = (4 / math.pi**2) * (torch.atan(w2 / h2) - torch.atan(w1 / h1)) ** 2
        with torch.no_grad():  # v = 0 (equal aspect ratios) gives a zero weight, not 0/0
            denom = v - iou + (1 + eps)
            alpha = torch.where(v > 0, v / torch.where(v > 0, denom, torch.ones_like(denom)), torch.zeros_like(v))
        return iou - (rho2 / c2 + v * alpha)
    raise ValueError(f"unknown IoU mode {mode!r}")


def bbox_wiou(box1: torch.Tensor, box2: torch.Tensor, xywh: bool = True, eps: float = 1e-7) -> torch.Tensor:
    """Wise-IoU v1 metric ``1 - exp(rho^2 / C^2) * (1 - IoU)`` (higher is
    better; loss = 1 - metric). With ``xywh=False`` widths and heights are
    clamped to ``eps``. The v3 focusing, which carries state, is in
    ``train/loss.py``."""
    b1_x1, b1_y1, b1_x2, b1_y2, w1, h1 = _corners(box1, xywh)
    b2_x1, b2_y1, b2_x2, b2_y2, w2, h2 = _corners(box2, xywh)
    if not xywh:
        w1, h1, w2, h2 = (t.clamp(min=eps) for t in (w1, h1, w2, h2))
    inter = (torch.minimum(b1_x2, b2_x2) - torch.maximum(b1_x1, b2_x1)).clamp(min=0) * (
        torch.minimum(b1_y2, b2_y2) - torch.maximum(b1_y1, b2_y1)).clamp(min=0)
    union = w1 * h1 + w2 * h2 - inter + eps
    iou = inter / union
    cw = torch.maximum(b1_x2, b2_x2) - torch.minimum(b1_x1, b2_x1)
    ch = torch.maximum(b1_y2, b2_y2) - torch.minimum(b1_y1, b2_y1)
    rho2 = ((b2_x1 + b2_x2 - b1_x1 - b1_x2) ** 2 + (b2_y1 + b2_y2 - b1_y1 - b1_y2) ** 2) / 4
    c2 = cw * cw + ch * ch + eps
    return 1.0 - torch.exp(rho2 / c2) * (1.0 - iou)  # rho2 / c2 <= 1: the exp is bounded


def box_iou_pairwise(box1: torch.Tensor, box2: torch.Tensor, eps: float = 1e-7) -> torch.Tensor:
    """IoU of every pair of (N, 4) and (M, 4) xyxy boxes -> (N, M)."""
    lt = torch.maximum(box1[:, None, :2], box2[None, :, :2])
    rb = torch.minimum(box1[:, None, 2:], box2[None, :, 2:])
    inter = (rb - lt).clamp(min=0).prod(-1)
    area1 = (box1[:, 2:] - box1[:, :2]).clamp(min=0).prod(-1)
    area2 = (box2[:, 2:] - box2[:, :2]).clamp(min=0).prod(-1)
    return inter / (area1[:, None] + area2[None, :] - inter + eps)


def _obb_covariance(obb: torch.Tensor) -> tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """Gaussian covariance terms (a, b, c) of (..., 5) xywhr boxes (reference iou.py:134-147)."""
    w, h, r = obb[..., 2], obb[..., 3], obb[..., 4]
    a = w * w / 12.0
    b = h * h / 12.0
    cos, sin = torch.cos(r), torch.sin(r)
    return a * cos * cos + b * sin * sin, a * sin * sin + b * cos * cos, (a - b) * cos * sin


def probiou(obb1: torch.Tensor, obb2: torch.Tensor, eps: float = 1e-7) -> torch.Tensor:
    """Probabilistic IoU of broadcastable (..., 5) xywhr boxes: one minus the
    Hellinger distance of their Gaussians (reference iou.py:150-169,
    arXiv:2106.06072), op by op in the JAX order."""
    x1, y1 = obb1[..., 0], obb1[..., 1]
    x2, y2 = obb2[..., 0], obb2[..., 1]
    a1, b1, c1 = _obb_covariance(obb1)
    a2, b2, c2 = _obb_covariance(obb2)
    dy, dx = y1 - y2, x1 - x2
    den = (a1 + a2) * (b1 + b2) - (c1 + c2) * (c1 + c2) + eps
    t1 = ((a1 + a2) * (dy * dy) + (b1 + b2) * (dx * dx)) / den * 0.25
    t2 = ((c1 + c2) * (x2 - x1) * dy) / den * 0.5
    det1 = (a1 * b1 - c1 * c1).clamp(min=0.0)
    det2 = (a2 * b2 - c2 * c2).clamp(min=0.0)
    t3 = torch.log((den - eps + eps) / (4.0 * torch.sqrt(det1 * det2) + eps) + eps) * 0.5
    bd = (t1 + t2 + t3).clamp(eps, 100.0)
    return 1.0 - torch.sqrt(1.0 - torch.exp(-bd) + eps)
