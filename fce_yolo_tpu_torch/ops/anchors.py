"""Anchor grids, distance -> box transform and DFL expectation decode
(reference ``fce_yolo_tpu/ops/anchors.py:17-96``). Trailing-axis layouts,
anchor-major like the reference."""

from __future__ import annotations

import torch


def make_anchors(
    feat_shapes: list[tuple[int, int]],
    strides: list[int],
    grid_cell_offset: float = 0.5,
    dtype: torch.dtype = torch.float32,
    device: torch.device | str = "cpu",
) -> tuple[torch.Tensor, torch.Tensor]:
    """Concatenated anchor centers (sum(h*w), 2) and per-anchor strides (sum(h*w), 1)."""
    points, stride_t = [], []
    for (h, w), s in zip(feat_shapes, strides):
        sx = torch.arange(w, dtype=dtype, device=device) + grid_cell_offset
        sy = torch.arange(h, dtype=dtype, device=device) + grid_cell_offset
        gy, gx = torch.meshgrid(sy, sx, indexing="ij")
        points.append(torch.stack([gx, gy], dim=-1).reshape(-1, 2))
        stride_t.append(torch.full((h * w, 1), float(s), dtype=dtype, device=device))
    return torch.cat(points, dim=0), torch.cat(stride_t, dim=0)


def dist2bbox(distance: torch.Tensor, anchor_points: torch.Tensor, xywh: bool = True) -> torch.Tensor:
    """(l, t, r, b) distances around anchors -> xywh (or xyxy) boxes."""
    lt, rb = distance[..., :2], distance[..., 2:4]
    x1y1 = anchor_points - lt
    x2y2 = anchor_points + rb
    if xywh:
        return torch.cat([(x1y1 + x2y2) * 0.5, x2y2 - x1y1], dim=-1)
    return torch.cat([x1y1, x2y2], dim=-1)


def dfl_expectation(pred_dist: torch.Tensor, reg_max: int = 16) -> torch.Tensor:
    """DFL decode: softmax over ``reg_max`` bins times arange, per side.

    ``pred_dist``: (..., 4 * reg_max) logits in bin-major [l, t, r, b] groups.
    Returns (..., 4) expected distances in the input dtype.
    """
    x = pred_dist.reshape(*pred_dist.shape[:-1], 4, reg_max).softmax(dim=-1)
    proj = torch.arange(reg_max, dtype=x.dtype, device=x.device)
    return torch.einsum("...kr,r->...k", x, proj)
