"""Box helpers the inference slice needs (reference ``fce_yolo_tpu/ops/boxes.py:18-30``)."""

from __future__ import annotations

import math

import torch


def make_divisible(x: float, divisor: int = 8) -> int:
    """Round ``x`` up to the nearest multiple of ``divisor`` (host-side int math)."""
    return int(math.ceil(x / divisor) * divisor)


def xywh2xyxy(x: torch.Tensor) -> torch.Tensor:
    """(cx, cy, w, h) -> (x1, y1, x2, y2) on the trailing axis."""
    xy, wh = x[..., :2], x[..., 2:4]
    half = wh * 0.5
    return torch.cat([xy - half, xy + half], dim=-1)
