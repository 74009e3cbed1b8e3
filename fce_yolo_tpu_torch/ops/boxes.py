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


def detr_detections(preds: torch.Tensor, imgsz: int, conf: float, max_det: int | None = None
                    ) -> dict[str, torch.Tensor]:
    """An RT-DETR head's ``preds`` (B, nq, 4 + nc), normalized xywh and
    sigmoid scores, as detections without NMS (reference
    ``fce_yolo_tpu/engine/predictor.py:194-208`` and ``RTDETRValidator``,
    validator.py:339-375): xyxy in ``imgsz`` pixels, one class a query (the
    first of its highest score), rows in descending score from a stable sort
    (``jnp.argsort``'s order: equal scores keep query order), the first
    ``max_det`` of them when given; ``valid`` where the score is above
    ``conf``, ``classes`` -1 elsewhere."""
    boxes = xywh2xyxy(preds[..., :4].float() * imgsz)
    scores = preds[..., 4:].float()
    best, cls = scores.amax(-1), scores.argmax(-1).to(torch.int32)
    order = torch.sort(best, dim=-1, descending=True, stable=True).indices[:, :max_det]
    best, cls = torch.gather(best, 1, order), torch.gather(cls, 1, order)
    boxes = torch.gather(boxes, 1, order[..., None].expand(-1, -1, 4))
    valid = best > conf
    return {"boxes": boxes, "scores": best, "classes": torch.where(valid, cls, torch.full_like(cls, -1)),
            "valid": valid}
