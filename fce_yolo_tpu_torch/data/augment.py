"""Letterbox and the val transform (reference ``fce_yolo_tpu/data/augment.py:61-102,
598-616``) with no cv2.

The resize is ``F.interpolate(mode="bilinear", align_corners=False,
antialias=False)`` in float32, rounded to uint8. cv2's INTER_LINEAR works in
fixed point on uint8, so a resized pixel may differ from the JAX package's
by one level; padding and geometry are identical.
"""

from __future__ import annotations

import numpy as np
import torch
import torch.nn.functional as F


def letterbox(img: np.ndarray, new_shape: int | tuple[int, int] = 640,
              scaleup: bool = True) -> tuple[np.ndarray, float, tuple[int, int]]:
    """Aspect-preserving resize + centred pad (value 114) to ``new_shape``.

    Returns (padded uint8 image, scale ratio, (padw, padh)); boxes map as
    ``new = old * ratio + pad``.
    """
    if isinstance(new_shape, int):
        new_shape = (new_shape, new_shape)
    h0, w0 = img.shape[:2]
    r = min(new_shape[0] / h0, new_shape[1] / w0)
    if not scaleup:
        r = min(r, 1.0)
    new_w, new_h = round(w0 * r), round(h0 * r)
    dw, dh = (new_shape[1] - new_w) / 2, (new_shape[0] - new_h) / 2
    if (w0, h0) != (new_w, new_h):
        t = torch.from_numpy(np.ascontiguousarray(img)).permute(2, 0, 1)[None].float()
        t = F.interpolate(t, size=(new_h, new_w), mode="bilinear", align_corners=False, antialias=False)
        img = t[0].permute(1, 2, 0).round().clamp(0, 255).to(torch.uint8).numpy()
    top, bottom = round(dh - 0.1), round(dh + 0.1)
    left, right = round(dw - 0.1), round(dw + 0.1)
    out = np.full((new_h + top + bottom, new_w + left + right, img.shape[2]), 114, np.uint8)
    out[top: top + new_h, left: left + new_w] = img
    return out, r, (left, top)


def _apply_letterbox_boxes(bboxes: np.ndarray, r: float, pad: tuple[int, int]) -> np.ndarray:
    """Pixel xyxy boxes through the letterbox: ``box * r + pad``."""
    if bboxes.size == 0:
        return bboxes
    out = bboxes * r
    out[:, [0, 2]] += pad[0]
    out[:, [1, 3]] += pad[1]
    return out


def val_transform(sample: dict, imgsz: int) -> dict:
    """Val path: letterbox only (``scaleup=False``); records ratio, pad and
    the original shape for box scale-back."""
    img, r, pad = letterbox(sample["img"], imgsz, scaleup=False)
    return {
        "img": img,
        "cls": sample["cls"],
        "bboxes": _apply_letterbox_boxes(sample["bboxes"].copy(), r, pad),
        "ratio": r,
        "pad": pad,
        "orig_shape": sample["img"].shape[:2],
    }
