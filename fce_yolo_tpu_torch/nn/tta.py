"""Test-time augmentation and model ensembles for detect models (reference
``fce_yolo_tpu/nn/tta.py:24-104``; Ultralytics nn/tasks.py:422-487 and
1238-1276).

``predict_augment`` runs the model at scales (1, 0.83, 0.67) with flips
(none, left-right, none), takes each pass's xywh boxes back to the input's
frame, drops the full-scale pass's coarse-grid tail and the smallest pass's
fine-grid head, and concatenates the rest on the anchor axis for one NMS
(``ops/nms.py::batched_nms``). ``ensemble_predict`` concatenates several
models' predictions the same way. Inputs are NCHW float images in [0, 1];
these are library functions, as in the JAX package (its facade has no
``augment`` flag, so the port's has none).

``scale_img`` resizes as ``jax.image.resize(..., "bilinear")`` does: with
antialiasing (a triangle filter widened by 1 / ratio when it shrinks), which
``F.interpolate(..., antialias=True)`` computes. Ultralytics' ``scale_img``
resizes without it (ROADMAP queue 3, item 27); the port follows JAX.
"""

from __future__ import annotations

import math
from typing import Sequence

import torch
import torch.nn.functional as F

__all__ = ["scale_img", "predict_augment", "ensemble_predict"]

PAD_VALUE = 0.447  # the ImageNet-mean gray that pads a scaled image to a stride multiple


def scale_img(x: torch.Tensor, ratio: float, gs: int = 32) -> torch.Tensor:
    """Resize an NCHW batch by ``ratio`` (bilinear, antialiased, in float32)
    to (int(H * ratio), int(W * ratio)), then pad the bottom and right to
    multiples of ``gs`` with ``PAD_VALUE``."""
    if ratio == 1.0:
        return x
    h, w = x.shape[2:]
    nh, nw = int(h * ratio), int(w * ratio)
    y = F.interpolate(x.float(), size=(nh, nw), mode="bilinear", align_corners=False, antialias=True).to(x.dtype)
    return F.pad(y, (0, math.ceil(nw / gs) * gs - nw, 0, math.ceil(nh / gs) * gs - nh), value=PAD_VALUE)


def _descale(p: torch.Tensor, flip_lr: bool, scale: float, img_w: int) -> torch.Tensor:
    """Decoded (B, N, 4 + nc) xywh preds back to the unscaled, unflipped frame."""
    box = p[..., :4] / scale
    if flip_lr:
        box = torch.cat([img_w - box[..., 0:1], box[..., 1:]], dim=-1)
    return torch.cat([box, p[..., 4:]], dim=-1)


def _clip_tails(ys: list[torch.Tensor], nl: int = 3) -> list[torch.Tensor]:
    """Drop the coarsest level's share of the first pass's anchors (the end
    of axis 1) and the finest level's share of the last pass's (the start)."""
    g = sum(4**i for i in range(nl))
    ys[0] = ys[0][:, : ys[0].shape[1] - ys[0].shape[1] // g]
    ys[-1] = ys[-1][:, (ys[-1].shape[1] // g) * 4 ** (nl - 1):]
    return ys


def predict_augment(model, x: torch.Tensor, gs: int = 32, scales: Sequence[float] = (1.0, 0.83, 0.67),
                    flips: Sequence[bool] = (False, True, False)) -> torch.Tensor:
    """Multi-scale and flip inference of a detect ``model`` (eval mode,
    three levels) on NCHW ``x`` in [0, 1], in the model's dtype: the
    passes' (B, N_i, 4 + nc) preds merged on the anchor axis, (B, N, 4 + nc)
    float32. At 640 px that is 8000 + 6069 + 980 = 15049 rows."""
    img_w = x.shape[3]
    ys = []
    for s, f in zip(scales, flips):
        xi = scale_img(x.flip(3) if f else x, s, gs)
        ys.append(_descale(model(xi)["preds"], f, s, img_w))
    return torch.cat(_clip_tails(ys, nl=3), dim=1)


def ensemble_predict(models: Sequence, x: torch.Tensor) -> torch.Tensor:
    """The "NMS ensemble": every model's decoded preds on NCHW ``x``,
    concatenated on the anchor axis for one NMS; the models must agree on
    the output width."""
    ys = [m(x)["preds"] for m in models]
    widths = {y.shape[-1] for y in ys}
    if len(widths) != 1:
        raise ValueError(f"ensemble members disagree on output width: {widths}")
    return torch.cat(ys, dim=1)
