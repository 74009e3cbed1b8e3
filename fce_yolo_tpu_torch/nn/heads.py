"""Heads beyond detect: Segment, Pose and OBB, the mask prototypes,
Classify, and YOLOv10's NMS-free ``V10Detect`` (reference
``fce_yolo_tpu/nn/heads.py:31-211, 363-438``).

Each head is the port's ``Detect`` (``legacy`` passed through: the v8-era
cls branch) with one more branch per level (``cv4``:
Conv3x3 -> Conv3x3 -> bare 1x1), so its ``state_dict`` keys are
Ultralytics' flat names (``model.23.cv2.0.0.conv.weight``,
``model.23.cv4.1.2.weight``, ``model.23.proto.upsample.weight``); the JAX
package nests the Detect trunk under a ``detect`` scope, which the weight
bridge drops and restores (``nn/weights.py``).

Eval outputs are anchor-major, in the JAX order, decoded in float32 whatever
the model's dtype:
- Segment: ``preds`` (B, A, 4 + nc + nm) and ``proto`` (B, nm, Hp, Wp);
- Pose: ``preds`` (B, A, 4 + nc + nk), keypoints ``(raw * 2 + anchor - 0.5) * stride``
  with a sigmoid on the visibility;
- OBB: ``preds`` (B, A, 4 + nc + 1), rotated (cx, cy, w, h) from ``dist2rbox``
  and the angle ``(sigmoid(theta) - 0.25) * pi``.
In training mode they return the JAX package's keys: ``feats`` with
``mask_coefs`` and ``proto``, ``kpts`` or ``angle``.
"""

from __future__ import annotations

import copy
import math
from typing import Any, Sequence

import torch
from torch import nn

from fce_yolo_tpu_torch.nn.modules import Conv2d, ConvBNAct, Detect
from fce_yolo_tpu_torch.ops.anchors import dfl_expectation, dist2bbox, dist2rbox, make_anchors

__all__ = ["Proto", "Segment", "Pose", "OBB", "Classify", "V10Detect", "stable_topk"]


class Proto(nn.Module):
    """Mask prototypes (reference block.py:83-104): cv1 3x3 -> 2x2 stride-2
    ``ConvTranspose2d`` -> cv2 3x3 -> cv3 1x1, at twice the P3 resolution."""

    def __init__(self, c1: int, c_: int = 256, c2: int = 32):
        super().__init__()
        self.cv1 = ConvBNAct(c1, c_, 3)
        self.upsample = nn.ConvTranspose2d(c_, c_, 2, 2, 0, bias=True)
        self.cv2 = ConvBNAct(c_, c_, 3)
        self.cv3 = ConvBNAct(c_, c2, 1)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return self.cv3(self.cv2(self.upsample(self.cv1(x))))


def _branches4(ch: Sequence[int], c4: int, out: int) -> nn.ModuleList:
    """The ``cv4`` branch shared by Segment, Pose and OBB, one per level."""
    return nn.ModuleList(nn.Sequential(ConvBNAct(x, c4, 3), ConvBNAct(c4, c4, 3), Conv2d(c4, out, 1)) for x in ch)


def _anchor_major(maps: list[torch.Tensor]) -> torch.Tensor:
    """Per-level (B, C, H, W) maps -> (B, sum(H*W), C), the JAX anchor order."""
    b, c = maps[0].shape[:2]
    return torch.cat([m.permute(0, 2, 3, 1).reshape(b, -1, c) for m in maps], dim=1)


class Segment(Detect):
    """Detect + per-anchor mask coefficients + prototypes (reference head.py:215-263)."""

    def __init__(self, nc: int, nm: int = 32, npr: int = 256, ch: Sequence[int] = (),
                 strides: Sequence[int] | None = None, legacy: bool = False):
        super().__init__(nc, ch, strides=strides, legacy=legacy)
        self.nm, self.npr = nm, npr
        self.proto = Proto(ch[0], npr, nm)
        self.cv4 = _branches4(ch, max(ch[0] // 4, nm), nm)

    def forward(self, xs: Sequence[torch.Tensor]) -> dict[str, Any]:
        proto = self.proto(xs[0])
        mc = _anchor_major([branch(x) for x, branch in zip(xs, self.cv4)])
        det = super().forward(xs)
        if self.training:
            return {"feats": det["feats"], "mask_coefs": mc, "proto": proto}
        return {"preds": torch.cat([det["preds"], mc.float()], dim=-1), "proto": proto, "feats": det["feats"]}


class Pose(Detect):
    """Detect + decoded keypoints (reference head.py:319-386)."""

    def __init__(self, nc: int, kpt_shape: Sequence[int] = (17, 3), ch: Sequence[int] = (),
                 strides: Sequence[int] | None = None, legacy: bool = False):
        super().__init__(nc, ch, strides=strides, legacy=legacy)
        self.kpt_shape = tuple(kpt_shape)
        self.nk = self.kpt_shape[0] * self.kpt_shape[1]
        self.cv4 = _branches4(ch, max(ch[0] // 4, self.nk), self.nk)

    def forward(self, xs: Sequence[torch.Tensor]) -> dict[str, Any]:
        kpt = _anchor_major([branch(x) for x, branch in zip(xs, self.cv4)])
        det = super().forward(xs)
        if self.training:
            return {"feats": det["feats"], "kpts": kpt}
        anchors, stride_t = make_anchors([f.shape[2:] for f in det["feats"]], list(self.strides), 0.5,
                                         dtype=torch.float32, device=kpt.device)
        decoded = self.kpts_decode(kpt.float(), anchors, stride_t)
        return {"preds": torch.cat([det["preds"], decoded], dim=-1), "kpts": kpt, "feats": det["feats"]}

    def kpts_decode(self, kpts: torch.Tensor, anchors: torch.Tensor, stride_t: torch.Tensor) -> torch.Tensor:
        """x, y = (raw * 2 + anchor - 0.5) * stride; a sigmoid on the visibility."""
        nkp, ndim = self.kpt_shape
        b, a, _ = kpts.shape
        y = kpts.reshape(b, a, nkp, ndim)
        xy = (y[..., :2] * 2.0 + (anchors[None, :, None, :] - 0.5)) * stride_t[None, :, None, :]
        if ndim == 3:
            xy = torch.cat([xy, y[..., 2:3].sigmoid()], dim=-1)
        return xy.reshape(b, a, nkp * ndim)


class OBB(Detect):
    """Detect + a per-anchor angle; eval boxes are rotated (reference head.py:265-318)."""

    def __init__(self, nc: int, ne: int = 1, ch: Sequence[int] = (), strides: Sequence[int] | None = None,
                 legacy: bool = False):
        super().__init__(nc, ch, strides=strides, legacy=legacy)
        self.ne = ne
        self.cv4 = _branches4(ch, max(ch[0] // 4, ne), ne)

    def forward(self, xs: Sequence[torch.Tensor]) -> dict[str, Any]:
        raw = _anchor_major([branch(x) for x, branch in zip(xs, self.cv4)])
        angle = (raw.float().sigmoid() - 0.25) * math.pi  # (B, A, ne) in [-pi/4, 3pi/4)
        feats = self.level_maps(xs)
        if self.training:
            return {"feats": feats, "angle": angle}
        flat = _anchor_major(feats)
        box_logits, cls_logits = flat[..., : self.reg_max * 4], flat[..., self.reg_max * 4:]
        anchors, stride_t = make_anchors([f.shape[2:] for f in feats], list(self.strides), 0.5,
                                         dtype=torch.float32, device=flat.device)
        dist = dfl_expectation(box_logits.float(), self.reg_max)
        rbox = dist2rbox(dist, angle, anchors[None]) * stride_t[None]
        preds = torch.cat([rbox, cls_logits.float().sigmoid(), angle], dim=-1)
        return {"preds": preds, "angle": angle, "feats": feats}


class Classify(nn.Module):
    """Image classification head (reference ``fce_yolo_tpu/nn/heads.py:195-211``):
    ConvBNAct to 1280 channels -> mean over H and W -> ``Linear`` -> softmax.
    The logits and probabilities come out in float32: ``{"logits"}`` in
    training mode, ``{"probs", "logits"}`` in eval mode."""

    C_ = 1280

    def __init__(self, c1: int, c2: int, k: int = 1, s: int = 1):
        super().__init__()
        self.conv = ConvBNAct(c1, self.C_, k, s)
        self.linear = nn.Linear(self.C_, c2)

    def forward(self, x: torch.Tensor) -> dict[str, Any]:
        logits = self.linear(self.conv(x).mean((2, 3))).float()
        if self.training:
            return {"logits": logits}
        return {"probs": logits.softmax(-1), "logits": logits}


def stable_topk(x: torch.Tensor, k: int) -> tuple[torch.Tensor, torch.Tensor]:
    """The ``k`` largest of the last axis, descending, equal values in index
    order: the tie rule of ``jax.lax.top_k``, which ``torch.topk`` does not
    promise (a stable descending sort)."""
    values, idx = torch.sort(x, dim=-1, descending=True, stable=True)
    return values[..., :k], idx[..., :k]


class V10Detect(Detect):
    """YOLOv10's NMS-free dual-assignment head (reference
    ``fce_yolo_tpu/nn/heads.py:363-438``; Ultralytics head.py:1134-1183).

    Two head sets of the Detect form with the v10 "light" cls branch:
    ``cv2``/``cv3`` (one-to-many, trained with top-10 TAL) and
    ``one2one_cv2``/``one2one_cv3`` (one-to-one, top-1 TAL), which run on
    the inputs detached, so the one-to-one loss trains only its own head.
    Training mode returns ``{"feats", "one2one_feats"}``. Eval mode decodes
    the one-to-one maps in float32 as **xyxy** pixels and sigmoid scores,
    takes the ``max_det`` anchors of highest best-class score, then the
    ``max_det`` highest of their ``max_det * nc`` scores (anchor = idx //
    nc, class = idx % nc; ties to the lower index at both steps, as
    ``jax.lax.top_k``): ``preds6`` (B, max_det, 6) [x1, y1, x2, y2, score,
    class], with ``feats`` and ``one2one_feats``. No NMS follows.
    """

    def __init__(self, nc: int, ch: Sequence[int], reg_max: int = 16, strides: Sequence[int] | None = None,
                 max_det: int = 300):
        super().__init__(nc, ch, reg_max, strides=strides, legacy=False)
        self.max_det = max_det
        self.one2one_cv2 = copy.deepcopy(self.cv2)
        self.one2one_cv3 = copy.deepcopy(self.cv3)

    def forward(self, xs: Sequence[torch.Tensor]) -> dict[str, Any]:
        one2many = self.level_maps(xs)
        one2one = [torch.cat([b(x.detach()), c(x.detach())], dim=1)
                   for x, b, c in zip(xs, self.one2one_cv2, self.one2one_cv3)]
        if self.training:
            return {"feats": one2many, "one2one_feats": one2one}
        assert self.strides is not None, "V10Detect.strides unresolved; build via build_model()"
        flat = _anchor_major(one2one)
        box_logits, cls_logits = flat[..., : self.reg_max * 4], flat[..., self.reg_max * 4:]
        anchors, stride_t = make_anchors([f.shape[2:] for f in one2one], list(self.strides), 0.5,
                                         dtype=torch.float32, device=flat.device)
        dist = dfl_expectation(box_logits.float(), self.reg_max)
        dbox = dist2bbox(dist, anchors[None], xywh=False) * stride_t[None]
        scores = cls_logits.float().sigmoid()
        k = min(self.max_det, dbox.shape[1])
        _, idx = stable_topk(scores.amax(-1), k)  # (B, k) anchors
        boxes_k = torch.gather(dbox, 1, idx[..., None].expand(-1, -1, 4))
        scores_k = torch.gather(scores, 1, idx[..., None].expand(-1, -1, self.nc))
        top, flat_idx = stable_topk(scores_k.flatten(1), k)
        anchor = flat_idx // self.nc
        boxes = torch.gather(boxes_k, 1, anchor[..., None].expand(-1, -1, 4))
        preds6 = torch.cat([boxes, top[..., None], (flat_idx % self.nc).float()[..., None]], dim=-1)
        return {"preds6": preds6, "feats": one2many, "one2one_feats": one2one}
