"""Heads beyond detect: Segment, Pose and OBB, the mask prototypes,
Classify, YOLOv10's NMS-free ``V10Detect`` and RT-DETR's ``RTDETRDecoder``
(reference ``fce_yolo_tpu/nn/heads.py:31-438``).

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

import numpy as np
import torch
from torch import nn

from fce_yolo_tpu_torch.nn.modules import BatchNorm2d, Conv2d, ConvBNAct, Detect
from fce_yolo_tpu_torch.nn.transformer import (LN_EPS, MLP, DeformableTransformerDecoder,
                                               DeformableTransformerDecoderLayer, inverse_sigmoid)
from fce_yolo_tpu_torch.ops.anchors import dfl_expectation, dist2bbox, dist2rbox, make_anchors

__all__ = ["Proto", "Segment", "Pose", "OBB", "Classify", "V10Detect", "RTDETRDecoder", "stable_topk"]


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


class RTDETRDecoder(nn.Module):
    """RT-DETR's head (reference ``fce_yolo_tpu/nn/heads.py:214-358``;
    Ultralytics head.py:812-1133): query selection over the encoder's
    scores, then ``ndl`` deformable decoder layers with iterative box
    refinement and a score head each.

    - Each input level: 1x1 conv (no bias) + BatchNorm (eps 1e-5, momentum
      0.1 = flax's 0.9), flattened to tokens (B, LV, hd).
    - ``generate_anchors``: per-level (x, y, w, h) logits; anchors within
      1e-2 of the border are invalid (``inf``) and their tokens zeroed.
    - Query selection: the ``nq = min(nq, LV)`` tokens of highest best-class
      encoder score from a stable descending sort, so equal scores keep
      index order (``jax.lax.top_k``'s rule; every invalid token has the same
      score).
    - Training: ``refer`` and the query embeddings are detached; the
      contrastive-denoising queries of ``dn`` (``dn_cls``, ``dn_bbox``,
      ``dn_attn_mask``, from ``train/detr_loss.py::make_cdn_group``) are
      put in front; returns ``dec_bboxes`` (ndl, B, nd + nq, 4) sigmoid xywh,
      ``dec_scores`` (ndl, B, nd + nq, nc) logits, ``enc_bboxes`` and
      ``enc_scores`` (B, nq, ...).
    - Eval: the last decoder layer's ``preds`` (B, nq, 4 + nc), normalized
      xywh and sigmoid scores in float32 (the reference's ``eval_idx`` -1).

    ``denoising_class_embed`` (nc, hd) exists whether or not training uses
    it, so every tree has the same leaves.
    """

    NH, NDP, D_FFN = 8, 4, 1024  # attention heads, sampling points a level, FFN width (no YAML sets them)

    def __init__(self, nc: int = 80, ch: Sequence[int] = (512, 1024, 2048), hd: int = 256, nq: int = 300,
                 ndl: int = 6):
        super().__init__()
        self.nc, self.hd, self.nq, self.ndl = nc, hd, nq, ndl
        self.input_proj = nn.ModuleList(
            nn.Sequential(nn.Conv2d(x, hd, 1, bias=False), BatchNorm2d(hd, eps=1e-5, momentum=0.1)) for x in ch)
        self.enc_output = nn.Sequential(nn.Linear(hd, hd), nn.LayerNorm(hd, eps=LN_EPS))
        self.enc_score_head = nn.Linear(hd, nc)
        self.enc_bbox_head = MLP(hd, hd, 4, num_layers=3)
        self.denoising_class_embed = nn.Embedding(nc, hd)
        self.query_pos_head = MLP(4, 2 * hd, hd, num_layers=2)
        self.decoder = DeformableTransformerDecoder(
            DeformableTransformerDecoderLayer(hd, self.NH, self.D_FFN, len(ch), self.NDP) for _ in range(ndl))
        self.dec_score_head = nn.ModuleList(nn.Linear(hd, nc) for _ in range(ndl))
        self.dec_bbox_head = nn.ModuleList(MLP(hd, hd, 4, num_layers=3) for _ in range(ndl))
        self._anchors: dict[tuple, tuple[torch.Tensor, torch.Tensor]] = {}

    @staticmethod
    def generate_anchors(shapes: Sequence[tuple[int, int]], grid_size: float = 0.05,
                         eps: float = 1e-2) -> tuple[torch.Tensor, torch.Tensor]:
        """(1, LV, 4) anchor logits (``inf`` where invalid) and the (1, LV, 1)
        validity mask, in numpy float32 as the JAX head makes them (head.py:248-263)."""
        anchors = []
        for i, (h, w) in enumerate(shapes):
            gy, gx = np.meshgrid(np.arange(h, dtype=np.float32), np.arange(w, dtype=np.float32), indexing="ij")
            xy = (np.stack([gx, gy], -1) + 0.5) / np.asarray([w, h], np.float32)
            wh = np.ones_like(xy) * grid_size * (2.0 ** i)
            anchors.append(np.concatenate([xy, wh], -1).reshape(h * w, 4))
        a = np.concatenate(anchors, 0)
        valid = ((a > eps) & (a < 1 - eps)).all(-1, keepdims=True)
        with np.errstate(divide="ignore"):
            a = np.log(a / (1 - a))
        a = np.where(valid, a, np.inf).astype(np.float32)
        return torch.from_numpy(a)[None], torch.from_numpy(valid.astype(np.float32))[None]

    def _anchors_on(self, shapes: list[tuple[int, int]], device: torch.device) -> tuple[torch.Tensor, torch.Tensor]:
        """``generate_anchors`` on ``device``, made once per (shapes, device);
        never inference tensors, which a later training forward could not save."""
        key = (tuple(shapes), device)
        if key not in self._anchors:
            with torch.inference_mode(False):
                self._anchors[key] = tuple(t.to(device) for t in self.generate_anchors(shapes))
        return self._anchors[key]

    def forward(self, xs: Sequence[torch.Tensor], dn: dict[str, torch.Tensor] | None = None) -> dict[str, Any]:
        feats, shapes = [], []
        for x, proj in zip(xs, self.input_proj):
            p = proj(x)
            shapes.append((p.shape[2], p.shape[3]))
            feats.append(p.flatten(2).transpose(1, 2))
        feats = torch.cat(feats, dim=1)  # (B, LV, hd)
        dt = feats.dtype
        anchors, valid = self._anchors_on(shapes, feats.device)

        f = self.enc_output(valid.to(dt) * feats)
        enc_scores_all = self.enc_score_head(f)  # (B, LV, nc)
        nq = min(self.nq, feats.shape[1])
        _, topk = stable_topk(enc_scores_all.amax(-1), nq)  # (B, nq)
        top_feats = torch.gather(f, 1, topk[..., None].expand(-1, -1, f.shape[-1]))
        refer = self.enc_bbox_head(top_feats).float() + anchors[0][topk]  # (B, nq, 4) logits, float32
        enc_bboxes = refer.sigmoid()
        enc_scores = torch.gather(enc_scores_all, 1, topk[..., None].expand(-1, -1, self.nc))

        embed = top_feats
        if self.training:
            refer, embed = refer.detach(), embed.detach()
        attn_mask = None
        if dn is not None:  # the denoising queries go in front (padded slots: zero embedding)
            dn_cls = dn["dn_cls"].long()
            dn_embed = self.denoising_class_embed(dn_cls.clamp(0, self.nc - 1))
            dn_embed = torch.where((dn_cls >= 0)[..., None], dn_embed, torch.zeros_like(dn_embed))
            refer = torch.cat([dn["dn_bbox"].float(), refer], dim=1)
            embed = torch.cat([dn_embed.to(embed.dtype), embed], dim=1)
            attn_mask = dn["dn_attn_mask"]

        refer_sig = refer.sigmoid()
        output = embed
        dec_bboxes, dec_scores = [], []
        last_refined = None
        for i, layer in enumerate(self.decoder.layers):
            pos = self.query_pos_head(refer_sig.to(output.dtype))
            output = layer(output, refer_sig, feats, shapes, attn_mask, pos)
            bbox = self.dec_bbox_head[i](output).float()
            refined = (bbox + inverse_sigmoid(refer_sig)).sigmoid()
            if self.training:
                dec_scores.append(self.dec_score_head[i](output))
                dec_bboxes.append(refined if i == 0 else (bbox + inverse_sigmoid(last_refined)).sigmoid())
            last_refined = refined
            refer_sig = refined.detach() if self.training else refined
        if self.training:
            return {"dec_bboxes": torch.stack(dec_bboxes), "dec_scores": torch.stack(dec_scores),
                    "enc_bboxes": enc_bboxes, "enc_scores": enc_scores}
        return {"preds": torch.cat([refined, self.dec_score_head[-1](output).float().sigmoid()], dim=-1)}
