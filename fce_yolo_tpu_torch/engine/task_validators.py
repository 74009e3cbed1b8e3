"""Pose (OKS) and OBB (probiou) validators (reference
``fce_yolo_tpu/engine/task_validators.py:28-214``).

Both run ``DetectionValidator``'s pass (the loader built once and reused,
the model taken off train mode): pose matches by box IoU and by object
keypoint similarity, with NMS multi-label at the validator's K (the NMS
kernel on a card); OBB matches by the probabilistic IoU of rotated boxes,
after ``rotated_batched_nms`` at its default candidate count (1024), as the
JAX validator calls it.
"""

from __future__ import annotations

import numpy as np
import torch

from fce_yolo_tpu_torch.engine.validator import TaskValidator, xywh_to_xyxy_np
from fce_yolo_tpu_torch.ops.iou import probiou
from fce_yolo_tpu_torch.ops.nms import rotated_batched_nms
from fce_yolo_tpu_torch.utils.metrics import DetMetrics, box_iou_np, match_predictions

__all__ = ["PoseValidator", "OBBValidator", "kpt_iou_np", "probiou_np", "OKS_SIGMA17"]

OKS_SIGMA17 = np.array(
    [0.26, 0.25, 0.25, 0.35, 0.35, 0.79, 0.79, 0.72, 0.72, 0.62, 0.62, 1.07, 1.07, 0.87, 0.87, 0.89, 0.89]
) / 10.0


def kpt_iou_np(gt_kpts: np.ndarray, pred_kpts: np.ndarray, gt_area: np.ndarray,
               sigmas: np.ndarray | None = None, eps: float = 1e-7) -> np.ndarray:
    """Object keypoint similarity (G, D) of (G, K, 3) labels with visibility
    and (D, K, 2+) predictions, given the labels' areas (G,)."""
    nk = gt_kpts.shape[1]
    if sigmas is None:
        sigmas = OKS_SIGMA17 if nk == 17 else np.full(nk, 1.0 / nk)
    d2 = ((gt_kpts[:, None, :, :2] - pred_kpts[None, :, :, :2]) ** 2).sum(-1)
    vis = gt_kpts[:, None, :, 2] > 0
    e = d2 / (2 * sigmas[None, None]) ** 2 / (gt_area[:, None, None] + eps) / 2
    oks = np.exp(-e) * vis
    return oks.sum(-1) / (vis.sum(-1) + eps)


def probiou_np(a: np.ndarray, b: np.ndarray) -> np.ndarray:
    """Pairwise probabilistic IoU of (G, 5) and (D, 5) xywhr boxes, float32
    on the CPU (``ops/iou.py::probiou``)."""
    if not len(a) or not len(b):
        return np.zeros((len(a), len(b)), np.float32)
    ta, tb = torch.from_numpy(np.asarray(a, np.float32)), torch.from_numpy(np.asarray(b, np.float32))
    return probiou(ta[:, None, :], tb[None, :, :]).numpy()


class PoseValidator(TaskValidator):
    """Box mAP and pose (OKS) mAP of a Pose model."""

    task = "pose"
    families = {"B": "box", "P": "pose"}

    def __init__(self, *args, kpt_shape: tuple[int, int] = (17, 3), **kw):
        super().__init__(*args, **kw)
        self.kpt_shape = tuple(kpt_shape)

    @torch.inference_mode()
    def nms(self, preds: torch.Tensor) -> dict[str, torch.Tensor]:
        out = super().nms(preds)
        out["keypoints"] = out.pop("extra")
        return out

    def update_metrics(self, out: dict, batch: dict, metrics: dict[str, DetMetrics]) -> None:
        """Match in letterbox pixels (the square ``imgsz``, as the JAX validator) by box IoU and by OKS."""
        nk, nd = self.kpt_shape
        s = self.imgsz
        for i in range(batch["n_valid"]):
            valid = out["valid"][i]
            pboxes, pconf = out["boxes"][i][valid], out["scores"][i][valid]
            pcls = out["classes"][i][valid].astype(float)
            pk = out["keypoints"][i][valid].reshape(-1, nk, 3 if nd == 3 else 2)
            m = batch["mask"][i]
            gxywh = batch["bboxes"][i][m] * s
            gcls = batch["cls"][i][m].astype(float)
            gk = batch["keypoints"][i][m] * np.array([s, s, 1], np.float32)
            garea = gxywh[:, 2] * gxywh[:, 3] * 0.53 if len(gxywh) else np.zeros(0)
            if len(pcls) and len(gcls):
                tp_b = match_predictions(pcls, gcls, box_iou_np(xywh_to_xyxy_np(gxywh), pboxes))
                tp_p = match_predictions(pcls, gcls, kpt_iou_np(gk, pk, garea))
            else:
                tp_b = tp_p = np.zeros((len(pcls), 10), bool)
            stat = dict(conf=pconf, pred_cls=pcls, target_cls=gcls, target_img=np.unique(gcls))
            metrics["B"].update_stats({**stat, "tp": tp_b})
            metrics["P"].update_stats({**stat, "tp": tp_p})


class OBBValidator(TaskValidator):
    """Rotated-box mAP of an OBB model, matched by probiou (tagged B)."""

    task = "obb"
    families = {"B": "rotated box"}

    @torch.inference_mode()
    def nms(self, preds: torch.Tensor) -> dict[str, torch.Tensor]:
        """Rotated NMS (probiou Fast-NMS), multi-label, its default 1024 candidates."""
        out = rotated_batched_nms(preds, conf_thres=self.conf, iou_thres=self.iou, max_det=self.max_det, nc=self.nc)
        out["angle"] = out.pop("extra")
        return out

    def update_metrics(self, out: dict, batch: dict, metrics: dict[str, DetMetrics]) -> None:
        """Match rotated boxes (the square ``imgsz``'s pixels) by probiou."""
        s = self.imgsz
        for i in range(batch["n_valid"]):
            valid = out["valid"][i]
            pr = np.concatenate([out["boxes"][i][valid], out["angle"][i][valid][:, :1]], 1)
            pconf, pcls = out["scores"][i][valid], out["classes"][i][valid].astype(float)
            m = batch["mask"][i]
            grb = batch["bboxes"][i][m] * np.array([s, s, s, s, 1], np.float32)
            gcls = batch["cls"][i][m].astype(float)
            if len(pcls) and len(gcls):
                tp = match_predictions(pcls, gcls, probiou_np(grb, pr))
            else:
                tp = np.zeros((len(pcls), 10), bool)
            metrics["B"].update_stats(dict(tp=tp, conf=pconf, pred_cls=pcls, target_cls=gcls,
                                           target_img=np.unique(gcls)))
