"""Segmentation validator: box mAP and mask mAP (reference
``fce_yolo_tpu/engine/seg_validator.py:26-139``).

Detections are matched to the labels twice, by box IoU and by mask IoU,
giving the Box (B) and Mask (M) metric families. Masks are compared at the
prototypes' resolution (imgsz / 4), the plane the ground-truth polygons are
filled into at collate; they are made for the rows NMS kept only. Fitness
is the mean of the two families' fitness.
"""

from __future__ import annotations

import numpy as np
import torch

from fce_yolo_tpu_torch.engine.validator import TaskValidator, xywh_to_xyxy_np
from fce_yolo_tpu_torch.ops.masks import process_mask
from fce_yolo_tpu_torch.utils.metrics import DetMetrics, box_iou_np, match_predictions

__all__ = ["SegmentationValidator", "mask_iou_np"]


def mask_iou_np(a: np.ndarray, b: np.ndarray, eps: float = 1e-7) -> np.ndarray:
    """(G, H, W) x (D, H, W) binary masks -> (G, D) IoU (reference seg_validator.py:26)."""
    g = a.reshape(len(a), -1).astype(np.float32)
    d = b.reshape(len(b), -1).astype(np.float32)
    inter = g @ d.T
    union = g.sum(1)[:, None] + d.sum(1)[None, :] - inter
    return inter / (union + eps)


class SegmentationValidator(TaskValidator):
    """Box and mask mAP of a Segment model (NMS multi-label over the
    dataset's classes at the validator's K, the NMS kernel on a card)."""

    task = "segment"
    families = {"B": "box", "M": "mask"}

    @torch.inference_mode()
    def forward(self, img_u8: torch.Tensor) -> dict:
        """uint8 RGB NHWC batch -> the head's ``preds`` and ``proto``, and the input's size."""
        dtype = next(self.model.parameters()).dtype
        out = self.model((img_u8.permute(0, 3, 1, 2).float() / 255.0).to(dtype))
        return {"preds": out["preds"], "proto": out["proto"], "shape": tuple(img_u8.shape[1:3])}

    @torch.inference_mode()
    def nms(self, out: dict) -> dict:
        """NMS with the mask coefficients as extras, then each image's masks
        at the prototypes' resolution for its kept rows (a list)."""
        nms = super().nms(out["preds"])
        coefs = nms.pop("extra")
        nms["masks"] = [process_mask(coefs[i][keep], out["proto"][i], nms["boxes"][i][keep], out["shape"],
                                     upsample=False) for i, keep in enumerate(nms["valid"])]
        return nms

    def to_host(self, out: dict) -> dict:
        masks = [m.cpu().numpy() for m in out["masks"]]
        return {**super().to_host({k: v for k, v in out.items() if k != "masks"}), "masks": masks}

    def update_metrics(self, out: dict, batch: dict, metrics: dict[str, DetMetrics]) -> None:
        """Match in letterbox pixels by box IoU and by mask IoU."""
        bh, bw = batch["img"].shape[1:3]
        s = np.array([bw, bh, bw, bh], np.float32)
        for i in range(batch["n_valid"]):
            valid = out["valid"][i]
            pboxes, pconf = out["boxes"][i][valid], out["scores"][i][valid]
            pcls = out["classes"][i][valid].astype(float)
            m = batch["mask"][i]
            gboxes = xywh_to_xyxy_np(batch["bboxes"][i][m] * s)
            gcls = batch["cls"][i][m].astype(float)
            gmasks = batch["masks"][i][m] > 0.5
            if len(pcls) and len(gcls):
                tp_b = match_predictions(pcls, gcls, box_iou_np(gboxes, pboxes))
                tp_m = match_predictions(pcls, gcls, mask_iou_np(gmasks, out["masks"][i]))
            else:
                tp_b = tp_m = np.zeros((len(pcls), 10), bool)
            stat = dict(conf=pconf, pred_cls=pcls, target_cls=gcls, target_img=np.unique(gcls))
            metrics["B"].update_stats({**stat, "tp": tp_b})
            metrics["M"].update_stats({**stat, "tp": tp_m})
