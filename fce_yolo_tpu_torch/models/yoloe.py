"""YOLOE facade (reference ``fce_yolo_tpu/models/yoloe.py``; Ultralytics
YOLOEModel, nn/tasks.py:954): open-vocabulary detection and segmentation
prompted by text (class names -> embeddings -> the head's ``reprta``) or by
example boxes (``visual_prompts``: per-class masks on the P3 grid -> SAVPE).
The text is bound on the model as for ``YOLOWorld`` (``models/world.py``).
"""

from __future__ import annotations

import numpy as np
import torch

from fce_yolo_tpu_torch.api import YOLO
from fce_yolo_tpu_torch.models.world import TextBound, dataset_names

__all__ = ["YOLOE"]


class YOLOE(TextBound):
    """Open-vocabulary prompt model over the YOLOEDetect / YOLOESegment
    graph, ``yoloe-11.yaml`` by default."""

    def __init__(self, model: str = "yoloe-11.yaml", text_model: str = "hash:512", **kw):
        super().__init__(model, text_model, **kw)

    @staticmethod
    def _prompt_masks(bboxes: np.ndarray, cls: np.ndarray, imgsz: int, ratio: float,
                      pad: tuple[float, float]) -> tuple[np.ndarray, np.ndarray]:
        """Prompt boxes (source pixels) -> (1, Q, imgsz/8, imgsz/8) masks on
        the letterboxed image's P3 grid, one a prompt class (the union of its
        boxes), and the Q class ids in order (reference LoadVisualPrompt,
        augment.py:2156; JAX models/yoloe.py:50-66)."""
        cls = np.asarray(cls).astype(int)
        q_cls = np.unique(cls)
        g = imgsz // 8
        masks = np.zeros((1, len(q_cls), g, g), np.float32)
        for qi, c in enumerate(q_cls):
            for b in np.asarray(bboxes, np.float32)[cls == c]:
                x1 = int((b[0] * ratio + pad[0]) // 8)
                y1 = int((b[1] * ratio + pad[1]) // 8)
                x2 = int(np.ceil((b[2] * ratio + pad[0]) / 8))
                y2 = int(np.ceil((b[3] * ratio + pad[1]) / 8))
                masks[0, qi, max(y1, 0):min(y2, g), max(x1, 0):min(x2, g)] = 1.0
        return masks, q_cls

    def predict(self, source, visual_prompts: dict | None = None, conf: float = 0.25, iou: float = 0.7,
                imgsz: int = 640, max_det: int = 300, **kw):
        """Text mode (the bound classes) through ``YOLO.predict``; with
        ``visual_prompts`` ({"bboxes": (n, 4) xyxy source pixels, "cls": (n,)})
        one image scored against its prompts (``_predict_visual``)."""
        if visual_prompts is None:
            return super().predict(source, conf=conf, iou=iou, imgsz=imgsz, max_det=max_det, **kw)
        return [self._predict_visual(source, visual_prompts, conf, iou, imgsz, max_det)]

    def _predict_visual(self, source, visual_prompts: dict, conf: float, iou: float, imgsz: int, max_det: int):
        """Visual-prompt predict on ONE image (reference YOLOEVPDetectPredictor;
        JAX models/yoloe.py:81-122): letterbox, the folded model at its dtype
        with the prompt masks, ``batched_nms`` single-label over the prompt
        slots (the NMS kernel on the card), the slots mapped back to the
        caller's class ids. The JAX facade takes a segment model's mask
        coefficients as class scores too; here only the Q prompt slots are
        (ROADMAP queue 3, item 37)."""
        from fce_yolo_tpu_torch.data.augment import letterbox
        from fce_yolo_tpu_torch.engine.predictor import load_source
        from fce_yolo_tpu_torch.engine.results import Results
        from fce_yolo_tpu_torch.ops.nms import batched_nms

        imgs = list(load_source(source, self.device))
        if len(imgs) != 1:
            raise ValueError(f"visual-prompt predict takes a single image, got {len(imgs)}")
        img, path = imgs[0]
        lb, ratio, pad = letterbox(img, imgsz)
        masks, q_cls = self._prompt_masks(np.asarray(visual_prompts["bboxes"], np.float32),
                                          np.asarray(visual_prompts["cls"]), imgsz, ratio, pad)
        model = self._inference_model()
        dtype = next(model.parameters()).dtype
        x = torch.from_numpy(np.ascontiguousarray(lb[None, ..., ::-1])).to(self.device).permute(0, 3, 1, 2)
        with torch.inference_mode():
            out = model((x.float() / 255.0).to(dtype), visual_prompts=torch.from_numpy(masks).to(self.device))
            nms = batched_nms(out["preds"], conf_thres=conf, iou_thres=iou, max_det=max_det, multi_label=False,
                              nc=len(q_cls))
        nms = {k: v[0].cpu().numpy() for k, v in nms.items() if k != "extra"}
        keep = nms["valid"].astype(bool)
        h, w = img.shape[:2]
        boxes = (nms["boxes"][keep] - np.array([pad[0], pad[1], pad[0], pad[1]], np.float32)) / ratio
        boxes[:, [0, 2]] = boxes[:, [0, 2]].clip(0, w)
        boxes[:, [1, 3]] = boxes[:, [1, 3]].clip(0, h)
        cls_ids = q_cls[nms["classes"][keep].astype(int)]  # prompt slots -> the caller's class ids
        rows = np.concatenate([boxes, nms["scores"][keep][:, None], cls_ids[:, None].astype(np.float32)],
                              1).astype(np.float32)
        names = self.names or {int(c): f"object{int(c)}" for c in q_cls}
        return Results(img, path, names, boxes=rows, device=self.device)

    def train(self, data, **kw):
        """Text-prompt training with the bound embeddings, re-bound to the
        dataset's names when their count differs (reference YOLOEPETrainer)."""
        self._rebind_to_dataset(data)
        return super().train(data, **kw)

    def train_visual_prompt(self, data, **kw):
        """Visual-prompt training (reference YOLOEVPTrainer + TVPDetectLoss):
        each batch carries its ground truth's per-class P3 masks, the head
        scores against SAVPE's embeddings of them, and only ``savpe`` updates
        (``freeze=["except:savpe"]`` unless given). The epoch's val runs with
        the text of the dataset's names."""
        from fce_yolo_tpu_torch.data.multimodal import YOLOVisualPromptDataset

        names = dataset_names(data)
        self.set_classes([v for _, v in sorted(names.items())])
        kw.setdefault("freeze", ["except:savpe"])
        return YOLO.train(self, data, dataset_cls=YOLOVisualPromptDataset, dataset_kw={"nc": len(self.names)}, **kw)
