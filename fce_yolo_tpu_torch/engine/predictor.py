"""Streaming detection predictor (reference ``fce_yolo_tpu/engine/predictor.py:97-363``).

Numpy sources are letterboxed to fixed-size uint8 batches on the host (BGR
-> RGB, padded to the predictor's batch size), run through the model with
Conv+BN folded on its device, NMS'd there, and come back as ``Results`` in
original-image pixels. The caller's model is never folded in place: an
unfolded one is folded in a copy (the reference folds a copy too,
predictor.py:247-268).

Stem gate (the port's form of the JAX gate at predictor.py:163-188): layers
0..2 run in the fused stem kernel when the model matches
``stem_spec_from_model``, the model is on a CUDA device and its conv weights
are bf16. Otherwise the plain graph runs from layer 0.
"""

from __future__ import annotations

import copy
import time
from typing import Iterator

import numpy as np
import torch

from fce_yolo_tpu_torch.data.augment import letterbox
from fce_yolo_tpu_torch.engine.results import Results
from fce_yolo_tpu_torch.nn.model import DetectionModel, fold_conv_bn, is_folded
from fce_yolo_tpu_torch.ops.nms import batched_nms
from fce_yolo_tpu_torch.ops.stem import apply_with_fused_stem, fold_stem_params, stem_spec_from_model, stem_weights

__all__ = ["DetectionPredictor", "load_source"]


def load_source(source) -> Iterator[tuple[np.ndarray, str]]:
    """Yield (BGR uint8 image, id) from an ndarray or a list/tuple of them."""
    if isinstance(source, (list, tuple)):
        for i, s in enumerate(source):
            for img, _ in load_source(s):
                yield img, f"array{i}"
        return
    if isinstance(source, np.ndarray):
        if source.ndim != 3 or source.shape[2] != 3 or source.dtype != np.uint8:
            raise ValueError(f"expected an (H, W, 3) uint8 BGR image, got {source.dtype} {source.shape}")
        yield source, "array"
        return
    raise TypeError(f"the port's predictor takes numpy images, got {type(source).__name__}")


class DetectionPredictor:
    """Fixed-shape batched detect predictor. On first use it runs ``model``
    as it is when folded (``YOLO`` hands it its memoized folded copy), else a
    folded copy of it; ``model`` itself is left as it was."""

    def __init__(self, model: DetectionModel, names: dict[int, str], imgsz: int = 640,
                 conf: float = 0.25, iou: float = 0.7, max_det: int = 300, batch_size: int = 1):
        self.model = model
        self.names = names
        self.imgsz = imgsz
        self.conf = conf
        self.iou = iou
        self.max_det = max_det
        self.batch_size = batch_size
        self._stem = None  # (StemSpec, StemWeights) once set up
        self._ready = False

    def _setup(self) -> None:
        if not is_folded(self.model):
            self.model = fold_conv_bn(copy.deepcopy(self.model))
        self.model.eval()
        w = self.model.model[0].conv.weight
        spec = stem_spec_from_model(self.model.spec, (self.imgsz, self.imgsz))
        if spec is not None and w.device.type == "cuda" and w.dtype == torch.bfloat16:
            self._stem = (spec, stem_weights(fold_stem_params(self.model, spec), spec))
        self._ready = True

    @torch.inference_mode()
    def infer(self, batch_u8: torch.Tensor) -> dict[str, torch.Tensor]:
        """uint8 RGB NHWC batch on the model's device -> fixed-shape NMS dict."""
        if not self._ready:
            self._setup()
        if self._stem is not None:
            out = apply_with_fused_stem(self.model, batch_u8, *self._stem)
        else:
            dtype = self.model.model[0].conv.weight.dtype
            x = (batch_u8.permute(0, 3, 1, 2).float() / 255.0).to(dtype)
            out = self.model(x)
        # predict is single-label per box (reference nms.py:19 default)
        return batched_nms(out["preds"], conf_thres=self.conf, iou_thres=self.iou,
                           max_det=self.max_det, multi_label=False)

    def stream(self, source) -> Iterator[Results]:
        """Generator over Results, batching the source internally."""
        device = self.model.model[0].conv.weight.device
        pending: list[tuple[np.ndarray, str, float, tuple[int, int]]] = []
        imgs: list[np.ndarray] = []

        def flush() -> Iterator[Results]:
            if not pending:
                return
            n = len(pending)
            while len(imgs) < self.batch_size:  # pad to the fixed batch shape
                imgs.append(imgs[-1])
            t0 = time.perf_counter()
            batch = torch.from_numpy(np.stack(imgs, 0)).to(device)
            t_pre = time.perf_counter() - t0
            t0 = time.perf_counter()
            out = {k: v.cpu().numpy() for k, v in self.infer(batch).items()}
            t_inf = time.perf_counter() - t0
            t0 = time.perf_counter()
            for i in range(n):
                orig, path, r, (pw, ph) = pending[i]
                valid = out["valid"][i]
                oh, ow = orig.shape[:2]
                boxes = (out["boxes"][i][valid] - np.array([pw, ph, pw, ph])) / r
                boxes[:, [0, 2]] = boxes[:, [0, 2]].clip(0, ow)
                boxes[:, [1, 3]] = boxes[:, [1, 3]].clip(0, oh)
                data = np.concatenate(
                    [boxes, out["scores"][i][valid, None], out["classes"][i][valid, None]], 1)
                yield Results(orig, path, self.names, boxes=data, speed={
                    "preprocess": t_pre * 1000 / n,
                    "inference": t_inf * 1000 / n,
                    "postprocess": (time.perf_counter() - t0) * 1000 / n,
                })
            pending.clear()
            imgs.clear()

        for img, path in load_source(source):
            lb, r, pad = letterbox(img, self.imgsz, scaleup=False)
            pending.append((img, path, r, pad))
            imgs.append(np.ascontiguousarray(lb[..., ::-1]))  # BGR -> RGB
            if len(pending) == self.batch_size:
                yield from flush()
        yield from flush()
