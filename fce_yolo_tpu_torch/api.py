"""``YOLO`` facade of the port (reference ``fce_yolo_tpu/api.py:77-284``), detect predict only."""

from __future__ import annotations

from pathlib import Path
from typing import Any, Mapping

import torch

from fce_yolo_tpu_torch.nn.model import build_model, fold_conv_bn, init_weights
from fce_yolo_tpu_torch.nn.weights import variables_to_state_dict


class YOLO:
    """Detection model facade: ``YOLO("yolo11s-fce.yaml", device="cuda")``.

    The model is built on ``device`` and initialized from seed 0 (as the JAX
    facade's lazy init); ``reset_weights`` re-seeds, ``load_jax_variables``
    loads weights exported from the JAX package.
    """

    def __init__(self, model: str | Path = "yolo11n.yaml", device: torch.device | str = "cpu"):
        self.model, self.spec, self.strides = build_model(model, device=device)
        self.names = {i: f"class_{i}" for i in range(self.spec.nc)}
        self.reset_weights(0)

    def reset_weights(self, seed: int = 0) -> "YOLO":
        """Re-initialize all parameters from ``seed`` (reference Model.reset_weights)."""
        init_weights(self.model, torch.Generator().manual_seed(seed))
        return self

    def load_jax_variables(self, variables: Mapping[str, Any]) -> "YOLO":
        """Load flax ``{"params", "batch_stats"}`` (numpy leaves) from the JAX package.

        The bridge (``nn/weights.py``) must fill every tensor of this model;
        fold before loading if the variables are folded.
        """
        sd = variables_to_state_dict(variables)
        self.model.load_state_dict(sd, strict=True)
        return self

    def fuse(self) -> "YOLO":
        """Fold Conv+BN into conv weights in place (reference Model.fuse); idempotent."""
        fold_conv_bn(self.model)
        return self

    def to(self, dtype_or_device) -> "YOLO":
        """Move the model to a dtype (e.g. ``torch.bfloat16``) or a device."""
        self.model.to(dtype_or_device)
        return self

    def predict(self, source, conf: float = 0.25, iou: float = 0.7, imgsz: int = 640,
                max_det: int = 300, batch: int = 1) -> list:
        """Detect on numpy BGR images (one array or a list); a list of
        ``Results``. Folds Conv+BN in place."""
        from fce_yolo_tpu_torch.engine.predictor import DetectionPredictor

        predictor = DetectionPredictor(self.model, self.names, imgsz=imgsz, conf=conf, iou=iou,
                                       max_det=max_det, batch_size=batch)
        return list(predictor.stream(source))
