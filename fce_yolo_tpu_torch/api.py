"""``YOLO`` facade of the port (reference ``fce_yolo_tpu/api.py:77-284, 400-423``): detect predict and val."""

from __future__ import annotations

from pathlib import Path
from typing import Any, Mapping

import torch

from fce_yolo_tpu_torch.nn.model import build_model, fold_conv_bn, init_weights
from fce_yolo_tpu_torch.nn.weights import variables_to_state_dict


class YOLO:
    """Detection model facade: ``YOLO("yolo11s-fce.yaml", device="cuda")``.

    The model is built on ``device`` (the card unless another is named; no
    CUDA raises) and initialized from seed 0 (as the JAX facade's lazy init);
    ``reset_weights`` re-seeds, ``load_jax_variables`` loads weights
    exported from the JAX package.
    """

    def __init__(self, model: str | Path = "yolo11n.yaml", device: torch.device | str = "cuda"):
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

    def val(self, data, imgsz: int = 640, batch: int = 16, conf: float = 0.001, iou: float = 0.7,
            max_det: int = 300, workers: int = 8, verbose: bool = True, save_json=None) -> dict:
        """mAP on the ``val`` split of ``data`` (a data YAML path or dict; PNG
        or ``.npy`` images), on the model's device. The dataset's class
        names replace ``class_*`` placeholders. Returns the validator's
        results dict."""
        from fce_yolo_tpu_torch.data.dataset import check_det_dataset
        from fce_yolo_tpu_torch.engine.validator import DetectionValidator

        d = check_det_dataset(data)
        if not self.names or all(v.startswith("class_") for v in self.names.values()):
            self.names = d["names"]
        validator = DetectionValidator(self.model, self.names, imgsz=imgsz, conf=conf, iou=iou, max_det=max_det,
                                       batch_size=batch, workers=workers)
        return validator(data=d, verbose=verbose, save_json=save_json)
