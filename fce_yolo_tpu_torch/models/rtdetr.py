"""RT-DETR facade (reference ``fce_yolo_tpu/models/rtdetr.py``): the
transformer detector as a named entry point. Its predict (no NMS), val
(``RTDETRValidator``) and train (``detr_loss`` with denoising groups) are
the shared facade's, picked by the task "rtdetr"."""

from __future__ import annotations

from fce_yolo_tpu_torch.api import YOLO

__all__ = ["RTDETR"]


class RTDETR(YOLO):
    """Real-Time DEtection TRansformer, ``rtdetr-l.yaml`` by default; the
    model must have an RT-DETR head."""

    def __init__(self, model: str = "rtdetr-l.yaml", **kw):
        super().__init__(model, **kw)
        if self.task != "rtdetr":
            raise ValueError(f"not an RT-DETR config: {model}")
