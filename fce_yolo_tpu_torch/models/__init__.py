"""Named model facades (reference ``fce_yolo_tpu/models/``): ``RTDETR``,
``YOLOWorld`` and ``YOLOE``, each loaded on first use."""

__all__ = ["RTDETR", "YOLOWorld", "YOLOE"]

_LAZY = {"RTDETR": "rtdetr", "YOLOWorld": "world", "YOLOE": "yoloe"}


def __getattr__(name: str):
    if name in _LAZY:
        import importlib

        return getattr(importlib.import_module(f"fce_yolo_tpu_torch.models.{_LAZY[name]}"), name)
    raise AttributeError(f"module 'fce_yolo_tpu_torch.models' has no attribute {name!r}")
