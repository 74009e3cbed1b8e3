"""PyTorch + CUDA port of fce_yolo_tpu: the ``YOLO`` facade (and
``RTDETR``, ``YOLOWorld``, ``YOLOE``) over detect, the task heads, RT-DETR
and the open-vocabulary models.

The JAX package ``fce_yolo_tpu`` is the reference; this package mirrors its
module names (``nn/parser.py``, ``nn/modules.py``, ``ops/nms.py``, ...) so
each part has an obvious counterpart. It imports ``torch`` and never JAX,
flax, cv2, PIL or pyyaml. The two Pallas kernels of the reference are
hand-written CUDA kernels here (``csrc/``), built with nvcc at first use and
bound with ctypes (``kernels/build.py``); on CPU tensors their plain PyTorch
versions run.
"""

__version__ = "0.1.0"

__all__ = ["YOLO", "RTDETR", "YOLOWorld", "YOLOE", "__version__"]

# the facades pull in the whole slice: each is loaded on first use (reference __init__.py:15-22)
# (the named facades through ``models/__init__.py``'s own lazy table)
_LAZY = {"YOLO": "fce_yolo_tpu_torch.api", "RTDETR": "fce_yolo_tpu_torch.models",
         "YOLOWorld": "fce_yolo_tpu_torch.models", "YOLOE": "fce_yolo_tpu_torch.models"}


def __getattr__(name: str):
    if name in _LAZY:
        import importlib

        return getattr(importlib.import_module(_LAZY[name]), name)
    raise AttributeError(f"module 'fce_yolo_tpu_torch' has no attribute {name!r}")
