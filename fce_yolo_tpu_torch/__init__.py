"""PyTorch + CUDA port of fce_yolo_tpu: the ``YOLO`` facade (and
``RTDETR``) over detect, the task heads and RT-DETR.

The JAX package ``fce_yolo_tpu`` is the reference; this package mirrors its
module names (``nn/parser.py``, ``nn/modules.py``, ``ops/nms.py``, ...) so
each part has an obvious counterpart. It imports ``torch`` and never JAX,
flax, cv2, PIL or pyyaml. The two Pallas kernels of the reference are
hand-written CUDA kernels here (``csrc/``), built with nvcc at first use and
bound with ctypes (``kernels/build.py``); on CPU tensors their plain PyTorch
versions run.
"""

__version__ = "0.1.0"

__all__ = ["YOLO", "RTDETR", "__version__"]

# the facades pull in the whole slice: each is loaded on first use (reference __init__.py:15-22)
_LAZY = {"YOLO": ("fce_yolo_tpu_torch.api", "YOLO"), "RTDETR": ("fce_yolo_tpu_torch.models.rtdetr", "RTDETR")}


def __getattr__(name: str):
    if name in _LAZY:
        import importlib

        mod, attr = _LAZY[name]
        return getattr(importlib.import_module(mod), attr)
    raise AttributeError(f"module 'fce_yolo_tpu_torch' has no attribute {name!r}")
