"""PyTorch + CUDA port of fce_yolo_tpu: detect predict and val, and the
detection loss.

The JAX package ``fce_yolo_tpu`` is the reference; this package mirrors its
module names (``nn/parser.py``, ``nn/modules.py``, ``ops/nms.py``, ...) so
each part has an obvious counterpart. It imports ``torch`` and never JAX,
flax, cv2, PIL or pyyaml. The two Pallas kernels of the reference are
hand-written CUDA kernels here (``csrc/``), built with nvcc at first use and
bound with ctypes (``kernels/build.py``); on CPU tensors their plain PyTorch
versions run.
"""

__all__ = ["YOLO"]


def __getattr__(name: str):
    if name == "YOLO":  # the facade pulls in the whole slice; load it on first use
        from fce_yolo_tpu_torch.api import YOLO

        return YOLO
    raise AttributeError(f"module 'fce_yolo_tpu_torch' has no attribute {name!r}")
