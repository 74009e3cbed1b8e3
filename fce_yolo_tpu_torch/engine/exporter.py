"""Model export (reference ``fce_yolo_tpu/engine/exporter.py``).

Two formats run without JAX or TensorFlow:

- ``torch_export``: ``<stem>_<imgsz>.pt2``, a ``torch.export`` program of
  ``ExportGraph`` written by ``torch.export.save``, with a JSON sidecar. It
  is the port's counterpart of the JAX ``stablehlo`` artifact: the
  framework's own compiled-graph interchange, loaded by
  ``nn/autobackend.py`` on the session's device. With ``nms=True`` the NMS
  runs inside the program as the custom op
  ``fce_yolo_tpu_torch::pick_suppress`` (``ops/nms.py``), so a program loaded
  on the card launches the NMS kernel.
- ``native``: ``<stem>_<imgsz>.fyir`` + ``.fybin`` for the repo's C++
  interpreter (``engine/export_native.py``), with the same sidecar.

``stablehlo``, ``saved_model`` and ``tflite`` (and ``int8``) need JAX or
TensorFlow and raise, naming ``torch_export`` instead.
"""

from __future__ import annotations

import copy
import json
import re
import time
from pathlib import Path

import torch

from fce_yolo_tpu_torch.nn.heads import V10Detect
from fce_yolo_tpu_torch.ops.nms import batched_nms

__all__ = ["export_model", "try_export", "ExportGraph", "EXPORT_FORMATS", "JAX_ONLY_FORMATS"]

EXPORT_FORMATS = ("torch_export", "native")
JAX_ONLY_FORMATS = {"stablehlo": "JAX", "saved_model": "TensorFlow (jax2tf)", "tflite": "TensorFlow (jax2tf)"}


def try_export(fn):
    """Decorator: time the export and report its end or its failure (reference ``exporter.py:24-38``)."""

    def wrapper(*args, **kwargs):
        name = fn.__name__.replace("_export_", "")
        t0 = time.time()
        try:
            out = fn(*args, **kwargs)
            print(f"export {name}: done in {time.time() - t0:.1f}s -> {out}")
            return out
        except Exception as e:
            print(f"export {name}: FAILED after {time.time() - t0:.1f}s: {e}")
            raise

    return wrapper


class ExportGraph(torch.nn.Module):
    """The exported inference graph (the JAX ``_predict_fn``): NHWC images,
    uint8-range or [0, 1] (scaled when the batch's largest value is above
    2, with ``torch.where`` so that the program keeps both branches), the
    model in its own dtype, then the raw preds, or with ``nms`` the
    ``boxes``, ``scores``, ``classes`` and ``valid`` of ``batched_nms``
    (multi-label, as the JAX graph's)."""

    def __init__(self, model: torch.nn.Module, nms: bool = False, conf: float = 0.25, iou: float = 0.7,
                 max_det: int = 300):
        super().__init__()
        self.model = model
        self.nms, self.conf, self.iou, self.max_det = nms, conf, iou, max_det
        self.dtype = next(model.parameters()).dtype

    def forward(self, img: torch.Tensor):
        x = img.float()
        x = torch.where(x.amax() > 2.0, x / 255.0, x)
        preds = self.model(x.permute(0, 3, 1, 2).to(self.dtype))["preds"]
        if not self.nms:
            return preds
        out = batched_nms(preds, conf_thres=self.conf, iou_thres=self.iou, max_det=self.max_det)
        return {k: out[k] for k in ("boxes", "scores", "classes", "valid")}


def artifact_stem(cfg_yaml: str, scale: str | None) -> str:
    """The JAX exporter's file stem: the config's name without its scale
    letter, then the scale (``yolo11n.yaml`` -> ``yolo11n``)."""
    stem = Path(str(cfg_yaml)).stem
    m = re.fullmatch(r"(yolov?\d+)([nslmx])(-[\w-]+)?", stem)
    if m:
        stem = m.group(1) + (m.group(3) or "")
    return stem + (scale or "")


def export_model(yolo, fmt: str = "torch_export", imgsz: int = 640, batch: int = 1, nms: bool = False,
                 int8: bool = False, conf: float = 0.25, iou: float = 0.7, max_det: int = 300,
                 out_dir: str | Path | None = None) -> str:
    """Export a ``YOLO`` facade's model; returns the artifact's path.

    ``torch_export`` traces ``ExportGraph`` at the static shape (batch,
    imgsz, imgsz, 3) on the model's device; ``native`` writes the
    single-image interpreter graph. Both write the JAX sidecar's keys.
    """
    if fmt in JAX_ONLY_FORMATS:
        raise NotImplementedError(f"{fmt!r} needs {JAX_ONLY_FORMATS[fmt]}, which the port and the card machine lack; "
                                  "the port's compiled-graph artifact is format='torch_export' (.pt2), its "
                                  "framework-free one format='native' (.fyir)")
    if fmt not in EXPORT_FORMATS:
        raise ValueError(f"unknown export format {fmt!r} ({'|'.join(EXPORT_FORMATS)})")
    if int8:
        raise NotImplementedError("int8 quantisation is the tflite exporter's (TensorFlow); the port exports float")
    if isinstance(yolo.model.detect, V10Detect):
        raise NotImplementedError("a v10 head's NMS-free top-k (preds6) is in neither export graph, as in the JAX "
                                  "exporter, which reads preds")
    if yolo.task == "classify" and fmt == "torch_export":
        raise NotImplementedError("torch_export writes the detection graph (preds or NMS); export a classify "
                                  "model with format='native'")
    from fce_yolo_tpu_torch.nn.model import param_count

    stem = artifact_stem(yolo.cfg_yaml, yolo.scale)
    out = Path(out_dir or ".") / f"{stem}_{imgsz}"
    out.parent.mkdir(parents=True, exist_ok=True)
    model = yolo._inference_model()
    meta = {"model": stem, "imgsz": imgsz, "batch": batch if fmt == "torch_export" else 1, "nc": yolo.nc,
            "names": yolo.names, "strides": list(yolo.strides or ()), "nms": bool(nms and fmt == "torch_export"),
            "layout": "NHWC", "input": "uint8-or-float [0,255]/[0,1]",
            "params": param_count(yolo.model)}
    if fmt == "native":
        return _export_native(model, out, imgsz, meta)
    return _export_torch_export(model, out, imgsz, batch, meta, conf=conf, iou=iou, max_det=max_det)


@try_export
def _export_torch_export(model: torch.nn.Module, out: Path, imgsz: int, batch: int, meta: dict, conf: float,
                         iou: float, max_det: int) -> str:
    graph = ExportGraph(copy.deepcopy(model).eval(), nms=meta["nms"], conf=conf, iou=iou, max_det=max_det)
    device = next(model.parameters()).device
    x = torch.zeros(batch, imgsz, imgsz, 3, device=device)
    with torch.no_grad():
        ep = torch.export.export(graph, (x,), strict=False)
    path = out.with_suffix(".pt2")
    torch.export.save(ep, str(path))
    path.with_suffix(".json").write_text(json.dumps(meta, indent=2))
    return str(path)


@try_export
def _export_native(model: torch.nn.Module, out: Path, imgsz: int, meta: dict) -> str:
    from fce_yolo_tpu_torch.engine.export_native import export_native

    ir = export_native(model, out, imgsz=imgsz)
    ir.with_suffix(".json").write_text(json.dumps(meta, indent=2))
    return str(ir)
