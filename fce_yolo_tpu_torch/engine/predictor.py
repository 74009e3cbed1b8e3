"""Streaming detection predictor (reference ``fce_yolo_tpu/engine/predictor.py:97-363``).

Sources (files, directories, MJPEG AVI video, streams of it, numpy or PIL
images; ``load_source``) are
letterboxed to fixed-size uint8 batches on the host (BGR -> RGB, padded to
the predictor's batch size), run through the model with
Conv+BN folded on its device, NMS'd there, and come back as ``Results`` in
original-image pixels. The caller's model is never folded in place: an
unfolded one is folded in a copy (the reference folds a copy too,
predictor.py:247-268).

Task heads (reference predictor.py:219-243, 303-351): segment runs NMS
with the mask coefficients as extras, then ``process_mask`` at the input
size for the rows that survived only, then ``scale_masks`` (cv2's
INTER_LINEAR in integer torch ops) on the model's device; pose
un-letterboxes the decoded keypoints; OBB suppresses with
``rotated_batched_nms`` (probiou) and only the centre leaves the
letterbox, w and h scaled and never clipped. A V10Detect model's
``preds6`` are already its detections: no NMS (predictor.py:209-218).

Stem gate (the port's form of the JAX gate at predictor.py:163-188): layers
0..2 run in the fused stem kernel when the model matches
``stem_spec_from_model``, the model is on a CUDA device and its conv weights
are bf16. Otherwise the plain graph runs from layer 0.

Exported artifacts (reference predictor.py:135-153): with ``infer_fn`` (an
``nn/autobackend.py::AutoBackend``) and no model, the uint8 batch goes to
the artifact; raw preds get single-label ``batched_nms`` here, a dict means
that NMS ran inside the artifact. Boxes only: the detect path.
"""

from __future__ import annotations

import copy
import time
from pathlib import Path
from typing import Iterator

import numpy as np
import torch

from fce_yolo_tpu_torch.data.augment import letterbox
from fce_yolo_tpu_torch.data.avi import avi_frames
from fce_yolo_tpu_torch.data.dataset import IMG_FORMATS
from fce_yolo_tpu_torch.data.imread import imread
from fce_yolo_tpu_torch.data.loaders import STREAM_PREFIXES, LoadScreenshots, LoadStreams
from fce_yolo_tpu_torch.engine.results import Results
from fce_yolo_tpu_torch.nn.model import DetectionModel, fold_conv_bn, is_folded
from fce_yolo_tpu_torch.ops.masks import process_mask, scale_masks
from fce_yolo_tpu_torch.ops.nms import batched_nms, rotated_batched_nms
from fce_yolo_tpu_torch.ops.stem import apply_with_fused_stem, fold_stem_params, stem_spec_from_model, stem_weights

__all__ = ["DetectionPredictor", "load_source"]


VID_FORMATS = {"asf", "avi", "gif", "m4v", "mkv", "mov", "mp4", "mpeg", "mpg", "ts", "webm", "wmv"}


def load_source(source, device="cuda") -> Iterator[tuple[np.ndarray, str]]:
    """Yield (BGR uint8 image, path or id) from an image file, a directory
    (its image files by extension, ``rglob``, sorted), an MJPEG ``.avi``
    video (each frame, named ``<path>#frame<i>``), a ``.streams`` file or a
    stream URL (``data/loaders.py::LoadStreams``, named by the source), a
    numpy BGR image, a PIL image (recognised by its class's module, PIL is
    not imported), or a list/tuple of these (the reference ``load_source``,
    ``fce_yolo_tpu/engine/predictor.py:28-100``). Files are read by
    ``imread`` and video frames by ``data/avi.py`` (a JPEG decodes on
    ``device``). A file that cannot be read raises: nothing is skipped (the
    reference skips what cv2 cannot read). Other video containers and
    codecs, network streams, webcams and screenshots raise
    NotImplementedError."""
    if isinstance(source, (list, tuple)):
        for i, s in enumerate(source):
            for img, path in load_source(s, device):
                yield img, f"array{i}" if path == "array" else path
        return
    if isinstance(source, np.ndarray):
        if source.ndim != 3 or source.shape[2] != 3 or source.dtype != np.uint8:
            raise ValueError(f"expected an (H, W, 3) uint8 BGR image, got {source.dtype} {source.shape}")
        yield source, "array"
        return
    if source.__class__.__module__.startswith("PIL"):
        arr = np.asarray(source)
        if arr.ndim != 3 or arr.shape[2] != 3 or arr.dtype != np.uint8:
            raise ValueError(f"expected an RGB PIL image, got mode {getattr(source, 'mode', '?')}")
        yield np.ascontiguousarray(arr[..., ::-1]), "pil"  # RGB -> BGR
        return
    if not isinstance(source, (str, Path)):
        raise TypeError(f"the port's predictor takes image paths, directories, videos, streams, numpy or PIL "
                        f"images, got {type(source).__name__}")
    text = str(source)
    if text.lower().startswith(STREAM_PREFIXES) or text.endswith(".streams") or text.isnumeric():
        streams = LoadStreams(text, device=device)
        try:
            for names, frames in streams:
                yield from zip(frames, names)
        finally:
            streams.close()
        return
    if text.startswith("screen"):
        for names, frames in LoadScreenshots(text):
            yield frames[0], names[0]
        return
    p = Path(text)
    if p.is_dir():
        for f in sorted(p.rglob("*")):
            if f.suffix[1:].lower() in IMG_FORMATS:
                yield imread(f, device), str(f)
        return
    suffix = p.suffix[1:].lower()
    if suffix in VID_FORMATS and suffix != "avi":
        raise NotImplementedError(f"{text}: the {suffix} video container is not read by the port; it reads "
                                  "Motion-JPEG AVI (.avi) video only")
    if p.is_file():
        if suffix == "avi":
            for i, frame in enumerate(avi_frames(p, device)):
                yield frame, f"{p}#frame{i}"
            return
        yield imread(p, device), str(p)
        return
    raise FileNotFoundError(f"source not found: {source}")


class DetectionPredictor:
    """Fixed-shape batched predictor for detect and the task heads (the
    model's ``task``). On first use it runs ``model`` as it is when folded
    (``YOLO`` hands it its memoized folded copy), else a folded copy of it;
    ``model`` itself is left as it was. With ``infer_fn`` (an exported
    artifact's ``AutoBackend``) ``model`` is None."""

    def __init__(self, model: DetectionModel | None, names: dict[int, str], imgsz: int = 640,
                 conf: float = 0.25, iou: float = 0.7, max_det: int = 300, batch_size: int = 1,
                 infer_fn=None):
        self.model = model
        self.names = names
        self.nc = len(names)
        self.infer_fn = infer_fn  # AutoBackend: uint8 images -> raw preds, or the NMS dict
        self.task = model.task if model is not None else "detect"
        self.imgsz = imgsz
        self.conf = conf
        self.iou = iou
        self.max_det = max_det
        self.batch_size = batch_size
        self._stem = None  # (StemSpec, StemWeights) once set up
        self._ready = False

    @property
    def device(self) -> torch.device:
        """The model's device, or the artifact backend's."""
        return self.infer_fn.device if self.model is None else next(self.model.parameters()).device

    def _setup(self) -> None:
        if not is_folded(self.model):
            self.model = fold_conv_bn(copy.deepcopy(self.model))
        self.model.eval()
        w = next(self.model.parameters())
        spec = stem_spec_from_model(self.model.spec, (self.imgsz, self.imgsz))
        if spec is not None and w.device.type == "cuda" and w.dtype == torch.bfloat16:
            self._stem = (spec, stem_weights(fold_stem_params(self.model, spec), spec))
        self._ready = True

    @torch.inference_mode()
    def forward(self, batch_u8: torch.Tensor) -> dict[str, torch.Tensor]:
        """uint8 RGB NHWC batch on the model's device -> the head's eval dict
        (layers 0-2 in the stem kernel where the gate allows)."""
        if not self._ready:
            self._setup()
        if self._stem is not None:
            return apply_with_fused_stem(self.model, batch_u8, *self._stem)
        dtype = next(self.model.parameters()).dtype
        return self.model((batch_u8.permute(0, 3, 1, 2).float() / 255.0).to(dtype))

    @torch.inference_mode()
    def postprocess(self, out: dict[str, torch.Tensor]) -> dict[str, torch.Tensor]:
        """The head's eval dict -> the fixed-shape NMS dict, single-label
        (reference nms.py:19 default): ``boxes``, ``scores``, ``classes``,
        ``valid``, and ``angle`` (OBB), ``keypoints`` (pose), or the mask
        coefficients ``extra`` and ``proto`` (segment; ``masks`` makes the
        masks of the rows kept). V10Detect's ``preds6`` (B, max_det, 6) give
        the boxes, scores and classes as they are, valid where the score is
        above ``conf``."""
        if "preds6" in out:
            p6 = out["preds6"]
            return {"boxes": p6[..., :4], "scores": p6[..., 4], "classes": p6[..., 5].to(torch.int32),
                    "valid": p6[..., 4] > self.conf}
        if self.task == "obb":
            nms = rotated_batched_nms(out["preds"], conf_thres=self.conf, iou_thres=self.iou, max_det=self.max_det,
                                      multi_label=False, nc=self.nc)
            nms["angle"] = nms.pop("extra")
            return nms
        nms = batched_nms(out["preds"], conf_thres=self.conf, iou_thres=self.iou, max_det=self.max_det,
                          multi_label=False, nc=self.nc if self.task in ("segment", "pose") else None)
        if self.task == "segment":
            nms["proto"] = out["proto"]
        elif self.task == "pose":
            nms["keypoints"] = nms.pop("extra")
        return nms

    @torch.inference_mode()
    def infer(self, batch_u8: torch.Tensor) -> dict[str, torch.Tensor]:
        """uint8 RGB NHWC batch on the model's device -> fixed-shape NMS dict."""
        if self.infer_fn is not None:
            out = self.infer_fn(batch_u8)
            if isinstance(out, dict):  # NMS inside the artifact
                return out
            return batched_nms(out, conf_thres=self.conf, iou_thres=self.iou, max_det=self.max_det,
                               multi_label=False, nc=self.nc)
        return self.postprocess(self.forward(batch_u8))

    @torch.inference_mode()
    def masks(self, nms: dict[str, torch.Tensor], n: int) -> list[torch.Tensor]:
        """Segment: the (kept, imgsz, imgsz) bool masks of the first ``n``
        images, for the rows NMS kept only (the JAX package makes all
        ``max_det`` of them)."""
        out = []
        for i in range(n):
            keep = nms["valid"][i]
            out.append(process_mask(nms["extra"][i][keep], nms["proto"][i], nms["boxes"][i][keep],
                                    (self.imgsz, self.imgsz)))
        return out

    def stream(self, source) -> Iterator[Results]:
        """Generator over Results, batching the source internally."""
        device = self.device
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
            nms = self.infer(batch)
            masks = self.masks(nms, n) if self.task == "segment" else None
            out = {k: v.cpu().numpy() for k, v in nms.items() if k not in ("proto", "extra")}
            t_inf = time.perf_counter() - t0
            t0 = time.perf_counter()
            for i in range(n):
                orig, path, r, (pw, ph) = pending[i]
                valid = out["valid"][i]
                oh, ow = orig.shape[:2]
                kw = {}
                if self.task == "obb":  # only the centre leaves the letterbox; w and h are scaled, never clipped
                    xywhr = np.concatenate([out["boxes"][i][valid], out["angle"][i][valid][:, :1]], 1)
                    xywhr[:, :2] = (xywhr[:, :2] - np.array([pw, ph])) / r
                    xywhr[:, 2:4] = xywhr[:, 2:4] / r
                    kw["obb"] = np.concatenate([xywhr, out["scores"][i][valid, None],
                                                out["classes"][i][valid, None]], 1)
                else:
                    boxes = (out["boxes"][i][valid] - np.array([pw, ph, pw, ph])) / r
                    boxes[:, [0, 2]] = boxes[:, [0, 2]].clip(0, ow)
                    boxes[:, [1, 3]] = boxes[:, [1, 3]].clip(0, oh)
                    kw["boxes"] = np.concatenate(
                        [boxes, out["scores"][i][valid, None], out["classes"][i][valid, None]], 1)
                if masks is not None:  # to the original image on the device, then to the host
                    kw["masks"] = scale_masks(masks[i], (oh, ow), (pw, ph)).cpu().numpy()
                if "keypoints" in out:
                    k = out["keypoints"][i][valid]
                    ndim = 3 if k.shape[-1] % 3 == 0 else 2
                    kpts = k.reshape(len(k), k.shape[-1] // ndim, ndim).copy()
                    kpts[..., 0] = (kpts[..., 0] - pw) / r
                    kpts[..., 1] = (kpts[..., 1] - ph) / r
                    kw["keypoints"] = kpts
                yield Results(orig, path, self.names, **kw, speed={
                    "preprocess": t_pre * 1000 / n,
                    "inference": t_inf * 1000 / n,
                    "postprocess": (time.perf_counter() - t0) * 1000 / n,
                }, device=device)
            pending.clear()
            imgs.clear()

        for img, path in load_source(source, device):
            lb, r, pad = letterbox(img, self.imgsz, scaleup=False)
            pending.append((img, path, r, pad))
            imgs.append(np.ascontiguousarray(lb[..., ::-1]))  # BGR -> RGB
            if len(pending) == self.batch_size:
                yield from flush()
        yield from flush()
