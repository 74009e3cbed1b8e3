"""Visual similarity search and the batch-inference app (reference
``fce_yolo_tpu/solutions/search.py``).

``VisualAISearch`` indexes a directory of images and answers a query with
the top-k matches. Two backends:

- ``"hsv"`` (the default): an 8 x 8 x 8 HSV histogram on a 2 x 2 grid,
  L2-normalised (``utils/imgproc.py::calc_hist_hsv`` on
  ``data/augment.py::bgr_to_hsv``, bit-equal to the reference's cv2 calls);
  image queries;
- ``"clip"`` (or ``clip_weights=``): the CLIP image tower
  (``nn/clip_vision.py``) and text tower (``nn/text_model.py``) on
  ``device``; text queries too. Without weights the towers are seeded.

Images are read by ``data/imread.py`` on ``device`` (a JPEG's IDCT and
colour kernels on the card). ``Inference`` writes each annotated frame as
a JPEG through ``utils/patches.py`` (the forward DCT on the model's device).
"""

from __future__ import annotations

from pathlib import Path

import numpy as np

from fce_yolo_tpu_torch.data.augment import bgr_to_hsv
from fce_yolo_tpu_torch.data.imread import imread
from fce_yolo_tpu_torch.utils.imgproc import calc_hist_hsv
from fce_yolo_tpu_torch.utils.patches import imwrite

__all__ = ["VisualAISearch", "Inference"]

IMAGE_SUFFIXES = (".jpg", ".jpeg", ".png", ".bmp")


class VisualAISearch:
    """Query-by-example (and, with CLIP, text) search over the images under
    ``data``. ``encoders`` injects a (text encoder, image encoder) pair."""

    def __init__(self, data: str = "images", k: int = 5, backend: str = "hsv", clip_weights: str | None = None,
                 encoders: tuple | None = None, device="cuda"):
        self.data = Path(data)
        self.k = k
        self.device = device
        self._clip = encoders
        if self._clip is None and (clip_weights or backend == "clip"):
            from fce_yolo_tpu_torch.nn.clip_vision import CLIPImageEncoder
            from fce_yolo_tpu_torch.nn.text_model import CLIPTextEncoder

            self._clip = (CLIPTextEncoder(weights=clip_weights, device=device),
                          CLIPImageEncoder(weights=clip_weights, device=device))
        self.paths: list[Path] = sorted(p for p in self.data.rglob("*") if p.suffix.lower() in IMAGE_SUFFIXES)
        feats = []
        for p in self.paths:
            img = imread(p, device=device)
            feats.append(self._embed(img) if self._clip is None else self._clip[1].encode_image([img])[0])
        self.feats = np.stack(feats, 0) if feats else np.zeros((0, 512), np.float32)

    @staticmethod
    def _embed(img: np.ndarray) -> np.ndarray:
        """The 2048-d HSV signature: a joint 8x8x8 histogram of each cell of a
        2x2 grid, L2-normalised."""
        hsv = bgr_to_hsv(img)
        h, w = hsv.shape[:2]
        cells = []
        for iy in range(2):
            for ix in range(2):
                cell = hsv[iy * h // 2: (iy + 1) * h // 2, ix * w // 2: (ix + 1) * w // 2]
                cells.append(calc_hist_hsv(cell).reshape(-1))
        v = np.concatenate(cells).astype(np.float32)
        return v / (np.linalg.norm(v) + 1e-9)

    def search(self, query: str | np.ndarray, k: int | None = None) -> list[tuple[str, float]]:
        """The top-k (path, similarity) matches of an image (a path or a BGR
        array) or, with the CLIP backend, of a text."""
        if isinstance(query, (str, Path)) and not Path(str(query)).exists():
            if self._clip is None:
                raise ValueError(f"{query!r} is no file, and text queries need the clip backend "
                                 "(clip_weights= or backend='clip')")
            q = self._clip[0].encode_text([str(query)])[0]
        elif self._clip is not None:
            img = imread(query, device=self.device) if isinstance(query, (str, Path)) else np.asarray(query)
            q = self._clip[1].encode_image([img])[0]
        else:
            if isinstance(query, (str, Path)):
                query = imread(query, device=self.device)
            q = self._embed(np.asarray(query))
        sims = self.feats @ q
        order = np.argsort(-sims)[: (k or self.k)]
        return [(str(self.paths[i]), float(sims[i])) for i in order]

    __call__ = search


class Inference:
    """Batch inference: a model over a source, each annotated frame written
    to ``out_dir`` as ``frame_<i>.jpg`` (the reference's headless stand-in
    for its upstream's streamlit app). ``model`` is a name or path, built on
    ``device`` (the card unless another is named), or a ``YOLO``."""

    def __init__(self, model: str = "yolo11n.yaml", conf: float = 0.25, iou: float = 0.7, imgsz: int = 640,
                 out_dir: str = "runs/inference", device="cuda"):
        from fce_yolo_tpu_torch.api import YOLO

        self.model = model if not isinstance(model, str) else YOLO(model, device=device or "cuda")
        self.conf, self.iou, self.imgsz = conf, iou, imgsz
        self.out_dir = Path(out_dir)
        self.out_dir.mkdir(parents=True, exist_ok=True)

    def __call__(self, source) -> list[str]:
        written = []
        for i, r in enumerate(self.model.predict(source, conf=self.conf, iou=self.iou, imgsz=self.imgsz,
                                                 stream=True)):
            p = self.out_dir / f"frame_{i:05d}.jpg"
            imwrite(p, r.plot(), device=self.model.device)
            written.append(str(p))
        return written
