"""Visual-output solutions: ``VisionEye``, ``ObjectBlurrer``,
``ObjectCropper`` and ``InstanceSegmentation`` (reference
``fce_yolo_tpu/solutions/visuals.py``). The blur is ``utils/imgproc.py``'s
(cv2's 8-bit Gaussian, bit for bit); crops are written by
``utils/patches.py``, whose JPEG writer runs its forward DCT on the model's
device.
"""

from __future__ import annotations

from pathlib import Path

import numpy as np

from fce_yolo_tpu_torch.solutions.base import BaseSolution, SolutionResults
from fce_yolo_tpu_torch.utils.imgproc import gaussian_blur
from fce_yolo_tpu_torch.utils.patches import imwrite

__all__ = ["VisionEye", "ObjectBlurrer", "ObjectCropper", "InstanceSegmentation"]


class VisionEye(BaseSolution):
    """A line from a fixed eye point to every tracked object's centre."""

    def __init__(self, vision_point: tuple[int, int] = (20, 20), **kw):
        super().__init__(**kw)
        self.vision_point = tuple(int(v) for v in vision_point)

    def process(self, result, tracks: np.ndarray) -> SolutionResults:
        ann = self.annotator(result.plot())
        for row in tracks:
            ann.visioneye(row[:4], self.vision_point)
        return SolutionResults(plot_im=ann.result(), total_tracks=len(tracks))


class ObjectBlurrer(BaseSolution):
    """A Gaussian blur over every tracked box (privacy masking); the kernel
    is ``blur_ratio`` * 50, odd, at least 3."""

    def __init__(self, blur_ratio: float = 0.5, **kw):
        super().__init__(**kw)
        self.k = max(3, int(blur_ratio * 50) | 1)

    def process(self, result, tracks: np.ndarray) -> SolutionResults:
        img = result.orig_img.copy()
        h, w = img.shape[:2]
        for row in tracks:
            x1, y1 = max(int(row[0]), 0), max(int(row[1]), 0)
            x2, y2 = min(int(row[2]), w), min(int(row[3]), h)
            if x2 > x1 and y2 > y1:
                img[y1:y2, x1:x2] = gaussian_blur(img[y1:y2, x1:x2], self.k)
        return SolutionResults(plot_im=img, total_tracks=len(tracks))


class ObjectCropper(BaseSolution):
    """A JPEG of each tracked box's crop, ``<class>_<n>.jpg`` in ``crop_dir``."""

    def __init__(self, crop_dir: str = "cropped-detections", **kw):
        super().__init__(**kw)
        self.crop_dir = Path(crop_dir)
        self.crop_dir.mkdir(parents=True, exist_ok=True)
        self.crop_idx = 0

    def process(self, result, tracks: np.ndarray) -> SolutionResults:
        img = result.orig_img
        h, w = img.shape[:2]
        for row in tracks:
            x1, y1 = max(int(row[0]), 0), max(int(row[1]), 0)
            x2, y2 = min(int(row[2]), w), min(int(row[3]), h)
            if x2 > x1 and y2 > y1:
                self.crop_idx += 1
                name = self.names.get(int(row[6]), str(int(row[6])))
                imwrite(self.crop_dir / f"{name}_{self.crop_idx}.jpg", np.ascontiguousarray(img[y1:y2, x1:x2]),
                        device=getattr(self, "device", "cuda"))
        return SolutionResults(plot_im=result.plot(), total_crop_objects=self.crop_idx, total_tracks=len(tracks))


class InstanceSegmentation(BaseSolution):
    """A segmentation model's masks over the frame (``Results.plot``; boxes
    alone where the result has no masks)."""

    def __init__(self, alpha: float = 0.5, **kw):
        kw.setdefault("model", "yolo11n-seg.yaml")
        super().__init__(**kw)
        self.alpha = alpha

    def process(self, result, tracks: np.ndarray) -> SolutionResults:
        img = result.plot()
        n_masks = 0 if result.masks is None else len(result.masks)
        return SolutionResults(plot_im=img, total_tracks=len(tracks), masks=n_masks)
