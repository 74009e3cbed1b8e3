"""Presence heatmap over tracked detections (reference
``fce_yolo_tpu/solutions/heatmap.py``).

``Heatmap`` extends ``ObjectCounter``, so a counting line or region can be
drawn over the decaying heat; each box adds 2 inside its inscribed circle.
The accumulator is normalised, coloured and blended by ``utils/imgproc.py``
and ``utils/draw.py``, bit-equal to the reference's cv2 calls.
"""

from __future__ import annotations

import numpy as np

from fce_yolo_tpu_torch.solutions.base import SolutionResults
from fce_yolo_tpu_torch.solutions.counter import ObjectCounter
from fce_yolo_tpu_torch.utils import draw, imgproc

__all__ = ["Heatmap"]


class Heatmap(ObjectCounter):
    def __init__(self, colormap: int | None = None, alpha: float = 0.5,
                 region: list[tuple[float, float]] | None = None, **kw):
        self.count_enabled = region is not None
        super().__init__(region=region, **kw)
        self.colormap = imgproc.COLORMAP_JET if colormap is None else colormap
        self.alpha = alpha
        self.acc: np.ndarray | None = None

    def heatmap_effect(self, box) -> None:
        """+2 inside the box's inscribed circle."""
        h, w = self.acc.shape
        x0, y0, x1, y1 = (int(v) for v in box[:4])
        x0, y0 = max(x0, 0), max(y0, 0)
        x1, y1 = min(x1, w), min(y1, h)
        if x1 <= x0 or y1 <= y0:
            return
        radius_sq = (min(x1 - x0, y1 - y0) // 2) ** 2
        xv, yv = np.meshgrid(np.arange(x0, x1), np.arange(y0, y1))
        dist_sq = (xv - (x0 + x1) // 2) ** 2 + (yv - (y0 + y1) // 2) ** 2
        self.acc[y0:y1, x0:x1][dist_sq <= radius_sq] += 2.0

    def process(self, result, tracks: np.ndarray) -> SolutionResults:
        h, w = result.orig_shape
        if self.acc is None or self.acc.shape != (h, w):
            self.acc = np.zeros((h, w), np.float32)
        for row in tracks:
            self.heatmap_effect(row)

        if self.count_enabled:
            res = super().process(result, tracks)
            img = res.plot_im
        else:  # the counter's fields all the same: in/out 0 and the class-wise counts
            classwise: dict[str, int] = {}
            for row in tracks:
                name = self.names.get(int(row[6]), str(int(row[6])))
                classwise[name] = classwise.get(name, 0) + 1
            res = SolutionResults(total_tracks=len(tracks), in_count=0, out_count=0, classwise_count=classwise)
            img = result.orig_img.copy()

        if self.acc.max() > 0:
            norm = imgproc.normalize_minmax(self.acc).astype(np.uint8)
            heat = imgproc.apply_color_map(norm, self.colormap)
            img = draw.add_weighted(img, 1 - self.alpha, heat, self.alpha, 0)
        res.plot_im = img
        res.total_tracks = len(tracks)
        res.max_heat = float(self.acc.max())
        return res
