"""Per-region live object counting (reference
``fce_yolo_tpu/solutions/region_counter.py``): the tracks whose centre is
inside each polygonal region this frame."""

from __future__ import annotations

import numpy as np

from fce_yolo_tpu_torch.solutions.base import BaseSolution, SolutionResults

__all__ = ["RegionCounter"]


def _point_in_poly(p: np.ndarray, poly: np.ndarray) -> bool:
    """Ray-casting point-in-polygon."""
    x, y = p
    inside = False
    n = len(poly)
    for i in range(n):
        x1, y1 = poly[i]
        x2, y2 = poly[(i + 1) % n]
        if (y1 > y) != (y2 > y):
            xin = (x2 - x1) * (y - y1) / (y2 - y1 + 1e-12) + x1
            if x < xin:
                inside = not inside
    return inside


class RegionCounter(BaseSolution):
    def __init__(self, regions: dict[str, list[tuple[float, float]]] | None = None, **kw):
        super().__init__(**kw)
        self.regions = {k: np.asarray(v, np.float32) for k, v in (regions or {}).items()}

    def process(self, result, tracks: np.ndarray) -> SolutionResults:
        ann = self.annotator(result.plot())
        counts = {k: 0 for k in self.regions}
        for row in tracks:
            c = np.array([(row[0] + row[2]) / 2, (row[1] + row[3]) / 2])
            for name, poly in self.regions.items():
                if _point_in_poly(c, poly):
                    counts[name] += 1
        for name, poly in self.regions.items():
            ann.draw_region(poly, color=(255, 0, 255), thickness=2)
            org = poly.mean(0)
            ann.display_objects_labels(
                ann.im, f"{name}: {counts[name]}", x_center=org[0],
                y_center=org[1])
        return SolutionResults(plot_im=ann.result(), region_counts=counts,
                               total_tracks=len(tracks))
