"""Object counting across a line or region (reference
``fce_yolo_tpu/solutions/counter.py``).

Counts unique track ids whose trajectory crosses the counting line, split
into in/out by crossing direction (sign of the cross product with the line
direction), or ids entering a polygonal region.
"""

from __future__ import annotations

import numpy as np

from fce_yolo_tpu_torch.solutions.base import BaseSolution, SolutionResults

__all__ = ["ObjectCounter"]


class ObjectCounter(BaseSolution):
    def __init__(self, region: list[tuple[float, float]] | None = None, **kw):
        super().__init__(**kw)
        self.region = region or [(0, 0), (1, 0)]
        self.in_count = 0
        self.out_count = 0
        self.counted: set[int] = set()
        self.prev_pos: dict[int, np.ndarray] = {}
        self.classwise: dict[str, dict[str, int]] = {}
        self.show_in = getattr(self.CFG, "show_in", True) if hasattr(self, "CFG") else True
        self.show_out = getattr(self.CFG, "show_out", True) if hasattr(self, "CFG") else True

    def _side(self, p: np.ndarray) -> float:
        """Signed side of the counting line for point p."""
        (x1, y1), (x2, y2) = self.region[0], self.region[1]
        return (x2 - x1) * (p[1] - y1) - (y2 - y1) * (p[0] - x1)

    def _crossing(self, prev: np.ndarray, cur: np.ndarray) -> int:
        """+1 = IN crossing, -1 = OUT crossing, 0 = none. A 2-point region
        counts by line side change; a >=3-point region counts by polygon
        entry/exit."""
        if len(self.region) >= 3:
            from fce_yolo_tpu_torch.solutions.zone import _in_polygon

            poly = np.asarray(self.region, np.float32)
            was_in, is_in = (bool(_in_polygon(p[None], poly)[0]) for p in (prev, cur))
            if is_in and not was_in:
                return 1
            if was_in and not is_in:
                return -1
            return 0
        s0, s1 = self._side(prev), self._side(cur)
        if s0 * s1 < 0:
            return 1 if s1 > 0 else -1
        return 0

    def process(self, result, tracks: np.ndarray) -> SolutionResults:
        ann = self.annotator(result.plot())
        ann.draw_region(self.region, color=(104, 0, 123),
                        thickness=getattr(self, "line_width", 2) * 2)
        for row in tracks:
            tid = int(row[4])
            center = np.array([(row[0] + row[2]) / 2, (row[1] + row[3]) / 2])
            prev = self.prev_pos.get(tid)
            self.prev_pos[tid] = center
            if prev is None or tid in self.counted:
                continue
            direction = self._crossing(prev, center)
            if direction:
                self.counted.add(tid)
                name = self.names.get(int(row[6]), str(int(row[6])))
                cw = self.classwise.setdefault(name, {"IN": 0, "OUT": 0})
                if direction > 0:
                    self.in_count += 1
                    cw["IN"] += 1
                else:
                    self.out_count += 1
                    cw["OUT"] += 1
        # the class-wise banner
        banner = {
            name: " ".join(
                p for p, on in (
                    (f"IN {c['IN']}", getattr(self, "show_in", True)),
                    (f"OUT {c['OUT']}", getattr(self, "show_out", True))) if on)
            for name, c in self.classwise.items()
            if c["IN"] or c["OUT"]
        }
        if banner:
            ann.display_analytics(ann.im, banner)
        return SolutionResults(
            plot_im=ann.result(), in_count=self.in_count,
            out_count=self.out_count, classwise_count=dict(self.classwise),
            total_tracks=len(tracks))
