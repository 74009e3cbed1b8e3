"""Speed estimation from track displacement (reference
``fce_yolo_tpu/solutions/speed.py``).

Pixel displacement per frame x meters-per-pixel x fps => km/h, averaged over
a short window per track id.
"""

from __future__ import annotations

from collections import defaultdict, deque

import numpy as np

from fce_yolo_tpu_torch.solutions.base import BaseSolution, SolutionResults

__all__ = ["SpeedEstimator"]


class SpeedEstimator(BaseSolution):
    def __init__(self, meter_per_pixel: float | None = None, fps: float | None = None,
                 window: int | None = None, **kw):
        super().__init__(**kw)
        # knob names follow SolutionConfig (meter_per_pixel, fps, max_hist), so CLI k=v values reach the estimator
        self.mpp = meter_per_pixel if meter_per_pixel is not None else self.CFG.meter_per_pixel
        self.fps = fps if fps is not None else self.CFG.fps
        self.max_speed = self.CFG.max_speed
        maxlen = window if window is not None else self.CFG.max_hist
        self.hist: dict[int, deque] = defaultdict(lambda: deque(maxlen=maxlen))
        self.speeds: dict[int, float] = {}

    def process(self, result, tracks: np.ndarray) -> SolutionResults:
        ann = self.annotator(result.plot())
        for row in tracks:
            tid = int(row[4])
            c = np.array([(row[0] + row[2]) / 2, (row[1] + row[3]) / 2])
            self.hist[tid].append(c)
            pts = self.hist[tid]
            if len(pts) >= 2:
                dist_px = float(np.linalg.norm(pts[-1] - pts[0])) / (len(pts) - 1)
                # km/h, capped at max_speed
                self.speeds[tid] = min(dist_px * self.mpp * self.fps * 3.6,
                                       float(self.max_speed))
                ann.adaptive_label(row[:4], f"{self.speeds[tid]:.1f} km/h",
                                   color=(104, 31, 17))
        return SolutionResults(plot_im=ann.result(),
                               speed_dict=dict(self.speeds),
                               total_tracks=len(tracks))
