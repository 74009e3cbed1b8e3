"""Region-scoped solutions: ``TrackZone``, ``QueueManager`` and
``ParkingManagement`` (reference ``fce_yolo_tpu/solutions/zone.py``), on the
host in numpy.
"""

from __future__ import annotations

import numpy as np

from fce_yolo_tpu_torch.solutions.base import BaseSolution, SolutionResults

__all__ = ["TrackZone", "QueueManager", "ParkingManagement"]


def _in_polygon(points: np.ndarray, polygon: np.ndarray) -> np.ndarray:
    """Vectorized point-in-polygon (ray casting). points (N, 2), polygon (M, 2)."""
    x, y = points[:, 0:1], points[:, 1:2]
    x1, y1 = polygon[:, 0], polygon[:, 1]
    x2, y2 = np.roll(x1, -1), np.roll(y1, -1)
    cross = (y1 <= y[:, ...]) != (y2 <= y)
    with np.errstate(divide="ignore", invalid="ignore"):
        xin = x1 + (y - y1) * (x2 - x1) / np.where(y2 == y1, np.inf, y2 - y1)
    hits = cross & (x < xin)
    return hits.sum(axis=1) % 2 == 1


class TrackZone(BaseSolution):
    """Track objects only inside a polygonal zone (reference trackzone.py:30-88:
    the zone is masked before inference; here detections outside the zone are
    filtered after tracking — same visible contract, no second inference)."""

    def __init__(self, region: list[tuple[float, float]] | None = None, **kw):
        super().__init__(**kw)
        self.region = np.asarray(region or [(75, 75), (565, 75), (565, 285), (75, 285)], np.float32)

    def process(self, result, tracks: np.ndarray) -> SolutionResults:
        ann = self.annotator(result.orig_img.copy())
        if len(tracks):
            centers = np.stack([(tracks[:, 0] + tracks[:, 2]) / 2, (tracks[:, 1] + tracks[:, 3]) / 2], 1)
            tracks = tracks[_in_polygon(centers, self.region)]
        ann.draw_region(self.region, color=(255, 255, 255), thickness=2)
        for row in tracks:
            ann.box_label(row[:4], f"id{int(row[4])}", color=(0, 255, 0))
        return SolutionResults(plot_im=ann.result(), total_tracks=len(tracks))


class QueueManager(BaseSolution):
    """Queue length monitoring: counts tracked objects currently inside the
    queue region (reference queue_management.py)."""

    def __init__(self, region: list[tuple[float, float]] | None = None, **kw):
        super().__init__(**kw)
        self.region = np.asarray(region or [(20, 60), (620, 60), (620, 360), (20, 360)], np.float32)
        self.max_queue = 0

    def process(self, result, tracks: np.ndarray) -> SolutionResults:
        ann = self.annotator(result.plot())
        count = 0
        if len(tracks):
            centers = np.stack([(tracks[:, 0] + tracks[:, 2]) / 2, (tracks[:, 1] + tracks[:, 3]) / 2], 1)
            count = int(_in_polygon(centers, self.region).sum())
        self.max_queue = max(self.max_queue, count)
        ann.draw_region(self.region, color=(0, 255, 255), thickness=2)
        ann.queue_counts_display(f"Queue Counts : {count}", points=self.region)
        return SolutionResults(plot_im=ann.result(), queue_count=count,
                               total_tracks=len(tracks),
                               max_queue=self.max_queue)


class ParkingManagement(BaseSolution):
    """Parking occupancy over a set of slot polygons (reference
    parking_management.py: JSON slot regions; a slot is occupied when any
    detection center falls inside it)."""

    def __init__(self, slots: list[list[tuple[float, float]]] | str | None = None,
                 json_file: str | None = None, **kw):
        super().__init__(**kw)
        slots = slots if slots is not None else json_file
        if isinstance(slots, str):  # JSON file of [{"points": [[x,y],...]}]
            import json

            slots = [s["points"] for s in json.loads(open(slots).read())]
        self.slots = [np.asarray(s, np.float32) for s in (slots or [])]

    def process(self, result, tracks: np.ndarray) -> SolutionResults:
        ann = self.annotator(result.orig_img.copy())
        centers = (
            np.stack([(tracks[:, 0] + tracks[:, 2]) / 2, (tracks[:, 1] + tracks[:, 3]) / 2], 1)
            if len(tracks) else np.zeros((0, 2), np.float32)
        )
        occupied = 0
        for poly in self.slots:
            occ = len(centers) > 0 and bool(_in_polygon(centers, poly).any())
            occupied += occ
            ann.draw_region(poly, color=(0, 0, 255) if occ else (0, 255, 0),
                            thickness=2)
        ann.display_analytics(
            ann.im, {"Occupancy": occupied,
                     "Available": len(self.slots) - occupied})
        return SolutionResults(plot_im=ann.result(), filled_slots=occupied,
                               available_slots=len(self.slots) - occupied,
                               total_tracks=len(tracks))
