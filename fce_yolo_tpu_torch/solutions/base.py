"""The solutions' core: ``SolutionResults`` and ``BaseSolution`` (reference
``fce_yolo_tpu/solutions/base.py``)."""

from __future__ import annotations

import time

import numpy as np

from fce_yolo_tpu_torch.solutions.config import SolutionConfig

__all__ = ["BaseSolution", "SolutionResults"]


class SolutionResults:
    """What every solution returns a frame: the annotated frame and the
    metric fields each app fills in; other keywords become attributes (an
    app's extras, e.g. ``max_heat``)."""

    def __init__(self, **kwargs):
        self.plot_im: np.ndarray | None = None
        self.in_count = 0
        self.out_count = 0
        self.classwise_count: dict = {}
        self.queue_count = 0
        self.workout_count = 0
        self.workout_angle = 0.0
        self.workout_stage = None
        self.pixels_distance = 0.0
        self.available_slots = 0
        self.filled_slots = 0
        self.email_sent = False
        self.total_tracks = 0
        self.region_counts: dict = {}
        self.speed_dict: dict = {}
        self.total_crop_objects = 0
        self.speed: dict = {}
        self.__dict__.update(kwargs)

    def __str__(self) -> str:
        """The fields that differ from their defaults, ``plot_im`` left out."""
        attrs = {
            k: v for k, v in self.__dict__.items()
            if k != "plot_im" and not (v is None or v == {} or v == 0 or v == 0.0 or v is False)
        }
        return ", ".join(f"{k}={v}" for k, v in attrs.items())


class BaseSolution:
    """A model and a tracker; a subclass implements ``process(result,
    tracks) -> SolutionResults``.

    Every keyword is checked against :class:`SolutionConfig`. ``model`` is a
    name or path that ``YOLO`` takes, built on ``device`` (empty: the card),
    or a ``YOLO``. Calling the solution on a source yields one
    ``SolutionResults`` a frame::

        sol = ObjectCounter(model="yolo11s-fce.yaml", region=[(0, 300), (640, 300)])
        for res in sol("video.avi"):
            res.plot_im, res.in_count, ...
    """

    def __init__(self, model: str = "yolo11n.yaml", **kwargs):
        from fce_yolo_tpu_torch.api import YOLO

        self.CFG = SolutionConfig(model=model if isinstance(model, str) else None).update(**kwargs)
        self.model = model if not isinstance(model, str) else YOLO(model, device=self.CFG.device or "cuda")
        self.device = self.model.device
        self.tracker_cfg = self.CFG.tracker
        self.conf = self.CFG.conf
        self.iou = self.CFG.iou
        self.imgsz = 640
        self.classes = self.CFG.classes
        self.line_width = self.CFG.line_width
        self.names = self.model.names

    def annotator(self, img: np.ndarray):
        """A SolutionAnnotator over ``img`` at the configured line width."""
        from fce_yolo_tpu_torch.solutions.annotator import SolutionAnnotator

        return SolutionAnnotator(np.ascontiguousarray(img), getattr(self, "line_width", 2),
                                 device=getattr(self, "device", "cuda"))

    def __call__(self, source, **kw):
        """One SolutionResults a frame of ``source`` through ``track_stream``,
        with the milliseconds of the frame's tracking and of ``process`` in
        ``speed``. Keywords go to ``predict``; ``imgsz`` replaces the
        solution's 640 (the reference raises on it: ROADMAP queue 3, item 40)."""
        from fce_yolo_tpu_torch.trackers.track import track_stream

        kw = {"imgsz": self.imgsz, **kw}
        t0 = time.perf_counter()
        for result, tracks in track_stream(self.model, source, tracker=self.tracker_cfg, conf=self.conf,
                                           iou=self.iou, **kw):
            t1 = time.perf_counter()
            if self.classes is not None and len(tracks):
                tracks = tracks[np.isin(tracks[:, 6].astype(int), self.classes)]
            out = self.process(result, tracks)
            t2 = time.perf_counter()
            out.speed = {"track": (t1 - t0) * 1e3, "solution": (t2 - t1) * 1e3}
            yield out
            t0 = time.perf_counter()

    def process(self, result, tracks: np.ndarray) -> SolutionResults:
        raise NotImplementedError
