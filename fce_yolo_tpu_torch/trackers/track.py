"""Tracking entry point: a source streamed through predict and a tracker
(reference ``fce_yolo_tpu/trackers/track.py``: ``build_tracker:19``,
``_crop_embed_encoder:41``, ``track_stream:58``)."""

from __future__ import annotations

from pathlib import Path

import numpy as np

from fce_yolo_tpu_torch.trackers.bot_sort import BOTSORT
from fce_yolo_tpu_torch.trackers.byte_tracker import BYTETracker, TrackerArgs
from fce_yolo_tpu_torch.utils.yaml_read import read_yaml

__all__ = ["build_tracker", "track_stream"]

TRACKER_DIR = Path(__file__).parent / "cfg"


def build_tracker(tracker: str = "bytetrack.yaml", frame_rate: int = 30, encoder=None):
    """A tracker from a YAML path, a YAML name under ``trackers/cfg/``, or a
    name with "botsort" or "bytetrack" in it (the defaults). ``encoder`` is
    the optional ReID callable (img, xyxy) -> (N, D) features that BoT-SORT
    uses when its ``with_reid`` is set."""
    name = str(tracker)
    cfg: dict = {}
    p = Path(name)
    if p.suffix == ".yaml":
        for cand in (p, TRACKER_DIR / p.name):
            if cand.exists():
                cfg = read_yaml(cand.read_text()) or {}
                break
        else:
            name = p.stem  # fall through to defaults by name
    args = TrackerArgs(**{k: v for k, v in cfg.items() if k in TrackerArgs.__dataclass_fields__})
    ttype = cfg.get("tracker_type", "botsort" if "botsort" in name else "bytetrack")
    if ttype == "botsort":
        return BOTSORT(args, frame_rate, encoder=encoder)
    return BYTETracker(args, frame_rate)


def _crop_embed_encoder(model, imgsz: int = 128):
    """ReID encoder from the detector itself (the reference's with_reid
    model="auto" mode): each detection's crop, at least 2 px a side, is
    embedded by ``model.embed`` at ``imgsz``. A box on the image's far edge
    (one the clip to the image flattened there) takes the edge's last 2 px,
    where the reference's crop is empty and its letterbox raises."""

    def encoder(img: np.ndarray, boxes: np.ndarray) -> np.ndarray:
        h, w = img.shape[:2]
        crops = []
        for x1, y1, x2, y2 in boxes.astype(int):
            x1, y1 = min(max(x1, 0), w - 2), min(max(y1, 0), h - 2)
            x2, y2 = min(max(x2, x1 + 2), w), min(max(y2, y1 + 2), h)
            crops.append(img[y1:y2, x1:x2])
        return np.stack(model.embed(crops, imgsz=imgsz)) if crops else np.zeros((0, 1))

    return encoder


def track_stream(model, source, tracker="bytetrack.yaml", **predict_kw):
    """Yield (Results, tracks (M, 7) [x1, y1, x2, y2, id, score, cls]) a
    frame. ``tracker`` is a tracker (kept across calls by ``YOLO.track``'s
    ``persist``) or what ``build_tracker`` takes."""
    if not isinstance(tracker, BYTETracker):
        tracker = build_tracker(tracker, encoder=_crop_embed_encoder(model) if hasattr(model, "embed") else None)
    for result in model.predict(source, stream=True, **predict_kw):
        b = result.boxes
        tracks = tracker.update(b.xyxy, b.conf, b.cls, img=result.orig_img)
        yield result, tracks
