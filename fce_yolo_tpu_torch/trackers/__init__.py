"""Multi-object trackers, ByteTrack and BoT-SORT, numpy and scipy on the
host (reference ``fce_yolo_tpu/trackers/``). The camera-motion
compensation's cv2 calls are ``trackers/flow.py``."""

from fce_yolo_tpu_torch.trackers.bot_sort import BOTSORT, GMC
from fce_yolo_tpu_torch.trackers.byte_tracker import BYTETracker, STrack, TrackerArgs
from fce_yolo_tpu_torch.trackers.kalman import KalmanFilterXYAH
from fce_yolo_tpu_torch.trackers.track import build_tracker, track_stream

__all__ = [
    "BOTSORT",
    "BYTETracker",
    "GMC",
    "KalmanFilterXYAH",
    "STrack",
    "TrackerArgs",
    "build_tracker",
    "track_stream",
]
