"""The solutions layer of the port (reference ``fce_yolo_tpu/solutions/``):
the apps users build on tracking, each a ``BaseSolution`` run on
``trackers/track.py::track_stream`` (on the card, the stem kernel and the
NMS kernel once a frame): counting, heatmap, regions, speed, zones, queues,
parking, overlays, crops and blur, analytics charts, distance, alarms,
workouts; and similarity search and a batch-inference app. The host work is
numpy; cv2's and matplotlib's calls are ``utils/draw.py``,
``utils/imgproc.py`` and ``utils/chart.py``.
"""

from fce_yolo_tpu_torch.solutions.analytics import AIGym, Analytics, DistanceCalculation, SecurityAlarm
from fce_yolo_tpu_torch.solutions.annotator import SolutionAnnotator
from fce_yolo_tpu_torch.solutions.base import BaseSolution, SolutionResults
from fce_yolo_tpu_torch.solutions.config import SolutionConfig
from fce_yolo_tpu_torch.solutions.counter import ObjectCounter
from fce_yolo_tpu_torch.solutions.heatmap import Heatmap
from fce_yolo_tpu_torch.solutions.region_counter import RegionCounter
from fce_yolo_tpu_torch.solutions.search import Inference, VisualAISearch
from fce_yolo_tpu_torch.solutions.speed import SpeedEstimator
from fce_yolo_tpu_torch.solutions.visuals import (
    InstanceSegmentation,
    ObjectBlurrer,
    ObjectCropper,
    VisionEye,
)
from fce_yolo_tpu_torch.solutions.zone import ParkingManagement, QueueManager, TrackZone

__all__ = [
    "AIGym",
    "Analytics",
    "BaseSolution",
    "DistanceCalculation",
    "Heatmap",
    "Inference",
    "InstanceSegmentation",
    "ObjectBlurrer",
    "ObjectCropper",
    "ObjectCounter",
    "ParkingManagement",
    "QueueManager",
    "RegionCounter",
    "SecurityAlarm",
    "SolutionAnnotator",
    "SolutionConfig",
    "SolutionResults",
    "SpeedEstimator",
    "TrackZone",
    "VisionEye",
    "VisualAISearch",
]
