"""Typed configuration of the solutions layer (reference
``fce_yolo_tpu/solutions/config.py``: ``SolutionConfig``).

One dataclass carries every solution knob, with the reference's fields and
defaults; ``update`` raises ``ValueError`` on a key it does not know.
"""

from __future__ import annotations

from dataclasses import dataclass, field
from typing import Any

__all__ = ["SolutionConfig"]


@dataclass
class SolutionConfig:
    """Every solution's parameters. ``device`` is where ``BaseSolution``
    builds a model it is given by name (empty: the card); ``show`` and
    ``half`` are accepted and ignored, as in the reference."""

    source: str | None = None
    model: str | None = None
    classes: list[int] | None = None
    show_conf: bool = True
    show_labels: bool = True
    region: list[tuple[int, int]] | None = None
    colormap: int | None = None  # a cv2 colormap id (utils/imgproc.py): JET when None
    show_in: bool = True
    show_out: bool = True
    up_angle: float = 145.0
    down_angle: int = 90
    kpts: list[int] = field(default_factory=lambda: [6, 8, 10])
    analytics_type: str = "line"
    figsize: tuple[int, int] | None = (12.8, 7.2)
    blur_ratio: float = 0.5
    vision_point: tuple[int, int] = (20, 20)
    crop_dir: str = "cropped-detections"
    json_file: str | None = None
    line_width: int = 2
    records: int = 5
    fps: float = 30.0
    max_hist: int = 5
    meter_per_pixel: float = 0.05
    max_speed: int = 120
    show: bool = False
    iou: float = 0.7
    conf: float = 0.25
    device: str | None = None
    max_det: int = 300
    half: bool = False
    tracker: str = "bytetrack.yaml"
    verbose: bool = True
    data: str = "images"

    def update(self, **kwargs: Any) -> "SolutionConfig":
        """Set known fields; raise ``ValueError`` on any unknown key."""
        for key, value in kwargs.items():
            if not hasattr(self, key):
                raise ValueError(
                    f"{key} is not a valid solution argument; see "
                    "SolutionConfig for the supported set")
            setattr(self, key, value)
        return self
