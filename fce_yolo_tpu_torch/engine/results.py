"""Detection result containers, host-side numpy (reference
``fce_yolo_tpu/engine/results.py:18-62, 180-278, 364``). Plotting is not
ported yet."""

from __future__ import annotations

import json

import numpy as np

__all__ = ["Boxes", "Results"]


class Boxes:
    """Final detection boxes of one image: (n, 6) [x1, y1, x2, y2, conf, cls]
    in original-image pixels."""

    def __init__(self, data: np.ndarray, orig_shape: tuple[int, int]):
        self.data = np.asarray(data, np.float32).reshape(-1, 6)
        self.orig_shape = orig_shape

    def __len__(self) -> int:
        return len(self.data)

    def __getitem__(self, i) -> "Boxes":
        return Boxes(self.data[i], self.orig_shape)

    @property
    def xyxy(self) -> np.ndarray:
        return self.data[:, :4]

    @property
    def conf(self) -> np.ndarray:
        return self.data[:, 4]

    @property
    def cls(self) -> np.ndarray:
        return self.data[:, 5]

    @property
    def xywh(self) -> np.ndarray:
        b = self.data[:, :4]
        return np.stack(
            [(b[:, 0] + b[:, 2]) / 2, (b[:, 1] + b[:, 3]) / 2, b[:, 2] - b[:, 0], b[:, 3] - b[:, 1]], 1)

    @property
    def xyxyn(self) -> np.ndarray:
        h, w = self.orig_shape
        return self.data[:, :4] / np.array([w, h, w, h], np.float32)

    @property
    def xywhn(self) -> np.ndarray:
        h, w = self.orig_shape
        return self.xywh / np.array([w, h, w, h], np.float32)


class Results:
    """One image's detections."""

    def __init__(self, orig_img: np.ndarray, path: str, names: dict[int, str],
                 boxes: np.ndarray | None = None, speed: dict | None = None):
        self.orig_img = orig_img
        self.orig_shape = orig_img.shape[:2]
        self.path = path
        self.names = names
        self.boxes = Boxes(boxes if boxes is not None else np.zeros((0, 6)), self.orig_shape)
        self.speed = speed or {"preprocess": 0.0, "inference": 0.0, "postprocess": 0.0}

    def __len__(self) -> int:
        return len(self.boxes)

    def __repr__(self) -> str:
        return f"Results(path={self.path!r}, n={len(self)}, shape={self.orig_shape})"

    def __getitem__(self, idx) -> "Results":
        sel = np.atleast_1d(np.arange(len(self))[idx])
        return Results(self.orig_img, self.path, self.names, boxes=self.boxes.data[sel], speed=self.speed)

    def verbose(self) -> str:
        """Per-image log string, e.g. '2 persons, 1 bus, '."""
        if len(self) == 0:
            return "(no detections), "
        counts: dict[int, int] = {}
        for c in self.boxes.cls.astype(int):
            counts[c] = counts.get(c, 0) + 1
        return "".join(f"{n} {self.names.get(c, str(c))}{'s' if n > 1 else ''}, "
                       for c, n in sorted(counts.items()))

    def summary(self, normalize: bool = False, decimals: int = 5) -> list[dict]:
        """Per-detection dicts (reference Results.summary)."""
        h, w = self.orig_shape if normalize else (1, 1)
        out = []
        for row in self.boxes.data:
            c = int(row[5])
            out.append({
                "name": self.names.get(c, str(c)),
                "class": c,
                "confidence": round(float(row[4]), decimals),
                "box": {k: round(float(v) / (w if k in ("x1", "x2") else h), decimals)
                        for k, v in zip(("x1", "y1", "x2", "y2"), row[:4])},
            })
        return out

    def to_json(self) -> str:
        return json.dumps(self.summary(), indent=2)
