"""Result containers, host-side numpy (reference
``fce_yolo_tpu/engine/results.py:18-178, 180-278, 364``): boxes, and for
the task heads masks, keypoints, oriented boxes and class probabilities. Plotting, and the
mask outlines (``Masks.xy``, which the reference traces with
``cv2.findContours``), are not ported yet (ROADMAP queue 1, item 4)."""

from __future__ import annotations

import json

import numpy as np

from fce_yolo_tpu_torch.ops.geometry import xywhr2xyxyxyxy

__all__ = ["Boxes", "Masks", "Keypoints", "OBB", "Probs", "Results"]

NOT_PORTED = "mask outlines (cv2.findContours in the reference) are not ported yet (ROADMAP queue 1, item 4)"


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


class Masks:
    """Per-detection binary masks (n, H, W) in original-image pixels (reference results.py:64-84)."""

    def __init__(self, data: np.ndarray, orig_shape: tuple[int, int]):
        self.data = np.asarray(data, bool)
        self.orig_shape = orig_shape

    def __len__(self) -> int:
        return len(self.data)

    @property
    def xy(self) -> list[np.ndarray]:
        raise NotImplementedError(NOT_PORTED)


class Keypoints:
    """Per-detection keypoints (n, nkpt, 2 or 3) in original-image pixels (reference results.py:87-106)."""

    def __init__(self, data: np.ndarray, orig_shape: tuple[int, int]):
        self.data = np.asarray(data, np.float32)
        self.orig_shape = orig_shape

    def __len__(self) -> int:
        return len(self.data)

    @property
    def xy(self) -> np.ndarray:
        return self.data[..., :2]

    @property
    def conf(self) -> np.ndarray | None:
        return self.data[..., 2] if self.data.shape[-1] == 3 else None


class OBB:
    """Oriented boxes: (n, 7) rows [cx, cy, w, h, angle (rad), conf, cls] in
    original-image pixels (reference results.py:131-177)."""

    def __init__(self, data: np.ndarray, orig_shape: tuple[int, int]):
        self.data = np.asarray(data, np.float32).reshape(-1, 7)
        self.orig_shape = orig_shape

    def __len__(self) -> int:
        return len(self.data)

    def __getitem__(self, i) -> "OBB":
        return OBB(self.data[i], self.orig_shape)

    @property
    def xywhr(self) -> np.ndarray:
        return self.data[:, :5]

    @property
    def conf(self) -> np.ndarray:
        return self.data[:, 5]

    @property
    def cls(self) -> np.ndarray:
        return self.data[:, 6]

    @property
    def xyxyxyxy(self) -> np.ndarray:
        """(n, 4, 2) corner polygons."""
        return xywhr2xyxyxyxy(self.data[:, :5]) if len(self) else np.zeros((0, 4, 2), np.float32)

    @property
    def xyxy(self) -> np.ndarray:
        """The axis-aligned hull of each rotated box."""
        p = self.xyxyxyxy
        return np.concatenate([p.min(1), p.max(1)], -1)


class Probs:
    """Class probabilities of one image (reference results.py:107-127)."""

    def __init__(self, data: np.ndarray):
        self.data = np.asarray(data, np.float32).reshape(-1)

    @property
    def top1(self) -> int:
        return int(self.data.argmax())

    @property
    def top5(self) -> list[int]:
        return np.argsort(-self.data)[:5].tolist()

    @property
    def top1conf(self) -> float:
        return float(self.data.max())

    @property
    def top5conf(self) -> np.ndarray:
        return self.data[self.top5]


class Results:
    """One image's predictions: ``boxes``, and ``masks`` (segment),
    ``keypoints`` (pose), ``obb`` (whose axis-aligned hulls are ``boxes``)
    or ``probs`` (classify, whose ``boxes`` are empty)."""

    def __init__(self, orig_img: np.ndarray, path: str, names: dict[int, str],
                 boxes: np.ndarray | None = None, masks: np.ndarray | None = None,
                 keypoints: np.ndarray | None = None, obb: np.ndarray | None = None,
                 probs: np.ndarray | None = None, speed: dict | None = None):
        self.orig_img = orig_img
        self.orig_shape = orig_img.shape[:2]
        self.path = path
        self.names = names
        self.obb = OBB(obb, self.orig_shape) if obb is not None else None
        if boxes is None and self.obb is not None:
            boxes = np.concatenate([self.obb.xyxy, self.obb.conf[:, None], self.obb.cls[:, None]], 1)
        self.boxes = Boxes(boxes if boxes is not None else np.zeros((0, 6)), self.orig_shape)
        self.masks = Masks(masks, self.orig_shape) if masks is not None else None
        self.keypoints = Keypoints(keypoints, self.orig_shape) if keypoints is not None else None
        self.probs = Probs(probs) if probs is not None else None
        self.speed = speed or {"preprocess": 0.0, "inference": 0.0, "postprocess": 0.0}

    def __len__(self) -> int:
        return len(self.obb) if self.obb is not None else len(self.boxes)

    def __repr__(self) -> str:
        return f"Results(path={self.path!r}, n={len(self)}, shape={self.orig_shape})"

    def __getitem__(self, idx) -> "Results":
        """The detections ``idx`` selects (an index, slice, index array or
        boolean mask), with their masks, keypoints and oriented boxes."""
        sel = np.atleast_1d(np.arange(len(self))[idx])

        def pick(c):
            return None if c is None else c.data[sel]

        return Results(self.orig_img, self.path, self.names, boxes=pick(self.boxes) if self.obb is None else None,
                       masks=pick(self.masks), keypoints=pick(self.keypoints), obb=pick(self.obb),
                       probs=None if self.probs is None else self.probs.data, speed=self.speed)

    def verbose(self) -> str:
        """Per-image log string, e.g. '2 persons, 1 bus, ', or the top-5
        classes with their probabilities, e.g. 'cat 0.81, dog 0.10, ...'."""
        if self.probs is not None:
            return ", ".join(f"{self.names.get(i, str(i))} {self.probs.data[i]:.2f}" for i in self.probs.top5)
        if len(self) == 0:
            return "(no detections), "
        counts: dict[int, int] = {}
        for c in self.boxes.cls.astype(int):
            counts[c] = counts.get(c, 0) + 1
        return "".join(f"{n} {self.names.get(c, str(c))}{'s' if n > 1 else ''}, "
                       for c, n in sorted(counts.items()))

    def summary(self, normalize: bool = False, decimals: int = 5) -> list[dict]:
        """Per-detection dicts with keypoints when present (reference
        Results.summary; a classify result has no detections, so its list is
        empty, as the reference's); the segments of masks need their
        outlines, which are not ported yet."""
        if self.masks is not None:
            raise NotImplementedError(NOT_PORTED)
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
        if self.keypoints is not None:
            for item, kp in zip(out, self.keypoints.data):
                item["keypoints"] = {
                    "x": [round(float(v) / w, decimals) for v in kp[:, 0]],
                    "y": [round(float(v) / h, decimals) for v in kp[:, 1]],
                    "visible": [round(float(v), decimals) for v in (kp[:, 2] if kp.shape[1] > 2 else np.ones(len(kp)))],
                }
        return out

    def to_json(self) -> str:
        return json.dumps(self.summary(), indent=2)
