"""Result containers, host-side numpy (reference
``fce_yolo_tpu/engine/results.py``): boxes, and for the task heads masks,
keypoints, oriented boxes and class probabilities, with the reference's
drawing and saving (``plot``, ``save``, ``save_txt``, ``save_crop``). Mask
outlines come from ``ops/contours.py`` (cv2.findContours in the reference),
drawing from ``utils/draw.py`` and image files from ``utils/patches.py``,
whose JPEG writer runs its forward DCT on the result's ``device``."""

from __future__ import annotations

import json
from pathlib import Path

import numpy as np

from fce_yolo_tpu_torch.ops.geometry import xywhr2xyxyxyxy

__all__ = ["Boxes", "Masks", "Keypoints", "OBB", "Probs", "Results"]


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
    """Per-detection binary masks (n, H, W) in original-image pixels (reference
    results.py:64-84); their outlines are traced on ``device`` (``ops/contours.py``)."""

    def __init__(self, data: np.ndarray, orig_shape: tuple[int, int], device="cuda"):
        self.data = np.asarray(data, bool)
        self.orig_shape = orig_shape
        self.device = device

    def __len__(self) -> int:
        return len(self.data)

    @property
    def xy(self) -> list[np.ndarray]:
        """Each mask's outline as float32 (n, 2) pixel points: its outer
        contour of the largest area (the first of equals), (0, 2) when empty."""
        from fce_yolo_tpu_torch.ops.contours import contour_area, find_contours_external

        out = []
        for m in self.data:
            cnts = find_contours_external(m, self.device)
            out.append(max(cnts, key=contour_area).reshape(-1, 2).astype(np.float32) if cnts
                       else np.zeros((0, 2), np.float32))
        return out


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
                 probs: np.ndarray | None = None, speed: dict | None = None, device="cuda"):
        self.orig_img = orig_img
        self.device = device  # where the outline walk (masks) and the JPEG writer's DCT (save, save_crop) run
        self.orig_shape = orig_img.shape[:2]
        self.path = path
        self.names = names
        self.obb = OBB(obb, self.orig_shape) if obb is not None else None
        if boxes is None and self.obb is not None:
            boxes = np.concatenate([self.obb.xyxy, self.obb.conf[:, None], self.obb.cls[:, None]], 1)
        self.boxes = Boxes(boxes if boxes is not None else np.zeros((0, 6)), self.orig_shape)
        self.masks = Masks(masks, self.orig_shape, device) if masks is not None else None
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
                       probs=None if self.probs is None else self.probs.data, speed=self.speed, device=self.device)

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
        """Per-detection dicts with segments and keypoints when present
        (reference Results.summary; a classify result has no detections, so
        its list is empty, as the reference's). A mask's segment is all its
        outlines spliced into one (``masks2segments``), normalised by the mask's size."""
        h, w = self.orig_shape if normalize else (1, 1)
        seg_xy = None
        if self.masks is not None:
            from fce_yolo_tpu_torch.ops.geometry import masks2segments

            seg_xy = masks2segments(self.masks.data.astype(np.uint8), device=self.device)
        out = []
        for i, row in enumerate(self.boxes.data):
            c = int(row[5])
            item = {
                "name": self.names.get(c, str(c)),
                "class": c,
                "confidence": round(float(row[4]), decimals),
                "box": {k: round(float(v) / (w if k in ("x1", "x2") else h), decimals)
                        for k, v in zip(("x1", "y1", "x2", "y2"), row[:4])},
            }
            if seg_xy is not None and i < len(seg_xy) and len(seg_xy[i]):
                mh, mw = self.masks.data.shape[1:3]
                sx, sy = (mw, mh) if normalize else (1, 1)
                item["segments"] = {"x": [round(float(v) / sx, decimals) for v in seg_xy[i][:, 0]],
                                    "y": [round(float(v) / sy, decimals) for v in seg_xy[i][:, 1]]}
            if self.keypoints is not None and i < len(self.keypoints.data):
                kp = self.keypoints.data[i]
                item["keypoints"] = {
                    "x": [round(float(v) / w, decimals) for v in kp[:, 0]],
                    "y": [round(float(v) / h, decimals) for v in kp[:, 1]],
                    "visible": [round(float(v), decimals) for v in (kp[:, 2] if kp.shape[1] > 2 else np.ones(len(kp)))],
                }
            out.append(item)
        return out

    def to_json(self) -> str:
        return json.dumps(self.summary(), indent=2)

    def plot(self, line_width: int | None = None, font_scale: float = 0.5) -> np.ndarray:
        """Boxes (or oriented boxes) with labels, masks blended at 0.4 and
        keypoints, drawn on a copy of the image (reference Results.plot)."""
        from fce_yolo_tpu_torch.utils import draw

        img = self.orig_img.copy()
        lw = line_width or max(round(sum(self.orig_shape) / 2 * 0.003), 2)
        if self.masks is not None:
            overlay = img.copy()
            for m, row in zip(self.masks.data, self.boxes.data):
                overlay[m] = _class_color(int(row[5]))
            img = draw.add_weighted(img, 0.6, overlay, 0.4, 0)
        if self.keypoints is not None:
            for kpts in self.keypoints.data:
                for kp in kpts:
                    if kp.shape[-1] < 3 or kp[2] > 0.5:
                        draw.circle(img, (int(kp[0]), int(kp[1])), max(lw, 2), (0, 255, 0), -1)
        if self.obb is not None:
            for poly, row in zip(self.obb.xyxyxyxy, self.obb.data):
                c = int(row[6])
                color = _class_color(c)
                draw.polylines(img, [poly.astype(np.int32)], True, color, lw)
                x1, y1 = poly.min(0)
                draw.put_text(img, f"{self.names.get(c, c)} {row[5]:.2f}", (int(x1), int(y1) - 2),
                              draw.FONT_HERSHEY_SIMPLEX, font_scale, color, 1)
            return img
        for row in self.boxes.data:
            x1, y1, x2, y2, conf, c = row
            c = int(c)
            color = _class_color(c)
            draw.rectangle(img, (int(x1), int(y1)), (int(x2), int(y2)), color, lw)
            label = f"{self.names.get(c, c)} {conf:.2f}"
            (tw, th), _ = draw.get_text_size(label, draw.FONT_HERSHEY_SIMPLEX, font_scale, 1)
            draw.rectangle(img, (int(x1), int(y1) - th - 4), (int(x1) + tw, int(y1)), color, -1)
            draw.put_text(img, label, (int(x1), int(y1) - 2), draw.FONT_HERSHEY_SIMPLEX, font_scale, (255, 255, 255), 1)
        return img

    def save(self, filename: str) -> str:
        """Write ``plot()`` to ``filename`` (JPEG or PNG by its suffix)."""
        from fce_yolo_tpu_torch.utils.patches import imwrite

        imwrite(filename, self.plot(), device=self.device)
        return filename

    def save_txt(self, txt_file: str, save_conf: bool = False) -> str:
        """One ``cls cx cy w h [conf]`` normalised row a detection; oriented
        boxes write ``cls x1 y1 ... x4 y4 [conf]`` corner rows."""
        lines = []
        if self.obb is not None:
            h, w = self.orig_shape
            norm = np.array([w, h] * 4, np.float32)
            rows = [(int(row[6]), poly.reshape(8) / norm, row[5]) for poly, row in zip(self.obb.xyxyxyxy, self.obb.data)]
        else:
            rows = [(int(row[5]), xywhn, row[4]) for xywhn, row in zip(self.boxes.xywhn, self.boxes.data)]
        for c, coords, conf in rows:
            vals = [*coords, conf] if save_conf else list(coords)
            lines.append(" ".join([str(c), *(f"{v:.6g}" for v in vals)]))
        Path(txt_file).parent.mkdir(parents=True, exist_ok=True)
        Path(txt_file).write_text("\n".join(lines) + ("\n" if lines else ""))
        return txt_file

    def save_crop(self, save_dir: str, file_name: str = "im.jpg") -> None:
        """One crop a detection under ``save_dir/<class name>/<stem><i><suffix>``
        (``save_one_box``, gain 1.02, pad 10)."""
        from fce_yolo_tpu_torch.utils.annotator import save_one_box

        stem, suffix = Path(file_name).stem, Path(file_name).suffix or ".jpg"
        for i, row in enumerate(self.boxes.data):
            name = self.names.get(int(row[5]), str(int(row[5])))
            save_one_box(row[:4], self.orig_img, file=Path(save_dir) / name / f"{stem}{i}{suffix}", square=False,
                         device=self.device)


def _class_color(c: int) -> tuple[int, int, int]:
    """The class's BGR colour, the reference's: ``RandomState(c + 7)``."""
    rng = np.random.RandomState(c + 7)
    return tuple(int(v) for v in rng.randint(64, 255, 3))
