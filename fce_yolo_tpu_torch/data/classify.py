"""Classification data (reference ``fce_yolo_tpu/data/classify.py``): a
class-folder tree, ``root/<class name>/*.jpg``, class ids in the sorted
folder order.

Train items: a random resized crop (area 0.08-1.0 of the image, aspect
3/4-4/3, ten tries, else the whole image), resized to ``imgsz`` x
``imgsz``, a left-right flip with ``fliplr``, a brightness gain of
1 +- ``hsv_v``; val items: ``val_transform``. Both resizes are
``data/augment.py::resize_linear`` (cv2's INTER_LINEAR, bit-equal), so an
item equals the reference's for the same seed and epoch. Images come out
RGB. JPEGs decode on ``device``.
"""

from __future__ import annotations

from pathlib import Path

import numpy as np

from fce_yolo_tpu_torch.data.augment import resize_linear
from fce_yolo_tpu_torch.data.dataset import IMG_FORMATS
from fce_yolo_tpu_torch.data.imread import imread

__all__ = ["ClassificationDataset", "val_transform", "classify_collate"]


class ClassificationDataset:
    """Items ``{"img": (imgsz, imgsz, 3) uint8 RGB, "label": int}``. The
    train augment draws from one generator in item order, reseeded by
    ``set_epoch`` from ``hash((epoch, len))`` (the reference's rule: ``seed``
    only seeds epoch 0)."""

    def __init__(self, root: str | Path, imgsz: int = 224, mode: str = "train", seed: int = 0,
                 fliplr: float = 0.5, hsv_v: float = 0.4, scale: tuple[float, float] = (0.08, 1.0),
                 device="cuda"):
        self.root = Path(root)
        self.imgsz = imgsz
        self.mode = mode
        self.fliplr = fliplr
        self.hsv_v = hsv_v
        self.scale = scale
        self.device = device
        classes = sorted(p.name for p in self.root.iterdir() if p.is_dir()) if self.root.is_dir() else []
        if not classes:
            raise FileNotFoundError(f"no class folders under {root}")
        self.names = dict(enumerate(classes))
        self.samples: list[tuple[str, int]] = []
        for ci, cname in enumerate(classes):
            for f in sorted((self.root / cname).rglob("*")):
                if f.suffix[1:].lower() in IMG_FORMATS:
                    self.samples.append((str(f), ci))
        self._rng = np.random.default_rng(seed)

    def __len__(self) -> int:
        return len(self.samples)

    def set_epoch(self, epoch: int) -> None:
        self._rng = np.random.default_rng(hash((epoch, len(self))) & 0x7FFFFFFF)

    def __getitem__(self, i: int) -> dict:
        path, label = self.samples[i]
        img = imread(path, self.device)
        s = self.imgsz
        if self.mode == "train":
            h, w = img.shape[:2]
            area = h * w
            for _ in range(10):
                target = self._rng.uniform(*self.scale) * area
                ar = self._rng.uniform(3 / 4, 4 / 3)
                cw = int(round(np.sqrt(target * ar)))
                ch = int(round(np.sqrt(target / ar)))
                if cw <= w and ch <= h:
                    x0 = int(self._rng.integers(0, w - cw + 1))
                    y0 = int(self._rng.integers(0, h - ch + 1))
                    img = img[y0: y0 + ch, x0: x0 + cw]
                    break
            img = resize_linear(np.ascontiguousarray(img), (s, s))
            if self.fliplr and self._rng.random() < self.fliplr:
                img = np.fliplr(img)
            if self.hsv_v:
                gain = 1 + self._rng.uniform(-1, 1) * self.hsv_v
                img = np.clip(img.astype(np.float32) * gain, 0, 255).astype(np.uint8)
        else:
            img = val_transform(img, s)
        return {"img": np.ascontiguousarray(img[..., ::-1]), "label": label}  # BGR -> RGB


def val_transform(img: np.ndarray, s: int) -> np.ndarray:
    """The shorter side resized to ``s`` (cv2's INTER_LINEAR), then the
    centre ``s`` x ``s`` crop (reference ``val_transform``); the channels are
    left as they are."""
    h, w = img.shape[:2]
    r = s / min(h, w)
    img = resize_linear(img, (max(s, int(round(w * r))), max(s, int(round(h * r)))))
    hh, ww = img.shape[:2]
    y0, x0 = (hh - s) // 2, (ww - s) // 2
    return img[y0: y0 + s, x0: x0 + s]


def classify_collate(samples: list[dict]) -> dict:
    return {"img": np.stack([x["img"] for x in samples], 0),
            "label": np.asarray([x["label"] for x in samples], np.int32)}

