"""YOLO-format detection dataset (reference ``fce_yolo_tpu/data/dataset.py:32-529``).

- ``check_det_dataset`` takes a data YAML path, a dataset name of the
  port's registry (``cfg/datasets/``: byte-equal copies of the JAX
  package's detect dataset YAMLs) or a dict. The YAML is read by
  ``utils/yaml_read.py``, so no pyyaml is needed; only ``path``, ``train``,
  ``val``, ``test``, ``nc``, ``names``, and for pose ``kpt_shape`` and
  ``flip_idx``, are kept, and ``download`` is
  read only to name the data's source when it is missing. Nothing is ever
  downloaded.
- ``YOLODataset`` parses the labels at construction, every time: the JAX
  package's ``.labels_*.npz`` cache is neither written nor read. Images are
  read by ``data/imread.py`` (baseline JPEG on the dataset's ``device``,
  PNG or ``.npy`` on the host), augmented (train) or
  letterboxed (val) in BGR without cv2 (``data/augment.py``) and leave as
  RGB.
- Train mode draws its augment from the dataset's generator, or from one a
  caller passes per item (the loader gives each item its own).
- ``collate`` pads labels to a fixed count per image, as the JAX batches do.

Labels live in the sibling ``labels/`` tree, one ``.txt`` per image, one
row per object, normalized to the image: ``cls cx cy w h`` (detect),
``cls x1 y1 x2 y2 ...`` (a segment polygon; its extent is the box),
``cls cx cy w h`` and ``nk`` keypoints of ``x y [v]`` (pose), or
``cls x1 y1 ... x4 y4`` (an OBB's four corners). For the task heads a
batch adds the ground-truth masks, keypoints or rotated boxes
(``collate``); in train mode the polygons (an OBB's corners among them) and
keypoints go through the augment with the boxes.
"""

from __future__ import annotations

import os
from dataclasses import replace
from pathlib import Path

import numpy as np

from fce_yolo_tpu_torch.data.augment import AugmentCfg, train_augment, val_transform
from fce_yolo_tpu_torch.data.imread import imread
from fce_yolo_tpu_torch.ops.geometry import fill_poly, min_area_rect
from fce_yolo_tpu_torch.utils.yaml_read import read_yaml

IMG_FORMATS = {"bmp", "dng", "jpeg", "jpg", "mpo", "png", "tif", "tiff", "webp", "pfm"}
DATA_KEYS = ("path", "train", "val", "test", "nc", "names", "kpt_shape", "flip_idx")
REGISTRY = Path(__file__).resolve().parent.parent / "cfg" / "datasets"
DATASETS_DIR = "datasets"  # the JAX package's default datasets_dir (utils/settings.py)

__all__ = ["IMG_FORMATS", "read_data_yaml", "resolve_dataset_yaml", "check_det_dataset", "img2label_path",
           "YOLODataset", "collate"]


def read_data_yaml(text: str) -> dict:
    """The top-level ``DATA_KEYS`` of a data YAML; other keys (``download:
    |`` scripts included) are skipped unread."""
    return read_yaml(text, keys=DATA_KEYS)


def _download_source(text: str):
    """A data YAML's ``download`` value, or None; a block scalar (``|`` or
    ``>``), which the reader does not read, is named as such."""
    try:
        return read_yaml(text, keys=("download",)).get("download")
    except ValueError:
        return "the download script in the YAML"


def resolve_dataset_yaml(dataset: str | Path) -> Path:
    """A data YAML's file (reference ``_resolve_dataset_yaml``,
    dataset.py:38-59): an existing path wins, then ``name`` or ``name.yaml``
    in the port's registry; else FileNotFoundError listing the registry."""
    p = Path(dataset)
    if p.exists():
        return p
    name = p.name if p.suffix in (".yaml", ".yml") else p.name + ".yaml"
    for cand in (REGISTRY / name, REGISTRY / name.replace(".yml", ".yaml")):
        if cand.exists():
            return cand
    known = ", ".join(h.stem for h in sorted(REGISTRY.glob("*.yaml")))
    raise FileNotFoundError(f"dataset '{dataset}' not found as a file and not in the packaged registry ({known})")


# ------------------------------------------------------------------- dataset
def check_det_dataset(dataset: str | Path | dict) -> dict:
    """Load and normalise a data YAML path, registry name or dict (reference
    ``dataset.py:62-109``): returns it with ``names`` as {int: str}, ``nc``,
    and absolute ``path`` and split paths. A relative ``path`` resolves next
    to the YAML (the working directory for a dict) if it exists there, else
    under ``$FY_DATASETS_DIR`` (default ``datasets`` in the working
    directory). A missing split path raises with the path to fill and the
    YAML's ``download`` source; nothing is downloaded."""
    if isinstance(dataset, (str, Path)):
        path = resolve_dataset_yaml(dataset)
        text = path.read_text()
        d, yaml_dir = read_data_yaml(text), path.resolve().parent
    else:
        d, yaml_dir, text = dict(dataset), Path.cwd(), None

    names = d.get("names")
    if isinstance(names, list):
        names = dict(enumerate(names))
    elif names is None and "nc" in d:
        names = {i: f"class_{i}" for i in range(d["nc"])}
    d["names"] = {int(k): str(v) for k, v in names.items()}
    d["nc"] = len(d["names"])

    root = Path(d.get("path") or ".").expanduser()
    if not root.is_absolute():
        local = (yaml_dir / root).resolve()
        if local.exists():
            root = local
        else:
            base = Path(os.environ.get("FY_DATASETS_DIR", DATASETS_DIR)).expanduser()
            root = (base if base.is_absolute() else Path.cwd() / base) / root
    d["path"] = str(root)
    for split in ("train", "val", "test"):
        if d.get(split):
            v = d[split]
            vv = [v] if isinstance(v, str) else list(v)
            resolved = [str(p if os.path.isabs(p) else root / p) for p in vv]
            d[split] = resolved[0] if isinstance(v, str) else resolved
            for p in resolved:
                if not os.path.exists(p):
                    src = d.get("download") if text is None else _download_source(text)
                    hint = f" (no auto-download here; original source: {src})" if src else ""
                    raise FileNotFoundError(f"dataset {split} path not found: {p}{hint}")
    return d


def img2label_path(img_path: str) -> str:
    """images/.../x.png -> labels/.../x.txt (reference ``dataset.py:112``)."""
    sa, sb = f"{os.sep}images{os.sep}", f"{os.sep}labels{os.sep}"
    return sb.join(img_path.rsplit(sa, 1)).rsplit(".", 1)[0] + ".txt"


def _scan_images(src: str | list) -> list[str]:
    """Image files of a directory tree (by extension, sorted), a ``.txt``
    list of paths, a single file, or a list of those."""
    files: list[str] = []
    for p in [src] if isinstance(src, str) else src:
        p = Path(p)
        if p.is_dir():
            files += [str(f) for f in sorted(p.rglob("*")) if f.suffix[1:].lower() in IMG_FORMATS]
        elif p.is_file() and p.suffix == ".txt":
            base = p.parent
            for line in p.read_text().splitlines():
                line = line.strip()
                if line:
                    files.append(str((base / line).resolve()) if not os.path.isabs(line) else line)
        elif p.is_file():
            files.append(str(p))
        else:
            raise FileNotFoundError(f"image source not found: {p}")
    return files


def _extent(pts: np.ndarray) -> list:
    """A polygon's axis-aligned extent as normalized (cx, cy, w, h)."""
    lo, hi = pts.min(0), pts.max(0)
    return [(lo[0] + hi[0]) / 2, (lo[1] + hi[1]) / 2, hi[0] - lo[0], hi[1] - lo[1]]


def _read_labels(label_path: str, task: str = "detect", kpt_shape: tuple[int, int] = (17, 3)) -> dict:
    """One label file -> {"cls" (n,), "xywhn" (n, 4)} float32, with
    "segments" (polygons, and an OBB's corners) or "keypoints" ((nk, 3),
    the visibility 1 where the file has none), as the JAX reader parses them
    (reference ``fce_yolo_tpu/data/dataset.py:306-345``: rows longer than
    five numbers are polygons whatever the task). No file: no labels."""
    rows = []
    if os.path.exists(label_path):
        rows = [l.split() for l in Path(label_path).read_text().splitlines() if l.strip()]
    if rows and task == "pose":
        nk, nd = kpt_shape
        cls, xywhn, kpts = [], [], []
        for r in rows:
            vals = np.array(r[1:], np.float32)
            cls.append(float(r[0]))
            xywhn.append(vals[:4])
            k = vals[4: 4 + nk * nd].reshape(nk, nd)
            if nd == 2:
                k = np.concatenate([k, np.ones((nk, 1), np.float32)], 1)
            kpts.append(k)
        return {"cls": np.array(cls, np.float32), "xywhn": np.stack(xywhn), "keypoints": kpts}
    if rows and (task == "obb" or len(rows[0]) > 5):
        cls, xywhn, segs = [], [], []
        for r in rows:
            pts = np.array(r[1:9] if task == "obb" else r[1:], np.float32).reshape(-1, 2)
            cls.append(float(r[0]))
            xywhn.append(_extent(pts))
            segs.append(pts)
        return {"cls": np.array(cls, np.float32), "xywhn": np.array(xywhn, np.float32), "segments": segs}
    arr = np.array(rows, np.float32) if rows else np.zeros((0, 5), np.float32)
    return {"cls": arr[:, 0], "xywhn": arr[:, 1:5]}


class YOLODataset:
    """Detection dataset over a YOLO image/label tree.

    Args:
        img_path: a split from the data YAML (dir, ``.txt`` list, or a list).
        imgsz: output size (the mosaic's or the letterbox's square).
        mode: "train" (mosaic, perspective, HSV, flips) or "val" (letterbox only).
        hyp: the train augment's hyperparameters.
        nc: class count (else 1 + the largest label).
        seed: seeds the generator until the first ``set_epoch``.
        device: where JPEG images decode (``imread``): the card unless
            another is named.
        task: "detect", "segment", "pose" or "obb" (the label format).
        kpt_shape: (keypoints, 2 or 3) of pose labels.
        flip_idx: the keypoints' left-right swap map (the data YAML's);
            a pose dataset without one flips neither way, as the
            reference does.
    """

    def __init__(self, img_path: str | list, imgsz: int = 640, mode: str = "val", hyp: AugmentCfg | None = None,
                 nc: int | None = None, seed: int = 0, device="cuda", task: str = "detect",
                 kpt_shape: tuple[int, int] = (17, 3), flip_idx: list[int] | None = None):
        if mode not in ("train", "val"):
            raise ValueError(f"mode {mode!r}: 'train' or 'val'")
        if task not in ("detect", "segment", "pose", "obb"):
            raise ValueError(f"task {task!r}: 'detect', 'segment', 'pose' or 'obb'")
        self.task = task
        self.kpt_shape = tuple(kpt_shape)
        self.imgsz = imgsz
        self.mode = mode
        self.device = device
        self.hyp = hyp or AugmentCfg()
        self.flip_idx = list(flip_idx) if flip_idx else None
        if task == "pose" and self.flip_idx is None:
            self.hyp = replace(self.hyp, fliplr=0.0, flipud=0.0)
        self.im_files = _scan_images(img_path)
        if not self.im_files:
            raise FileNotFoundError(f"no images found in {img_path}")
        self.labels = [_read_labels(img2label_path(f), task, self.kpt_shape) for f in self.im_files]
        self.nc = nc if nc is not None else int(max((l["cls"].max() for l in self.labels if l["cls"].size), default=0) + 1)
        self.mosaic_enabled = mode == "train"
        self.epoch_seed = seed
        self._rng = np.random.default_rng(seed)

    def __len__(self) -> int:
        return len(self.im_files)

    def set_epoch(self, epoch: int, close_mosaic_at: int | None = None, total_epochs: int | None = None) -> None:
        """Reseed from the epoch, as the reference does (``hash((epoch, len))``:
        the user's seed plays no part), and close the mosaic for the last
        ``close_mosaic_at`` epochs."""
        self.epoch_seed = hash((epoch, len(self))) & 0x7FFFFFFF
        self._rng = np.random.default_rng(self.epoch_seed)
        if close_mosaic_at and total_epochs and epoch >= total_epochs - close_mosaic_at:
            self.mosaic_enabled = False

    def load_raw(self, i: int) -> dict:
        """Image i as read (BGR uint8) with its labels as pixel xyxy, and its
        polygons and keypoints in pixels."""
        img = imread(self.im_files[i], self.device)
        h, w = img.shape[:2]
        lab = self.labels[i]
        xywh = lab["xywhn"] * np.array([w, h, w, h], np.float32)
        boxes = np.empty_like(xywh)
        if len(xywh):
            boxes[:, 0] = xywh[:, 0] - xywh[:, 2] / 2
            boxes[:, 1] = xywh[:, 1] - xywh[:, 3] / 2
            boxes[:, 2] = xywh[:, 0] + xywh[:, 2] / 2
            boxes[:, 3] = xywh[:, 1] + xywh[:, 3] / 2
        out = {"img": img, "cls": lab["cls"].copy(), "bboxes": boxes}
        if "segments" in lab:
            out["segments"] = [seg * np.array([w, h], np.float32) for seg in lab["segments"]]
        if "keypoints" in lab:
            out["keypoints"] = [k * np.array([w, h, 1], np.float32) for k in lab["keypoints"]]
        return out

    def get(self, i: int, rng: np.random.Generator | None = None) -> dict:
        """Item i; a train item draws from ``rng`` (else the dataset's generator)."""
        if self.mode == "train":
            out = train_augment(self.load_raw, i, len(self), self.imgsz, self.hyp,
                                self._rng if rng is None else rng, self.mosaic_enabled, self.flip_idx)
        else:
            out = val_transform(self.load_raw(i), self.imgsz)
        out["img"] = np.ascontiguousarray(out["img"][..., ::-1])  # BGR -> RGB at the exit
        return out

    def __getitem__(self, i: int) -> dict:
        return self.get(i)


MASK_RATIO = 4  # ground-truth masks at the prototypes' resolution (the reference's mask_ratio)


def collate(samples: list[dict], max_labels: int = 128, obb: bool = False) -> dict:
    """Stack samples into one fixed-shape batch: img (B, S, S, 3) uint8 NHWC,
    cls (B, M), bboxes (B, M, 4) xywh normalized by the image size, mask
    (B, M) bool, and the val extras ratio (B,), pad (B, 2), orig_shape (B, 2).
    Labels past ``max_labels`` in an image are dropped. With the task heads'
    labels (reference ``fce_yolo_tpu/data/dataset.py:438-530``):

    - polygons (not ``obb``): ``masks`` (B, M, S/4, S/4) float32, each
      polygon's rounded vertices filled as ``cv2.fillPoly`` fills them
      (``ops/geometry.py::fill_poly``; fewer than 3 points: no fill), then
      the overlap rule: every pixel goes to the smallest instance covering
      it (area-descending ``np.argsort(-areas)``, a 1-based index plane);
    - keypoints: ``keypoints`` (B, M, nk, 3), x and y normalized;
    - ``obb``: ``bboxes`` (B, M, 5) normalized xywhr from each four-corner
      polygon's minimum-area rectangle (``min_area_rect``), w >= h and the
      angle in [-pi/4, 3pi/4);
    - the open-vocabulary datasets' (``data/multimodal.py``): ``txt_feats``
      (B, max_samples, 512) float32 and ``visual_prompts`` (B, nc, S/8, S/8).
    """
    b = len(samples)
    sh, sw = samples[0]["img"].shape[:2]
    img = np.stack([x["img"] for x in samples], 0)
    cls = np.zeros((b, max_labels), np.float32)
    bboxes = np.zeros((b, max_labels, 4), np.float32)
    mask = np.zeros((b, max_labels), bool)
    has_segments = any("segments" in x for x in samples) and not obb
    has_kpts = any("keypoints" in x for x in samples)
    nk = max((len(x["keypoints"][0]) for x in samples if x.get("keypoints")), default=17) if has_kpts else 0
    smh, smw = sh // MASK_RATIO, sw // MASK_RATIO
    seg_masks = np.zeros((b, max_labels, smh, smw), np.float32) if has_segments else None
    kpts_arr = np.zeros((b, max_labels, nk, 3), np.float32) if has_kpts else None
    rboxes = np.zeros((b, max_labels, 5), np.float32) if obb else None
    for i, x in enumerate(samples):
        n = min(len(x["cls"]), max_labels)
        if n:
            cls[i, :n] = x["cls"][:n]
            xyxy = x["bboxes"][:n]
            h, w = x["img"].shape[:2]
            cx = (xyxy[:, 0] + xyxy[:, 2]) / 2 / w
            cy = (xyxy[:, 1] + xyxy[:, 3]) / 2 / h
            bw = (xyxy[:, 2] - xyxy[:, 0]) / w
            bh = (xyxy[:, 3] - xyxy[:, 1]) / h
            bboxes[i, :n] = np.stack([cx, cy, bw, bh], 1)
            mask[i, :n] = True
            if has_segments and "segments" in x:
                scale = np.array([smw / w, smh / h], np.float32)
                for j, seg in enumerate(x["segments"][:n]):
                    pts = np.round(seg * scale).astype(np.int32)
                    if len(pts) >= 3:
                        fill_poly(seg_masks[i, j], [pts], 1.0)
            if has_kpts and "keypoints" in x:
                norm = np.array([1.0 / w, 1.0 / h, 1.0], np.float32)
                for j, kp in enumerate(x["keypoints"][:n]):
                    kpts_arr[i, j] = kp * norm
            if obb and "segments" in x:
                for j, seg in enumerate(x["segments"][:n]):
                    (rcx, rcy), (rw, rh), ang = min_area_rect(seg.astype(np.float32))
                    theta = np.deg2rad(ang)
                    if rw < rh:  # the long side is w
                        rw, rh = rh, rw
                        theta += np.pi / 2
                    theta = (theta + np.pi / 4) % np.pi - np.pi / 4
                    rboxes[i, j] = [rcx / w, rcy / h, rw / w, rh / h, theta]
    if seg_masks is not None:
        for inst in seg_masks:  # (M, h, w) of one image: each pixel to the smallest instance on it
            areas = inst.reshape(inst.shape[0], -1).sum(1)
            plane = np.zeros(inst.shape[1:], np.int32)
            for j in np.argsort(-areas):
                if areas[j] > 0:
                    plane[inst[j] > 0.5] = j + 1
            for j in np.flatnonzero(areas > 0):
                inst[j] = (plane == j + 1).astype(np.float32)
    out = {"img": img, "cls": cls, "bboxes": bboxes if rboxes is None else rboxes, "mask": mask}
    if seg_masks is not None:
        out["masks"] = seg_masks
    if kpts_arr is not None:
        out["keypoints"] = kpts_arr
    if "txt_feats" in samples[0]:
        out["txt_feats"] = np.stack([x["txt_feats"] for x in samples], 0).astype(np.float32)
    if "visual_prompts" in samples[0]:
        out["visual_prompts"] = np.stack([x["visual_prompts"] for x in samples], 0)
    if "ratio" in samples[0]:
        out["ratio"] = np.array([x["ratio"] for x in samples], np.float32)
        out["pad"] = np.array([x["pad"] for x in samples], np.float32)
        out["orig_shape"] = np.array([x["orig_shape"] for x in samples], np.int32)
    return out
