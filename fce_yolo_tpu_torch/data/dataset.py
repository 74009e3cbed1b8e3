"""YOLO-format detection dataset (reference ``fce_yolo_tpu/data/dataset.py:32-529``).

- ``check_det_dataset`` takes a data YAML path, a dataset name of the
  port's registry (``cfg/datasets/``: byte-equal copies of the JAX
  package's detect dataset YAMLs) or a dict. The YAML is read by
  ``utils/yaml_read.py``, so no pyyaml is needed; only ``path``, ``train``,
  ``val``, ``test``, ``nc`` and ``names`` are kept, and ``download`` is
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
``cls cx cy w h`` row (normalized xywh) per object.
"""

from __future__ import annotations

import os
from pathlib import Path

import numpy as np

from fce_yolo_tpu_torch.data.augment import AugmentCfg, train_augment, val_transform
from fce_yolo_tpu_torch.data.imread import imread
from fce_yolo_tpu_torch.utils.yaml_read import read_yaml

IMG_FORMATS = {"bmp", "dng", "jpeg", "jpg", "mpo", "png", "tif", "tiff", "webp", "pfm"}
DATA_KEYS = ("path", "train", "val", "test", "nc", "names")
REGISTRY = Path(__file__).resolve().parent.parent / "cfg" / "datasets"
DATASETS_DIR = "datasets"  # the JAX package's default datasets_dir (utils/settings.py)

__all__ = ["IMG_FORMATS", "read_data_yaml", "resolve_dataset_yaml", "check_det_dataset", "img2label_path",
           "YOLODataset", "collate"]


def read_data_yaml(text: str) -> dict:
    """The top-level ``path``, ``train``, ``val``, ``test``, ``nc`` and
    ``names`` of a data YAML; other keys (``download: |`` scripts included)
    are skipped unread."""
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


def _read_labels(label_path: str) -> dict:
    """One label file -> {"cls" (n,), "xywhn" (n, 4)} float32; none if absent."""
    rows = []
    if os.path.exists(label_path):
        rows = [l.split() for l in Path(label_path).read_text().splitlines() if l.strip()]
    if any(len(r) != 5 for r in rows):
        raise ValueError(f"{label_path}: a detect label row is 'cls cx cy w h'; segment, pose and "
                         "OBB labels are not read by the port yet")
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
    """

    def __init__(self, img_path: str | list, imgsz: int = 640, mode: str = "val", hyp: AugmentCfg | None = None,
                 nc: int | None = None, seed: int = 0, device="cuda"):
        if mode not in ("train", "val"):
            raise ValueError(f"mode {mode!r}: 'train' or 'val'")
        self.imgsz = imgsz
        self.mode = mode
        self.device = device
        self.hyp = hyp or AugmentCfg()
        self.im_files = _scan_images(img_path)
        if not self.im_files:
            raise FileNotFoundError(f"no images found in {img_path}")
        self.labels = [_read_labels(img2label_path(f)) for f in self.im_files]
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
        """Image i as read (BGR uint8) with its labels as pixel xyxy."""
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
        return {"img": img, "cls": lab["cls"].copy(), "bboxes": boxes}

    def get(self, i: int, rng: np.random.Generator | None = None) -> dict:
        """Item i; a train item draws from ``rng`` (else the dataset's generator)."""
        if self.mode == "train":
            out = train_augment(self.load_raw, i, len(self), self.imgsz, self.hyp,
                                self._rng if rng is None else rng, self.mosaic_enabled)
        else:
            out = val_transform(self.load_raw(i), self.imgsz)
        out["img"] = np.ascontiguousarray(out["img"][..., ::-1])  # BGR -> RGB at the exit
        return out

    def __getitem__(self, i: int) -> dict:
        return self.get(i)


def collate(samples: list[dict], max_labels: int = 128) -> dict:
    """Stack samples into one fixed-shape batch: img (B, S, S, 3) uint8 NHWC,
    cls (B, M), bboxes (B, M, 4) xywh normalized by the image size, mask
    (B, M) bool, and the val extras ratio (B,), pad (B, 2), orig_shape (B, 2).
    Labels past ``max_labels`` in an image are dropped."""
    b = len(samples)
    img = np.stack([x["img"] for x in samples], 0)
    cls = np.zeros((b, max_labels), np.float32)
    bboxes = np.zeros((b, max_labels, 4), np.float32)
    mask = np.zeros((b, max_labels), bool)
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
    out = {"img": img, "cls": cls, "bboxes": bboxes, "mask": mask}
    if "ratio" in samples[0]:
        out["ratio"] = np.array([x["ratio"] for x in samples], np.float32)
        out["pad"] = np.array([x["pad"] for x in samples], np.float32)
        out["orig_shape"] = np.array([x["orig_shape"] for x in samples], np.int32)
    return out
