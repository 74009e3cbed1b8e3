"""Open-vocabulary datasets for YOLO-World and YOLOE training (reference
``fce_yolo_tpu/data/multimodal.py``):

- ``random_load_text``: Ultralytics' ``RandomLoadText`` (augment.py:2252) on
  one sample, the same draws from the same ``numpy`` Generator as the JAX one;
- ``YOLOMultiModalDataset``: YOLO labels + per-sample class texts;
- ``GroundingDataset``: boxes grounded in caption spans of a COCO-style JSON
  (``tokens_positive``), the classes being each image's phrases;
- ``YOLOVisualPromptDataset``: the ground truth's per-class P3 masks;
- ``YOLOConcatDataset``: a concatenation with the collate contract.

Each sample carries ``txt_feats`` (max_samples, 512): hash-encoded
(``nn/text_model.py``), one static (B, M, 512) tensor a batch. A train item
draws its texts after its augment from the same generator: the dataset's
own, or the one the loader hands ``get`` for item j of the epoch.
"""

from __future__ import annotations

import json
from collections import defaultdict
from dataclasses import replace
from pathlib import Path

import numpy as np

from fce_yolo_tpu_torch.data.dataset import YOLODataset

__all__ = ["random_load_text", "YOLOMultiModalDataset", "GroundingDataset", "YOLOConcatDataset",
           "YOLOVisualPromptDataset", "texts_flat"]


def random_load_text(sample: dict, class_texts: list[list[str]], rng: np.random.Generator, max_samples: int = 80,
                     neg_samples: tuple[int, int] = (80, 100), padding: bool = True,
                     padding_pool: list[str] | None = None, prompt_format: str = "{}") -> dict:
    """Sample positive and negative class texts for one sample and remap its
    classes (RandomLoadText semantics): up to ``max_samples`` positive
    classes, random negatives from the rest, instances of unsampled classes
    dropped, ``cls`` remapped to positions in the sampled list, one synonym a
    class, padded to ``max_samples`` from ``padding_pool``. Mutates and
    returns ``sample`` (cls, bboxes, segments, keypoints) with ``texts``."""
    nc = len(class_texts)
    cls = np.asarray(sample["cls"]).astype(int).reshape(-1)
    pos = np.unique(cls).tolist()
    if len(pos) > max_samples:
        pos = rng.permutation(pos)[:max_samples].tolist()

    n_neg = int(rng.integers(neg_samples[0], neg_samples[1] + 1))
    n_neg = min(min(nc, max_samples) - len(pos), n_neg)
    neg_pool = [i for i in range(nc) if i not in pos]
    neg = rng.permutation(neg_pool)[:max(n_neg, 0)].tolist()

    sampled = pos + neg
    new_id = {c: i for i, c in enumerate(sampled)}
    valid = np.array([c in new_id for c in cls.tolist()], bool)
    sample["cls"] = np.array([new_id[c] for c in cls[valid].tolist()], np.float32)
    sample["bboxes"] = np.asarray(sample["bboxes"])[valid]
    for k in ("segments", "keypoints"):
        if k in sample:
            v = sample[k]
            sample[k] = [x for x, ok in zip(v, valid) if ok] if isinstance(v, list) else np.asarray(v)[valid]

    texts = [prompt_format.format(class_texts[c][rng.integers(len(class_texts[c]))]) for c in sampled]
    if padding:
        pool = padding_pool or [""]
        texts += [pool[int(rng.integers(len(pool)))] for _ in range(max_samples - len(texts))]
        assert len(texts) == max_samples
    sample["texts"] = texts
    return sample


class _TextEncodingMixin:
    """Synonym vocab statistics, the negative pool and the memoized hash
    encoding of each sample's texts."""

    def _init_text(self, class_texts: list[list[str]], max_samples: int, neg_samples: tuple[int, int],
                   prompt_format: str, text_dim: int):
        from fce_yolo_tpu_torch.nn.text_model import build_text_model

        self.class_texts = class_texts
        self.max_samples = max_samples
        self.neg_samples = neg_samples
        self.prompt_format = prompt_format
        self._encoder = build_text_model(f"hash:{text_dim}")
        self._emb_cache: dict[str, np.ndarray] = {}
        self._neg_pool = self._get_neg_texts(self.category_freq)

    @property
    def category_names(self) -> set[str]:
        """Unique category names, '/'-separated synonyms included."""
        return {t.strip() for text in self.class_texts for t in text}

    @property
    def category_freq(self) -> dict[str, int]:
        """Instances a category name over the whole dataset."""
        freq: dict[str, int] = defaultdict(int)
        for lbl, texts in self._iter_label_texts():
            for c in np.asarray(lbl["cls"]).reshape(-1).astype(int):
                for t in texts[c]:
                    freq[t.strip()] += 1
        return dict(freq)

    @staticmethod
    def _get_neg_texts(category_freq: dict[str, int], threshold: int = 100) -> list[str]:
        """The frequent categories' names, the padding negatives (reference
        ``_get_neg_texts``); the threshold clamps to the most frequent class
        so a small dataset still gives a pool."""
        if not category_freq:
            return [""]
        threshold = min(max(category_freq.values()), threshold)
        return [k for k, v in category_freq.items() if v >= threshold] or [""]

    def _encode_texts(self, texts: list[str]) -> np.ndarray:
        """(M,) strings -> (M, D) float32, memoized a string."""
        missing = [t for t in dict.fromkeys(texts) if t not in self._emb_cache]
        if missing:
            for t, e in zip(missing, self._encoder.encode_text(self._encoder.tokenize(missing))):
                self._emb_cache[t] = e
        return np.stack([self._emb_cache[t] for t in texts], 0)

    def _finalize_text_sample(self, s: dict, per_image_texts: list[list[str]], rng: np.random.Generator) -> dict:
        if self.mode == "train":
            s = random_load_text(s, per_image_texts, rng, max_samples=self.max_samples, neg_samples=self.neg_samples,
                                 padding=True, padding_pool=self._neg_pool, prompt_format=self.prompt_format)
        else:  # val: the fixed class list, padded to the static M
            texts = [self.prompt_format.format(t[0]) for t in per_image_texts]
            texts += [""] * (self.max_samples - len(texts))
            s["texts"] = texts[: self.max_samples]
        s["txt_feats"] = self._encode_texts(s["texts"])
        return s


class YOLOMultiModalDataset(_TextEncodingMixin, YOLODataset):
    """YOLO labels + per-sample class texts (reference dataset.py:311):
    ``names`` values may carry '/'-separated synonyms, of which a train item
    samples one a class. Items gain ``texts`` (max_samples) and
    ``txt_feats`` (max_samples, D)."""

    def __init__(self, img_path, names: dict[int, str], max_samples: int | None = None,
                 neg_samples: tuple[int, int] = (80, 100), prompt_format: str = "{}", text_dim: int = 512, **kw):
        kw.setdefault("nc", len(names))
        super().__init__(img_path, **kw)
        class_texts = [str(names[k]).split("/") for k in sorted(names)]
        self._init_text(class_texts, max_samples=min(len(class_texts), 80) if max_samples is None else max_samples,
                        neg_samples=neg_samples, prompt_format=prompt_format, text_dim=text_dim)

    def _iter_label_texts(self):
        for lbl in self.labels:
            yield lbl, self.class_texts

    def get(self, i: int, rng: np.random.Generator | None = None) -> dict:
        rng = self._rng if rng is None else rng
        return self._finalize_text_sample(super().get(i, rng), self.class_texts, rng)


class GroundingDataset(_TextEncodingMixin, YOLODataset):
    """Caption-grounded detection from a COCO-style grounding JSON (reference
    dataset.py:407): an annotation's class is the caption phrase its
    ``tokens_positive`` span; class ids are an image's own. Mosaic, mixup,
    cutmix and copy-paste are off: samples of different images have
    different vocabularies."""

    def __init__(self, img_path: str, json_file: str, task: str = "detect", max_samples: int = 80,
                 neg_samples: tuple[int, int] = (30, 30), prompt_format: str = "{}", text_dim: int = 512, **kw):
        if task not in ("detect", "segment"):
            raise ValueError("GroundingDataset supports detect/segment only")
        self.json_file = json_file
        im_files, labels, texts = self._parse_grounding_json(Path(img_path), Path(json_file))
        self._image_texts = texts
        kw.setdefault("nc", max(max_samples, 1))
        super().__init__(im_files, task=task, **kw)
        self.labels = labels
        self.mosaic_enabled = False
        self.hyp = replace(self.hyp, mixup=0.0, cutmix=0.0, copy_paste=0.0, mosaic=0.0)
        self._init_text(texts_flat(texts), max_samples=max_samples, neg_samples=neg_samples,
                        prompt_format=prompt_format, text_dim=text_dim)

    @staticmethod
    def _parse_grounding_json(img_dir: Path, json_file: Path):
        """JSON -> (image files, labels as the label files give them, each
        image's texts). Boxes come as COCO ltwh pixels and are kept as
        normalized xywh; caption spans become the image's class texts."""
        ann = json.loads(json_file.read_text())
        images = {int(im["id"]): im for im in ann["images"]}
        per_img: dict[int, list[dict]] = defaultdict(list)
        for a in ann["annotations"]:
            per_img[int(a["image_id"])].append(a)

        im_files, labels, texts = [], [], []
        for img_id, anns in per_img.items():
            im = images[img_id]
            f = img_dir / im["file_name"]
            if not f.exists():
                continue
            w, h = float(im["width"]), float(im["height"])
            caption = im["caption"]
            cat2id: dict[str, int] = {}
            img_texts: list[list[str]] = []
            cls, xywhn = [], []
            for a in anns:
                if a.get("iscrowd"):
                    continue
                x, y, bw, bh = (float(v) for v in a["bbox"])
                if bw <= 0 or bh <= 0:
                    continue
                phrase = " ".join(caption[t[0]:t[1]] for t in a["tokens_positive"]).lower().strip()
                if not phrase:
                    continue
                if phrase not in cat2id:
                    cat2id[phrase] = len(cat2id)
                    img_texts.append([phrase])
                cls.append(float(cat2id[phrase]))
                xywhn.append([(x + bw / 2) / w, (y + bh / 2) / h, bw / w, bh / h])
            if not cls:
                continue
            im_files.append(str(f))
            labels.append({"cls": np.array(cls, np.float32), "xywhn": np.array(xywhn, np.float32)})
            texts.append(img_texts)
        return im_files, labels, texts

    def _iter_label_texts(self):
        yield from zip(self.labels, self._image_texts)

    def get(self, i: int, rng: np.random.Generator | None = None) -> dict:
        rng = self._rng if rng is None else rng
        return self._finalize_text_sample(super().get(i, rng), self._image_texts[i], rng)


def texts_flat(per_image_texts: list[list[list[str]]]) -> list[list[str]]:
    """The union of every image's phrase lists, in first-seen order."""
    seen, out = set(), []
    for img_texts in per_image_texts:
        for t in img_texts:
            if tuple(t) not in seen:
                seen.add(tuple(t))
                out.append(t)
    return out or [[""]]


class YOLOVisualPromptDataset(YOLODataset):
    """The ground truth's boxes as visual prompts (reference
    LoadVisualPrompt, augment.py:2156): items carry ``visual_prompts`` (nc,
    H/8, W/8), channel c the union of class c's boxes on the P3 grid; an
    absent class's channel stays zero (SAVPE then pools the whole grid)."""

    def get(self, i: int, rng: np.random.Generator | None = None) -> dict:
        s = super().get(i, rng)
        h, w = s["img"].shape[:2]
        gh, gw = h // 8, w // 8
        masks = np.zeros((self.nc, gh, gw), np.float32)
        for b, c in zip(np.asarray(s["bboxes"], np.float32), np.asarray(s["cls"]).astype(int)):
            y1, y2 = int(b[1] // 8), int(np.ceil(b[3] / 8))
            x1, x2 = int(b[0] // 8), int(np.ceil(b[2] / 8))
            masks[c, max(y1, 0):min(y2, gh), max(x1, 0):min(x2, gw)] = 1.0
        s["visual_prompts"] = masks
        return s


class YOLOConcatDataset:
    """Datasets concatenated under one collate contract (reference
    dataset.py:642): ``mode``, ``imgsz``, ``task``, ``set_epoch``, ``get``,
    ``__len__``, ``__getitem__`` and ``labels``, as the loader reads them."""

    def __init__(self, datasets: list):
        if not datasets:
            raise ValueError("need at least one dataset")
        self.datasets = list(datasets)
        modes = {d.mode for d in self.datasets}
        if len(modes) != 1:
            raise ValueError(f"mixed modes in concat: {modes}")
        self.mode = self.datasets[0].mode
        self.imgsz = self.datasets[0].imgsz
        self.task = self.datasets[0].task
        self._cum = np.cumsum([len(d) for d in self.datasets])

    def __len__(self) -> int:
        return int(self._cum[-1])

    def _locate(self, i: int) -> tuple[int, int]:
        if i < 0:
            i += len(self)
        if not 0 <= i < len(self):
            raise IndexError(f"index {i} out of range")
        k = int(np.searchsorted(self._cum, i, side="right"))
        return k, i - (int(self._cum[k - 1]) if k else 0)

    def get(self, i: int, rng: np.random.Generator | None = None):
        k, j = self._locate(i)
        return self.datasets[k].get(j, rng)

    def __getitem__(self, i: int):
        return self.get(i)

    @property
    def epoch_seed(self) -> int:
        return self.datasets[0].epoch_seed

    def set_epoch(self, epoch: int, **kw) -> None:
        for d in self.datasets:
            d.set_epoch(epoch, **kw)

    @property
    def labels(self) -> list[dict]:
        return [lbl for d in self.datasets for lbl in d.labels]
