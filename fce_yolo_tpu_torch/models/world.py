"""YOLO-World facade (reference ``fce_yolo_tpu/models/world.py``; Ultralytics
WorldModel, nn/tasks.py:824-950): open-vocabulary detection with classes
named by text.

Text embeddings come from ``nn/text_model.py`` (the offline hash encoder by
default, ``text_model="clip:<path>"`` for the CLIP tower). The bound
embeddings live on the model as its ``txt_feats`` buffer
(``nn/model.py::DetectionModel``), so ``predict``, ``val`` and ``train`` run
the shared engine untouched, the stem kernel path included: this replaces
the JAX facade's swap of ``self.model`` for a text-binding shim.
"""

from __future__ import annotations

from typing import Mapping

import numpy as np
import torch

from fce_yolo_tpu_torch.api import YOLO

__all__ = ["YOLOWorld", "YOLOWorldTrainable", "dataset_names"]


def dataset_names(data) -> dict[int, str]:
    """The class names of a data YAML or dict, ``class_<i>`` where it gives none."""
    from fce_yolo_tpu_torch.data.dataset import check_det_dataset

    d = check_det_dataset(data)
    names = d.get("names") or {i: f"class_{i}" for i in range(d["nc"])}
    return {int(k): str(v) for k, v in (names.items() if isinstance(names, Mapping) else enumerate(names))}


class TextBound(YOLO):
    """A facade whose model scores against ``txt_feats`` (1, K, 512), bound
    on the model and bound again whenever the model is built anew."""

    txt_feats: np.ndarray | None = None

    def __init__(self, model: str, text_model: str = "hash:512", **kw):
        super().__init__(model, **kw)
        if self.spec is None or not self.spec.needs_text:
            raise ValueError(f"not an open-vocabulary config: {model}")
        self.text_model = text_model  # "clip:<local-checkpoint>" for the CLIP tower
        # the reference's placeholder until set_classes: random text features (JAX models/world.py:26)
        self._set_text(np.random.RandomState(0).randn(1, self.spec.nc, 512).astype(np.float32))

    def _build(self, *a, **kw) -> None:
        super()._build(*a, **kw)
        if self.txt_feats is not None:
            self._set_text(self.txt_feats)

    def _set_text(self, txt: np.ndarray) -> None:
        self.txt_feats = np.asarray(txt, np.float32)
        self.model.txt_feats = torch.from_numpy(self.txt_feats).to(self.device)
        # the new buffer may take a freed one's address and version, which
        # ``weights_version`` would not tell apart: fold predict's copy anew
        self._folded_copy = None

    def set_classes(self, names: list[str], embeddings: np.ndarray | None = None) -> None:
        """Bind class names for predict, val and train: their embeddings
        from ``text_model``, or ``embeddings`` (1, n, 512) precomputed
        (reference WorldModel.set_classes, tasks.py:861-870; YOLOE.set_classes)."""
        self._set_text(self.get_text_pe(names) if embeddings is None else embeddings)
        self.names = dict(enumerate(names))

    def get_text_pe(self, text: list[str]) -> np.ndarray:
        """Raw text embeddings (1, n, 512) of ``text`` from ``text_model``."""
        from fce_yolo_tpu_torch.nn.text_model import build_text_model

        enc = build_text_model(self.text_model, device=self.device)
        return enc.encode_text(enc.tokenize(text))[None]

    def _rebind_to_dataset(self, data) -> None:
        """Follow the dataset's class names when their count differs from the
        bound ones (a stale binding would shift the head's class slots)."""
        if data is None:
            return
        names = dataset_names(data)
        if len(names) != len(self.names or {}):
            self.set_classes([v for _, v in sorted(names.items())])


class YOLOWorld(TextBound):
    """Open-vocabulary detect facade over the WorldDetect graph,
    ``yolov8-world.yaml`` by default."""

    def __init__(self, model: str = "yolov8-world.yaml", text_model: str = "hash:512", **kw):
        super().__init__(model, text_model, **kw)


class YOLOWorldTrainable(YOLOWorld):
    """YOLOWorld whose ``train`` follows the dataset's class names (reference
    WorldTrainer: the detection loss over text-scored logits), and
    ``train_multimodal`` samples texts per image."""

    def train(self, data, **kw):
        self._rebind_to_dataset(data)
        return super().train(data, **kw)

    def train_multimodal(self, data, max_samples: int | None = None, **kw):
        """Open-vocabulary training with per-image sampled texts (reference
        WorldTrainerFromScratch over YOLOMultiModalDataset): every batch
        carries its positive and negative text embeddings as one (B, M, 512)
        tensor, M = min(nc, 80) unless given, and the class logits score
        against those M slots. The full class list (first synonym each) is
        bound for the epoch's val."""
        from fce_yolo_tpu_torch.data.multimodal import YOLOMultiModalDataset

        names = dataset_names(data)
        self.set_classes([v.split("/")[0] for _, v in sorted(names.items())])
        m = min(len(names), 80) if max_samples is None else max_samples
        return YOLO.train(self, data, dataset_cls=YOLOMultiModalDataset,
                          dataset_kw={"names": names, "max_samples": m}, **kw)
