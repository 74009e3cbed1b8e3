"""Two-stage experiment trainer on the port's facade (reference
``fce_yolo_tpu/experiments/trainer.py``, a rebuild of script/trainer.py:100-149).

Stage 1: short warmup run (optionally from pretrained weights) so the
randomly-initialized FCE/BiFPN modules converge into a sane regime.
Stage 2: long finetune restarting from stage 1's best checkpoint (its last
when no val ran). Single-stage runs skip straight to stage 2's config.
Every stage trains on ``device``: the card unless the caller names another.
"""

from __future__ import annotations

from pathlib import Path

import torch

from fce_yolo_tpu_torch.api import YOLO
from fce_yolo_tpu_torch.experiments.config import ModelConfig, StageConfig, TrainConfig, get_model_config

__all__ = ["ExperimentTrainer"]


class ExperimentTrainer:
    """Trains one model variant at one scale per the registry recipe."""

    def __init__(
        self,
        model_type: str | ModelConfig,
        scale: str = "s",
        train_cfg: TrainConfig | None = None,
        pretrained: str | None = None,
        device: torch.device | str = "cuda",
    ):
        self.device = torch.device(device)
        if self.device.type == "cuda" and not torch.cuda.is_available():
            raise RuntimeError("ExperimentTrainer: CUDA is not available; pass device='cpu' to train on the CPU")
        self.model_cfg = get_model_config(model_type) if isinstance(model_type, str) else model_type
        self.scale = scale
        self.train_cfg = train_cfg or TrainConfig()
        self.pretrained = pretrained

    def _stage_kwargs(self, stage: StageConfig, name: str) -> dict:
        kw = self.train_cfg.to_train_kwargs()
        kw.update(
            epochs=stage.epochs,
            patience=stage.patience,
            lr0=stage.lr0,
            cos_lr=stage.cos_lr,
            close_mosaic=stage.close_mosaic,
            name=name,
            # ablation dirs are fixed by contract (stale runs are detected
            # explicitly, ablation.py) — never auto-increment
            exist_ok=True,
        )
        # the wiou variant carries its loss in the model config (config.py)
        if self.model_cfg.iou_type != "CIoU" and kw.get("iou_type", "CIoU") == "CIoU":
            kw["iou_type"] = self.model_cfg.iou_type
        return kw

    def _model_name(self) -> str:
        stem = Path(self.model_cfg.yaml_path).stem  # yolo11-fce
        return stem.replace("yolo11", f"yolo11{self.scale}") + ".yaml"

    def train(self) -> dict:
        """Run the full (one- or two-stage) recipe. Returns summary dict."""
        stage1_cfg = self.model_cfg.stage1 or self.train_cfg.stage1
        stage2_cfg = self.model_cfg.stage2 or self.train_cfg.stage2
        summary: dict = {"model": self.model_cfg.name, "scale": self.scale}

        if stage1_cfg is not None:
            name1 = self.model_cfg.get_result_path(self.scale, stage=1)
            model = YOLO(self.pretrained or self._model_name(), device=self.device)
            out1 = model.train(**self._stage_kwargs(stage1_cfg, name1))
            summary["stage1"] = out1
            best1 = Path(out1["save_dir"]) / "weights" / "best"
            start = str(best1) if best1.exists() else str(Path(out1["save_dir"]) / "weights" / "last")
        else:
            start = self.pretrained or self._model_name()

        name2 = self.model_cfg.get_result_path(self.scale)
        model = YOLO(start, device=self.device)
        out2 = model.train(**self._stage_kwargs(stage2_cfg, name2))
        summary["stage2"] = out2
        summary["best_fitness"] = out2["best_fitness"]
        summary["save_dir"] = out2["save_dir"]
        return summary
