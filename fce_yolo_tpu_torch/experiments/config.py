"""Experiment registry: model variants, two-stage recipes, dataset presets.

A copy of the JAX package's ``experiments/config.py`` (itself a rebuild of
the fork's script/config.py, reference script/config.py:168-243):
the four ablation variants {baseline, bifpn, fce, fce_wiou} each with a
two-stage StageConfig (stage1 50-epoch warmup for the randomly-initialized
FCE modules, stage2 250-epoch finetune — rationale documented at reference
script/config.py:156-167), plus dataset presets and override merging
(config.py:289-346).
"""

from __future__ import annotations

from dataclasses import dataclass, field, replace
from typing import Callable, Optional

__all__ = [
    "StageConfig",
    "TrainConfig",
    "ModelConfig",
    "MODEL_CONFIGS",
    "DATASET_PRESETS",
    "get_model_config",
    "get_dataset_preset",
    "apply_overrides",
]


@dataclass(frozen=True)
class StageConfig:
    """Per-stage hyperparameters (reference StageConfig, script/config.py:17-23)."""

    epochs: int = 300
    patience: int = 50
    lr0: float = 0.001
    cos_lr: bool = True
    close_mosaic: int = 20


@dataclass
class TrainConfig:
    """Shared (cross-stage) training configuration (script/config.py:29-92)."""

    data: str = ""
    batch: int = 32
    imgsz: int = 640
    workers: int = 8
    optimizer: str = "AdamW"
    lrf: float = 0.01
    momentum: float = 0.937
    weight_decay: float = 0.0005
    iou_type: str = "CIoU"
    project: str = "runs/detect"
    save_period: int = -1
    verbose: bool = True
    seed: int = 0
    max_labels: int = 128
    extra_args: dict = field(default_factory=dict)
    stage1: Optional[StageConfig] = None
    stage2: StageConfig = field(default_factory=StageConfig)

    def to_train_kwargs(self) -> dict:
        """Flatten the shared params into YOLO.train kwargs."""
        d = dict(
            data=self.data,
            batch=self.batch,
            imgsz=self.imgsz,
            workers=self.workers,
            optimizer=self.optimizer,
            lrf=self.lrf,
            momentum=self.momentum,
            weight_decay=self.weight_decay,
            iou_type=self.iou_type,
            project=self.project,
            save_period=self.save_period,
            verbose=self.verbose,
            seed=self.seed,
            max_labels=self.max_labels,
        )
        d.update(self.extra_args)
        return d


@dataclass(frozen=True)
class ModelConfig:
    """One ablation variant (script/config.py:95-135)."""

    name: str
    yaml_path: str
    color: str
    display_name: Callable[[str], str]
    freeze: int = 0
    stage1: Optional[StageConfig] = None
    stage2: StageConfig = field(default_factory=StageConfig)
    result_pattern: str = ""
    iou_type: str = "CIoU"

    def get_display_name(self, scale: str) -> str:
        return self.display_name(scale)

    def is_two_stage(self) -> bool:
        return self.stage1 is not None

    def get_result_path(self, scale: str, stage: int | None = None) -> str:
        """Run-dir name; stage2 results land in <base>_stage2 (config.py:112-135)."""
        pattern = self.result_pattern.format(scale=scale).replace("_stage2", "")
        if stage is not None:
            return f"{pattern}_stage{stage}"
        if self.is_two_stage():
            return f"{pattern}_stage2"
        return pattern


_TWO_STAGE_1 = StageConfig(epochs=50, patience=50, lr0=0.001, cos_lr=True, close_mosaic=0)
_TWO_STAGE_2 = StageConfig(epochs=250, patience=50, lr0=0.001, cos_lr=True, close_mosaic=20)

# All four variants use the identical two-stage recipe with freeze=0 so the
# ablation is a fair comparison (reference rationale, script/config.py:156-167:
# the FCE/BiFPN modules get no transferred weights and need the stage-1 warmup;
# baseline runs the same schedule so the only variable is the architecture).
MODEL_CONFIGS: dict[str, ModelConfig] = {
    "baseline": ModelConfig(
        name="baseline",
        yaml_path="yolo11.yaml",
        color="#0BDBEB",
        display_name=lambda s: f"YOLOv11{s.upper()} Baseline",
        stage1=_TWO_STAGE_1,
        stage2=_TWO_STAGE_2,
        result_pattern="baseline_yolo11{scale}",
    ),
    "bifpn": ModelConfig(
        name="bifpn",
        yaml_path="yolo11-bifpn.yaml",
        color="#042AFF",
        display_name=lambda s: f"YOLOv11{s.upper()}-BiFPN",
        stage1=_TWO_STAGE_1,
        stage2=_TWO_STAGE_2,
        result_pattern="bifpn_{scale}",
    ),
    "fce": ModelConfig(
        name="fce",
        yaml_path="yolo11-fce.yaml",
        color="#FF6B00",
        display_name=lambda s: f"YOLOv11{s.upper()}-FCE",
        stage1=_TWO_STAGE_1,
        stage2=_TWO_STAGE_2,
        result_pattern="fce_{scale}",
    ),
    # same architecture as fce, trained with the WIoU loss; separate result
    # dir so it never overwrites the CIoU run (script/config.py:203-216)
    "fce_wiou": ModelConfig(
        name="fce_wiou",
        yaml_path="yolo11-fce.yaml",
        color="#E91E63",
        display_name=lambda s: f"YOLOv11{s.upper()}-FCE(WIoU)",
        stage1=_TWO_STAGE_1,
        stage2=_TWO_STAGE_2,
        result_pattern="fce_wiou_{scale}",
        iou_type="WIoU",
    ),
}

DATASET_PRESETS: dict[str, TrainConfig] = {
    "default": TrainConfig(data="data.yaml", imgsz=1280, batch=32, workers=16),
    "coco": TrainConfig(data="coco.yaml", imgsz=640, batch=16, workers=8),
    "coco_hq": TrainConfig(data="coco_custom.yaml", imgsz=640, batch=128, workers=24),
}

ABLATION_ORDER = ["baseline", "bifpn", "fce", "fce_wiou"]  # M1 -> M4


def get_model_config(model_type: str) -> ModelConfig:
    if model_type not in MODEL_CONFIGS:
        raise ValueError(f"unknown model type {model_type!r}; options: {', '.join(MODEL_CONFIGS)}")
    return MODEL_CONFIGS[model_type]


def get_dataset_preset(name: str) -> TrainConfig:
    if name not in DATASET_PRESETS:
        raise ValueError(f"unknown dataset preset {name!r}; options: {', '.join(DATASET_PRESETS)}")
    return replace(DATASET_PRESETS[name])  # fresh copy


def apply_overrides(cfg: TrainConfig, overrides: dict) -> TrainConfig:
    """Merge user overrides: known TrainConfig fields update directly, stage
    params update both stages, everything else goes to extra_args
    (reference script/config.py:289-346)."""
    cfg = replace(cfg)
    stage_fields = set(StageConfig.__dataclass_fields__)
    for k, v in overrides.items():
        if v is None:
            continue
        if k in TrainConfig.__dataclass_fields__ and k not in ("stage1", "stage2", "extra_args"):
            setattr(cfg, k, v)
        elif k in stage_fields:
            if cfg.stage1 is not None:
                cfg.stage1 = replace(cfg.stage1, **{k: v})
            cfg.stage2 = replace(cfg.stage2, **{k: v})
        else:
            cfg.extra_args[k] = v
    return cfg
