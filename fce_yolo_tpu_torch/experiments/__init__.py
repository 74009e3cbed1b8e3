"""Experiment orchestration on the port (reference ``fce_yolo_tpu/experiments/``,
the fork's script/ layer rebuilt): config registry, two-stage trainer,
ablation pipeline, analysis, weight inspection, packing and the paper
tables and figures. Training runs on the card unless ``device`` names
another."""

from fce_yolo_tpu_torch.experiments.ablation import detect_stale_runs, run_ablation, validate_run
from fce_yolo_tpu_torch.experiments.analysis import ablation_table, best_epoch, format_table, load_results
from fce_yolo_tpu_torch.experiments.config import (
    ABLATION_ORDER,
    DATASET_PRESETS,
    MODEL_CONFIGS,
    ModelConfig,
    StageConfig,
    TrainConfig,
    apply_overrides,
    get_dataset_preset,
    get_model_config,
)
from fce_yolo_tpu_torch.experiments.inspect_weights import inspect_checkpoint, inspect_state_dict
from fce_yolo_tpu_torch.experiments.trainer import ExperimentTrainer

__all__ = [
    "ABLATION_ORDER",
    "DATASET_PRESETS",
    "MODEL_CONFIGS",
    "ExperimentTrainer",
    "ModelConfig",
    "StageConfig",
    "TrainConfig",
    "ablation_table",
    "apply_overrides",
    "best_epoch",
    "detect_stale_runs",
    "format_table",
    "get_dataset_preset",
    "get_model_config",
    "inspect_checkpoint",
    "inspect_state_dict",
    "load_results",
    "run_ablation",
    "validate_run",
]
