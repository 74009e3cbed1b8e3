"""Packaged model configs as Python dicts.

Equal to ``yaml.safe_load`` of ``fce_yolo_tpu/cfg/models/yolo11.yaml`` and
``yolo11-fce.yaml`` (YAML's unquoted ``None`` is the string "None", resolved
by the parser like the reference's literal_eval pass). Keeping them as dicts
means the port needs no pyyaml; ``load_model_dict`` imports ``yaml`` only for
a user-given file path.
"""

from __future__ import annotations

import copy
import re
from pathlib import Path

_SCALES = {
    "n": [0.5, 0.25, 1024],
    "s": [0.5, 0.5, 1024],
    "m": [0.5, 1.0, 512],
    "l": [1.0, 1.0, 512],
    "x": [1.0, 1.5, 512],
}

MODELS: dict[str, dict] = {
    "yolo11": {
        "nc": 80,
        "scales": _SCALES,
        "backbone": [
            [-1, 1, "Conv", [64, 3, 2]],  # 0 P1/2
            [-1, 1, "Conv", [128, 3, 2]],  # 1 P2/4
            [-1, 2, "C3k2", [256, False, 0.25]],  # 2
            [-1, 1, "Conv", [256, 3, 2]],  # 3 P3/8
            [-1, 2, "C3k2", [512, False, 0.25]],  # 4
            [-1, 1, "Conv", [512, 3, 2]],  # 5 P4/16
            [-1, 2, "C3k2", [512, True]],  # 6
            [-1, 1, "Conv", [1024, 3, 2]],  # 7 P5/32
            [-1, 2, "C3k2", [1024, True]],  # 8
            [-1, 1, "SPPF", [1024, 5]],  # 9
            [-1, 2, "C2PSA", [1024]],  # 10
        ],
        "head": [
            [-1, 1, "nn.Upsample", ["None", 2, "nearest"]],  # 11
            [[-1, 6], 1, "Concat", [1]],  # 12
            [-1, 2, "C3k2", [512, False]],  # 13
            [-1, 1, "nn.Upsample", ["None", 2, "nearest"]],  # 14
            [[-1, 4], 1, "Concat", [1]],  # 15
            [-1, 2, "C3k2", [256, False]],  # 16 P3/8
            [-1, 1, "Conv", [256, 3, 2]],  # 17
            [[-1, 13], 1, "Concat", [1]],  # 18
            [-1, 2, "C3k2", [512, False]],  # 19 P4/16
            [-1, 1, "Conv", [512, 3, 2]],  # 20
            [[-1, 10], 1, "Concat", [1]],  # 21
            [-1, 2, "C3k2", [1024, True]],  # 22 P5/32
            [[16, 19, 22], 1, "Detect", ["nc"]],  # 23
        ],
    },
    "yolo11-fce": {
        "nc": 80,
        "scales": _SCALES,
        "backbone": [
            [-1, 1, "Conv", [64, 3, 2]],  # 0 P1/2
            [-1, 1, "Conv", [128, 3, 2]],  # 1 P2/4
            [-1, 2, "C3k2", [256, False, 0.25]],  # 2
            [-1, 1, "Conv", [256, 3, 2]],  # 3 P3/8
            [-1, 2, "C3k2", [512, False, 0.25]],  # 4
            [-1, 1, "BiCoordCrossAtt", [512, 8, 4]],  # 5
            [-1, 1, "Conv", [512, 3, 2]],  # 6 P4/16
            [-1, 2, "C3k2", [512, True]],  # 7
            [-1, 1, "BiCoordCrossAtt", [512, 8, 4]],  # 8
            [-1, 1, "Conv", [1024, 3, 2]],  # 9 P5/32
            [-1, 2, "C3k2", [1024, True]],  # 10
            [-1, 1, "SPPF", [1024, 5]],  # 11
            [-1, 2, "C2PSA", [1024]],  # 12
        ],
        "head": [
            [-1, 1, "nn.Upsample", ["None", 2, "nearest"]],  # 13
            [[-1, 8], 1, "BiFPN_Concat", []],  # 14
            [-1, 2, "C3k2", [512, False]],  # 15
            [-1, 1, "nn.Upsample", ["None", 2, "nearest"]],  # 16
            [[-1, 5], 1, "BiFPN_Concat", []],  # 17
            [-1, 2, "C3k2", [256, False]],  # 18 P3/8
            [-1, 1, "Conv", [256, 3, 2]],  # 19
            [[-1, 8, 15], 1, "BiFPN_Concat", []],  # 20
            [-1, 2, "C3k2", [512, False]],  # 21 P4/16
            [-1, 1, "Conv", [512, 3, 2]],  # 22
            [[-1, 12], 1, "BiFPN_Concat", []],  # 23
            [-1, 2, "C3k2", [1024, True]],  # 24 P5/32
            [[18, 21, 24], 1, "Detect", ["nc"]],  # 25
        ],
    },
}


def guess_scale(model_name: str) -> str | None:
    """Extract the scale letter from names like ``yolo11s-fce``."""
    m = re.search(r"yolov?\d+([nslmx])", model_name)
    return m.group(1) if m else None


def load_model_dict(name: str | Path) -> tuple[dict, str | None]:
    """Resolve a model name or YAML path to (config dict, scale or None).

    ``yolo11s-fce.yaml`` -> the packaged ``yolo11-fce`` dict with scale 's'
    (the reference's ``yaml_model_load``/``guess_model_scale`` rule). An
    existing file path is read with pyyaml, imported only here.
    """
    path = Path(name)
    if path.is_file():
        import yaml

        with open(path) as fh:
            return yaml.safe_load(fh), guess_scale(path.stem)
    stem = path.stem if path.suffix in (".yaml", ".yml") else path.name
    if stem in MODELS:
        return copy.deepcopy(MODELS[stem]), None
    m = re.fullmatch(r"(yolov?\d+)([nslmx])(-[\w-]+)?", stem)
    if m:
        base = m.group(1) + (m.group(3) or "")
        if base in MODELS:
            return copy.deepcopy(MODELS[base]), m.group(2)
    raise FileNotFoundError(f"model config not found: {name} (packaged: {sorted(MODELS)})")
