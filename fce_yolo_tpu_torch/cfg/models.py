"""Packaged model configs: the yolo11 family as Python dicts, the other
families as YAML files.

``MODELS`` equals ``yaml.safe_load`` of ``fce_yolo_tpu/cfg/models/yolo11.yaml``,
``yolo11-fce.yaml``, ``yolo11-bifpn.yaml`` and the task heads'
``yolo11-seg.yaml``, ``yolo11-pose.yaml``, ``yolo11-obb.yaml`` and
``yolo11-cls.yaml`` (YAML's unquoted ``None`` is the string "None",
resolved by the parser like the reference's literal_eval pass).
``cfg/models/*.yaml`` are byte-equal copies of the JAX package's v3, v5, v6,
v8, v9, v10, yolo12, ResNet-classify, RT-DETR, YOLO-World and YOLOE YAMLs. These files and a user-given model YAML are read by
the port's own reader (``utils/yaml_read.py``): the port needs no pyyaml.
"""

from __future__ import annotations

import copy
import re
from pathlib import Path

from fce_yolo_tpu_torch.utils.yaml_read import read_yaml

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
    "yolo11-bifpn": {  # the ablation's M2: yolo11 with its four neck Concats as BiFPN_Concat
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
            [[-1, 6], 1, "BiFPN_Concat", []],  # 12
            [-1, 2, "C3k2", [512, False]],  # 13
            [-1, 1, "nn.Upsample", ["None", 2, "nearest"]],  # 14
            [[-1, 4], 1, "BiFPN_Concat", []],  # 15
            [-1, 2, "C3k2", [256, False]],  # 16 P3/8
            [-1, 1, "Conv", [256, 3, 2]],  # 17
            [[-1, 6, 13], 1, "BiFPN_Concat", []],  # 18
            [-1, 2, "C3k2", [512, False]],  # 19 P4/16
            [-1, 1, "Conv", [512, 3, 2]],  # 20
            [[-1, 10], 1, "BiFPN_Concat", []],  # 21
            [-1, 2, "C3k2", [1024, True]],  # 22 P5/32
            [[16, 19, 22], 1, "Detect", ["nc"]],  # 23
        ],
    },
}



def _yolo11_with_head(head: list, **top) -> dict:
    """yolo11 with another last layer (the task heads' YAMLs differ from
    yolo11.yaml only there, and pose in its top-level ``kpt_shape``)."""
    d = copy.deepcopy(MODELS["yolo11"])
    d["head"][-1] = [[16, 19, 22], 1, *head]
    return {**top, **d}


MODELS["yolo11-seg"] = _yolo11_with_head(["Segment", ["nc", 32, 256]])
MODELS["yolo11-pose"] = _yolo11_with_head(["Pose", ["nc", "kpt_shape"]], kpt_shape=[17, 3])
MODELS["yolo11-obb"] = _yolo11_with_head(["OBB", ["nc", 1]])
MODELS["yolo11-cls"] = {  # yolo11's backbone without SPPF, then the Classify head
    "nc": 1000,
    "scales": _SCALES,
    "backbone": [*copy.deepcopy(MODELS["yolo11"]["backbone"][:9]), [-1, 2, "C2PSA", [1024]]],
    "head": [[-1, 1, "Classify", ["nc"]]],
}


MODELS_DIR = Path(__file__).resolve().parent / "models"


def packaged_models() -> list[str]:
    """Every packaged model name: the dicts and the YAML files."""
    return sorted({*MODELS, *(p.stem for p in MODELS_DIR.glob("*.yaml"))})


def _packaged(stem: str) -> dict | None:
    """The packaged config named ``stem``, or None."""
    if stem in MODELS:
        return copy.deepcopy(MODELS[stem])
    path = MODELS_DIR / f"{stem}.yaml"
    return read_yaml(path.read_text()) if path.is_file() else None


def guess_scale(model_name: str) -> str | None:
    """Extract the scale letter from names like ``yolo11s-fce``."""
    m = re.search(r"yolo(?:v|e-v?)?\d+([nslmx])", model_name)
    return m.group(1) if m else None


def packaged_model_dict(name: str | Path) -> tuple[dict, str | None] | None:
    """The packaged config a model name or file name resolves to, as
    (config dict, scale or None), or None when no packaged config has it:
    ``yolo11s-fce.yaml`` -> the ``yolo11-fce`` dict with scale 's'. A
    packaged name is taken as it is first (``yolov9c``, ``yolov3-tiny``: no
    scale letter to strip), as the JAX ``load_model_yaml`` does. YOLOE's
    names take a scale letter too (``yoloe-11s-seg.yaml``, ``yoloe-v8s.yaml``),
    which the JAX package does not resolve (ROADMAP queue 3, item 36)."""
    path = Path(name)
    stem = path.stem if path.suffix in (".yaml", ".yml") else path.name
    d = _packaged(stem)
    if d is not None:
        return d, None
    m = re.fullmatch(r"(yolov?\d+|yoloe-v?\d+)([nslmx])(-[\w-]+)?", stem)
    if m:
        d = _packaged(m.group(1) + (m.group(3) or ""))
        if d is not None:
            return d, m.group(2)
    return None


def load_model_dict(name: str | Path) -> tuple[dict, str | None]:
    """Resolve a model name or YAML path to (config dict, scale or None)
    (the reference's ``yaml_model_load``/``guess_model_scale`` rule): an
    existing file path is read as it is, any other name resolves among the
    packaged configs (``packaged_model_dict``)."""
    path = Path(name)
    if path.is_file():
        return read_yaml(path.read_text()), guess_scale(path.stem)
    found = packaged_model_dict(name)
    if found is None:
        raise FileNotFoundError(f"model config not found: {name} (packaged: {', '.join(packaged_models())})")
    return found
