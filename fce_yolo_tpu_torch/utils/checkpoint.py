"""Checkpoints (reference ``fce_yolo_tpu/utils/checkpoint.py:24-66``): a
checkpoint is a directory holding ``meta.json`` (model config, scale,
class names, train arguments, fitness) and the tensors.

The reference writes its tensors with orbax; here they go into one file,
``tensors.pt``, written by ``torch.save`` and read back with
``torch.load(weights_only=True)``, so loading runs no pickled code. The
tensors are a nested dict of tensors, numbers and lists. Reading the
reference's orbax checkpoints is not supported.
"""

from __future__ import annotations

import json
import os
from pathlib import Path
from typing import Any

import torch

__all__ = ["is_checkpoint", "save_checkpoint", "load_checkpoint"]

_META = "meta.json"
_TENSORS = "tensors.pt"


def is_checkpoint(path: str | Path) -> bool:
    return Path(path).is_dir() and (Path(path) / _META).exists()


def save_checkpoint(path: str | Path, tree: dict, meta: dict[str, Any]) -> str:
    """Write ``tree`` and ``meta`` to the directory ``path``, replacing a
    checkpoint there. The tensors are written to a temporary name first and
    renamed, so an interrupted save leaves the previous file whole."""
    path = Path(path).resolve()
    path.mkdir(parents=True, exist_ok=True)
    tmp = path / (_TENSORS + ".tmp")
    torch.save(tree, tmp)
    os.replace(tmp, path / _TENSORS)
    (path / _META).write_text(json.dumps(_jsonable(meta), indent=2))
    return str(path)


def load_checkpoint(path: str | Path, map_location: str | torch.device = "cpu") -> tuple[dict, dict]:
    """Read (tree, meta) back; tensors land on ``map_location``."""
    path = Path(path).resolve()
    meta = json.loads((path / _META).read_text())
    tree = torch.load(path / _TENSORS, map_location=map_location, weights_only=True)
    return tree, meta


def _jsonable(obj):
    if isinstance(obj, dict):
        return {str(k): _jsonable(v) for k, v in obj.items()}
    if isinstance(obj, (list, tuple)):
        return [_jsonable(v) for v in obj]
    if hasattr(obj, "item") and getattr(obj, "ndim", 1) == 0:
        return obj.item()
    if isinstance(obj, Path):
        return str(obj)
    return obj
