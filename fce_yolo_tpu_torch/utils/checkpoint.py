"""Checkpoints (reference ``fce_yolo_tpu/utils/checkpoint.py:24-66``): a
checkpoint is a directory holding ``meta.json`` (model config, scale,
class names, train arguments, fitness) and the tensors.

The reference writes its tensors with orbax; here they go into one file,
``tensors.pt``, written by ``torch.save`` and read back with
``torch.load(weights_only=True)``, so loading runs no pickled code. The
tensors are a nested dict of tensors, numbers and lists.

The reference's own checkpoints (``tree/`` written by orbax) are read by
``load_jax_checkpoint`` without orbax, tensorstore or JAX: ``tree/_METADATA``
lists the leaves, ``utils/ocdbt.py`` reads the OCDBT key-value store and
``utils/zarr.py`` each leaf's zarr v2 array, both decompressing on the
caller's device (``utils/zstd.py``). zarr3 trees raise.
"""

from __future__ import annotations

import json
import os
from pathlib import Path
from typing import Any

import torch

__all__ = ["is_checkpoint", "is_jax_checkpoint", "save_checkpoint", "load_checkpoint", "load_jax_checkpoint"]

_META = "meta.json"
_TENSORS = "tensors.pt"
_TREE = "tree"


def is_jax_checkpoint(path: str | Path) -> bool:
    """A checkpoint of the JAX package: ``meta.json`` and an orbax ``tree/``."""
    p = Path(path)
    return p.is_dir() and (p / _META).exists() and (p / _TREE / "_METADATA").exists()


def is_checkpoint(path: str | Path) -> bool:
    """A checkpoint directory of the port (``tensors.pt``) or of the JAX package (``tree/_METADATA``)."""
    p = Path(path)
    return p.is_dir() and (p / _META).exists() and ((p / _TENSORS).exists() or is_jax_checkpoint(p))


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


def load_jax_checkpoint(path: str | Path, collections: tuple[str, ...] | None = ("params", "batch_stats"),
                        device: str | torch.device = "cuda") -> tuple[dict, dict]:
    """Read (tree, meta) of a JAX package checkpoint (reference
    ``load_checkpoint``, ``fce_yolo_tpu/utils/checkpoint.py:46-53``): the
    leaves of the top-level ``collections`` (all with None), as numpy arrays
    (bfloat16 ones as ``torch.bfloat16`` tensors), in the nested dicts of
    ``tree/_METADATA``'s key paths (the JAX package saves dicts). Only the
    collections asked for are decoded (a ``last`` checkpoint's
    ``train_state_leaves`` are skipped for a predict). zstd runs as host
    C++ for a ``cuda`` device, in Python for ``cpu``."""
    from fce_yolo_tpu_torch.utils.ocdbt import OcdbtStore
    from fce_yolo_tpu_torch.utils.zarr import read_array

    path = Path(path).resolve()
    meta = json.loads((path / _META).read_text())
    tree_dir = path / _TREE
    md = json.loads((tree_dir / "_METADATA").read_text())
    if md.get("use_zarr3"):
        raise ValueError(f"{tree_dir}: a zarr3 tree (use_zarr3) is not supported; the JAX package writes zarr v2")
    if not md.get("use_ocdbt", False):
        raise ValueError(f"{tree_dir}: a tree without OCDBT (use_ocdbt false) is not supported")
    store = OcdbtStore(tree_dir, device)
    tree: dict = {}
    for entry in md["tree_metadata"].values():
        keys = [str(k["key"]) for k in entry["key_metadata"]]
        if collections is not None and keys[0] not in collections:
            continue
        if entry.get("value_metadata", {}).get("skip_deserialize"):
            continue
        node = tree
        for k in keys[:-1]:
            node = node.setdefault(k, {})
        node[keys[-1]] = read_array(store, ".".join(keys), device)
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
