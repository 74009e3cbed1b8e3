"""JAX variables -> the port's ``state_dict`` (inverse of
``fce_yolo_tpu/nn/import_torch.py:41`` ``torch_key_to_flax``).

  flax (numpy leaves)                          port state_dict
  params/layers_0/conv/kernel      (HWIO)  ->  model.0.conv.weight        (OIHW)
  params/layers_0/bn/{scale,bias}          ->  model.0.bn.{weight,bias}
  batch_stats/layers_0/bn/{mean,var}       ->  model.0.bn.running_{mean,var}
  params/layers_23/cv2_0_2/conv2d/kernel   ->  model.23.cv2.0.2.weight
  params/layers_14/w                       ->  model.14.w

Takes plain numpy trees, so it needs no JAX (``jax.device_get`` or
``np.asarray`` the variables first).
"""

from __future__ import annotations

import re
from typing import Any, Mapping

import numpy as np
import torch

_LEAF = {
    ("params", "kernel"): "weight",
    ("params", "scale"): "weight",
    ("batch_stats", "mean"): "running_mean",
    ("batch_stats", "var"): "running_var",
}


def _module_token(name: str) -> str:
    """``layers_5`` -> ``model.5``; ``cv2_0_1`` -> ``cv2.0.1``; ``proj_q_h`` stays."""
    m = re.fullmatch(r"(.*?)((?:_\d+)+)", name)
    if not m:
        return name
    base = "model" if m.group(1) == "layers" else m.group(1)
    return base + m.group(2).replace("_", ".")


def _walk(node: Mapping[str, Any], path: tuple[str, ...] = ()):
    for k, v in node.items():
        if isinstance(v, Mapping):
            yield from _walk(v, path + (k,))
        else:
            yield path + (k,), v


def flax_path_to_key(collection: str, path: tuple[str, ...]) -> str:
    """One flax leaf path -> the port's state_dict key."""
    *mods, leaf = path
    parts = [_module_token(p) for p in mods if p != "conv2d"]  # bare Conv2d scope
    parts.append(_LEAF.get((collection, leaf), leaf))
    return ".".join(parts)


def variables_to_state_dict(variables: Mapping[str, Any]) -> dict[str, torch.Tensor]:
    """flax ``{"params", "batch_stats"}`` of numpy arrays -> port state_dict
    (float tensors keep their dtype; bf16 numpy leaves need jnp's ml_dtypes
    and are converted through float32)."""
    out: dict[str, torch.Tensor] = {}
    for coll in ("params", "batch_stats"):
        for path, arr in _walk(variables.get(coll, {})):
            a = np.asarray(arr)
            if a.dtype.kind == "V" or a.dtype.name == "bfloat16":
                t = torch.from_numpy(a.astype(np.float32)).to(torch.bfloat16)
            else:
                t = torch.from_numpy(np.array(a))  # a writable copy
            if path[-1] == "kernel" and t.ndim == 4:
                t = t.permute(3, 2, 0, 1).contiguous()  # HWIO -> OIHW
            key = flax_path_to_key(coll, path)
            if key in out:
                raise ValueError(f"two flax leaves map to {key}")
            out[key] = t
    return out
