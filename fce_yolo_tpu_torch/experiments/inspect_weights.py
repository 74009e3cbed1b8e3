"""Post-hoc diagnosis of trained FCE modules in the port's checkpoints
(reference ``fce_yolo_tpu/experiments/inspect_weights.py``, a rebuild of
script/inspect_weights.py:43-170).

Reads a checkpoint's state_dict and reports:
- BiFPN_Concat learned fusion weights (raw + relu-normalized) with a verdict
  on whether the fusion learned a preference or collapsed to plain averaging
  (reference inspect_bifpn, script/inspect_weights.py:54-73).
- BiCoordCrossAtt gate-projection weight statistics (out_h / out_w /
  identity; reference inspect_bicoord:75-92). Keys are the port's state_dict
  names; mean, std and L2 do not depend on the layout, ``shape`` is the
  port's OIHW. The JAX package's version looks for ``out_h/kernel`` where its
  trees hold ``out_h/conv2d/kernel``, so it reports no layer here.
"""

from __future__ import annotations

from typing import Any, Iterator, Mapping

import numpy as np
import torch

__all__ = ["inspect_state_dict", "inspect_checkpoint", "bifpn_fusion_weights", "bicoord_gate_stats"]


def _arrays(state_dict: Mapping[str, torch.Tensor]) -> Iterator[tuple[str, np.ndarray]]:
    for key, t in state_dict.items():
        if isinstance(t, torch.Tensor) and t.is_floating_point():
            yield key, t.detach().cpu().float().numpy()


def bifpn_fusion_weights(state_dict: Mapping[str, torch.Tensor], epsilon: float = 1e-4) -> dict[str, dict]:
    """Collect every BiFPN fusion weight vector ``<layer>.w`` -> normalized + verdict."""
    out = {}
    for key, arr in _arrays(state_dict):
        if key.endswith(".w") and arr.ndim == 1 and arr.size <= 8:
            relu = np.maximum(arr, 0)
            normed = relu / (relu.sum() + epsilon)
            n = arr.size
            max_dev = float(np.abs(normed - 1.0 / n).max())
            if max_dev < 0.02:
                verdict = "≈ uniform fusion (no learned preference; equivalent to plain Concat)"
            elif max_dev < 0.10:
                verdict = "slight preference"
            else:
                verdict = "strong learned fusion preference"
            out[key] = {
                "raw": arr.tolist(),
                "normalized": [round(float(x), 4) for x in normed],
                "max_dev_from_uniform": round(max_dev, 4),
                "verdict": verdict,
            }
    return out


def _tensor_stats(arr: np.ndarray) -> dict[str, Any]:
    return {
        "shape": list(arr.shape),
        "mean": round(float(arr.mean()), 5),
        "std": round(float(arr.std()), 5),
        "l2": round(float(np.linalg.norm(arr)), 4),
    }


def bicoord_gate_stats(state_dict: Mapping[str, torch.Tensor]) -> dict[str, dict]:
    """Per-BiCoordCrossAtt layer: out_h/out_w/identity conv weight statistics.

    A near-zero gate-projection norm means the branch's sigmoid sits at a
    constant ~0.5 and the attention is inactive.
    """
    layers: dict[str, dict] = {}
    for key, arr in _arrays(state_dict):
        for tag in ("out_h", "out_w", "identity"):
            marker = f".{tag}.weight"
            if key.endswith(marker):
                layers.setdefault(key[: -len(marker)], {})[tag] = _tensor_stats(arr)
    # genuine BiCoordCrossAtt layers have both gates
    return {k: v for k, v in layers.items() if "out_h" in v and "out_w" in v}


def inspect_state_dict(state_dict: Mapping[str, torch.Tensor]) -> dict[str, Any]:
    return {"bifpn": bifpn_fusion_weights(state_dict), "bicoord": bicoord_gate_stats(state_dict)}


def inspect_checkpoint(path: str, verbose: bool = True) -> dict[str, Any]:
    """``inspect_state_dict`` of a checkpoint directory's model weights, with its metadata."""
    from fce_yolo_tpu_torch.utils.checkpoint import load_checkpoint

    tree, meta = load_checkpoint(path)
    report = inspect_state_dict(tree["model"])
    report["meta"] = {k: meta.get(k) for k in ("cfg_yaml", "scale", "nc", "epoch", "fitness")}
    if verbose:
        print(f"checkpoint: {path} ({report['meta']})")
        for name, info in report["bifpn"].items():
            print(f"  [BiFPN] {name}: w={info['normalized']} dev={info['max_dev_from_uniform']} -> {info['verdict']}")
        for name, info in report["bicoord"].items():
            print(f"  [BiCoordCrossAtt] {name}: " + ", ".join(f"{t} l2={s['l2']}" for t, s in info.items()))
    return report
