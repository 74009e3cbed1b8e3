"""Ultralytics ``.pt`` weights into the port (reference
``fce_yolo_tpu/nn/import_torch.py``).

The port's module tree carries Ultralytics' own attribute names, so its
``state_dict`` keys are the ``.pt`` file's (``model.0.conv.weight``,
``model.23.cv2.0.2.weight``, ``model.23.proto.upsample.weight``) and the
tensors keep torch's layouts: the import is a strict load, not the flax
rewrite of the reference. So are RT-DETR's keys, which the reference maps
one by one (``import_torch.py:60-95``): ``decoder.layers.N``, the
attention's ``in_proj_*`` and ``out_proj``, the Linears, the LayerNorms and
``denoising_class_embed.weight`` are the port's own module names, and so
are World's and YOLOE's (``attn.gl``, ``attn.bias``, ``query.0``,
``projections.0``, ``cv4.0.norm``, ``cv4.0.logit_scale``, ``reprta.m.w12``,
``savpe.cv6.1``; reference ``import_torch.py:101-143``), a YOLOE-seg
head's trunk flat beside ``proto`` and ``cv5`` where the reference nests it
under ``detect`` (``:196-197``). Dropped: a ``module.`` prefix (DataParallel
saves), ``num_batches_tracked`` buffers and ``*.dfl.conv.weight`` (the
port's DFL decode is parameter-free, as the reference's,
``import_torch.py:56``). A ConvTranspose2d kernel is taken as stored: the
reference's flip belongs to its flax layout (ROADMAP queue 3, item 14).
"""

from __future__ import annotations

from typing import Any, Mapping

import torch
from torch import nn

__all__ = ["import_torch_state_dict", "load_pt_state_dict"]


def load_pt_state_dict(path: str, allow_unsafe: bool = False) -> dict[str, torch.Tensor]:
    """Read a torch ``.pt`` file into a float32 state_dict (reference
    ``load_pt_state_dict``, ``import_torch.py:239-271``): the trainer's
    checkpoint (a dict with ``ema`` / ``model``, ``ema`` first, each a state
    dict or a module), or a bare state_dict, which the reference's reader
    refuses by accident (ROADMAP queue 3, item 29).

    Loads with ``torch.load(weights_only=True)``, so an untrusted file runs
    no pickled code; a file that stores module objects needs
    ``allow_unsafe=True``, given only for files you trust (and their
    classes importable: Ultralytics' own files need ``ultralytics``)."""
    try:
        ckpt = torch.load(path, map_location="cpu", weights_only=True)
    except Exception:
        if not allow_unsafe:
            raise ValueError(
                f"{path}: checkpoint needs full (unsafe) unpickling — it stores "
                "module objects, not just tensors. Re-call with allow_unsafe=True "
                "ONLY if you trust the file's origin."
            ) from None
        ckpt = torch.load(path, map_location="cpu", weights_only=False)
    if isinstance(ckpt, dict) and ("ema" in ckpt or "model" in ckpt):
        model = ckpt.get("ema") or ckpt.get("model")
    else:
        model = ckpt
    if hasattr(model, "state_dict"):
        model = model.state_dict()
    if not isinstance(model, Mapping):
        raise ValueError(f"{path}: holds no state_dict (a {type(model).__name__})")
    return {k: v.float() for k, v in model.items() if isinstance(v, torch.Tensor)}


def _dropped(key: str) -> bool:
    return key.endswith(".num_batches_tracked") or key.endswith(".dfl.conv.weight")


def import_torch_state_dict(state_dict: Mapping[str, Any], model: nn.Module) -> nn.Module:
    """Load an Ultralytics state_dict into the port's ``model``, strictly:
    every tensor of the model filled with its shape and nothing left over,
    else ``ValueError("weight import incomplete; missing=[...]
    mismatched=[...] unexpected=[...]")`` (the reference's message,
    ``import_torch.py:233-235``, naming keys the port has no module for
    too). Values take the model's dtype and device."""
    sd = {k.removeprefix("module."): torch.as_tensor(v) for k, v in state_dict.items()}
    sd = {k: v for k, v in sd.items() if not _dropped(k)}
    target = {k: t for k, t in model.state_dict().items() if not _dropped(k)}
    missing = [k for k in target if k not in sd]
    mismatched = [f"{k}: {tuple(sd[k].shape)} vs {tuple(t.shape)}" for k, t in target.items()
                  if k in sd and tuple(sd[k].shape) != tuple(t.shape)]
    unexpected = [k for k in sd if k not in target]
    if missing or mismatched or unexpected:
        raise ValueError(f"weight import incomplete; missing={missing[:8]} mismatched={mismatched[:8]} "
                         f"unexpected={unexpected[:8]}")
    model.load_state_dict({k: sd[k] for k in target}, strict=True)  # BatchNorm fills num_batches_tracked
    return model
