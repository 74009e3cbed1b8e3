"""JAX variables -> the port's ``state_dict`` (inverse of
``fce_yolo_tpu/nn/import_torch.py:41`` ``torch_key_to_flax``).

  flax (numpy leaves)                          port state_dict
  params/layers_0/conv/kernel      (HWIO)  ->  model.0.conv.weight        (OIHW)
  params/layers_0/bn/{scale,bias}          ->  model.0.bn.{weight,bias}
  batch_stats/layers_0/bn/{mean,var}       ->  model.0.bn.running_{mean,var}
  params/layers_23/cv2_0_2/conv2d/kernel   ->  model.23.cv2.0.2.weight
  params/layers_14/w                       ->  model.14.w
  params/layers_23/detect/cv2_0_0/conv/kernel  ->  model.23.cv2.0.0.conv.weight  (a task head's trunk)
  params/layers_23/proto/upsample/kernel  ->  model.23.proto.upsample.weight  (ConvTranspose2d)
  params/layers_17/conv_transpose2d/kernel  ->  model.17.weight  (a YAML ``nn.ConvTranspose2d`` layer)
  params/layers_6/m_0_1/mlp_0/conv/kernel  ->  model.6.m.0.1.mlp.0.conv.weight
  params/layers_6/gamma                    ->  model.6.gamma
  params/layers_10/linear/kernel   (in, out)  ->  model.10.linear.weight     (out, in)  (Classify's Linear)
  params/layers_23/one2one_cv3_0_1_0/conv/kernel  ->  model.23.one2one_cv3.0.1.0.conv.weight  (V10Detect)
  params/layers_0/m/layer2_0/conv1/kernel  ->  model.0.m.layer2.0.conv1.weight  (a ResNet trunk's bare conv)
  params/layers_0/m/layer2_0/down_conv/kernel  ->  model.0.m.layer2.0.downsample.0.weight
  params/layers_0/m/layer2_0/down_bn/scale     ->  model.0.m.layer2.0.downsample.1.weight
  params/layers_11/ma/in_proj_weight  (3C, C)  ->  model.11.ma.in_proj_weight   (as it is)
  params/layers_11/ma/out_proj_weight (out, in)  ->  model.11.ma.out_proj.weight  (as it is)
  params/layers_11/norm1/scale             ->  model.11.norm1.weight   (LayerNorm)
  params/layers_28/decoder_layers_0/norm3/bias  ->  model.28.decoder.layers.0.norm3.bias
  params/layers_28/dec_bbox_head_0/layers_2/kernel  ->  model.28.dec_bbox_head.0.layers.2.weight  (an MLP's Linear)
  params/layers_28/input_proj_0_0/conv2d/kernel  ->  model.28.input_proj.0.0.weight
  params/layers_28/denoising_class_embed   ->  model.28.denoising_class_embed.weight  (nn.Embedding)

YOLO-World and YOLOE (``nn/world.py``, ``nn/yoloe.py``): their Dense
kernels (``gl``, ``query_1``/``key_1``/``value_1``, ``proj``, ``w12``,
``w3``) are transposed like any Linear's, the LayerNorms' ``scale`` is
their ``weight``, ``BNContrastiveHead``'s ``norm`` is a BatchNorm, and the
bare parameters (``bias``, ``logit_scale``, and the ``scale`` of
``ImagePoolingAttn``, whose flax scope is the layer's own) keep their names:

  params/layers_12/attn/gl/kernel  (in, out)  ->  model.12.attn.gl.weight   (out, in)
  params/layers_16/scale                   ->  model.16.scale             (a bare parameter)
  params/layers_16/query_0/scale           ->  model.16.query.0.weight    (LayerNorm)
  params/layers_22/cv4_0/norm/scale        ->  model.22.cv4.0.norm.weight (BNContrastiveHead's BatchNorm)
  params/layers_23/detect/reprta/m/w12/kernel  ->  model.23.reprta.m.w12.weight  (YOLOESegment's trunk)

A task head (Segment, Pose, OBB, YOLOESegment) nests its Detect trunk under a ``detect``
scope in flax; the port's keys are Ultralytics' flat names, so the scope is
dropped here and put back by ``key_to_flax``; so is the ``conv_transpose2d``
scope of a YAML ``nn.ConvTranspose2d`` layer, whose weights are the layer's
own in the port (``model.17.weight``, as Ultralytics names them). A ResNet
trunk (``nn/resnet.py``) keeps torchvision's names: its convs are flax
``nn.Conv``s without the ``conv2d`` scope, and the flax ``down_conv`` and
``down_bn`` are torchvision's ``downsample.0`` and ``downsample.1``. A flax
``ConvTranspose`` kernel (kh, kw, in, out) becomes torch's (in, out, kh, kw)
with both spatial axes flipped: flax's transposed convolution
(``transpose_kernel`` False) applies the kernel unflipped to the dilated
input, torch's is the gradient of a convolution, which applies it flipped.
Whether a kernel is a transposed one follows the kind of the port module
that owns its key (``nn.ConvTranspose2d``) when the model is given, as
``YOLO.load_jax_variables`` and ``state_dict_to_variables`` (the way back)
do; without a model, its flax scope tells: the JAX package builds its
``nn.ConvTranspose`` modules under two names, Proto's ``upsample`` and the
layer's ``conv_transpose2d`` (``_CONV_T``).

RT-DETR (``nn/transformer.py``, ``RTDETRDecoder``): a flax ``Dense``
kernel is transposed into a Linear's weight, a ``LayerNorm``'s ``scale`` is
its ``weight``; the attention's packed ``in_proj_*`` and its
``out_proj_{weight,bias}`` keep torch's layout (the JAX ``_TorchMHA``
declares them so); the embedding tables are flax leaves of the head's scope;
flax flattens Ultralytics' ``decoder.layers.N`` into ``decoder_layers_N``,
and only the first token of a path is a model layer (``layers_N`` deeper
down is an MLP's ``layers.N``).

Takes plain numpy trees, so it needs no JAX (``jax.device_get`` or
``np.asarray`` the variables first). ``key_to_flax`` is the inverse, for a
key of a given model (the optimizer's parameter groups and ``freeze`` read
the flax paths).
"""

from __future__ import annotations

import re
from typing import Any, Mapping

import numpy as np
import torch
from torch import nn

from fce_yolo_tpu_torch.nn.heads import OBB, Pose, Segment
from fce_yolo_tpu_torch.nn.resnet import ResNetTrunk
from fce_yolo_tpu_torch.nn.transformer import TorchMHA
from fce_yolo_tpu_torch.nn.yoloe import YOLOESegment

_LEAF = {  # (collection, flax leaf) -> (owner: conv or BN, state_dict leaf)
    ("params", "kernel"): (nn.Conv2d, "weight"),
    ("params", "scale"): (nn.BatchNorm2d, "weight"),
    ("batch_stats", "mean"): (nn.BatchNorm2d, "running_mean"),
    ("batch_stats", "var"): (nn.BatchNorm2d, "running_var"),
}
_FLAX_LEAF = {v: k for k, v in _LEAF.items()}
_BARE_CONV = "conv2d"  # the flax scope of a bare Conv2d (not a ConvBNAct's ``conv``)
_TRUNK = "detect"  # the flax scope of a task head's Detect trunk
_LAYER_CONV_T = "conv_transpose2d"  # the flax scope of a YAML nn.ConvTranspose2d layer's weights
_CONV_T = ("upsample", _LAYER_CONV_T)  # the scopes of the JAX package's flax ConvTranspose modules
_RESNET_DOWN = {"down_conv": "downsample.0", "down_bn": "downsample.1"}  # flax scope -> torchvision's name
_EMBED = ("denoising_class_embed",)  # flax leaves that are an nn.Embedding's weight
_OUT_PROJ = ("out_proj_weight", "out_proj_bias")  # the attention's out projection, flax leaves
_YOLOE_TRUNK = ("cv2", "cv3", "cv4", "reprta", "savpe")  # YOLOESegment's children under ``detect`` (else cv2, cv3)


def _bare_scale(collection: str, mods: list[str], leaf: str) -> bool:
    """Whether a flax ``scale`` leaf is a bare parameter (ImagePoolingAttn's,
    directly under its layer), not a norm's."""
    return (collection == "params" and leaf == "scale" and bool(mods)
            and re.fullmatch(r"layers_\d+", mods[-1]) is not None)


def _module_token(name: str, top: bool = True) -> str:
    """``layers_5`` -> ``model.5`` (at the ``top`` of a path, else ``layers.5``);
    ``cv2_0_1`` -> ``cv2.0.1``; ``decoder_layers_0`` -> ``decoder.layers.0``; ``proj_q_h`` stays."""
    m = re.fullmatch(r"(.*?)((?:_\d+)+)", name)
    if not m:
        return name
    base = "model" if m.group(1) == "layers" and top else m.group(1)
    if base == "decoder_layers":
        base = "decoder.layers"
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
    parts = [_RESNET_DOWN.get(p, _module_token(p, top=i == 0)) for i, p in enumerate(mods)
             if p not in (_BARE_CONV, _TRUNK, _LAYER_CONV_T)]
    if leaf in _EMBED:
        parts += [leaf, "weight"]
    elif _bare_scale(collection, mods, leaf):
        parts.append(leaf)
    elif leaf in _OUT_PROJ:
        parts += ["out_proj", leaf.rpartition("_")[2]]
    else:
        parts.append(_LEAF.get((collection, leaf), (None, leaf))[1])
    return ".".join(parts)


def key_to_flax(model: nn.Module, key: str) -> tuple[str, tuple[str, ...]]:
    """One state_dict key of ``model`` -> (collection, flax leaf path), the
    inverse of ``flax_path_to_key``: ``model.23.cv2.0.2.weight`` ->
    ("params", ("layers_23", "cv2_0_2", "conv2d", "kernel"))."""
    mod_name, _, leaf = key.rpartition(".")
    owner = model.get_submodule(mod_name)
    tokens = mod_name.split(".")
    mods: list[str] = []
    for t in tokens:  # the inverse of _module_token: digits join the name before them
        if t.isdigit() and mods:
            mods[-1] = f"{mods[-1]}_{t}"
        else:
            mods.append(t)
    if "decoder" in mods:  # Ultralytics' decoder.layers.N is flax's decoder_layers_N
        i = mods.index("decoder")
        if i + 1 < len(mods) and mods[i + 1].startswith("layers_"):
            mods[i:i + 2] = [f"decoder_{mods[i + 1]}"]
    if mods and tokens[0] == "model":
        mods[0] = "layers" + mods[0][len("model"):]
        head = model.get_submodule(".".join(tokens[:2])) if len(tokens) > 2 else None
        trunk = _YOLOE_TRUNK if isinstance(head, YOLOESegment) else ("cv2", "cv3")
        if isinstance(head, (Segment, Pose, OBB, YOLOESegment)) and tokens[2] in trunk:
            mods.insert(1, _TRUNK)
    if isinstance(owner, nn.Embedding):
        return "params", tuple(mods)
    if isinstance(owner, nn.Linear) and tokens[-1] == "out_proj" and isinstance(
            model.get_submodule(mod_name.rpartition(".")[0]), TorchMHA):
        return "params", tuple(mods[:-1]) + (f"out_proj_{leaf}",)
    kind = next((k for k in (nn.Conv2d, nn.BatchNorm2d, nn.ConvTranspose2d, nn.Linear, nn.LayerNorm)
                 if isinstance(owner, k)), None)
    if any(isinstance(model.get_submodule(".".join(tokens[:i])), ResNetTrunk) for i in range(1, len(tokens))):
        down = {v.replace(".", "_"): k for k, v in _RESNET_DOWN.items()}
        mods = [down.get(m, m) for m in mods]
    elif kind is nn.Conv2d and tokens[-1] != "conv":
        mods.append(_BARE_CONV)
    if kind is nn.ConvTranspose2d and len(tokens) == 2 and tokens[0] == "model":
        mods.append(_LAYER_CONV_T)
    kind = {nn.ConvTranspose2d: nn.Conv2d, nn.Linear: nn.Conv2d, nn.LayerNorm: nn.BatchNorm2d}.get(kind, kind)
    collection, flax_leaf = _FLAX_LEAF.get((kind, leaf), ("params", leaf))
    return collection, tuple(mods) + (flax_leaf,)


def _is_conv_t(model: nn.Module | None, key: str, path: tuple[str, ...]) -> bool:
    """Whether the kernel at ``path`` (port key ``key``) is a transposed
    convolution's: by the kind of ``model``'s module that owns the key, or
    without a model by its flax scope (``_CONV_T``)."""
    if model is None:
        return path[-2] in _CONV_T
    return isinstance(model.get_submodule(key.rpartition(".")[0]), nn.ConvTranspose2d)


def variables_to_state_dict(variables: Mapping[str, Any], model: nn.Module | None = None) -> dict[str, torch.Tensor]:
    """flax ``{"params", "batch_stats"}`` of numpy arrays -> port state_dict
    (float tensors keep their dtype; bf16 numpy leaves need jnp's ml_dtypes
    and are converted through float32; torch tensor leaves, as
    ``utils/zarr.py`` gives bfloat16 arrays, are taken as they are). With
    ``model`` (the port model the keys belong to), a kernel is read as a
    transposed one by the kind of the module that owns it; without, by its
    flax scope."""
    out: dict[str, torch.Tensor] = {}
    for coll in ("params", "batch_stats"):
        for path, arr in _walk(variables.get(coll, {})):
            a = arr if isinstance(arr, torch.Tensor) else np.asarray(arr)
            if isinstance(a, torch.Tensor):
                t = a.detach().clone()
            elif a.dtype.kind == "V" or a.dtype.name == "bfloat16":
                t = torch.from_numpy(a.astype(np.float32)).to(torch.bfloat16)
            else:
                t = torch.from_numpy(np.array(a))  # a writable copy
            key = flax_path_to_key(coll, path)
            if path[-1] == "kernel" and t.ndim == 4 and _is_conv_t(model, key, path):
                t = t.flip(0, 1).permute(2, 3, 0, 1).contiguous()  # flax ConvTranspose -> torch (I, O, kH, kW)
            elif path[-1] == "kernel" and t.ndim == 4:
                t = t.permute(3, 2, 0, 1).contiguous()  # HWIO -> OIHW
            elif path[-1] == "kernel" and t.ndim == 2:
                t = t.t().contiguous()  # flax Dense (in, out) -> torch Linear (out, in)
            if key in out:
                raise ValueError(f"two flax leaves map to {key}")
            out[key] = t
    return out


def state_dict_to_variables(model: nn.Module, state_dict: Mapping[str, torch.Tensor] | None = None) -> dict:
    """The inverse of ``variables_to_state_dict``: ``model``'s weights (or
    ``state_dict``, keys of ``model``) as flax ``{"params", "batch_stats"}``
    of numpy arrays. Paths come from ``key_to_flax``; each kernel's layout
    from the kind of module that owns it: a conv's OIHW -> HWIO, a
    ``nn.ConvTranspose2d``'s (in, out, kh, kw) -> (kh, kw, in, out) with both
    spatial axes flipped back, a Linear's (out, in) -> (in, out)."""
    out: dict = {"params": {}, "batch_stats": {}}
    for key, t in (model.state_dict() if state_dict is None else state_dict).items():
        if key.endswith("num_batches_tracked"):
            continue
        coll, path = key_to_flax(model, key)
        a = t.detach().float().cpu().numpy() if t.dtype == torch.bfloat16 else t.detach().cpu().numpy().copy()
        owner = model.get_submodule(key.rpartition(".")[0])
        if path[-1] == "kernel" and isinstance(owner, nn.ConvTranspose2d):
            a = np.ascontiguousarray(a.transpose(2, 3, 0, 1)[::-1, ::-1])
        elif path[-1] == "kernel" and a.ndim == 4:
            a = np.ascontiguousarray(a.transpose(2, 3, 1, 0))
        elif path[-1] == "kernel" and a.ndim == 2:
            a = np.ascontiguousarray(a.T)
        node = out[coll]
        for k in path[:-1]:
            node = node.setdefault(k, {})
        node[path[-1]] = a
    return out
