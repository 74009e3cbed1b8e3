"""Graph-executor detection model (reference ``fce_yolo_tpu/nn/model.py``).

``DetectionModel`` walks the parsed layer list with a savelist cache, like
the reference's ``BaseModel._predict_once`` (nn/tasks.py:160-188). Strides
come from a forward on the ``meta`` device (shapes only, no memory, no
FLOPs) in place of the JAX ``eval_shape`` probe.
"""

from __future__ import annotations

import math
from pathlib import Path
from typing import Any

import torch
from torch import nn

from fce_yolo_tpu_torch.nn import fce
from fce_yolo_tpu_torch.nn import modules as M
from fce_yolo_tpu_torch.nn.parser import LayerSpec, ModelSpec, load_model_yaml, parse_model_yaml


def make_layer(ls: LayerSpec, strides: tuple[int, ...] | None, legacy: bool = False) -> nn.Module:
    """Instantiate the module for one LayerSpec (reference-arg convention)."""
    a, n = ls.args, ls.name
    if n == "Conv":  # (c1, c2, k=1, s=1, p=None, g=1, d=1, act=True)
        return M.ConvBNAct(a[0], a[1], *a[2:8])
    if n == "C3k2":
        return M.C3k2(a[0], a[1], n=a[2], c3k=a[3] if len(a) > 3 else False,
                      e=a[4] if len(a) > 4 else 0.5)
    if n == "SPPF":
        return M.SPPF(a[0], a[1], k=a[2] if len(a) > 2 else 5)
    if n == "C2PSA":
        return M.C2PSA(a[0], a[1], n=a[2], e=a[3] if len(a) > 3 else 0.5)
    if n in ("nn.Upsample", "Upsample"):  # [None, 2, "nearest"]
        return M.Upsample(scale=int(a[1]), mode=a[2] if len(a) > 2 else "nearest")
    if n == "Concat":
        return M.Concat()
    if n == "Detect":
        if legacy:
            raise KeyError(f"the v8-era Detect head (layer {ls.i}) is not ported yet")
        return M.Detect(nc=a[0], ch=tuple(a[-1]), strides=strides)
    if n == "BiFPN_Concat":
        return fce.BiFPN_Concat(c1=tuple(a[0]), c2=a[1])
    if n == "BiCoordCrossAtt":
        return fce.BiCoordCrossAtt(inp=a[0], oup=a[1], reduction=a[2], num_heads=a[3])
    raise KeyError(f"module {n!r} at layer {ls.i} is not ported yet")


class DetectionModel(nn.Module):
    """Config-defined detection graph (reference DetectionModel, nn/tasks.py:339-490).

    ``forward`` returns the Detect head's dict: ``{"feats"}`` in training
    mode, ``{"preds", "feats"}`` in eval mode (preds (B, N, 4 + nc), xywh
    pixels + class scores).
    """

    def __init__(self, spec: ModelSpec, strides: tuple[int, ...] | None = None):
        super().__init__()
        self.spec = spec
        self.strides = strides
        self.model = nn.ModuleList(make_layer(ls, strides, legacy=spec.legacy) for ls in spec.layers)

    @property
    def detect(self) -> M.Detect:
        return self.model[-1]

    def forward(self, x: torch.Tensor, start_layer: int = 0) -> dict[str, Any]:
        """``start_layer > 0``: ``x`` is already the output of layer
        ``start_layer - 1`` (the fused stem computes layers 0..2); valid only
        when no skipped layer's output is consumed later."""
        saved: dict[int, torch.Tensor] = {}
        out: Any = x
        if start_layer > 0:
            if any(i in self.spec.save for i in range(start_layer - 1)):
                raise ValueError("start_layer skips layers whose outputs are consumed later")
            if start_layer - 1 in self.spec.save:
                saved[start_layer - 1] = x
        for ls, layer in zip(self.spec.layers, self.model):
            if ls.i < start_layer:
                continue
            if ls.is_multi_input:  # negative indices are relative (tasks.py:1738)
                inp = [out if j == -1 else saved[j % ls.i] for j in ls.f]
            else:
                inp = out if ls.f == -1 else saved[ls.f % ls.i]
            out = layer(inp)
            if ls.i in self.spec.save:
                saved[ls.i] = out
        return out


def resolve_strides(spec: ModelSpec, probe: int = 256) -> tuple[int, ...]:
    """Per-level strides from a training-mode forward on the ``meta`` device."""
    with torch.device("meta"):
        model = DetectionModel(spec, strides=None)
        feats = model(torch.empty(1, 3, probe, probe))["feats"]
    return tuple(probe // f.shape[2] for f in feats)


def build_model(
    cfg: str | Path | dict,
    scale: str | None = None,
    device: torch.device | str = "cpu",
) -> tuple[DetectionModel, ModelSpec, tuple[int, ...]]:
    """Parse, probe strides, and build the decode-capable model on ``device``
    in eval mode, channels_last. Returns (model, spec, strides). Weights are
    torch's defaults until ``init_weights`` or a weight load."""
    if isinstance(cfg, dict):
        spec = parse_model_yaml(dict(cfg), ch=3, scale=scale)
    else:
        spec = load_model_yaml(cfg, scale=scale)
    strides = resolve_strides(spec)
    model = DetectionModel(spec, strides).to(device=device, memory_format=torch.channels_last)
    return model.eval(), spec, strides


def _lecun_normal(shape: torch.Size, generator: torch.Generator) -> torch.Tensor:
    """flax's default conv kernel init: truncated normal (+-2 std), variance 1/fan_in."""
    fan_in = math.prod(shape[1:])
    std = math.sqrt(1.0 / fan_in) / 0.87962566103423978  # std of N(0,1) cut at +-2
    out = torch.empty(shape, dtype=torch.float32)
    return nn.init.trunc_normal_(out, 0.0, std, -2 * std, 2 * std, generator=generator)


@torch.no_grad()
def init_weights(model: DetectionModel, generator: torch.Generator, bias_prior: bool = True) -> DetectionModel:
    """Initialize like the JAX ``init_variables`` (nn/model.py:366-388): conv
    kernels lecun-normal, conv biases 0, BN (1, 0, mean 0, var 1), BiFPN
    weights 1, then the Detect bias priors when ``bias_prior``. Values are
    drawn on the CPU from ``generator`` (a CPU generator) so one seed gives
    the same weights on every device."""
    for m in model.modules():
        if isinstance(m, nn.Conv2d):
            m.weight.copy_(_lecun_normal(m.weight.shape, generator))
            if m.bias is not None:
                m.bias.zero_()
        elif isinstance(m, nn.BatchNorm2d):
            m.reset_parameters()
        elif isinstance(m, fce.BiFPN_Concat):
            m.w.fill_(1.0)
    if bias_prior:
        model.detect.bias_init()
    return model


@torch.no_grad()
def fold_conv_bn(model: nn.Module) -> nn.Module:
    """Fold every ConvBNAct's BatchNorm into its conv, in place (reference
    ``Model.fuse``): weight' = weight * g/std, bias' = beta - mean * g/std,
    bn -> Identity. The math runs in float32 and the results keep the conv
    weight's dtype (the JAX fold, nn/model.py:460-468, always emits f32).
    Idempotent: folded modules are skipped."""
    for m in model.modules():
        if isinstance(m, M.ConvBNAct) and not m.folded:
            conv, bn = m.conv, m.bn
            dtype = conv.weight.dtype
            g_std = bn.weight.float() / torch.sqrt(bn.running_var.float() + bn.eps)
            conv.weight.copy_((conv.weight.float() * g_std[:, None, None, None]).to(dtype))
            conv.bias = nn.Parameter((bn.bias.float() - bn.running_mean.float() * g_std).to(dtype))
            m.bn = nn.Identity()
    return model
