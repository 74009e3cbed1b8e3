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
from fce_yolo_tpu_torch.nn import heads as H
from fce_yolo_tpu_torch.nn import modules as M
from fce_yolo_tpu_torch.nn import resnet
from fce_yolo_tpu_torch.nn import world as W
from fce_yolo_tpu_torch.nn import yoloe as Y
from fce_yolo_tpu_torch.nn.parser import LayerSpec, ModelSpec, load_model_yaml, parse_model_yaml
from fce_yolo_tpu_torch.nn.transformer import AIFI, MSDeformAttn, TorchMHA

TEXT_DIM = 512  # the text embeddings' width (CLIP's projection)


# layers built positionally from the parsed args (the JAX ``_POSITIONAL`` table, nn/model.py:29-65)
_POSITIONAL: dict[str, Any] = {
    "Bottleneck": M.Bottleneck, "C2": M.C2, "GhostConv": M.GhostConv, "GhostBottleneck": M.GhostBottleneck,
    "C3Ghost": M.C3Ghost, "SPP": M.SPP, "ResNetLayer": M.ResNetLayer, "RepNCSPELAN4": M.RepNCSPELAN4,
    "ELAN1": M.ELAN1, "AConv": M.AConv, "ADown": M.ADown, "SPPELAN": M.SPPELAN, "CBLinear": M.CBLinear,
    "CBFuse": M.CBFuse, "A2C2f": M.A2C2f, "nn.MaxPool2d": M.MaxPool2d, "nn.ZeroPad2d": M.ZeroPad2d,
    "nn.Identity": nn.Identity, "nn.ConvTranspose2d": M.ConvTranspose2d, "RepVGGDW": M.RepVGGDW, "CIB": M.CIB,
    "C2fCIB": M.C2fCIB, "PSA": M.PSA, "SCDown": M.SCDown, "TorchVision": resnet.TorchVision,
    "LightConv": M.LightConv,
}
# layers the port refuses, by the item of ROADMAP queue 1 that ports them
_LATER: dict[str, str] = {
    **dict.fromkeys(("C1", "C3x", "Focus", "Conv2", "ConvTranspose", "BottleneckCSP", "C3TR", "CBAM",
                     "ChannelAttention", "SpatialAttention", "Index", "C2fPSA", "AGLU",
                     "DWConvTranspose2d"), "7.2"),
}


def make_layer(ls: LayerSpec, strides: tuple[int, ...] | None, legacy: bool = False) -> nn.Module:
    """Instantiate the module for one LayerSpec (reference-arg convention);
    ``legacy`` builds the v8-era heads."""
    a, n = ls.args, ls.name
    if n == "Conv":  # (c1, c2, k=1, s=1, p=None, g=1, d=1, act=True)
        return M.ConvBNAct(a[0], a[1], *a[2:8])
    if n == "DWConv":  # (c1, c2, k=1, s=1, d=1, act=True), Ultralytics' signature (queue 3, item 33)
        return M.DWConvBNAct(a[0], a[1], *a[2:6])
    if n == "C3k2":
        return M.C3k2(a[0], a[1], n=a[2], c3k=a[3] if len(a) > 3 else False,
                      e=a[4] if len(a) > 4 else 0.5)
    if n == "C3":
        return M.C3(a[0], a[1], a[2], shortcut=a[3] if len(a) > 3 else True)
    if n == "C2f":
        return M.C2f(a[0], a[1], n=a[2], shortcut=a[3] if len(a) > 3 else False)
    if n == "SPPF":
        return M.SPPF(a[0], a[1], k=a[2] if len(a) > 2 else 5)
    if n == "C2PSA":
        return M.C2PSA(a[0], a[1], n=a[2], e=a[3] if len(a) > 3 else 0.5)
    if n in ("nn.Upsample", "Upsample"):  # [None, 2, "nearest"]
        return M.Upsample(scale=int(a[1]), mode=a[2] if len(a) > 2 else "nearest")
    if n == "Concat":
        return M.Concat()
    if n == "Detect":
        return M.Detect(nc=a[0], ch=tuple(a[-1]), strides=strides, legacy=legacy)
    if n == "Segment":  # [nc, nm, npr, ch]
        return H.Segment(nc=a[0], nm=a[1] if len(a) > 2 else 32, npr=a[2] if len(a) > 3 else 256,
                         ch=tuple(a[-1]), strides=strides, legacy=legacy)
    if n == "Pose":  # [nc, kpt_shape, ch]
        return H.Pose(nc=a[0], kpt_shape=tuple(a[1]), ch=tuple(a[-1]), strides=strides, legacy=legacy)
    if n == "OBB":  # [nc, ne, ch]
        return H.OBB(nc=a[0], ne=a[1] if len(a) > 2 else 1, ch=tuple(a[-1]), strides=strides, legacy=legacy)
    if n == "BiFPN_Concat":
        return fce.BiFPN_Concat(c1=tuple(a[0]), c2=a[1])
    if n == "v10Detect":
        return H.V10Detect(nc=a[0], ch=tuple(a[-1]), strides=strides)
    if n == "BiCoordCrossAtt":
        return fce.BiCoordCrossAtt(inp=a[0], oup=a[1], reduction=a[2], num_heads=a[3])
    if n == "CoordAtt":
        return fce.CoordAtt(inp=a[0], oup=a[1], reduction=a[2])
    if n == "CoordCrossAtt":
        return fce.CoordCrossAtt(inp=a[0], oup=a[1], reduction=a[2], num_heads=a[3])
    if n == "RepC3":  # (c1, c2, n, e)
        return M.RepC3(a[0], a[1], a[2], e=a[3] if len(a) > 3 else 1.0)
    if n == "HGStem":  # (c1, cm, c2)
        return M.HGStem(a[0], a[1], a[2])
    if n == "HGBlock":  # (c1, cm, c2, k, n, lightconv, shortcut)
        return M.HGBlock(*a[:7])
    if n == "AIFI":  # (c1, cm, num_heads)
        return AIFI(a[0], a[1] if len(a) > 1 else 2048, a[2] if len(a) > 2 else 8)
    if n == "RTDETRDecoder":  # [nc, ch, hd, nq, ndl]: the extras size the JAX tests' tiny heads
        return H.RTDETRDecoder(nc=a[0], ch=tuple(a[1]), hd=a[2] if len(a) > 2 else 256,
                               nq=a[3] if len(a) > 3 else 300, ndl=a[4] if len(a) > 4 else 6)
    if n == "C2fAttn":  # (c1, c2, n, ec, nh, gc)
        return W.C2fAttn(a[0], a[1], n=a[2], ec=a[3], nh=a[4], gc=a[5] if len(a) > 5 else 512)
    if n == "ImagePoolingAttn":  # (ec, ch, ct, nh, k, scale)
        return W.ImagePoolingAttn(a[0], tuple(a[1]), *a[2:6])
    if n == "WorldDetect":  # [nc, embed, with_bn, ch]
        return W.WorldDetect(nc=a[0], embed=a[1] if len(a) > 2 else 512, with_bn=a[2] if len(a) > 3 else False,
                             ch=tuple(a[-1]), strides=strides)
    if n == "YOLOEDetect":  # [nc, embed, with_bn, ch]
        return Y.YOLOEDetect(nc=a[0], embed=a[1] if len(a) > 2 else 512, with_bn=a[2] if len(a) > 3 else True,
                             ch=tuple(a[-1]), strides=strides)
    if n == "YOLOESegment":  # [nc, nm, npr, embed, with_bn, ch]
        return Y.YOLOESegment(nc=a[0], nm=a[1] if len(a) > 2 else 32, npr=a[2] if len(a) > 3 else 256,
                              embed=a[3] if len(a) > 4 else 512, with_bn=a[4] if len(a) > 5 else True,
                              ch=tuple(a[-1]), strides=strides)
    if n == "Classify":  # [c1, c2, k, s]
        return H.Classify(a[0], a[1], k=a[2] if len(a) > 2 else 1, s=a[3] if len(a) > 3 else 1)
    if n in _POSITIONAL:
        return _POSITIONAL[n](*(tuple(x) if isinstance(x, list) else x for x in a))
    where = f" (ROADMAP queue 1, item {_LATER[n]})" if n in _LATER else ""
    raise KeyError(f"module {n!r} at layer {ls.i} is not ported yet{where}")


class DetectionModel(nn.Module):
    """Config-defined detection graph (reference DetectionModel, nn/tasks.py:339-490).

    ``forward`` returns the head's dict: for Detect ``{"feats"}`` in training
    mode, ``{"preds", "feats"}`` in eval mode (preds (B, N, 4 + nc), xywh
    pixels + class scores); a task head (``nn/heads.py``) adds its own keys,
    V10Detect gives ``{"feats", "one2one_feats"}`` / ``{"preds6", "feats",
    "one2one_feats"}``, and Classify ``{"logits"}`` / ``{"probs", "logits"}``.

    An open-vocabulary graph (``spec.needs_text``: YOLO-World, YOLOE) holds
    the text it scores against in the buffer ``txt_feats`` (1 or B, K,
    512), zeros (1, nc, 512) until a facade binds its classes (as the JAX
    graph's default, nn/model.py:277-281). The buffer is not saved with the
    weights; ``deepcopy`` and ``fold_conv_bn`` keep it, so every engine path
    (the predictor's stem kernel path too) scores against the bound text
    without being told of it.
    """

    def __init__(self, spec: ModelSpec, strides: tuple[int, ...] | None = None):
        super().__init__()
        self.spec = spec
        self.strides = strides
        self.model = nn.ModuleList(make_layer(ls, strides, legacy=spec.legacy) for ls in spec.layers)
        if spec.needs_text:
            self.register_buffer("txt_feats", torch.zeros(1, spec.nc, TEXT_DIM), persistent=False)

    @property
    def detect(self) -> M.Detect | H.Classify:
        """The head: a Detect, a task head built on one, or Classify."""
        return self.model[-1]

    @property
    def task(self) -> str:
        return self.spec.task

    def forward(self, x: torch.Tensor, start_layer: int = 0, txt_feats: torch.Tensor | None = None,
                **head_kw: Any) -> dict[str, Any]:
        """``start_layer > 0``: ``x`` is already the output of layer
        ``start_layer - 1`` (the fused stem computes layers 0..2); valid only
        when no skipped layer's output is consumed later. ``head_kw`` goes to
        the head, the last layer (an RT-DETR head's denoising queries ``dn``
        in training, a YOLOE head's ``visual_prompts``; reference
        nn/model.py:306-310). ``txt_feats`` (1 or B, K, 512) replaces the
        bound text for this call (a multimodal train batch's sampled texts).
        Text threads as in the JAX graph (nn/model.py:283-300): C2fAttn
        takes the running text, ImagePoolingAttn updates it and passes the
        previous layer's output on, the head takes the text as given."""
        head_i = self.spec.layers[-1].i
        saved: dict[int, torch.Tensor] = {}
        txt = txt0 = None
        if self.spec.needs_text:
            t = self.txt_feats if txt_feats is None else txt_feats
            txt = txt0 = t.to(x.dtype).expand(x.shape[0], -1, -1) if t.shape[0] == 1 else t.to(x.dtype)
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
            if ls.name == "C2fAttn":
                out = layer(inp, txt)
            elif ls.name == "ImagePoolingAttn":
                txt = layer(inp, txt)
            elif ls.i == head_i:
                out = layer(inp, txt0, **head_kw) if txt0 is not None else layer(inp, **head_kw)
            else:
                out = layer(inp)
            if ls.i in self.spec.save:
                saved[ls.i] = out
        return out


def resolve_strides(spec: ModelSpec, probe: int = 256) -> tuple[int, ...]:
    """Per-level strides from a forward on the ``meta`` device, the head in
    training mode (raw maps, no decode) and the rest in eval mode (the meta
    device runs a training BatchNorm several times slower); none for a
    classifier (reference ``resolve_strides``, nn/model.py:318-321)."""
    if spec.task == "classify":
        return ()
    if spec.task == "rtdetr":  # the normalized-box head needs none; P3-P5 (reference nn/model.py:322-325)
        return (8, 16, 32)
    with torch.device("meta"):
        model = DetectionModel(spec, strides=None).eval()
        model.detect.train()
        feats = model(torch.empty(1, 3, probe, probe))["feats"]
    return tuple(probe // f.shape[2] for f in feats)


def build_model(
    cfg: str | Path | dict,
    scale: str | None = None,
    device: torch.device | str = "cuda",
) -> tuple[DetectionModel, ModelSpec, tuple[int, ...]]:
    """Parse, probe strides, and build the decode-capable model on ``device``
    in eval mode, channels_last. Returns (model, spec, strides). Weights are
    torch's defaults, drawn on ``device`` (nothing drawn on ``meta``), until
    ``init_weights`` or a weight load. The model goes
    to the card unless the caller names another device; without CUDA that
    raises rather than falling back to the CPU."""
    device = torch.device(device)
    if device.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError("build_model: CUDA is not available; pass device='cpu' to build on the CPU")
    if isinstance(cfg, dict):
        spec = parse_model_yaml(dict(cfg), ch=3, scale=scale)
    else:
        spec = load_model_yaml(cfg, scale=scale)
    strides = resolve_strides(spec)
    with device:
        model = DetectionModel(spec, strides)
    return model.to(memory_format=torch.channels_last).eval(), spec, strides


def _lecun_normal(shape: torch.Size, generator: torch.Generator) -> torch.Tensor:
    """flax's default conv kernel init: truncated normal (+-2 std), variance 1/fan_in."""
    fan_in = math.prod(shape[1:])
    std = math.sqrt(1.0 / fan_in) / 0.87962566103423978  # std of N(0,1) cut at +-2
    out = torch.empty(shape, dtype=torch.float32)
    return nn.init.trunc_normal_(out, 0.0, std, -2 * std, 2 * std, generator=generator)


def _xavier_uniform(shape: torch.Size, generator: torch.Generator) -> torch.Tensor:
    """flax's ``xavier_uniform`` of a 2-D parameter: U(+-sqrt(6 / (fan_in + fan_out)))."""
    bound = math.sqrt(6.0 / (shape[0] + shape[1]))
    return torch.empty(shape).uniform_(-bound, bound, generator=generator)


@torch.no_grad()
def init_weights(model: DetectionModel, generator: torch.Generator, bias_prior: bool = True) -> DetectionModel:
    """Initialize like the JAX ``init_variables`` (nn/model.py:366-388): conv
    and dense kernels lecun-normal, their biases 0, BN (1, 0, mean 0, var 1), BiFPN
    weights 1, A2C2f's ``gamma`` 0.01, LayerNorm (1, 0), RT-DETR's attention
    projections xavier-uniform, MSDeformAttn's offset and weight kernels 0
    with the direction grid as the offsets' bias, the denoising table N(0, 1),
    YOLOE's ``reprta`` output layer 0 (the JAX ``SwiGLUFFN``'s zero-init
    ``w3``), then the Detect bias priors when ``bias_prior`` (on a Detect
    or a task head's Detect trunk only, not on V10Detect, as the JAX package does). Values are
    drawn on the CPU from ``generator`` (a CPU generator) so one seed gives
    the same weights on every device."""
    for m in model.modules():
        if isinstance(m, (nn.Conv2d, nn.ConvTranspose2d, nn.Linear)):
            if isinstance(m, nn.ConvTranspose2d):  # (in, out, kh, kw): the fan-in is in * kh * kw
                m.weight.copy_(_lecun_normal(m.weight.transpose(0, 1).shape, generator).transpose(0, 1))
            else:
                m.weight.copy_(_lecun_normal(m.weight.shape, generator))
            if m.bias is not None:
                m.bias.zero_()
        elif isinstance(m, nn.BatchNorm2d):
            m.reset_parameters()
        elif isinstance(m, fce.BiFPN_Concat):
            m.w.fill_(1.0)
        elif isinstance(m, M.A2C2f) and m.gamma is not None:
            m.gamma.fill_(0.01)
        elif isinstance(m, nn.LayerNorm):
            m.reset_parameters()
    for m in model.modules():  # RT-DETR's leaves after the generic pass over their Linears
        if isinstance(m, TorchMHA):  # xavier-uniform projections, zero biases (transformer.py:38-52)
            m.in_proj_weight.copy_(_xavier_uniform(m.in_proj_weight.shape, generator))
            m.out_proj.weight.copy_(_xavier_uniform(m.out_proj.weight.shape, generator))
            m.in_proj_bias.zero_()
            m.out_proj.bias.zero_()
        elif isinstance(m, MSDeformAttn):
            m.reset_offsets()
        elif isinstance(m, H.RTDETRDecoder):
            m.denoising_class_embed.weight.copy_(torch.randn(m.denoising_class_embed.weight.shape,
                                                             generator=generator))
        elif isinstance(m, Y.Residual):
            m.reset_w3()
    if bias_prior and isinstance(model.detect, M.Detect) and not isinstance(model.detect, H.V10Detect):
        model.detect.bias_init()
    return model


@torch.no_grad()
def fold_conv_bn(model: nn.Module) -> nn.Module:
    """Fold every ConvBNAct's BatchNorm into its conv, in place (reference
    ``Model.fuse``): weight' = weight * g/std, bias' = beta - mean * g/std,
    bn -> Identity. The math runs in float32 and the results keep the conv
    weight's dtype (the JAX fold, nn/model.py:460-468, always emits f32).
    RepConv's two branches are ConvBNActs and fold each on its own, as in the
    JAX fold; they are not merged into one conv; so are RepVGGDW's. The ResNet
    trunk's BatchNorms (``nn/resnet.py``) stay, as in the JAX fold.
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


def is_folded(model: nn.Module) -> bool:
    """Whether ``fold_conv_bn`` has folded ``model`` (its BatchNorms are gone)."""
    return any(m.folded for m in model.modules() if isinstance(m, M.ConvBNAct))


def weights_version(model: nn.Module) -> tuple | None:
    """A key that changes whenever a parameter or buffer of ``model`` is
    replaced (a load, a move, a fold) or written in place (a training step):
    each tensor's storage and version counter. None when one is an inference
    tensor, which keeps no version counter."""
    tensors = [*model.parameters(), *model.buffers()]
    if any(t.is_inference() for t in tensors):
        return None
    return tuple((t.data_ptr(), t._version) for t in tensors)


def param_count(model: nn.Module) -> int:
    """Parameter count (reference ``param_count``, nn/model.py:391): every
    parameter tensor, the BatchNorm running statistics not included."""
    return sum(p.numel() for p in model.parameters())


def estimate_flops(model: DetectionModel, imgsz: int = 640, batch: int = 1) -> float:
    """FLOPs of one eval forward at ``imgsz`` (reference ``estimate_flops``,
    nn/model.py:397), counted by ``torch.utils.flop_counter.FlopCounterMode``
    on a copy of the graph on the ``meta`` device: shapes only, no memory,
    no arithmetic. A multiply-add counts 2; convolutions, matmuls and
    attention are counted, elementwise work is not."""
    from torch.utils.flop_counter import FlopCounterMode

    with torch.device("meta"):
        probe = DetectionModel(model.spec, model.strides).eval()
        x = torch.empty(batch, 3, imgsz, imgsz)
    counter = FlopCounterMode(display=False)
    with counter, torch.no_grad():
        probe(x)
    return float(counter.get_total_flops())
