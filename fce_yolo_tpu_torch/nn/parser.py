"""Model-config dict -> graph spec (reference ``fce_yolo_tpu/nn/parser.py:39-300``).

Same semantics as the reference's ``parse_model_yaml`` for the modules the
port builds: depth/width/max_channels compound scaling, per-module channel
inference, the forced ``c3k`` at m/l/x, the FCE argument rewriting and the
savelist. Branches for modules the port does not build yet are left out;
their layers fall through to the generic channel rule and ``make_layer``
refuses them by name.
"""

from __future__ import annotations

from dataclasses import dataclass, field
from pathlib import Path
from typing import Any

from fce_yolo_tpu_torch.cfg.models import load_model_dict
from fce_yolo_tpu_torch.ops.boxes import make_divisible

# modules whose first config arg is the output-channel count, with the
# standard (c1, c2, ...) signature (reference tasks.py:1524-1561)
_BASE = {
    "Conv", "Conv2", "DWConv", "ConvTranspose", "nn.ConvTranspose2d", "GhostConv",
    "Focus", "Bottleneck", "GhostBottleneck", "SPP", "SPPF", "C2PSA", "C2fPSA",
    "BottleneckCSP", "C1", "C2", "C2f", "C3", "C3k", "C3k2", "C3x", "C3Ghost",
    "RepC3", "RepNCSPELAN4", "ELAN1", "ADown", "AConv", "SPPELAN", "PSA",
    "SCDown", "C2fCIB", "A2C2f", "C2fAttn",
}
# modules with an insertable repeat count (reference tasks.py:1563-1580)
_REPEAT = {
    "BottleneckCSP", "C1", "C2", "C2f", "C3", "C3k", "C3k2", "C3x", "C3Ghost",
    "RepC3", "C2fPSA", "C2fCIB", "C2PSA", "A2C2f", "C2fAttn",
}


@dataclass
class LayerSpec:
    """One node of the model graph."""

    i: int  # layer index
    f: int | list[int]  # input layer index/indices (-1 = previous)
    name: str  # module registry name
    args: list[Any]  # resolved constructor args (reference convention)
    c2: int  # output channels
    n: int = 1  # resolved repeat count (already baked into args for _REPEAT)
    is_multi_input: bool = False


@dataclass
class ModelSpec:
    layers: list[LayerSpec]
    save: list[int]  # indices whose outputs later layers consume
    nc: int
    ch_out: list[int]
    scale: str
    yaml_dict: dict = field(default_factory=dict)
    legacy: bool = False  # v8-era Detect cls branch (reference tasks.py:1504)


def _adaptive_reduction(inp: int) -> int:
    """Default reduction = sqrt(inp) clamped to [8, 32] (tasks.py:1646-1652)."""
    return max(8, min(32, int(inp**0.5)))


def _adaptive_heads(inp: int, reduction: int) -> int:
    """Default heads: <=8, >=1, each head >=8 channels (tasks.py:1665-1678)."""
    base_dim = max(8, inp // reduction)
    num_heads = max(1, min(8, inp // 32))
    while num_heads > 1 and base_dim // num_heads < 8:
        num_heads -= 1
    return num_heads


def parse_model_yaml(d: dict, ch: int = 3, scale: str | None = None) -> ModelSpec:
    """Parse a model-config dict into a :class:`ModelSpec`.

    ``scale`` defaults to the dict's ``scale`` entry or the first key of
    ``scales``.
    """
    nc = d.get("nc", 80)
    scales = d.get("scales")
    depth, width, max_channels = 1.0, 1.0, float("inf")
    scale = scale or d.get("scale")
    if scales:
        if not scale:
            scale = next(iter(scales.keys()))
        depth, width, max_channels = scales[scale]
    scale = scale or ""

    ch_list = [ch]
    layers: list[LayerSpec] = []
    save: list[int] = []
    legacy = True  # flips False when a modern block appears (tasks.py:1607)

    for i, (f, n, name, args) in enumerate(d["backbone"] + d["head"]):
        args = list(args)
        for j, a in enumerate(args):  # the reference's literal_eval pass
            if isinstance(a, str):
                if a == "nc":
                    args[j] = nc
                elif a in ("None", "none"):
                    args[j] = None
                elif a in ("True", "False"):
                    args[j] = a == "True"
        n_rep = max(round(n * depth), 1) if n > 1 else n

        if name in _BASE:
            c1, c2 = ch_list[f], args[0]
            if c2 != nc:
                c2 = make_divisible(min(c2, max_channels) * width, 8)
            args = [c1, c2, *args[1:]]
            if name in _REPEAT:
                args.insert(2, n_rep)
                n_rep = 1
            if name == "C3k2":
                legacy = False
                if scale in "mlx":  # force c3k=True for m/l/x (tasks.py:1611-1614)
                    while len(args) < 4:
                        args.append(False)
                    args[3] = True
        elif name == "Concat":
            c2 = sum(ch_list[x] for x in f)
        elif name == "BiFPN_Concat":
            c1 = [ch_list[x] for x in f] if isinstance(f, list) else [ch_list[f]]
            c2 = args[0] if args else max(c1)
            c2 = make_divisible(min(c2, max_channels) * width, 8)
            args = [c1, c2]
        elif name in ("CoordAtt", "CoordCrossAtt", "BiCoordCrossAtt"):
            inp = ch_list[f]
            oup = args[0] if args else inp
            if args:
                oup = make_divisible(min(oup, max_channels) * width, 8)
            reduction = args[1] if len(args) > 1 else _adaptive_reduction(inp)
            if name == "CoordAtt":
                args = [inp, oup, reduction]
            else:
                heads = args[2] if len(args) > 2 else _adaptive_heads(inp, reduction)
                args = [inp, oup, reduction, heads]
            c2 = oup
        elif name == "Detect":
            args = [*args, [ch_list[x] for x in f]]
            c2 = ch_list[f[-1]]
        elif name in ("nn.Upsample", "Upsample"):
            c2 = ch_list[f]
        else:
            c2 = ch_list[f] if isinstance(f, int) else ch_list[f[-1]]

        layers.append(LayerSpec(i=i, f=f, name=name, args=args, c2=c2, n=n_rep,
                                is_multi_input=isinstance(f, list)))
        save.extend(x % i for x in ([f] if isinstance(f, int) else f) if x != -1)
        if i == 0:
            ch_list = []
        ch_list.append(c2)

    return ModelSpec(layers=layers, save=sorted(set(save)), nc=nc, ch_out=ch_list,
                     scale=scale, yaml_dict=d, legacy=legacy)


def load_model_yaml(name: str | Path, scale: str | None = None) -> ModelSpec:
    """Parse a packaged model name (``yolo11s-fce.yaml``) or a config file path."""
    d, guessed = load_model_dict(name)
    return parse_model_yaml(d, ch=3, scale=scale or guessed)
