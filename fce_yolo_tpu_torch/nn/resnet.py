"""torchvision's ResNet trunks and the YAML ``TorchVision`` layer (reference
``fce_yolo_tpu/nn/resnet.py:46-138``; Ultralytics block.py:1554).

``yolo11-cls-resnet18.yaml`` takes ``[512, resnet18, DEFAULT, True, 2]``:
the resnet18 trunk with avgpool and fc cut off. The card machine has no
torchvision, so resnet18, resnet34 and resnet50 are written out here with
torchvision's architecture and ``state_dict`` keys (``conv1.weight``,
``bn1.*``, ``layer{i}.{j}.conv{k}.weight``, ``layer{i}.{j}.downsample.{0,1}.*``),
so a torchvision state dict loads into ``ResNetTrunk`` unchanged. The
``"DEFAULT"`` weights are random here: nothing is downloaded.

The BatchNorms take torchvision's constants, eps 1e-5 and momentum 0.1
(flax's 0.9), not YOLO's 1e-3 and 0.03; they are the port's ``BatchNorm2d``
(flax's biased running variance). ``fold_conv_bn`` leaves them as they are,
as the JAX fold does.
"""

from __future__ import annotations

import torch
import torch.nn.functional as F
from torch import nn

from fce_yolo_tpu_torch.nn.modules import BatchNorm2d

__all__ = ["BasicBlock", "BottleneckBlock", "ResNetTrunk", "TorchVision", "RESNET_DEPTHS"]

# variant -> (block kind, stage depths, expansion)
RESNET_DEPTHS = {
    "resnet18": ("basic", (2, 2, 2, 2), 1),
    "resnet34": ("basic", (3, 4, 6, 3), 1),
    "resnet50": ("bottleneck", (3, 4, 6, 3), 4),
}
BN_EPS, BN_MOMENTUM = 1e-5, 0.1  # torchvision's


def _conv(c1: int, c2: int, k: int, s: int) -> nn.Conv2d:
    return nn.Conv2d(c1, c2, k, s, (k - 1) // 2, bias=False)


def _bn(c: int) -> BatchNorm2d:
    return BatchNorm2d(c, eps=BN_EPS, momentum=BN_MOMENTUM)


def _downsample(c1: int, c2: int, s: int) -> nn.Sequential | None:
    return nn.Sequential(_conv(c1, c2, 1, s), _bn(c2)) if s != 1 or c1 != c2 else None


class BasicBlock(nn.Module):
    """torchvision's BasicBlock: 3x3 (stride s) -> 3x3, plus the identity or
    a 1x1 downsample, then ReLU."""

    def __init__(self, c1: int, c2: int, s: int = 1):
        super().__init__()
        self.conv1, self.bn1 = _conv(c1, c2, 3, s), _bn(c2)
        self.conv2, self.bn2 = _conv(c2, c2, 3, 1), _bn(c2)
        self.downsample = _downsample(c1, c2, s)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        y = self.bn2(self.conv2(F.relu(self.bn1(self.conv1(x)))))
        return F.relu(y + (x if self.downsample is None else self.downsample(x)))


class BottleneckBlock(nn.Module):
    """torchvision's Bottleneck (v1.5: the stride on the 3x3): 1x1 -> 3x3 ->
    1x1 to 4 * c2, plus the identity or a 1x1 downsample, then ReLU."""

    def __init__(self, c1: int, c2: int, s: int = 1):
        super().__init__()
        c3 = c2 * 4
        self.conv1, self.bn1 = _conv(c1, c2, 1, 1), _bn(c2)
        self.conv2, self.bn2 = _conv(c2, c2, 3, s), _bn(c2)
        self.conv3, self.bn3 = _conv(c2, c3, 1, 1), _bn(c3)
        self.downsample = _downsample(c1, c3, s)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        y = F.relu(self.bn1(self.conv1(x)))
        y = F.relu(self.bn2(self.conv2(y)))
        y = self.bn3(self.conv3(y))
        return F.relu(y + (x if self.downsample is None else self.downsample(x)))


class ResNetTrunk(nn.Module):
    """conv1 7x7 s2 / bn1 / ReLU / 3x3 s2 max pool, then four stages of
    blocks (the first block of stages 2-4 at stride 2); the output is stage
    4's map (torchvision's resnet with avgpool and fc cut off)."""

    def __init__(self, variant: str = "resnet18", c1: int = 3):
        super().__init__()
        kind, depths, expansion = RESNET_DEPTHS[variant]
        block = BasicBlock if kind == "basic" else BottleneckBlock
        self.conv1, self.bn1 = _conv(c1, 64, 7, 2), _bn(64)
        c = 64
        for stage, n in enumerate(depths):
            c2 = 64 * 2**stage
            blocks = []
            for j in range(n):
                blocks.append(block(c, c2, 2 if stage > 0 and j == 0 else 1))
                c = c2 * expansion
            setattr(self, f"layer{stage + 1}", nn.Sequential(*blocks))

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        x = F.max_pool2d(F.relu(self.bn1(self.conv1(x))), 3, 2, 1)
        return self.layer4(self.layer3(self.layer2(self.layer1(x))))


class TorchVision(nn.Module):
    """The YAML's ``TorchVision`` layer, (c2, model, weights, unwrap,
    truncate, split) as the reference takes them: the trunk form
    (unwrap=True, truncate=2, split=False) of resnet18, resnet34 or
    resnet50, as ``m``; any other model or form raises, as the JAX layer
    does. ``weights`` is taken and ignored: the weights start random."""

    def __init__(self, c2: int, model: str = "resnet18", weights: str = "DEFAULT", unwrap: bool = True,
                 truncate: int = 2, split: bool = False):
        super().__init__()
        if model not in RESNET_DEPTHS:
            raise NotImplementedError(f"TorchVision passthrough supports {sorted(RESNET_DEPTHS)}, got {model!r}")
        if not unwrap or truncate != 2 or split:
            raise NotImplementedError("TorchVision passthrough supports the trunk form only "
                                      "(unwrap=True, truncate=2, split=False)")
        self.m = ResNetTrunk(model)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return self.m(x)
