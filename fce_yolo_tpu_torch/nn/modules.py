"""YOLO modules (reference ``fce_yolo_tpu/nn/modules.py``): the YOLO11 blocks
and the Detect head (``:87-593``), and the v3/v5/v6/v8, v9, v10, yolo12 and
ResNet blocks of the other YAMLs (``:700-1379``).

NCHW ``nn.Module``s; attribute names follow Ultralytics (``cv1``, ``m.0``,
``cv2.0.2``) so ``state_dict`` keys are ``model.{i}.<path>`` and the JAX
weight bridge (``nn/weights.py``) is a name rewrite. Where the JAX module
names a child ``m_{i}_{j}`` or ``conv_0``, the port nests ``nn.Sequential``s
(``m.{i}.{j}``, ``conv.0``). Convolutions pad
symmetrically (``autopad``), as torch and the reference do. BatchNorm uses
eps 1e-3 and momentum 0.03 (flax's 0.97), and flax's running variance.
"""

from __future__ import annotations

import math
from typing import Any, Sequence

import torch
import torch.nn.functional as F
from torch import nn

from fce_yolo_tpu_torch.ops.anchors import dfl_expectation, dist2bbox, make_anchors

BN_EPS = 1e-3
BN_MOMENTUM = 0.03


def autopad(k: int, p: int | None = None, d: int = 1) -> int:
    """'same'-shape padding for odd kernels (reference conv.py:30-36)."""
    if d > 1:
        k = d * (k - 1) + 1
    return k // 2 if p is None else p


def apply_act(x: torch.Tensor, act: Any) -> torch.Tensor:
    """True -> SiLU, a name ("relu", ...) -> that function, False/None -> identity."""
    if act is True:
        return F.silu(x)
    if isinstance(act, str):
        return getattr(F, act.lower())(x)
    return x


class BatchNorm2d(nn.BatchNorm2d):
    """``nn.BatchNorm2d`` whose training-mode running variance takes the
    biased batch variance, as flax's ``BatchNorm`` does (torch's takes the
    unbiased one, n / (n - 1) larger).

    In training mode ``F.batch_norm`` computes the batch statistics once, into
    scratch buffers (momentum 1), and normalises with them; the running
    statistics are then ``0.97 * running + 0.03 * batch`` with the variance
    scaled back by (n - 1) / n. On the CPU the input is made contiguous
    first: torch's CPU kernel sums a channels-last input in float32 (a
    contiguous one in float64), which on flat-colour images moves a float32
    train step's updates by per cents of the largest."""

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        if not self.training:
            return super().forward(x)
        if x.device.type == "cpu":
            x = x.contiguous()
        mean = torch.zeros_like(self.running_mean)
        var = torch.ones_like(self.running_var)
        y = F.batch_norm(x, mean, var, self.weight, self.bias, True, 1.0, self.eps)
        n = x.numel() // x.shape[1]
        with torch.no_grad():
            self.running_mean.mul_(1 - self.momentum).add_(mean, alpha=self.momentum)
            self.running_var.mul_(1 - self.momentum).add_(var, alpha=self.momentum * (n - 1) / n)
        return y


class ConvBNAct(nn.Module):
    """Conv2d(bias=False) + BatchNorm2d + SiLU: the reference's ``Conv`` (conv.py:39-91).

    ``fold_conv_bn`` (nn/model.py) turns it into the folded form: a biased
    conv and ``bn = nn.Identity()``.
    """

    def __init__(self, c1: int, c2: int, k: int = 1, s: int = 1, p: int | None = None,
                 g: int = 1, d: int = 1, act: Any = True):
        super().__init__()
        self.conv = nn.Conv2d(c1, c2, k, s, autopad(k, p, d), dilation=d, groups=g, bias=False)
        self.bn = BatchNorm2d(c2, eps=BN_EPS, momentum=BN_MOMENTUM)
        self.act = act

    @property
    def folded(self) -> bool:
        return isinstance(self.bn, nn.Identity)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return apply_act(self.bn(self.conv(x)), self.act)


def DWConvBNAct(c1: int, c2: int, k: int = 1, s: int = 1, d: int = 1, act: Any = True) -> ConvBNAct:
    """Depthwise Conv+BN+SiLU, groups = gcd(c1, c2) (reference ``DWConv``, conv.py:186-200),
    with Ultralytics' ``d`` and ``act``: a YAML's ``[c2, k, s, d, False]`` has no activation
    (ROADMAP queue 3, item 33: the JAX ``make_layer`` drops both and applies SiLU)."""
    return ConvBNAct(c1, c2, k, s, g=math.gcd(c1, c2), d=d, act=act)


def Conv2d(c1: int, c2: int, k: int = 1, s: int = 1) -> nn.Conv2d:
    """Plain biased conv with symmetric k//2 padding (the reference's bare ``nn.Conv2d``)."""
    return nn.Conv2d(c1, c2, k, s, k // 2, bias=True)


class Bottleneck(nn.Module):
    """Standard bottleneck (reference block.py:452-477)."""

    def __init__(self, c1: int, c2: int, shortcut: bool = True, g: int = 1,
                 k: tuple[int, int] = (3, 3), e: float = 0.5):
        super().__init__()
        c_ = int(c2 * e)
        self.cv1 = ConvBNAct(c1, c_, k[0], 1)
        self.cv2 = ConvBNAct(c_, c2, k[1], 1, g=g)
        self.add = shortcut and c1 == c2

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        y = self.cv2(self.cv1(x))
        return x + y if self.add else y


class C3(nn.Module):
    """CSP bottleneck with 3 convs (reference block.py:317-342); ``c3k_style``
    gives the inner blocks (k, k) kernels, as C3k does (block.py:1090-1107)."""

    def __init__(self, c1: int, c2: int, n: int = 1, shortcut: bool = True, g: int = 1,
                 e: float = 0.5, k: int = 3, c3k_style: bool = False):
        super().__init__()
        c_ = int(c2 * e)
        self.cv1 = ConvBNAct(c1, c_, 1, 1)
        self.cv2 = ConvBNAct(c1, c_, 1, 1)
        self.cv3 = ConvBNAct(2 * c_, c2, 1)
        kk = (k, k) if c3k_style else (1, 3)
        self.m = nn.Sequential(*(Bottleneck(c_, c_, shortcut, g, k=kk, e=1.0) for _ in range(n)))

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return self.cv3(torch.cat([self.m(self.cv1(x)), self.cv2(x)], dim=1))


def C3k(c1: int, c2: int, n: int = 2, shortcut: bool = True, g: int = 1) -> C3:
    """C3 with (3, 3) inner kernels (reference block.py:1090-1107)."""
    return C3(c1, c2, n, shortcut, g, c3k_style=True)


class C3k2(nn.Module):
    """C2f-style CSP block (reference block.py:1064-1088): cv1 splits in two
    halves, n inner blocks chain off the second, everything concats into cv2."""

    def __init__(self, c1: int, c2: int, n: int = 1, c3k: bool = False, e: float = 0.5,
                 g: int = 1, shortcut: bool = True):
        super().__init__()
        self.c = c = int(c2 * e)
        self.cv1 = ConvBNAct(c1, 2 * c, 1, 1)
        self.cv2 = ConvBNAct((2 + n) * c, c2, 1)
        self.m = nn.ModuleList(
            C3k(c, c, 2, shortcut, g) if c3k else Bottleneck(c, c, shortcut, g, k=(3, 3), e=0.5)
            for _ in range(n)
        )

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        ys = list(self.cv1(x).split((self.c, self.c), dim=1))
        for m in self.m:
            ys.append(m(ys[-1]))
        return self.cv2(torch.cat(ys, dim=1))


class C2f(nn.Module):
    """CSP bottleneck with 2 convs, the YOLOv8 block (reference block.py:283-316):
    C3k2's form with plain (3, 3) Bottlenecks of expansion 1."""

    def __init__(self, c1: int, c2: int, n: int = 1, shortcut: bool = False, g: int = 1, e: float = 0.5):
        super().__init__()
        self.c = c = int(c2 * e)
        self.cv1 = ConvBNAct(c1, 2 * c, 1, 1)
        self.cv2 = ConvBNAct((2 + n) * c, c2, 1)
        self.m = nn.ModuleList(Bottleneck(c, c, shortcut, g, k=(3, 3), e=1.0) for _ in range(n))

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        ys = list(self.cv1(x).split((self.c, self.c), dim=1))
        for m in self.m:
            ys.append(m(ys[-1]))
        return self.cv2(torch.cat(ys, dim=1))


class C2(nn.Module):
    """CSP bottleneck with 2 convs (reference block.py:256-282): the
    Bottlenecks run on the first half only."""

    def __init__(self, c1: int, c2: int, n: int = 1, shortcut: bool = True, g: int = 1, e: float = 0.5):
        super().__init__()
        self.c = c = int(c2 * e)
        self.cv1 = ConvBNAct(c1, 2 * c, 1, 1)
        self.cv2 = ConvBNAct(2 * c, c2, 1)
        self.m = nn.Sequential(*(Bottleneck(c, c, shortcut, g, k=(3, 3), e=1.0) for _ in range(n)))

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        a, b = self.cv1(x).split((self.c, self.c), dim=1)
        return self.cv2(torch.cat([self.m(a), b], dim=1))


class GhostConv(nn.Module):
    """Ghost convolution (reference conv.py:311-352): a primary conv to c2/2
    channels and a cheap depthwise 5x5 on its output, concatenated."""

    def __init__(self, c1: int, c2: int, k: int = 1, s: int = 1, g: int = 1, act: Any = True):
        super().__init__()
        c_ = c2 // 2
        self.cv1 = ConvBNAct(c1, c_, k, s, None, g, act=act)
        self.cv2 = ConvBNAct(c_, c_, 5, 1, None, c_, act=act)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        y = self.cv1(x)
        return torch.cat([y, self.cv2(y)], dim=1)


class GhostBottleneck(nn.Module):
    """Ghost bottleneck (reference block.py:424-451): GhostConv, a depthwise
    stride-2 conv when s == 2, GhostConv without activation, plus the
    shortcut (a depthwise + pointwise pair when s == 2)."""

    def __init__(self, c1: int, c2: int, k: int = 3, s: int = 1):
        super().__init__()
        c_ = c2 // 2
        self.conv = nn.Sequential(
            GhostConv(c1, c_, 1, 1),
            ConvBNAct(c_, c_, k, s, g=c_, act=False) if s == 2 else nn.Identity(),
            GhostConv(c_, c2, 1, 1, act=False),
        )
        self.shortcut = (nn.Sequential(ConvBNAct(c1, c1, k, s, g=c1, act=False), ConvBNAct(c1, c2, 1, 1, act=False))
                         if s == 2 else nn.Identity())

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return self.conv(x) + self.shortcut(x)


class C3Ghost(C3):
    """C3 with GhostBottleneck inner blocks (reference block.py:405-423)."""

    def __init__(self, c1: int, c2: int, n: int = 1, shortcut: bool = True, g: int = 1, e: float = 0.5):
        super().__init__(c1, c2, n, shortcut, g, e)
        c_ = int(c2 * e)
        self.m = nn.Sequential(*(GhostBottleneck(c_, c_) for _ in range(n)))


def max_pool_same(x: torch.Tensor, k: int) -> torch.Tensor:
    """k x k stride-1 max pool with symmetric k//2 padding (reference ``_max_pool_same``, modules.py:286)."""
    return F.max_pool2d(x, k, 1, k // 2)


class SPP(nn.Module):
    """Classic spatial pyramid pooling: parallel max pools of kernels ``k``
    (reference block.py:185-207)."""

    def __init__(self, c1: int, c2: int, k: Sequence[int] = (5, 9, 13)):
        super().__init__()
        c_ = c1 // 2
        self.cv1 = ConvBNAct(c1, c_, 1, 1)
        self.cv2 = ConvBNAct(c_ * (len(k) + 1), c2, 1, 1)
        self.k = tuple(k)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        y = self.cv1(x)
        return self.cv2(torch.cat([y, *(max_pool_same(y, k) for k in self.k)], dim=1))


class SPPF(nn.Module):
    """Spatial pyramid pooling, fast (reference block.py:208-233)."""

    def __init__(self, c1: int, c2: int, k: int = 5):
        super().__init__()
        c_ = c1 // 2
        self.cv1 = ConvBNAct(c1, c_, 1, 1)
        self.cv2 = ConvBNAct(c_ * 4, c2, 1, 1)
        self.k = k

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        ys = [self.cv1(x)]
        for _ in range(3):
            ys.append(max_pool_same(ys[-1], self.k))
        return self.cv2(torch.cat(ys, dim=1))


class Attention(nn.Module):
    """PSA self-attention over the flattened H*W grid (reference block.py:1247-1306).

    Explicit matmul + softmax, with torch's head-major channel layout
    (``view(B, heads, 2*key_dim + head_dim, N)``), as the JAX module keeps.
    """

    def __init__(self, dim: int, num_heads: int = 8, attn_ratio: float = 0.5):
        super().__init__()
        self.num_heads = num_heads
        self.head_dim = dim // num_heads
        self.key_dim = int(self.head_dim * attn_ratio)
        self.scale = self.key_dim**-0.5
        nh_kd = self.key_dim * num_heads
        self.qkv = ConvBNAct(dim, dim + nh_kd * 2, 1, act=False)
        self.proj = ConvBNAct(dim, dim, 1, act=False)
        self.pe = ConvBNAct(dim, dim, 3, 1, g=dim, act=False)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        b, c, h, w = x.shape
        n = h * w
        qkv = self.qkv(x).reshape(b, self.num_heads, self.key_dim * 2 + self.head_dim, n)
        q, k, v = qkv.split([self.key_dim, self.key_dim, self.head_dim], dim=2)
        attn = ((q.transpose(-2, -1) @ k) * self.scale).softmax(dim=-1)
        out = (v @ attn.transpose(-2, -1)).reshape(b, c, h, w)
        return self.proj(out + self.pe(v.reshape(b, c, h, w)))


class PSABlock(nn.Module):
    """Attention + FFN with shortcuts (reference block.py:1307-1360)."""

    def __init__(self, c: int, attn_ratio: float = 0.5, num_heads: int = 4, shortcut: bool = True):
        super().__init__()
        self.attn = Attention(c, num_heads, attn_ratio)
        self.ffn = nn.Sequential(ConvBNAct(c, c * 2, 1), ConvBNAct(c * 2, c, 1, act=False))
        self.add = shortcut

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        a = self.attn(x)
        x = x + a if self.add else a
        f = self.ffn(x)
        return x + f if self.add else f


class C2PSA(nn.Module):
    """CSP wrapper around stacked PSABlocks (reference block.py:1412-1475)."""

    def __init__(self, c1: int, c2: int, n: int = 1, e: float = 0.5):
        super().__init__()
        assert c1 == c2
        self.c = c = int(c1 * e)
        self.cv1 = ConvBNAct(c1, 2 * c, 1, 1)
        self.cv2 = ConvBNAct(2 * c, c1, 1)
        self.m = nn.Sequential(*(PSABlock(c, attn_ratio=0.5, num_heads=c // 64) for _ in range(n)))

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        a, b = self.cv1(x).split((self.c, self.c), dim=1)
        return self.cv2(torch.cat([a, self.m(b)], dim=1))


class ResNetBlock(nn.Module):
    """Bottleneck ResNet block (reference block.py:534-565): 1x1, 3x3 (stride
    ``s``), 1x1 to e * c2, plus the shortcut, then ReLU."""

    def __init__(self, c1: int, c2: int, s: int = 1, e: int = 4):
        super().__init__()
        c3 = e * c2
        self.cv1 = ConvBNAct(c1, c2, 1, 1)
        self.cv2 = ConvBNAct(c2, c2, 3, s, p=1)
        self.cv3 = ConvBNAct(c2, c3, 1, act=False)
        self.shortcut = (nn.Sequential(ConvBNAct(c1, c3, 1, s, act=False)) if s != 1 or c1 != c3
                         else nn.Identity())

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return F.relu(self.cv3(self.cv2(self.cv1(x))) + self.shortcut(x))


class ResNetLayer(nn.Module):
    """The ResNet stem (7x7 s2 conv, 3x3 s2 max pool) when ``is_first``, else
    ``n`` ResNetBlocks (reference block.py:566-616)."""

    def __init__(self, c1: int, c2: int, s: int = 1, is_first: bool = False, n: int = 1, e: int = 4):
        super().__init__()
        if is_first:
            self.layer = nn.Sequential(ConvBNAct(c1, c2, 7, 2, p=3), nn.MaxPool2d(3, 2, 1))
        else:
            self.layer = nn.Sequential(ResNetBlock(c1, c2, s, e),
                                       *(ResNetBlock(e * c2, c2, 1, e) for _ in range(n - 1)))

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return self.layer(x)


class RepConv(nn.Module):
    """RepVGG-style conv (reference conv.py:353-510): a 3x3 and a 1x1
    Conv+BN, summed (3x3 first) before the activation. ``fold_conv_bn`` folds
    each branch on its own, as the JAX fold does; the branches are not merged."""

    def __init__(self, c1: int, c2: int, k: int = 3, s: int = 1, g: int = 1, act: Any = True):
        super().__init__()
        self.conv1 = ConvBNAct(c1, c2, k, s, p=1, g=g, act=False)
        self.conv2 = ConvBNAct(c1, c2, 1, s, p=0, g=g, act=False)
        self.act = act

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return apply_act(self.conv1(x) + self.conv2(x), self.act)


class RepC3(nn.Module):
    """CSP block of RepConvs (reference block.py:365-392, the RT-DETR neck):
    ``cv3(m(cv1(x)) + cv2(x))``, ``cv3`` the identity when ``e`` is 1."""

    def __init__(self, c1: int, c2: int, n: int = 3, e: float = 1.0):
        super().__init__()
        c_ = int(c2 * e)
        self.cv1 = ConvBNAct(c1, c_, 1)
        self.cv2 = ConvBNAct(c1, c_, 1)
        self.m = nn.Sequential(*(RepConv(c_, c_) for _ in range(n)))
        self.cv3 = ConvBNAct(c_, c2, 1) if c_ != c2 else nn.Identity()

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return self.cv3(self.m(self.cv1(x)) + self.cv2(x))


class LightConv(nn.Module):
    """1x1 Conv+BN without activation, then a depthwise k x k Conv+BN+act
    (reference conv.py:150-184, PaddleDetection's HGNetV2)."""

    def __init__(self, c1: int, c2: int, k: int = 1, act: Any = "relu"):
        super().__init__()
        self.conv1 = ConvBNAct(c1, c2, 1, act=False)
        self.conv2 = ConvBNAct(c2, c2, k, g=c2, act=act)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return self.conv2(self.conv1(x))


class HGStem(nn.Module):
    """PPHGNetV2 stem (reference block.py:104-139), all ReLU: stem1 (3x3 s2),
    a right/bottom zero pad of 1, then stem2a -> pad -> stem2b (2x2 convs) beside
    a 2x2 stride-1 max pool of the padded map, concat, stem3 (3x3 s2), stem4 (1x1)."""

    def __init__(self, c1: int, cm: int, c2: int):
        super().__init__()
        self.stem1 = ConvBNAct(c1, cm, 3, 2, act="relu")
        self.stem2a = ConvBNAct(cm, cm // 2, 2, 1, 0, act="relu")
        self.stem2b = ConvBNAct(cm // 2, cm, 2, 1, 0, act="relu")
        self.stem3 = ConvBNAct(cm * 2, cm, 3, 2, act="relu")
        self.stem4 = ConvBNAct(cm, c2, 1, 1, act="relu")

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        x = F.pad(self.stem1(x), [0, 1, 0, 1])
        x2 = self.stem2b(F.pad(self.stem2a(x), [0, 1, 0, 1]))
        x = torch.cat([F.max_pool2d(x, 2, 1), x2], dim=1)
        return self.stem4(self.stem3(x))


class HGBlock(nn.Module):
    """PPHGNetV2 block (reference block.py:141-184): ``n`` chained k x k
    convs (LightConvs with ``lightconv``), all outputs and the input
    concatenated, squeezed to c2 / 2 and excited to c2 by 1x1s; the input is
    added when ``shortcut`` and c1 == c2."""

    def __init__(self, c1: int, cm: int, c2: int, k: int = 3, n: int = 6, lightconv: bool = False,
                 shortcut: bool = False, act: Any = "relu"):
        super().__init__()
        self.m = nn.ModuleList(
            LightConv(c1 if i == 0 else cm, cm, k, act=act) if lightconv
            else ConvBNAct(c1 if i == 0 else cm, cm, k, act=act) for i in range(n))
        self.sc = ConvBNAct(c1 + n * cm, c2 // 2, 1, act=act)
        self.ec = ConvBNAct(c2 // 2, c2, 1, act=act)
        self.add = shortcut and c1 == c2

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        ys = [x]
        for m in self.m:
            ys.append(m(ys[-1]))
        y = self.ec(self.sc(torch.cat(ys, dim=1)))
        return y + x if self.add else y


class RepBottleneck(Bottleneck):
    """Bottleneck whose first conv is a RepConv (reference block.py:823-842)."""

    def __init__(self, c1: int, c2: int, shortcut: bool = True, g: int = 1,
                 k: tuple[int, int] = (3, 3), e: float = 0.5):
        super().__init__(c1, c2, shortcut, g, k, e)
        self.cv1 = RepConv(c1, int(c2 * e), k[0], 1)


class RepCSP(C3):
    """C3 with RepBottleneck inner blocks (reference block.py:844-861)."""

    def __init__(self, c1: int, c2: int, n: int = 1, shortcut: bool = True, g: int = 1, e: float = 0.5):
        super().__init__(c1, c2, n, shortcut, g, e)
        c_ = int(c2 * e)
        self.m = nn.Sequential(*(RepBottleneck(c_, c_, shortcut, g, e=1.0) for _ in range(n)))


class RepNCSPELAN4(nn.Module):
    """CSP-ELAN (reference block.py:863-893): cv1 splits in two halves, two
    (RepCSP, 3x3 Conv) stages chain off the second, all four concat into cv4."""

    def __init__(self, c1: int, c2: int, c3: int, c4: int, n: int = 1):
        super().__init__()
        self.c = c3 // 2
        self.cv1 = ConvBNAct(c1, c3, 1, 1)
        self.cv2 = nn.Sequential(RepCSP(c3 // 2, c4, n), ConvBNAct(c4, c4, 3, 1))
        self.cv3 = nn.Sequential(RepCSP(c4, c4, n), ConvBNAct(c4, c4, 3, 1))
        self.cv4 = ConvBNAct(c3 + 2 * c4, c2, 1, 1)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        ys = list(self.cv1(x).split((self.c, self.c), dim=1))
        ys.append(self.cv2(ys[-1]))
        ys.append(self.cv3(ys[-1]))
        return self.cv4(torch.cat(ys, dim=1))


class ELAN1(RepNCSPELAN4):
    """ELAN with plain 3x3 convs in place of the (RepCSP, Conv) stages (reference block.py:896-914)."""

    def __init__(self, c1: int, c2: int, c3: int, c4: int):
        nn.Module.__init__(self)
        self.c = c3 // 2
        self.cv1 = ConvBNAct(c1, c3, 1, 1)
        self.cv2 = ConvBNAct(c3 // 2, c4, 3, 1)
        self.cv3 = ConvBNAct(c4, c4, 3, 1)
        self.cv4 = ConvBNAct(c3 + 2 * c4, c2, 1, 1)


def avg_pool2(x: torch.Tensor) -> torch.Tensor:
    """2x2 stride-1 unpadded average pool, summed in float32 (reference ``_avg_pool2``, modules.py:1033)."""
    return F.avg_pool2d(x.float(), 2, 1, 0).to(x.dtype)


class AConv(nn.Module):
    """Average pool, then a 3x3 stride-2 conv (reference block.py:916-933)."""

    def __init__(self, c1: int, c2: int):
        super().__init__()
        self.cv1 = ConvBNAct(c1, c2, 3, 2, p=1)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return self.cv1(avg_pool2(x))


class ADown(nn.Module):
    """Dual-branch downsample (reference block.py:935-962): after an average
    pool, the first c1/2 channels take a 3x3 stride-2 conv, the rest a 3x3
    stride-2 max pool and a 1x1 conv."""

    def __init__(self, c1: int, c2: int):
        super().__init__()
        self.half = c1 // 2
        self.cv1 = ConvBNAct(self.half, c2 // 2, 3, 2, p=1)
        self.cv2 = ConvBNAct(c1 - self.half, c2 // 2, 1, 1, p=0)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        x1, x2 = avg_pool2(x).split((self.half, x.shape[1] - self.half), dim=1)
        return torch.cat([self.cv1(x1), self.cv2(F.max_pool2d(x2, 3, 2, 1))], dim=1)


class SPPELAN(nn.Module):
    """SPP-ELAN (reference block.py:964-990): cv1, three chained k x k max
    pools, all four concat into cv5."""

    def __init__(self, c1: int, c2: int, c3: int, k: int = 5):
        super().__init__()
        self.cv1 = ConvBNAct(c1, c3, 1, 1)
        self.cv5 = ConvBNAct(4 * c3, c2, 1, 1)
        self.k = k

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        ys = [self.cv1(x)]
        for _ in range(3):
            ys.append(max_pool_same(ys[-1], self.k))
        return self.cv5(torch.cat(ys, dim=1))


class CBLinear(nn.Module):
    """A biased conv whose output channels split into a tuple of maps
    (reference block.py:992-1011); a later CBFuse indexes the tuple."""

    def __init__(self, c1: int, c2s: Sequence[int], k: int = 1, s: int = 1, p: int | None = None, g: int = 1):
        super().__init__()
        self.c2s = tuple(c2s)
        self.conv = nn.Conv2d(c1, sum(self.c2s), k, s, autopad(k, p), groups=g, bias=True)

    def forward(self, x: torch.Tensor) -> tuple[torch.Tensor, ...]:
        return tuple(self.conv(x).split(self.c2s, dim=1))


def resize_nearest(x: torch.Tensor, size: tuple[int, int]) -> torch.Tensor:
    """``jax.image.resize(method="nearest")`` on the last two axes: output
    index i samples floor((i + 0.5) * in / out), in float32 (half-pixel
    centres). ``F.interpolate(mode="nearest")`` samples floor(i * in / out),
    which agrees for integer upscales only."""
    for dim, n in zip((2, 3), size):
        m = x.shape[dim]
        if m != n:
            idx = ((torch.arange(n, dtype=torch.float32, device=x.device) + 0.5) * m / n).floor().long()
            x = x.index_select(dim, idx)
    return x


class CBFuse(nn.Module):
    """Sum the selected map of each CBLinear tuple, resized (nearest, JAX's
    rule) to the last input's size, onto the last input (reference
    block.py:1013-1035); the sum runs in the JAX order, last input first."""

    def __init__(self, idx: Sequence[int]):
        super().__init__()
        self.idx = tuple(idx)

    def forward(self, xs: Sequence[Any]) -> torch.Tensor:
        out = xs[-1]
        for i, x in zip(self.idx, xs[:-1]):
            out = out + resize_nearest(x[i], tuple(out.shape[2:]))
        return out


class AAttn(nn.Module):
    """Area attention (reference block.py:1617-1697, JAX modules.py:1255-1279):
    full attention within ``area`` slabs of the H*W grid flattened row-major.

    The qkv map is taken to (B, H, W, 3 * dim) and split as the JAX NHWC one
    is: (B * area, H * W / area, heads, 3 * head_dim), each head's q, k and v
    adjacent. ``v`` goes back to (B, dim, H, W) for the 7x7 depthwise ``pe``.
    H * W must divide by ``area`` (the JAX reshape fails otherwise)."""

    def __init__(self, dim: int, num_heads: int, area: int = 1):
        super().__init__()
        self.dim, self.num_heads, self.area = dim, num_heads, area
        self.head_dim = dim // num_heads
        self.qkv = ConvBNAct(dim, dim * 3, 1, act=False)
        self.proj = ConvBNAct(dim, dim, 1, act=False)
        self.pe = ConvBNAct(dim, dim, 7, 1, p=3, g=dim, act=False)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        b, _, h, w = x.shape
        n, area, hd = h * w, self.area, self.head_dim
        if n % area:
            raise ValueError(f"AAttn: the {h}x{w} grid does not split into {area} areas")
        qkv = self.qkv(x).permute(0, 2, 3, 1).reshape(b * area, n // area, self.num_heads, 3 * hd)
        q, k, v = qkv.transpose(1, 2).split(hd, dim=-1)  # (B * area, heads, N / area, hd) each
        attn = ((q @ k.transpose(-2, -1)) * hd**-0.5).softmax(dim=-1)
        out = (attn @ v).transpose(1, 2).reshape(b, h, w, self.dim).permute(0, 3, 1, 2)
        vmap = v.transpose(1, 2).reshape(b, h, w, self.dim).permute(0, 3, 1, 2)
        return self.proj(out + self.pe(vmap))


class ABlock(nn.Module):
    """Area attention then a 1x1 conv MLP, each with a residual (reference block.py:1699-1745)."""

    def __init__(self, dim: int, num_heads: int, mlp_ratio: float = 1.2, area: int = 1):
        super().__init__()
        self.attn = AAttn(dim, num_heads, area)
        hid = int(dim * mlp_ratio)
        self.mlp = nn.Sequential(ConvBNAct(dim, hid, 1), ConvBNAct(hid, dim, 1, act=False))

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        x = x + self.attn(x)
        return x + self.mlp(x)


class A2C2f(nn.Module):
    """Area-attention C2f (reference block.py:1747-1846): cv1, n blocks
    chained (two ABlocks each when ``a2``, else a C3k), all concat into cv2.
    With ``a2`` and ``residual`` (yolo12 l/x) the output is
    x + gamma * cv2(...), gamma a per-channel parameter starting at 0.01."""

    def __init__(self, c1: int, c2: int, n: int = 1, a2: bool = True, area: int = 1, residual: bool = False,
                 mlp_ratio: float = 2.0, e: float = 0.5, g: int = 1, shortcut: bool = True):
        super().__init__()
        c_ = int(c2 * e)
        if c_ % 32:
            raise ValueError("A2C2f hidden dim must be a multiple of 32")
        self.cv1 = ConvBNAct(c1, c_, 1, 1)
        self.cv2 = ConvBNAct((1 + n) * c_, c2, 1)
        self.m = nn.ModuleList(
            nn.Sequential(*(ABlock(c_, c_ // 32, mlp_ratio, area) for _ in range(2))) if a2
            else C3k(c_, c_, 2, shortcut, g)
            for _ in range(n)
        )
        self.gamma = nn.Parameter(torch.full((c2,), 0.01)) if a2 and residual else None

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        ys = [self.cv1(x)]
        for m in self.m:
            ys.append(m(ys[-1]))
        out = self.cv2(torch.cat(ys, dim=1))
        if self.gamma is not None:
            return x + self.gamma.view(1, -1, 1, 1) * out
        return out


class RepVGGDW(nn.Module):
    """7x7 and 3x3 depthwise Conv+BN without activation, summed, then SiLU
    (reference block.py:1108-1170). ``fold_conv_bn`` folds each branch on
    its own; the two are not merged into one 7x7."""

    def __init__(self, ed: int):
        super().__init__()
        self.conv = ConvBNAct(ed, ed, 7, 1, p=3, g=ed, act=False)
        self.conv1 = ConvBNAct(ed, ed, 3, 1, p=1, g=ed, act=False)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return F.silu(self.conv(x) + self.conv1(x))


class CIB(nn.Module):
    """Compact inverted block (reference block.py:1172-1214): depthwise 3x3,
    1x1 to 2c_, a depthwise 3x3 (RepVGGDW when ``lk``), 1x1 to c2, depthwise
    3x3, plus the shortcut when c1 == c2."""

    def __init__(self, c1: int, c2: int, shortcut: bool = True, e: float = 0.5, lk: bool = False):
        super().__init__()
        c_ = int(c2 * e)
        self.cv1 = nn.Sequential(
            ConvBNAct(c1, c1, 3, g=c1), ConvBNAct(c1, 2 * c_, 1),
            RepVGGDW(2 * c_) if lk else ConvBNAct(2 * c_, 2 * c_, 3, g=2 * c_),
            ConvBNAct(2 * c_, c2, 1), ConvBNAct(c2, c2, 3, g=c2))
        self.add = shortcut and c1 == c2

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        y = self.cv1(x)
        return x + y if self.add else y


class C2fCIB(C2f):
    """C2f with CIB inner blocks of expansion 1 (reference block.py:1216-1245)."""

    def __init__(self, c1: int, c2: int, n: int = 1, shortcut: bool = False, lk: bool = False, g: int = 1,
                 e: float = 0.5):
        super().__init__(c1, c2, n, shortcut, g, e)
        self.m = nn.ModuleList(CIB(self.c, self.c, shortcut, e=1.0, lk=lk) for _ in range(n))


class PSA(nn.Module):
    """Position-sensitive attention (reference block.py:1362-1411): cv1
    splits in two halves, the second takes ``Attention`` (heads c // 64,
    ratio 0.5) and a 1x1 FFN, each with a residual, and both concat into cv2."""

    def __init__(self, c1: int, c2: int, e: float = 0.5):
        super().__init__()
        assert c1 == c2
        self.c = c = int(c1 * e)
        self.cv1 = ConvBNAct(c1, 2 * c, 1, 1)
        self.cv2 = ConvBNAct(2 * c, c1, 1)
        self.attn = Attention(c, num_heads=c // 64, attn_ratio=0.5)
        self.ffn = nn.Sequential(ConvBNAct(c, c * 2, 1), ConvBNAct(c * 2, c, 1, act=False))

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        a, b = self.cv1(x).split((self.c, self.c), dim=1)
        b = b + self.attn(b)
        b = b + self.ffn(b)
        return self.cv2(torch.cat([a, b], dim=1))


class SCDown(nn.Module):
    """Separable downsample (reference block.py:1506-1552): a 1x1 Conv to
    c2, then a k x k stride-s depthwise Conv+BN without activation."""

    def __init__(self, c1: int, c2: int, k: int, s: int):
        super().__init__()
        self.cv1 = ConvBNAct(c1, c2, 1, 1)
        self.cv2 = ConvBNAct(c2, c2, k, s, g=c2, act=False)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return self.cv2(self.cv1(x))


class MaxPool2d(nn.MaxPool2d):
    """The YAML's ``nn.MaxPool2d(k, s, p)``: stride ``k`` when ``s`` is None."""

    def __init__(self, k: int, s: int | None = None, p: int = 0):
        super().__init__(k, s if s is not None else k, p)


class ZeroPad2d(nn.ZeroPad2d):
    """The YAML's ``nn.ZeroPad2d``: an int, or (left, right, top, bottom)."""

    def __init__(self, padding: int | Sequence[int] = 0):
        super().__init__(padding if isinstance(padding, int) else tuple(padding))


class ConvTranspose2d(nn.ConvTranspose2d):
    """The YAML's ``nn.ConvTranspose2d(c1, c2, k, s, p)`` with a bias. Its
    output is (H - 1) * s - 2p + k, which is what the JAX module's VALID
    transpose cropped by p on each side gives."""

    def __init__(self, c1: int, c2: int, k: int = 2, s: int = 2, p: int = 0):
        super().__init__(c1, c2, k, s, p, bias=True)


class Upsample(nn.Module):
    """Nearest-neighbour integer upsample (torch ``nn.Upsample(None, s, 'nearest')``)."""

    def __init__(self, scale: int = 2, mode: str = "nearest"):
        super().__init__()
        assert mode == "nearest", mode
        self.scale = scale

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return F.interpolate(x, scale_factor=self.scale, mode="nearest")


class Concat(nn.Module):
    """Channel concat of several inputs (reference conv.py:616-643)."""

    def forward(self, xs: Sequence[torch.Tensor]) -> torch.Tensor:
        return torch.cat(list(xs), dim=1)


def decode_maps(feats: list[torch.Tensor], strides: Sequence[int], reg_max: int = 16) -> torch.Tensor:
    """Per-level (B, 4 * reg_max + K, H, W) maps -> ``preds`` (B, N, 4 + K) in
    float32, anchor-major: DFL expectation -> dist2bbox around the anchors ->
    pixel xywh, and sigmoid class scores. K is the maps' class channels (an
    open-vocabulary head's text rows, else ``nc``)."""
    b, no = feats[0].shape[:2]
    flat = torch.cat([f.permute(0, 2, 3, 1).reshape(b, -1, no) for f in feats], dim=1)
    box_logits, cls_logits = flat[..., : reg_max * 4], flat[..., reg_max * 4:]
    anchors, stride_t = make_anchors([f.shape[2:] for f in feats], list(strides), 0.5, dtype=torch.float32,
                                     device=flat.device)
    dbox = dist2bbox(dfl_expectation(box_logits.float(), reg_max), anchors[None], xywh=True) * stride_t[None]
    return torch.cat([dbox, cls_logits.float().sigmoid()], dim=-1)


class Detect(nn.Module):
    """YOLO detect head (reference head.py:26-212).

    Per level: the cv2 branch gives 4*reg_max DFL logits, the cv3 branch nc
    class logits; ``legacy`` (the v8-era heads, JAX modules.py:552-568) makes
    the cv3 branch two plain 3x3 convs in place of the depthwise pairs. In training mode it returns the raw per-level maps
    ``{"feats": [(B, no, H, W)]}``. In eval mode it also decodes in float32:
    DFL expectation -> dist2bbox around the anchors -> pixel xywh and sigmoid
    class scores, anchor-major ``preds`` (B, N, 4 + nc) as the JAX head gives.
    """

    def __init__(self, nc: int, ch: Sequence[int], reg_max: int = 16,
                 strides: Sequence[int] | None = None, legacy: bool = False):
        super().__init__()
        self.nc, self.reg_max, self.legacy = nc, reg_max, legacy
        self.no = nc + reg_max * 4
        self.strides = tuple(strides) if strides is not None else None
        c2 = max(16, ch[0] // 4, reg_max * 4)
        c3 = max(ch[0], min(nc, 100))
        self.cv2 = nn.ModuleList(
            nn.Sequential(ConvBNAct(x, c2, 3), ConvBNAct(c2, c2, 3), Conv2d(c2, 4 * reg_max, 1))
            for x in ch
        )
        self.cv3 = nn.ModuleList(nn.Sequential(
            ConvBNAct(x, c3, 3), ConvBNAct(c3, c3, 3), Conv2d(c3, nc, 1),
        ) if legacy else nn.Sequential(
            nn.Sequential(DWConvBNAct(x, x, 3), ConvBNAct(x, c3, 1)),
            nn.Sequential(DWConvBNAct(c3, c3, 3), ConvBNAct(c3, c3, 1)),
            Conv2d(c3, nc, 1),
        ) for x in ch)

    def level_maps(self, xs: Sequence[torch.Tensor]) -> list[torch.Tensor]:
        """The per-level (B, 4*reg_max + nc, H, W) maps of the box and class branches."""
        return [torch.cat([b(x), c(x)], dim=1) for x, b, c in zip(xs, self.cv2, self.cv3)]

    def forward(self, xs: Sequence[torch.Tensor]) -> dict[str, Any]:
        feats = self.level_maps(xs)
        if self.training:
            return {"feats": feats}
        assert self.strides is not None, "Detect.strides unresolved; build via build_model()"
        return {"preds": decode_maps(feats, self.strides, self.reg_max), "feats": feats}

    def bias_init(self) -> None:
        """Detection prior biases (reference head.py:169-188): box branch 1.0,
        class branch log(5 / nc / (640 / s)^2)."""
        with torch.no_grad():
            for b, c, s in zip(self.cv2, self.cv3, self.strides):
                b[-1].bias.fill_(1.0)
                c[-1].bias.fill_(math.log(5 / self.nc / (640 / s) ** 2))
