"""YOLO11 modules of the inference slice (reference ``fce_yolo_tpu/nn/modules.py:87-593``).

NCHW ``nn.Module``s; attribute names follow Ultralytics (``cv1``, ``m.0``,
``cv2.0.2``) so ``state_dict`` keys are ``model.{i}.<path>`` and the JAX
weight bridge (``nn/weights.py``) is a name rewrite. Convolutions pad
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


def DWConvBNAct(c1: int, c2: int, k: int = 1, s: int = 1, act: Any = True) -> ConvBNAct:
    """Depthwise Conv+BN+SiLU, groups = gcd(c1, c2) (reference ``DWConv``, conv.py:186-200)."""
    return ConvBNAct(c1, c2, k, s, g=math.gcd(c1, c2), act=act)


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
            ys.append(F.max_pool2d(ys[-1], self.k, 1, self.k // 2))
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


class Detect(nn.Module):
    """YOLO detect head (reference head.py:26-212).

    Per level: the cv2 branch gives 4*reg_max DFL logits, the cv3 branch nc
    class logits. In training mode it returns the raw per-level maps
    ``{"feats": [(B, no, H, W)]}``. In eval mode it also decodes in float32:
    DFL expectation -> dist2bbox around the anchors -> pixel xywh and sigmoid
    class scores, anchor-major ``preds`` (B, N, 4 + nc) as the JAX head gives.
    """

    def __init__(self, nc: int, ch: Sequence[int], reg_max: int = 16,
                 strides: Sequence[int] | None = None):
        super().__init__()
        self.nc, self.reg_max = nc, reg_max
        self.no = nc + reg_max * 4
        self.strides = tuple(strides) if strides is not None else None
        c2 = max(16, ch[0] // 4, reg_max * 4)
        c3 = max(ch[0], min(nc, 100))
        self.cv2 = nn.ModuleList(
            nn.Sequential(ConvBNAct(x, c2, 3), ConvBNAct(c2, c2, 3), Conv2d(c2, 4 * reg_max, 1))
            for x in ch
        )
        self.cv3 = nn.ModuleList(nn.Sequential(
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
        bsz = feats[0].shape[0]
        flat = torch.cat([f.permute(0, 2, 3, 1).reshape(bsz, -1, self.no) for f in feats], dim=1)
        box_logits, cls_logits = flat[..., : self.reg_max * 4], flat[..., self.reg_max * 4:]
        anchors, stride_t = make_anchors([f.shape[2:] for f in feats], list(self.strides),
                                         0.5, dtype=torch.float32, device=flat.device)
        dist = dfl_expectation(box_logits.float(), self.reg_max)
        dbox = dist2bbox(dist, anchors[None], xywh=True) * stride_t[None]
        preds = torch.cat([dbox, cls_logits.float().sigmoid()], dim=-1)
        return {"preds": preds, "feats": feats}

    def bias_init(self) -> None:
        """Detection prior biases (reference head.py:169-188): box branch 1.0,
        class branch log(5 / nc / (640 / s)^2)."""
        with torch.no_grad():
            for b, c, s in zip(self.cv2, self.cv3, self.strides):
                b[-1].bias.fill_(1.0)
                c[-1].bias.fill_(math.log(5 / self.nc / (640 / s) ** 2))
