"""YOLO-World's open-vocabulary modules (reference ``fce_yolo_tpu/nn/world.py``;
Ultralytics block.py:566-820, head.py:440-505): ``MaxSigmoidAttnBlock``,
``C2fAttn``, ``ImagePoolingAttn``, ``ContrastiveHead``,
``BNContrastiveHead`` and ``WorldDetect``.

NCHW modules with Ultralytics' attribute names (``gl``, ``proj_conv``,
``query.0``, ``projections.0``, ``cv4.0.logit_scale``), so the weight bridge
and a ``.pt`` import are name rewrites as for the other layers. The
text-conditioned modules take ``(x, text)`` with ``text`` (B, K, 512) at the
batch of ``x``; the graph (``nn/model.py``) threads it as the JAX graph does.

Where the JAX package differs from Ultralytics the port follows JAX:
``ImagePoolingAttn``'s LayerNorms take flax's eps 1e-6 (Ultralytics 1e-5;
ROADMAP queue 3, item 35) and ``BNContrastiveHead``'s BatchNorm the port's
eps 1e-3 and momentum 0.03 (Ultralytics' torch defaults 1e-5 and 0.1).
"""

from __future__ import annotations

import math
from typing import Any, Sequence

import torch
import torch.nn.functional as F
from torch import nn

from fce_yolo_tpu_torch.nn.modules import (BN_EPS, BN_MOMENTUM, BatchNorm2d, Bottleneck, Conv2d, ConvBNAct, Detect,
                                           decode_maps)

__all__ = ["MaxSigmoidAttnBlock", "C2fAttn", "ImagePoolingAttn", "ContrastiveHead", "BNContrastiveHead",
           "WorldDetect"]

IPA_LN_EPS = 1e-6  # flax's nn.LayerNorm default, which the JAX ImagePoolingAttn takes


class MaxSigmoidAttnBlock(nn.Module):
    """Max-sigmoid guided attention (reference world.py:41-75): per head the
    image/text similarity, its max over the text rows, a sigmoid gate on the
    3x3 projection."""

    def __init__(self, c1: int, c2: int, nh: int = 1, ec: int = 128, gc: int = 512):
        super().__init__()
        self.nh, self.hc = nh, c2 // nh
        self.ec = ConvBNAct(c1, ec, 1, act=False) if c1 != ec else None
        self.gl = nn.Linear(gc, ec)
        self.bias = nn.Parameter(torch.zeros(nh))
        self.proj_conv = ConvBNAct(c1, c2, 3, 1, act=False)

    def forward(self, x: torch.Tensor, guide: torch.Tensor) -> torch.Tensor:
        b, _, h, w = x.shape
        g = self.gl(guide).reshape(b, -1, self.nh, self.hc)
        embed = (x if self.ec is None else self.ec(x)).reshape(b, self.nh, self.hc, h, w)
        aw = torch.einsum("bmchw,bnmc->bmhwn", embed, g).amax(dim=-1) / self.hc ** 0.5
        aw = torch.sigmoid(aw + self.bias[None, :, None, None])
        y = self.proj_conv(x).reshape(b, self.nh, -1, h, w) * aw.unsqueeze(2)
        return y.reshape(b, -1, h, w)


class C2fAttn(nn.Module):
    """C2f with a guided-attention branch on its last output (reference world.py:78-106)."""

    def __init__(self, c1: int, c2: int, n: int = 1, ec: int = 128, nh: int = 1, gc: int = 512,
                 shortcut: bool = False, g: int = 1, e: float = 0.5):
        super().__init__()
        self.c = c = int(c2 * e)
        self.cv1 = ConvBNAct(c1, 2 * c, 1, 1)
        self.cv2 = ConvBNAct((3 + n) * c, c2, 1)
        self.m = nn.ModuleList(Bottleneck(c, c, shortcut, g, k=(3, 3), e=1.0) for _ in range(n))
        self.attn = MaxSigmoidAttnBlock(c, c, gc=gc, ec=ec, nh=nh)

    def forward(self, x: torch.Tensor, guide: torch.Tensor) -> torch.Tensor:
        ys = list(self.cv1(x).split((self.c, self.c), dim=1))
        for m in self.m:
            ys.append(m(ys[-1]))
        ys.append(self.attn(ys[-1], guide))
        return self.cv2(torch.cat(ys, dim=1))


class ImagePoolingAttn(nn.Module):
    """Text embeddings enhanced by attention over k x k max-pooled patches of
    each level (reference world.py:123-165). ``F.adaptive_max_pool2d``'s
    bins are the JAX ``_adaptive_max_pool``'s (floor / ceil edges)."""

    def __init__(self, ec: int = 256, ch: Sequence[int] = (), ct: int = 512, nh: int = 8, k: int = 3,
                 scale: bool = False):
        super().__init__()
        self.ec, self.nh, self.k = ec, nh, k
        self.query = nn.Sequential(nn.LayerNorm(ct, eps=IPA_LN_EPS), nn.Linear(ct, ec))
        self.key = nn.Sequential(nn.LayerNorm(ec, eps=IPA_LN_EPS), nn.Linear(ec, ec))
        self.value = nn.Sequential(nn.LayerNorm(ec, eps=IPA_LN_EPS), nn.Linear(ec, ec))
        self.proj = nn.Linear(ec, ct)
        self.scale = nn.Parameter(torch.zeros(1)) if scale else None
        self.projections = nn.ModuleList(Conv2d(c, ec, 1) for c in ch)

    def forward(self, xs: Sequence[torch.Tensor], text: torch.Tensor) -> torch.Tensor:
        b = xs[0].shape[0]
        img = torch.cat([F.adaptive_max_pool2d(p(x), self.k).reshape(b, self.ec, -1)
                         for x, p in zip(xs, self.projections)], dim=2).transpose(1, 2)  # (B, nf*k*k, ec)
        hc = self.ec // self.nh
        q = self.query(text).reshape(b, -1, self.nh, hc)
        k = self.key(img).reshape(b, -1, self.nh, hc)
        v = self.value(img).reshape(b, -1, self.nh, hc)
        aw = torch.softmax(torch.einsum("bnmc,bkmc->bmnk", q, k) / hc ** 0.5, dim=-1)
        out = self.proj(torch.einsum("bmnk,bkmc->bnmc", aw, v).reshape(b, -1, self.ec))
        return (out if self.scale is None else out * self.scale) + text


class ContrastiveHead(nn.Module):
    """Region-text similarity of L2-normalized features (reference world.py:168-177)."""

    def __init__(self):
        super().__init__()
        self.bias = nn.Parameter(torch.tensor([-10.0]))
        self.logit_scale = nn.Parameter(torch.tensor(math.log(1 / 0.07)))

    def forward(self, x: torch.Tensor, w: torch.Tensor) -> torch.Tensor:
        x = F.normalize(x, dim=1)
        w = F.normalize(w, dim=-1)
        return torch.einsum("bchw,bkc->bkhw", x, w) * self.logit_scale.exp() + self.bias


class BNContrastiveHead(nn.Module):
    """The worldv2 / YOLOE variant: the image features BatchNorm-ed instead
    of L2-normalized (reference world.py:180-194)."""

    def __init__(self, embed_dims: int):
        super().__init__()
        self.norm = BatchNorm2d(embed_dims, eps=BN_EPS, momentum=BN_MOMENTUM)
        self.bias = nn.Parameter(torch.tensor([-10.0]))
        self.logit_scale = nn.Parameter(torch.tensor(-1.0))

    def forward(self, x: torch.Tensor, w: torch.Tensor) -> torch.Tensor:
        w = F.normalize(w, dim=-1)
        return torch.einsum("bchw,bkc->bkhw", self.norm(x), w) * self.logit_scale.exp() + self.bias


def contrastive_heads(ch: Sequence[int], embed: int, with_bn: bool) -> nn.ModuleList:
    return nn.ModuleList(BNContrastiveHead(embed) if with_bn else ContrastiveHead() for _ in ch)


class WorldDetect(Detect):
    """Detect scoring classes against text embeddings (reference
    world.py:197-234): the box branch is Detect's ``cv2``, the class branch
    ``cv3`` (two 3x3 convs, then a 1x1 to ``embed``) and the contrastive
    ``cv4`` against ``text``. ``preds`` (B, N, 4 + K), K the text rows."""

    def __init__(self, nc: int, embed: int = 512, with_bn: bool = False, ch: Sequence[int] = (),
                 strides: Sequence[int] | None = None):
        super().__init__(nc, ch, strides=strides, legacy=True)
        c3 = max(ch[0], min(nc, 100))
        for seq in self.cv3:
            seq[-1] = Conv2d(c3, embed, 1)
        self.cv4 = contrastive_heads(ch, embed, with_bn)

    def forward(self, xs: Sequence[torch.Tensor], text: torch.Tensor) -> dict[str, Any]:
        feats = [torch.cat([b(x), h(c(x), text)], dim=1) for x, b, c, h in zip(xs, self.cv2, self.cv3, self.cv4)]
        if self.training:
            return {"feats": feats}
        return {"preds": decode_maps(feats, self.strides, self.reg_max), "feats": feats}

    def bias_init(self) -> None:
        """The box branch's prior only (reference WorldDetect.bias_init, head.py:487; JAX nn/model.py:381-387)."""
        with torch.no_grad():
            for b in self.cv2:
                b[-1].bias.fill_(1.0)
