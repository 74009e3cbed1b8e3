"""FCE modules (reference ``fce_yolo_tpu/nn/fce.py``): ``BiFPN_Concat`` and
``BiCoordCrossAtt`` on the paper's detector, and ``CoordAtt`` and
``CoordCrossAtt``, which only a user's own model YAML reaches.
"""

from __future__ import annotations

from typing import Sequence

import torch
import torch.nn.functional as F
from torch import nn

from fce_yolo_tpu_torch.nn.modules import Conv2d, ConvBNAct


class BiFPN_Concat(nn.Module):
    """Weighted multi-input fusion (reference fce_block.py:13-63):
    ``sum_i w_i x_i / (sum_i w_i + eps)`` with w = relu(param), init 1; inputs
    whose width differs from c2 are realigned by a 1x1 Conv+BN+SiLU."""

    def __init__(self, c1: Sequence[int], c2: int, epsilon: float = 1e-4):
        super().__init__()
        self.epsilon = epsilon
        self.realign_convs = nn.ModuleList(
            ConvBNAct(ch, c2, 1, 1) if ch != c2 else nn.Identity() for ch in c1)
        self.w = nn.Parameter(torch.ones(len(c1)))

    def forward(self, xs: Sequence[torch.Tensor]) -> torch.Tensor:
        assert len(xs) == len(self.realign_convs), f"expected {len(self.realign_convs)} inputs"
        w = F.relu(self.w)
        w = w / (w.sum() + self.epsilon)
        out = w[0] * self.realign_convs[0](xs[0])
        for i in range(1, len(xs)):
            out = out + w[i] * self.realign_convs[i](xs[i])
        return out


def _strips(x: torch.Tensor) -> torch.Tensor:
    """The H strip (mean over W) and the W strip (mean over H) of (B, C, H, W),
    stacked on the length axis: (B, C, H + W, 1)."""
    return torch.cat([x.mean(dim=3, keepdim=True), x.mean(dim=2, keepdim=True).transpose(2, 3)], dim=2)


class CoordAtt(nn.Module):
    """Coordinate attention (reference fce_block.py:65-116, arXiv 2103.02907;
    JAX ``fce.py:56-81``): both strips through one shared 1x1 Conv+BN+SiLU
    to ``mip = max(8, inp // reduction)`` channels, split back, a 1x1 conv
    and a sigmoid on each: ``identity(x) * a_h * a_w``."""

    def __init__(self, inp: int, oup: int, reduction: int = 32):
        super().__init__()
        mip = max(8, inp // reduction)
        self.cv1 = ConvBNAct(inp, mip, 1, 1, p=0)
        self.cv_h = Conv2d(mip, oup)
        self.cv_w = Conv2d(mip, oup)
        self.identity = Conv2d(inp, oup) if inp != oup else nn.Identity()

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        h = x.shape[2]
        y_h, y_w = self.cv1(_strips(x)).split((h, x.shape[3]), dim=2)
        a_h = torch.sigmoid(self.cv_h(y_h))  # (B, oup, H, 1)
        a_w = torch.sigmoid(self.cv_w(y_w)).transpose(2, 3)  # (B, oup, 1, W)
        return self.identity(x) * a_h * a_w


class CoordCrossAtt(nn.Module):
    """Coordinate cross attention (reference fce_block.py:119-180; JAX
    ``fce.py:84-119``): the H strip's queries attend over the W strip's keys
    and values, ``num_heads`` heads of ``mip / num_heads`` channels (channel
    = head * dim_head + d); one sigmoid gate on the H axis: ``x * gate``.
    Its ``cv1`` is a plain biased conv, unlike CoordAtt's."""

    def __init__(self, inp: int, oup: int, reduction: int = 32, num_heads: int = 1):
        super().__init__()
        self.mip = mip = max(8, inp // reduction)
        self.num_heads = num_heads
        self.scale = (mip // num_heads) ** -0.5
        self.cv1 = Conv2d(inp, mip)
        self.q_conv, self.k_conv, self.v_conv = (Conv2d(mip, mip) for _ in range(3))
        self.proj = Conv2d(mip, oup)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        b, _, h, w = x.shape
        nh, dh = self.num_heads, self.mip // self.num_heads
        y_h, y_w = self.cv1(_strips(x)).split((h, w), dim=2)
        q = self.q_conv(y_h).reshape(b, nh, dh, h)
        k = self.k_conv(y_w).reshape(b, nh, dh, w)
        v = self.v_conv(y_w).reshape(b, nh, dh, w)
        attn = (torch.einsum("bndq,bndk->bnqk", q, k) * self.scale).softmax(dim=-1)
        z = torch.einsum("bnqk,bndk->bndq", attn, v).reshape(b, self.mip, h, 1)
        return x * torch.sigmoid(self.proj(z))


class BiCoordCrossAtt(nn.Module):
    """Bidirectional coordinate cross attention (reference fce_block.py:183-284).

    H- and W-strip pooled features attend to each other (multi-head, channel
    = head * dim_head + d); the two projected branches add before ONE
    sigmoid: ``out = identity(x) * sigmoid(gate_h + gate_w)``.
    """

    def __init__(self, inp: int, oup: int, reduction: int = 32, num_heads: int = 4):
        super().__init__()
        self.num_heads = num_heads
        self.dim_head = max(8, inp // reduction) // num_heads
        mid = self.dim_head * num_heads
        self.scale = self.dim_head**-0.5
        self.proj_q_h, self.proj_k_h, self.proj_v_h = (Conv2d(inp, mid) for _ in range(3))
        self.out_h = Conv2d(mid, oup)
        self.proj_q_w, self.proj_k_w, self.proj_v_w = (Conv2d(inp, mid) for _ in range(3))
        self.out_w = Conv2d(mid, oup)
        self.identity = Conv2d(inp, oup) if inp != oup else nn.Identity()

    def _attend(self, q_conv, k_conv, v_conv, out_conv, q_strip, kv_strip) -> torch.Tensor:
        """Queries from one strip (B, C, Lq, 1), keys/values from the other
        (B, C, Lk, 1) -> projected gate logits (B, oup, Lq, 1)."""
        b, lq, lk = q_strip.shape[0], q_strip.shape[2], kv_strip.shape[2]
        nh, dh = self.num_heads, self.dim_head
        q = q_conv(q_strip).reshape(b, nh, dh, lq)
        k = k_conv(kv_strip).reshape(b, nh, dh, lk)
        v = v_conv(kv_strip).reshape(b, nh, dh, lk)
        attn = (torch.einsum("bndq,bndk->bnqk", q, k) * self.scale).softmax(dim=-1)
        y = torch.einsum("bnqk,bndk->bndq", attn, v).reshape(b, nh * dh, lq, 1)
        return out_conv(y)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        x_h = x.mean(dim=3, keepdim=True)  # (B, C, H, 1)
        x_w = x.mean(dim=2, keepdim=True).transpose(2, 3)  # (B, C, W, 1)
        gate_h = self._attend(self.proj_q_h, self.proj_k_h, self.proj_v_h, self.out_h, x_h, x_w)
        gate_w = self._attend(self.proj_q_w, self.proj_k_w, self.proj_v_w, self.out_w, x_w, x_h)
        gate = torch.sigmoid(gate_h + gate_w.transpose(2, 3))  # (B, oup, H, W)
        return self.identity(x) * gate
