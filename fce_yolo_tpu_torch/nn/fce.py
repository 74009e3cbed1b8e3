"""FCE modules on the inference slice (reference ``fce_yolo_tpu/nn/fce.py:18-44, 122-166``).

``CoordAtt``/``CoordCrossAtt`` are off the slice's path and not ported yet.
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
