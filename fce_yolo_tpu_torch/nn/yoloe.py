"""YOLOE's prompt modules (reference ``fce_yolo_tpu/nn/yoloe.py``;
Ultralytics block.py:1847-1947, head.py:560-812): ``SwiGLUFFN``,
``Residual``, ``SAVPE``, ``YOLOEDetect`` and ``YOLOESegment``.

Classes are scored against prompt embeddings: text embeddings through the
zero-initialized SwiGLU residual ``reprta`` and an L2 norm, or, given
``visual_prompts`` (B, Q, H3, W3) masks on the P3 grid, SAVPE's embeddings
of them. The JAX head runs SAVPE on a dummy prompt in text mode only so
that flax creates its parameters; here they exist from the constructor and
SAVPE runs in visual mode only. The LRPC prompt-free path is absent, as in
the JAX package.
"""

from __future__ import annotations

from typing import Any, Sequence

import torch
import torch.nn.functional as F
from torch import nn

from fce_yolo_tpu_torch.nn.heads import Proto, _anchor_major
from fce_yolo_tpu_torch.nn.modules import Conv2d, ConvBNAct, Detect, decode_maps
from fce_yolo_tpu_torch.nn.world import contrastive_heads

__all__ = ["SwiGLUFFN", "Residual", "SAVPE", "YOLOEDetect", "YOLOESegment"]


class SwiGLUFFN(nn.Module):
    """SwiGLU feed-forward (reference yoloe.py:33-47): ``w3(silu(x1) * x2)``, (x1, x2) = ``w12(x)``."""

    def __init__(self, gc: int, ec: int, e: int = 4):
        super().__init__()
        self.w12 = nn.Linear(gc, e * ec)
        self.w3 = nn.Linear(e * ec // 2, ec)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        x1, x2 = self.w12(x).chunk(2, dim=-1)
        return self.w3(F.silu(x1) * x2)


class Residual(nn.Module):
    """``x + m(x)``, ``m`` a SwiGLUFFN whose ``w3`` starts at zero, so the
    adapter starts as the identity (reference yoloe.py:50-60)."""

    def __init__(self, m: SwiGLUFFN):
        super().__init__()
        self.m = m
        self.reset_w3()

    @torch.no_grad()
    def reset_w3(self) -> None:
        self.m.w3.weight.zero_()
        self.m.w3.bias.zero_()

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return x + self.m(x)


def _to_p3(level: int) -> nn.Module:
    """Nearest upsampling of level 1 (x2) and 2 (x4) to the P3 grid."""
    return nn.Upsample(scale_factor=2 * level, mode="nearest") if level in (1, 2) else nn.Identity()


class SAVPE(nn.Module):
    """Spatial-aware visual prompt embedding (reference yoloe.py:63-106): per
    prompt a 16-way attention over the P3 grid, masked to the prompt's
    cells, pools the 16 channel groups of the embedding map. Masked cells
    score ``finfo.min``, so a prompt with an empty mask pools the whole grid
    uniformly (no NaN, in bfloat16 too)."""

    def __init__(self, ch: Sequence[int], c3: int, embed: int):
        super().__init__()
        self.c = 16
        self.cv1 = nn.ModuleList(nn.Sequential(ConvBNAct(x, c3, 3), ConvBNAct(c3, c3, 3), _to_p3(i))
                                 for i, x in enumerate(ch))
        self.cv2 = nn.ModuleList(nn.Sequential(ConvBNAct(x, c3, 1), _to_p3(i)) for i, x in enumerate(ch))
        self.cv3 = Conv2d(len(ch) * c3, embed, 1)
        self.cv4 = Conv2d(len(ch) * c3, self.c, 3)
        self.cv5 = Conv2d(1, self.c, 3)
        self.cv6 = nn.Sequential(ConvBNAct(2 * self.c, self.c, 3), Conv2d(self.c, self.c, 3))

    def forward(self, xs: Sequence[torch.Tensor], vp: torch.Tensor) -> torch.Tensor:
        x = self.cv3(torch.cat([m(x) for m, x in zip(self.cv1, xs)], dim=1))  # (B, E, H, W)
        y = self.cv4(torch.cat([m(x) for m, x in zip(self.cv2, xs)], dim=1))  # (B, 16, H, W)
        b, e, h, w = x.shape
        q, c = vp.shape[1], self.c
        vp = vp.to(y.dtype)
        y = y[:, None].expand(-1, q, -1, -1, -1).reshape(b * q, c, h, w)
        z = self.cv6(torch.cat([y, self.cv5(vp.reshape(b * q, 1, h, w))], dim=1)).reshape(b, q, c, h * w)
        vpm = vp.reshape(b, q, 1, h * w)
        score = torch.softmax(torch.where(vpm > 0, z * vpm, torch.finfo(z.dtype).min), dim=-1)
        agg = score.transpose(1, 2) @ x.reshape(b, c, e // c, h * w).transpose(-1, -2)  # (B, c, Q, E/c)
        return F.normalize(agg.transpose(1, 2).reshape(b, q, e), dim=-1)


class YOLOEDetect(Detect):
    """Prompt-embedding detect head (reference yoloe.py:109-176): the box
    branch Detect's ``cv2``; the class branch Detect's depthwise ``cv3``
    ending in a 1x1 to ``embed``, scored by ``cv4`` against the text
    embeddings through ``reprta`` and an L2 norm, or against SAVPE's
    embeddings of ``visual_prompts``. ``preds`` (B, N, 4 + K), K the text
    rows or the prompts."""

    def __init__(self, nc: int, embed: int = 512, with_bn: bool = True, ch: Sequence[int] = (),
                 strides: Sequence[int] | None = None):
        super().__init__(nc, ch, strides=strides, legacy=False)
        c3 = max(ch[0], min(nc, 100))
        for seq in self.cv3:
            seq[-1] = Conv2d(c3, embed, 1)
        self.cv4 = contrastive_heads(ch, embed, with_bn)
        self.reprta = Residual(SwiGLUFFN(embed, embed))
        self.savpe = SAVPE(ch, c3, embed)

    def prompt_maps(self, xs: Sequence[torch.Tensor], txt_feats: torch.Tensor,
                    visual_prompts: torch.Tensor | None = None) -> list[torch.Tensor]:
        if visual_prompts is None:
            cls_pe = F.normalize(self.reprta(txt_feats), dim=-1)
        else:
            cls_pe = self.savpe(xs, visual_prompts)
        return [torch.cat([b(x), h(c(x), cls_pe)], dim=1) for x, b, c, h in zip(xs, self.cv2, self.cv3, self.cv4)]

    def forward(self, xs: Sequence[torch.Tensor], txt_feats: torch.Tensor,
                visual_prompts: torch.Tensor | None = None) -> dict[str, Any]:
        feats = self.prompt_maps(xs, txt_feats, visual_prompts)
        if self.training:
            return {"feats": feats}
        return {"preds": decode_maps(feats, self.strides, self.reg_max), "feats": feats}

    def bias_init(self) -> None:
        """None: the JAX package gives YOLOE no bias prior (nn/model.py:376-387)."""


class YOLOESegment(YOLOEDetect):
    """YOLOEDetect + Proto masks + the coefficient branch ``cv5`` (reference
    yoloe.py:179-217): train adds ``mask_coefs`` (B, A, nm) and ``proto``;
    eval ``preds`` (B, A, 4 + K + nm) and ``proto``."""

    def __init__(self, nc: int, nm: int = 32, npr: int = 256, embed: int = 512, with_bn: bool = True,
                 ch: Sequence[int] = (), strides: Sequence[int] | None = None):
        super().__init__(nc, embed, with_bn, ch, strides)
        self.nm, self.npr = nm, npr
        self.proto = Proto(ch[0], npr, nm)
        c5 = max(ch[0] // 4, nm)
        self.cv5 = nn.ModuleList(nn.Sequential(ConvBNAct(x, c5, 3), ConvBNAct(c5, c5, 3), Conv2d(c5, nm, 1))
                                 for x in ch)

    def forward(self, xs: Sequence[torch.Tensor], txt_feats: torch.Tensor,
                visual_prompts: torch.Tensor | None = None) -> dict[str, Any]:
        proto = self.proto(xs[0])
        mc = _anchor_major([m(x) for m, x in zip(self.cv5, xs)])
        out = super().forward(xs, txt_feats, visual_prompts)
        if self.training:
            return {**out, "mask_coefs": mc, "proto": proto}
        return {"preds": torch.cat([out["preds"], mc.float()], dim=-1), "proto": proto, "feats": out["feats"]}
