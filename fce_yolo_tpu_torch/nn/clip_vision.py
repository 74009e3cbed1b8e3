"""CLIP vision tower, the image half of the CLIP pair (reference
``fce_yolo_tpu/nn/clip_vision.py``): patch-embedding conv, class token,
positional embedding, ``ln_pre``, the pre-LN transformer of
``nn/text_model.py`` (packed QKV, quick-GELU, not causal), ``ln_post`` of
the class token, the projection, an L2 norm. Parameter names are openai's
``visual.*`` without the prefix; ``clip_vision_state_dict`` takes an openai
or a HuggingFace ``CLIPVisionModelWithProjection`` state dict to them.

``clip_preprocess`` resizes the shorter side bicubically (a=-0.75, half-pixel
centres, edges replicated: cv2's ``INTER_CUBIC``, which the JAX package
calls, in float arithmetic, rounded to uint8; cv2 works in fixed point, so a
pixel may differ by one level), centre-crops and normalizes.
"""

from __future__ import annotations

from dataclasses import dataclass

import numpy as np
import torch
import torch.nn.functional as F
from torch import nn

from fce_yolo_tpu_torch.nn.text_model import Transformer, _hf_blocks, _np, _openai_blocks, load_any_state_dict

__all__ = ["CLIPVisionCfg", "CLIPVisionTower", "CLIPImageEncoder", "clip_vision_state_dict", "clip_preprocess"]

CLIP_MEAN = np.array([0.48145466, 0.4578275, 0.40821073], np.float32)  # openai clip/clip.py _transform
CLIP_STD = np.array([0.26862954, 0.26130258, 0.27577711], np.float32)


@dataclass(frozen=True)
class CLIPVisionCfg:
    """ViT-B/32 vision-tower defaults."""

    image_size: int = 224
    patch: int = 32
    width: int = 768
    heads: int = 12
    layers: int = 12
    proj: int = 512


class CLIPVisionTower(nn.Module):
    """ViT image encoder: CLIP-normalized float NCHW (B, 3, S, S) ->
    L2-normalized (B, proj)."""

    def __init__(self, cfg: CLIPVisionCfg = CLIPVisionCfg()):
        super().__init__()
        self.cfg = cfg
        n = (cfg.image_size // cfg.patch) ** 2
        self.conv1 = nn.Conv2d(3, cfg.width, cfg.patch, cfg.patch, bias=False)
        self.class_embedding = nn.Parameter(torch.empty(cfg.width))
        self.positional_embedding = nn.Parameter(torch.empty(n + 1, cfg.width))
        self.ln_pre = nn.LayerNorm(cfg.width, eps=1e-5)
        self.transformer = Transformer(cfg.width, cfg.heads, cfg.layers, causal=False)
        self.ln_post = nn.LayerNorm(cfg.width, eps=1e-5)
        self.proj = nn.Parameter(torch.empty(cfg.width, cfg.proj))

    @torch.no_grad()
    def reset_parameters(self, seed: int = 0) -> "CLIPVisionTower":
        g = torch.Generator().manual_seed(seed)
        fan_in = 3 * self.cfg.patch ** 2
        self.conv1.weight.copy_(torch.randn(self.conv1.weight.shape, generator=g) / fan_in ** 0.5)
        self.class_embedding.copy_(torch.randn(self.class_embedding.shape, generator=g) * 0.02)
        self.positional_embedding.copy_(torch.randn(self.positional_embedding.shape, generator=g) * 0.01)
        self.transformer.reset_parameters(g)
        self.ln_pre.reset_parameters()
        self.ln_post.reset_parameters()
        self.proj.copy_(torch.randn(self.proj.shape, generator=g) * 0.02)
        return self

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        x = self.conv1(x).flatten(2).transpose(1, 2)  # (B, g*g, D), patches row-major
        cls = self.class_embedding.to(x.dtype).expand(x.shape[0], 1, -1)
        x = self.ln_pre(torch.cat([cls, x], 1) + self.positional_embedding)
        x = self.ln_post(self.transformer(x)[:, 0])
        out = x @ self.proj
        return out / out.norm(dim=-1, keepdim=True)


def clip_vision_state_dict(sd, cfg: CLIPVisionCfg = CLIPVisionCfg()) -> dict[str, torch.Tensor]:
    """A CLIP vision state dict, HuggingFace ``CLIPVisionModelWithProjection``
    (``vision_model.*``, ``visual_projection.weight`` (P, D)) or openai
    (``visual.*``, ``visual.proj`` (D, P)) -> ``CLIPVisionTower``'s names
    (float32 on the CPU). Other keys (the text half) are left."""
    sd = {k: _np(v) for k, v in sd.items()}
    if any(k.startswith("vision_model.") for k in sd):
        e = "vision_model.embeddings"
        return {"conv1.weight": sd[f"{e}.patch_embedding.weight"], "class_embedding": sd[f"{e}.class_embedding"],
                "positional_embedding": sd[f"{e}.position_embedding.weight"],
                "ln_pre.weight": sd["vision_model.pre_layrnorm.weight"],  # HF spells it "pre_layrnorm"
                "ln_pre.bias": sd["vision_model.pre_layrnorm.bias"],
                **_hf_blocks(sd, "vision_model.encoder.layers", "transformer.resblocks", cfg.layers),
                "ln_post.weight": sd["vision_model.post_layernorm.weight"],
                "ln_post.bias": sd["vision_model.post_layernorm.bias"],
                "proj": sd["visual_projection.weight"].t().contiguous()}
    v = "visual"
    return {"conv1.weight": sd[f"{v}.conv1.weight"], "class_embedding": sd[f"{v}.class_embedding"],
            "positional_embedding": sd[f"{v}.positional_embedding"],
            "ln_pre.weight": sd[f"{v}.ln_pre.weight"], "ln_pre.bias": sd[f"{v}.ln_pre.bias"],
            **_openai_blocks(sd, f"{v}.transformer.resblocks", cfg.layers),
            "ln_post.weight": sd[f"{v}.ln_post.weight"], "ln_post.bias": sd[f"{v}.ln_post.bias"],
            "proj": sd[f"{v}.proj"]}


def clip_preprocess(img: np.ndarray, size: int = 224) -> np.ndarray:
    """BGR uint8 HWC -> CLIP-normalized RGB float32 (size, size, 3): the
    shorter side resized to ``size`` (module docstring), centre crop, mean/std
    (clip/clip.py ``_transform``)."""
    h, w = img.shape[:2]
    s = size / min(h, w)
    nh, nw = max(size, int(round(h * s))), max(size, int(round(w * s)))
    x = torch.from_numpy(np.ascontiguousarray(img)).permute(2, 0, 1)[None].float()
    x = F.interpolate(x, size=(nh, nw), mode="bicubic", align_corners=False).round().clamp(0, 255)
    x = x[0].permute(1, 2, 0).numpy()
    top, left = (nh - size) // 2, (nw - size) // 2
    x = x[top: top + size, left: left + size, ::-1]  # BGR -> RGB
    return (x / 255.0 - CLIP_MEAN) / CLIP_STD


class CLIPImageEncoder:
    """``encode_image(crops) -> (N, proj)`` unit-norm float32 numpy. ``weights``:
    an openai or HF checkpoint path; without one a seeded random tower. On
    ``device``: the card unless another is named."""

    def __init__(self, cfg: CLIPVisionCfg | None = None, weights: str | None = None, seed: int = 0,
                 device: torch.device | str = "cuda"):
        self.cfg = cfg or CLIPVisionCfg()
        self.device = torch.device(device)
        self.model = CLIPVisionTower(self.cfg)
        if weights:
            self.model.load_state_dict(clip_vision_state_dict(load_any_state_dict(weights), self.cfg))
        else:
            self.model.reset_parameters(seed)
        self.model.to(self.device).eval()

    @torch.inference_mode()
    def encode_image(self, imgs) -> np.ndarray:
        """``imgs``: BGR uint8 crops of any size, or a pre-normalized (N, S, S, 3) float array."""
        if isinstance(imgs, np.ndarray) and imgs.dtype.kind == "f" and imgs.ndim == 4:
            x = imgs
        else:
            x = np.stack([clip_preprocess(np.asarray(im), self.cfg.image_size) for im in imgs])
        x = torch.from_numpy(np.ascontiguousarray(x, np.float32)).to(self.device).permute(0, 3, 1, 2)
        return self.model(x).float().cpu().numpy()
