"""Transformer modules of RT-DETR (reference ``fce_yolo_tpu/nn/transformer.py``).

NCHW maps outside, (B, N, C) token sequences inside. Attribute names follow
Ultralytics (``ma.in_proj_weight``, ``ma.out_proj``, ``fc1``, ``norm1``,
``cross_attn.sampling_offsets``, ``layers.0``), so an Ultralytics ``.pt``
loads by name and the JAX weight bridge (``nn/weights.py``) is a rewrite:
flax ``Dense`` kernels are transposed, a ``LayerNorm``'s ``scale`` is its
``weight``, the attention's packed ``in_proj_*`` keep torch's layout and its
``out_proj_{weight,bias}`` are the ``out_proj`` Linear's.

As in the JAX package: ``LayerNorm`` eps 1e-6 (flax's default; torch's is
1e-5) and ``gelu`` in its tanh form (``jax.nn.gelu``'s default; the AIFI
FFN), ROADMAP queue 3, item 34.

Deformable sampling is ``F.grid_sample`` (bilinear, zero padding,
``align_corners=False``) on the ``2 * loc - 1`` grid, which computes what
the JAX package's four corner gathers compute; it runs in float32 whatever
the model's dtype, so bf16 weights do not round the sampling positions.
"""

from __future__ import annotations

from typing import Sequence

import numpy as np
import torch
import torch.nn.functional as F
from torch import nn

__all__ = ["TorchMHA", "TransformerEncoderLayer", "AIFI", "MLP", "LayerNorm2d", "MSDeformAttn",
           "DeformableTransformerDecoderLayer", "DeformableTransformerDecoder", "build_2d_sincos_pos_embed",
           "inverse_sigmoid", "sampling_offsets_bias", "LN_EPS"]

LN_EPS = 1e-6  # flax nn.LayerNorm's epsilon


class TorchMHA(nn.Module):
    """Multi-head attention with ``nn.MultiheadAttention``'s parameters
    (packed ``in_proj_weight`` (3C, C), ``in_proj_bias``, ``out_proj``
    Linear), reference ``_TorchMHA`` (transformer.py:27-56). ``attn_mask``
    is True where attention is blocked (torch's convention);
    ``F.scaled_dot_product_attention`` takes True as allowed, so it is
    inverted."""

    def __init__(self, c: int, num_heads: int):
        super().__init__()
        self.c, self.num_heads = c, num_heads
        self.in_proj_weight = nn.Parameter(torch.empty(3 * c, c))
        self.in_proj_bias = nn.Parameter(torch.zeros(3 * c))
        self.out_proj = nn.Linear(c, c)
        nn.init.xavier_uniform_(self.in_proj_weight)

    def forward(self, q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                attn_mask: torch.Tensor | None = None) -> torch.Tensor:
        c, h = self.c, self.num_heads
        wq, wk, wv = self.in_proj_weight.chunk(3)
        bq, bk, bv = self.in_proj_bias.chunk(3)
        b = q.shape[0]

        def heads(x, w, bias):
            return F.linear(x, w, bias).view(b, -1, h, c // h).transpose(1, 2)  # (B, h, N, hd)

        out = F.scaled_dot_product_attention(heads(q, wq, bq), heads(k, wk, bk), heads(v, wv, bv),
                                             attn_mask=None if attn_mask is None else ~attn_mask)
        return self.out_proj(out.transpose(1, 2).reshape(b, -1, c))


class TransformerEncoderLayer(nn.Module):
    """MHA + FFN encoder layer, post-norm, tanh GELU in the FFN (reference
    transformer.py:59-86; its pre-norm form and other activations have no
    caller)."""

    def __init__(self, c1: int, cm: int = 2048, num_heads: int = 8):
        super().__init__()
        self.ma = TorchMHA(c1, num_heads)
        self.fc1 = nn.Linear(c1, cm)
        self.fc2 = nn.Linear(cm, c1)
        self.norm1 = nn.LayerNorm(c1, eps=LN_EPS)
        self.norm2 = nn.LayerNorm(c1, eps=LN_EPS)

    def forward(self, src: torch.Tensor, pos: torch.Tensor | None = None) -> torch.Tensor:
        q = src if pos is None else src + pos
        src = self.norm1(src + self.ma(q, q, src))
        return self.norm2(src + self.fc2(F.gelu(self.fc1(src), approximate="tanh")))


def build_2d_sincos_pos_embed(w: int, h: int, embed_dim: int, temperature: float = 10000.0) -> torch.Tensor:
    """(1, h * w, embed_dim) sine-cosine embedding in [sin_w, cos_w, sin_h,
    cos_h] channel order, the grid flattened w-major as the reference does
    although the features flatten h-major (reference transformer.py:101-117;
    numpy float32, so it equals the JAX package's table bit for bit)."""
    assert embed_dim % 4 == 0
    gw, gh = np.meshgrid(np.arange(w, dtype=np.float32), np.arange(h, dtype=np.float32), indexing="ij")
    pos_dim = embed_dim // 4
    omega = 1.0 / temperature ** (np.arange(pos_dim, dtype=np.float32) / pos_dim)
    out_w = gw.reshape(-1)[:, None] * omega[None]
    out_h = gh.reshape(-1)[:, None] * omega[None]
    emb = np.concatenate([np.sin(out_w), np.cos(out_w), np.sin(out_h), np.cos(out_h)], axis=1)
    return torch.from_numpy(emb)[None]


class AIFI(TransformerEncoderLayer):
    """Attention over the flattened grid with sin-cos positions (reference
    transformer.py:89-98). Input and output (B, C, H, W). The position
    table is made once per (w, h, device, dtype), never as an inference
    tensor (a later training forward could not save it)."""

    def __init__(self, c1: int, cm: int = 2048, num_heads: int = 8):
        super().__init__(c1, cm, num_heads)
        self._pos: dict[tuple, torch.Tensor] = {}

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        b, c, h, w = x.shape
        key = (w, h, c, x.device, x.dtype)
        if key not in self._pos:
            with torch.inference_mode(False):
                self._pos[key] = build_2d_sincos_pos_embed(w, h, c).to(x.device, x.dtype)
        y = super().forward(x.flatten(2).transpose(1, 2), pos=self._pos[key])
        return y.transpose(1, 2).reshape(b, c, h, w)


class MLP(nn.Module):
    """Stacked Linears with ReLU between them (reference transformer.py:120-137)."""

    def __init__(self, input_dim: int, hidden_dim: int, output_dim: int, num_layers: int = 3):
        super().__init__()
        dims = [input_dim] + [hidden_dim] * (num_layers - 1) + [output_dim]
        self.layers = nn.ModuleList(nn.Linear(a, b) for a, b in zip(dims[:-1], dims[1:]))

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        for i, layer in enumerate(self.layers):
            x = layer(x)
            if i < len(self.layers) - 1:
                x = F.relu(x)
        return x


class LayerNorm2d(nn.Module):
    """Channel LayerNorm over (B, C, H, W) maps (reference transformer.py:140-145,
    its flax ``ln`` scope kept as a child)."""

    def __init__(self, c: int):
        super().__init__()
        self.ln = nn.LayerNorm(c, eps=LN_EPS)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return self.ln(x.permute(0, 2, 3, 1)).permute(0, 3, 1, 2)


def inverse_sigmoid(x: torch.Tensor, eps: float = 1e-5) -> torch.Tensor:
    """logit with the reference's clamping (transformer.py:148-153)."""
    x = x.clamp(0.0, 1.0)
    return torch.log(x.clamp(min=eps) / (1.0 - x).clamp(min=eps))


def sampling_offsets_bias(n_heads: int, n_levels: int, n_points: int) -> torch.Tensor:
    """The ``sampling_offsets`` bias of a fresh MSDeformAttn (reference
    ``_sampling_offsets_bias_init``, transformer.py:156-171): per head a unit
    direction, scaled by the point's index + 1."""
    thetas = np.arange(n_heads, dtype=np.float32) * (2.0 * np.pi / n_heads)
    grid = np.stack([np.cos(thetas), np.sin(thetas)], -1)
    grid = grid / np.abs(grid).max(-1, keepdims=True)
    grid = np.tile(grid[:, None, None, :], (1, n_levels, n_points, 1))
    for i in range(n_points):
        grid[:, :, i, :] *= i + 1
    return torch.from_numpy(grid.reshape(-1).copy())


class MSDeformAttn(nn.Module):
    """Multi-scale deformable attention (reference transformer.py:174-254,
    Deformable-DETR): per query, head, level and point an offset from the
    reference point (or box) and a softmax weight over levels x points;
    values sampled bilinearly from each level's map."""

    def __init__(self, d_model: int = 256, n_levels: int = 4, n_heads: int = 8, n_points: int = 4):
        super().__init__()
        self.d_model, self.n_levels, self.n_heads, self.n_points = d_model, n_levels, n_heads, n_points
        self.sampling_offsets = nn.Linear(d_model, n_heads * n_levels * n_points * 2)
        self.attention_weights = nn.Linear(d_model, n_heads * n_levels * n_points)
        self.value_proj = nn.Linear(d_model, d_model)
        self.output_proj = nn.Linear(d_model, d_model)
        self.reset_offsets()

    @torch.no_grad()
    def reset_offsets(self) -> None:
        """Zero kernels for the offsets and the attention weights, the
        direction grid as the offsets' bias (the JAX initialisation)."""
        nn.init.zeros_(self.sampling_offsets.weight)
        self.sampling_offsets.bias.copy_(sampling_offsets_bias(self.n_heads, self.n_levels, self.n_points))
        nn.init.zeros_(self.attention_weights.weight)
        nn.init.zeros_(self.attention_weights.bias)

    def forward(self, query: torch.Tensor, refer_bbox: torch.Tensor, value: torch.Tensor,
                value_shapes: Sequence[tuple[int, int]]) -> torch.Tensor:
        """query (B, nq, C); refer_bbox (B, nq, n_levels, 2 or 4) in [0, 1];
        value (B, sum(H*W), C); value_shapes [(H, W)] per level."""
        c, nh, nl, npts = self.d_model, self.n_heads, self.n_levels, self.n_points
        hd = c // nh
        b, nq = query.shape[:2]
        v = self.value_proj(value).float()
        offsets = self.sampling_offsets(query).float().view(b, nq, nh, nl, npts, 2)
        attn = self.attention_weights(query).float().view(b, nq, nh, nl * npts).softmax(-1)
        ref = refer_bbox.float()
        if ref.shape[-1] == 2:
            norm = torch.tensor([[wl, hl] for hl, wl in value_shapes], dtype=torch.float32, device=query.device)
            loc = ref[:, :, None, :, None, :] + offsets / norm[None, None, None, :, None, :]
        else:  # xywh boxes scale the offsets (reference transformer.py:574)
            loc = ref[:, :, None, :, None, :2] + offsets / npts * ref[:, :, None, :, None, 2:] * 0.5
        grid = (2 * loc - 1).transpose(1, 2).flatten(0, 1)  # (B * nh, nq, nl, np, 2)
        sampled = []
        for lvl, (value_l, (hl, wl)) in enumerate(zip(v.split([h_ * w_ for h_, w_ in value_shapes], 1),
                                                      value_shapes)):
            value_l = value_l.view(b, hl * wl, nh, hd).permute(0, 2, 3, 1).reshape(b * nh, hd, hl, wl)
            sampled.append(F.grid_sample(value_l, grid[:, :, lvl], mode="bilinear", padding_mode="zeros",
                                         align_corners=False))  # (B * nh, hd, nq, np)
        attn = attn.transpose(1, 2).reshape(b * nh, 1, nq, nl * npts)
        out = (torch.stack(sampled, dim=-2).flatten(-2) * attn).sum(-1)  # (B * nh, hd, nq)
        out = out.view(b, c, nq).transpose(1, 2).to(query.dtype)
        return self.output_proj(out)


class DeformableTransformerDecoderLayer(nn.Module):
    """Self-attention, deformable cross-attention and a ReLU FFN, each
    followed by a residual LayerNorm (reference transformer.py:257-285)."""

    def __init__(self, d_model: int = 256, n_heads: int = 8, d_ffn: int = 1024, n_levels: int = 4,
                 n_points: int = 4):
        super().__init__()
        self.self_attn = TorchMHA(d_model, n_heads)
        self.norm1 = nn.LayerNorm(d_model, eps=LN_EPS)
        self.cross_attn = MSDeformAttn(d_model, n_levels, n_heads, n_points)
        self.norm2 = nn.LayerNorm(d_model, eps=LN_EPS)
        self.linear1 = nn.Linear(d_model, d_ffn)
        self.linear2 = nn.Linear(d_ffn, d_model)
        self.norm3 = nn.LayerNorm(d_model, eps=LN_EPS)

    def forward(self, embed: torch.Tensor, refer_bbox: torch.Tensor, feats: torch.Tensor,
                shapes: Sequence[tuple[int, int]], attn_mask: torch.Tensor | None = None,
                query_pos: torch.Tensor | None = None) -> torch.Tensor:
        q = embed if query_pos is None else embed + query_pos
        embed = self.norm1(embed + self.self_attn(q, q, embed, attn_mask))
        q = embed if query_pos is None else embed + query_pos
        embed = self.norm2(embed + self.cross_attn(q, refer_bbox[:, :, None, :], feats, shapes))
        return self.norm3(embed + self.linear2(F.relu(self.linear1(embed))))


class DeformableTransformerDecoder(nn.Module):
    """The decoder layers' container (Ultralytics' ``decoder.layers.N``); the
    refinement loop runs in ``RTDETRDecoder``, as in the JAX head."""

    def __init__(self, layers: Sequence[nn.Module]):
        super().__init__()
        self.layers = nn.ModuleList(layers)

