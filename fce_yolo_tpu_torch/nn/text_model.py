"""Text embeddings for the open-vocabulary models (reference
``fce_yolo_tpu/nn/text_model.py``).

- ``HashTextEncoder``: the offline stand-in, a unit vector a string drawn
  from ``numpy``'s ``default_rng`` seeded by the string's SHA-256, bit-equal
  to the JAX one. Stable across runs, not semantic. The default.
- ``CLIPTextTower``: the CLIP text transformer as an ``nn.Module`` with
  openai-``clip``'s parameter names (``token_embedding``,
  ``transformer.resblocks.{i}.attn.in_proj_weight``, ``ln_final``,
  ``text_projection``): token + positional embeddings, pre-LN causal blocks
  with packed QKV (LayerNorm eps 1e-5, quick-GELU), the first end-of-text
  token's state pooled, the projection, then an L2 norm.
  ``clip_text_state_dict`` takes an openai or a HuggingFace
  ``CLIPTextModelWithProjection`` state dict to the tower's names, as the
  JAX ``clip_text_state_dict_to_variables`` (``:132``) takes both to flax.
- ``CLIPTextEncoder`` / ``build_text_model("hash:512" | "clip[:<path>]")``.

Without weights the tower is a seeded random init, not the JAX one (flax's
initialisers cannot be drawn the same way). The JAX encoder without a BPE
vocab first tries ``transformers``' locally cached tokenizer; the port goes
straight to the hash tokenization (the card's machine has no
``transformers``).
"""

from __future__ import annotations

import hashlib
import warnings
from collections import OrderedDict
from dataclasses import dataclass

import numpy as np
import torch
import torch.nn.functional as F
from torch import nn

__all__ = ["HashTextEncoder", "CLIPTextCfg", "CLIPTextTower", "CLIPTextEncoder", "clip_text_state_dict",
           "build_text_model", "Transformer"]


class HashTextEncoder:
    """Deterministic per-string unit-norm embeddings (offline CLIP stand-in)."""

    def __init__(self, dim: int = 512):
        self.dim = dim

    def tokenize(self, texts):
        return list(texts)

    def encode_text(self, tokens) -> np.ndarray:
        out = np.empty((len(tokens), self.dim), np.float32)
        for i, t in enumerate(tokens):
            seed = int.from_bytes(hashlib.sha256(str(t).encode()).digest()[:8], "little")
            v = np.random.default_rng(seed).standard_normal(self.dim).astype(np.float32)
            out[i] = v / np.linalg.norm(v)
        return out


@dataclass(frozen=True)
class CLIPTextCfg:
    """ViT-B/32 text-tower defaults (openai CLIP / HF CLIPTextConfig)."""

    vocab: int = 49408
    width: int = 512
    heads: int = 8
    layers: int = 12
    ctx: int = 77
    proj: int = 512
    eos_id: int = 49407


class QuickGELU(nn.Module):
    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return x * torch.sigmoid(1.702 * x)


class PackedAttention(nn.Module):
    """Multi-head self-attention with one packed (3C, C) QKV projection,
    openai's ``attn`` names (``in_proj_weight``, ``in_proj_bias``, ``out_proj``)."""

    def __init__(self, width: int, heads: int):
        super().__init__()
        self.heads = heads
        self.in_proj_weight = nn.Parameter(torch.empty(3 * width, width))
        self.in_proj_bias = nn.Parameter(torch.zeros(3 * width))
        self.out_proj = nn.Linear(width, width)

    def forward(self, x: torch.Tensor, causal: bool) -> torch.Tensor:
        b, n, c = x.shape
        q, k, v = (t.reshape(b, n, self.heads, c // self.heads).transpose(1, 2)
                   for t in F.linear(x, self.in_proj_weight, self.in_proj_bias).chunk(3, dim=-1))
        o = F.scaled_dot_product_attention(q, k, v, is_causal=causal)
        return self.out_proj(o.transpose(1, 2).reshape(b, n, c))


class ResidualAttentionBlock(nn.Module):
    """Pre-LN transformer block: x + attn(ln_1(x)), then x + mlp(ln_2(x))."""

    def __init__(self, width: int, heads: int):
        super().__init__()
        self.ln_1 = nn.LayerNorm(width, eps=1e-5)
        self.attn = PackedAttention(width, heads)
        self.ln_2 = nn.LayerNorm(width, eps=1e-5)
        self.mlp = nn.Sequential(OrderedDict(c_fc=nn.Linear(width, 4 * width), gelu=QuickGELU(),
                                             c_proj=nn.Linear(4 * width, width)))

    def forward(self, x: torch.Tensor, causal: bool) -> torch.Tensor:
        x = x + self.attn(self.ln_1(x), causal)
        return x + self.mlp(self.ln_2(x))


class Transformer(nn.Module):
    """``resblocks`` of one CLIP tower (shared by the text and vision towers)."""

    def __init__(self, width: int, heads: int, layers: int, causal: bool):
        super().__init__()
        self.causal = causal
        self.resblocks = nn.ModuleList(ResidualAttentionBlock(width, heads) for _ in range(layers))

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        for blk in self.resblocks:
            x = blk(x, self.causal)
        return x

    @torch.no_grad()
    def reset_parameters(self, generator: torch.Generator) -> None:
        """Seeded init: projections N(0, 0.02), biases 0, LayerNorms (1, 0)."""
        for blk in self.resblocks:
            for w in (blk.attn.in_proj_weight, blk.attn.out_proj.weight, blk.mlp.c_fc.weight, blk.mlp.c_proj.weight):
                w.copy_(torch.randn(w.shape, generator=generator) * 0.02)
            for b in (blk.attn.in_proj_bias, blk.attn.out_proj.bias, blk.mlp.c_fc.bias, blk.mlp.c_proj.bias):
                b.zero_()
            blk.ln_1.reset_parameters()
            blk.ln_2.reset_parameters()


class CLIPTextTower(nn.Module):
    """CLIP text transformer (module docstring): int tokens (B, L) ->
    L2-normalized (B, proj) float embeddings."""

    def __init__(self, cfg: CLIPTextCfg = CLIPTextCfg()):
        super().__init__()
        self.cfg = cfg
        self.token_embedding = nn.Embedding(cfg.vocab, cfg.width)
        self.positional_embedding = nn.Parameter(torch.empty(cfg.ctx, cfg.width))
        self.transformer = Transformer(cfg.width, cfg.heads, cfg.layers, causal=True)
        self.ln_final = nn.LayerNorm(cfg.width, eps=1e-5)
        self.text_projection = nn.Parameter(torch.empty(cfg.width, cfg.proj))

    @torch.no_grad()
    def reset_parameters(self, seed: int = 0) -> "CLIPTextTower":
        g = torch.Generator().manual_seed(seed)
        self.token_embedding.weight.copy_(torch.randn(self.token_embedding.weight.shape, generator=g) * 0.02)
        self.positional_embedding.copy_(torch.randn(self.positional_embedding.shape, generator=g) * 0.01)
        self.transformer.reset_parameters(g)
        self.ln_final.reset_parameters()
        self.text_projection.copy_(torch.randn(self.text_projection.shape, generator=g) * 0.02)
        return self

    def forward(self, tokens: torch.Tensor) -> torch.Tensor:
        tokens = tokens.long()
        b, n = tokens.shape
        x = self.transformer(self.token_embedding(tokens) + self.positional_embedding[:n])
        x = self.ln_final(x)
        # the first end-of-text token (HF's pooling; for openai tokens argmax(id) is the same slot), else the last
        is_eos = tokens == self.cfg.eos_id
        eot = torch.where(is_eos.any(-1), is_eos.int().argmax(-1), n - 1)
        out = x[torch.arange(b, device=x.device), eot] @ self.text_projection
        return out / out.norm(dim=-1, keepdim=True)


def _np(v) -> torch.Tensor:
    return v.detach().float().cpu() if isinstance(v, torch.Tensor) else torch.from_numpy(np.asarray(v, np.float32))


def _hf_blocks(sd: dict, src: str, dst: str, layers: int) -> dict:
    """HF ``{src}.{i}`` encoder layers -> openai ``{dst}.{i}`` resblocks (q, k, v packed)."""
    out = {}
    for i in range(layers):
        s, d = f"{src}.{i}", f"{dst}.{i}"
        for leaf in ("weight", "bias"):
            out[f"{d}.attn.in_proj_{leaf}"] = torch.cat([sd[f"{s}.self_attn.{n}_proj.{leaf}"] for n in "qkv"], 0)
            out[f"{d}.attn.out_proj.{leaf}"] = sd[f"{s}.self_attn.out_proj.{leaf}"]
            out[f"{d}.ln_1.{leaf}"] = sd[f"{s}.layer_norm1.{leaf}"]
            out[f"{d}.ln_2.{leaf}"] = sd[f"{s}.layer_norm2.{leaf}"]
            out[f"{d}.mlp.c_fc.{leaf}"] = sd[f"{s}.mlp.fc1.{leaf}"]
            out[f"{d}.mlp.c_proj.{leaf}"] = sd[f"{s}.mlp.fc2.{leaf}"]
    return out


def _openai_blocks(sd: dict, src: str, layers: int) -> dict:
    keys = ("attn.in_proj_weight", "attn.in_proj_bias", "attn.out_proj.weight", "attn.out_proj.bias",
            *(f"{m}.{leaf}" for m in ("ln_1", "ln_2", "mlp.c_fc", "mlp.c_proj") for leaf in ("weight", "bias")))
    return {f"transformer.resblocks.{i}.{k}": sd[f"{src}.{i}.{k}"] for i in range(layers) for k in keys}


def clip_text_state_dict(sd, cfg: CLIPTextCfg = CLIPTextCfg()) -> dict[str, torch.Tensor]:
    """A CLIP text-tower state dict in either naming -> ``CLIPTextTower``'s
    (float32 on the CPU): HuggingFace ``CLIPTextModelWithProjection``
    (``text_model.encoder.layers.{i}.self_attn.q_proj.weight``, ...,
    ``text_projection.weight`` stored (P, D)) or openai ``clip``
    (``transformer.resblocks.{i}.attn.in_proj_weight``, ...,
    ``text_projection`` stored (D, P)). Other keys (the vision half) are left."""
    sd = {k: _np(v) for k, v in sd.items()}
    if any(k.startswith("text_model.") for k in sd):
        t = "text_model"
        return {"token_embedding.weight": sd[f"{t}.embeddings.token_embedding.weight"],
                "positional_embedding": sd[f"{t}.embeddings.position_embedding.weight"],
                **_hf_blocks(sd, f"{t}.encoder.layers", "transformer.resblocks", cfg.layers),
                "ln_final.weight": sd[f"{t}.final_layer_norm.weight"],
                "ln_final.bias": sd[f"{t}.final_layer_norm.bias"],
                "text_projection": sd["text_projection.weight"].t().contiguous()}
    return {"token_embedding.weight": sd["token_embedding.weight"],
            "positional_embedding": sd["positional_embedding"],
            **_openai_blocks(sd, "transformer.resblocks", cfg.layers),
            "ln_final.weight": sd["ln_final.weight"], "ln_final.bias": sd["ln_final.bias"],
            "text_projection": sd["text_projection"]}


def load_any_state_dict(path: str) -> dict:
    """A state dict from a ``.npz`` or a torch file (a module, or a dict with ``state_dict``)."""
    if str(path).endswith(".npz"):
        return dict(np.load(path))
    obj = torch.load(path, map_location="cpu", weights_only=False)
    sd = obj.state_dict() if hasattr(obj, "state_dict") else obj
    return sd.get("state_dict", sd)


class CLIPTextEncoder:
    """The CLIP tower behind the text-model contract (``tokenize`` ->
    ``encode_text`` -> (N, proj) float32 numpy). ``weights``: an openai or HF
    state-dict path; without one a seeded random tower. On ``device``: the
    card unless another is named."""

    def __init__(self, cfg: CLIPTextCfg | None = None, weights: str | None = None, seed: int = 0,
                 vocab: str | None = None, device: torch.device | str = "cuda"):
        from fce_yolo_tpu_torch.nn.bpe import find_local_vocab

        self.cfg = cfg or CLIPTextCfg()
        self.device = torch.device(device)
        self.model = CLIPTextTower(self.cfg)
        if weights:
            self.model.load_state_dict(clip_text_state_dict(load_any_state_dict(weights), self.cfg))
        else:
            self.model.reset_parameters(seed)
        self.model.to(self.device).eval()
        self.vocab = vocab or find_local_vocab()
        self._bpe = None
        self._warned = False

    def tokenize(self, texts) -> np.ndarray:
        """CLIP's BPE (``nn/bpe.py``) with a vocab (``vocab=`` or
        ``FY_CLIP_VOCAB``); else a deterministic hash of each word into the
        vocab (stable, not semantic), with a warning."""
        texts = [str(t) for t in texts]
        if self.vocab:
            if self._bpe is None:
                from fce_yolo_tpu_torch.nn.bpe import CLIPBPETokenizer

                self._bpe = CLIPBPETokenizer(self.vocab, context_length=self.cfg.ctx)
            return self._bpe.tokenize(texts)
        if not self._warned:
            self._warned = True
            warnings.warn("CLIPTextEncoder: no BPE vocab found (pass vocab= or set FY_CLIP_VOCAB to a local merges "
                          "file): falling back to the deterministic NON-SEMANTIC hash tokenizer", stacklevel=2)
        toks = np.zeros((len(texts), self.cfg.ctx), np.int32)
        for i, t in enumerate(texts):
            words = t.lower().split() or [t]
            ids = [int.from_bytes(hashlib.sha256(w.encode()).digest()[:4], "little") % (self.cfg.vocab - 2) + 1
                   for w in words[: self.cfg.ctx - 2]]
            row = [0, *ids, self.cfg.eos_id]
            toks[i, : len(row)] = row
        return toks

    @torch.inference_mode()
    def encode_text(self, tokens) -> np.ndarray:
        if not isinstance(tokens, np.ndarray) or tokens.dtype.kind not in "iu":
            tokens = self.tokenize(tokens)
        return self.model(torch.from_numpy(np.asarray(tokens)).to(self.device)).float().cpu().numpy()


def build_text_model(spec: str = "hash:512", device: torch.device | str = "cuda", weights: str | None = None,
                     vocab: str | None = None):
    """``hash:<dim>`` -> ``HashTextEncoder`` (the default); ``clip`` /
    ``clip:<weights-path>`` -> ``CLIPTextEncoder`` on ``device`` (a seeded
    random tower without weights), BPE from ``vocab`` or ``FY_CLIP_VOCAB``
    (reference ``build_text_model``, nn/text_model.py:350)."""
    if spec.startswith("hash"):
        return HashTextEncoder(int(spec.split(":")[1]) if ":" in spec else 512)
    if spec.startswith("clip") or spec.startswith("mobileclip"):
        w = weights or (spec.split(":", 1)[1] if ":" in spec else None)
        return CLIPTextEncoder(weights=w or None, vocab=vocab, device=device)
    raise NotImplementedError(f"text model {spec!r}: use 'hash:<dim>', 'clip', or 'clip:<local-checkpoint-path>'")
