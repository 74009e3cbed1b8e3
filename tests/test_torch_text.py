"""The port's text side against the JAX package: the CLIP BPE tokenizer
(``nn/bpe.py``, split by the standard library where the JAX one uses the
``regex`` package), the hash text encoder, and the CLIP text and vision
towers (``nn/text_model.py``, ``nn/clip_vision.py``) with both state-dict
namings and the encoders built on them.

Tolerances: token ids and hash embeddings equal; the towers' float32
embeddings within 1e-5 absolute (unit vectors; summation order only);
``clip_preprocess`` within one uint8 level over the channel's std (cv2's
bicubic resize is fixed point, the port's float).
"""

import gzip
import json
import sys

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from fce_yolo_tpu.nn import bpe as JB
from fce_yolo_tpu.nn import clip_vision as JV
from fce_yolo_tpu.nn import text_model as JT
from fce_yolo_tpu_torch.nn import bpe as PB
from fce_yolo_tpu_torch.nn import clip_vision as PV
from fce_yolo_tpu_torch.nn import text_model as PT

torch.set_num_threads(1)

CORPUS = [
    "a photo of a cat", "The dog's bowl", "THEY'RE HERE, WE'VE GOT IT, I'M SURE, YOU'LL SEE, IT'S, DON'T, HE'D",
    "héllo wörld café naïve Øresund", "机械臂 抓取 方形工件", "한국어 텍스트", "数字 0123456789 and 42nd",
    "emoji 🙂 ok 👍🏽 🐈‍⬛", "<|startoftext|> spaced <|endoftext|>", "<|STARTOFTEXT|>caps<|ENDOFTEXT|>",
    "punct!!! ?? ... -- __ ''quoted'' \"dq\"", "tab\tand\nnewline  and&amp;html&lt;", "Ⅻ ½ ² ٣ ४ ǅungla ſ'ſ 'ſ",
    "decomposed é (e + U+0301)", "x" * 40, "traffic light, stop sign, parking meter", "",
]


def _learned_merges(texts, n: int = 80) -> list:
    """A merges table learned greedily on ``texts`` (most frequent adjacent
    pair first, as BPE training does) over the byte units of each word: it
    has multi-byte (accented, CJK, emoji) units and ``</w>`` merges."""
    b2u = JB.bytes_to_unicode()
    words = []
    for t in texts:
        for tok in JB.CLIPBPETokenizer(merges=[("a", "b")]).pat.findall(t.lower()):
            u = [b2u[b] for b in tok.encode("utf-8")]
            words.append(u[:-1] + [u[-1] + "</w>"])
    merges = []
    for _ in range(n):
        pairs = {}
        for w in words:
            for p in zip(w, w[1:]):
                pairs[p] = pairs.get(p, 0) + 1
        if not pairs:
            break
        best = max(sorted(pairs), key=lambda p: pairs[p])
        merges.append(best)
        words = [_merge(w, best) for w in words]
    return merges


def _merge(w, pair):
    out, i = [], 0
    while i < len(w):
        if i < len(w) - 1 and (w[i], w[i + 1]) == pair:
            out.append(w[i] + w[i + 1])
            i += 2
        else:
            out.append(w[i])
            i += 1
    return out


@pytest.fixture(scope="module")
def merges():
    return _learned_merges(CORPUS)


def test_split_pattern_matches_the_regex_package():
    """The hand-written scanner finds what the JAX tokenizer's ``regex``
    pattern finds, on the corpus and on seeded random strings over letters,
    digits, marks, emoji, whitespace, the contractions in both cases and the
    special tokens."""
    jpat = JB.CLIPBPETokenizer(merges=[("a", "b")]).pat
    ppat = PB.CLIPBPETokenizer(merges=[("a", "b")]).pat
    rng = np.random.default_rng(0)
    pool = list("abXYZ'sStTrReEvVmMlLdD 09 ,.!?-_ \t\n\xa0\x1c​　éüñ日本한٣४Ⅻ½😀👍🏽́ſKİı<|>") + [
        "<|startoftext|>", "<|ENDOFTEXT|>", "'LL", "'Ve", "'RE", "'D"]
    texts = CORPUS + ["".join(rng.choice(pool, rng.integers(0, 24))) for _ in range(3000)]
    for t in texts:
        assert ppat.findall(t) == jpat.findall(t), repr(t)


def test_token_ids_match_jax(merges):
    jtk = JB.CLIPBPETokenizer(merges=merges, context_length=24)
    ptk = PB.CLIPBPETokenizer(merges=merges, context_length=24)
    assert len(merges) == 80 and any(len(a.encode()) > 1 for a, _ in merges)
    assert ptk.encoder == jtk.encoder and (ptk.sot_id, ptk.eot_id) == (jtk.sot_id, jtk.eot_id)
    for t in CORPUS:
        assert ptk.encode(t) == jtk.encode(t), t
        assert ptk.decode(ptk.encode(t)) == jtk.decode(jtk.encode(t))
    np.testing.assert_array_equal(ptk.tokenize(CORPUS), jtk.tokenize(CORPUS))
    with pytest.raises(RuntimeError):
        ptk.tokenize(["x " * 30], truncate=False)


def test_vocab_files_load_as_in_jax(merges, tmp_path):
    """openai's single file (plain and gzip) and a HF directory with
    ``vocab.json``: the same encoder and ids."""
    body = "#version: clip-mini\n" + "\n".join(f"{a} {b}" for a, b in merges)
    (tmp_path / "v.txt").write_text(body)
    with gzip.open(tmp_path / "v.txt.gz", "wt", encoding="utf-8") as f:
        f.write(body)
    hf = tmp_path / "hf"
    hf.mkdir()
    (hf / "merges.txt").write_text(body)
    vocab = {t: i for i, t in enumerate(JB.CLIPBPETokenizer(merges=merges).encoder)}
    (hf / "vocab.json").write_text(json.dumps(vocab))
    for path in (tmp_path / "v.txt", tmp_path / "v.txt.gz", hf, hf / "merges.txt"):
        jtk, ptk = JB.CLIPBPETokenizer(str(path)), PB.CLIPBPETokenizer(str(path))
        assert ptk.encoder == jtk.encoder and ptk.bpe_ranks == jtk.bpe_ranks
        np.testing.assert_array_equal(ptk.tokenize(CORPUS), jtk.tokenize(CORPUS))
    with pytest.raises(ValueError):
        PB.CLIPBPETokenizer()


def test_hash_encoder_is_bit_equal():
    texts = ["cat", "dog", "", "traffic light", "机械臂", "cat"]
    for dim in (512, 64):
        a = PT.HashTextEncoder(dim).encode_text(texts)
        b = JT.HashTextEncoder(dim).encode_text(texts)
        assert a.dtype == np.float32 and a.shape == (6, dim)
        np.testing.assert_array_equal(a, b)
    assert isinstance(PT.build_text_model("hash:64"), PT.HashTextEncoder)
    with pytest.raises(NotImplementedError):
        PT.build_text_model("bert")


TEXT_CFG = dict(vocab=300, width=32, heads=4, layers=2, ctx=12, proj=16, eos_id=299)
VISION_CFG = dict(image_size=32, patch=8, width=32, heads=4, layers=2, proj=16)


def _random_sd(module, rng, prefix=""):
    """Seeded random float32 values for every tensor of ``module``'s state
    dict (LayerNorm weights around 1)."""
    out = {}
    for k, v in module.state_dict().items():
        a = rng.normal(0, 0.2, tuple(v.shape)).astype(np.float32)
        if "ln" in k and k.endswith("weight"):
            a += 1.0
        out[prefix + k] = a
    return out


def _to_hf_text(sd: dict, layers: int) -> dict:
    """An openai text state dict in HF ``CLIPTextModelWithProjection`` names."""
    t = "text_model"
    hf = {f"{t}.embeddings.token_embedding.weight": sd["token_embedding.weight"],
          f"{t}.embeddings.position_embedding.weight": sd["positional_embedding"],
          f"{t}.final_layer_norm.weight": sd["ln_final.weight"], f"{t}.final_layer_norm.bias": sd["ln_final.bias"],
          "text_projection.weight": sd["text_projection"].T.copy()}
    hf.update(_hf_layers(sd, "transformer.resblocks", f"{t}.encoder.layers", layers))
    return hf


def _hf_layers(sd, src, dst, layers):
    out = {}
    for i in range(layers):
        s, d = f"{src}.{i}", f"{dst}.{i}"
        for leaf in ("weight", "bias"):
            for n, part in zip("qkv", np.split(sd[f"{s}.attn.in_proj_{leaf}"], 3, 0)):
                out[f"{d}.self_attn.{n}_proj.{leaf}"] = part
            out[f"{d}.self_attn.out_proj.{leaf}"] = sd[f"{s}.attn.out_proj.{leaf}"]
            out[f"{d}.layer_norm1.{leaf}"] = sd[f"{s}.ln_1.{leaf}"]
            out[f"{d}.layer_norm2.{leaf}"] = sd[f"{s}.ln_2.{leaf}"]
            out[f"{d}.mlp.fc1.{leaf}"] = sd[f"{s}.mlp.c_fc.{leaf}"]
            out[f"{d}.mlp.fc2.{leaf}"] = sd[f"{s}.mlp.c_proj.{leaf}"]
    return out


def _tokens(rng, n=4):
    """Rows with an end-of-text token at varied places, one without any
    (pooled at the last slot), and one with two (the first pools)."""
    toks = np.zeros((n, 12), np.int32)
    toks[0, :5] = [298, 5, 7, 9, 299]
    toks[1, :3] = [298, 3, 299]
    toks[2] = rng.integers(1, 298, 12)
    toks[3, :6] = [298, 10, 299, 11, 299, 0]
    return toks


@pytest.mark.parametrize("naming", ["openai", "hf"])
def test_text_tower_matches_jax(naming):
    """One random state dict in each naming through both loaders: causal
    attention, EOT pooling (first end-of-text, else the last slot), the
    projection and the L2 norm."""
    rng = np.random.default_rng(1)
    pcfg, jcfg = PT.CLIPTextCfg(**TEXT_CFG), JT.CLIPTextCfg(**TEXT_CFG)
    tower = PT.CLIPTextTower(pcfg)
    sd = _random_sd(tower, rng)
    if naming == "hf":
        sd = _to_hf_text(sd, pcfg.layers)
    toks = _tokens(rng)
    ref = np.asarray(JT.CLIPTextTower(jcfg).apply(JT.clip_text_state_dict_to_variables(sd, jcfg), jnp.asarray(toks)))
    tower.load_state_dict(PT.clip_text_state_dict(sd, pcfg))
    with torch.no_grad():
        out = tower(torch.from_numpy(toks)).numpy()
    np.testing.assert_allclose(out, ref, rtol=0, atol=1e-5)
    np.testing.assert_allclose(np.linalg.norm(out, axis=-1), 1.0, atol=1e-5)


def _to_hf_vision(sd: dict, layers: int) -> dict:
    v, e = "visual", "vision_model.embeddings"
    hf = {f"{e}.patch_embedding.weight": sd[f"{v}.conv1.weight"], f"{e}.class_embedding": sd[f"{v}.class_embedding"],
          f"{e}.position_embedding.weight": sd[f"{v}.positional_embedding"],
          "vision_model.pre_layrnorm.weight": sd[f"{v}.ln_pre.weight"],
          "vision_model.pre_layrnorm.bias": sd[f"{v}.ln_pre.bias"],
          "vision_model.post_layernorm.weight": sd[f"{v}.ln_post.weight"],
          "vision_model.post_layernorm.bias": sd[f"{v}.ln_post.bias"],
          "visual_projection.weight": sd[f"{v}.proj"].T.copy()}
    hf.update(_hf_layers(sd, f"{v}.transformer.resblocks", "vision_model.encoder.layers", layers))
    return hf


@pytest.mark.parametrize("naming", ["openai", "hf"])
def test_vision_tower_matches_jax(naming):
    rng = np.random.default_rng(2)
    pcfg, jcfg = PV.CLIPVisionCfg(**VISION_CFG), JV.CLIPVisionCfg(**VISION_CFG)
    tower = PV.CLIPVisionTower(pcfg)
    sd = _random_sd(tower, rng, "visual.")
    if naming == "hf":
        sd = _to_hf_vision(sd, pcfg.layers)
    x = rng.normal(0, 1, (3, 32, 32, 3)).astype(np.float32)
    jv = JV.clip_vision_state_dict_to_variables(sd, jcfg)
    ref = np.asarray(JV.CLIPVisionTower(jcfg).apply(jv, jnp.asarray(x)))
    tower.load_state_dict(PV.clip_vision_state_dict(sd, pcfg))
    with torch.no_grad():
        out = tower(torch.from_numpy(x).permute(0, 3, 1, 2)).numpy()
    np.testing.assert_allclose(out, ref, rtol=0, atol=1e-5)


@pytest.mark.parametrize("hw", [(50, 70), (224, 300), (400, 180), (32, 32)])
def test_clip_preprocess_matches_jax(hw):
    img = np.random.default_rng(3).integers(0, 256, (*hw, 3), dtype=np.uint8)
    ref = JV.clip_preprocess(img, 32)
    out = PV.clip_preprocess(img, 32)
    assert out.shape == ref.shape == (32, 32, 3)
    np.testing.assert_allclose(out, ref, rtol=0, atol=1.0 / 255 / JV._CLIP_STD.min() + 1e-6)


@pytest.fixture(scope="module")
def clip_checkpoint(tmp_path_factory):
    """An openai-named CLIP state dict (text and vision halves) saved as a ``.pt``."""
    rng = np.random.default_rng(4)
    sd = {**_random_sd(PT.CLIPTextTower(PT.CLIPTextCfg(**TEXT_CFG)), rng),
          **_random_sd(PV.CLIPVisionTower(PV.CLIPVisionCfg(**VISION_CFG)), rng, "visual.")}
    path = tmp_path_factory.mktemp("clip") / "clip.pt"
    torch.save({k: torch.from_numpy(v) for k, v in sd.items()}, path)
    return str(path)


def test_text_encoder_from_a_checkpoint_matches_jax(clip_checkpoint, merges, tmp_path, monkeypatch):
    """``CLIPTextEncoder(weights=, vocab=)`` on the CPU: BPE tokens and
    embeddings as the JAX encoder's; without a vocab both fall back to the
    same hash tokens (the JAX encoder's ``transformers`` attempt blocked)."""
    vocab = tmp_path / "v.txt"
    vocab.write_text("#version\n" + "\n".join(f"{a} {b}" for a, b in merges))
    cfg = dict(TEXT_CFG, vocab=512 + len(merges) + 2, eos_id=512 + len(merges) + 1)
    sd = torch.load(clip_checkpoint)
    sd["token_embedding.weight"] = torch.randn(cfg["vocab"], cfg["width"], generator=torch.Generator().manual_seed(0))
    torch.save(sd, tmp_path / "clip.pt")
    texts = ["a photo of a cat", "The DOG'S bowl", "机械臂"]
    p = PT.CLIPTextEncoder(PT.CLIPTextCfg(**cfg), weights=str(tmp_path / "clip.pt"), vocab=str(vocab), device="cpu")
    j = JT.CLIPTextEncoder(JT.CLIPTextCfg(**cfg), weights=str(tmp_path / "clip.pt"), vocab=str(vocab))
    np.testing.assert_array_equal(p.tokenize(texts), j.tokenize(texts))
    np.testing.assert_allclose(p.encode_text(texts), j.encode_text(texts), rtol=0, atol=1e-5)
    monkeypatch.setitem(sys.modules, "transformers", None)
    monkeypatch.delenv("FY_CLIP_VOCAB", raising=False)
    p = PT.CLIPTextEncoder(PT.CLIPTextCfg(**cfg), weights=str(tmp_path / "clip.pt"), device="cpu")
    j = JT.CLIPTextEncoder(JT.CLIPTextCfg(**cfg), weights=str(tmp_path / "clip.pt"))
    with pytest.warns(UserWarning, match="hash tokenizer"):
        toks = p.tokenize(texts)
    np.testing.assert_array_equal(toks, j.tokenize(texts))
    np.testing.assert_allclose(p.encode_text(toks), j.encode_text(toks), rtol=0, atol=1e-5)


def test_image_encoder_from_a_checkpoint_matches_jax(clip_checkpoint):
    """``CLIPImageEncoder(weights=)`` on crops of any size (CLIP's
    preprocessing, then the tower) and on a pre-normalized batch."""
    rng = np.random.default_rng(5)
    crops = [rng.integers(0, 256, s, dtype=np.uint8) for s in ((40, 60, 3), (33, 33, 3))]
    p = PV.CLIPImageEncoder(PV.CLIPVisionCfg(**VISION_CFG), weights=clip_checkpoint, device="cpu")
    j = JV.CLIPImageEncoder(JV.CLIPVisionCfg(**VISION_CFG), weights=clip_checkpoint)
    x = np.stack([JV.clip_preprocess(c, 32) for c in crops])
    np.testing.assert_allclose(p.encode_image(x), j.encode_image(x), rtol=0, atol=1e-5)
    assert p.encode_image(crops).shape == (2, 16)


def test_seeded_random_towers_are_unit_and_deterministic():
    """Without weights the towers are a seeded random init (not the JAX
    one): unit embeddings, the same for the same seed."""
    a = PT.CLIPTextEncoder(PT.CLIPTextCfg(**TEXT_CFG), device="cpu", seed=3)
    b = PT.CLIPTextEncoder(PT.CLIPTextCfg(**TEXT_CFG), device="cpu", seed=3)
    toks = _tokens(np.random.default_rng(0))
    np.testing.assert_array_equal(a.encode_text(toks), b.encode_text(toks))
    np.testing.assert_allclose(np.linalg.norm(a.encode_text(toks), axis=-1), 1.0, atol=1e-5)
    v = PV.CLIPImageEncoder(PV.CLIPVisionCfg(**VISION_CFG), device="cpu")
    e = v.encode_image(np.zeros((2, 32, 32, 3), np.float32))
    np.testing.assert_allclose(np.linalg.norm(e, axis=-1), 1.0, atol=1e-5)
