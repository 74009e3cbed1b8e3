"""CLIP byte-level BPE tokenizer (reference ``fce_yolo_tpu/nn/bpe.py``): the
openai-``clip`` SimpleTokenizer from its published semantics, offline (a
merges file or a merges list is passed in, nothing is fetched).

- byte -> unicode map over all 256 byte values, so any UTF-8 text
  round-trips through the string-keyed vocab;
- CLIP's split pattern ``<|startoftext|>|<|endoftext|>|'s|'t|'re|'ve|'m|'ll|'d|
  [\\p{L}]+|[\\p{N}]|[^\\s\\p{L}\\p{N}]+`` (case-insensitive), which the JAX
  package runs with the ``regex`` package. The port scans it by hand with
  the standard library (``_CLIPSplitter``): ``\\p{L}`` and ``\\p{N}`` are the
  ``unicodedata`` categories L* and N*, ``\\s`` the Unicode White_Space
  characters, and the flag's case folding that of each character;
- ``</w>`` on the last byte-unit of each word, lowest-rank bigram merging;
- vocab: 256 byte units, 256 word-final units, one token a merge, then
  ``<|startoftext|>``/``<|endoftext|>`` (openai layout), or a HF ``vocab.json``;
- ``tokenize``: SOT + ids + EOT, 0-padded to the context length; a longer
  prompt is cut with EOT in the last slot (``truncate=True``) or raises.

Cleaning: ``html.unescape`` twice, whitespace collapsed, lower case (no
``ftfy``, as in the JAX package).
"""

from __future__ import annotations

import functools
import gzip
import html
import json
import os
import unicodedata
from pathlib import Path

import numpy as np

__all__ = ["CLIPBPETokenizer", "bytes_to_unicode", "find_local_vocab"]

SOT_TEXT = "<|startoftext|>"
EOT_TEXT = "<|endoftext|>"
OPENAI_N_MERGES = 49152 - 256 - 2  # the openai merges table: lines [1, 49152-256-2+1) of the vocab file
_SPECIALS = (SOT_TEXT, EOT_TEXT)
_CONTRACTIONS = ("'s", "'t", "'re", "'ve", "'m", "'ll", "'d")  # in the pattern's order
_WHITE_SPACE = frozenset("\t\n\v\f\r \x85\xa0\u1680\u2028\u2029\u202f\u205f\u3000"
                         + "".join(map(chr, range(0x2000, 0x200B))))  # the Unicode White_Space property: ``\s``


@functools.lru_cache(maxsize=1)
def bytes_to_unicode() -> dict:
    """Bijective byte -> unicode-char map (openai byte-level BPE base)."""
    bs = list(range(ord("!"), ord("~") + 1)) + list(range(ord("\xa1"), ord("\xac") + 1)) + list(
        range(ord("\xae"), ord("\xff") + 1))
    cs = bs[:]
    n = 0
    for b in range(256):
        if b not in bs:
            bs.append(b)
            cs.append(256 + n)
            n += 1
    return dict(zip(bs, (chr(c) for c in cs)))


def _get_pairs(word: tuple) -> set:
    return {(word[i], word[i + 1]) for i in range(len(word) - 1)}


def _basic_clean(text: str) -> str:
    return html.unescape(html.unescape(text)).strip()


def _whitespace_clean(text: str) -> str:
    return " ".join(text.split())


def find_local_vocab() -> str | None:
    """A local CLIP vocab: the ``FY_CLIP_VOCAB`` environment variable, else None."""
    p = os.environ.get("FY_CLIP_VOCAB", "")
    return p if p and Path(p).exists() else None


def _letter(c: str) -> bool:
    return unicodedata.category(c)[0] == "L"


def _number(c: str) -> bool:
    return unicodedata.category(c)[0] == "N"


def _starts(text: str, i: int, lit: str) -> bool:
    """Whether ``lit`` (ASCII) is at ``text[i]``, each character compared by
    its simple case folding (so ``'ſ`` is ``'s``, as the pattern's flag has it)."""
    return len(text) - i >= len(lit) and all(
        c == p or c.casefold() == p for c, p in zip(text[i:i + len(lit)], lit))


class _CLIPSplitter:
    """CLIP's split pattern as a scanner (module docstring): at each position
    the pattern's alternatives in their order, the first that matches wins;
    a position none matches (whitespace) is skipped."""

    @staticmethod
    def findall(text: str) -> list[str]:
        out: list[str] = []
        i, n = 0, len(text)
        while i < n:
            tok = next((s for s in (*_SPECIALS, *_CONTRACTIONS) if _starts(text, i, s)), None)
            if tok is not None:
                out.append(text[i:i + len(tok)])
                i += len(tok)
                continue
            c = text[i]
            j = i + 1
            if _letter(c):
                while j < n and _letter(text[j]):
                    j += 1
            elif _number(c):
                pass
            elif c not in _WHITE_SPACE:
                while j < n and not (text[j] in _WHITE_SPACE or _letter(text[j]) or _number(text[j])):
                    j += 1
            else:
                i = j
                continue
            out.append(text[i:j])
            i = j
        return out


class CLIPBPETokenizer:
    """openai-CLIP SimpleTokenizer (the JAX ``CLIPBPETokenizer``).

    ``vocab_path``: an openai merges file (``*.txt``/``*.txt.gz``) or a
    HuggingFace tokenizer directory / ``merges.txt`` (with an optional
    sibling ``vocab.json`` as the id map). ``merges``: (first, second) pairs,
    the vocab built the openai way. ``context_length``: the width of
    ``tokenize`` (77)."""

    def __init__(self, vocab_path: str | None = None, merges: list | None = None, context_length: int = 77):
        if (vocab_path is None) == (merges is None):
            raise ValueError("pass exactly one of vocab_path= or merges=")
        self.context_length = int(context_length)
        self.byte_encoder = bytes_to_unicode()
        self.byte_decoder = {v: k for k, v in self.byte_encoder.items()}
        encoder = None
        if vocab_path is not None:
            merges, encoder = self._load(Path(vocab_path))
        merges = [tuple(m) for m in merges]
        self.bpe_ranks = dict(zip(merges, range(len(merges))))
        if encoder is None:
            vocab = list(self.byte_encoder.values())
            vocab += [v + "</w>" for v in vocab]
            vocab += ["".join(m) for m in merges]
            vocab += [SOT_TEXT, EOT_TEXT]
            encoder = {tok: i for i, tok in enumerate(vocab)}
        self.encoder = encoder
        self.decoder = {i: tok for tok, i in encoder.items()}
        self.sot_id = encoder[SOT_TEXT]
        self.eot_id = encoder[EOT_TEXT]
        self.cache = {SOT_TEXT: SOT_TEXT, EOT_TEXT: EOT_TEXT}  # special tokens never enter the merge loop
        self.pat = _CLIPSplitter()

    @staticmethod
    def _load(path: Path) -> tuple[list, dict | None]:
        """(merges, encoder or None) from an openai file or a HF directory."""
        if path.is_dir():
            merges_file, vocab_json = path / "merges.txt", path / "vocab.json"
        elif path.name == "merges.txt":
            merges_file, vocab_json = path, path.with_name("vocab.json")
        else:  # openai single-file format (.txt / .txt.gz)
            opener = gzip.open if path.suffix == ".gz" else open
            with opener(path, "rt", encoding="utf-8") as f:
                lines = f.read().split("\n")
            rows = [ln for ln in lines[1:] if len(ln.split()) == 2]
            return [tuple(ln.split()) for ln in rows[:OPENAI_N_MERGES]], None
        with open(merges_file, encoding="utf-8") as f:
            lines = f.read().split("\n")
        start = 1 if lines and lines[0].startswith("#") else 0
        merges = [tuple(ln.split()) for ln in lines[start:] if len(ln.split()) == 2]
        encoder = None
        if vocab_json.exists():
            with open(vocab_json, encoding="utf-8") as f:
                encoder = {k: int(v) for k, v in json.load(f).items()}
            for tok in (SOT_TEXT, EOT_TEXT):
                encoder.setdefault(tok, len(encoder))
        return merges, encoder

    def bpe(self, token: str) -> str:
        """Merge a byte-unit string by ranked bigrams; the space-joined
        subwords, the last carrying ``</w>``."""
        if token in self.cache:
            return self.cache[token]
        word = tuple(token[:-1]) + (token[-1] + "</w>",)
        pairs = _get_pairs(word)
        if not pairs:
            return token + "</w>"
        while True:
            bigram = min(pairs, key=lambda p: self.bpe_ranks.get(p, float("inf")))
            if bigram not in self.bpe_ranks:
                break
            first, second = bigram
            new_word: list = []
            i = 0
            while i < len(word):
                try:
                    j = word.index(first, i)
                except ValueError:
                    new_word.extend(word[i:])
                    break
                new_word.extend(word[i:j])
                i = j
                if i < len(word) - 1 and word[i + 1] == second:
                    new_word.append(first + second)
                    i += 2
                else:
                    new_word.append(word[i])
                    i += 1
            word = tuple(new_word)
            if len(word) == 1:
                break
            pairs = _get_pairs(word)
        out = " ".join(word)
        self.cache[token] = out
        return out

    def encode(self, text: str) -> list:
        ids: list = []
        text = _whitespace_clean(_basic_clean(text)).lower()
        for token in self.pat.findall(text):
            unit = "".join(self.byte_encoder[b] for b in token.encode("utf-8"))
            for sub in self.bpe(unit).split(" "):
                if sub not in self.encoder:  # the reference tokenizer's KeyError; only an incomplete vocab.json
                    raise KeyError(f"subword {sub!r} not in BPE vocab (incomplete vocab.json?)")
                ids.append(self.encoder[sub])
        return ids

    def decode(self, ids) -> str:
        text = "".join(self.decoder.get(int(i), "") for i in ids)
        raw = bytearray(self.byte_decoder[c] for c in text if c in self.byte_decoder)
        return raw.decode("utf-8", errors="replace").replace("</w>", " ").strip()

    def tokenize(self, texts, context_length: int | None = None, truncate: bool = True) -> np.ndarray:
        """(B, context_length) int32 tokens: SOT + ids + EOT, 0-padded
        (``clip.tokenize(texts, truncate=True)``); ``truncate=False`` raises
        on a prompt that does not fit."""
        if isinstance(texts, str):
            texts = [texts]
        ctx = int(context_length or self.context_length)
        out = np.zeros((len(texts), ctx), np.int32)
        for i, text in enumerate(texts):
            row = [self.sot_id, *self.encode(str(text)), self.eot_id]
            if len(row) > ctx:
                if not truncate:
                    raise RuntimeError(f"input {text!r} is too long for context length {ctx}")
                row = row[:ctx]
                row[-1] = self.eot_id
            out[i, : len(row)] = row
        return out
