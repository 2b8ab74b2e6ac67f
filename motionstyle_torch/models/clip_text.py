"""CLIP ViT-B/32 text tower in PyTorch + a self-contained tokenizer.

Counterpart of motionstyle/models/clip_text.py. The tower is plain PyTorch
(the JAX one has no Pallas kernel behind it): token_embedding (49408 x 512),
positional_embedding (77 x 512), 12 pre-LN residual attention blocks (width
512, 8 heads, mlp 4x, QuickGELU), ln_final, text_projection (512 x 512).
encode returns the EOT token's hidden state projected by text_projection.
Module names follow OpenAI's CLIP state dict, so a CLIP checkpoint's text
keys load as they are (with or without a 'clip_model.' prefix).

Tokenizer: with CLIP_BPE_PATH pointing at bpe_simple_vocab_16e6.txt(.gz),
true CLIP BPE; otherwise a deterministic byte-level fallback with the same
special tokens and context-length semantics.
"""
from __future__ import annotations

import functools
import gzip
import html
import os
import re
from dataclasses import dataclass

import numpy as np
import torch
from torch import nn

VOCAB_SIZE = 49408
CONTEXT_LENGTH = 77
SOT = VOCAB_SIZE - 2  # <|startoftext|>
EOT = VOCAB_SIZE - 1  # <|endoftext|>

# OpenAI's pattern with stdlib `re` classes: [^\W\d_] is a unicode letter
_WORD_RE = re.compile(
    r"""'s|'t|'re|'ve|'m|'ll|'d|[^\W\d_]+|\d|(?:[^\s\w]|_)+""",
    re.IGNORECASE | re.UNICODE,
)


def _bytes_to_unicode():
    """GPT-2/CLIP reversible byte<->unicode table."""
    bs = list(range(ord("!"), ord("~") + 1)) + list(range(ord("¡"), ord("¬") + 1)) + list(range(ord("®"), ord("ÿ") + 1))
    cs = bs[:]
    n = 0
    for b in range(2 ** 8):
        if b not in bs:
            bs.append(b)
            cs.append(2 ** 8 + n)
            n += 1
    return dict(zip(bs, [chr(c) for c in cs]))


class ClipBPETokenizer:
    """True CLIP BPE, loaded from bpe_simple_vocab_16e6.txt(.gz)."""

    def __init__(self, bpe_path: str):
        self.byte_encoder = _bytes_to_unicode()
        opener = gzip.open if bpe_path.endswith(".gz") else open
        with opener(bpe_path, "rt", encoding="utf-8") as f:
            merges = f.read().split("\n")
        merges = [tuple(m.split()) for m in merges[1: 49152 - 256 - 2 + 1]]
        vocab = list(self.byte_encoder.values())
        vocab = vocab + [v + "</w>" for v in vocab]
        vocab += ["".join(m) for m in merges]
        vocab.extend(["<|startoftext|>", "<|endoftext|>"])
        self.encoder = {v: i for i, v in enumerate(vocab)}
        self.bpe_ranks = dict(zip(merges, range(len(merges))))
        self.cache = {}

    def _bpe(self, token: str) -> str:
        if token in self.cache:
            return self.cache[token]
        word = tuple(token[:-1]) + (token[-1] + "</w>",)
        while len(word) > 1:
            pairs = set(zip(word[:-1], word[1:]))
            bigram = min(pairs, key=lambda p: self.bpe_ranks.get(p, float("inf")))
            if bigram not in self.bpe_ranks:
                break
            first, second = bigram
            new_word, i = [], 0
            while i < len(word):
                if i < len(word) - 1 and word[i] == first and word[i + 1] == second:
                    new_word.append(first + second)
                    i += 2
                else:
                    new_word.append(word[i])
                    i += 1
            word = tuple(new_word)
        out = " ".join(word)
        self.cache[token] = out
        return out

    def encode(self, text: str) -> list:
        text = html.unescape(html.unescape(text)).strip().lower()
        text = re.sub(r"\s+", " ", text)
        ids = []
        for token in _WORD_RE.findall(text):
            token = "".join(self.byte_encoder[b] for b in token.encode("utf-8"))
            ids.extend(self.encoder[t] for t in self._bpe(token).split(" "))
        return ids


class ByteFallbackTokenizer:
    """Deterministic byte-level fallback: plain bytes 0..255, end-of-word
    bytes 256..511, always inside the CLIP vocabulary."""

    def encode(self, text: str) -> list:
        text = re.sub(r"\s+", " ", text.strip().lower())
        ids = []
        for word in text.split(" "):
            bs = word.encode("utf-8")
            if not bs:
                continue
            ids.extend(int(b) for b in bs[:-1])
            ids.append(256 + int(bs[-1]))
        return ids


@functools.lru_cache(maxsize=1)
def default_tokenizer():
    path = os.environ.get("CLIP_BPE_PATH", "")
    if path and os.path.exists(path):
        return ClipBPETokenizer(path)
    return ByteFallbackTokenizer()


def tokenize(texts, context_length: int = CONTEXT_LENGTH, truncate: bool = True,
             tokenizer=None) -> np.ndarray:
    """texts (list of str) -> int64 ids (B, context_length), clip.tokenize's
    semantics."""
    if isinstance(texts, str):
        texts = [texts]
    tok = tokenizer or default_tokenizer()
    out = np.zeros((len(texts), context_length), dtype=np.int64)
    for i, t in enumerate(texts):
        ids = [SOT] + tok.encode(t) + [EOT]
        if len(ids) > context_length:
            if not truncate:
                raise RuntimeError(f"text too long for context {context_length}: {t!r}")
            ids = ids[:context_length]
            ids[-1] = EOT
        out[i, : len(ids)] = ids
    return out


# init scales of the tower's free parameters (the JAX tower's initialisers)
INIT_STDS = {"positional_embedding": 0.01, "text_projection": 0.02}


@dataclass(frozen=True)
class ClipTextConfig:
    vocab_size: int = VOCAB_SIZE
    context_length: int = CONTEXT_LENGTH
    width: int = 512
    heads: int = 8
    layers: int = 12
    embed_dim: int = 512


class _Attention(nn.Module):
    def __init__(self, width: int):
        super().__init__()
        self.in_proj_weight = nn.Parameter(torch.empty(3 * width, width))
        self.in_proj_bias = nn.Parameter(torch.zeros(3 * width))
        self.out_proj = nn.Linear(width, width)
        nn.init.xavier_uniform_(self.in_proj_weight)


class _MLP(nn.Module):
    def __init__(self, width: int):
        super().__init__()
        self.c_fc = nn.Linear(width, 4 * width)
        self.c_proj = nn.Linear(4 * width, width)


class ResidualAttentionBlock(nn.Module):
    """Pre-LN block with QuickGELU and a causal mask."""

    def __init__(self, width: int, heads: int):
        super().__init__()
        self.heads = heads
        self.ln_1 = nn.LayerNorm(width, eps=1e-5)
        self.attn = _Attention(width)
        self.ln_2 = nn.LayerNorm(width, eps=1e-5)
        self.mlp = _MLP(width)

    def forward(self, x: torch.Tensor, causal_mask: torch.Tensor) -> torch.Tensor:
        B, S, D = x.shape
        H, dh = self.heads, D // self.heads
        qkv = nn.functional.linear(self.ln_1(x), self.attn.in_proj_weight,
                                   self.attn.in_proj_bias)
        q, k, v = (t.reshape(B, S, H, dh).transpose(1, 2) for t in qkv.split(D, -1))
        scores = (q * (1.0 / dh ** 0.5)) @ k.transpose(-1, -2) + causal_mask
        a = (torch.softmax(scores, dim=-1) @ v).transpose(1, 2).reshape(B, S, D)
        x = x + self.attn.out_proj(a)
        h = self.mlp.c_fc(self.ln_2(x))
        h = h * torch.sigmoid(1.702 * h)  # QuickGELU
        return x + self.mlp.c_proj(h)


class _Transformer(nn.Module):
    def __init__(self, c: ClipTextConfig):
        super().__init__()
        self.resblocks = nn.ModuleList(ResidualAttentionBlock(c.width, c.heads)
                                       for _ in range(c.layers))


class ClipTextEncoder(nn.Module):
    def __init__(self, cfg: ClipTextConfig = ClipTextConfig()):
        super().__init__()
        self.cfg = cfg
        self.token_embedding = nn.Embedding(cfg.vocab_size, cfg.width)
        self.positional_embedding = nn.Parameter(
            torch.randn(cfg.context_length, cfg.width) * 0.01)
        self.transformer = _Transformer(cfg)
        self.ln_final = nn.LayerNorm(cfg.width, eps=1e-5)
        self.text_projection = nn.Parameter(torch.randn(cfg.width, cfg.embed_dim) * 0.02)

    def forward(self, tokens: torch.Tensor) -> torch.Tensor:
        """tokens (B, S) int -> (B, embed_dim) text features."""
        S = tokens.shape[1]
        x = self.token_embedding(tokens) + self.positional_embedding[None, :S]
        causal = torch.full((S, S), -1e9, device=x.device).triu(1)[None, None]
        for block in self.transformer.resblocks:
            x = block(x, causal)
        x = self.ln_final(x)
        eot = tokens.argmax(dim=-1)  # EOT = highest id in each row
        pooled = x[torch.arange(x.shape[0], device=x.device), eot]
        return pooled @ self.text_projection

    def load_clip_state_dict(self, sd: dict) -> None:
        """An OpenAI CLIP state dict (keys optionally under 'clip_model.';
        fp16 accepted) -> this tower; the image tower's keys are ignored."""
        prefix = "clip_model." if any(k.startswith("clip_model.") for k in sd) else ""
        own = self.state_dict()
        picked = {k: torch.as_tensor(np.asarray(sd[prefix + k], np.float32))
                  for k in own}
        self.load_state_dict(picked)


def text_ids(texts, dataset: str = "stylexia_posrot", tokenizer=None) -> np.ndarray:
    """(len(texts), 77) token ids as MDM.encode_text :298-313 builds them:
    humanml/kit use a 22-token context zero-padded to 77."""
    if dataset in ("humanml", "kit"):
        context_length = 20 + 2
        ids = tokenize(texts, context_length=context_length, truncate=True,
                       tokenizer=tokenizer)
        ids = np.concatenate(
            [ids, np.zeros((ids.shape[0], CONTEXT_LENGTH - context_length), np.int64)],
            axis=1)
    else:
        ids = tokenize(texts, tokenizer=tokenizer)
    return ids


def encode_text(model: ClipTextEncoder, texts, dataset: str = "stylexia_posrot",
                tokenizer=None) -> torch.Tensor:
    """Host tokenize (text_ids) + device encode on the model's device."""
    ids = text_ids(texts, dataset, tokenizer)
    device = model.text_projection.device
    with torch.no_grad():
        return model(torch.as_tensor(ids, device=device))
