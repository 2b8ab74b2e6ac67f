"""Plain CLIP text tower (Radford et al. 2021, ViT-B/32's text side) over a
dict of named weights, with the byte-level tokenizer the benchmark's runs
use (no BPE merges are in the repository): each word's bytes, the last one
marked as end of word (256 + byte), between CLIP's start and end tokens.
MDM's humanml branch encodes a 22-token context zero-padded to 77.
"""
from __future__ import annotations

import re

import numpy as np
import torch
import torch.nn.functional as F

SOT, EOT = 49406, 49407


def token_ids(texts, context: int, width: int = 77) -> np.ndarray:
    """(len(texts), width) int64 ids: truncated to `context` tokens (the
    last one made the end token), zero-padded to `width`."""
    out = np.zeros((len(texts), width), dtype=np.int64)
    for row, text in enumerate(texts):
        ids = []
        for word in re.sub(r"\s+", " ", text.strip().lower()).split(" "):
            bs = word.encode("utf-8")
            if bs:
                ids += [int(b) for b in bs[:-1]] + [256 + int(bs[-1])]
        ids = [SOT] + ids + [EOT]
        if len(ids) > context:
            ids = ids[:context]
            ids[-1] = EOT
        out[row, :len(ids)] = ids
    return out


def encode(w: dict, ids: torch.Tensor, heads: int, layers: int) -> torch.Tensor:
    """ids (B, S) -> (B, embed_dim) features: the end token's final hidden
    state through text_projection. Pre-LN blocks, causal attention,
    QuickGELU, fp32."""
    B, S = ids.shape
    x = w["token_embedding.weight"][ids] + w["positional_embedding"][:S]
    D = x.shape[-1]
    dh = D // heads
    causal = torch.full((S, S), -1e9, device=x.device).triu(1)
    for i in range(layers):
        p = f"transformer.resblocks.{i}."
        h = F.layer_norm(x, (D,), w[p + "ln_1.weight"], w[p + "ln_1.bias"], 1e-5)
        qkv = h @ w[p + "attn.in_proj_weight"].t() + w[p + "attn.in_proj_bias"]
        q, k, v = (t.reshape(B, S, heads, dh).transpose(1, 2) for t in qkv.split(D, -1))
        a = torch.softmax(q @ k.transpose(-1, -2) / dh ** 0.5 + causal, -1) @ v
        a = a.transpose(1, 2).reshape(B, S, D)
        x = x + a @ w[p + "attn.out_proj.weight"].t() + w[p + "attn.out_proj.bias"]
        h = F.layer_norm(x, (D,), w[p + "ln_2.weight"], w[p + "ln_2.bias"], 1e-5)
        h = h @ w[p + "mlp.c_fc.weight"].t() + w[p + "mlp.c_fc.bias"]
        h = h * torch.sigmoid(1.702 * h)
        x = x + h @ w[p + "mlp.c_proj.weight"].t() + w[p + "mlp.c_proj.bias"]
    x = F.layer_norm(x, (D,), w["ln_final.weight"], w["ln_final.bias"], 1e-5)
    return x[torch.arange(B, device=x.device), ids.argmax(-1)] @ w["text_projection"]


def encode_texts(w: dict, texts, clip: dict, device) -> torch.Tensor:
    ids = torch.as_tensor(token_ids(texts, clip["text_context"], clip["context_length"]),
                          device=device)
    with torch.no_grad():
        return encode(w, ids, clip["heads"], clip["layers"])
