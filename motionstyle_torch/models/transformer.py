"""Post-LN transformer encoder (trans_enc) in PyTorch, parameter-for-parameter
the layout of torch.nn.TransformerEncoderLayer, so the reference's
checkpoints load with their own key names:

  self_attn.in_proj_weight (3D, D), self_attn.in_proj_bias,
  self_attn.out_proj, linear1 (D -> F), linear2 (F -> D), norm1, norm2
  order: x = norm1(x + attn(x)); x = norm2(x + ffn(x))

Written by hand rather than with nn.TransformerEncoderLayer, which drops
out attention probabilities; the JAX layer (motionstyle/models/transformer.py)
has no such dropout. Batch-first (B, S, D), exact-erf gelu, LayerNorm eps
1e-5. This slice serves inference only, so no dropout is applied.

`dtype` is the compute dtype: parameters stay fp32 and are cast at use, as
flax's Dense(dtype=...) does. With use_fused the stack runs through the
hand-written CUDA layer (ops/fused_encoder.py), as the JAX encoder routes
through its Pallas kernel.
"""
from __future__ import annotations

from typing import Optional

import torch
import torch.nn.functional as F
from torch import nn

from motionstyle_torch.ops.fused_encoder import fused_encoder, pack_layer_params

_NEG = -1e9


def dense(linear: nn.Linear, x: torch.Tensor, dtype: torch.dtype) -> torch.Tensor:
    """flax Dense(dtype=...) semantics: input, weight and bias cast to the
    compute dtype."""
    return F.linear(x.to(dtype), linear.weight.to(dtype), linear.bias.to(dtype))


class MultiheadSelfAttention(nn.Module):
    """Packed-projection attention, torch.nn.MultiheadAttention's layout."""

    def __init__(self, embed_dim: int, num_heads: int):
        super().__init__()
        self.num_heads = num_heads
        self.in_proj_weight = nn.Parameter(
            nn.init.xavier_uniform_(torch.empty(3 * embed_dim, embed_dim)))
        self.in_proj_bias = nn.Parameter(torch.zeros(3 * embed_dim))
        self.out_proj = nn.Linear(embed_dim, embed_dim)

    def forward(self, x: torch.Tensor, key_padding_mask: Optional[torch.Tensor],
                dtype: torch.dtype) -> torch.Tensor:
        B, S, D = x.shape
        H = self.num_heads
        dh = D // H
        qkv = F.linear(x.to(dtype), self.in_proj_weight.to(dtype),
                       self.in_proj_bias.to(dtype))
        q, k, v = (t.reshape(B, S, H, dh).transpose(1, 2) for t in qkv.split(D, -1))
        # scores and softmax in fp32, as the JAX XLA path's
        # preferred_element_type=float32
        scores = (q * (1.0 / dh ** 0.5)).float() @ k.float().transpose(-1, -2)
        if key_padding_mask is not None:
            scores = scores + torch.where(key_padding_mask.bool(), 0.0,
                                          _NEG)[:, None, None, :]
        probs = torch.softmax(scores, dim=-1)
        out = (probs @ v.float()).transpose(1, 2).reshape(B, S, D)
        return dense(self.out_proj, out, dtype)


class TransformerEncoderLayer(nn.Module):
    def __init__(self, d_model: int, nhead: int, dim_feedforward: int = 2048):
        super().__init__()
        self.self_attn = MultiheadSelfAttention(d_model, nhead)
        self.linear1 = nn.Linear(d_model, dim_feedforward)
        self.linear2 = nn.Linear(dim_feedforward, d_model)
        self.norm1 = nn.LayerNorm(d_model, eps=1e-5)
        self.norm2 = nn.LayerNorm(d_model, eps=1e-5)

    def forward(self, x: torch.Tensor, key_padding_mask: Optional[torch.Tensor] = None,
                dtype: torch.dtype = torch.float32) -> torch.Tensor:
        a = self.self_attn(x, key_padding_mask, dtype)
        x = self.norm1((x.to(dtype) + a).float()).to(dtype)
        h = F.gelu(dense(self.linear1, x, dtype), approximate="none")
        h = dense(self.linear2, h, dtype)
        return self.norm2((x + h).float()).to(dtype)


class TransformerEncoder(nn.Module):
    def __init__(self, num_layers: int, d_model: int, nhead: int,
                 dim_feedforward: int = 1024):
        super().__init__()
        self.nhead = nhead
        self.layers = nn.ModuleList(
            TransformerEncoderLayer(d_model, nhead, dim_feedforward)
            for _ in range(num_layers))
        self._packed = None  # (parameter versions, packed kernel params)

    def packed_layers(self) -> list:
        """The layers' parameters in the fused kernel's format (bf16 weights),
        rebuilt whenever a parameter was replaced or changed in place."""
        key = tuple((p.data_ptr(), p._version, p.device) for p in self.parameters())
        if self._packed is None or self._packed[0] != key:
            self._packed = (key, [pack_layer_params(l) for l in self.layers])
        return self._packed[1]

    def forward(self, x: torch.Tensor, key_padding_mask: Optional[torch.Tensor] = None,
                dtype: torch.dtype = torch.float32, use_fused: bool = False
                ) -> torch.Tensor:
        if use_fused:
            return fused_encoder(x, self.packed_layers(), self.nhead,
                                 key_padding_mask).to(x.dtype)
        for layer in self.layers:
            x = layer(x, key_padding_mask, dtype)
        return x
