"""Post-LN transformer encoder (trans_enc) in PyTorch, parameter-for-parameter
the layout of torch.nn.TransformerEncoderLayer, so the reference's
checkpoints load with their own key names:

  self_attn.in_proj_weight (3D, D), self_attn.in_proj_bias,
  self_attn.out_proj, linear1 (D -> F), linear2 (F -> D), norm1, norm2
  order: x = norm1(x + attn(x)); x = norm2(x + ffn(x))

Written by hand rather than with nn.TransformerEncoderLayer, which drops
out attention probabilities; the JAX layer (motionstyle/models/transformer.py)
has no such dropout. Batch-first (B, S, D), exact-erf gelu, LayerNorm eps
1e-5. A training forward (deterministic=False) applies dropout at the JAX
layer's three sites: after the out-projection, after gelu and after linear2
(models/transformer.py:67-82), with masks drawn from an explicit
torch.Generator, so a caller that re-seeds it redraws the same masks.

`dtype` is the compute dtype: parameters stay fp32 and are cast at use, as
flax's Dense(dtype=...) does. The encoder routes as the JAX encoder does
(:203-229): use_fused at inference runs the hand-written CUDA layer
(ops/fused_encoder.py), with use_int8 the int8 CUDA layer; fused_train in a
training forward runs the differentiable CUDA training layer
(ops/fused_encoder_train.py), with store_probs its store-probs kernels and
with in_kernel_prng its in-kernel Philox dropout.

The other MDM architectures (motionstyle/models/transformer.py:82-189): the
post-LN decoder (TransformerDecoderLayer: self-attention, cross-attention to
the memory, FFN, norm1-3, dropout on each residual branch and inside the
FFN) and a multi-layer GRU (GRUStack). The decoder's self-attention goes
through ops/attention.multihead_attention, so on the card it reaches kernel 4
where the JAX package reaches its Pallas attention (S > 512 or
MOTIONSTYLE_PALLAS_ATTN=1); its cross-attention has Sq != Sk and stays on
the plain version, as in the JAX package. GRUStack is torch.nn.GRU (its
parameter names are the JAX module's) run in fp32; the JAX package has no
kernel for it.
"""
from __future__ import annotations

from typing import Optional

import torch
import torch.nn.functional as F
from torch import nn

from motionstyle_torch.ops.attention import multihead_attention
from motionstyle_torch.ops.fused_encoder import (
    LAYER_KEYS, fused_encoder, layer_params, packed_params, refuse_grad,
    traced_fused_encoder)
from motionstyle_torch.ops.fused_encoder_train import fused_encoder_train, make_dropout_masks


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
        D = x.shape[-1]
        qkv = F.linear(x.to(dtype), self.in_proj_weight.to(dtype),
                       self.in_proj_bias.to(dtype))
        q, k, v = qkv.split(D, -1)
        # the fp32 attention output (ops/attention.py: the plain version, or
        # kernel 4 on the card for S > 512 or MOTIONSTYLE_PALLAS_ATTN=1, as
        # the JAX package dispatches), cast by the out-projection
        out = multihead_attention(q, k, v, self.num_heads, key_padding_mask)
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
                dtype: torch.dtype = torch.float32, masks: Optional[tuple] = None
                ) -> torch.Tensor:
        """masks: the three sites' scaled keep-masks (make_dropout_masks) in a
        training forward, else None."""
        drop = (lambda t, i: t) if masks is None else \
            (lambda t, i: t * masks[i].to(t.dtype))  # noqa: E731
        a = drop(self.self_attn(x, key_padding_mask, dtype), 0)
        x = self.norm1((x.to(dtype) + a).float()).to(dtype)
        h = drop(F.gelu(dense(self.linear1, x, dtype), approximate="none"), 1)
        h = drop(dense(self.linear2, h, dtype), 2)
        return self.norm2((x + h).float()).to(dtype)


class TransformerEncoder(nn.Module):
    def __init__(self, num_layers: int, d_model: int, nhead: int,
                 dim_feedforward: int = 1024, dropout: float = 0.1):
        super().__init__()
        self.nhead = nhead
        self.dim_feedforward = dim_feedforward
        self.dropout = dropout
        self.layers = nn.ModuleList(
            TransformerEncoderLayer(d_model, nhead, dim_feedforward)
            for _ in range(num_layers))

    def packed_layers(self, int8: bool = False) -> list:
        """The layers' parameters in the fused kernel's format: bf16 weights,
        or with int8 the int8 kernel's codes and scales quantized from the
        fp32 parameters. Each layer's copy is made once for each set of its
        parameters' tensor versions (packed_params, the cache the exported
        program's operators read too), so it is rebuilt whenever a parameter
        was replaced or changed in place."""
        return [packed_params([p[k] for k in LAYER_KEYS], int8)
                for p in map(layer_params, self.layers)]

    def forward(self, x: torch.Tensor, key_padding_mask: Optional[torch.Tensor] = None,
                dtype: torch.dtype = torch.float32, use_fused: bool = False,
                fused_train: bool = False, deterministic: bool = True,
                generator: Optional[torch.Generator] = None,
                store_probs: bool = False, use_int8: bool = False,
                in_kernel_prng: bool = False) -> torch.Tensor:
        """deterministic=False is a training forward: dropout at rate
        self.dropout from `generator`, one draw per layer in layer order.
        use_int8 (with use_fused, at inference) runs the int8 layer;
        store_probs and in_kernel_prng (with fused_train) the store-probs
        training kernels and the kernels' own dropout (one seed vector per
        layer from `generator`), as the JAX encoder passes them
        (motionstyle/models/transformer.py:203-227)."""
        drop = not deterministic and self.dropout > 0.0
        if drop and generator is None:
            raise ValueError("a training forward with dropout needs a torch.Generator")
        if use_fused and deterministic:
            refuse_grad(x, *self.parameters())
            if torch.compiler.is_compiling():
                # traced (torch.export with the parameters as inputs): the
                # kernels' custom operators take the layers' own parameters
                return traced_fused_encoder(x, [layer_params(l) for l in self.layers],
                                            self.nhead, key_padding_mask,
                                            int8=use_int8).to(x.dtype)
            return fused_encoder(x, self.packed_layers(use_int8), self.nhead,
                                 key_padding_mask, int8=use_int8).to(x.dtype)
        # the int8 layer has no training kernels: with use_int8 a training
        # forward takes the plain layers, as the JAX encoder does
        # (motionstyle/models/transformer.py:217-218)
        if fused_train and not deterministic and not use_int8:
            return fused_encoder_train(
                x, [layer_params(layer) for layer in self.layers], self.nhead,
                self.dropout, generator, key_padding_mask, store_probs,
                in_kernel_prng).to(x.dtype)
        for layer in self.layers:
            masks = None
            if drop:
                masks = make_dropout_masks(generator, x.shape, self.dropout,
                                           self.dim_feedforward, dtype=torch.float32)
            x = layer(x, key_padding_mask, dtype, masks)
        return x


def _dropout(t: torch.Tensor, rate: float, generator: Optional[torch.Generator]
             ) -> torch.Tensor:
    """Inverted dropout at `rate` with bits from `generator`."""
    keep = 1.0 - rate
    bits = torch.rand(t.shape, generator=generator, device=t.device)
    return t * ((bits < keep).to(t.dtype) / keep)


class MultiheadCrossAttention(nn.Module):
    """Cross-attention with a q projection and a packed kv projection (the
    JAX module's layout, models/transformer.py:82-97)."""

    def __init__(self, embed_dim: int, num_heads: int):
        super().__init__()
        self.num_heads = num_heads
        self.q_proj = nn.Linear(embed_dim, embed_dim)
        self.kv_proj = nn.Linear(embed_dim, 2 * embed_dim)
        self.out_proj = nn.Linear(embed_dim, embed_dim)

    def forward(self, x: torch.Tensor, memory: torch.Tensor, dtype: torch.dtype
                ) -> torch.Tensor:
        q = dense(self.q_proj, x, dtype)
        k, v = dense(self.kv_proj, memory, dtype).split(x.shape[-1], -1)
        return dense(self.out_proj, multihead_attention(q, k, v, self.num_heads), dtype)


class TransformerDecoderLayer(nn.Module):
    """Post-LN decoder block: x = norm1(x + self_attn(x)); x = norm2(x +
    cross_attn(x, memory)); x = norm3(x + ffn(x)); in a training forward,
    dropout on each residual branch and after gelu (JAX :100-135)."""

    def __init__(self, d_model: int, nhead: int, dim_feedforward: int = 1024,
                 dropout: float = 0.1):
        super().__init__()
        self.dropout = dropout
        self.self_attn = MultiheadSelfAttention(d_model, nhead)
        self.multihead_attn = MultiheadCrossAttention(d_model, nhead)
        self.linear1 = nn.Linear(d_model, dim_feedforward)
        self.linear2 = nn.Linear(dim_feedforward, d_model)
        self.norm1 = nn.LayerNorm(d_model, eps=1e-5)
        self.norm2 = nn.LayerNorm(d_model, eps=1e-5)
        self.norm3 = nn.LayerNorm(d_model, eps=1e-5)

    def forward(self, x: torch.Tensor, memory: torch.Tensor, dtype: torch.dtype = torch.float32,
                deterministic: bool = True, generator: Optional[torch.Generator] = None
                ) -> torch.Tensor:
        drop = (lambda t: t) if deterministic or self.dropout <= 0.0 else \
            (lambda t: _dropout(t, self.dropout, generator))  # noqa: E731
        a = drop(self.self_attn(x, None, dtype))
        x = self.norm1((x.to(dtype) + a).float()).to(dtype)
        c = drop(self.multihead_attn(x, memory, dtype))
        x = self.norm2((x + c).float()).to(dtype)
        h = drop(F.gelu(dense(self.linear1, x, dtype), approximate="none"))
        h = drop(dense(self.linear2, h, dtype))
        return self.norm3((x + h).float()).to(dtype)


class TransformerDecoder(nn.Module):
    def __init__(self, num_layers: int, d_model: int, nhead: int,
                 dim_feedforward: int = 1024, dropout: float = 0.1):
        super().__init__()
        self.dropout = dropout
        self.layers = nn.ModuleList(
            TransformerDecoderLayer(d_model, nhead, dim_feedforward, dropout)
            for _ in range(num_layers))

    def forward(self, x: torch.Tensor, memory: torch.Tensor, dtype: torch.dtype = torch.float32,
                deterministic: bool = True, generator: Optional[torch.Generator] = None
                ) -> torch.Tensor:
        if not deterministic and self.dropout > 0.0 and generator is None:
            raise ValueError("a training forward with dropout needs a torch.Generator")
        for layer in self.layers:
            x = layer(x, memory, dtype, deterministic, generator)
        return x


class GRUStack(nn.GRU):
    """Multi-layer unidirectional GRU over (B, T, D) -> (B, T, H) from a zero
    state: torch's GRU cell math, as the JAX GRUStack's scan computes it
    (:138-167), with its parameter names (weight_ih_l{k}, weight_hh_l{k},
    bias_ih_l{k}, bias_hh_l{k}), in fp32."""

    def __init__(self, input_size: int, hidden_size: int, num_layers: int):
        super().__init__(input_size, hidden_size, num_layers, batch_first=True)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return super().forward(x.float())[0]
