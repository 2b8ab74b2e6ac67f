"""Plain MDM trans_enc denoiser (Tevet et al. 2023) over a dict of named
weights: frame embedding, sinusoidal positions, timestep MLP, text
projection, post-LN encoder layers (packed qkv, softmax attention, exact-erf
GELU, LayerNorm eps 1e-5) and the output head; the x0 prediction.

Every matrix product goes through `mm`, which computes in float32 ("fp32",
TF32 off) or, as the training cell's control, with both operands rounded
to float8 e4m3 under a per-tensor scale ("fp8"); products accumulate in
float32. Dropout, where given, uses the caller's keep-masks at the layer's
three sites and after the positions.
"""
from __future__ import annotations

import math

import torch
import torch.nn.functional as F

FP8_MAX = 448.0


def _fp8(t: torch.Tensor) -> torch.Tensor:
    scale = t.abs().amax().clamp_min(1e-12) / FP8_MAX
    return (t / scale).to(torch.float8_e4m3fn).to(torch.float32) * scale


class _Fp8MatMul(torch.autograd.Function):
    """a @ b with both operands, and in the backward the incoming gradient,
    rounded to float8 e4m3 under a per-tensor scale; fp32 accumulation."""

    @staticmethod
    def forward(ctx, a, b):
        aq, bq = _fp8(a), _fp8(b)
        ctx.save_for_backward(aq, bq)
        return aq @ bq

    @staticmethod
    def backward(ctx, g):
        aq, bq = ctx.saved_tensors
        gq = _fp8(g)
        return gq @ bq.transpose(-1, -2), aq.transpose(-1, -2) @ gq


def mm(a: torch.Tensor, b: torch.Tensor, prec: str) -> torch.Tensor:
    """a @ b in the given precision."""
    if prec == "fp32":
        return a @ b
    if prec != "fp8":
        raise ValueError(f"precision {prec!r}")
    if b.dim() == 2 and a.dim() > 2:  # a linear layer: one 2-D product
        return _Fp8MatMul.apply(a.reshape(-1, a.shape[-1]), b).reshape(*a.shape[:-1], -1)
    return _Fp8MatMul.apply(a, b)


def linear(x, w: dict, name: str, prec: str):
    return mm(x, w[name + ".weight"].t(), prec) + w[name + ".bias"]


def positions(n: int, d: int, device) -> torch.Tensor:
    pos = torch.arange(n, dtype=torch.float32, device=device)[:, None]
    div = torch.exp(torch.arange(0, d, 2, dtype=torch.float32, device=device)
                    * (-math.log(10000.0) / d))
    pe = torch.zeros(n, d, device=device)
    pe[:, 0::2] = torch.sin(pos * div)
    pe[:, 1::2] = torch.cos(pos * div)
    return pe


def encoder_layer(x, w: dict, p: str, heads: int, prec: str, masks=None):
    """x (B, S, D) -> the post-LN layer's output; masks: three keep-masks
    (after the out-projection, after GELU, after linear2) or None."""
    B, S, D = x.shape
    dh = D // heads
    qkv = mm(x, w[p + "self_attn.in_proj_weight"].t(), prec) + w[p + "self_attn.in_proj_bias"]
    q, k, v = (t.reshape(B, S, heads, dh).transpose(1, 2) for t in qkv.split(D, -1))
    scores = mm(q, k.transpose(-1, -2), prec) / math.sqrt(dh)
    a = mm(torch.softmax(scores, -1), v, prec).transpose(1, 2).reshape(B, S, D)
    a = linear(a, w, p + "self_attn.out_proj", prec)
    if masks is not None:
        a = a * masks[0]
    x = F.layer_norm(x + a, (D,), w[p + "norm1.weight"], w[p + "norm1.bias"], 1e-5)
    h = F.gelu(linear(x, w, p + "linear1", prec))
    if masks is not None:
        h = h * masks[1]
    h = linear(h, w, p + "linear2", prec)
    if masks is not None:
        h = h * masks[2]
    return F.layer_norm(x + h, (D,), w[p + "norm2.weight"], w[p + "norm2.bias"], 1e-5)


def denoise(w: dict, x, t, enc_text, cfg: dict, encoder: str = "mdm.seqTransEncoder",
            prec: str = "fp32", pe_mask=None, layer_masks=None):
    """x (B, C, F, T), t (B,) original timesteps, enc_text (B, clip_dim)
    -> x0 (B, C, F, T). `encoder` is the stack the tokens go through: the
    prior's, or the style encoder ('style_encoder') between the prior's
    embedding and head, as StyleDiffusion runs it."""
    B, C, Fe, T = x.shape
    d = cfg["latent_dim"]
    pe = positions(max(T + 1, int(t.max()) + 1), d, x.device)
    emb = linear(F.silu(linear(pe[t], w, "mdm.embed_timestep.time_embed.0", prec)), w,
                 "mdm.embed_timestep.time_embed.2", prec)
    emb = emb + linear(enc_text, w, "mdm.embed_text", prec)
    h = linear(x.permute(0, 3, 1, 2).reshape(B, T, C * Fe), w,
               "mdm.input_process.poseEmbedding", prec)
    xs = torch.cat([emb[:, None], h], 1) + pe[None, :T + 1]
    if pe_mask is not None:
        xs = xs * pe_mask
    for i in range(cfg["num_layers"]):
        xs = encoder_layer(xs, w, f"{encoder}.layers.{i}.", cfg["num_heads"], prec,
                           None if layer_masks is None else layer_masks[i])
    out = linear(xs[:, 1:], w, "mdm.output_process.poseFinal", prec)
    return out.reshape(B, T, C, Fe).permute(0, 2, 3, 1)
