"""Sequence parallelism over the transformer encoder stack.

Counterpart of motionstyle/parallel/sequence.py: the frame axis is split over
the mesh's 'seq' dim. Every per-token op (the qkv and out projections, the
LayerNorms, the FFN) runs on the rank's own tokens; the one exchange is
attention's: each layer all-gathers k, v and the key mask over 'seq' with a
gradient, and the queries stay local, so activations and FLOPs scale as
S/k. The gather keeps the ranks' order, so every softmax sums its keys in
the unsplit order: exact, not approximate.

S is padded to a multiple of the group with masked tokens, whose outputs
are stripped (:53-81). Attention takes the plain path: with Sq != Sk the
standalone kernel (kernel 4, which needs Sq = Sk, ops/attention.py) cannot
run, as the JAX package's Pallas attention cannot (ops/attention.py:164-165).
The stack's output is gathered to every rank of the group; its backward
keeps the rank's own slice of the (replicated) gradient, and
sync_seq_grads sums the parameters' gradients over 'seq', the psum XLA
derives.

Composes with data parallelism: mesh dims ('data', 'seq'), the batch over
'data', the frames over 'seq'.
"""
from __future__ import annotations

from typing import Optional

import torch
import torch.distributed as dist
import torch.nn.functional as F

from motionstyle_torch.models.transformer import dense
from motionstyle_torch.ops.attention import multihead_attention
from motionstyle_torch.parallel import mesh as mesh_lib

def _gather_frames(t: torch.Tensor, group) -> torch.Tensor:
    """All ranks' frames (dim 1) in rank order; the backward sums every
    rank's contribution to this rank's frames (mesh.gather)."""
    return mesh_lib.gather(t, group, 1)


class _GatherOutput(torch.autograd.Function):
    """All ranks' frames in rank order; the backward keeps this rank's slice
    of a gradient that every rank holds whole (the loss is computed on the
    gathered output, replicated over the group)."""

    @staticmethod
    def forward(ctx, t, group, rank_, n):
        ctx.rank, ctx.n = rank_, n
        parts = [torch.empty_like(t) for _ in range(n)]
        dist.all_gather(parts, t.contiguous(), group=group)
        return torch.cat(parts, dim=1)

    @staticmethod
    def backward(ctx, g):
        return g.chunk(ctx.n, dim=1)[ctx.rank].contiguous(), None, None, None


def _layer(layer, x: torch.Tensor, mask: torch.Tensor, dtype: torch.dtype, group) -> torch.Tensor:
    """TransformerEncoderLayer's inference forward on local tokens, its
    attention over the gathered keys."""
    attn = layer.self_attn
    D = x.shape[-1]
    qkv = F.linear(x.to(dtype), attn.in_proj_weight.to(dtype), attn.in_proj_bias.to(dtype))
    q, kv = qkv[..., :D], qkv[..., D:]
    # one gather for k and v: each rank's backward then meets the same
    # collective in the same order
    k, v = _gather_frames(kv, group).split(D, -1)
    a = dense(attn.out_proj, multihead_attention(q, k, v, attn.num_heads, mask), dtype)
    x = layer.norm1((x.to(dtype) + a).float()).to(dtype)
    h = F.gelu(dense(layer.linear1, x, dtype), approximate="none")
    h = dense(layer.linear2, h, dtype)
    return layer.norm2((x + h).float()).to(dtype)


def sequence_parallel_encoder(encoder, x: torch.Tensor, key_padding_mask: Optional[torch.Tensor],
                              mesh, dtype: torch.dtype = torch.float32,
                              axis: str = "seq") -> torch.Tensor:
    """The encoder stack with the frame axis split over `axis`. x (B, S, D)
    whole on every rank of the group (the data shard's batch); returns
    (B, S, D) whole on every rank, equal to the sequential stack's."""
    group = mesh_lib.axis_group(mesh, axis)
    k, r = mesh_lib.axis_size(mesh, axis), mesh_lib.axis_rank(mesh, axis)
    B, S, _ = x.shape
    Sp = -(-S // k) * k
    if key_padding_mask is None:
        key_padding_mask = torch.ones((B, S), dtype=torch.bool, device=x.device)
    xp = F.pad(x, (0, 0, 0, Sp - S))
    maskp = F.pad(key_padding_mask.to(torch.bool), (0, Sp - S), value=False)
    n = Sp // k
    h, mask = xp[:, r * n:(r + 1) * n], maskp[:, r * n:(r + 1) * n]
    parts = [torch.empty_like(mask) for _ in range(k)]
    dist.all_gather(parts, mask.contiguous(), group=group)
    mask_full = torch.cat(parts, dim=1)
    for layer in encoder.layers:
        h = _layer(layer, h, mask_full, dtype, group)
    return _GatherOutput.apply(h, group, r, k)[:, :S]


def sync_seq_grads(params, mesh, axis: str = "seq") -> None:
    """Sum each parameter's gradient over `axis`: every rank's tokens
    contribute to every weight."""
    group = mesh_lib.axis_group(mesh, axis)
    for p in params:
        if p.grad is not None:
            dist.all_reduce(p.grad, group=group)


def seq_parallel_style_model_fn_builder(model, mesh):
    """A ShardedSampler model_fn_builder that runs StyleDiffusion's style
    encoder stack sequence-parallel over the mesh's 'seq' dim, between the
    model's own embed_tokens and output_head."""
    cfg = model.cfg

    def builder(params):
        m = params if params is not None else model

        def model_fn(x, t_orig, cond):
            xseq = m.embed_tokens(x, t_orig, cond.get("enc_text"))
            enc = sequence_parallel_encoder(m.style_encoder, xseq.to(cfg.torch_dtype), None,
                                            mesh, cfg.torch_dtype)
            return m.output_head(enc.to(xseq.dtype))

        return model_fn

    return builder
