"""Pipeline parallelism over the transformer encoder stack (GPipe schedule).

Counterpart of motionstyle/parallel/pipeline.py. The L identical encoder
layers are split into n_stages contiguous stages along the mesh's 'pipe'
dim: stage s owns layers [s*Lps, (s+1)*Lps). A batch is cut into n_micro
microbatches that stream through the stages, stage to stage by
point-to-point send and receive over the 'pipe' group, in the GPipe
fill/steady/drain order; the last stage holds the result.

Where the JAX package derives the backward by autodiff through ppermute,
the port schedules it by hand, as GPipe does: the last stage runs the loss's
backward into its layers, then each stage, for the microbatches in reverse,
receives the gradient of its outputs from the next stage, runs its layers'
backward and sends the gradient of its inputs to the previous one
(StagePipeline.backward). The embedding and the head are replicated over
'pipe': stage 0 alone feeds the embedding's output in and the last stage
alone runs the head, so each holds their gradients alone, and
sync_replicated_grads sums them over 'pipe' onto every stage's copy.

Numerics are those of the sequential stack: the same layer math in the same
order (tests/test_torch_pipeline.py). A training forward draws each (stage,
layer, microbatch)'s dropout masks from a generator of its own, seeded from
one draw of the caller's generator: independent of (statistically the same
as) the sequential stack's draws, as the JAX pipeline's key folds are
(:102-109).

Composes with data parallelism: mesh dims ('data', 'pipe'), the batch over
'data', each data shard running its own pipeline over the same stages.
Every rank keeps the whole model; only its stage's layers run and update
there, and a checkpoint first gathers each layer from its stage
(gather_stage_layers), so model*.pt and opt*.pt stay layout-independent.
"""
from __future__ import annotations

from typing import Optional

import torch
import torch.distributed as dist

from motionstyle_torch.ops.fused_encoder_train import make_dropout_masks
from motionstyle_torch.parallel import mesh as mesh_lib

_SEED_MOD = 2 ** 62


def stack_stage_params(encoder_state: dict, num_layers: int, n_stages: int) -> dict:
    """A TransformerEncoder state dict ('layers.{i}.<key>') -> {<key>: tensor
    with two leading axes (n_stages, layers_per_stage)}; stage s holds layers
    [s*Lps, (s+1)*Lps) in order."""
    assert num_layers % n_stages == 0, (num_layers, n_stages)
    lps = num_layers // n_stages
    keys = sorted({k.split(".", 2)[2] for k in encoder_state if k.startswith("layers.")})
    return {k: torch.stack([torch.stack([encoder_state[f"layers.{s * lps + i}.{k}"]
                                         for i in range(lps)]) for s in range(n_stages)])
            for k in keys}


def unstack_stage_params(stacked: dict, num_layers: int) -> dict:
    """Inverse of stack_stage_params: back to 'layers.{i}.<key>'."""
    flat = {k: v.reshape((num_layers,) + tuple(v.shape[2:])) for k, v in stacked.items()}
    return {f"layers.{i}.{k}": v[i] for k, v in flat.items() for i in range(num_layers)}


def stage_layers(num_layers: int, n_stages: int, stage: int) -> range:
    """The layer indices stage `stage` owns."""
    lps = num_layers // n_stages
    return range(stage * lps, (stage + 1) * lps)


def default_micro(per_shard: int, n_stages: int) -> int:
    """The JAX trainer's auto microbatch count: the largest divisor of the
    per-data-shard batch no larger than 2 * n_stages."""
    return max(d for d in range(1, per_shard + 1) if per_shard % d == 0 and d <= 2 * n_stages)


class StagePipeline:
    """One rank's part of a GPipe schedule over the 'pipe' dim of `mesh`.

    forward() runs the stage's layers of `encoder` on every microbatch,
    receiving the previous stage's outputs and sending its own on; it
    returns the stack's output (B, S, D) on the last stage and None on the
    others. With a gradient, backward() must follow once the last stage's
    loss has been differentiated into that output."""

    def __init__(self, encoder, mesh, n_micro: int):
        self.encoder = encoder
        self.group = mesh_lib.axis_group(mesh, "pipe")
        self.n_stages = mesh_lib.axis_size(mesh, "pipe")
        self.stage = mesh_lib.axis_rank(mesh, "pipe")
        self.n_micro = n_micro
        self.layers = [encoder.layers[i] for i in
                       stage_layers(len(encoder.layers), self.n_stages, self.stage)]
        ranks = dist.get_process_group_ranks(self.group)
        self.prev = ranks[self.stage - 1] if self.stage > 0 else None
        self.next = ranks[self.stage + 1] if self.stage < self.n_stages - 1 else None
        self.first, self.last = self.stage == 0, self.stage == self.n_stages - 1
        self.data_rank = mesh_lib.axis_rank(mesh, "data")  # decorrelates data shards' draws
        self._saved = []

    def _apply(self, h, mask, dtype, gen_seed, micro: int):
        for j, layer in enumerate(self.layers):
            masks = None
            if gen_seed is not None:
                li = self.stage * len(self.layers) + j
                gen = torch.Generator(device=h.device).manual_seed(
                    ((gen_seed * 1000003 + self.data_rank) * 1009 + li * 101 + micro)
                    % _SEED_MOD)
                masks = make_dropout_masks(gen, h.shape, self.encoder.dropout,
                                           self.encoder.dim_feedforward, dtype=torch.float32)
            h = layer(h, mask, dtype, masks)
        return h

    def forward(self, x: torch.Tensor, key_padding_mask: Optional[torch.Tensor] = None,
                dtype: torch.dtype = torch.float32, dropout_seed: Optional[int] = None
                ) -> Optional[torch.Tensor]:
        """x: (B, S, D), the data shard's batch (read by stage 0 only).
        dropout_seed: a training forward's seed (None: no dropout)."""
        B = x.shape[0]
        if B % self.n_micro:
            raise ValueError(f"{self.n_micro} microbatches do not divide the batch {B}")
        bm = B // self.n_micro
        grad = torch.is_grad_enabled()
        self._saved, outs, self._x = [], [], x
        for m in range(self.n_micro):
            rows = slice(m * bm, (m + 1) * bm)
            mask = None if key_padding_mask is None else key_padding_mask[rows]
            if self.first:
                # a leaf per microbatch: backward() sends the embedding's
                # gradient through x once, after the drain
                inp = x[rows].detach().requires_grad_(grad and x.requires_grad)
            else:
                inp = torch.empty((bm,) + tuple(x.shape[1:]), dtype=dtype, device=x.device)
                dist.recv(inp, self.prev, group=self.group)
                inp.requires_grad_(grad)
            out = self._apply(inp, mask, dtype, dropout_seed, m)
            if self.last:
                outs.append(out)
            else:
                dist.send(out.detach().contiguous(), self.next, group=self.group)
            if grad:
                self._saved.append((inp, out))
        return torch.cat(outs) if self.last else None

    def backward(self) -> None:
        """The drain of the backward: microbatches in reverse, each stage's
        input gradients sent to the previous stage."""
        for inp, out in reversed(self._saved):
            if not self.last:
                g = torch.empty_like(out)
                dist.recv(g, self.next, group=self.group)
                torch.autograd.backward(out, g)
            if not self.first:
                g_in = inp.grad if inp.grad is not None else torch.zeros_like(inp)
                dist.send(g_in.contiguous(), self.prev, group=self.group)
        if self.first and self._saved and self._x.requires_grad:
            torch.autograd.backward(self._x, torch.cat([inp.grad for inp, _ in self._saved]))
        self._saved, self._x = [], None

    def broadcast(self, out: Optional[torch.Tensor], like: torch.Tensor) -> torch.Tensor:
        """The last stage's output on every stage (inference)."""
        buf = out.contiguous() if self.last else torch.empty_like(like)
        dist.broadcast(buf, dist.get_process_group_ranks(self.group)[-1], group=self.group)
        return buf


def pipeline_encoder(encoder, x: torch.Tensor, key_padding_mask: Optional[torch.Tensor],
                     mesh, n_micro: int, dtype: torch.dtype = torch.float32) -> torch.Tensor:
    """The encoder stack's inference forward pipelined over the mesh's 'pipe'
    dim, returned on every stage; equal to the sequential stack's."""
    with torch.no_grad():
        pipe = StagePipeline(encoder, mesh, n_micro)
        return pipe.broadcast(pipe.forward(x, key_padding_mask, dtype), x.to(dtype))


def sync_replicated_grads(params, mesh) -> None:
    """Sum the gradients of the parameters replicated over 'pipe' (the
    embedding's, held by stage 0, and the head's, held by the last stage)
    onto every stage's copy."""
    group = mesh_lib.axis_group(mesh, "pipe")
    for p in params:
        if p.grad is None:
            p.grad = torch.zeros_like(p)
        dist.all_reduce(p.grad, group=group)


def gather_stage_layers(encoder, mesh, tensors: Optional[dict] = None, prefix: str = "") -> None:
    """Broadcast each layer's parameters (or, with `tensors`, the entries
    '{prefix}layers.{i}.*' of that dict: the EMA, or moments keyed alike)
    from the stage that owns the layer to every stage, in place."""
    group = mesh_lib.axis_group(mesh, "pipe")
    n_stages = mesh_lib.axis_size(mesh, "pipe")
    ranks = dist.get_process_group_ranks(group)
    L = len(encoder.layers)
    for s in range(n_stages):
        for i in stage_layers(L, n_stages, s):
            if tensors is None:
                items = [p.data for p in encoder.layers[i].parameters()]
            else:
                items = [v for k, v in sorted(tensors.items())
                         if k.startswith(f"{prefix}layers.{i}.")]
            for t in items:
                dist.broadcast(t, ranks[s], group=group)


def pipelined_style_model_fn_builder(model, mesh, n_micro: int):
    """A ShardedSampler model_fn_builder that runs StyleDiffusion's style
    encoder stack pipelined over the mesh's 'pipe' dim, between the model's
    own embed_tokens and output_head; equal to the plain forward."""
    cfg = model.cfg

    def builder(params):
        m = params if params is not None else model

        def model_fn(x, t_orig, cond):
            xseq = m.embed_tokens(x, t_orig, cond.get("enc_text"))
            enc = pipeline_encoder(m.style_encoder, xseq.to(cfg.torch_dtype), None, mesh,
                                   n_micro, cfg.torch_dtype)
            return m.output_head(enc.to(xseq.dtype))

        return model_fn

    return builder
