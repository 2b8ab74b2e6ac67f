"""Standalone multi-head attention for the unfused denoiser: a CUDA kernel for
Hopper and its plain PyTorch twin, behind the JAX package's dispatch.

Replaces the Pallas TPU kernel motionstyle/ops/attention.py::_pallas_attention
(pallas_call at :90; kernel 4). Per (batch row, head), with the Pallas body's
roundings (:73-88):

  qs  = q * scale, rounded to the input dtype     scale = 1/sqrt(dh), itself
                                                  in the input dtype (JAX's
                                                  weakly typed Python float)
  s   = qs k^T + mask                             fp32 products and sums; the
                                                  additive key mask (0 / -1e9)
                                                  added in fp32
  p   = softmax(s)                                fp32, p kept in fp32
  out = p v                                       fp32 products and sums; fp32
                                                  output (B, S, D)

fp32 inputs (the unfused denoiser's default) give fp32 products throughout;
bf16 inputs differ only in q, k and v being bf16 values. The kernel
(csrc/attention.cu) runs the products on the tensor cores in split
precision, never in single-pass TF32 (three digits): fp32 operands split into
two TF32 terms each and multiply as hi*hi + hi*lo + lo*hi (3xTF32); bf16 q k^T
is exact in bf16 products, and p v splits p in two TF32 terms against v,
which is exact in TF32. Its softmax is online and normalises at the end,
which changes only fp32 rounding since p is never rounded. The keys of each
16-row query group are split over 4 warps and combined at the end, so the
short sequences fill the card (see the source for the design);
tests/test_torch_attention_split.py emulates the split on the CPU.

`multihead_attention` copies the JAX dispatch (:133-178): self-attention
only; with use_pallas=None the kernel runs for CUDA tensors when S > 512 or
MOTIONSTYLE_PALLAS_ATTN=1 (read at call time), as the JAX package runs the
Pallas kernel on the TPU; otherwise the plain version runs. The kernel's
gradient is the plain version's recompute under autograd (_attention_bwd,
:118-129, is XLA's recompute, not a kernel). `attention_kernel.launches`
counts kernel launches.

A row whose every key is masked is left out of every comparison: the Pallas
kernel's padded keys (-1e9) then take part in its softmax and the XLA path's
do not. No caller produces one: the denoiser's first token is always valid.
"""
from __future__ import annotations

import functools
import math
import os
from typing import Optional

import torch

from motionstyle_torch.ops.fused_encoder import MAX_HEAD_WIDTH, additive_key_mask


def _heads(t: torch.Tensor, num_heads: int) -> torch.Tensor:
    B, S, D = t.shape
    return t.reshape(B, S, num_heads, D // num_heads).transpose(1, 2)


@functools.lru_cache(maxsize=None)
def head_scale(dh: int, dtype: torch.dtype) -> float:
    """1/sqrt(dh) rounded to `dtype`, as JAX rounds the Python float of
    `qb * scale` to a bf16 operand's dtype."""
    return float(torch.tensor(1.0 / math.sqrt(dh), dtype=torch.float32).to(dtype))


def attention_reference(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, num_heads: int,
                        mask_add: Optional[torch.Tensor] = None) -> torch.Tensor:
    """The Pallas body in plain PyTorch, on any device. q (B, Sq, D), k and v
    (B, Sk, D), fp32 or bf16; mask_add (B, Sk) additive fp32 or None. Returns
    fp32 (B, Sq, D)."""
    dh = q.shape[-1] // num_heads
    qs = q * head_scale(dh, q.dtype)
    scores = _heads(qs, num_heads).float() @ _heads(k, num_heads).float().transpose(-1, -2)
    if mask_add is not None:
        scores = scores + mask_add[:, None, None, :].float()
    p = torch.softmax(scores, dim=-1)
    out = p @ _heads(v, num_heads).float()
    B, _, Sq, _ = out.shape
    return out.transpose(1, 2).reshape(B, Sq, -1)


def _rows(t: torch.Tensor) -> tuple:
    """(tensor, row stride) with unit column stride and rows evenly spaced
    across the batch, so that (b, s) is row b*S + s at that stride; a column
    slice of a packed (B, S, 3D) qkv passes as it is, anything else is made
    contiguous. Every row starts 16-byte aligned."""
    B, S, D = t.shape
    ld = t.stride(1) if S > 1 else t.stride(0)
    aligned = t.data_ptr() % 16 == 0 and (ld * t.element_size()) % 16 == 0
    if t.stride(2) != 1 or t.stride(0) != S * ld or not aligned:
        t = t.contiguous()
        ld = D
    return t, ld


def _check_cuda_inputs(q, k, v, num_heads, mask_add) -> tuple:
    """Refuse what the kernel does not take: self-attention over (B, S, D)
    fp32 or bf16 tensors of one dtype on one card, S >= 1, a head width D / H
    that is a multiple of 16 up to MAX_HEAD_WIDTH; mask_add (B, S) fp32."""
    if q.shape != k.shape or q.shape != v.shape or q.dim() != 3:
        raise ValueError(f"the attention kernel takes self-attention over equal (B, S, D) "
                         f"q, k, v; got {tuple(q.shape)}, {tuple(k.shape)}, {tuple(v.shape)}")
    B, S, D = q.shape
    if q.dtype not in (torch.float32, torch.bfloat16) or k.dtype != q.dtype \
            or v.dtype != q.dtype:
        raise ValueError(f"q, k, v must share a dtype, float32 or bfloat16; got {q.dtype}, "
                         f"{k.dtype}, {v.dtype}")
    if k.device != q.device or v.device != q.device:
        raise ValueError("q, k and v must be on one device")
    dh = D // num_heads if num_heads >= 1 else 0
    if num_heads < 1 or D % num_heads or dh % 16 or not 16 <= dh <= MAX_HEAD_WIDTH or S < 1:
        raise ValueError(f"the attention kernel takes a head width that is a multiple of 16 up "
                         f"to {MAX_HEAD_WIDTH} and any S >= 1; got D={D} H={num_heads} S={S}")
    if mask_add is not None and (tuple(mask_add.shape) != (B, S)
                                 or mask_add.dtype != torch.float32
                                 or mask_add.device != q.device):
        raise ValueError(f"mask_add must be a float32 ({B}, {S}) tensor on {q.device}, got "
                         f"{mask_add.dtype} {tuple(mask_add.shape)} on {mask_add.device}")
    return B, S, D, dh


def attention_kernel(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, num_heads: int,
                     mask_add: Optional[torch.Tensor] = None) -> torch.Tensor:
    """Launch kernel 4 on CUDA tensors (forward only; see multihead_attention
    for the differentiable call). Same arguments and result as
    attention_reference. q, k and v may be column slices of one packed
    (B, S, 3D) tensor: the kernel takes each one's row stride."""
    if q.device.type != "cuda":
        raise ValueError(f"the attention kernel runs on cuda tensors, not {q.device}")
    from motionstyle_torch import _build

    B, S, D, dh = _check_cuda_inputs(q, k, v, num_heads, mask_add)
    lib = _build.load("attention")
    (q, ldq), (k, ldk), (v, ldv) = _rows(q), _rows(k), _rows(v)
    if mask_add is not None:
        mask_add = mask_add.contiguous()
    out = torch.empty((B, S, D), dtype=torch.float32, device=q.device)
    rc = lib.attention_forward(
        q.data_ptr(), ldq, k.data_ptr(), ldk, v.data_ptr(), ldv,
        None if mask_add is None else mask_add.data_ptr(), out.data_ptr(),
        B, S, num_heads, dh, int(q.dtype == torch.bfloat16), head_scale(dh, q.dtype),
        torch.cuda.current_stream(q.device).cuda_stream)
    if rc != 0:
        raise RuntimeError(f"attention kernel failed: CUDA error {rc}")
    attention_kernel.launches += 1
    return out


attention_kernel.launches = 0


class KernelAttention(torch.autograd.Function):
    """Kernel 4's forward; the backward recomputes attention_reference under
    autograd (the JAX package's XLA recompute backward), so its gradients
    are the plain version's."""

    @staticmethod
    def forward(ctx, q, k, v, num_heads, mask_add):
        ctx.num_heads = num_heads
        ctx.save_for_backward(q, k, v, mask_add)
        return attention_kernel(q, k, v, num_heads, mask_add)

    @staticmethod
    def backward(ctx, g):
        q, k, v, mask_add = ctx.saved_tensors
        leaves = [t.detach().requires_grad_(need)
                  for t, need in zip((q, k, v), ctx.needs_input_grad[:3])]
        with torch.enable_grad():
            out = attention_reference(*leaves, ctx.num_heads, mask_add)
        wanted = [t for t in leaves if t.requires_grad]
        grads = iter(torch.autograd.grad(out, wanted, g))
        return (*(next(grads) if t.requires_grad else None for t in leaves), None, None)


def use_kernel(q: torch.Tensor, k: torch.Tensor, use_pallas: Optional[bool] = None) -> bool:
    """The JAX dispatch (:164-172): self-attention only; by default the kernel
    on the card for S > 512 or with MOTIONSTYLE_PALLAS_ATTN=1."""
    if q.shape[1] != k.shape[1]:
        return False  # the kernel takes self-attention only
    if use_pallas is None:
        return q.device.type == "cuda" and (
            q.shape[1] > 512 or os.environ.get("MOTIONSTYLE_PALLAS_ATTN") == "1")
    return bool(use_pallas)


def multihead_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, num_heads: int,
                        key_padding_mask: Optional[torch.Tensor] = None,
                        use_pallas: Optional[bool] = None) -> torch.Tensor:
    """Self/cross attention over (B, S, D) tensors, fp32 (B, Sq, D) out.

    key_padding_mask: (B, Sk) with True/1 = valid key. use_pallas=None picks
    the kernel as use_kernel says; True asks for it and raises on CPU
    tensors (the kernel runs only on the card); False runs the plain
    version."""
    mask_add = additive_key_mask(key_padding_mask, k.shape[0], k.shape[1], k.device)
    if use_kernel(q, k, use_pallas):
        if q.device.type != "cuda":
            raise ValueError(f"use_pallas=True: the attention kernel runs on cuda tensors, "
                             f"not {q.device}")
        return KernelAttention.apply(q, k, v, num_heads, mask_add)
    return attention_reference(q, k, v, num_heads, mask_add)
