"""One fused post-LN transformer encoder layer: a CUDA kernel for Hopper and
its plain PyTorch twin.

Replaces the Pallas TPU kernel motionstyle/ops/fused_encoder.py::_layer_kernel
(pallas_call in fused_encoder_layer). Same math, with the bf16 roundings in
the same places:

  qkv = bf16(x) Wqkv^T + b                      bf16 operands, fp32 accumulate
  per head: softmax(bf16(q/sqrt(dh)) bf16(k)^T + mask) -> bf16(p) bf16(v)
  h1  = LN1(x + bf16(attn) Wo^T + bo)           fp32 statistics, eps 1e-5
  out = LN2(h1 + bf16(gelu_tanh(bf16(h1) W1^T + b1)) W2^T + b2)

The gelu is the tanh approximation (the TPU kernel's, ~1e-3 from the exact
erf gelu of the unfused layer). The output has x's dtype.

On the card (csrc/fused_encoder.cu) the layer is bound by tensor-core
operations at the serving shape: ~2.7 GFLOP over ~5 MB at B=8, S=77, D=512,
F=1024. The TPU kernel held a whole batch row plus all weights in VMEM per
grid step; a Hopper SM has 227 KB of shared memory, so the layer runs as five
launches (qkv GEMM, attention per (row, head) over key tiles, out-projection
+ LN1, FFN-up + gelu, FFN-down + LN2), each LayerNorm fused into the GEMM
block that owns whole rows. See the source for the design and the shapes it
takes (_check_cuda_inputs states them).

`fused_encoder_layer` launches the kernel for CUDA tensors (or raises) and
runs the twin `fused_encoder_layer_reference` only for CPU tensors.
`fused_encoder_layer.launches` counts kernel launches (one per layer call).
"""
from __future__ import annotations

import math
from typing import Optional

import torch

_NEG = -1e9
_BF16 = torch.bfloat16

# packed layer parameters: weights bf16 (out, in) as nn.Linear stores them,
# vectors fp32
WEIGHT_KEYS = ("in_proj_weight", "out_proj_weight", "linear1_weight",
               "linear2_weight")
VECTOR_KEYS = ("in_proj_bias", "out_proj_bias", "norm1_weight", "norm1_bias",
               "linear1_bias", "linear2_bias", "norm2_weight", "norm2_bias")


def layer_params(layer) -> dict:
    """An encoder layer module (models.transformer.TransformerEncoderLayer)
    -> its parameters by kernel name, still attached to autograd."""
    return {
        "in_proj_weight": layer.self_attn.in_proj_weight,
        "in_proj_bias": layer.self_attn.in_proj_bias,
        "out_proj_weight": layer.self_attn.out_proj.weight,
        "out_proj_bias": layer.self_attn.out_proj.bias,
        "linear1_weight": layer.linear1.weight,
        "linear1_bias": layer.linear1.bias,
        "linear2_weight": layer.linear2.weight,
        "linear2_bias": layer.linear2.bias,
        "norm1_weight": layer.norm1.weight,
        "norm1_bias": layer.norm1.bias,
        "norm2_weight": layer.norm2.weight,
        "norm2_bias": layer.norm2.bias,
    }


def pack(params: dict) -> dict:
    """Kernel format: bf16 contiguous weights, fp32 contiguous vectors,
    detached."""
    return {k: v.detach().to(_BF16 if k in WEIGHT_KEYS else torch.float32).contiguous()
            for k, v in params.items()}


def pack_layer_params(layer) -> dict:
    """An encoder layer module -> the kernel's parameter dict."""
    return pack(layer_params(layer))


def additive_key_mask(key_padding_mask: Optional[torch.Tensor], B: int, S: int,
                      device) -> Optional[torch.Tensor]:
    """(B, S) bool, True = valid key -> (B, S) fp32 additive mask (0 / -1e9)."""
    if key_padding_mask is None:
        return None
    if tuple(key_padding_mask.shape) != (B, S):
        raise ValueError(f"key_padding_mask must be ({B}, {S}), got "
                         f"{tuple(key_padding_mask.shape)}")
    keep = key_padding_mask.to(device=device, dtype=torch.bool)
    return torch.where(keep, 0.0, _NEG).to(torch.float32).contiguous()


def _bf16_dot(h, w, b):
    """bf16 operands, fp32 products and sums, fp32 bias."""
    return h.to(_BF16).float() @ w.to(_BF16).float().t() + b.float()


def _layernorm(h, scale, bias):
    mu = h.mean(-1, keepdim=True)
    var = ((h - mu) ** 2).mean(-1, keepdim=True)
    return (h - mu) * torch.rsqrt(var + 1e-5) * scale.float() + bias.float()


def gelu_tanh(f):
    return 0.5 * f * (1.0 + torch.tanh(0.7978845608028654 * (f + 0.044715 * f ** 3)))


def fused_encoder_layer_reference(x: torch.Tensor, p: dict, num_heads: int,
                                  key_padding_mask: Optional[torch.Tensor] = None
                                  ) -> torch.Tensor:
    """Plain PyTorch twin of the kernel: the same math in the same bf16/fp32
    places, on any device. x (B, S, D); p from pack_layer_params."""
    B, S, D = x.shape
    dh = D // num_heads
    xb = x.to(_BF16)
    qkv = _bf16_dot(xb, p["in_proj_weight"], p["in_proj_bias"])  # (B, S, 3D)
    q, k, v = qkv.split(D, dim=-1)

    def heads(t):
        return t.to(_BF16).float().reshape(B, S, num_heads, dh).transpose(1, 2)

    scores = heads(q * (1.0 / math.sqrt(dh))) @ heads(k).transpose(-1, -2)
    mask = additive_key_mask(key_padding_mask, B, S, x.device)
    if mask is not None:
        scores = scores + mask[:, None, None, :]
    m = scores.amax(dim=-1, keepdim=True)
    e = torch.exp(scores - m)
    probs = e / e.sum(dim=-1, keepdim=True)
    attn = (probs.to(_BF16).float() @ heads(v)).transpose(1, 2).reshape(B, S, D)
    h1 = _layernorm(xb.float() + _bf16_dot(attn, p["out_proj_weight"],
                                           p["out_proj_bias"]),
                    p["norm1_weight"], p["norm1_bias"])
    ff = gelu_tanh(_bf16_dot(h1, p["linear1_weight"], p["linear1_bias"]))
    ff = _bf16_dot(ff, p["linear2_weight"], p["linear2_bias"])
    h2 = _layernorm(h1 + ff, p["norm2_weight"], p["norm2_bias"])
    return h2.to(x.dtype)


MAX_D, MAX_HEAD_WIDTH = 1024, 128  # the widest rows and heads the CUDA kernels take


def _check_cuda_inputs(x, p, num_heads):
    """Refuse what the CUDA launchers do not take: D a multiple of 64 up to
    MAX_D, a head width D / H that is a multiple of 16 up to MAX_HEAD_WIDTH,
    F a multiple of 64; any S >= 1. num_heads None skips the head check (a
    half of a layer without attention)."""
    B, S, D = x.shape
    F = p["linear1_weight"].shape[0]
    shapes = {"in_proj_weight": (3 * D, D), "out_proj_weight": (D, D),
              "linear1_weight": (F, D), "linear2_weight": (D, F),
              "in_proj_bias": (3 * D,), "out_proj_bias": (D,),
              "linear1_bias": (F,), "linear2_bias": (D,),
              "norm1_weight": (D,), "norm1_bias": (D,),
              "norm2_weight": (D,), "norm2_bias": (D,)}
    for key, shape in shapes.items():
        t = p[key]
        want = _BF16 if key in WEIGHT_KEYS else torch.float32
        if tuple(t.shape) != shape or t.dtype != want or t.device != x.device \
                or not t.is_contiguous():
            raise ValueError(
                f"{key}: need a contiguous {want} {shape} tensor on {x.device}, "
                f"got {t.dtype} {tuple(t.shape)} on {t.device}")
    heads_ok = num_heads is None or (
        num_heads >= 1 and D % num_heads == 0 and (D // num_heads) % 16 == 0
        and D // num_heads <= MAX_HEAD_WIDTH)
    if D % 64 or not 64 <= D <= MAX_D or not heads_ok or F % 64 or F < 64 or S < 1:
        raise ValueError(
            f"kernel supports D a multiple of 64 up to {MAX_D}, a head width that is a "
            f"multiple of 16 up to {MAX_HEAD_WIDTH}, F a multiple of 64 and any S >= 1; "
            f"got D={D} H={num_heads} F={F} S={S}")
    if x.dtype not in (_BF16, torch.float32):
        raise ValueError(f"x must be bfloat16 or float32, got {x.dtype}")
    return B, S, D, F


def refuse_grad(*tensors: torch.Tensor) -> None:
    """The inference layer is forward-only (the JAX package's pallas_call has
    no VJP either): a forward that autograd would differentiate must take the
    training path (MDMConfig.fused_train, ops/fused_encoder_train.py) instead
    of losing its gradient here."""
    if torch.is_grad_enabled() and any(t.requires_grad for t in tensors):
        raise RuntimeError(
            "the fused inference encoder layer has no backward: run it under "
            "torch.no_grad(), or train through fused_train "
            "(ops/fused_encoder_train.py)")


def fused_encoder_layer(x: torch.Tensor, p: dict, num_heads: int,
                        key_padding_mask: Optional[torch.Tensor] = None
                        ) -> torch.Tensor:
    """Run one fused encoder layer. x (B, S, D) bf16 or fp32; p from
    pack_layer_params; key_padding_mask (B, S) with True = valid key.
    CUDA tensors launch the kernel; CPU tensors run the twin. Refuses inputs
    that require grad while grad is enabled (refuse_grad)."""
    refuse_grad(x, *p.values())
    if x.device.type == "cpu":
        return fused_encoder_layer_reference(x, p, num_heads, key_padding_mask)
    if x.device.type != "cuda":
        raise ValueError(f"fused_encoder_layer runs on cuda or cpu, not {x.device}")
    from motionstyle_torch import _build

    B, S, D, F = _check_cuda_inputs(x, p, num_heads)
    lib = _build.load("fused_encoder")
    M = B * S
    xb = x.to(_BF16).contiguous()
    kmask = additive_key_mask(key_padding_mask, B, S, x.device)
    act = torch.empty((5, M, D), dtype=_BF16, device=x.device)  # q k v attn h1
    h1_f32 = torch.empty((M, D), dtype=torch.float32, device=x.device)
    ff = torch.empty((M, F), dtype=_BF16, device=x.device)
    out = torch.empty((B, S, D), dtype=x.dtype, device=x.device)
    ptr = lambda t: None if t is None else t.data_ptr()  # noqa: E731
    rc = lib.fused_encoder_layer_forward(
        ptr(xb), ptr(kmask),
        ptr(p["in_proj_weight"]), ptr(p["in_proj_bias"]),
        ptr(p["out_proj_weight"]), ptr(p["out_proj_bias"]),
        ptr(p["norm1_weight"]), ptr(p["norm1_bias"]),
        ptr(p["linear1_weight"]), ptr(p["linear1_bias"]),
        ptr(p["linear2_weight"]), ptr(p["linear2_bias"]),
        ptr(p["norm2_weight"]), ptr(p["norm2_bias"]),
        ptr(act[0]), ptr(act[1]), ptr(act[2]), ptr(act[3]),
        ptr(h1_f32), ptr(act[4]), ptr(ff),
        ptr(out) if out.dtype == _BF16 else None,
        ptr(out) if out.dtype == torch.float32 else None,
        B, S, D, num_heads, F,
        torch.cuda.current_stream(x.device).cuda_stream)
    if rc != 0:
        raise RuntimeError(f"fused_encoder_layer kernel failed: CUDA error {rc}")
    fused_encoder_layer.launches += 1
    return out


fused_encoder_layer.launches = 0


def fused_encoder(x: torch.Tensor, layers: list, num_heads: int,
                  key_padding_mask: Optional[torch.Tensor] = None) -> torch.Tensor:
    """Stack of fused layers over packed per-layer parameter dicts."""
    for p in layers:
        x = fused_encoder_layer(x, p, num_heads, key_padding_mask)
    return x
