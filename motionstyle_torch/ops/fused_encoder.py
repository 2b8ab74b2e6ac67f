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
launches (qkv GEMM, attention on the tensor cores per (row, head, 16
queries) over key tiles, out-projection + LN1, FFN-up + gelu, FFN-down +
LN2). The GEMMs run wgmma on tiles that TMA streams through a shared-memory
ring (csrc/wgmma.cuh); each LayerNorm launch is a thread-block cluster whose
blocks split a row's columns and share its statistics through distributed
shared memory. See the source for the design and the shapes it takes
(_check_cuda_inputs states them).

`fused_encoder_layer` launches the kernel for CUDA tensors (or raises) and
runs the twin `fused_encoder_layer_reference` only for CPU tensors.
`fused_encoder_layer.launches` counts kernel launches (one per layer call).

The int8 serving layer (`fused_encoder_layer_int8`, csrc/fused_encoder_int8.cu)
replaces the Pallas TPU kernel motionstyle/ops/fused_encoder.py::
_layer_kernel_int8 (pallas_call in fused_encoder_layer_int8): kernel 1 with
its four large matmuls done int8 x int8 -> int32 (`int8_dot`):

  q, s = quant_rows(h)      per row: s = max(max|h| / 127, 1e-8),
                            q = clip(round_half_even(h / s), -127, 127)
  y    = fp32(q Wq^T) * s * s_w + b   per-output-channel weight scales s_w

  qkv = int8_dot(x)                             x the bf16 input in fp32
  per head: softmax(bf16(q/sqrt(dh)) bf16(k)^T + mask) -> bf16(p) bf16(v),
            the attention output kept in fp32
  h1  = LN1(x + int8_dot(attn))
  out = LN2(h1 + int8_dot(gelu_tanh(int8_dot(h1))))   gelu output fp32

Weights are quantized once from the fp32 parameters (quantize_weight), never
from kernel 1's bf16 copies. On the card it is bound by operations: at B=8,
S=77, D=512, F=1024 the four int8 GEMMs are ~2.6 GOP at 1,979 TOP/s and the
attention products ~0.1 GFLOP at 989 TFLOP/s. Its four GEMMs are kernel 1's
wgmma GEMM on s8 operands (int32 sums; `int8_layer_plan` mirrors its
tile plan), its attention kernel 1's tensor-core launch with an fp32
output, and three launches write the row codes of x, attn and ff.
`fused_encoder_layer_int8` launches the kernel for CUDA tensors (or raises),
runs its twin `fused_encoder_layer_int8_reference` only for CPU tensors, and
counts its launches in `fused_encoder_layer_int8.launches`.

Both layers are also the custom operators motionstyle::fused_encoder_layer
and motionstyle::fused_encoder_layer_int8 (torch.library.custom_op, each with
a fake that gives a (B, S, D) tensor in x's dtype), so torch.export keeps
them as opaque nodes of an exported program (serve/export.py). The
operators take a layer's own fp32 parameters (layer_params, in LAYER_KEYS
order) and convert them to the kernel's format once for each set of tensor
versions (packed_params, the one cache of the kernel formats, which
TransformerEncoder.packed_layers reads for an eager model too), so a program
does not repeat the conversion at every call; then they make the same eager
call, counter included. A traced model
(TransformerEncoder under torch.export) calls traced_fused_encoder; an
eager one launches the kernels directly. A process that loads an exported
program must import this module first, so that the operators exist.
"""
from __future__ import annotations

import math
from typing import Optional

import torch

from motionstyle_torch.parallel.mesh import refuse_dtensor

_NEG = -1e9
_BF16 = torch.bfloat16

# packed layer parameters: weights bf16 (out, in) as nn.Linear stores them,
# vectors fp32
WEIGHT_KEYS = ("in_proj_weight", "out_proj_weight", "linear1_weight",
               "linear2_weight")
VECTOR_KEYS = ("in_proj_bias", "out_proj_bias", "norm1_weight", "norm1_bias",
               "linear1_bias", "linear2_bias", "norm2_weight", "norm2_bias")
# the int8 layer's per-output-channel weight scales, fp32 (N,), beside the
# int8 (out, in) codes under the WEIGHT_KEYS
SCALE_KEYS = tuple(k.replace("_weight", "_scale") for k in WEIGHT_KEYS)


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


def _div127(amax: torch.Tensor) -> torch.Tensor:
    """amax / 127 as a true division. PyTorch's CUDA division by a Python
    scalar multiplies by its reciprocal, which rounds some scales one ulp
    away from the JAX package's and the kernel's amax / 127; the inputs of
    the int8 layer are bf16 values, whose codes often sit exactly on a tie,
    so that ulp would move whole rows of codes."""
    return amax / amax.new_tensor(127.0)


def quantize_weight(w: torch.Tensor) -> tuple:
    """Per-output-channel symmetric int8 of an (out, in) weight: (int8 codes
    (out, in), fp32 scales (out,)). The JAX package's quantize_weight on its
    (in, out) kernel, transposed: the same codes and scales bit for bit."""
    w = w.detach().float()
    s = torch.clamp_min(_div127(w.abs().amax(dim=1)), 1e-8)
    q = torch.clamp(torch.round(w / s[:, None]), -127, 127).to(torch.int8)
    return q.contiguous(), s.contiguous()


def quantize_layer_params(params: dict) -> dict:
    """An encoder layer's parameters (layer_params) -> the int8 kernel's
    format: int8 weight codes, their fp32 scales under SCALE_KEYS, fp32
    vectors, all contiguous and detached."""
    out = {}
    for k, v in params.items():
        if k in WEIGHT_KEYS:
            out[k], out[k.replace("_weight", "_scale")] = quantize_weight(v)
        else:
            out[k] = v.detach().float().contiguous()
    return out


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


def quant_rows(h: torch.Tensor) -> tuple:
    """Dynamic per-row symmetric int8 of fp32 h (..., K): (int8 codes, fp32
    row scales (..., 1)); round half to even, as jnp.round and the kernel's
    rintf do."""
    s = torch.clamp_min(_div127(h.abs().amax(dim=-1, keepdim=True)), 1e-8)
    q = torch.clamp(torch.round(h / s), -127, 127).to(torch.int8)
    return q, s


def int8_dot(h: torch.Tensor, wq: torch.Tensor, ws: torch.Tensor, b: torch.Tensor
             ) -> torch.Tensor:
    """fp32 h (..., K) times int8 (N, K) codes: row codes, an exact integer
    product (in fp64, exact for any K this layer takes: |sum| < 2^53), its
    fp32 value, then * row scale * column scale + bias in that order."""
    q, s = quant_rows(h.float())
    acc = q.double() @ wq.double().t()
    return acc.float() * s * ws.float() + b.float()


def _attention(qkv: torch.Tensor, num_heads: int,
               key_padding_mask: Optional[torch.Tensor]) -> torch.Tensor:
    """Per-head masked softmax attention over fp32 (B, S, 3D) qkv with the
    Pallas bodies' roundings: bf16(q * scale) bf16(k)^T in fp32, fp32
    softmax, bf16(p) bf16(v) summed in fp32; (B, S, D) fp32."""
    B, S, D3 = qkv.shape
    D = D3 // 3
    dh = D // num_heads
    q, k, v = qkv.split(D, dim=-1)

    def heads(t):
        return t.to(_BF16).float().reshape(B, S, num_heads, dh).transpose(1, 2)

    scores = heads(q * (1.0 / math.sqrt(dh))) @ heads(k).transpose(-1, -2)
    mask = additive_key_mask(key_padding_mask, B, S, qkv.device)
    if mask is not None:
        scores = scores + mask[:, None, None, :]
    m = scores.amax(dim=-1, keepdim=True)
    e = torch.exp(scores - m)
    probs = e / e.sum(dim=-1, keepdim=True)
    return (probs.to(_BF16).float() @ heads(v)).transpose(1, 2).reshape(B, S, D)


def fused_encoder_layer_reference(x: torch.Tensor, p: dict, num_heads: int,
                                  key_padding_mask: Optional[torch.Tensor] = None
                                  ) -> torch.Tensor:
    """Plain PyTorch twin of the kernel: the same math in the same bf16/fp32
    places, on any device. x (B, S, D); p from pack_layer_params."""
    xb = x.to(_BF16)
    qkv = _bf16_dot(xb, p["in_proj_weight"], p["in_proj_bias"])  # (B, S, 3D)
    attn = _attention(qkv, num_heads, key_padding_mask)
    h1 = _layernorm(xb.float() + _bf16_dot(attn, p["out_proj_weight"],
                                           p["out_proj_bias"]),
                    p["norm1_weight"], p["norm1_bias"])
    ff = gelu_tanh(_bf16_dot(h1, p["linear1_weight"], p["linear1_bias"]))
    ff = _bf16_dot(ff, p["linear2_weight"], p["linear2_bias"])
    h2 = _layernorm(h1 + ff, p["norm2_weight"], p["norm2_bias"])
    return h2.to(x.dtype)


def int8_qkv_reference(x: torch.Tensor, p: dict, num_heads: int) -> torch.Tensor:
    """The q, k and v planes the int8 kernel hands its attention launch, as
    the twin rounds them before its score product: (3, B*S, D) bf16, q taken
    times 1/sqrt(dh) in fp32 first."""
    B, S, D = x.shape
    qkv = int8_dot(x.to(_BF16).float(), p["in_proj_weight"], p["in_proj_scale"],
                   p["in_proj_bias"]).reshape(B * S, 3, D)
    q = qkv[:, 0] * (1.0 / math.sqrt(D // num_heads))
    return torch.stack([q, qkv[:, 1], qkv[:, 2]]).to(_BF16)


def fused_encoder_layer_int8_reference(x: torch.Tensor, p: dict, num_heads: int,
                                       key_padding_mask: Optional[torch.Tensor] = None
                                       ) -> torch.Tensor:
    """Plain PyTorch twin of the int8 kernel (the Pallas _layer_kernel_int8's
    rounding points), on any device. x (B, S, D); p from
    quantize_layer_params."""
    def dot(h, name):
        return int8_dot(h, p[f"{name}_weight"], p[f"{name}_scale"], p[f"{name}_bias"])

    xf = x.to(_BF16).float()
    attn = _attention(dot(xf, "in_proj"), num_heads, key_padding_mask)
    h1 = _layernorm(xf + dot(attn, "out_proj"), p["norm1_weight"], p["norm1_bias"])
    ff = dot(gelu_tanh(dot(h1, "linear1")), "linear2")
    h2 = _layernorm(h1 + ff, p["norm2_weight"], p["norm2_bias"])
    return h2.to(x.dtype)


MAX_D, MAX_HEAD_WIDTH = 1024, 128  # the widest rows and heads the CUDA kernels take
_MAX_CLUSTER = 8  # blocks of a LayerNorm cluster (csrc/wgmma_gemm.cuh)


def _cdiv(a: int, b: int) -> int:
    return -(-a // b)


def _plan_for(M: int, N: int, owns_rows: bool, sms: int, narrow: bool = False) -> dict:
    """csrc/wgmma_gemm.cuh's plan_for: 128 x 128 tiles where they fill the
    card's `sms` SMs (narrow, the int8 launches but LN2: 128 x 64), else
    64-row tiles and 64-column slices (128 for a LayerNorm row wider than 8 x
    64); a LayerNorm launch is a cluster of its column tiles."""
    big = _cdiv(M, 128) * _cdiv(N, 128) >= sms
    bn = 128 if (big and not narrow) or (owns_rows and _cdiv(N, 64) > _MAX_CLUSTER) else 64
    bm = 128 if big else 64
    return dict(bm=bm, bn=bn, gx=_cdiv(M, bm), gy=_cdiv(N, bn),
                cluster=_cdiv(N, bn) if owns_rows else 1, split=1)


def layer_plan(B: int, S: int, D: int, F: int, sms: int) -> list:
    """Kernel 1's four GEMM launches (qkv, out-projection + LN1, FFN-up,
    FFN-down + LN2) as fused_encoder_layer_plan plans them on a card of
    `sms` SMs: each a dict of its tile (bm, bn), grid (gx, gy) and
    cluster."""
    return [_plan_for(B * S, N, owns_rows, sms)
            for N, owns_rows in ((3 * D, False), (D, True), (F, False), (D, True))]


def int8_layer_plan(B: int, S: int, D: int, F: int, sms: int) -> list:
    """The int8 layer's four GEMM launches (qkv, out-projection + LN1,
    FFN-up, FFN-down + LN2) as fused_encoder_layer_int8_plan plans them on a
    card of `sms` SMs: kernel 1's tiles, but 128 x 64 where kernel 1's are
    128 x 128, LN2's excepted. Each a dict of its tile (bm, bn), grid (gx,
    gy), cluster, threads per block and dynamic shared bytes (the ring of 3
    or 4 stages of BM + BN rows of 128 bytes, its barriers, a LayerNorm
    cluster's two [8][BM] fp32 slot arrays, and 1 KB to align the ring)."""
    plans = []
    for N, owns_rows, narrow in ((3 * D, False, True), (D, True, True), (F, False, True),
                                 (D, True, False)):
        pl = _plan_for(B * S, N, owns_rows, sms, narrow)
        stages, slots = (3 if pl["bm"] == 128 else 4), (2 if owns_rows else 0)
        plans.append(dict(bm=pl["bm"], bn=pl["bn"], gx=pl["gx"], gy=pl["gy"],
                          cluster=pl["cluster"], threads=pl["bm"] // 64 * 128 + 32,
                          smem=1024 + stages * (pl["bm"] + pl["bn"]) * 128 + 16 * stages
                          + 4 * slots * _MAX_CLUSTER * pl["bm"]))
    return plans


def _check_cuda_inputs(x, p, num_heads, int8: bool = False):
    """Refuse what the CUDA launchers do not take: D a multiple of 64 up to
    MAX_D, a head width D / H that is a multiple of 16 up to MAX_HEAD_WIDTH,
    F a multiple of 64; any S >= 1. num_heads None skips the head check (a
    half of a layer without attention). int8: the int8 kernel's parameters
    (quantize_layer_params) instead of bf16 weights."""
    B, S, D = x.shape
    F = p["linear1_weight"].shape[0]
    shapes = {"in_proj_weight": (3 * D, D), "out_proj_weight": (D, D),
              "linear1_weight": (F, D), "linear2_weight": (D, F),
              "in_proj_bias": (3 * D,), "out_proj_bias": (D,),
              "linear1_bias": (F,), "linear2_bias": (D,),
              "norm1_weight": (D,), "norm1_bias": (D,),
              "norm2_weight": (D,), "norm2_bias": (D,)}
    if int8:
        shapes.update({"in_proj_scale": (3 * D,), "out_proj_scale": (D,),
                       "linear1_scale": (F,), "linear2_scale": (D,)})
    for key, shape in shapes.items():
        t = p[key]
        want = (torch.int8 if int8 else _BF16) if key in WEIGHT_KEYS else torch.float32
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


def fused_encoder_layer_int8(x: torch.Tensor, p: dict, num_heads: int,
                             key_padding_mask: Optional[torch.Tensor] = None,
                             return_qkv: bool = False):
    """Run one int8 encoder layer. x (B, S, D) bf16 or fp32; p from
    quantize_layer_params; key_padding_mask (B, S) with True = valid key.
    CUDA tensors launch the kernel; CPU tensors run the twin. Refuses inputs
    that require grad while grad is enabled (refuse_grad). return_qkv (a
    check's, not the model's): also return the q, k and v planes the
    attention read, (3, B*S, D) bf16 (int8_qkv_reference's on the CPU)."""
    refuse_grad(x, *p.values())
    if x.device.type == "cpu":
        out = fused_encoder_layer_int8_reference(x, p, num_heads, key_padding_mask)
        return (out, int8_qkv_reference(x, p, num_heads)) if return_qkv else out
    if x.device.type != "cuda":
        raise ValueError(f"fused_encoder_layer_int8 runs on cuda or cpu, not {x.device}")
    from motionstyle_torch import _build

    B, S, D, F = _check_cuda_inputs(x, p, num_heads, int8=True)
    lib = _build.load("fused_encoder_int8")
    M, dev = B * S, x.device
    xb = x.to(_BF16).contiguous()
    kmask = additive_key_mask(key_padding_mask, B, S, dev)
    codes = torch.empty((M, max(D, F)), dtype=torch.int8, device=dev)  # each GEMM's row codes
    scales = torch.empty((M,), dtype=torch.float32, device=dev)
    qkv = torch.empty((3, M, D), dtype=_BF16, device=dev)
    attn = torch.empty((M, D), dtype=torch.float32, device=dev)
    h1 = torch.empty((M, D), dtype=torch.float32, device=dev)
    h1_codes = torch.empty((M, D), dtype=torch.int8, device=dev)
    h1_scales = torch.empty((M,), dtype=torch.float32, device=dev)
    ff = torch.empty((M, F), dtype=torch.float32, device=dev)
    out = torch.empty((B, S, D), dtype=x.dtype, device=dev)
    ptr = lambda t: None if t is None else t.data_ptr()  # noqa: E731
    rc = lib.fused_encoder_layer_int8_forward(
        ptr(xb), ptr(kmask),
        *(ptr(p[f"{n}_{k}"]) for n in ("in_proj", "out_proj") for k in ("weight", "scale", "bias")),
        ptr(p["norm1_weight"]), ptr(p["norm1_bias"]),
        *(ptr(p[f"{n}_{k}"]) for n in ("linear1", "linear2") for k in ("weight", "scale", "bias")),
        ptr(p["norm2_weight"]), ptr(p["norm2_bias"]),
        ptr(codes), ptr(scales), ptr(qkv[0]), ptr(qkv[1]), ptr(qkv[2]), ptr(attn),
        ptr(h1), ptr(h1_codes), ptr(h1_scales), ptr(ff),
        ptr(out) if out.dtype == _BF16 else None,
        ptr(out) if out.dtype == torch.float32 else None,
        B, S, D, num_heads, F,
        torch.cuda.current_stream(dev).cuda_stream)
    if rc != 0:
        raise RuntimeError(f"fused_encoder_layer_int8 kernel failed: CUDA error {rc}")
    fused_encoder_layer_int8.launches += 1
    return (out, qkv) if return_qkv else out


fused_encoder_layer_int8.launches = 0


# the custom operators' flat list of a layer's fp32 parameters, in this order
LAYER_KEYS = WEIGHT_KEYS + VECTOR_KEYS


def packed_params(params: list, int8: bool) -> dict:
    """A layer's fp32 parameters (LAYER_KEYS order) in kernel 1's format (pack)
    or, with int8, kernel 2's (quantize_layer_params), converted once for
    each set of tensor versions. The copies hang on the in-projection weight
    (attribute _kernel_formats), so they live as long as the parameters they
    were made from."""
    refuse_dtensor(*params)
    versions = tuple((t.data_ptr(), t._version) for t in params)
    formats = getattr(params[0], "_kernel_formats", {})
    hit = formats.get(int8)
    if hit is None or hit[0] != versions:
        convert = quantize_layer_params if int8 else pack
        hit = (versions, convert(dict(zip(LAYER_KEYS, params))))
        params[0]._kernel_formats = {**formats, int8: hit}
    return hit[1]


@torch.library.custom_op("motionstyle::fused_encoder_layer", mutates_args=())
def _layer_op(x: torch.Tensor, params: list[torch.Tensor], num_heads: int,
              key_padding_mask: Optional[torch.Tensor]) -> torch.Tensor:
    return fused_encoder_layer(x, packed_params(params, False), num_heads, key_padding_mask)


@torch.library.custom_op("motionstyle::fused_encoder_layer_int8", mutates_args=())
def _layer_int8_op(x: torch.Tensor, params: list[torch.Tensor], num_heads: int,
                   key_padding_mask: Optional[torch.Tensor]) -> torch.Tensor:
    return fused_encoder_layer_int8(x, packed_params(params, True), num_heads,
                                    key_padding_mask)


@_layer_op.register_fake
@_layer_int8_op.register_fake
def _layer_fake(x, params, num_heads, key_padding_mask):
    return x.new_empty(x.shape)


def traced_fused_encoder(x: torch.Tensor, layers: list, num_heads: int,
                         key_padding_mask: Optional[torch.Tensor] = None,
                         int8: bool = False) -> torch.Tensor:
    """fused_encoder for a traced model: each layer's own parameters
    (layer_params) go to kernel 1's (int8: kernel 2's) custom operator,
    which a traced program keeps as one node a layer."""
    op = (torch.ops.motionstyle.fused_encoder_layer_int8 if int8
          else torch.ops.motionstyle.fused_encoder_layer)
    for p in layers:
        x = op(x, [p[k] for k in LAYER_KEYS], num_heads, key_padding_mask)
    return x


def fused_encoder(x: torch.Tensor, layers: list, num_heads: int,
                  key_padding_mask: Optional[torch.Tensor] = None,
                  int8: bool = False) -> torch.Tensor:
    """Stack of fused layers over packed per-layer parameter dicts
    (pack_layer_params, or quantize_layer_params with int8)."""
    layer = fused_encoder_layer_int8 if int8 else fused_encoder_layer
    for p in layers:
        x = layer(x, p, num_heads, key_padding_mask)
    return x
