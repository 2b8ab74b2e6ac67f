"""The fused encoder layer's training path: CUDA kernels for Hopper, their
plain PyTorch twins, and the autograd Function that joins them.

Replaces the Pallas TPU kernels of motionstyle/ops/fused_encoder_train.py:

  fused_layer_train_forward          <- _fwd_kernel             (pallas_call at :602)
  fused_layer_train_bwd_ffn          <- _bwd_ffn_kernel         (:644)
  fused_layer_train_bwd_attn         <- _bwd_attn_kernel        (:688)
  fused_layer_train_forward_store    <- _fwd_store_kernel       (:439)
  fused_layer_train_bwd_attn_stored  <- _bwd_attn_stored_kernel (:482)

and, inside all five, the in-kernel dropout of _drop_site in "prng" mode
(:118-133, with _unpack_drop :136; kernel 10), joined into one differentiable layer as the JAX package's custom VJPs
(`_fused_layer_train`, :732-759, and `_fused_layer_train_store`, :499-539)
join them: forward, FFN half, attention half; with store_probs the forward
also keeps the bf16 softmax probabilities (B, H, S, S) and qkv (B, S, 3D, q
unscaled), and the attention half reads them instead of recomputing qkv, the
scores and the softmax (its gradients differ from the recompute path's at
bf16 epsilon: p enters the softmax VJP rounded). The forward applies the
layer's three dropout sites (after the out-projection, after gelu, after
linear2; none on the attention probabilities), and keeps two residuals for the backward: `a1`, the
pre-LN1 sum (fp32), and `attn`, the attention output (bf16). The backward
recomputes the rest. Rounding points are the Pallas bodies' (see the source
csrc/fused_encoder_train.cu), gelu is the tanh approximation with the
gradient of `_gelu_tanh_grad`, and the weight gradients are summed in fp32.

Dropout comes in two modes, as in the JAX package (:797-800: one or the
other, never both):
  masks: bf16 masks holding {0, 1/keep} drawn outside the kernels from an
    explicit torch.Generator (make_dropout_masks, :766-776), read by the
    forward and both backward halves;
  prng: a (B,) int32 seed per clip for the layer and the rate. Every site
    regenerates its keep bits inside the kernels with counter-based
    Philox4x32-10: key (uint32(seed[b]), site), counter (s, col >> 2, 0, 0),
    word col & 3 (dropout_bits), so the bit depends only on the element's
    index and the forward and both backward halves see one mask with no mask
    in device memory. An element is kept where bits < min(int(keep * 2^32),
    2^32 - 1) and scaled by fp32(1/keep) (:127-133), where the masks mode
    multiplies by bf16(1/keep). The twins compute the same Philox in int64
    PyTorch arithmetic. The TPU's hardware bits are not Philox, so the two
    packages agree in statistics, not bit for bit.

Each wrapper launches its kernel for CUDA tensors (or raises) and runs its
twin only for CPU tensors; `<wrapper>.launches` counts kernel launches and
`<wrapper>.prng_launches` those in prng mode; make_dropout_masks.calls counts
mask draws.
"""
from __future__ import annotations

import math
from typing import Optional, Sequence

import torch

from motionstyle_torch.ops.fused_encoder import (
    _bf16_dot, _cdiv, _check_cuda_inputs as _check_layer, _layernorm, _plan_for,
    additive_key_mask, gelu_tanh, pack)
from motionstyle_torch.parallel.mesh import draw_rows, refuse_dtensor

_BF16 = torch.bfloat16
_EPS = 1e-5
_C = 0.7978845608028654  # sqrt(2/pi)
_A = 0.044715

# a layer's parameters in the order FusedLayerTrain takes them
PARAM_KEYS = ("in_proj_weight", "in_proj_bias", "out_proj_weight", "out_proj_bias",
              "norm1_weight", "norm1_bias", "linear1_weight", "linear1_bias",
              "linear2_weight", "linear2_bias", "norm2_weight", "norm2_bias")


def make_dropout_masks(generator: torch.Generator, shape, rate: float,
                       dim_feedforward: int, dtype: torch.dtype = _BF16) -> tuple:
    """Scaled keep-masks {0, 1/keep} for one layer's three dropout sites:
    (B, S, D) after the out-projection, (B, S, F) after gelu, (B, S, D) after
    linear2, drawn on the generator's device. bf16, as the JAX package's
    (1/keep is rounded to bf16 there too); other dtypes for the plain layer."""
    make_dropout_masks.calls += 1
    B, S, D = shape
    keep = 1.0 - rate
    scale = torch.tensor(1.0 / keep, dtype=dtype)

    def mk(d):
        bits = draw_rows(lambda shape: torch.rand(shape, generator=generator,
                                                  device=generator.device), (B, S, d))
        return ((bits < keep).to(dtype) * scale.to(bits.device)).contiguous()

    return mk(D), mk(dim_feedforward), mk(D)


make_dropout_masks.calls = 0

# ---------------------------------------------------------------------------
# prng mode (kernel 10): Philox4x32-10 in int64 PyTorch arithmetic
# ---------------------------------------------------------------------------

_M32 = 0xFFFFFFFF
_PHILOX_M = (0xD2511F53, 0xCD9E8D57)
_PHILOX_W = (0x9E3779B9, 0xBB67AE85)


def _mulhilo(m: int, c: torch.Tensor) -> tuple:
    """(hi, lo) 32-bit halves of m * c for uint32 m and c held in int64: c is
    split into 16-bit halves so that no product passes 2^48."""
    p_lo, p_hi = m * (c & 0xFFFF), m * (c >> 16)
    t = p_lo + ((p_hi & 0xFFFF) << 16)
    return (p_hi >> 16) + (t >> 32), t & _M32


def philox4x32_10(counter, key) -> tuple:
    """Philox4x32-10 (Salmon et al., SC 2011; Random123's constants) of four
    counter words and two key words, each an int64 tensor of uint32 values
    (broadcast together); returns the four output words likewise."""
    c0, c1, c2, c3 = (torch.as_tensor(c, dtype=torch.int64) for c in counter)
    k0, k1 = (torch.as_tensor(k, dtype=torch.int64) for k in key)
    for r in range(10):
        if r:
            k0, k1 = (k0 + _PHILOX_W[0]) & _M32, (k1 + _PHILOX_W[1]) & _M32
        hi0, lo0 = _mulhilo(_PHILOX_M[0], c0)
        hi1, lo1 = _mulhilo(_PHILOX_M[1], c2)
        c0, c1, c2, c3 = hi1 ^ c1 ^ k0, lo1, hi0 ^ c3 ^ k1, lo0
    return c0, c1, c2, c3


def dropout_bits(seeds: torch.Tensor, site: int, S: int, N: int) -> torch.Tensor:
    """The prng mode's 32 random bits of every element of one site, (B, S, N)
    int64: word col & 3 of Philox4x32-10 at counter (s, col >> 2, 0, 0) and
    key (uint32(seeds[b]), site), as csrc/fused_encoder_train.cu's Dropout."""
    dev = seeds.device
    n4 = -(-N // 4)
    zero = torch.zeros((1, 1, 1), dtype=torch.int64, device=dev)
    words = philox4x32_10(
        (torch.arange(S, dtype=torch.int64, device=dev).view(1, S, 1),
         torch.arange(n4, dtype=torch.int64, device=dev).view(1, 1, n4), zero, zero),
        ((seeds.to(torch.int64) & _M32).view(-1, 1, 1), torch.tensor(site, device=dev)))
    words = torch.broadcast_tensors(*words)
    return torch.stack(words, -1).reshape(len(seeds), S, 4 * n4)[..., :N]


def prng_threshold(rate: float) -> tuple:
    """(threshold, scale) of the prng mode at `rate` (_drop_site, :127-133):
    keep where bits < min(int(keep * 2^32), 2^32 - 1), the clamp that keeps
    keep = 1 from wrapping to 0; kept values times fp32(1/keep)."""
    keep = 1.0 - rate
    return min(int(keep * 4294967296.0), _M32), 1.0 / keep


def draw_dropout_seeds(generator: torch.Generator, num_layers: int, batch: int) -> torch.Tensor:
    """(num_layers, batch) int32 seeds over the full 32-bit range on the
    generator's device, as the JAX stack's jax.random.bits(...).astype(int32)
    (:839-846)."""
    return draw_rows(lambda shape: torch.randint(-2 ** 31, 2 ** 31, shape, generator=generator,
                                                 device=generator.device, dtype=torch.int64),
                     (num_layers, batch), dim=1).to(torch.int32)


def _check_dropout(masks, seeds, rate: float):
    """The JAX contract (:797-800): masks or seeds, not both; seeds need a
    rate in (0, 1)."""
    if masks is not None and seeds is not None:
        raise ValueError("pass external masks or in-kernel prng seeds, not both")
    if seeds is not None and not 0.0 < rate < 1.0:
        raise ValueError(f"seeds given with rate {rate}: prng dropout needs a rate in (0, 1)")


class _Drop:
    """The three dropout sites of one layer call in the twins: external
    masks, the prng mode's regenerated keep bits, or none (rate 0). A site is
    applied to (B, S, N) or (B*S, N) values."""

    def __init__(self, masks, seeds, rate: float, S: int):
        _check_dropout(masks, seeds, rate)
        self.masks, self.seeds, self.S = masks, seeds, S
        if seeds is not None:
            self.thresh, scale = prng_threshold(rate)
            self.scale = torch.tensor(scale, dtype=torch.float32, device=seeds.device)
        self._keep = {}

    def __call__(self, site: int, t: torch.Tensor) -> torch.Tensor:
        if self.masks is not None:
            return t * self.masks[site].reshape(t.shape).float()
        if self.seeds is None:
            return t
        if site not in self._keep:
            self._keep[site] = dropout_bits(self.seeds, site, self.S, t.shape[-1]) < self.thresh
        return torch.where(self._keep[site].reshape(t.shape), t * self.scale, 0.0)


# ---------------------------------------------------------------------------
# plain twins: the kernels' arithmetic in PyTorch, with the same roundings
# ---------------------------------------------------------------------------

def _bf(t: torch.Tensor) -> torch.Tensor:
    return t.to(_BF16).float()


def _ln_stats(a: torch.Tensor):
    mu = a.mean(-1, keepdim=True)
    var = ((a - mu) ** 2).mean(-1, keepdim=True)
    rstd = torch.rsqrt(var + _EPS)
    return (a - mu) * rstd, rstd


def _ln_bwd(dh, xhat, rstd, scale):
    """Per-row LayerNorm backward over (M, D) rows -> (dx, dscale, dbias)."""
    dxh = dh * scale.float()
    m1 = dxh.mean(-1, keepdim=True)
    m2 = (dxh * xhat).mean(-1, keepdim=True)
    return rstd * (dxh - m1 - xhat * m2), (dh * xhat).sum(0), dh.sum(0)


def _heads(t: torch.Tensor, B: int, S: int, H: int) -> torch.Tensor:
    return t.reshape(B, S, H, -1).transpose(1, 2)


def _probs(q, k, kmask, B, S, H):
    """Per-head softmax(bf16(q*scale) bf16(k)^T + mask), fp32 (B, H, S, S)."""
    dh = q.shape[-1] // H
    scores = _heads(_bf(q * (1.0 / math.sqrt(dh))), B, S, H) @ _heads(_bf(k), B, S, H).transpose(-1, -2)
    if kmask is not None:
        scores = scores + kmask[:, None, None, :]
    e = torch.exp(scores - scores.amax(-1, keepdim=True))
    return e / e.sum(-1, keepdim=True)


def _forward_reference(x, p, num_heads, kmask, drop, out_dtype):
    """The forward's arithmetic with the dropout sites `drop` (_Drop);
    returns (out, a1 fp32, attn bf16, probs fp32 (B, H, S, S), qkv fp32
    (B, S, 3D) with q unscaled)."""
    B, S, D = x.shape
    xb = x.to(_BF16)
    qkv = _bf16_dot(xb, p["in_proj_weight"], p["in_proj_bias"])
    q, k, v = qkv.split(D, dim=-1)
    probs = _probs(q, k, kmask, B, S, num_heads)
    attn = (_bf(probs) @ _heads(_bf(v), B, S, num_heads)).transpose(1, 2).reshape(B, S, D)
    proj = drop(0, _bf16_dot(attn, p["out_proj_weight"], p["out_proj_bias"]))
    a1 = xb.float() + proj
    h1 = _layernorm(a1, p["norm1_weight"], p["norm1_bias"])
    g = drop(1, gelu_tanh(_bf16_dot(h1, p["linear1_weight"], p["linear1_bias"])))
    f = drop(2, _bf16_dot(g, p["linear2_weight"], p["linear2_bias"]))
    out = _layernorm(h1 + f, p["norm2_weight"], p["norm2_bias"])
    return out.to(out_dtype or x.dtype), a1, attn.to(_BF16), probs, qkv


def fused_layer_train_forward_reference(x, p, num_heads, kmask=None, masks=None,
                                        out_dtype=None, seeds=None, rate=0.0):
    """Twin of the forward kernel. x (B, S, D); p packed; kmask (B, S)
    additive fp32 or None; masks (m0, m1, m2) or None; or seeds (B,) int32
    with rate for the prng mode. Returns (out, a1 fp32, attn bf16)."""
    drop = _Drop(masks, seeds, rate, x.shape[1])
    return _forward_reference(x, p, num_heads, kmask, drop, out_dtype)[:3]


def fused_layer_train_forward_store_reference(x, p, num_heads, kmask=None, masks=None,
                                              out_dtype=None, seeds=None, rate=0.0):
    """Twin of the store-probs forward kernel: the forward twin's (out, a1,
    attn), bit-equal to it, plus probs (B, H, S, S) bf16, the probabilities
    exactly as p @ V used them, and qkv (B, S, 3D) bf16 with q unscaled."""
    drop = _Drop(masks, seeds, rate, x.shape[1])
    out, a1, attn, probs, qkv = _forward_reference(x, p, num_heads, kmask, drop, out_dtype)
    return out, a1, attn, probs.to(_BF16), qkv.to(_BF16)


def bwd_ffn_reference(dh2, a1, p, masks=None, seeds=None, rate=0.0):
    """Twin of the FFN-half backward kernel: recompute from a1, then LN2^T,
    linear2^T, gelu^T, linear1^T, LN1^T. Returns (da1 (B, S, D) fp32, grads)
    with grads fp32 by parameter name (linear weights in (out, in) layout)."""
    B, S, D = a1.shape
    drop = _Drop(masks, seeds, rate, S)
    flat = lambda t: t.reshape(B * S, -1)  # noqa: E731
    a1 = flat(a1).float()
    xhat1, rstd1 = _ln_stats(a1)
    h1 = xhat1 * p["norm1_weight"] + p["norm1_bias"]
    u = _bf16_dot(h1, p["linear1_weight"], p["linear1_bias"])
    t = torch.tanh(_C * (u + _A * u ** 3))
    gd = drop(1, 0.5 * u * (1.0 + t))
    f = _bf16_dot(gd, p["linear2_weight"], p["linear2_bias"])
    xhat2, rstd2 = _ln_stats(h1 + drop(2, f))
    da2, dls2, dlb2 = _ln_bwd(flat(dh2).float(), xhat2, rstd2, p["norm2_weight"])
    df = drop(2, da2)
    dw2 = _bf(df).t() @ _bf(gd)
    dgd = _bf(df) @ _bf(p["linear2_weight"])
    du = drop(1, dgd) * (0.5 * (1.0 + t) + 0.5 * u * (1.0 - t * t) * _C * (1.0 + 3.0 * _A * u * u))
    dw1 = _bf(du).t() @ _bf(h1)
    dh1 = da2 + _bf(du) @ _bf(p["linear1_weight"])
    da1, dls1, dlb1 = _ln_bwd(dh1, xhat1, rstd1, p["norm1_weight"])
    grads = {"linear1_weight": dw1, "linear1_bias": du.sum(0),
             "linear2_weight": dw2, "linear2_bias": df.sum(0),
             "norm1_weight": dls1, "norm1_bias": dlb1,
             "norm2_weight": dls2, "norm2_bias": dlb2}
    return da1.reshape(B, S, D), grads


def _bwd_attn_half(da1, xb, attn, p, H, probs, q, k, v, drop):
    """out-projection^T, the softmax VJP from fp32 probs (B, H, S, S) and
    q (unscaled), k, v (B*S, D), then dWqkv and dx. xb (B*S, D) bf16."""
    B, _, S, _ = probs.shape
    D = xb.shape[-1]
    scale = 1.0 / math.sqrt(D // H)
    da1 = da1.reshape(B * S, D).float()
    dproj = drop(0, da1)
    dwo = _bf(dproj).t() @ _bf(attn.reshape(B * S, D))
    dattn = _bf(dproj) @ _bf(p["out_proj_weight"])
    da = _heads(_bf(dattn), B, S, H)
    dv = _bf(probs).transpose(-1, -2) @ da
    dp = da @ _heads(_bf(v), B, S, H).transpose(-1, -2)
    ds = probs * (dp - (dp * probs).sum(-1, keepdim=True))
    dq = (_bf(ds) @ _heads(_bf(k), B, S, H)) * scale
    dk = (_bf(ds).transpose(-1, -2) @ _heads(_bf(q), B, S, H)) * scale
    merge = lambda t: t.transpose(1, 2).reshape(B * S, D)  # noqa: E731
    dqkv = torch.cat([merge(dq), merge(dk), merge(dv)], dim=-1)
    dx = da1 + _bf(dqkv) @ _bf(p["in_proj_weight"])
    grads = {"in_proj_weight": _bf(dqkv).t() @ _bf(xb), "in_proj_bias": dqkv.sum(0),
             "out_proj_weight": dwo, "out_proj_bias": dproj.sum(0)}
    return dx.reshape(B, S, D), grads


def bwd_attn_reference(da1, x, attn, p, num_heads, kmask=None, masks=None, seeds=None,
                       rate=0.0):
    """Twin of the attention-half backward kernel: out-projection^T, qkv and
    softmax recompute, softmax VJP. x is the layer input (rounded to bf16).
    Returns (dx (B, S, D) fp32, grads fp32 by parameter name)."""
    B, S, D = x.shape
    xb = x.reshape(B * S, D).to(_BF16)
    qkv = _bf16_dot(xb, p["in_proj_weight"], p["in_proj_bias"])
    q, k, v = qkv.split(D, dim=-1)
    probs = _probs(q, k, kmask, B, S, num_heads)  # fp32, as the Pallas body keeps it
    return _bwd_attn_half(da1, xb, attn, p, num_heads, probs, q, k, v,
                          _Drop(masks, seeds, rate, S))


def bwd_attn_stored_reference(da1, x, attn, probs, qkv, p, num_heads, masks=None,
                              seeds=None, rate=0.0):
    """Twin of the stored attention-half backward kernel: the same VJP from
    the store forward's bf16 probs (B, H, S, S) and qkv (B, S, 3D, q
    unscaled) instead of a recompute (_bwd_attn_stored_kernel, :364-406)."""
    B, S, D = x.shape
    q, k, v = qkv.reshape(B * S, 3 * D).float().split(D, dim=-1)
    return _bwd_attn_half(da1, x.reshape(B * S, D).to(_BF16), attn, p, num_heads,
                          probs.float(), q, k, v, _Drop(masks, seeds, rate, S))


# ---------------------------------------------------------------------------
# the backward's GEMM plan (csrc/wgmma_gemm.cuh's plan_for and plan_wgrad) and
# the partial buffers it needs
# ---------------------------------------------------------------------------

_BK, _MAX_SPLIT, _MIN_SLICE_STEPS = 64, 8, 4

# the backward's GEMM launches in fused_layer_train_backward_plan's order:
# kernel 6's, then kernel 7's (kernel 9's are the same without the qkv)
BACKWARD_GEMMS = ("up_bwd_gemm", "ln2_bwd_gemm", "du_bwd_gemm", "ln1_bwd_gemm", "dw2_gemm",
                  "dw1_gemm", "dattn_bwd_gemm", "qkv_store_train_gemm", "dwqkv_gemm", "dwo_gemm",
                  "dx_bwd_gemm")


def _plan_wgrad(P: int, Q: int, K: int, sms: int) -> dict:
    """plan_wgrad of the weight gradient X^T Y, (P, Q) over K rows: 128 x 128
    tiles where they and their slices can fill the card (64 x 64 for a side
    under 128 or a short K) and as many slices of K as bring the blocks to
    about one per SM, at most 8, each at least 4 k steps of 64 rows, none
    empty."""
    nk = _cdiv(K, _BK)
    big = (P >= 128 and Q >= 128
           and _cdiv(P, 128) * _cdiv(Q, 128) * _cdiv(nk, _MIN_SLICE_STEPS) >= sms)
    t = 128 if big else 64
    tiles = _cdiv(P, t) * _cdiv(Q, t)
    split = max(1, min(_MAX_SPLIT, sms // tiles, _cdiv(nk, _MIN_SLICE_STEPS)))
    return dict(bm=t, bn=t, gx=_cdiv(P, t), gy=_cdiv(Q, t), cluster=1,
                split=_cdiv(nk, _cdiv(nk, split)))


def backward_plan(B: int, S: int, D: int, F: int, sms: int) -> list:
    """The backward's GEMM launches (BACKWARD_GEMMS) as
    fused_layer_train_backward_plan plans them on a card of `sms` SMs: each
    a dict of its tile (bm, bn), grid (gx, gy), cluster and slices of K."""
    M = B * S
    return [_plan_for(M, F, False, sms), _plan_for(M, D, True, sms), _plan_for(M, F, False, sms),
            _plan_for(M, D, True, sms), _plan_wgrad(D, F, M, sms), _plan_wgrad(F, D, M, sms),
            _plan_for(M, D, False, sms), _plan_for(M, 3 * D, False, sms),
            _plan_wgrad(3 * D, D, M, sms), _plan_wgrad(D, D, M, sms), _plan_for(M, D, False, sms)]


def backward_partial_floats(B: int, S: int, D: int, F: int, sms: int) -> tuple:
    """fp32 elements of the partial buffers the backward launchers fill
    (csrc/fused_encoder_train.cu): the FFN half's column sums, R = ceil(M /
    64) rows (as many as any plan's row tiles) of 5 D + F, then dW2's and
    dW1's slices; the attention half's dWqkv and dWo slices. A weight
    gradient of one slice is written in place and takes none."""
    M = B * S

    def slices(P, Q):
        split = _plan_wgrad(P, Q, M, sms)["split"]
        return split * P * Q if split > 1 else 0

    return (_cdiv(M, 64) * (5 * D + F) + slices(D, F) + slices(F, D),
            slices(3 * D, D) + slices(D, D))


def weight_grad_slices_reference(x: torch.Tensor, y: torch.Tensor, split: int) -> torch.Tensor:
    """x^T y (x (M, P), y (M, Q)) in the kernels' order of sums: the rows
    cut into `split` slices of whole 64-row k steps, each slice an fp32
    product, the slices added in slice order."""
    per = _cdiv(_cdiv(x.shape[0], _BK), split) * _BK
    out = None
    for z in range(split):
        part = x[z * per:(z + 1) * per].float().t() @ y[z * per:(z + 1) * per].float()
        out = part if out is None else out + part
    return out


def _sm_count(device) -> int:
    return torch.cuda.get_device_properties(device).multi_processor_count


# ---------------------------------------------------------------------------
# the kernels' wrappers
# ---------------------------------------------------------------------------

def _check_cuda_inputs(x, p, num_heads, masks=None, seeds=None, rate=0.0):
    """Refuse what the training launchers do not take (the layer's shapes as
    the inference kernel's _check_cuda_inputs states them; masks contiguous
    bf16 of the layer's shapes; seeds a contiguous int32 (B,) tensor with a
    rate in (0, 1)); num_heads None skips the head check (the FFN half)."""
    B, S, D, F = _check_layer(x, p, num_heads)
    _check_dropout(masks, seeds, rate)
    if seeds is not None and (tuple(seeds.shape) != (B,) or seeds.dtype != torch.int32
                              or seeds.device != x.device or not seeds.is_contiguous()):
        raise ValueError(f"seeds must be a contiguous int32 ({B},) tensor on {x.device}, got "
                         f"{seeds.dtype} {tuple(seeds.shape)} on {seeds.device}")
    if masks is not None:
        for m, d in zip(masks, (D, F, D)):
            if m is None or tuple(m.shape) != (B, S, d) or m.dtype != _BF16 \
                    or m.device != x.device or not m.is_contiguous():
                raise ValueError(f"dropout masks must be contiguous bf16 (B, S, D), "
                                 f"(B, S, F), (B, S, D) on {x.device}")
    return B, S, D, F


def _check_stored(probs, qkv, B, S, D, H, device):
    for name, t, shape in (("probs", probs, (B, H, S, S)), ("qkv", qkv, (B, S, 3 * D))):
        if tuple(t.shape) != shape or t.dtype != _BF16 or t.device != device \
                or not t.is_contiguous():
            raise ValueError(f"{name} must be a contiguous bf16 {shape} tensor on {device}, "
                             f"got {t.dtype} {tuple(t.shape)} on {t.device}")


def _device_guard(x, what: str) -> bool:
    """True for CPU tensors (run the twin); raise for anything but CUDA."""
    if x.device.type == "cpu":
        return True
    if x.device.type != "cuda":
        raise ValueError(f"{what} runs on cuda or cpu, not {x.device}")
    return False


def _ptr(t):
    return None if t is None else t.data_ptr()


def _drop_args(seeds, rate) -> tuple:
    """The launchers' prng arguments: (seeds pointer, keep threshold, 1/keep),
    (None, 0, 0.0) outside the prng mode."""
    if seeds is None:
        return None, 0, 0.0
    return (seeds.data_ptr(),) + prng_threshold(rate)


def _count(wrapper, seeds):
    wrapper.launches += 1
    if seeds is not None:
        wrapper.prng_launches += 1


def _stream(x):
    return torch.cuda.current_stream(x.device).cuda_stream


def _raise_on(rc: int, what: str):
    if rc != 0:
        raise RuntimeError(f"{what} kernel failed: CUDA error {rc}")


def _forward_launch(symbol, x, p, num_heads, kmask, masks, out_dtype, store, seeds, rate):
    """Run kernel 5 (store False) or kernel 8 (store True) on the card;
    returns (out, a1, attn) and, with store, (probs, qkv)."""
    from motionstyle_torch import _build

    B, S, D, F = _check_cuda_inputs(x, p, num_heads, masks, seeds, rate)
    if out_dtype not in (_BF16, torch.float32):
        raise ValueError(f"output must be bfloat16 or float32, got {out_dtype}")
    lib = _build.load("fused_encoder_train")
    M, dev = B * S, x.device
    bf = dict(dtype=_BF16, device=dev)
    xb = x.to(_BF16).contiguous()
    m0, m1, m2 = masks if masks is not None else (None, None, None)
    h1_f32 = torch.empty((M, D), dtype=torch.float32, device=dev)
    h1_bf16, g = torch.empty((M, D), **bf), torch.empty((M, F), **bf)
    out = torch.empty((B, S, D), dtype=out_dtype, device=dev)
    a1 = torch.empty((B, S, D), dtype=torch.float32, device=dev)
    attn = torch.empty((B, S, D), **bf)
    if store:
        q_s = torch.empty((M, D), **bf)
        probs = torch.empty((B, num_heads, S, S), **bf)
        qkv = torch.empty((B, S, 3 * D), **bf)
        scratch = (q_s,)
        stored = (probs, qkv)
    else:
        scratch = tuple(torch.empty((3, M, D), **bf))  # q k v
        stored = ()
    rc = getattr(lib, symbol)(
        _ptr(xb), _ptr(kmask), _ptr(m0), _ptr(m1), _ptr(m2), *_drop_args(seeds, rate),
        *(_ptr(p[k]) for k in PARAM_KEYS),
        *(_ptr(t) for t in scratch), _ptr(h1_f32), _ptr(h1_bf16), _ptr(g),
        _ptr(out) if out_dtype == _BF16 else None,
        _ptr(out) if out_dtype == torch.float32 else None,
        _ptr(a1), _ptr(attn), *(_ptr(t) for t in stored), B, S, D, num_heads, F, _stream(x))
    _raise_on(rc, symbol)
    return (out, a1, attn) + stored


def fused_layer_train_forward(x, p, num_heads, kmask=None, masks=None, out_dtype=None,
                              seeds=None, rate=0.0):
    """Training forward of one layer. x (B, S, D) bf16; p packed; kmask (B, S)
    additive fp32 or None; masks (m0, m1, m2) or None (rate 0), or seeds (B,)
    int32 and rate for the prng mode. Returns (out in out_dtype, a1 fp32,
    attn bf16)."""
    out_dtype = out_dtype or x.dtype
    if _device_guard(x, "fused_layer_train_forward"):
        return fused_layer_train_forward_reference(x, p, num_heads, kmask, masks, out_dtype,
                                                   seeds, rate)
    res = _forward_launch("fused_layer_train_forward", x, p, num_heads, kmask, masks,
                          out_dtype, False, seeds, rate)
    _count(fused_layer_train_forward, seeds)
    return res


fused_layer_train_forward.launches = fused_layer_train_forward.prng_launches = 0


def fused_layer_train_forward_store(x, p, num_heads, kmask=None, masks=None, out_dtype=None,
                                    seeds=None, rate=0.0):
    """Store-probs training forward of one layer: the forward's (out, a1,
    attn), bit-equal to fused_layer_train_forward's, plus probs (B, H, S, S)
    bf16 and qkv (B, S, 3D) bf16 (q unscaled) for the stored backward."""
    out_dtype = out_dtype or x.dtype
    if _device_guard(x, "fused_layer_train_forward_store"):
        return fused_layer_train_forward_store_reference(x, p, num_heads, kmask, masks,
                                                         out_dtype, seeds, rate)
    res = _forward_launch("fused_layer_train_forward_store", x, p, num_heads, kmask, masks,
                          out_dtype, True, seeds, rate)
    _count(fused_layer_train_forward_store, seeds)
    return res


fused_layer_train_forward_store.launches = fused_layer_train_forward_store.prng_launches = 0


def fused_layer_train_bwd_ffn(dh2, a1, p, masks=None, seeds=None, rate=0.0):
    """FFN half of the backward. dh2 (B, S, D); a1 (B, S, D) fp32; the
    forward's masks or seeds and rate. Returns (da1 fp32, grads fp32 by
    parameter name)."""
    if _device_guard(a1, "fused_layer_train_bwd_ffn"):
        return bwd_ffn_reference(dh2, a1, p, masks, seeds, rate)
    from motionstyle_torch import _build

    B, S, D, F = _check_cuda_inputs(a1, p, None, masks, seeds, rate)
    lib = _build.load("fused_encoder_train")
    M, dev = B * S, a1.device
    f32 = dict(dtype=torch.float32, device=dev)
    bf = dict(dtype=_BF16, device=dev)
    dh2 = dh2.float().contiguous()
    a1 = a1.contiguous()
    m1, m2 = (masks[1], masks[2]) if masks is not None else (None, None)
    stats, h1 = torch.empty((M, 2), **f32), torch.empty((M, D), **bf)
    gd, gp = torch.empty((M, F), **bf), torch.empty((M, F), **f32)
    da2, df, du = torch.empty((M, D), **f32), torch.empty((M, D), **bf), torch.empty((M, F), **bf)
    partial = torch.empty((backward_partial_floats(B, S, D, F, _sm_count(dev))[0],), **f32)
    da1 = torch.empty((B, S, D), **f32)
    g = {"linear1_weight": torch.empty((F, D), **f32), "linear1_bias": torch.empty((F,), **f32),
         "linear2_weight": torch.empty((D, F), **f32), "linear2_bias": torch.empty((D,), **f32),
         "norm1_weight": torch.empty((D,), **f32), "norm1_bias": torch.empty((D,), **f32),
         "norm2_weight": torch.empty((D,), **f32), "norm2_bias": torch.empty((D,), **f32)}
    rc = lib.fused_layer_train_bwd_ffn(
        _ptr(dh2), _ptr(a1), _ptr(m1), _ptr(m2), *_drop_args(seeds, rate),
        *(_ptr(p[k]) for k in ("linear1_weight", "linear1_bias", "linear2_weight",
                               "linear2_bias", "norm1_weight", "norm1_bias",
                               "norm2_weight", "norm2_bias")),
        _ptr(stats), _ptr(h1), _ptr(gd), _ptr(gp), _ptr(da2), _ptr(df), _ptr(du),
        _ptr(partial), _ptr(da1),
        *(_ptr(g[k]) for k in ("linear1_weight", "linear1_bias", "linear2_weight",
                               "linear2_bias", "norm1_weight", "norm1_bias",
                               "norm2_weight", "norm2_bias")),
        B, S, D, F, _stream(a1))
    _raise_on(rc, "fused_layer_train_bwd_ffn")
    _count(fused_layer_train_bwd_ffn, seeds)
    return da1, g


fused_layer_train_bwd_ffn.launches = fused_layer_train_bwd_ffn.prng_launches = 0


def _attn_bwd_buffers(B, S, D, H, F, dev) -> tuple:
    """Scratch shared by both attention halves (dproj, dattn, dqkv, the
    partial column sums, the weight gradients' slices and the rows' softmax
    statistics) and their outputs (dx, grads)."""
    f32 = dict(dtype=torch.float32, device=dev)
    M, nb, nt = B * S, -(-B * S // 16), -(-S // 64)
    slices = backward_partial_floats(B, S, D, F, _sm_count(dev))[1]
    scratch = (torch.empty((M, D), dtype=_BF16, device=dev),      # dproj
               torch.empty((M, D), dtype=_BF16, device=dev),      # dattn
               torch.empty((M, 3 * D), dtype=_BF16, device=dev),  # dqkv
               torch.empty((nb, D), **f32), torch.empty((B * nt, 3 * D), **f32),
               torch.empty((max(slices, 1),), **f32),
               torch.empty((B * H * S, 3), **f32))
    dx = torch.empty((B, S, D), **f32)
    g = {"in_proj_weight": torch.empty((3 * D, D), **f32),
         "in_proj_bias": torch.empty((3 * D,), **f32),
         "out_proj_weight": torch.empty((D, D), **f32),
         "out_proj_bias": torch.empty((D,), **f32)}
    return scratch, dx, g


_GRAD_KEYS = ("in_proj_weight", "in_proj_bias", "out_proj_weight", "out_proj_bias")


def fused_layer_train_bwd_attn(da1, x, attn, p, num_heads, kmask=None, masks=None,
                               seeds=None, rate=0.0):
    """Attention half of the backward. da1 (B, S, D) fp32; x the layer input
    (bf16); attn the forward's residual; the forward's masks or seeds and
    rate. Returns (dx fp32, grads fp32)."""
    if _device_guard(x, "fused_layer_train_bwd_attn"):
        return bwd_attn_reference(da1, x, attn, p, num_heads, kmask, masks, seeds, rate)
    from motionstyle_torch import _build

    B, S, D, F = _check_cuda_inputs(x, p, num_heads, masks, seeds, rate)
    lib = _build.load("fused_encoder_train")
    (dproj, dattn, dqkv, part_o, part_qkv, part_w, stats), dx, g = _attn_bwd_buffers(
        B, S, D, num_heads, F, x.device)
    xb = x.to(_BF16).contiguous()
    m0 = masks[0] if masks is not None else None
    # the recompute's q*scale and q, k, v (unscaled, as kernel 8 stores them)
    q_s = torch.empty((B * S, D), dtype=_BF16, device=x.device)
    qkv = torch.empty((B * S, 3 * D), dtype=_BF16, device=x.device)
    rc = lib.fused_layer_train_bwd_attn(
        _ptr(da1.float().contiguous()), _ptr(xb), _ptr(kmask), _ptr(attn.contiguous()),
        _ptr(m0), *_drop_args(seeds, rate), _ptr(p["in_proj_weight"]), _ptr(p["in_proj_bias"]),
        _ptr(p["out_proj_weight"]), _ptr(dproj), _ptr(dattn), _ptr(q_s), _ptr(qkv),
        _ptr(dqkv), _ptr(part_o), _ptr(part_qkv), _ptr(part_w), _ptr(stats), _ptr(dx),
        *(_ptr(g[k]) for k in _GRAD_KEYS), B, S, D, num_heads, _stream(x))
    _raise_on(rc, "fused_layer_train_bwd_attn")
    _count(fused_layer_train_bwd_attn, seeds)
    return dx, g


fused_layer_train_bwd_attn.launches = fused_layer_train_bwd_attn.prng_launches = 0


def fused_layer_train_bwd_attn_stored(da1, x, attn, probs, qkv, p, num_heads, masks=None,
                                      seeds=None, rate=0.0):
    """Attention half of the backward from the store forward's probs
    (B, H, S, S) and qkv (B, S, 3D), with no recompute. Returns (dx fp32,
    grads fp32)."""
    if _device_guard(x, "fused_layer_train_bwd_attn_stored"):
        return bwd_attn_stored_reference(da1, x, attn, probs, qkv, p, num_heads, masks, seeds,
                                         rate)
    from motionstyle_torch import _build

    B, S, D, F = _check_cuda_inputs(x, p, num_heads, masks, seeds, rate)
    _check_stored(probs, qkv, B, S, D, num_heads, x.device)
    lib = _build.load("fused_encoder_train")
    (dproj, dattn, dqkv, part_o, part_qkv, part_w, stats), dx, g = _attn_bwd_buffers(
        B, S, D, num_heads, F, x.device)
    xb = x.to(_BF16).contiguous()
    m0 = masks[0] if masks is not None else None
    rc = lib.fused_layer_train_bwd_attn_stored(
        _ptr(da1.float().contiguous()), _ptr(xb), _ptr(attn.contiguous()), _ptr(m0),
        *_drop_args(seeds, rate), _ptr(probs), _ptr(qkv), _ptr(p["in_proj_weight"]),
        _ptr(p["out_proj_weight"]), _ptr(dproj), _ptr(dattn), _ptr(dqkv), _ptr(part_o),
        _ptr(part_qkv), _ptr(part_w), _ptr(stats), _ptr(dx),
        *(_ptr(g[k]) for k in _GRAD_KEYS), B, S, D, num_heads, _stream(x))
    _raise_on(rc, "fused_layer_train_bwd_attn_stored")
    _count(fused_layer_train_bwd_attn_stored, seeds)
    return dx, g


fused_layer_train_bwd_attn_stored.launches = fused_layer_train_bwd_attn_stored.prng_launches = 0


# ---------------------------------------------------------------------------
# the differentiable layer and stack
# ---------------------------------------------------------------------------

class FusedLayerTrain(torch.autograd.Function):
    """One differentiable fused layer: the forward kernel, and as backward
    the FFN half then the attention half. With store the forward is the
    store-probs kernel and the attention half reads its probs and qkv.
    Inputs: x, the additive key mask (or None), the three masks (or None),
    the prng mode's seeds (or None) and rate, the head count, store, then
    the layer's parameters in PARAM_KEYS order. The backward regenerates
    the prng mode's bits from the saved seeds."""

    @staticmethod
    def forward(ctx, x, kmask, m0, m1, m2, seeds, rate, num_heads, store, *params):
        p = pack(dict(zip(PARAM_KEYS, params)))
        masks = None if m0 is None else (m0, m1, m2)
        xb = x.detach().to(_BF16).contiguous()
        probs = qkv = None
        if store:
            out, a1, attn, probs, qkv = fused_layer_train_forward_store(
                xb, p, num_heads, kmask, masks, x.dtype, seeds, rate)
        else:
            out, a1, attn = fused_layer_train_forward(xb, p, num_heads, kmask, masks, x.dtype,
                                                      seeds, rate)
        ctx.num_heads = num_heads
        ctx.rate = rate
        ctx.x_dtype = x.dtype
        ctx.param_dtypes = [t.dtype for t in params]
        ctx.has_masks = masks is not None
        ctx.save_for_backward(xb, kmask, m0, m1, m2, seeds, a1, attn, probs, qkv,
                              *(p[k] for k in PARAM_KEYS))
        return out

    @staticmethod
    def backward(ctx, dout):
        xb, kmask, m0, m1, m2, seeds, a1, attn, probs, qkv, *packed = ctx.saved_tensors
        p = dict(zip(PARAM_KEYS, packed))
        masks = (m0, m1, m2) if ctx.has_masks else None
        drop = dict(seeds=seeds, rate=ctx.rate)
        da1, g_ffn = fused_layer_train_bwd_ffn(dout, a1, p, masks, **drop)
        if probs is not None:
            dx, g_attn = fused_layer_train_bwd_attn_stored(da1, xb, attn, probs, qkv, p,
                                                           ctx.num_heads, masks, **drop)
        else:
            dx, g_attn = fused_layer_train_bwd_attn(da1, xb, attn, p, ctx.num_heads, kmask,
                                                    masks, **drop)
        grads = {**g_ffn, **g_attn}
        # dx leaves in the layer input's rounding (bf16), then the caller's dtype
        dx = dx.to(_BF16).to(ctx.x_dtype)
        return (dx, None, None, None, None, None, None, None, None,
                *(grads[k].to(dt) for k, dt in zip(PARAM_KEYS, ctx.param_dtypes)))


def fused_encoder_layer_train(x, params: dict, num_heads: int, masks=None,
                              key_padding_mask: Optional[torch.Tensor] = None,
                              store_probs: bool = False, seeds: Optional[torch.Tensor] = None,
                              rate: float = 0.0):
    """One differentiable fused layer. x (B, S, D); params by PARAM_KEYS name
    (autograd leaves or not); masks from make_dropout_masks or None, or seeds
    (B,) int32 with the rate for the in-kernel prng dropout (one or the
    other, :797-800); store_probs selects the store-probs forward and stored
    backward. Under torch.no_grad() (the parallel unroll's Picard sweeps)
    nothing reads the stored probs, so the recompute forward runs: its out is
    the store forward's, bit for bit."""
    B, S, _ = x.shape
    _check_dropout(masks, seeds, rate)
    kmask = additive_key_mask(key_padding_mask, B, S, x.device)
    m0, m1, m2 = masks if masks is not None else (None, None, None)
    store = bool(store_probs) and torch.is_grad_enabled()
    return FusedLayerTrain.apply(x, kmask, m0, m1, m2, seeds, float(rate), num_heads,
                                 store, *(params[k] for k in PARAM_KEYS))


def fused_encoder_train(x: torch.Tensor, layers: Sequence[dict], num_heads: int,
                        dropout: float = 0.0, generator: Optional[torch.Generator] = None,
                        key_padding_mask: Optional[torch.Tensor] = None,
                        store_probs: bool = False, in_kernel_prng: bool = False) -> torch.Tensor:
    """Differentiable fused encoder stack (training path). dropout > 0 needs
    a generator. Masks mode: each layer draws independent masks from it, in
    layer order (fused_encoder_train, :810-851). in_kernel_prng: one (B,)
    seed vector per layer is drawn from it before any layer runs
    (draw_dropout_seeds), and the kernels generate the masks (kernel 10);
    make_dropout_masks is never called."""
    if dropout > 0.0 and generator is None:
        raise ValueError("dropout > 0 needs a torch.Generator")
    refuse_dtensor(*(t for params in layers for t in params.values()))
    B, S, D = x.shape
    seeds = None
    if dropout > 0.0 and in_kernel_prng:
        seeds = draw_dropout_seeds(generator, len(layers), B).to(x.device)
    for i, params in enumerate(layers):
        masks = None
        if dropout > 0.0 and seeds is None:
            masks = make_dropout_masks(generator, (B, S, D), dropout,
                                       params["linear1_weight"].shape[0])
        x = fused_encoder_layer_train(
            x, params, num_heads, masks, key_padding_mask, store_probs,
            seeds=None if seeds is None else seeds[i].contiguous(),
            rate=dropout if seeds is not None else 0.0)
    return x
