"""The tensor-core attention backward of kernels 7 and 9 (csrc/
fused_encoder_train.cu: attention_bwd_rows_tc for dq and the bf16 p and ds
it hands on, attention_bwd_cols_tc for dk and dv from them), emulated in plain
PyTorch on the CPU and held to the plain twins and to the JAX package.

The emulation keeps the launches' order: products as 16-wide k steps over
16-key (rows) or 16-query (cols) chunks; the row max and sum exact over the
row on the register path (S up to 256 at head width <= 64, 208 at 128) and
running over 64-key tiles on the tiled path; p = div_by(e, sum) in fp32;
dp formed again for ds; delta = sum_j dp p from fp32 dp and p; ds = p (dp -
delta) rounded to bf16 before ds k and ds^T q; bf16(p)^T da for dv, the
cols launch reading the bf16 p and ds the rows launch hands it; and dbqkv
from each 64-row block's column sums (16-row warps added in warp order),
which the reduce launch adds in its order.

Gates:
- against the twin's softmax VJP (ops.fused_encoder_train.
  attention_vjp_reference) on the same bf16 operands: rel L2 EMU_REL_L2 =
  3e-4 for each of dq, dk and dv. Both round ds and p at the same points, so
  they differ only where another order of fp32 sums (or div_by's quotient)
  moves a value across a bf16 rounding (at most 7.2e-5 over these cases);
  leaving out a rounding, or taking delta as rowsum(dO o O) with O =
  bf16(bf16(p) v), moves them by 1.2e-3 to 1.7e-3, which
  test_rounding_points_are_the_pallas_bodies shows;
- against the JAX package's _bwd_attn_kernel and _bwd_attn_stored_kernel
  (their pallas_calls in interpret mode, as tests/test_torch_fused_train.py
  runs them): dx and every gradient leaf within GRAD_REL = 3e-2 of the
  leaf's largest magnitude, tests/test_torch_fused_train.py's gate;
- dbqkv from the blocks' column sums against dqkv summed over rows: rel L2
  1e-6 (fp32 sums in two orders).
Widths: D=128 with 4 heads (head width 32) and 2 heads (64); D=256 with 2
heads (128) where the register path stops at 208.
"""
import math

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from motionstyle.models.transformer import TransformerEncoderLayer as JLayer
from motionstyle.ops import fused_encoder_train as jft
from motionstyle_torch.models.params import encoder_from_jax
from motionstyle_torch.models.transformer import TransformerEncoder
from motionstyle_torch.ops import fused_encoder as fe
from motionstyle_torch.ops import fused_encoder_train as ft
from tests.test_torch_attention_split import div_by
from tests.test_torch_models import numpy_params, one_torch_thread  # noqa: F401

TILE, CHUNK, CQ = 64, 16, 32  # BWD_T (TC_KT), the 16-key chunk, BWD_CQ
EMU_REL_L2 = 3e-4
GRAD_REL = 3e-2
COLSUM_REL_L2 = 1e-6


def reg_max(dh: int) -> int:
    """rows_reg_max: the longest S of the rows launch's register path."""
    return 256 if dh <= 64 else 208


def bf(t: torch.Tensor) -> torch.Tensor:
    return t.to(torch.bfloat16).float()


def ceil16(n: int) -> int:
    return -(-n // 16) * 16


def pad_rows(t: torch.Tensor, n: int) -> torch.Tensor:
    return torch.nn.functional.pad(t, (0, 0, 0, n - t.shape[-2]))


def abt_chunks(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """a b^T (.., R, dh) x (.., C, dh) -> (.., R, ceil16(C)) as the kernels
    sum it: per 16-column chunk, 16-wide k steps added in order; b's rows past
    C are zero."""
    cp, dh = ceil16(b.shape[-2]), a.shape[-1]
    b = pad_rows(b, cp)
    out = torch.zeros(*a.shape[:-1], cp)
    for c in range(0, cp, CHUNK):
        for kc in range(0, dh, 16):
            out[..., c:c + CHUNK] += a[..., kc:kc + 16] @ b[..., c:c + CHUNK, kc:kc + 16].transpose(-1, -2)
    return out


def chunk_sum(t: torch.Tensor) -> torch.Tensor:
    """The last axis summed chunk by chunk, in chunk order."""
    out = torch.zeros(t.shape[:-1])
    for c in range(0, t.shape[-1], CHUNK):
        out += t[..., c:c + CHUNK].sum(-1)
    return out


def a_b_chunks(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """a b, (.., R, K) x (.., K, dh), K summed in 16-wide chunks in order."""
    out = torch.zeros(*a.shape[:-1], b.shape[-1])
    for c in range(0, a.shape[-1], CHUNK):
        out += a[..., c:c + CHUNK] @ b[..., c:c + CHUNK, :]
    return out


def divide(e: torch.Tensor, l: torch.Tensor) -> torch.Tensor:
    """mma.cuh's div_by of every e by its row's l."""
    return torch.from_numpy(div_by(e.numpy(), l.expand_as(e).contiguous().numpy()))


def rows_launch(qs, k, v, da, mask, probs, variant=None):
    """attention_bwd_rows_tc on (B, H, S, dh) bf16-valued qs (q*scale), k, v,
    da; mask (B, S) additive or None; probs (B, H, S, S) stored or None.
    Returns dq (fp32, before the scale and the rounding) and the fp32 p and
    ds (B, H, S, ceil16(S)) it hands the cols launch (ds rounded to bf16)."""
    S, dh = da.shape[-2], da.shape[-1]
    sp = ceil16(S)
    dp = abt_chunks(da, v)
    if probs is None:
        add = torch.full((da.shape[0], sp), -torch.inf)
        add[:, :S] = 0.0 if mask is None else mask
        s = abt_chunks(qs, k) + add[:, None, None, :]
        if S <= reg_max(dh):  # the whole row in registers: exact max and sum
            m = s.amax(-1, keepdim=True)
            l = chunk_sum(torch.exp(s - m))[..., None]
        else:  # running max and sum over the 64-key tiles
            m = torch.full((*s.shape[:-1], 1), -torch.inf)
            l = torch.zeros_like(m)
            for j in range(0, sp, TILE):
                st = s[..., j:j + TILE]
                n = torch.maximum(m, st.amax(-1, keepdim=True))
                e = chunk_sum(torch.exp(st - n))[..., None]
                l = torch.where(m == -torch.inf, 0.0, l * torch.exp(m - n)) + e
                m = n
        p = divide(torch.exp(s - m), l)
    else:
        p = torch.nn.functional.pad(probs.float(), (0, sp - S))
    if variant == "delta_from_out":  # rowsum(dO o O), O = bf16(bf16(p) v)
        delta = (da * bf(bf(p) @ pad_rows(v, sp))).sum(-1)
    else:
        delta = chunk_sum(p * dp)
    ds = p * (dp - delta[..., None])
    if variant != "ds_unrounded":
        ds = bf(ds)
    return a_b_chunks(ds, pad_rows(k, sp)), p, ds


def cols_launch(q, da, p, ds, variant=None):
    """attention_bwd_cols_tc: dk = bf16(ds)^T q and dv = bf16(p)^T da over
    16-query chunks, from the p and ds the rows launch handed over (keys as
    the rows). Returns dk (before the scale) and dv, fp32."""
    S = da.shape[-2]
    pt, dst = p[..., :S].transpose(-1, -2), ds[..., :S].transpose(-1, -2)
    if variant != "p_unrounded":
        pt = bf(pt)
    return a_b_chunks(dst, q), a_b_chunks(pt, da)


def block_column_sums(t: torch.Tensor) -> torch.Tensor:
    """Column sums of (B, S, W) rows as the launches and the reduce launch
    take them: each 64-row block's four 16-row warps, added in warp order,
    into partial[b * ntiles + tile]; then the reduce launch's order over
    those rows (in row order for at most 8; else 8 warps each adding rows w,
    w + 8, ..., then the warps in order)."""
    B, S, W = t.shape
    parts = []
    for b in range(B):
        for j in range(0, S, TILE):
            acc = torch.zeros(W)
            for w in range(j, min(j + TILE, S), 16):
                acc = acc + t[b, w:w + 16].sum(0)
            parts.append(acc)
    parts = torch.stack(parts)
    if len(parts) <= 8:
        out = torch.zeros(W)
        for r in parts:
            out = out + r
        return out
    warps = []
    for w in range(8):
        acc = torch.zeros(W)
        for r in parts[w::8]:
            acc = acc + r
        warps.append(acc)
    out = warps[0]
    for acc in warps[1:]:
        out = out + acc
    return out


def attention_vjp_emulated(probs_stored, q, k, v, dattn, kmask, B, H, variant=None):
    """The two launches on B clips' (B*S, D) q (unscaled), k, v, dattn (and
    the stored bf16 probs (B, H, S, S), or None to recompute): (dqkv fp32
    (B*S, 3D) before rounding, dbqkv from the blocks' column sums)."""
    M, D = q.shape
    S, dh = M // B, D // H
    scale = 1.0 / math.sqrt(dh)
    heads = lambda t: bf(t).reshape(B, S, H, dh).transpose(1, 2)  # noqa: E731
    qs = heads(q * scale)
    qh, kh, vh, dah = heads(q), heads(k), heads(v), heads(dattn)
    dq, p, ds = rows_launch(qs, kh, vh, dah, kmask, probs_stored, variant)
    dk, dv = cols_launch(qh, dah, p, ds, variant)
    merge = lambda t: t[..., :S, :].transpose(1, 2).reshape(B * S, D)  # noqa: E731
    dqkv = torch.cat([merge(dq * scale), merge(dk * scale), merge(dv)], -1)
    return dqkv, block_column_sums(dqkv.reshape(B, S, 3 * D))


def _rel_l2(a, b) -> float:
    """rel L2, 0 for two zeros (dq at S=1: ds = p (dp - delta) = 0)."""
    return float((a - b).norm() / b.norm().clamp_min(1e-30))


def _rel(got, want) -> float:
    return float(np.abs(got - want).max() / (np.abs(want).max() + 1e-8))


def _vjp_inputs(B, S, D, H, masked, stored, seed):
    """q (unscaled), k, v as the recompute's qkv GEMM gives them (fp32 sums
    of bf16 operands, rounded to bf16 where stored), dattn bf16, the key mask
    and the stored probs; the twin's fp32 probs."""
    r = np.random.RandomState(seed)
    q, k, v, da = (torch.from_numpy(r.randn(B * S, D).astype(np.float32)) for _ in range(4))
    da = bf(da)
    mask = None
    if masked:
        kpm = torch.ones(B, S, dtype=torch.bool)
        kpm[-1, S // 2 + 1:] = False  # the masked clip keeps its first keys
        mask = fe.additive_key_mask(kpm, B, S, "cpu")
    if stored:
        q, k, v = bf(q), bf(k), bf(v)
    probs = ft._probs(q, k, mask, B, S, H)
    stored_p = probs.to(torch.bfloat16) if stored else None
    return q, k, v, da, mask, probs, stored_p


CASES = [(S, D, H) for S in (1, 13, 77, 197, 300) for D, H in ((128, 4), (128, 2))] + [
    (197, 256, 2), (240, 256, 2)]


@pytest.mark.parametrize("stored", [False, True])
@pytest.mark.parametrize("masked", [False, True])
@pytest.mark.parametrize("S,D,H", CASES)
def test_emulation_matches_the_twins_vjp(S, D, H, masked, stored):
    """dq, dk and dv of the launches' order within EMU_REL_L2 of the twin's
    softmax VJP on the same operands, and dbqkv from the blocks' column sums
    within COLSUM_REL_L2 of dqkv summed over rows; S=300 at head width <= 64
    and S=240 at 128 take the tiled rows path."""
    B = 2
    q, k, v, da, mask, probs, stored_p = _vjp_inputs(B, S, D, H, masked, stored, seed=S + D + H)
    got, colsums = attention_vjp_emulated(stored_p, q, k, v, da, None if stored else mask, B, H)
    want = ft.attention_vjp_reference(stored_p.float() if stored else probs, q, k, v, da, H)
    for part in range(3):
        sl = slice(part * D, (part + 1) * D)
        assert _rel_l2(got[:, sl], want[:, sl]) <= EMU_REL_L2, ("qkv"[part], _rel_l2(got[:, sl], want[:, sl]))
    assert _rel_l2(colsums, got.sum(0)) <= COLSUM_REL_L2


@pytest.mark.parametrize("variant,stored", [
    ("ds_unrounded", False), ("ds_unrounded", True), ("p_unrounded", False),
    ("delta_from_out", False), ("delta_from_out", True)])
def test_rounding_points_are_the_pallas_bodies(variant, stored):
    """At the finetune's S=77 with head width 32: leaving ds unrounded before
    ds k and ds^T q, or the recomputed p unrounded before p^T da (a stored p
    is bf16 already), or taking delta as rowsum(dO o O) (FlashAttention's
    shortcut; O was formed from bf16(p)) misses EMU_REL_L2, which the
    emulation as written meets (test_emulation_matches_the_twins_vjp): the
    gate sees the choice."""
    B, S, D, H = 2, 77, 128, 4
    q, k, v, da, mask, probs, stored_p = _vjp_inputs(B, S, D, H, True, stored, seed=5)
    got, _ = attention_vjp_emulated(stored_p, q, k, v, da, None if stored else mask, B, H, variant)
    want = ft.attention_vjp_reference(stored_p.float() if stored else probs, q, k, v, da, H)
    part = {"ds_unrounded": 0, "p_unrounded": 2, "delta_from_out": 1}[variant]
    sl = slice(part * D, (part + 1) * D)
    assert _rel_l2(got[:, sl], want[:, sl]) > EMU_REL_L2


def _jax_layer(D, H, seed):
    x0 = np.zeros((1, 16, D), np.float32)
    tree = JLayer(D, H, 2 * D, dropout=0.1).init(jax.random.PRNGKey(seed), jnp.asarray(x0))
    params = numpy_params(tree, seed)["params"]
    enc = TransformerEncoder(1, D, H, 2 * D)
    enc.load_state_dict(encoder_from_jax({"layers_0": params}))
    return params, fe.layer_params(enc.layers[0])


def _half_emulated(da1, x, p, H, mask, stored):
    """The attention half (dropout off) with the launches' softmax VJP in
    place of the twin's: returns (dx (B, S, D), grads by parameter name)."""
    B, S, D = x.shape
    xb = x.reshape(B * S, D).to(torch.bfloat16)
    qkv = fe._bf16_dot(xb, p["in_proj_weight"], p["in_proj_bias"])
    q, k, v = qkv.split(D, dim=-1)
    stored_p = None
    if stored:  # the store forward's bf16 qkv and probs
        q, k, v = bf(q), bf(k), bf(v)
        stored_p = ft._probs(qkv[:, :D], qkv[:, D:2 * D], mask, B, S, H).to(torch.bfloat16)
    dproj = da1.reshape(B * S, D)
    dattn = bf(bf(dproj) @ bf(p["out_proj_weight"]))
    dqkv, dbqkv = attention_vjp_emulated(stored_p, q, k, v, dattn, None if stored else mask, B, H)
    dx = dproj + bf(dqkv) @ bf(p["in_proj_weight"])
    grads = {"in_proj_weight": bf(dqkv).t() @ bf(xb), "in_proj_bias": dbqkv}
    return dx.reshape(B, S, D), grads, stored_p, qkv


@pytest.mark.parametrize("stored", [False, True])
@pytest.mark.parametrize("S,D,H", [(13, 128, 4), (77, 128, 2), (300, 128, 4), (240, 256, 2)])
def test_emulation_matches_pallas(S, D, H, stored):
    """The attention half with the launches' VJP against the JAX package's
    _bwd_attn_kernel (recompute) or _bwd_attn_stored_kernel (stored p and
    qkv), interpret mode, masked keys, dropout off: dx, dWqkv and dbqkv
    within GRAD_REL. The JAX side pads S to 16 and masks the padded keys."""
    B = 2
    params, p = _jax_layer(D, H, seed=S + H)
    r = np.random.RandomState(S)
    x = r.randn(B, S, D).astype(np.float32)
    da1 = r.randn(B, S, D).astype(np.float32)
    attn = r.randn(B, S, D).astype(np.float32)
    kpm = np.ones((B, S), bool)
    kpm[-1, S // 2 + 1:] = False
    mask = fe.additive_key_mask(torch.from_numpy(kpm), B, S, "cpu")
    with torch.no_grad():
        dx, grads, stored_p, qkv = _half_emulated(torch.from_numpy(da1), torch.from_numpy(x), p,
                                                  H, mask, stored)

    sp = ceil16(S)
    pad = lambda a: np.pad(a, [(0, 0), (0, sp - S)] + [(0, 0)] * (a.ndim - 2))  # noqa: E731
    kmask_p = np.where(np.pad(kpm, [(0, 0), (0, sp - S)]), 0.0, -1e9).astype(np.float32)[:, None]
    bf16 = lambda a: jnp.asarray(a, jnp.bfloat16)  # noqa: E731
    if stored:
        probs_p = np.pad(stored_p.float().numpy(), [(0, 0), (0, 0), (0, sp - S), (0, sp - S)])
        qkv_p = pad(bf(qkv).reshape(B, S, 3 * D).numpy())
        out = jft._bwd_attn_call_stored(jnp.asarray(pad(da1)), bf16(pad(x)), bf16(pad(attn)),
                                        bf16(probs_p), bf16(qkv_p), params, None, H)
    else:
        out = jft._bwd_attn_call(jnp.asarray(pad(da1)), bf16(pad(x)), jnp.asarray(kmask_p),
                                 bf16(pad(attn)), params, None, H)
    jdx, jdwqkv, jdbqkv = (np.asarray(a) for a in out[:3])
    assert _rel(dx.numpy(), jdx[:, :S]) < GRAD_REL
    assert _rel(grads["in_proj_weight"].numpy(), jdwqkv.T) < GRAD_REL
    assert _rel(grads["in_proj_bias"].numpy(), jdbqkv[0]) < GRAD_REL
