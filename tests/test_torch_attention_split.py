"""The tensor-core arithmetic of the attention kernels, emulated in plain
PyTorch on the CPU and held to the plain versions and to the JAX package.

Kernel 4 (csrc/attention.cu) keeps fp32 accuracy on the tensor cores by
splitting each fp32 operand x into hi = tf32(x) and lo = tf32(x - hi) (tf32
rounding as cvt.rna.tf32.f32 does it: to nearest, ties away from zero) and
summing hi*hi' + hi*lo' + lo*hi' (3xTF32); bf16 q and k multiply exactly in
bf16, and p v is p_hi v + p_lo v, bf16 v being exact in tf32. Its softmax is
online: sum_j exp(s_j - m) v_j over sum_j exp(s_j - m). The emulation keeps
those terms and that order and must sit within rel L2 1e-6 of
attention_reference (the gate on the card is 1e-5); single-pass TF32 must
miss 1e-5, so this file guards the reason the split exists.

Kernel 1's attention launch (attention_fwd.cuh, forward_tc_regs) keeps a
query row's whole score row in registers for S <= 256: exact max and sum,
p = bf16(exp(s - max) / sum), then p v; its products run as 16-wide k steps
over 16-key chunks, and it divides by the sum as e r corrected by the
remainder (mma.cuh's div_by). The emulation of that order is held to the
fused layer's twin (fused_encoder._attention).
"""
from fractions import Fraction

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from motionstyle.ops import attention as jattn
from motionstyle_torch.ops import attention, fused_encoder
from tests.test_torch_models import one_torch_thread  # noqa: F401

B, D, H = 2, 128, 4  # head width 32
SPLIT_REL_L2 = 1e-6  # the emulated split against the plain version
GATE_REL_L2 = 1e-5   # chip_smoke.py's ATTN_REL_L2, the card's gate
XLA_ATOL = 1e-5      # tests/test_torch_attention.py's tolerance against JAX


def tf32_rna(x: torch.Tensor) -> torch.Tensor:
    """fp32 -> the tf32 value cvt.rna.tf32.f32 gives: the 13 low mantissa
    bits rounded off to nearest, ties away from zero (sign and magnitude:
    adding half of the dropped range to the bits rounds the magnitude up)."""
    bits = x.float().contiguous().view(torch.int32)
    return ((bits + 0x1000) & -0x2000).view(torch.float32)


def split(x: torch.Tensor) -> tuple:
    hi = tf32_rna(x)
    return hi, tf32_rna(x - hi)


def mm_3xtf32(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """a @ b in 3xTF32: the small terms summed apart, then added."""
    (ah, al), (bh, bl) = split(a), split(b)
    return (al @ bh + ah @ bl) + ah @ bh


def _heads(t: torch.Tensor) -> torch.Tensor:
    b, s, d = t.shape
    return t.reshape(b, s, H, d // H).transpose(1, 2)


def kernel4_emulation(q, k, v, mask_add, single_pass_tf32: bool = False):
    """Kernel 4's arithmetic on (B, S, D) fp32 or bf16 q, k, v: fp32 (B, S, D)."""
    dh = q.shape[-1] // H
    qs = q * attention.head_scale(dh, q.dtype)  # rounded to the input type
    qh, kh, vh = (_heads(t).float() for t in (qs, k, v))
    if single_pass_tf32:
        s = tf32_rna(qh) @ tf32_rna(kh).transpose(-1, -2)
    elif q.dtype == torch.float32:
        s = mm_3xtf32(qh, kh.transpose(-1, -2))
    else:
        s = qh @ kh.transpose(-1, -2)  # bf16 products are exact in fp32
    if mask_add is not None:
        s = s + mask_add[:, None, None, :]
    e = torch.exp(s - s.amax(-1, keepdim=True))
    if single_pass_tf32:
        out = tf32_rna(e) @ tf32_rna(vh)
    elif q.dtype == torch.float32:
        out = mm_3xtf32(e, vh)
    else:
        eh, el = split(e)
        out = el @ vh + eh @ vh  # bf16 v is exact in tf32
    out = out / e.sum(-1, keepdim=True)
    b, _, s_, _ = out.shape
    return out.transpose(1, 2).reshape(b, s_, -1)


def _inputs(S: int, dtype, seed: int = 0):
    r = np.random.RandomState(seed)
    q, k, v = (r.randn(B, S, D).astype(np.float32) for _ in range(3))
    kpm = np.ones((B, S), bool)
    kpm[1, S // 2 + 1:] = False  # the masked clip keeps its first key
    mask = np.where(kpm, 0.0, -1e9).astype(np.float32)
    return [torch.from_numpy(a).to(dtype) for a in (q, k, v)], torch.from_numpy(mask)


def _rel_l2(a, b) -> float:
    return float((a - b).norm() / b.norm())


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("S", [1, 77, 197, 600])
def test_kernel4_split_matches_plain_and_jax(S, dtype):
    (q, k, v), mask = _inputs(S, dtype)
    got = kernel4_emulation(q, k, v, mask)
    want = attention.attention_reference(q, k, v, H, mask)
    assert _rel_l2(got, want) <= SPLIT_REL_L2
    jdt = jnp.bfloat16 if dtype == torch.bfloat16 else jnp.float32
    jq, jk, jv = (jnp.asarray(t.float().numpy()).astype(jdt) for t in (q, k, v))
    want_jax = np.asarray(jattn._xla_attention(jq, jk, jv, H,
                                               jnp.asarray(mask.numpy())[:, None, None, :]))
    np.testing.assert_allclose(got.numpy(), want_jax, atol=XLA_ATOL)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("S", [77, 600])
def test_single_pass_tf32_misses_the_gate(S, dtype):
    """tf32 operands without the split keep 11 significant bits: the card's
    1e-5 gate fails, which is why kernel 4 splits them."""
    (q, k, v), mask = _inputs(S, dtype, seed=1)
    got = kernel4_emulation(q, k, v, mask, single_pass_tf32=True)
    assert _rel_l2(got, attention.attention_reference(q, k, v, H, mask)) > GATE_REL_L2


def test_tf32_rounding_is_to_nearest_ties_away():
    one = 1.0
    ulp = 2.0 ** -10  # tf32's spacing at 1
    x = torch.tensor([one + ulp / 2, -(one + ulp / 2), one + ulp / 2 - 2.0 ** -23,
                      one + 3 * ulp / 2, 3.0, 0.0], dtype=torch.float32)
    want = torch.tensor([one + ulp, -(one + ulp), one, one + 2 * ulp, 3.0, 0.0])
    torch.testing.assert_close(tf32_rna(x), want, rtol=0, atol=0)
    assert (tf32_rna(torch.randn(1000)).view(torch.int32) & 0x1FFF == 0).all()


def test_split_keeps_22_bits():
    x = torch.from_numpy(np.random.RandomState(2).randn(4096).astype(np.float32))
    hi, lo = split(x)
    assert ((x - hi - lo).abs() <= 2.0 ** -22 * x.abs()).all()


def _rn32(x: Fraction) -> np.float32:
    """A rational rounded to the nearest float32, ties to even."""
    f = np.float32(float(x))
    near = (np.nextafter(f, np.float32(-np.inf)), f, np.nextafter(f, np.float32(np.inf)))
    return min(near, key=lambda c: (abs(Fraction(float(c)) - x),
                                    int(np.array(c).view(np.int32)) & 1))


def div_by(e: np.ndarray, l: np.ndarray) -> np.ndarray:
    """mma.cuh's div_by on float32 arrays: q = e r with r = 1/l, corrected once
    by the remainder, q + fma(-q, l, e) r. float64 holds e - q l exactly and
    the product of the remainder and r, so only the final sum can round twice."""
    f32, f64 = np.float32, np.float64
    r = (f32(1) / l).astype(f32)
    q = (e * r).astype(f32)
    rem = (e.astype(f64) - q.astype(f64) * l.astype(f64)).astype(f32)
    return (rem.astype(f64) * r.astype(f64) + q.astype(f64)).astype(f32)


def test_div_by_is_the_quotient_to_one_ulp():
    """The kernel's normalisation against e / l on a softmax's range of
    values, exactly: every quotient within one fp32 ulp, and all but a few
    in 1e5 equal to the correctly rounded one (rechecked with exact fmas
    where the float64 emulation differs)."""
    rs = np.random.RandomState(4)
    n = 200_000
    e = (rs.rand(n) ** (1 + 20 * rs.rand(n))).astype(np.float32)
    l = (1 + rs.rand(n) * 300).astype(np.float32)
    want = e / l
    got = div_by(e, l)
    for i in np.nonzero(got != want)[0]:
        r = np.float32(1) / l[i]
        q = e[i] * r
        rem = _rn32(Fraction(float(e[i])) - Fraction(float(q)) * Fraction(float(l[i])))
        got[i] = _rn32(Fraction(float(rem)) * Fraction(float(r)) + Fraction(float(q)))
    ulps = np.abs(got.view(np.int32).astype(np.int64) - want.view(np.int32).astype(np.int64))
    assert ulps.max() <= 1
    assert (ulps > 0).mean() <= 1e-4


def kernel1_register_path(q, k, v, mask_add, num_heads: int) -> tuple:
    """forward_tc_regs's order on (B, S, D) fp32 q (already scaled), k, v:
    bf16 operands, scores as fp32 sums over 16-wide k steps per 16-key
    chunk, keys padded to a multiple of 16 with -inf, the exact row max and
    sum, p = bf16(div_by(e, sum)), then p v chunk by chunk. Returns (fp32
    (B, S, D) output, bf16 p over the S keys)."""
    qh, kh, vh = (t.to(torch.bfloat16).float().reshape(t.shape[0], t.shape[1], num_heads, -1)
                  .transpose(1, 2) for t in (q, k, v))
    S, dh = qh.shape[2], qh.shape[3]
    sp = (S + 15) // 16 * 16
    kh = torch.nn.functional.pad(kh, (0, 0, 0, sp - S))
    vh = torch.nn.functional.pad(vh, (0, 0, 0, sp - S))
    s = torch.zeros(*qh.shape[:3], sp)
    for c in range(0, sp, 16):
        for kc in range(0, dh, 16):
            kt = kh[..., c:c + 16, kc:kc + 16].transpose(-1, -2)
            s[..., c:c + 16] += qh[..., kc:kc + 16] @ kt
    add = torch.full((q.shape[0], sp), -torch.inf)
    add[:, :S] = 0.0 if mask_add is None else mask_add
    s = s + add[:, None, None, :]
    e = torch.exp(s - s.amax(-1, keepdim=True))
    l = e.sum(-1, keepdim=True).expand_as(e)
    p = torch.from_numpy(div_by(e.numpy(), l.contiguous().numpy())).to(torch.bfloat16)
    out = torch.zeros(*qh.shape[:3], dh)
    for c in range(0, sp, 16):
        out += p[..., c:c + 16].float() @ vh[..., c:c + 16, :]
    b = out.shape[0]
    return out.transpose(1, 2).reshape(b, S, -1), p[..., :S]


@pytest.mark.parametrize("S", [77, 197])
def test_kernel1_register_path_matches_the_twin(S):
    """The register-resident order against the fused layer's twin at the
    CLI shapes (D=512, 4 heads, head width 128). Both take the exact row max
    and sum and round the normalised p once, but they sum the same fp32
    products in another order, so an fp32 p can differ in its last place and
    land on the other side of a bf16 rounding: p agrees to one bf16 ulp,
    all but a few in 1e3 to the bit, and the output, whose error is those
    few flips of 2^-9 of a p, within rel L2 1e-4 (8e-6 at S=197 here)."""
    d, heads = 512, 4
    r = np.random.RandomState(3)
    qkv = torch.from_numpy(r.randn(2, S, 3 * d).astype(np.float32))
    kpm = torch.ones(2, S, dtype=torch.bool)
    kpm[1, S // 3:] = False
    mask = fused_encoder.additive_key_mask(kpm, 2, S, "cpu")
    q, k, v = qkv.split(d, -1)
    qs = q * (1.0 / np.sqrt(d // heads))
    got, p = kernel1_register_path(qs, k, v, mask, heads)
    want = fused_encoder._attention(qkv, heads, kpm)
    assert _rel_l2(got, want) <= 1e-4
    # the twin's p: its softmax of the same bf16 scores
    qh, kh = (t.to(torch.bfloat16).float().reshape(2, S, heads, -1).transpose(1, 2)
              for t in (qs, k))
    p_twin = torch.softmax(qh @ kh.transpose(-1, -2) + mask[:, None, None, :], -1)
    p_twin = p_twin.to(torch.bfloat16).float()
    diff = (p.float() - p_twin).abs()
    ulp = 2.0 ** (torch.floor(torch.log2(p_twin.clamp_min(2.0 ** -126))) - 7)
    assert (diff <= ulp).all()
    assert (diff == 0).float().mean() >= 0.999
