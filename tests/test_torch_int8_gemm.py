"""The int8 serving layer (kernel 2) on the shared wgmma GEMM: chip_smoke.py's
per-launch work beside each launch's device time, the tile plan the wrapper
mirrors (the C launcher's is held to it on the card), the tiling independence
of the int32 sums that the card's bit-equality check of the q, k and v planes
relies on, and those planes (the wrapper's return_qkv) against the JAX
package's int8 dot. The kernel itself runs only on the card (chip_smoke.py's
kernel phase).
"""
import math

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import chip_smoke
from motionstyle.ops.fused_encoder import _int8_dot as jint8_dot
from motionstyle_torch.ops import fused_encoder as fe
from tests.test_torch_models import one_torch_thread  # noqa: F401

SMS = 132  # an H100 SXM's streaming multiprocessors


@pytest.mark.parametrize("b, s, d, h, f", [(8, 77, 512, 4, 1024), (64, 197, 512, 4, 1024),
                                           (1, 77, 512, 4, 1024), (8, 1, 1024, 8, 2048),
                                           (8, 77, 64, 1, 64)])
def test_int8_gemm_bounds_split_the_layer(b, s, d, h, f):
    """int8_gemm_bounds' launches do exactly int8_layer_bound's operations,
    the int8 products in the four GEMMs and the bf16 ones in the attention,
    one (ops, flops, bytes) triple a launch name of INT8_LAUNCHES; each
    launch moves at least its own part of the layer's input (the bytes count
    the intermediates too); at the serving shape the four GEMMs are 0.969,
    0.323, 0.646 and 0.646 GOP."""
    for masked in (False, True):
        launches = chip_smoke.int8_gemm_bounds(b, s, d, h, f, masked)
        _, _, ops, flops, nbytes = chip_smoke.int8_layer_bound(b, s, d, h, f, masked)
        assert len(launches) == len(chip_smoke.INT8_LAUNCHES)
        assert sum(o for o, _, _ in launches) == ops
        assert sum(fl for _, fl, _ in launches) == flops
        assert all(nb > 0 for _, _, nb in launches) and sum(nb for *_, nb in launches) > nbytes
    gemms = [launches[i][0] for i in (1, 4, 5, 6)]
    if (b, s, d) == (8, 77, 512):
        assert [round(o / 1e9, 3) for o in gemms] == [0.969, 0.323, 0.646, 0.646]
    m = b * s
    unmasked = chip_smoke.int8_gemm_bounds(b, s, d, h, f)
    assert launches[2][2] - unmasked[2][2] == b * s * 4  # the attention reads the mask
    # the weights are read once: 1 byte a code
    assert launches[1][2] == m * d + m * 4 + 3 * d * d + 6 * d * 4 + 3 * m * d * 2
    # the FFN-up launch writes ff in fp32, which the fp32 row-code launch
    # (one row with attn's) reads and codes
    assert unmasked[5][2] == m * d + m * 4 + f * d + 2 * f * 4 + m * f * 4
    assert unmasked[3][2] == m * d * 4 + m * d + m * 4 + m * f * 4 + m * f + m * 4


@pytest.mark.parametrize("b, s, d, f, want", [
    (1, 77, 512, 1024, [(64, 64, 2, 24, 1), (64, 64, 2, 8, 8), (64, 64, 2, 16, 1),
                        (64, 64, 2, 8, 8)]),
    (8, 77, 512, 1024, [(64, 64, 10, 24, 1), (64, 64, 10, 8, 8), (64, 64, 10, 16, 1),
                        (64, 64, 10, 8, 8)]),
    (64, 197, 512, 1024, [(128, 64, 99, 24, 1), (128, 64, 99, 8, 8), (128, 64, 99, 16, 1),
                          (128, 128, 99, 4, 4)]),
    (64, 197, 1024, 2048, [(128, 64, 99, 48, 1), (128, 128, 99, 8, 8), (128, 64, 99, 32, 1),
                           (128, 128, 99, 8, 8)]),
    (8, 77, 1024, 2048, [(64, 64, 10, 48, 1), (64, 128, 10, 8, 8), (64, 64, 10, 32, 1),
                         (64, 128, 10, 8, 8)]),
    (8, 77, 64, 64, [(64, 64, 10, 3, 1), (64, 64, 10, 1, 1), (64, 64, 10, 1, 1),
                     (64, 64, 10, 1, 1)]),
])
def test_layer_plan_tiles_and_clusters(b, s, d, f, want):
    """The plan the int8 launcher takes, (bm, bn, grid x, grid y, cluster)
    a launch: 64-row tiles and 64-column slices at the serving M = 77 and
    616 with LayerNorm clusters of D / 64 = 8; 128-row tiles at the DDPM
    chain's M = 12608, 64 columns wide but LN2's (128, a cluster of 4), so
    LN1 is a cluster of 8; a row wider than 8 x 64 (D = 1024) takes BN = 128
    in a cluster of 8; D = 64 one block a row."""
    plans = fe.int8_layer_plan(b, s, d, f, SMS)
    assert [(p["bm"], p["bn"], p["gx"], p["gy"], p["cluster"]) for p in plans] == want
    for p in plans:
        assert p["threads"] == p["bm"] // 64 * 128 + 32 and p["smem"] <= 227 * 1024
    # a LayerNorm launch holds two [8][BM] fp32 slot arrays beside its ring
    if plans[0]["bn"] == plans[1]["bn"]:
        assert plans[1]["smem"] - plans[0]["smem"] == 2 * 8 * plans[1]["bm"] * 4


def _blockwise_codes(h: torch.Tensor, bn: int) -> tuple:
    """Row codes as the LayerNorm 1 cluster computes h1's: each block of bn
    columns takes its largest |h|, the row's maximum is the largest of the
    blocks' (in rank order, though any order gives the same bits), then the
    scale max / 127 (true division) and each block codes its own columns."""
    blocks = h.split(bn, dim=-1)
    amax = blocks[0].abs().amax(-1, keepdim=True)
    for blk in blocks[1:]:
        amax = torch.maximum(amax, blk.abs().amax(-1, keepdim=True))
    s = torch.clamp_min(amax / amax.new_tensor(127.0), 1e-8)
    q = torch.cat([torch.clamp(torch.round(blk / s), -127, 127) for blk in blocks], -1)
    return q.to(torch.int8), s


@pytest.mark.parametrize("f, bn", [(1024, 128), (512, 64), (64, 64), (384, 128)])
def test_cluster_row_codes_equal_quant_rows(f, bn):
    """h1's codes from the LayerNorm 1 cluster's blockwise maxima (D / BN
    blocks of BN columns: 8 x 128 at D = 1024, 8 x 64 at 512, 1 x 64 at 64,
    3 x 128 at 384) equal quant_rows of the whole row bit for bit: an
    all-zero row (scale 1e-8, codes 0), a row whose maximum sits in the last
    block, and exact .5 ties (round half to even)."""
    rs = np.random.RandomState(f + bn)
    h = torch.from_numpy(rs.randn(6, f).astype(np.float32))
    h[0] = 0.0
    h[1, -1] = 9.0  # the maximum in the last block
    h[2] = torch.from_numpy(rs.randint(-254, 255, f).astype(np.float32) / 2)
    h[2, 0] = 127.0  # scale 1: every odd half-integer a tie
    got_q, got_s = _blockwise_codes(h, bn)
    want_q, want_s = fe.quant_rows(h)
    assert torch.equal(got_q, want_q) and torch.equal(got_s.view(torch.int32),
                                                      want_s.view(torch.int32))
    assert bool((want_q[0] == 0).all()) and float(want_s[0]) == pytest.approx(1e-8)
    assert torch.equal(want_q[2, 1:].float(), torch.round(h[2, 1:]))  # ties to even


@pytest.mark.parametrize("k", [64, 192, 512, 1024])
def test_int8_dot_is_independent_of_the_k_tiling(k):
    """The kernels sum int8 products over stages of 128 k values (a last half
    stage of TMA's zeros where K is not a multiple of 128) into int32; the
    sum is exact, so adding the stages' partial sums gives int8_dot's one
    product bit for bit, and the dequantised values (the q, k and v planes
    the card checks) cannot depend on the tiling."""
    rs = np.random.RandomState(k)
    h = torch.from_numpy(rs.randn(37, k).astype(np.float32)).bfloat16().float()
    wq, ws = fe.quantize_weight(torch.from_numpy(rs.randn(96, k).astype(np.float32)))
    b = torch.from_numpy(rs.randn(96).astype(np.float32))
    q, s = fe.quant_rows(h)
    acc = torch.zeros(37, 96, dtype=torch.int32)
    for k0 in range(0, k, 128):
        stage = torch.zeros(37, 128, dtype=torch.int64), torch.zeros(96, 128, dtype=torch.int64)
        n = min(128, k - k0)
        stage[0][:, :n], stage[1][:, :n] = q[:, k0:k0 + n], wq[:, k0:k0 + n]
        acc += (stage[0] @ stage[1].t()).to(torch.int32)
    got = acc.float() * s * ws + b
    want = fe.int8_dot(h, wq, ws, b)
    assert torch.equal(got.view(torch.int32), want.view(torch.int32))


@pytest.mark.parametrize("d, h", [(128, 4), (64, 1)])
def test_qkv_planes_match_jax_int8_dot(d, h):
    """The q, k and v planes the wrapper returns with return_qkv (on the CPU
    int8_qkv_reference's) are the JAX package's _int8_dot of the same bf16
    input and weight codes, split into q * 1/sqrt(dh), k and v and rounded
    to bf16, bit for bit; the layer's output is the twin's."""
    rs = np.random.RandomState(d)
    b, s = 2, 13
    x = torch.from_numpy(rs.randn(b, s, d).astype(np.float32)).bfloat16()
    params = {"in_proj_weight": rs.randn(3 * d, d) * d ** -0.5, "in_proj_bias": rs.randn(3 * d),
              "out_proj_weight": rs.randn(d, d) * d ** -0.5, "out_proj_bias": rs.randn(d),
              "linear1_weight": rs.randn(2 * d, d) * d ** -0.5, "linear1_bias": rs.randn(2 * d),
              "linear2_weight": rs.randn(d, 2 * d) * (2 * d) ** -0.5, "linear2_bias": rs.randn(d),
              "norm1_weight": 1 + 0.1 * rs.randn(d), "norm1_bias": 0.1 * rs.randn(d),
              "norm2_weight": 1 + 0.1 * rs.randn(d), "norm2_bias": 0.1 * rs.randn(d)}
    p8 = fe.quantize_layer_params({k: torch.from_numpy(v.astype(np.float32))
                                   for k, v in params.items()})
    out, planes = fe.fused_encoder_layer_int8(x, p8, h, return_qkv=True)
    assert torch.equal(out, fe.fused_encoder_layer_int8_reference(x, p8, h))
    assert planes.shape == (3, b * s, d) and planes.dtype == torch.bfloat16
    qkv = np.asarray(jint8_dot(jnp.asarray(x.float().numpy().reshape(b * s, d)),
                               jnp.asarray(p8["in_proj_weight"].numpy().T),
                               jnp.asarray(p8["in_proj_scale"].numpy()[None]),
                               jnp.asarray(p8["in_proj_bias"].numpy()[None])))
    want = np.stack([qkv[:, :d] * np.float32(1.0 / math.sqrt(d // h)), qkv[:, d:2 * d],
                     qkv[:, 2 * d:]])
    want = torch.from_numpy(np.ascontiguousarray(want)).bfloat16()
    assert torch.equal(planes.view(torch.int16), want.view(torch.int16))
