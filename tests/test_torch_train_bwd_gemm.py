"""The training backward halves (kernels 6, 7 and 9) on the shared wgmma GEMM:
chip_smoke.py's per-launch work beside each launch's device time, the plan's
weight-gradient slices and the partial buffers the wrappers size from the
plan's plain mirror, and the order in which the kernels add a weight
gradient's slices. The kernels themselves run only on the card
(chip_smoke.py's train_kernel phase, which also holds the C launcher's plan
to the mirror tested here).
"""
import numpy as np
import pytest
import torch

import chip_smoke
from motionstyle_torch.ops import fused_encoder_train as ft
from tests.test_torch_models import one_torch_thread  # noqa: F401

SMS = 132  # an H100 SXM's streaming multiprocessors


@pytest.mark.parametrize("b, s, d, h, f", [(64, 77, 512, 4, 1024), (1, 77, 512, 4, 1024),
                                           (16, 197, 384, 6, 1536), (3, 1, 1024, 8, 2048),
                                           (8, 77, 64, 1, 64)])
def test_train_bwd_gemm_bounds_split_the_backward(b, s, d, h, f):
    """train_bwd_gemm_bounds' launches of kernels 6, 7 and 9 do exactly
    train_bounds' operations of each kernel, one (flops, bytes) pair a
    launch of TRAIN_BWD_LAUNCHES; at B=64, S=77 kernel 6's six GEMMs are
    5.17 GFLOP each."""
    for masked in (True, False):
        launches = chip_smoke.train_bwd_gemm_bounds(b, s, d, h, f, masked)
        bounds = chip_smoke.train_bounds(b, s, d, h, f, masked)
        for name, names in chip_smoke.TRAIN_BWD_LAUNCHES.items():
            assert len(launches[name]) == len(names)
            assert sum(fl for fl, _ in launches[name]) == bounds[name][2]
            assert all(nb > 0 for _, nb in launches[name])
    ffn = chip_smoke.train_bwd_gemm_bounds(b, s, d, h, f)["fused_layer_train_bwd_ffn"]
    if (b, s) == (64, 77):
        assert [round(fl / 1e9, 2) for fl, _ in ffn[1:7]] == [5.17] * 6
    # masks mode reads sites 1 and 2 in kernel 6 (site 1 twice) and site 0 in 7 and 9
    unmasked = chip_smoke.train_bwd_gemm_bounds(b, s, d, h, f, masked=False)
    masked = chip_smoke.train_bwd_gemm_bounds(b, s, d, h, f, masked=True)
    extra = {n: sum(nb for _, nb in masked[n]) - sum(nb for _, nb in unmasked[n]) for n in masked}
    m = b * s
    assert extra == {"fused_layer_train_bwd_ffn": m * (2 * f + d) * 2,
                     "fused_layer_train_bwd_attn": m * d * 2,
                     "fused_layer_train_bwd_attn_stored": m * d * 2}


def test_backward_plan_at_the_training_shape():
    """At B=64, S=77 (M = 4928) every backward GEMM takes 128 x 128 tiles,
    the LayerNorm launches are clusters of 4, and the weight gradients cut M
    into 4 (dW2, dW1: 32 tiles), 2 (dWqkv: 48) and 8 (dWo: 16) slices; at the
    finetune's B=1 (M = 77) 64-row tiles, clusters of 8 and one slice."""
    plan = dict(zip(ft.BACKWARD_GEMMS, ft.backward_plan(64, 77, 512, 1024, SMS)))
    assert {(p["bm"], p["bn"]) for p in plan.values()} == {(128, 128)}
    assert [plan[n]["cluster"] for n in ("ln2_bwd_gemm", "ln1_bwd_gemm")] == [4, 4]
    assert [plan[n]["split"] for n in ("dw2_gemm", "dw1_gemm", "dwqkv_gemm", "dwo_gemm")] == [
        4, 4, 2, 8]
    assert plan["up_bwd_gemm"]["gx"] == 39 and plan["up_bwd_gemm"]["gy"] == 8
    small = dict(zip(ft.BACKWARD_GEMMS, ft.backward_plan(1, 77, 512, 1024, SMS)))
    assert {(p["bm"], p["bn"]) for p in small.values()} == {(64, 64)}
    assert small["ln2_bwd_gemm"]["cluster"] == 8 and small["ln2_bwd_gemm"]["gx"] == 2
    assert {p["split"] for p in small.values()} == {1}


@pytest.mark.parametrize("b", [1, 3, 64])
@pytest.mark.parametrize("s", [1, 77, 300])
@pytest.mark.parametrize("sms", [SMS, 114])
def test_partial_buffers_cover_the_plan(b, s, sms):
    """The partial buffers the wrappers allocate (backward_partial_floats)
    hold every block's column sums and every weight gradient's slices at the
    layout the C launchers use (R = ceil(M / 64) rows a column-sum slot, the
    slices after them), and no plan has an empty slice or more than 8 (the
    last pass adds them in slice order, one warp each)."""
    d, f = 512, 1024
    m, rows = b * s, -(-b * s // 64)
    plan = dict(zip(ft.BACKWARD_GEMMS, ft.backward_plan(b, s, d, f, sms)))
    for name in ("up_bwd_gemm", "ln2_bwd_gemm", "du_bwd_gemm", "ln1_bwd_gemm"):
        assert plan[name]["gx"] <= rows
    for name in ("dw2_gemm", "dw1_gemm", "dwqkv_gemm", "dwo_gemm"):
        nk, split = -(-m // 64), plan[name]["split"]
        per = -(-nk // split)
        assert 1 <= split <= 8 and (split - 1) * per < nk
    ffn, attn = ft.backward_partial_floats(b, s, d, f, sms)

    def slices(name, p, q):
        split = plan[name]["split"]
        return split * p * q if split > 1 else 0

    column_sums = (3 * plan["ln2_bwd_gemm"]["gx"] * d + plan["du_bwd_gemm"]["gx"] * f
                   + 2 * plan["ln1_bwd_gemm"]["gx"] * d)
    assert column_sums <= rows * (5 * d + f)
    assert ffn == rows * (5 * d + f) + slices("dw2_gemm", d, f) + slices("dw1_gemm", f, d)
    assert attn == slices("dwqkv_gemm", 3 * d, d) + slices("dwo_gemm", d, d)


@pytest.mark.parametrize("m, split", [(4928, 4), (4928, 8), (4928, 2), (300, 2), (77, 1)])
def test_weight_grad_slices_match_one_product(m, split):
    """The weight gradient as the kernels add it (fp32 slices of whole
    64-row k steps, summed in slice order) against the one-product twin of
    bwd_ffn_reference / _bwd_attn_half, on bf16-valued operands: the two
    differ only in the order of their fp32 sums, rel L2 <= 1e-6 and max abs
    <= 1e-5 of the largest entry. Splits are the plan's at B=64, S=77 (dW1
    and dW2: 4, dWo: 8, dWqkv: 2) and at M not a multiple of 64."""
    rs = np.random.RandomState(m + split)
    x = torch.from_numpy(rs.randn(m, 64).astype(np.float32)).bfloat16()
    y = torch.from_numpy(rs.randn(m, 96).astype(np.float32)).bfloat16()
    want = x.float().t() @ y.float()
    got = ft.weight_grad_slices_reference(x, y, split)
    assert got.dtype == torch.float32 and got.shape == (64, 96)
    assert float((got - want).norm() / want.norm()) <= 1e-6
    assert float((got - want).abs().max()) <= 1e-5 * float(want.abs().max())
    if split == 1:
        assert torch.equal(got, want)
