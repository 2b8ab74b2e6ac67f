"""chip_smoke.py's helpers for the training forwards (kernels 5 and 8) on
their shared wgmma GEMM and the tensor-core attention: the per-launch work
the smoke sets beside each launch's device time, the build log's registers
and spills of the new GEMM kernels, and the probabilities twin the smoke
holds kernel 8's stored p to. The kernels themselves run only on the card
(chip_smoke.py's train_kernel phase).
"""
import numpy as np
import pytest
import torch

import chip_smoke
from motionstyle_torch.ops import fused_encoder_train as ft
from motionstyle_torch.ops.fused_encoder import additive_key_mask, pack
from tests.test_torch_models import one_torch_thread  # noqa: F401


def _intermediates(b, s, d, f, store):
    """Bytes the five launches move that the forward as one function does
    not: the second read of x (qkv and LN1's residual) and, each written by
    one launch and read by the next, q*scale, k and v (kernel 8 reads k and v
    out of its stored qkv), attn's read by LN1, h1 in fp32 and bf16, g."""
    m = b * s
    qkv_between = (m * d * 2 * 2 + 2 * m * d * 2) if store else 2 * 3 * m * d * 2
    return (m * d * 2 + qkv_between + m * d * 2 + 2 * m * d * 4 + 2 * m * d * 2
            + 2 * m * f * 2)


@pytest.mark.parametrize("store", [False, True])
@pytest.mark.parametrize("b, s, d, h, f", [(64, 77, 512, 4, 1024), (1, 77, 512, 4, 1024),
                                           (16, 197, 384, 6, 1536), (3, 1, 1024, 8, 2048)])
def test_train_gemm_bounds_split_the_forward(b, s, d, h, f, store):
    """train_gemm_bounds' five launches do train_bounds' forward operations
    exactly, and move its bytes plus each intermediate written once and read
    once; at B=64, S=77 the GEMMs are 7.75 / 2.58 / 5.17 / 5.17 GFLOP."""
    launches = chip_smoke.train_gemm_bounds(b, s, d, h, f, masked=True, store=store)
    name = "fused_layer_train_forward_store" if store else "fused_layer_train_forward"
    _, _, flops, nbytes = chip_smoke.train_bounds(b, s, d, h, f, masked=True)[name]
    assert len(launches) == len(chip_smoke.TRAIN_LAUNCHES) == 5
    assert sum(fl for fl, _ in launches) == flops
    assert sum(nb for _, nb in launches) == nbytes + _intermediates(b, s, d, f, store)
    if (b, s) == (64, 77):
        assert [round(fl / 1e9, 2) for fl, _ in [launches[0]] + launches[2:]] == [
            7.75, 2.58, 5.17, 5.17]
    # masks mode reads one bf16 mask element for each element of a site
    unmasked = chip_smoke.train_gemm_bounds(b, s, d, h, f, masked=False, store=store)
    masks = b * s * (2 * d + f) * 2
    assert sum(nb for _, nb in launches) - sum(nb for _, nb in unmasked) == masks


def test_train_gemm_registers_read_from_the_build_log(tmp_path, capsys):
    """The build phase reads the training forwards' GEMM kernels (their
    dropout site's prng mode a third template argument) beside kernel 1's."""
    prefix = "_ZN49_GLOBAL__N__b0_16_fused_encoder_train_cu_5aa43aa6"
    names = [f"{prefix}14ln1_train_gemmILi128ELi128ELb1EEEv14CUtensorMap_st",
             f"{prefix}20qkv_store_train_gemmILi64ELi64EEEv14CUtensorMap_st",
             f"{prefix}17ffn_up_train_gemmILi64ELi64ELb0EEEv14CUtensorMap_st",
             f"{prefix}8ln2_gemmILi64ELi128EEEv14CUtensorMap_st"]
    log = ""
    for i, fn in enumerate(names):
        log += (f"ptxas info    : Compiling entry function '{fn}' for 'sm_90a'\n"
                f"ptxas info    : Function properties for {fn}\n"
                f"    0 bytes stack frame, {4 * i} bytes spill stores, {2 * i} bytes spill loads\n"
                f"ptxas info    : Used {100 + i} registers, used 1 barriers\n")
    (tmp_path / "lib.log").write_text(log)
    chip_smoke.print_gemm_registers(str(tmp_path / "lib.so"))
    assert capsys.readouterr().out.splitlines() == [
        "  ln1_train_gemm<128, 128, true>: 100 registers, 0 B spill stores, 0 B spill loads",
        "  qkv_store_train_gemm<64, 64>: 101 registers, 4 B spill stores, 2 B spill loads",
        "  ffn_up_train_gemm<64, 64, false>: 102 registers, 8 B spill stores, 4 B spill loads",
        "  ln2_gemm<64, 128>: 103 registers, 12 B spill stores, 6 B spill loads"]


@pytest.mark.parametrize("b, s, d, h, f, masked", [(2, 9, 64, 4, 128, False),
                                                   (2, 9, 64, 4, 128, True),
                                                   (1, 257, 64, 1, 64, False),
                                                   (2, 300, 128, 2, 64, True)])
def test_probs_twin_equals_the_store_twin(b, s, d, h, f, masked):
    """The probabilities the smoke holds kernel 8's stored p to (its
    attention launch's, on the short register path and the tiled one past
    S = 256) are bit for bit those of the store forward's twin."""
    rs = np.random.RandomState(s + d)
    gen = torch.Generator().manual_seed(s)
    p = pack(chip_smoke.random_params(gen, d, f))
    x = torch.from_numpy(rs.randn(b, s, d).astype(np.float32)).bfloat16()
    kmask = None
    if masked:
        kpm = torch.ones(b, s, dtype=torch.bool)
        kpm[-1, s // 2:] = False
        kmask = additive_key_mask(kpm, b, s, x.device)
    want = ft.fused_layer_train_forward_store_reference(x, p, h, kmask)[3]
    got = chip_smoke.probs_twin(x, p, h, kmask)
    assert got.dtype == torch.bfloat16 and got.shape == (b, h, s, s)
    assert torch.equal(got, want)
    assert torch.allclose(got.float().sum(-1), torch.ones(b, h, s), atol=s * 2 ** -8)
