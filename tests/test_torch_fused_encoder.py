"""The fused encoder layer's plain PyTorch twin vs the JAX package's Pallas
kernel (interpret mode on the CPU, as tests/test_fused_encoder.py runs it),
and the wrapper's CPU behaviour. The CUDA kernel itself is held against the
twin on the card by chip_smoke.py.

Tolerance atol 2e-2 on bf16 outputs: both sides round the same operands to
bf16 but sum in different orders, so an output can land one bf16 ulp apart
(7.8e-3 at |y| in [1, 2), 1.6e-2 in [2, 4)).
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from motionstyle.models.transformer import TransformerEncoder as JEncoder
from motionstyle.ops.fused_encoder import fused_encoder as jfused_encoder
from motionstyle.ops.fused_encoder import fused_encoder_layer as jfused_layer
from motionstyle_torch.models.params import encoder_from_jax
from motionstyle_torch.models.transformer import TransformerEncoder
from motionstyle_torch.ops import fused_encoder as fe
from tests.test_torch_models import one_torch_thread, numpy_params  # noqa: F401

ATOL = 2e-2
B, S, D, H, F = 2, 13, 128, 4, 256


def _pair(layers: int, seed: int):
    """(JAX encoder params, port encoder) with the same numpy weights."""
    x0 = jnp.zeros((1, S, D))
    params = numpy_params(JEncoder(layers, D, H, F, 0.1).init(jax.random.PRNGKey(0), x0), seed)
    port = TransformerEncoder(layers, D, H, F)
    port.load_state_dict(encoder_from_jax(params["params"]))
    return params["params"], port


def _inputs(seed: int, masked: bool):
    rs = np.random.RandomState(seed)
    x = rs.randn(B, S, D).astype(np.float32)
    kpm = np.ones((B, S), bool)
    if masked:
        kpm[1, 7:] = False
    return x, (kpm if masked else None)


@pytest.mark.parametrize("dtype", ["bfloat16", "float32"])
@pytest.mark.parametrize("masked", [False, True])
def test_twin_matches_pallas_layer(masked, dtype):
    params, port = _pair(1, seed=1)
    x, kpm = _inputs(2, masked)
    jx = jnp.asarray(x, dtype=jnp.dtype(dtype))
    want = jfused_layer(jx, params["layers_0"], H,
                        None if kpm is None else jnp.asarray(kpm))
    tx = torch.from_numpy(x).to(getattr(torch, dtype))
    got = fe.fused_encoder_layer(tx, fe.pack_layer_params(port.layers[0]), H,
                                 None if kpm is None else torch.from_numpy(kpm))
    assert got.dtype == tx.dtype and got.shape == tx.shape
    np.testing.assert_allclose(got.float().numpy(),
                               np.asarray(want.astype(jnp.float32)), atol=ATOL)


@pytest.mark.parametrize("masked", [False, True])
def test_fused_stack_matches_pallas_stack(masked):
    """The encoder module's fused arm against the JAX fused stack."""
    params, port = _pair(2, seed=3)
    x, kpm = _inputs(4, masked)
    want = jfused_encoder(jnp.asarray(x, jnp.bfloat16), params, 2, H,
                          None if kpm is None else jnp.asarray(kpm))
    with torch.no_grad():
        got = port(torch.from_numpy(x).bfloat16(),
                   None if kpm is None else torch.from_numpy(kpm), use_fused=True)
    assert got.dtype == torch.bfloat16
    np.testing.assert_allclose(got.float().numpy(),
                               np.asarray(want.astype(jnp.float32)), atol=ATOL)


def test_padded_keys_do_not_leak():
    """Changing masked-out tokens leaves the valid rows unchanged."""
    _, port = _pair(1, seed=5)
    x, kpm = _inputs(6, True)
    x2 = x.copy()
    x2[1, 7:] = 99.0
    p = fe.pack_layer_params(port.layers[0])
    a = fe.fused_encoder_layer(torch.from_numpy(x).bfloat16(), p, H, torch.from_numpy(kpm))
    b = fe.fused_encoder_layer(torch.from_numpy(x2).bfloat16(), p, H, torch.from_numpy(kpm))
    torch.testing.assert_close(a[1, :7], b[1, :7], rtol=0, atol=0)


def test_cpu_tensors_use_the_twin_and_count_no_launch():
    _, port = _pair(1, seed=7)
    x = torch.from_numpy(_inputs(8, False)[0]).bfloat16()
    p = fe.pack_layer_params(port.layers[0])
    before = fe.fused_encoder_layer.launches
    got = fe.fused_encoder_layer(x, p, H)
    assert fe.fused_encoder_layer.launches == before
    torch.testing.assert_close(got, fe.fused_encoder_layer_reference(x, p, H),
                               rtol=0, atol=0)


def test_other_devices_raise():
    _, port = _pair(1, seed=9)
    p = fe.pack_layer_params(port.layers[0])
    with pytest.raises(ValueError, match="cuda or cpu"):
        fe.fused_encoder_layer(torch.empty(B, S, D, device="meta"), p, H)


def test_pack_layer_params_layout():
    _, port = _pair(1, seed=10)
    p = fe.pack_layer_params(port.layers[0])
    assert set(p) == set(fe.WEIGHT_KEYS) | set(fe.VECTOR_KEYS)
    for k, t in p.items():
        assert t.is_contiguous()
        assert t.dtype == (torch.bfloat16 if k in fe.WEIGHT_KEYS else torch.float32)
    assert p["in_proj_weight"].shape == (3 * D, D)
    assert p["linear2_weight"].shape == (D, F)


@pytest.mark.parametrize("bad", ["dtype", "shape", "heads", "seq"])
def test_kernel_input_checks(bad):
    """What the CUDA launcher does not take is refused before a launch."""
    _, port = _pair(1, seed=11)
    p = fe.pack_layer_params(port.layers[0])
    x = torch.zeros(B, S, D, dtype=torch.bfloat16)
    heads = H
    if bad == "dtype":
        p["in_proj_weight"] = p["in_proj_weight"].float()
    elif bad == "shape":
        p["linear1_bias"] = p["linear1_bias"][:-1]
    elif bad == "heads":
        heads = 16  # head width 8: not a multiple of 16
    else:
        x = torch.zeros(B, 0, D, dtype=torch.bfloat16)  # any S >= 1 runs
    with pytest.raises(ValueError):
        fe._check_cuda_inputs(x, p, heads)


def test_packed_layers_follow_parameter_updates():
    _, port = _pair(1, seed=12)
    first = port.packed_layers()
    assert all(a is b for a, b in zip(port.packed_layers(), first))
    with torch.no_grad():
        port.layers[0].linear1.weight.mul_(2.0)
    second = port.packed_layers()
    assert second[0] is not first[0]
    torch.testing.assert_close(second[0]["linear1_weight"].float(),
                               (first[0]["linear1_weight"].float() * 2.0))


def test_inference_layer_refuses_inputs_that_need_a_gradient():
    """The inference kernel has no backward, as the JAX package's pallas_call
    has no VJP: a forward autograd would differentiate raises, naming the
    training path, instead of losing its gradient. Under no_grad it runs."""
    _, port = _pair(1, seed=13)
    p = fe.pack_layer_params(port.layers[0])
    x = torch.from_numpy(_inputs(14, False)[0]).bfloat16()
    with pytest.raises(RuntimeError, match="fused_train"):
        fe.fused_encoder_layer(x.clone().requires_grad_(True), p, H)
    with pytest.raises(RuntimeError, match="fused_train"):
        fe.fused_encoder_layer(x, {**p, "linear1_bias": p["linear1_bias"].requires_grad_(True)}, H)
    with pytest.raises(RuntimeError, match="fused_train"):  # the module's packed copies
        port(x, use_fused=True)
    with torch.no_grad():
        out = port(x.requires_grad_(True), use_fused=True)
    assert out.shape == x.shape and not out.requires_grad


@pytest.mark.parametrize("b, s, d, f", [(64, 197, 512, 1024), (8, 77, 512, 1024),
                                        (3, 1, 1024, 2048)])
def test_gemm_launch_bounds_split_the_layer(b, s, d, f):
    """chip_smoke.py's per-launch GEMM work: with the attention products the
    four launches' operations are the layer's, and at the DDPM chain's shape
    they are 19.83 / 6.61 / 13.22 / 13.22 GFLOP over 53.2 / 65.1 / 39.8 /
    65.6 MB (each input read once, each output written once)."""
    import chip_smoke

    launches = chip_smoke.gemm_bounds(b, s, d, f)
    _, _, layer_flops, _ = chip_smoke.layer_bound(b, s, d, 4, f)
    assert sum(fl for fl, _ in launches) + 4 * b * s * s * d == layer_flops
    if (b, s) == (64, 197):
        assert [round(fl / 1e9, 2) for fl, _ in launches] == [19.83, 6.61, 13.22, 13.22]
        assert [round(nb / 1e6, 1) for _, nb in launches] == [53.2, 65.1, 39.8, 65.6]


def test_gemm_registers_read_from_the_build_log(tmp_path, capsys):
    """chip_smoke.py reads each GEMM kernel's registers and spills from the
    nvcc log that sits beside the built library."""
    import chip_smoke

    fn = "_ZN49_GLOBAL__N__b0_16_fused_encoder_cu_5aa43aa68ln2_gemmILi64ELi128EEEv14CUtensorMap_st"
    (tmp_path / "lib.log").write_text(
        f"ptxas info    : Compiling entry function '{fn}' for 'sm_90a'\n"
        f"ptxas info    : Function properties for {fn}\n"
        "    0 bytes stack frame, 8 bytes spill stores, 4 bytes spill loads\n"
        "ptxas info    : Used 116 registers, used 1 barriers\n")
    chip_smoke.print_gemm_registers(str(tmp_path / "lib.so"))
    assert capsys.readouterr().out.strip() == (
        "ln2_gemm<64, 128>: 116 registers, 8 B spill stores, 4 B spill loads")


@pytest.mark.parametrize("b, s, want", [
    (8, 77, [(64, 64, 10, 24, 1), (64, 64, 10, 8, 8), (64, 64, 10, 16, 1), (64, 64, 10, 8, 8)]),
    (16, 197, [(128, 128, 25, 12, 1), (64, 64, 50, 8, 8), (128, 128, 25, 8, 1),
               (64, 64, 50, 8, 8)]),
    (64, 197, [(128, 128, 99, 12, 1), (128, 128, 99, 4, 4), (128, 128, 99, 8, 1),
               (128, 128, 99, 4, 4)])])
def test_layer_plan_mirror(b, s, want):
    """Kernel 1's plan as its C launcher takes it on an H100's 132 SMs, (bm,
    bn, grid x, grid y, cluster) a launch (qkv, LN1, FFN-up, LN2): 64-row
    tiles and 64-column slices where 128 x 128 tiles would not fill the card
    (the serving M = 616, and the LayerNorm launches at the humanml demo's
    guided B=16, S=197), 128 x 128 where they do, a LayerNorm launch a
    cluster of its column tiles. chip_smoke.layer_plan_check holds the C
    launcher to it on the card."""
    plans = fe.layer_plan(b, s, 512, 1024, 132)
    assert [(p["bm"], p["bn"], p["gx"], p["gy"], p["cluster"]) for p in plans] == want
