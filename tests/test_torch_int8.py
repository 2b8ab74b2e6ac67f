"""The int8 serving layer (kernel 2): the port's quantizers and the int8
layer's plain PyTorch twin against the JAX package's Pallas int8 kernel
(interpret mode on the CPU, as tests/test_fused_encoder.py runs it), the
module's and the model's int8 arms, and the wrapper's CPU behaviour. The CUDA
kernel itself is held against the twin on the card by chip_smoke.py.

Weights come from numpy seeds and cross over with from_jax_params /
encoder_from_jax. Bounds against the Pallas kernel, on fp32 outputs: max abs
3e-2 and rel L2 1e-2. Both sides quantize the same values with the same
rounding points, but the fp32 sums that feed a quantizer run in other orders,
so a value that sits on a code boundary can land one code apart (a ±1 flip
moves that product by one scale step) and carry into the next layer.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from motionstyle.models.transformer import TransformerEncoder as JEncoder
from motionstyle.ops.fused_encoder import _quant_rows as jquant_rows
from motionstyle.ops.fused_encoder import fused_encoder as jfused_encoder
from motionstyle.ops.fused_encoder import fused_encoder_layer_int8 as jfused_layer_int8
from motionstyle.ops.fused_encoder import quantize_weight as jquantize_weight
from motionstyle_torch.models.params import encoder_from_jax
from motionstyle_torch.models.transformer import TransformerEncoder
from motionstyle_torch.ops import fused_encoder as fe
from tests.test_torch_models import (  # noqa: F401
    denoiser_inputs, numpy_params, one_torch_thread, style_pair)

MAX_ABS, REL_L2 = 3e-2, 1e-2
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


def _check(got: np.ndarray, want: np.ndarray):
    err = float(np.abs(got - want).max())
    rel = float(np.linalg.norm(got - want) / np.linalg.norm(want))
    assert err <= MAX_ABS and rel <= REL_L2, (err, rel)


def _int8_params(port: TransformerEncoder, i: int = 0) -> dict:
    return fe.quantize_layer_params(fe.layer_params(port.layers[i]))


def test_quantize_weight_is_bit_equal_to_jax():
    """Codes and scales of the (out, in) weight equal the JAX package's on
    its (in, out) kernel, transposed, bit for bit; a zero channel included."""
    rs = np.random.RandomState(0)
    kernel = (rs.randn(96, 160) * 0.3).astype(np.float32)  # flax (in, out)
    kernel[:, 5] = 0.0
    kernel[3, 7] = 2.5  # a large entry sets channel 7's scale
    jq, js = jquantize_weight(jnp.asarray(kernel))
    q, s = fe.quantize_weight(torch.from_numpy(kernel.T.copy()))
    assert q.dtype == torch.int8 and s.dtype == torch.float32
    assert q.shape == (160, 96) and s.shape == (160,)
    np.testing.assert_array_equal(q.numpy(), np.asarray(jq).T)
    np.testing.assert_array_equal(s.numpy(), np.asarray(js)[0])


def test_row_codes_equal_jax_with_a_zero_row_and_ties():
    """Row codes and scales equal _quant_rows's: an all-zero row (scale
    1e-8, codes 0) and exact .5 ties, rounded half to even."""
    rs = np.random.RandomState(1)
    h = (rs.randn(6, 64) * 2.0).astype(np.float32)
    h[1] = 0.0
    # max 127 gives the scale 1.0 exactly, max 254 the scale 2.0: every
    # entry below is an exact tie between two codes
    h[2, :8] = [127.0, 0.5, 1.5, 2.5, -0.5, -1.5, -2.5, 126.5]
    h[2, 8:] = 0.0
    h[3, :6] = [254.0, 1.0, 3.0, 5.0, -3.0, -253.0]
    h[3, 6:] = 0.0
    jq, js = jquant_rows(jnp.asarray(h))
    q, s = fe.quant_rows(torch.from_numpy(h))
    np.testing.assert_array_equal(q.numpy(), np.asarray(jq))
    np.testing.assert_array_equal(s.numpy(), np.asarray(js))
    assert q[1].abs().max() == 0 and float(s[1, 0]) == np.float32(1e-8)
    assert q[2, :8].tolist() == [127, 0, 2, 2, 0, -2, -2, 126]
    assert q[3, :6].tolist() == [127, 0, 2, 2, -2, -126]


@pytest.mark.parametrize("masked", [False, True])
def test_twin_matches_pallas_int8_layer(masked):
    params, port = _pair(1, seed=1)
    x, kpm = _inputs(2, masked)
    want = jfused_layer_int8(jnp.asarray(x), params["layers_0"], H,
                             None if kpm is None else jnp.asarray(kpm))
    got = fe.fused_encoder_layer_int8(torch.from_numpy(x), _int8_params(port), H,
                                      None if kpm is None else torch.from_numpy(kpm))
    assert got.dtype == torch.float32 and got.shape == (B, S, D)
    _check(got.numpy(), np.asarray(want))


@pytest.mark.parametrize("masked", [False, True])
def test_int8_stack_matches_pallas_int8_stack(masked):
    """The encoder module's int8 arm (quantized once, cached) against the
    JAX int8 stack, bf16 in and out as the model runs it."""
    params, port = _pair(2, seed=3)
    x, kpm = _inputs(4, masked)
    want = jfused_encoder(jnp.asarray(x, jnp.bfloat16), params, 2, H,
                          None if kpm is None else jnp.asarray(kpm), int8=True)
    with torch.no_grad():
        got = port(torch.from_numpy(x).bfloat16(),
                   None if kpm is None else torch.from_numpy(kpm), use_fused=True,
                   use_int8=True)
    assert got.dtype == torch.bfloat16
    _check(got.float().numpy(), np.asarray(want.astype(jnp.float32)))


def test_style_diffusion_int8_matches_jax():
    """StyleDiffusion with quant_int8 (fp32 around the layers, the config's
    default) against the JAX model with the same flag and weights."""
    kw = dict(latent_dim=128, ff_size=256, quant_int8=True)
    jmodel, params, port = style_pair(5, **kw)
    assert port.cfg.quant_int8
    x, t, enc = denoiser_inputs(6)
    want = np.asarray(jmodel.apply(params, jnp.asarray(x), jnp.asarray(t), jnp.asarray(enc)))
    with torch.no_grad():
        got = port(torch.from_numpy(x), torch.from_numpy(t), torch.from_numpy(enc)).numpy()
    _check(got, want)


def test_twin_tracks_the_fp32_encoder():
    """The int8 twin against the port's fp32 encoder, at the JAX package's
    bounds for its int8 kernel against its fp32 encoder
    (tests/test_fused_encoder.py::test_int8_matches_xla_encoder)."""
    _, port = _pair(2, seed=7)
    x = torch.from_numpy(np.random.RandomState(8).randn(B, S, D).astype(np.float32) * 0.5)
    with torch.no_grad():
        ref = port(x).numpy()
        got = port(x, use_fused=True, use_int8=True).numpy()
    corr = np.corrcoef(got.ravel(), ref.ravel())[0, 1]
    rel = np.abs(got - ref).mean() / np.abs(ref).mean()
    assert corr > 0.999 and rel < 0.05, (corr, rel)


def test_cpu_tensors_use_the_twin_and_count_no_launch():
    _, port = _pair(1, seed=9)
    x = torch.from_numpy(_inputs(10, False)[0]).bfloat16()
    p = _int8_params(port)
    before = fe.fused_encoder_layer_int8.launches
    got = fe.fused_encoder_layer_int8(x, p, H)
    assert fe.fused_encoder_layer_int8.launches == before
    assert got.dtype == torch.bfloat16
    torch.testing.assert_close(got, fe.fused_encoder_layer_int8_reference(x, p, H),
                               rtol=0, atol=0)
    with pytest.raises(ValueError, match="cuda or cpu"):
        fe.fused_encoder_layer_int8(torch.empty(B, S, D, device="meta"), p, H)


def test_quantized_params_layout_and_input_checks():
    _, port = _pair(1, seed=11)
    p = _int8_params(port)
    assert set(p) == set(fe.WEIGHT_KEYS) | set(fe.SCALE_KEYS) | set(fe.VECTOR_KEYS)
    for k, t in p.items():
        assert t.is_contiguous() and not t.requires_grad
        assert t.dtype == (torch.int8 if k in fe.WEIGHT_KEYS else torch.float32)
    assert p["in_proj_weight"].shape == (3 * D, D) and p["in_proj_scale"].shape == (3 * D,)
    assert p["linear2_weight"].shape == (D, F) and p["linear2_scale"].shape == (D,)
    x = torch.zeros(B, S, D, dtype=torch.bfloat16)
    assert fe._check_cuda_inputs(x, p, H, int8=True) == (B, S, D, F)
    with pytest.raises(ValueError):  # bf16 weights are kernel 1's, not this kernel's
        fe._check_cuda_inputs(x, fe.pack_layer_params(port.layers[0]), H, int8=True)
    with pytest.raises(ValueError):
        fe._check_cuda_inputs(x, {**p, "linear1_scale": p["linear1_scale"][:-1]}, H, int8=True)


def test_int8_layers_follow_parameter_updates():
    """The module quantizes once from its fp32 parameters and again after a
    parameter changes in place; the bf16 packing is cached apart."""
    _, port = _pair(1, seed=12)
    first = port.packed_layers(int8=True)
    assert all(a is b for a, b in zip(port.packed_layers(int8=True), first))
    assert port.packed_layers()[0]["linear1_weight"].dtype == torch.bfloat16
    with torch.no_grad():
        port.layers[0].linear1.weight.mul_(2.0)
    second = port.packed_layers(int8=True)
    assert second[0] is not first[0]
    torch.testing.assert_close(second[0]["linear1_weight"], first[0]["linear1_weight"],
                               rtol=0, atol=0)  # the codes are scale-free
    torch.testing.assert_close(second[0]["linear1_scale"], first[0]["linear1_scale"] * 2.0)


def test_int8_inference_refuses_grad():
    _, port = _pair(1, seed=13)
    x = torch.from_numpy(_inputs(14, False)[0]).bfloat16()
    with pytest.raises(RuntimeError, match="fused_train"):
        port(x, use_fused=True, use_int8=True)
    with torch.no_grad():
        out = port(x.requires_grad_(True), use_fused=True, use_int8=True)
    assert out.shape == x.shape and not out.requires_grad
