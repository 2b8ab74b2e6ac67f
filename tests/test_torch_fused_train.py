"""The fused training layer's plain PyTorch twins (forward, FFN-half and
attention-half backward, joined by FusedLayerTrain) against the JAX
package's fused_encoder_layer_train, whose Pallas kernels run in interpret
mode on the CPU as tests/test_fused_train.py runs them. The CUDA kernels are
held against the same twins on the card by chip_smoke.py.

Shapes as tests/test_fused_train.py: B=3, S=9, D=32, F=64, H=4; the JAX side
pads S to 16, so the same numpy masks go to it padded and to the port sliced
to S. Gates: forward atol 2e-2 (bf16 matmul operands on both sides, sums in
other orders); every gradient leaf and dx within 3e-2 of the leaf's largest
magnitude, the gate tests/test_fused_train.py:75 holds the fused layer to.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from torch.utils.checkpoint import checkpoint

from motionstyle.models.transformer import TransformerEncoderLayer as JLayer
from motionstyle.ops.fused_encoder_train import fused_encoder_layer_train as jlayer_train
from motionstyle_torch.models.params import encoder_from_jax
from motionstyle_torch.models.transformer import TransformerEncoder
from motionstyle_torch.ops import fused_encoder as fe
from motionstyle_torch.ops import fused_encoder_train as ft
from tests.test_torch_models import one_torch_thread, numpy_params  # noqa: F401

B, S, D, F, H = 3, 9, 32, 64, 4
SP = 16
FWD_ATOL = 2e-2
GRAD_REL = 3e-2


def _loss(out):
    return (torch.sin(out) * torch.cos(out * 0.3)).sum()


def _jloss(out):
    return jnp.sum(jnp.sin(out) * jnp.cos(out * 0.3))


@pytest.fixture(scope="module")
def setup():
    r = np.random.RandomState(1)
    x = r.randn(B, S, D).astype(np.float32)
    kpm = np.concatenate([np.ones((B, 7)), np.zeros((B, 2))], 1).astype(bool)
    tree = JLayer(D, H, F, dropout=0.1).init(jax.random.PRNGKey(0), jnp.asarray(x))
    params = numpy_params(tree, 2)["params"]
    return params, x, kpm


def _port_layer(params):
    enc = TransformerEncoder(1, D, H, F)
    enc.load_state_dict(encoder_from_jax({"layers_0": params}))
    return enc.layers[0]


def _np_masks(rate: float, seed: int):
    """bf16-exact {0, 1/keep} masks padded to SP (JAX side) as numpy."""
    if rate == 0.0:
        return None
    r = np.random.RandomState(seed)
    keep = 1.0 - rate
    scale = float(torch.tensor(1.0 / keep, dtype=torch.bfloat16))
    return tuple(((r.rand(B, SP, d) < keep) * scale).astype(np.float32) for d in (D, F, D))


def _to_jax(masks):
    return None if masks is None else tuple(jnp.asarray(m, jnp.bfloat16) for m in masks)


def _to_port(masks):
    return None if masks is None else tuple(
        torch.from_numpy(m[:, :S].copy()).bfloat16() for m in masks)


def _port_grads(layer, x, kpm, masks):
    xt = torch.from_numpy(x).requires_grad_(True)
    out = ft.fused_encoder_layer_train(xt, fe.layer_params(layer), H, masks,
                                       torch.from_numpy(kpm))
    _loss(out).backward()
    grads = {f"layers.0.{n}": p.grad.numpy() for n, p in layer.named_parameters()}
    return out.detach().numpy(), grads, xt.grad.numpy()


def _jax_grads(params, x, kpm, masks):
    def loss(p, xx):
        return _jloss(jlayer_train(xx, p, H, masks=masks, key_padding_mask=jnp.asarray(kpm)))

    out = jlayer_train(jnp.asarray(x), params, H, masks=masks, key_padding_mask=jnp.asarray(kpm))
    gp, gx = jax.grad(loss, argnums=(0, 1))(params, jnp.asarray(x))
    grads = {k: v.numpy() for k, v in encoder_from_jax({"layers_0": jax.device_get(gp)}).items()}
    return np.asarray(out), grads, np.asarray(gx)


def _rel(got, want):
    return float(np.abs(got - want).max() / (np.abs(want).max() + 1e-8))


@pytest.mark.parametrize("rate", [0.0, 0.25])
def test_forward_matches_pallas(setup, rate):
    params, x, kpm = setup
    masks = _np_masks(rate, 3)
    want = jlayer_train(jnp.asarray(x), params, H, masks=_to_jax(masks),
                        key_padding_mask=jnp.asarray(kpm))
    with torch.no_grad():
        got = ft.fused_encoder_layer_train(torch.from_numpy(x), fe.layer_params(_port_layer(params)),
                                           H, _to_port(masks), torch.from_numpy(kpm))
    assert got.dtype == torch.float32 and got.shape == (B, S, D)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=FWD_ATOL)


@pytest.mark.parametrize("rate", [0.0, 0.25])
def test_grads_match_pallas(setup, rate):
    """Every parameter leaf and dx against the custom VJP of the Pallas path."""
    params, x, kpm = setup
    masks = _np_masks(rate, 4)
    _, g_port, gx_port = _port_grads(_port_layer(params), x, kpm, _to_port(masks))
    _, g_jax, gx_jax = _jax_grads(params, x, kpm, _to_jax(masks))
    assert g_port.keys() == g_jax.keys()
    for k in g_jax:
        assert _rel(g_port[k], g_jax[k]) < GRAD_REL, (k, _rel(g_port[k], g_jax[k]))
    assert _rel(gx_port, gx_jax) < GRAD_REL


@pytest.mark.parametrize("half", ["bwd_ffn", "bwd_attn"])
def test_backward_halves_match_autograd_of_the_forward_twin(setup, half):
    """Each backward twin against autograd through the forward twin in fp32
    arithmetic: the same function, so they differ by the bf16 operand
    rounding of the backward products only."""
    params, x, kpm = setup
    masks = _to_port(_np_masks(0.25, 5))
    p = ft.pack(fe.layer_params(_port_layer(params)))
    kmask = torch.where(torch.from_numpy(kpm), 0.0, -1e9)
    xt = torch.from_numpy(x).bfloat16().float().requires_grad_(True)
    leaves = {k: v.float().clone().requires_grad_(True) for k, v in p.items()}
    out, a1, attn = ft.fused_layer_train_forward_reference(xt, leaves, H, kmask, masks)
    dh2 = torch.from_numpy(np.random.RandomState(6).randn(B, S, D).astype(np.float32))
    out.backward(dh2)
    da1, g_ffn = ft.bwd_ffn_reference(dh2, a1.detach(), p, masks)
    dx, g_attn = ft.bwd_attn_reference(da1, xt.detach(), attn.detach(), p, H, kmask, masks)
    got = g_ffn if half == "bwd_ffn" else g_attn
    for k, g in got.items():
        assert _rel(g.numpy(), leaves[k].grad.numpy()) < GRAD_REL, k
    if half == "bwd_attn":
        assert _rel(dx.numpy(), xt.grad.numpy()) < GRAD_REL


def test_finite_difference_with_dropout(setup):
    """Directional derivative through the port's twin itself, dropout on
    (tests/test_fused_train.py:84-110, the same bound)."""
    params, x, kpm = setup
    base = {k: v.detach().clone() for k, v in fe.layer_params(_port_layer(params)).items()}
    masks = _to_port(_np_masks(0.1, 7))
    kp = torch.from_numpy(kpm)

    def loss(pdict, xx):
        return torch.sin(ft.fused_encoder_layer_train(xx, pdict, H, masks, kp)).sum()

    leaves = {k: v.clone().requires_grad_(True) for k, v in base.items()}
    xt = torch.from_numpy(x).requires_grad_(True)
    loss(leaves, xt).backward()
    rv = np.random.RandomState(2)
    vp = {k: torch.from_numpy(rv.randn(*v.shape).astype(np.float32)) for k, v in base.items()}
    vx = torch.from_numpy(rv.randn(*x.shape).astype(np.float32))
    eps = 1e-2  # large enough to dominate the bf16 forward's quantization
    with torch.no_grad():
        plus = loss({k: base[k] + eps * vp[k] for k in base}, torch.from_numpy(x) + eps * vx)
        minus = loss({k: base[k] - eps * vp[k] for k in base}, torch.from_numpy(x) - eps * vx)
    fd = float((plus - minus) / (2 * eps))
    an = sum(float((leaves[k].grad * vp[k]).sum()) for k in base) + float((xt.grad * vx).sum())
    assert abs(fd - an) / abs(an) < 5e-2, (fd, an)


def test_mask_statistics():
    gen = torch.Generator().manual_seed(0)
    m0, m1, m2 = ft.make_dropout_masks(gen, (4, 64, 128), 0.1, 256)
    assert m0.dtype == torch.bfloat16 and m1.shape == (4, 64, 256) and m2.shape == (4, 64, 128)
    scale = float(torch.tensor(1 / 0.9, dtype=torch.bfloat16))
    for m in (m0, m1, m2):
        vals = set(torch.unique(m.float()).tolist())
        assert vals <= {0.0, scale}
        keep = float((m > 0).float().mean())
        assert abs(keep - 0.9) < 0.01, keep
    # independent sites, and the generator's state decides the draw
    assert not torch.equal(m0, m2)
    again = ft.make_dropout_masks(torch.Generator().manual_seed(0), (4, 64, 128), 0.1, 256)
    assert all(torch.equal(a, b) for a, b in zip((m0, m1, m2), again))


def test_stack_checkpointed_equals_unchecked_under_dropout(setup):
    """A checkpointed body that draws its masks from a generator seeded
    inside the body recomputes the same masks, so its gradients equal the
    unchecked run's exactly."""
    params, x, kpm = setup
    enc = TransformerEncoder(2, D, H, F)
    enc.load_state_dict(encoder_from_jax({"layers_0": params, "layers_1": params}))
    layers = [fe.layer_params(layer) for layer in enc.layers]

    def body(xx):
        gen = torch.Generator().manual_seed(1234)
        return ft.fused_encoder_train(xx, layers, H, dropout=0.1, generator=gen,
                                      key_padding_mask=torch.from_numpy(kpm))

    grads = []
    for use_ckpt in (False, True):
        enc.zero_grad()
        xt = torch.from_numpy(x).requires_grad_(True)
        out = checkpoint(body, xt, use_reentrant=False) if use_ckpt else body(xt)
        _loss(out).backward()
        grads.append([p.grad.clone() for p in enc.parameters()] + [xt.grad.clone()])
    for a, b in zip(*grads):
        torch.testing.assert_close(a, b, rtol=0, atol=0)


def test_cpu_wrappers_run_twins_and_count_no_launch(setup):
    params, x, kpm = setup
    before = (ft.fused_layer_train_forward.launches, ft.fused_layer_train_bwd_ffn.launches,
              ft.fused_layer_train_bwd_attn.launches)
    _port_grads(_port_layer(params), x, kpm, None)
    assert (ft.fused_layer_train_forward.launches, ft.fused_layer_train_bwd_ffn.launches,
            ft.fused_layer_train_bwd_attn.launches) == before


@pytest.mark.parametrize("bad", ["dtype", "seq", "heads", "mask"])
def test_kernel_input_checks(setup, bad):
    """What the CUDA launchers do not take is refused before a launch."""
    p = ft.pack(fe.layer_params(TransformerEncoder(1, 128, 2, 256).layers[0]))
    x = torch.zeros(2, 9, 128, dtype=torch.bfloat16)
    heads, masks = 2, None
    if bad == "dtype":
        p["linear2_weight"] = p["linear2_weight"].float()
    elif bad == "seq":
        x = torch.zeros(2, 0, 128, dtype=torch.bfloat16)  # any S >= 1 runs
    elif bad == "heads":
        heads = 16  # head width 8: not a multiple of 16
    else:
        masks = ft.make_dropout_masks(torch.Generator().manual_seed(0), (2, 9, 128), 0.1, 128)
    with pytest.raises(ValueError):
        ft._check_cuda_inputs(x, p, heads, masks)


def test_other_devices_raise(setup):
    params, _, _ = setup
    p = ft.pack(fe.layer_params(_port_layer(params)))
    with pytest.raises(ValueError, match="cuda or cpu"):
        ft.fused_layer_train_forward(torch.empty(B, S, D, device="meta"), p, H)


# ---------------------------------------------------------------------------
# the store-probs pair (kernels 8 and 9) and shapes past the old caps
# ---------------------------------------------------------------------------

def _port_grads_store(layer, x, kpm, masks, store=True):
    xt = torch.from_numpy(x).requires_grad_(True)
    out = ft.fused_encoder_layer_train(xt, fe.layer_params(layer), H, masks,
                                       torch.from_numpy(kpm), store_probs=store)
    _loss(out).backward()
    grads = {f"layers.0.{n}": p.grad.numpy() for n, p in layer.named_parameters()}
    return out.detach().numpy(), grads, xt.grad.numpy()


@pytest.mark.parametrize("rate", [0.0, 0.1])
def test_store_forward_and_grads_match_pallas(setup, rate):
    """The store twins (forward, every gradient leaf and dx) against the
    Pallas layer with store_probs=True, the same masks, the gates above."""
    params, x, kpm = setup
    masks = _np_masks(rate, 8)
    jmasks = _to_jax(masks)
    want = jlayer_train(jnp.asarray(x), params, H, masks=jmasks,
                        key_padding_mask=jnp.asarray(kpm), store_probs=True)

    def loss(p, xx):
        return _jloss(jlayer_train(xx, p, H, masks=jmasks, key_padding_mask=jnp.asarray(kpm),
                                   store_probs=True))

    gp, gx = jax.grad(loss, argnums=(0, 1))(params, jnp.asarray(x))
    g_jax = {k: v.numpy() for k, v in encoder_from_jax({"layers_0": jax.device_get(gp)}).items()}
    out, g_port, gx_port = _port_grads_store(_port_layer(params), x, kpm, _to_port(masks))
    np.testing.assert_allclose(out, np.asarray(want), atol=FWD_ATOL)
    assert g_port.keys() == g_jax.keys()
    for k in g_jax:
        assert _rel(g_port[k], g_jax[k]) < GRAD_REL, (k, _rel(g_port[k], g_jax[k]))
    assert _rel(gx_port, np.asarray(gx)) < GRAD_REL


def test_store_forward_twin_bit_equals_the_forward_twin(setup):
    """Keeping probs and qkv changes nothing the forward returns, with masks
    and without (tests/test_fused_train.py:208-220)."""
    params, x, kpm = setup
    p = ft.pack(fe.layer_params(_port_layer(params)))
    kmask = torch.where(torch.from_numpy(kpm), 0.0, -1e9)
    for masks in (None, _to_port(_np_masks(0.25, 9))):
        plain = ft.fused_layer_train_forward_reference(torch.from_numpy(x), p, H, kmask, masks)
        out, a1, attn, probs, qkv = ft.fused_layer_train_forward_store_reference(
            torch.from_numpy(x), p, H, kmask, masks)
        for u, v in zip(plain, (out, a1, attn)):
            torch.testing.assert_close(u, v, rtol=0, atol=0)
        assert probs.dtype == qkv.dtype == torch.bfloat16
        assert probs.shape == (B, H, S, S) and qkv.shape == (B, S, 3 * D)
        # the stored probabilities are the ones p @ V used: rows sum to 1 over valid keys
        torch.testing.assert_close(probs.float().sum(-1), torch.ones(B, H, S), atol=2e-2,
                                   rtol=0)
        assert float(probs[..., 7:].float().abs().max()) == 0.0  # masked keys


def test_store_grads_match_recompute(setup):
    """Stored-probs gradients equal the recompute path's up to the bf16
    rounding of the stored probabilities, every leaf and dx, dropout on
    (tests/test_fused_train.py:222-245, the same 2e-2 bound)."""
    params, x, kpm = setup
    masks = _to_port(_np_masks(0.1, 10))
    _, g_r, gx_r = _port_grads_store(_port_layer(params), x, kpm, masks, store=False)
    _, g_s, gx_s = _port_grads_store(_port_layer(params), x, kpm, masks, store=True)
    for k in g_r:
        assert _rel(g_s[k], g_r[k]) < 2e-2, (k, _rel(g_s[k], g_r[k]))
    assert _rel(gx_s, gx_r) < 2e-2


def test_store_stack_checkpointed_equals_unchecked_under_dropout(setup):
    """The store-probs stack under torch.utils.checkpoint: the recomputed
    forward stores the same probs and draws the same masks, so the gradients
    equal the unchecked run's exactly."""
    params, x, kpm = setup
    enc = TransformerEncoder(2, D, H, F)
    enc.load_state_dict(encoder_from_jax({"layers_0": params, "layers_1": params}))
    layers = [fe.layer_params(layer) for layer in enc.layers]

    def body(xx):
        gen = torch.Generator().manual_seed(4321)
        return ft.fused_encoder_train(xx, layers, H, dropout=0.1, generator=gen,
                                      key_padding_mask=torch.from_numpy(kpm), store_probs=True)

    grads = []
    for use_ckpt in (False, True):
        enc.zero_grad()
        xt = torch.from_numpy(x).requires_grad_(True)
        out = checkpoint(body, xt, use_reentrant=False) if use_ckpt else body(xt)
        _loss(out).backward()
        grads.append([p.grad.clone() for p in enc.parameters()] + [xt.grad.clone()])
    for a, b in zip(*grads):
        torch.testing.assert_close(a, b, rtol=0, atol=0)


@pytest.mark.parametrize("store", [False, True])
def test_twins_match_pallas_past_the_old_sequence_cap(store):
    """S = 140 (the CUDA kernels took S <= 128 before), B=1, D=32, H=4: the
    forward and every gradient of the twins against the Pallas layer."""
    s, d, f = 140, 32, 64
    r = np.random.RandomState(12)
    x = r.randn(1, s, d).astype(np.float32)
    kpm = np.ones((1, s), bool)
    kpm[0, 120:] = False
    tree = JLayer(d, H, f, dropout=0.1).init(jax.random.PRNGKey(1), jnp.asarray(x))
    params = numpy_params(tree, 13)["params"]
    keep = float(torch.tensor(1 / 0.9, dtype=torch.bfloat16))
    sp = -(-s // 16) * 16
    masks = tuple(((r.rand(1, sp, w) < 0.9) * keep).astype(np.float32) for w in (d, f, d))

    def jloss(p, xx):
        return _jloss(jlayer_train(xx, p, H, masks=_to_jax(masks),
                                   key_padding_mask=jnp.asarray(kpm), store_probs=store))

    want = jlayer_train(jnp.asarray(x), params, H, masks=_to_jax(masks),
                        key_padding_mask=jnp.asarray(kpm), store_probs=store)
    gp, gx = jax.grad(jloss, argnums=(0, 1))(params, jnp.asarray(x))
    g_jax = {k: v.numpy() for k, v in encoder_from_jax({"layers_0": jax.device_get(gp)}).items()}
    enc = TransformerEncoder(1, d, H, f)
    enc.load_state_dict(encoder_from_jax({"layers_0": params}))
    tmasks = tuple(torch.from_numpy(m[:, :s].copy()).bfloat16() for m in masks)
    xt = torch.from_numpy(x).requires_grad_(True)
    out = ft.fused_encoder_layer_train(xt, fe.layer_params(enc.layers[0]), H, tmasks,
                                       torch.from_numpy(kpm), store_probs=store)
    _loss(out).backward()
    np.testing.assert_allclose(out.detach().numpy(), np.asarray(want), atol=FWD_ATOL)
    for n, p in enc.layers[0].named_parameters():
        k = f"layers.0.{n}"
        assert _rel(p.grad.numpy(), g_jax[k]) < GRAD_REL, (k, _rel(p.grad.numpy(), g_jax[k]))
    assert _rel(xt.grad.numpy(), np.asarray(gx)) < GRAD_REL


@pytest.mark.parametrize("shape,ok", [((2, 197, 128, 2, 256), True),
                                      ((2, 9, 384, 6, 1536), True),
                                      ((2, 9, 128, 4, 320), True),
                                      ((2, 9, 100, 4, 256), False)])
def test_kernel_input_checks_take_every_sequence_length(shape, ok):
    """S = 197 and D = 384 with 6 heads (head width 64), head width 32 and
    F = 320 are taken since the caps were lifted; D = 100 is refused."""
    b, s, d, h, f = shape
    p = ft.pack(fe.layer_params(TransformerEncoder(1, d, h, f).layers[0]))
    x = torch.zeros(b, s, d, dtype=torch.bfloat16)
    masks = ft.make_dropout_masks(torch.Generator().manual_seed(0), (b, s, d), 0.1, f)
    if ok:
        assert ft._check_cuda_inputs(x, p, h, masks) == (b, s, d, f)
        assert fe._check_cuda_inputs(x, p, h) == (b, s, d, f)
    else:
        with pytest.raises(ValueError):
            ft._check_cuda_inputs(x, p, h, masks)


def test_store_wrappers_on_the_cpu_count_no_launch(setup):
    params, x, kpm = setup
    names = ("fused_layer_train_forward_store", "fused_layer_train_bwd_attn_stored",
             "fused_layer_train_forward", "fused_layer_train_bwd_attn")
    before = [getattr(ft, n).launches for n in names]
    _port_grads_store(_port_layer(params), x, kpm, None)
    assert [getattr(ft, n).launches for n in names] == before
