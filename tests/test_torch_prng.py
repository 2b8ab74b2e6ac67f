"""The training layer's prng dropout mode (kernel 10: dropout bits
regenerated inside kernels 5-9 from per-clip seeds with Philox4x32-10) on
the CPU, through the plain PyTorch twins. The CUDA kernels are held against
the same twins on the card by chip_smoke.py.

The JAX package's prng mode runs only on a TPU (off it, it falls back to
mask arrays, tests/test_fused_train.py:296-309), so the port is held to it
element by element through the masks path: at rate 0.5, 1/keep = 2 is exact
in bf16, so the {0, 2} masks built from the port's Philox bits make JAX's
masks-mode layer compute the prng arithmetic exactly. Elsewhere the checks
are the JAX package's own TPU checks (tests/test_fused_train.py:311-362):
determinism per seed, the rate -> 0 limit, the keep fraction and a finite
difference through the layer.

Shapes: B=3, S=9 (padded to 16 on the JAX side), D=64, 4 heads, F=128.
Gates: the port's prng twin against its masks twin given those masks, fp32
atol 2e-4 (the same arithmetic); against JAX's Pallas masks path, the bounds
of tests/test_torch_fused_train.py (forward atol 2e-2, gradients 3e-2 of
each leaf's largest magnitude: bf16 operands summed in other orders).
"""
import math

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from torch.utils.checkpoint import checkpoint

from motionstyle.models.transformer import TransformerEncoderLayer as JLayer
from motionstyle.ops.fused_encoder_train import fused_encoder_layer_train as jlayer_train
from motionstyle_torch.cli import model_util
from motionstyle_torch.cli.parser_util import finetune_inpainting_style_args
from motionstyle_torch.models.denoiser import MDMConfig
from motionstyle_torch.models.params import encoder_from_jax
from motionstyle_torch.models.transformer import TransformerEncoder
from motionstyle_torch.ops import fused_encoder as fe
from motionstyle_torch.ops import fused_encoder_train as ft
from tests.test_torch_models import numpy_params, one_torch_thread  # noqa: F401

B, S, D, F, H = 3, 9, 64, 128, 4
SP = 16
FWD_ATOL, GRAD_REL, TWIN_ATOL = 2e-2, 3e-2, 2e-4
M32 = 0xFFFFFFFF
SEEDS = [11, -7, 2 ** 31 - 1]

# Random123's known-answer vectors for philox4x32-10: (counter, key, output)
KNOWN = [
    ((0, 0, 0, 0), (0, 0), (0x6627E8D5, 0xE169C58D, 0xBC57AC4C, 0x9B00DBD8)),
    ((M32,) * 4, (M32, M32), (0x408F276D, 0x41C83B0E, 0xA20BC7C6, 0x6D5451FD)),
    ((0x243F6A88, 0x85A308D3, 0x13198A2E, 0x03707344), (0xA4093822, 0x299F31D0),
     (0xD16CFE09, 0x94FDCCEB, 0x5001E420, 0x24126EA1)),
]


def philox_py(c, k):
    """Philox4x32-10 in plain Python integers."""
    c, k = list(c), list(k)
    for r in range(10):
        if r:
            k = [(k[0] + 0x9E3779B9) & M32, (k[1] + 0xBB67AE85) & M32]
        p0, p1 = 0xD2511F53 * c[0], 0xCD9E8D57 * c[2]
        c = [((p1 >> 32) ^ c[1] ^ k[0]) & M32, p1 & M32, ((p0 >> 32) ^ c[3] ^ k[1]) & M32,
             p0 & M32]
    return c


@pytest.mark.parametrize("counter,key,want", KNOWN)
def test_philox_known_answers(counter, key, want):
    got = ft.philox4x32_10(counter, key)
    assert [int(w) for w in got] == list(want)
    assert philox_py(counter, key) == list(want)


def test_philox_matches_plain_python():
    rs = np.random.RandomState(0)
    c = rs.randint(0, 2 ** 32, size=(4, 64), dtype=np.uint64).astype(np.int64)
    k = rs.randint(0, 2 ** 32, size=(2, 64), dtype=np.uint64).astype(np.int64)
    got = torch.stack(ft.philox4x32_10(torch.from_numpy(c), torch.from_numpy(k))).numpy()
    for i in range(64):
        assert list(got[:, i]) == philox_py(c[:, i].tolist(), k[:, i].tolist())


def test_dropout_bits_index_layout():
    """Element (b, s, col) of site `site` is word col & 3 of the Philox block
    at counter (s, col >> 2, 0, 0) and key (uint32(seed_b), site): the layout
    the kernels regenerate whatever their tiling."""
    seeds = torch.tensor(SEEDS, dtype=torch.int32)
    bits = ft.dropout_bits(seeds, 2, S, 70)  # 70: the last block is cut to 2 words
    assert bits.shape == (B, S, 70) and bits.dtype == torch.int64
    for b, s, col in ((0, 0, 0), (1, 4, 33), (2, 8, 69), (2, 3, 5)):
        want = philox_py((s, col >> 2, 0, 0), (SEEDS[b] & M32, 2))[col & 3]
        assert int(bits[b, s, col]) == want


def test_prng_threshold_clamps():
    thresh, scale = ft.prng_threshold(1e-12)
    assert thresh == M32 and scale == pytest.approx(1.0)
    assert ft.prng_threshold(0.5) == (2 ** 31, 2.0)


# ---------------------------------------------------------------------------
# the layer in prng mode
# ---------------------------------------------------------------------------

@pytest.fixture(scope="module")
def setup():
    r = np.random.RandomState(1)
    x = r.randn(B, S, D).astype(np.float32)
    kpm = np.concatenate([np.ones((B, 7)), np.zeros((B, 2))], 1).astype(bool)
    tree = JLayer(D, H, F, dropout=0.1).init(jax.random.PRNGKey(0), jnp.asarray(x))
    params = numpy_params(tree, 2)["params"]
    return params, x, kpm


def _layer(params):
    enc = TransformerEncoder(1, D, H, F)
    enc.load_state_dict(encoder_from_jax({"layers_0": params}))
    return enc.layers[0]


def _loss(out):
    return (torch.sin(out) * torch.cos(out * 0.3)).sum()


def _port(params, x, kpm, store=False, **drop):
    """(out, grads by parameter name, dx) of the port's fused layer."""
    layer = _layer(params)
    xt = torch.from_numpy(x).requires_grad_(True)
    out = ft.fused_encoder_layer_train(xt, fe.layer_params(layer), H,
                                       key_padding_mask=torch.from_numpy(kpm),
                                       store_probs=store, **drop)
    _loss(out).backward()
    grads = {n: p.grad.numpy() for n, p in layer.named_parameters()}
    return out.detach().numpy(), grads, xt.grad.numpy()


def _masks_from_bits(seeds, rate):
    """The prng mode's keep bits as {0, 1/keep} masks (B, S, N), fp32."""
    thresh, scale = ft.prng_threshold(rate)
    return tuple(torch.where(ft.dropout_bits(seeds, site, S, n) < thresh, scale, 0.0).float()
                 for site, n in ((0, D), (1, F), (2, D)))


def _rel(got, want):
    return float(np.abs(got - want).max() / (np.abs(want).max() + 1e-8))


@pytest.mark.parametrize("store", [False, True])
def test_prng_twin_matches_jax_masks_path_at_half(setup, store):
    """Rate 0.5: the port's prng twin against (a) its masks twin given
    masks built from its own bits, fp32 atol 2e-4, and (b) JAX's Pallas
    masks path given the same masks, within the fused-layer bounds."""
    params, x, kpm = setup
    seeds = torch.tensor(SEEDS, dtype=torch.int32)
    masks = _masks_from_bits(seeds, 0.5)
    out, grads, dx = _port(params, x, kpm, store, seeds=seeds, rate=0.5)

    m_out, m_grads, m_dx = _port(params, x, kpm, store,
                                 masks=tuple(m.bfloat16() for m in masks))
    np.testing.assert_allclose(out, m_out, atol=TWIN_ATOL)
    np.testing.assert_allclose(dx, m_dx, atol=TWIN_ATOL)
    for k in grads:
        np.testing.assert_allclose(grads[k], m_grads[k], atol=TWIN_ATOL, err_msg=k)

    pad = lambda m: np.pad(m.numpy(), ((0, 0), (0, SP - S), (0, 0)))  # noqa: E731
    jmasks = tuple(jnp.asarray(pad(m), jnp.bfloat16) for m in masks)

    def jloss(p, xx):
        o = jlayer_train(xx, p, H, masks=jmasks, key_padding_mask=jnp.asarray(kpm),
                         store_probs=store)
        return jnp.sum(jnp.sin(o) * jnp.cos(o * 0.3))

    j_out = np.asarray(jlayer_train(jnp.asarray(x), params, H, masks=jmasks,
                                    key_padding_mask=jnp.asarray(kpm), store_probs=store))
    gp, gx = jax.grad(jloss, argnums=(0, 1))(params, jnp.asarray(x))
    j_grads = {k[len("layers.0."):]: v.numpy()
               for k, v in encoder_from_jax({"layers_0": jax.device_get(gp)}).items()}
    np.testing.assert_allclose(out, j_out, atol=FWD_ATOL)
    assert _rel(dx, np.asarray(gx)) < GRAD_REL
    assert grads.keys() == j_grads.keys()
    for k in grads:
        assert _rel(grads[k], j_grads[k]) < GRAD_REL, (k, _rel(grads[k], j_grads[k]))


def test_prng_scale_is_fp32_not_the_masks_bf16(setup):
    """At rate 0.1 the prng mode scales kept values by fp32(1/keep) =
    1.1111112 (:133), where the masks mode's bf16 mask holds 1.109375."""
    params, x, _ = setup
    seeds = torch.tensor(SEEDS, dtype=torch.int32)
    p = fe.layer_params(_layer(params))
    with torch.no_grad():
        out = ft.fused_layer_train_forward_reference(
            torch.from_numpy(x), ft.pack(p), H, out_dtype=torch.float32, seeds=seeds, rate=0.1)
        masks = tuple(m.bfloat16() for m in _masks_from_bits(seeds, 0.1))
        assert float(masks[0].max()) == 1.109375
        f32 = tuple(m.float() for m in _masks_from_bits(seeds, 0.1))
        want = ft.fused_layer_train_forward_reference(
            torch.from_numpy(x), ft.pack(p), H, masks=f32, out_dtype=torch.float32)
    np.testing.assert_array_equal(out[0].numpy(), want[0].numpy())


def test_prng_determinism_and_seed_sensitivity(setup):
    params, x, kpm = setup
    seeds = torch.tensor(SEEDS, dtype=torch.int32)
    a = _port(params, x, kpm, seeds=seeds, rate=0.3)
    b = _port(params, x, kpm, seeds=seeds, rate=0.3)
    c = _port(params, x, kpm, seeds=seeds + 1, rate=0.3)
    np.testing.assert_array_equal(a[0], b[0])
    for k in a[1]:
        np.testing.assert_array_equal(a[1][k], b[1][k])
    assert not np.array_equal(a[0], c[0])
    # each clip has its own seed: changing one clip's seed leaves the others
    d = _port(params, x, kpm, seeds=torch.tensor([11, -7, 5], dtype=torch.int32), rate=0.3)
    np.testing.assert_array_equal(a[0][:2], d[0][:2])
    assert not np.array_equal(a[0][2], d[0][2])


def test_prng_rate_to_zero_is_the_deterministic_layer(setup):
    params, x, kpm = setup
    det = _port(params, x, kpm)
    tiny = _port(params, x, kpm, seeds=torch.tensor(SEEDS, dtype=torch.int32), rate=1e-9)
    np.testing.assert_allclose(tiny[0], det[0], atol=1e-5)
    np.testing.assert_allclose(tiny[2], det[2], atol=1e-5)


def test_keep_fraction_at_half_within_5_sigma():
    seeds = torch.arange(16, dtype=torch.int32) * 7919
    thresh, _ = ft.prng_threshold(0.5)
    kept = n = 0
    for site, width in ((0, D), (1, F), (2, D)):
        bits = ft.dropout_bits(seeds, site, 77, width)
        kept += int((bits < thresh).sum())
        n += bits.numel()
    assert abs(kept / n - 0.5) <= 5 * 0.5 / math.sqrt(n), kept / n
    # the three sites draw independent bits
    assert not torch.equal(ft.dropout_bits(seeds, 0, 9, D), ft.dropout_bits(seeds, 2, 9, D))


@pytest.mark.parametrize("case", ["rate0", "rate1", "both"])
def test_prng_contract_refuses(setup, case):
    """Seeds need a rate in (0, 1), and masks and seeds are exclusive
    (:797-800)."""
    params, x, _ = setup
    p = fe.layer_params(_layer(params))
    seeds = torch.tensor(SEEDS, dtype=torch.int32)
    kw = {"rate0": dict(seeds=seeds), "rate1": dict(seeds=seeds, rate=1.0),
          "both": dict(seeds=seeds, rate=0.1, masks=_masks_from_bits(seeds, 0.1))}[case]
    with pytest.raises(ValueError, match="seeds|masks"):
        ft.fused_encoder_layer_train(torch.from_numpy(x), p, H, **kw)


@pytest.mark.parametrize("bad", ["dtype", "shape", "strided"])
def test_cuda_launcher_refuses_bad_seeds(bad):
    """The launchers take a contiguous int32 (B,) seed vector only."""
    p = ft.pack(fe.layer_params(TransformerEncoder(1, 128, 2, 256).layers[0]))
    x = torch.zeros(2, 9, 128, dtype=torch.bfloat16)
    seeds = {"dtype": torch.zeros(2, dtype=torch.int64),
             "shape": torch.zeros(3, dtype=torch.int32),
             "strided": torch.zeros(4, dtype=torch.int32)[::2]}[bad]
    ft._check_cuda_inputs(x, p, 2, seeds=torch.zeros(2, dtype=torch.int32), rate=0.1)
    with pytest.raises(ValueError, match="seeds"):
        ft._check_cuda_inputs(x, p, 2, seeds=seeds, rate=0.1)


def test_store_and_prng_compose(setup):
    """The store-probs forward in prng mode is bit-equal to the recompute
    forward, and its gradients differ only by the stored bf16 p."""
    params, x, kpm = setup
    seeds = torch.tensor(SEEDS, dtype=torch.int32)
    rec = _port(params, x, kpm, False, seeds=seeds, rate=0.2)
    sto = _port(params, x, kpm, True, seeds=seeds, rate=0.2)
    np.testing.assert_array_equal(rec[0], sto[0])
    for k in rec[1]:
        assert _rel(sto[1][k], rec[1][k]) < GRAD_REL, k
    assert _rel(sto[2], rec[2]) < GRAD_REL


@pytest.mark.parametrize("store", [False, True])
def test_finite_difference_through_the_prng_layer(store):
    """The gradient of FusedLayerTrain in prng mode against a central finite
    difference through the same twins (the JAX package's TPU check, its 5e-2
    bound). The direction takes each gradient entry's sign scaled by its
    leaf's rms, so the directional derivative does not cancel; a backward
    that regenerated other bits than the forward's misses by ~20 %."""
    import chip_smoke

    gen = torch.Generator().manual_seed(7)
    b, s, d, h, f = 4, 20, 128, 4, 256
    base = chip_smoke.random_params(gen, d, f)
    x = torch.randn(b, s, d, generator=gen)
    seeds = ft.draw_dropout_seeds(gen, 1, b)[0]

    def loss(pd, xx, sd=seeds):
        return torch.sin(ft.fused_encoder_layer_train(xx, pd, h, store_probs=store, seeds=sd,
                                                      rate=0.1)).sum()

    def rel_error(sd):
        leaves = {k: v.clone().requires_grad_(True) for k, v in base.items()}
        xt = x.clone().requires_grad_(True)
        loss(leaves, xt, sd).backward()
        rms = lambda t: t.pow(2).mean().sqrt()  # noqa: E731
        vp = {k: torch.sign(leaves[k].grad) * rms(base[k]) for k in base}
        vx = torch.sign(xt.grad) * rms(x)
        eps = 1e-2
        with torch.no_grad():
            fd = float((loss({k: base[k] + eps * vp[k] for k in base}, x + eps * vx)
                        - loss({k: base[k] - eps * vp[k] for k in base}, x - eps * vx))
                       / (2 * eps))
        an = sum(float((leaves[k].grad * vp[k]).sum()) for k in base) + float((xt.grad * vx).sum())
        return abs(fd - an) / abs(an)

    assert rel_error(seeds) < 5e-2
    # the check has teeth: another clip's bits in the gradient miss it
    assert rel_error(seeds + 1) > 5e-2


# ---------------------------------------------------------------------------
# the stack and the model
# ---------------------------------------------------------------------------

def _stack(params):
    enc = TransformerEncoder(2, D, H, F)
    enc.load_state_dict(encoder_from_jax({"layers_0": params, "layers_1": params}))
    return enc, [fe.layer_params(layer) for layer in enc.layers]


def test_stack_draws_one_seed_vector_per_layer_and_no_masks(setup, monkeypatch):
    """in_kernel_prng: one (B,) int32 seed vector per layer, all drawn from
    the generator before any layer runs, and no mask arrays at all."""
    params, x, kpm = setup
    enc, layers = _stack(params)
    seen = []
    real = ft.fused_encoder_layer_train

    def spy(xx, pp, heads, masks=None, kpm=None, store=False, seeds=None, rate=0.0):
        seen.append((masks, None if seeds is None else seeds.clone(), rate))
        return real(xx, pp, heads, masks, kpm, store, seeds=seeds, rate=rate)

    monkeypatch.setattr(ft, "fused_encoder_layer_train", spy)
    calls = ft.make_dropout_masks.calls
    gen = torch.Generator().manual_seed(5)
    with torch.no_grad():
        ft.fused_encoder_train(torch.from_numpy(x), layers, H, dropout=0.1, generator=gen,
                               key_padding_mask=torch.from_numpy(kpm), in_kernel_prng=True)
    assert ft.make_dropout_masks.calls == calls
    want = ft.draw_dropout_seeds(torch.Generator().manual_seed(5), 2, B)
    assert want.dtype == torch.int32 and want.shape == (2, B)
    assert [m for m, _, _ in seen] == [None, None] and [r for _, _, r in seen] == [0.1, 0.1]
    for i, (_, sd, _) in enumerate(seen):
        assert torch.equal(sd, want[i])
    assert not torch.equal(want[0], want[1])


def test_stack_checkpointed_equals_unchecked_in_prng_mode(setup):
    """A checkpointed body that seeds its generator inside the body redraws
    the same seeds, so its gradients equal the unchecked run's exactly."""
    params, x, kpm = setup
    enc, layers = _stack(params)

    def body(xx):
        gen = torch.Generator().manual_seed(1234)
        return ft.fused_encoder_train(xx, layers, H, dropout=0.1, generator=gen,
                                      key_padding_mask=torch.from_numpy(kpm),
                                      in_kernel_prng=True)

    grads = []
    for use_ckpt in (False, True):
        enc.zero_grad()
        xt = torch.from_numpy(x).requires_grad_(True)
        out = checkpoint(body, xt, use_reentrant=False) if use_ckpt else body(xt)
        _loss(out).backward()
        grads.append([p.grad.clone() for p in enc.parameters()] + [xt.grad.clone()])
    for a, b in zip(*grads):
        torch.testing.assert_close(a, b, rtol=0, atol=0)


def test_config_and_cli_flag_imply_fused_train():
    assert MDMConfig(fused_train_prng=True).fused_train
    assert MDMConfig(fused_train_store=True).fused_train
    assert not MDMConfig().fused_train
    args = finetune_inpainting_style_args(["--save_dir", "x", "--fused_train_prng", "1"])
    cfg = model_util.get_transfer_config(args)
    assert cfg.fused_train and cfg.fused_train_prng and not cfg.fused_train_store
    assert args.fused_train == 1  # the args object is normalized too
