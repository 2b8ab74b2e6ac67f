"""The port's other MDM architectures and DiffuseTransfer against the JAX
package on the CPU: the decoder layer, GRUStack, MDM trans_dec (with and
without emb_trans_dec) and gru with weights carried over by from_jax_params
(numpy-made), atol 2e-4 (tests/test_models.py:35's bound); DiffuseTransfer
against tests/goldens/diffuse_transfer.npz and the JAX module (2e-4) with
the residual-code checks of tests/test_models.py:122-200; checkpoint import
refusing the other architectures, as the JAX importer does.
"""
import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp
from motionstyle.models import denoiser as jden
from motionstyle.models import transformer as jtr
from motionstyle.models.torch_import import assemble_diffuse_transfer_params as j_assemble
from motionstyle_torch.models import transformer as ttr
from motionstyle_torch.models.denoiser import MDM, DiffuseTransfer, MDMConfig
from motionstyle_torch.models.params import (
    _layers_from_jax, _DECODER_LAYER_LEAVES, assemble_diffuse_transfer_params,
    from_jax_params, from_torch_state_dict, seeded_init_)
from tests.test_torch_models import numpy_params, one_torch_thread  # noqa: F401

ATOL = 2e-4
C, T, D, CLIP = 16, 9, 32, 16


def _np(t):
    return np.asarray(t)


def _mdm_pair(arch: str, emb_trans_dec: bool = False, layers: int = 2, seed: int = 0):
    """(JAX MDM, its numpy params, port MDM with the same weights)."""
    kw = dict(njoints=C, nfeats=1, latent_dim=D, ff_size=64, num_layers=layers, num_heads=4,
              clip_dim=CLIP, arch=arch, emb_trans_dec=emb_trans_dec)
    jm = jden.MDM(jden.MDMConfig(**kw))
    tree = numpy_params(jax.jit(jm.init)(jax.random.PRNGKey(0), jnp.zeros((1, C, 1, 4)),
                                         jnp.zeros((1,), jnp.int32), jnp.zeros((1, CLIP))), seed)
    port = MDM(MDMConfig(**kw)).eval()
    missing, unexpected = port.load_state_dict(from_jax_params(tree, port.cfg), strict=False)
    assert not unexpected and not missing
    return jm, tree, port


def _inputs(seed: int, B: int = 3):
    rs = np.random.RandomState(seed)
    x = rs.randn(B, C, 1, T).astype(np.float32)
    t = rs.randint(0, 1000, B).astype(np.int32)
    enc = rs.randn(B, CLIP).astype(np.float32)
    return x, t, enc


@pytest.mark.parametrize("arch, emb_trans_dec", [("trans_dec", False), ("trans_dec", True),
                                                 ("gru", False)],
                         ids=["trans_dec", "emb_trans_dec", "gru"])
def test_mdm_architectures_match_jax(arch, emb_trans_dec):
    jm, tree, port = _mdm_pair(arch, emb_trans_dec)
    x, t, enc = _inputs(1)
    apply = jax.jit(jm.apply)
    want = _np(apply(tree, jnp.asarray(x), jnp.asarray(t), jnp.asarray(enc)))
    got = port(torch.from_numpy(x), torch.from_numpy(t).long(), torch.from_numpy(enc))
    assert got.shape == (3, C, 1, T) and got.dtype == torch.float32
    np.testing.assert_allclose(got.detach().numpy(), want, atol=ATOL)
    # without a text condition too (the uncond half of guidance)
    want = _np(apply(tree, jnp.asarray(x), jnp.asarray(t), None))
    got = port(torch.from_numpy(x), torch.from_numpy(t).long(), None)
    np.testing.assert_allclose(got.detach().numpy(), want, atol=ATOL)


def test_decoder_layer_matches_jax():
    layer = jtr.TransformerDecoderLayer(D, 4, 64, 0.1)
    rs = np.random.RandomState(2)
    x = rs.randn(2, 7, D).astype(np.float32)
    mem = rs.randn(2, 3, D).astype(np.float32)  # Sq != Sk: the plain attention
    tree = numpy_params(jax.jit(layer.init)(jax.random.PRNGKey(0), jnp.asarray(x),
                                            jnp.asarray(mem)), 5)
    want = _np(jax.jit(layer.apply)(tree, jnp.asarray(x), jnp.asarray(mem)))
    port = ttr.TransformerDecoderLayer(D, 4, 64, 0.1)
    sd = _layers_from_jax({"layers_0": tree["params"]}, "", _DECODER_LAYER_LEAVES)
    port.load_state_dict({k[len("layers.0."):]: v for k, v in sd.items()})
    got = port(torch.from_numpy(x), torch.from_numpy(mem))
    np.testing.assert_allclose(got.detach().numpy(), want, atol=ATOL)


def test_gru_stack_matches_jax():
    gru = jtr.GRUStack(D, 2)
    rs = np.random.RandomState(3)
    x = rs.randn(2, 11, 24).astype(np.float32)
    tree = numpy_params(jax.jit(gru.init)(jax.random.PRNGKey(0), jnp.asarray(x)), 6)
    want = _np(jax.jit(gru.apply)(tree, jnp.asarray(x)))
    port = ttr.GRUStack(24, D, 2)
    port.load_state_dict({k: torch.from_numpy(np.asarray(v)) for k, v in tree["params"].items()})
    got = port(torch.from_numpy(x))
    assert got.shape == (2, 11, D)
    np.testing.assert_allclose(got.detach().numpy(), want, atol=ATOL)


def test_decoder_training_forward_draws_from_its_generator():
    _, _, port = _mdm_pair("trans_dec", True)
    x, t, enc = (torch.from_numpy(a) for a in _inputs(4))
    t = t.long()
    port.train()
    runs = [port(x, t, enc, deterministic=False,
                 generator=torch.Generator().manual_seed(s)) for s in (7, 7, 8)]
    assert torch.equal(runs[0], runs[1]) and not torch.equal(runs[0], runs[2])
    assert not torch.allclose(runs[0], port(x, t, enc))
    with pytest.raises(ValueError, match="torch.Generator"):
        port(x, t, enc, deterministic=False)


def test_bad_arch_and_gru_dtype_raise():
    with pytest.raises(ValueError, match="correct architecture"):
        MDM(MDMConfig(njoints=C, latent_dim=D, num_layers=1, arch="nope"))
    with pytest.raises(ValueError, match="float32"):
        MDM(MDMConfig(njoints=C, latent_dim=D, num_layers=1, arch="gru", dtype="bfloat16"))


@pytest.mark.parametrize("arch", ["trans_dec", "gru"])
def test_checkpoint_import_refuses_other_architectures(arch):
    """Reference checkpoints load trans_enc only, as torch_import.py:66-76."""
    _, _, port = _mdm_pair(arch)
    sd = {k: v.numpy() for k, v in port.state_dict().items()}
    with pytest.raises(NotImplementedError, match="trans_enc"):
        from_torch_state_dict(sd, port.cfg, part="mdm")


def test_seeded_gru_init_is_lecun_with_zero_biases():
    model = seeded_init_(MDM(MDMConfig(njoints=C, latent_dim=64, num_layers=2, arch="gru",
                                       clip_dim=CLIP)), 0)
    for name, p in model.gru.named_parameters():
        if name.startswith("bias"):
            assert torch.count_nonzero(p) == 0
        else:
            assert abs(float(p.detach().std()) * np.sqrt(p.shape[1]) - 1.0) < 0.1, name


# ---- DiffuseTransfer --------------------------------------------------------

DT_KW = dict(njoints=32, nfeats=1, latent_dim=64, ff_size=128, num_layers=2, num_heads=4,
             clip_dim=64, dropout=0.1)


@pytest.fixture(scope="module")
def golden_dt(goldens):
    g = goldens["diffuse_transfer"]
    sd = {k[len("sd__"):]: g[k] for k in g.files if k.startswith("sd__")}
    model = DiffuseTransfer(MDMConfig(**DT_KW)).eval()
    model.load_state_dict(assemble_diffuse_transfer_params(model.cfg, sd))
    # the JAX module on its own assembly of the same state dict
    jparams = jax.tree_util.tree_map(np.asarray, j_assemble(jden.MDMConfig(**DT_KW), sd))
    return model, jparams, {k: torch.from_numpy(g[k]) for k in
                            ("x", "t", "mu", "style_code", "content_code", "out")}


def _dt_call(model, g, **kw):
    args = [g["x"], g["t"].long(), g["mu"], g["style_code"], g["content_code"]]
    for k, v in kw.items():
        args[["x", "t", "mu", "style_code", "content_code"].index(k)] = v
    return model(*args[:5])


def test_diffuse_transfer_matches_the_golden_and_jax(golden_dt):
    model, jparams, g = golden_dt
    got = _dt_call(model, g)
    assert got.shape == g["out"].shape
    np.testing.assert_allclose(got.detach().numpy(), g["out"].numpy(), atol=ATOL)
    # the JAX module on the same weights, and the port on them carried over
    want = _np(jax.jit(jden.DiffuseTransfer(jden.MDMConfig(**DT_KW)).apply)(
        jparams, *(jnp.asarray(g[k].numpy()) for k in ("x", "t", "mu", "style_code",
                                                       "content_code"))))
    np.testing.assert_allclose(got.detach().numpy(), want, atol=ATOL)
    carried = DiffuseTransfer(model.cfg).eval()
    carried.load_state_dict(from_jax_params(jparams, model.cfg))
    np.testing.assert_allclose(_dt_call(carried, g).detach().numpy(), want, atol=ATOL)


def test_diffuse_transfer_residual_code_semantics(golden_dt):
    """style_code == content_code reduces to the plain text condition;
    the residual shifts the output (:745-747)."""
    model, _, g = golden_dt
    zeros = torch.zeros_like(g["style_code"])
    same = _dt_call(model, g, style_code=g["content_code"])
    plain = _dt_call(model, g, style_code=zeros, content_code=zeros)
    np.testing.assert_allclose(same.detach().numpy(), plain.detach().numpy(), atol=1e-5)
    shifted = _dt_call(model, g)
    assert not np.allclose(shifted.detach().numpy(), plain.detach().numpy(), atol=1e-3)


def test_diffuse_transfer_uncond_zeroes_the_whole_condition(golden_dt):
    model, _, g = golden_dt
    z = torch.zeros_like(g["mu"])
    un = model(g["x"], g["t"].long(), g["mu"], g["style_code"], g["content_code"], uncond=True)
    ref = model(g["x"], g["t"].long(), z, z, z)
    np.testing.assert_allclose(un.detach().numpy(), ref.detach().numpy(), atol=1e-5)


def test_diffuse_transfer_encode_motion_and_tree(golden_dt):
    """encode_motion answers as JAX's on the same weights; the port's tree
    is the JAX full_init tree's (every leaf carried, none left over)."""
    model, jparams, g = golden_dt
    want = _np(jden.DiffuseTransfer(jden.MDMConfig(**DT_KW)).apply(
        jparams, jnp.asarray(g["x"].numpy()), method=jden.DiffuseTransfer.encode_motion))
    got = model.encode_motion(g["x"])
    assert got.shape == (g["x"].shape[0], 64)
    np.testing.assert_allclose(got.detach().numpy(), want, atol=ATOL)
    assert not torch.allclose(got, model.encode_motion(g["x"] + 1.0))
    carried = from_jax_params(jparams, model.cfg)
    assert set(carried) == set(model.state_dict())
