"""PyTorch port vs the JAX package: transformer encoder, MDM,
StyleDiffusion, weight import and the CLIP text tower, on the CPU.

Weights and inputs come from numpy seeds and go into both packages (JAX
params through models.params.from_jax_params). fp32 paths are held at atol
2e-4, the bound tests/test_models.py holds the JAX package to against the
torch reference.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from motionstyle.models import clip_text as jclip
from motionstyle.models import denoiser as jden
from motionstyle.models.torch_import import (
    export_mdm, export_semantic_discriminator, export_style_encoder)
from motionstyle.models.transformer import TransformerEncoder as JEncoder
from motionstyle_torch.models import clip_text
from motionstyle_torch.models.denoiser import MDM, MDMConfig, StyleDiffusion
from motionstyle_torch.models.params import (
    encoder_from_jax, from_jax_params, from_torch_state_dict, seeded_init_)
from motionstyle_torch.models.transformer import TransformerEncoder

ATOL = 2e-4  # tests/test_models.py:35


@pytest.fixture(autouse=True, scope="module")
def one_torch_thread():
    """These tests share the machine with other test workers: run torch's
    CPU kernels on one thread while they run, and restore the setting."""
    old = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(old)


def numpy_params(tree, seed: int):
    """Replace every leaf of a flax param tree with numpy draws of its shape:
    kernels lecun-scaled, biases small, LayerNorm scales near 1."""
    rs = np.random.RandomState(seed)

    def draw(path, leaf):
        name = str(getattr(path[-1], "key", path[-1]))
        r = rs.randn(*leaf.shape).astype(np.float32)
        if name == "kernel":
            return r / np.sqrt(leaf.shape[0])
        if name == "bias":
            return 0.1 * r
        if name == "scale":
            return 1.0 + 0.1 * r
        return r

    return jax.tree_util.tree_map_with_path(draw, jax.device_get(tree))


def small_cfgs(**kw):
    base = dict(njoints=12, nfeats=1, latent_dim=64, ff_size=128, num_layers=2,
                num_heads=4, clip_dim=32)
    base.update(kw)
    jkw = {k: v for k, v in base.items()}
    tkw = {k: v for k, v in base.items() if k in MDMConfig.__dataclass_fields__}
    return jden.MDMConfig(**jkw), MDMConfig(**tkw)


def style_pair(seed: int = 0, **kw):
    """(JAX model, numpy params, port model) with the same weights."""
    jcfg, tcfg = small_cfgs(**kw)
    jmodel = jden.StyleDiffusion(jcfg)
    x = jnp.zeros((1, jcfg.njoints, 1, 8))
    tree = jmodel.init(jax.random.PRNGKey(0), x, jnp.zeros((1,), jnp.int32),
                       jnp.zeros((1, jcfg.clip_dim)),
                       method=jden.StyleDiffusion.full_init)
    params = numpy_params(tree, seed)
    tmodel = StyleDiffusion(tcfg)
    tmodel.load_state_dict(from_jax_params(params, tcfg))
    return jmodel, params, tmodel.eval()


def denoiser_inputs(seed: int, cfg_njoints=12, B=2, T=8, clip_dim=32):
    rs = np.random.RandomState(seed)
    return (rs.randn(B, cfg_njoints, 1, T).astype(np.float32),
            rs.randint(0, 1000, size=(B,)).astype(np.int64),
            rs.randn(B, clip_dim).astype(np.float32))


class TestEncoder:
    @pytest.mark.parametrize("masked", [False, True])
    def test_fp32_encoder_matches_jax(self, masked):
        B, S, D, L, H = 2, 9, 64, 2, 4
        enc = JEncoder(L, D, H, 128, 0.1)
        rs = np.random.RandomState(1)
        x = rs.randn(B, S, D).astype(np.float32)
        kpm = np.ones((B, S), bool)
        if masked:
            kpm[1, 5:] = False
        params = numpy_params(enc.init(jax.random.PRNGKey(0), jnp.asarray(x)), 2)
        want = np.asarray(enc.apply(params, jnp.asarray(x),
                                    key_padding_mask=jnp.asarray(kpm) if masked else None))
        port = TransformerEncoder(L, D, H, 128)
        port.load_state_dict(encoder_from_jax(params["params"]))
        with torch.no_grad():
            got = port(torch.from_numpy(x),
                       key_padding_mask=torch.from_numpy(kpm) if masked else None)
        np.testing.assert_allclose(got.numpy(), want, atol=ATOL)

    def test_bf16_encoder_tracks_fp32(self):
        """The compute-dtype path: bf16 within bf16 rounding of fp32."""
        port = seeded_init_(TransformerEncoder(2, 64, 4, 128), 3)
        x = torch.from_numpy(np.random.RandomState(4).randn(2, 9, 64).astype(np.float32))
        with torch.no_grad():
            a = port(x)
            b = port(x.bfloat16(), dtype=torch.bfloat16).float()
        assert b.dtype == torch.float32
        assert float((a - b).norm() / a.norm()) < 2e-2


class TestDenoiser:
    def test_mdm_matches_jax(self):
        jcfg, tcfg = small_cfgs()
        jmodel = jden.MDM(jcfg)
        x, t, enc = denoiser_inputs(5)
        tree = jmodel.init(jax.random.PRNGKey(0), jnp.asarray(x), jnp.asarray(t),
                           jnp.asarray(enc))
        params = numpy_params(tree, 6)
        want = np.asarray(jmodel.apply(params, jnp.asarray(x), jnp.asarray(t),
                                       jnp.asarray(enc)))
        port = MDM(tcfg)
        port.load_state_dict(from_jax_params(params, tcfg))
        with torch.no_grad():
            got = port(torch.from_numpy(x), torch.from_numpy(t), torch.from_numpy(enc))
        assert got.dtype == torch.float32 and got.shape == want.shape
        np.testing.assert_allclose(got.numpy(), want, atol=ATOL)

    @pytest.mark.parametrize("method", ["style", "prior", "no_text"])
    def test_style_diffusion_matches_jax(self, method):
        jmodel, params, port = style_pair(7)
        x, t, enc = denoiser_inputs(8)
        enc_j = None if method == "no_text" else jnp.asarray(enc)
        enc_t = None if method == "no_text" else torch.from_numpy(enc)
        if method == "prior":
            want = jmodel.apply(params, jnp.asarray(x), jnp.asarray(t), enc_j,
                                method=jden.StyleDiffusion.denoise_prior)
            fn = port.denoise_prior
        else:
            want = jmodel.apply(params, jnp.asarray(x), jnp.asarray(t), enc_j)
            fn = port
        with torch.no_grad():
            got = fn(torch.from_numpy(x), torch.from_numpy(t), enc_t)
        np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=ATOL)

    def test_embed_tokens_output_head_compose_to_forward(self):
        _, _, port = style_pair(9)
        x, t, enc = (torch.from_numpy(a) for a in denoiser_inputs(10))
        with torch.no_grad():
            whole = port(x, t, enc)
            parts = port.output_head(port.style_encoder(port.embed_tokens(x, t, enc)))
        torch.testing.assert_close(parts, whole, rtol=0, atol=0)

    def test_golden_state_dict_matches_reference(self, goldens):
        """The reference-layout prior checkpoint, full width, against the
        torch reference's output (tests/test_models.py:27-35)."""
        g = goldens["mdm_model"]
        sd = {k[len("sd__"):]: g[k] for k in g.files if k.startswith("sd__")}
        cfg = MDMConfig(njoints=181, nfeats=1)
        model = StyleDiffusion(cfg)
        missing, unexpected = model.load_state_dict(
            from_torch_state_dict(sd, cfg, part="mdm"), strict=False)
        # a prior checkpoint leaves the style encoder and the semantic
        # discriminator to their own checkpoints
        assert not unexpected and all(k.startswith(
            ("style_encoder.", "motion_enc_encoder.", "mu_query", "sigma_query"))
            for k in missing)
        with torch.no_grad():
            out = model.denoise_prior(torch.from_numpy(g["x"]), torch.from_numpy(g["t"]),
                                      torch.from_numpy(g["enc_text"]))
        np.testing.assert_allclose(out.numpy(), g["out"], atol=ATOL)


class TestParams:
    def test_checkpoint_and_jax_tree_agree(self):
        """A checkpoint the JAX package writes (export_mdm /
        export_style_encoder / export_semantic_discriminator) loads into the
        same port state as its tree."""
        _, params, port = style_pair(11)
        tcfg = port.cfg
        sd_mdm = export_mdm(params, tcfg.num_layers)
        sd_style = export_style_encoder(params, tcfg.num_layers)
        sd_sem = export_semantic_discriminator(params, tcfg.num_layers)
        state = from_torch_state_dict(sd_mdm, tcfg, part="mdm")
        state.update(from_torch_state_dict(sd_style, tcfg, part="style_encoder"))
        state.update(from_torch_state_dict(sd_sem, tcfg, part="semantic"))
        want = from_jax_params(params, tcfg)
        assert state.keys() == want.keys()
        for k in want:
            torch.testing.assert_close(state[k], want[k], rtol=0, atol=0, msg=k)

    def test_layer_count_mismatch_raises(self):
        _, params, port = style_pair(12)
        sd = export_style_encoder(params, 2)
        with pytest.raises(ValueError, match="layers"):
            from_torch_state_dict(sd, MDMConfig(njoints=12, num_layers=3), part="style_encoder")
        with pytest.raises(ValueError, match="part"):
            from_torch_state_dict(sd, port.cfg, part="clip")

    def test_seeded_init_is_deterministic(self):
        a = seeded_init_(StyleDiffusion(small_cfgs()[1]), 5).state_dict()
        b = seeded_init_(StyleDiffusion(small_cfgs()[1]), 5).state_dict()
        c = seeded_init_(StyleDiffusion(small_cfgs()[1]), 6).state_dict()
        for k in a:
            torch.testing.assert_close(a[k], b[k], rtol=0, atol=0)
        w = "style_encoder.layers.0.linear1.weight"
        assert not torch.equal(a[w], c[w])
        assert torch.all(a["style_encoder.layers.0.linear1.bias"] == 0)
        assert torch.all(a["style_encoder.layers.0.norm1.weight"] == 1)


class TestClipText:
    @pytest.mark.parametrize("text", ["a person walks angrily", "  Jumps   HIGH!! ",
                                      "café " * 30, ""])
    def test_tokenize_matches_jax(self, text):
        np.testing.assert_array_equal(clip_text.tokenize([text]), jclip.tokenize([text]))
        np.testing.assert_array_equal(clip_text.tokenize([text], context_length=22),
                                      jclip.tokenize([text], context_length=22))

    def test_tower_matches_jax_through_a_clip_state_dict(self):
        """An OpenAI-layout text-tower state dict (the --clip_weights path)
        through the JAX converter and the port's loader: same features."""
        from motionstyle.models.torch_import import convert_clip_text

        c = clip_text.ClipTextConfig(layers=2, width=64, heads=4,
                                     embed_dim=32)
        port = clip_text.ClipTextEncoder(c)
        rs = np.random.RandomState(13)
        sd = {"clip_model." + k: (rs.randn(*v.shape) * (0.02 if v.ndim > 1 else 0.1)
                                  + (1.0 if k.endswith(("ln_1.weight", "ln_2.weight",
                                                        "ln_final.weight")) else 0.0)
                                  ).astype(np.float32)
              for k, v in port.state_dict().items()}
        sd["clip_model.visual.proj"] = np.zeros((3, 3), np.float32)  # image tower: ignored
        port.load_clip_state_dict(sd)
        jenc = jclip.ClipTextEncoder(jclip.ClipTextConfig(
            layers=2, width=64, heads=4, embed_dim=32))
        ids = clip_text.tokenize(["a person walks", "runs"], context_length=16)
        want = np.asarray(jenc.apply({"params": convert_clip_text(sd)},
                                     jnp.asarray(ids.astype(np.int32))))
        with torch.no_grad():
            got = port(torch.from_numpy(ids)).numpy()
        np.testing.assert_allclose(got, want, atol=ATOL)

    @pytest.mark.parametrize("dataset", ["stylexia_posrot", "humanml"])
    def test_encode_text_context(self, dataset):
        c = clip_text.ClipTextConfig(layers=1, width=32, heads=2, embed_dim=16)
        enc = seeded_init_(clip_text.ClipTextEncoder(c), 42, stds=clip_text.INIT_STDS).eval()
        out = clip_text.encode_text(enc, ["a person walks " * 20, "runs"], dataset=dataset)
        assert out.shape == (2, 16) and torch.isfinite(out).all()
