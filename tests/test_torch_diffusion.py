"""PyTorch port vs the JAX package and the reference goldens: schedule
tables, respacing, inpainting masks, and the sampling loop (alone on the toy
goldens, and around the style model against the JAX loop), on the CPU.

Trajectory tests pin the noise (sample_loop's noise=/step_noise= hooks) with
numpy draws fed to both packages, since the two frameworks' generators
differ. fp32 trajectories are held at atol 2e-4; the fused (bf16) ones at
relative L2 2e-2, the bf16 rounding of two denoiser calls.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from motionstyle.data.masks import get_inpainting_mask as jget_mask
from motionstyle.diffusion import sampling as jsampling
from motionstyle.diffusion.ddpm import Inpainting as JInpainting
from motionstyle.diffusion.schedule import make_schedule as jmake_schedule
from motionstyle.diffusion.schedule import space_timesteps as jspace_timesteps
from motionstyle_torch.data.masks import LAYOUTS, get_inpainting_mask
from motionstyle_torch.diffusion import ddpm, sampling
from motionstyle_torch.diffusion.ddpm import Inpainting
from motionstyle_torch.diffusion.schedule import make_schedule, space_timesteps
from tests.test_torch_models import one_torch_thread, style_pair  # noqa: F401

ATOL = 2e-4
FUSED_REL_L2 = 2e-2


def _t(a):
    return torch.from_numpy(np.asarray(a))


class TestSchedule:
    TABLES = ["betas", "alphas_cumprod", "posterior_variance",
              "posterior_log_variance_clipped", "posterior_mean_coef1",
              "posterior_mean_coef2", "sqrt_alphas_cumprod",
              "sqrt_one_minus_alphas_cumprod"]

    def test_cosine_tables_golden(self, goldens):
        g = goldens["schedule"]
        s = make_schedule("cosine", 1000, device="cpu")
        for name in self.TABLES:
            np.testing.assert_allclose(getattr(s, name).numpy(), g[name],
                                       rtol=2e-5, atol=1e-7, err_msg=name)

    def test_respaced_tables_golden(self, goldens):
        g = goldens["schedule"]
        s = make_schedule("cosine", 1000, "ddim20", device="cpu")
        assert s.num_timesteps == 20
        np.testing.assert_allclose(s.betas.numpy(), g["sp_betas"], rtol=2e-5, atol=1e-7)
        np.testing.assert_array_equal(s.timestep_map.numpy(), g["sp_timestep_map"])
        np.testing.assert_allclose(s.posterior_log_variance_clipped.numpy(),
                                   g["sp_posterior_log_variance_clipped"],
                                   rtol=2e-5, atol=1e-6)

    @pytest.mark.parametrize("name,steps,respacing", [
        ("cosine", 1000, "ddim20"), ("linear", 1000, None), ("cosine", 40, "ddim10"),
        ("cosine", 300, "10,15,20")])
    def test_tables_equal_jax(self, name, steps, respacing):
        ours = make_schedule(name, steps, respacing, device="cpu")
        ref = jmake_schedule(name, steps, respacing)
        for field in ours.__dataclass_fields__:
            a = getattr(ours, field)
            if torch.is_tensor(a):
                np.testing.assert_array_equal(a.numpy(), np.asarray(getattr(ref, field)),
                                              err_msg=field)

    @pytest.mark.parametrize("counts", ["ddim20", "ddim100", "10,15,20", [5, 7]])
    def test_space_timesteps_equal_jax(self, counts):
        assert space_timesteps(300 if not str(counts).startswith("ddim") else 1000, counts) \
            == jspace_timesteps(300 if not str(counts).startswith("ddim") else 1000, counts)

    def test_q_sample_inpainting_keeps_content(self):
        s = make_schedule("cosine", 1000, device="cpu")
        x0 = torch.randn(2, 4, 1, 3, generator=torch.Generator().manual_seed(0))
        mask = torch.zeros_like(x0)
        mask[:, :2] = 1.0
        t = torch.tensor([500, 999])
        xt = ddpm.q_sample(s, x0, t, torch.ones_like(x0), Inpainting(mask, x0))
        scale = s.sqrt_alphas_cumprod[t].reshape(-1, 1, 1, 1)
        torch.testing.assert_close(xt[:, :2], (scale * x0)[:, :2])


class TestMasks:
    @pytest.mark.parametrize("dataset,key,D", [
        ("stylexia_posrot", "stylexia", 181), ("bandai-2_posrot", "bandai", 190),
        ("humanml_posrot", "hml_posrot", 199), ("humanml", "humanml", 263)])
    @pytest.mark.parametrize("name", ["root", "root_horizontal", "y_rotation",
                                      "upper_body", "lower_body"])
    def test_named_masks_golden(self, goldens, dataset, key, D, name):
        ours = get_inpainting_mask(name, (2, D, 1, 5), dataset=dataset)
        np.testing.assert_array_equal(ours, goldens["masks"][f"{key}__{name}"])

    def test_joint_mask_golden(self, goldens):
        ours = get_inpainting_mask("root_horizontal,ltoes", (2, 181, 1, 5),
                                   dataset="stylexia_posrot")
        np.testing.assert_array_equal(ours, goldens["masks"]["stylexia__root_horizontal_ltoes"])

    @pytest.mark.parametrize("dataset", sorted(set(LAYOUTS) - {"kit"}))
    def test_all_names_equal_jax(self, dataset):
        D = LAYOUTS[dataset].dim
        names = ["root", "root_horizontal", "y_rotation", "linear_vel", "xz_plane",
                 "upper_body", "lower_body", "right_hand", "root_horizontal,lower_body"]
        for name in names:
            np.testing.assert_array_equal(
                get_inpainting_mask(name, (1, D, 1, 6), dataset=dataset),
                jget_mask(name, (1, D, 1, 6), dataset=dataset), err_msg=name)
        kw = dict(lengths=[6, 4], prefix_end=0.25, suffix_end=0.75)
        np.testing.assert_array_equal(
            get_inpainting_mask("in_between", (2, D, 1, 6), dataset=dataset, **kw),
            jget_mask("in_between", (2, D, 1, 6), dataset=dataset, **kw))


def _toy_model_fn(g):
    W, t_scale = _t(g["W"]), _t(g["t_scale"])

    def model_fn(x, t_orig, cond):
        xt = torch.einsum("bcft,cd->bdft", x, W)
        return xt + t_scale[None, :, None, None] * t_orig.float().reshape(-1, 1, 1, 1)

    return model_fn


class TestSamplerGoldens:
    def _kw(self, g):
        return dict(noise=_t(g["init_noise"]), init_image=_t(g["content"]),
                    inpainting=Inpainting(_t(g["mask"]), _t(g["content"])),
                    clip_denoised=False, dump_all_xstart=True)

    def test_ddim_inpainting_trajectory(self, goldens):
        """DDIM-20, skip 14, warm start, inpainting, dump_all_xstart: the demo
        configuration, against the torch reference."""
        g = goldens["sampler_toy"]
        sched = make_schedule("cosine", 1000, "ddim20", device="cpu")
        out = sampling.sample_loop(sched, _toy_model_fn(g), {}, method="ddim",
                                   skip_timesteps=14, **self._kw(g))
        np.testing.assert_allclose(out.numpy(), g["ddim_stack"], atol=1e-4)

    def test_ddpm_stop_timesteps_trajectory(self, goldens):
        g = goldens["sampler_toy"]
        sched = make_schedule("cosine", 1000, device="cpu")
        out = sampling.sample_loop(sched, _toy_model_fn(g), {}, method="ddpm",
                                   stop_timesteps=990, step_noise=_t(g["ddpm_step_noise"]),
                                   **self._kw(g))
        np.testing.assert_allclose(out.numpy(), g["ddpm_stack"], atol=1e-4)

    def test_early_stop_equals_dump_pick(self, goldens):
        g = goldens["sampler_toy"]
        sched = make_schedule("cosine", 1000, "ddim20", device="cpu")
        full = sampling.sample_loop(sched, _toy_model_fn(g), {}, method="ddim",
                                    skip_timesteps=14, **self._kw(g))
        stopped = sampling.sample_loop(sched, _toy_model_fn(g), {}, method="ddim",
                                       skip_timesteps=14, stop_timesteps=4, **self._kw(g))
        assert stopped.shape[0] == 2
        torch.testing.assert_close(full[-5], stopped[-1], rtol=0, atol=0)

    @pytest.mark.parametrize("num_timesteps,skip", [(20, 14), (20, 0), (10, 7), (20, 17)])
    def test_min_latency_plan_equals_jax(self, num_timesteps, skip):
        assert sampling.min_latency_plan(num_timesteps, skip) == \
            jsampling.min_latency_plan(num_timesteps, skip)

    def test_step_noise_length_checked(self, goldens):
        g = goldens["sampler_toy"]
        sched = make_schedule("cosine", 1000, "ddim20", device="cpu")
        with pytest.raises(ValueError, match="step_noise"):
            sampling.sample_loop(sched, _toy_model_fn(g), {}, method="ddim",
                                 skip_timesteps=14, step_noise=torch.zeros(3, 1, 8, 1, 10),
                                 **self._kw(g))


def _style_trajectories(method: str, fused: bool, seed: int):
    """The same style-model sampling run through the JAX loop and the port's
    loop: root_horizontal-style inpainting, pinned noise. Returns both
    (S, B, C, 1, T) dump stacks (or final samples for DDPM)."""
    kw = dict(latent_dim=128, ff_size=256, num_heads=4)
    if fused:
        kw.update(fused=True, dtype="bfloat16")
    jmodel, params, port = style_pair(seed, **kw)
    rs = np.random.RandomState(seed + 1)
    B, C, T = 2, 12, 8
    content = rs.randn(B, C, 1, T).astype(np.float32)
    noise = rs.randn(B, C, 1, T).astype(np.float32)
    mask = np.zeros((B, C, 1, T), np.float32)
    mask[:, :3] = 1.0
    enc = rs.randn(B, 32).astype(np.float32)
    if method == "ddim":
        loop = dict(method="ddim", skip_timesteps=14, stop_timesteps=4, dump_all_xstart=True)
        n_steps = 2
    else:
        loop = dict(method="ddpm", skip_timesteps=12, stop_timesteps=5, dump_all_xstart=False)
        n_steps = 3
    step_noise = rs.randn(n_steps, B, C, 1, T).astype(np.float32)

    jsched = jmake_schedule("cosine", 1000, "ddim20")
    want = jsampling.sample_loop(
        jsched, lambda x, t, c: jmodel.apply(params, x, t, c["enc_text"]),
        {"enc_text": jnp.asarray(enc)}, jax.random.PRNGKey(0),
        noise=jnp.asarray(noise), init_image=jnp.asarray(content),
        inpainting=JInpainting(jnp.asarray(mask), jnp.asarray(content)),
        step_noise=jnp.asarray(step_noise), **loop)
    sched = make_schedule("cosine", 1000, "ddim20", device="cpu")
    got = sampling.sample_loop(
        sched, lambda x, t, c: port(x, t, c["enc_text"]), {"enc_text": _t(enc)},
        noise=_t(noise), init_image=_t(content),
        inpainting=Inpainting(_t(mask), _t(content)), step_noise=_t(step_noise), **loop)
    return got.numpy(), np.asarray(want), mask, content


class TestSampleLoopVsJax:
    @pytest.mark.parametrize("method", ["ddim", "ddpm"])
    def test_fp32_trajectory(self, method):
        got, want, mask, content = _style_trajectories(method, fused=False, seed=20)
        assert got.shape == want.shape
        np.testing.assert_allclose(got, want, atol=ATOL)
        if method == "ddim":  # the served x0 keeps the content channels exactly
            np.testing.assert_array_equal(got[-1] * mask, content * mask)

    def test_fused_trajectory(self):
        """--fused serving numerics: the twin in the port's loop against the
        Pallas kernel (interpret mode) in the JAX loop."""
        got, want, mask, content = _style_trajectories("ddim", fused=True, seed=30)
        rel = np.linalg.norm(got - want) / np.linalg.norm(want)
        assert rel <= FUSED_REL_L2, rel
        np.testing.assert_array_equal(got[-1] * mask, content * mask)
