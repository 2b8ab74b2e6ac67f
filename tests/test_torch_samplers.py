"""PyTorch port vs the JAX package: classifier guidance (cond_fn,
condition_mean, condition_score), classifier-free guidance (cfg_model_fn),
the PLMS and forecast samplers and the VLB terms, on the CPU.

Mirrors tests/test_arch_variants.py::TestClassifierGuidance,
tests/test_models.py::TestCFG, tests/test_plms_vlb.py and
tests/test_forecast_sampling.py, with the JAX functions and the goldens
(sampler_toy.npz, plms_toy.npz, mdm_model.npz) as the oracle. Noise is
pinned with numpy draws fed to both packages. Toy trajectories are held at
atol 1e-4 (the sampler goldens' bound, tests/test_torch_diffusion.py), the
PLMS golden at the JAX test's 2e-3, the full-width MDM at 2e-4
(tests/test_models.py:35).
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from motionstyle.diffusion import ddpm as jddpm
from motionstyle.diffusion import sampling as jsampling
from motionstyle.diffusion import vlb as jvlb
from motionstyle.diffusion.forecast_sampling import forecast_sample_loop as jforecast
from motionstyle.diffusion.plms import plms_sample_loop as jplms
from motionstyle.diffusion.schedule import make_schedule as jmake_schedule
from motionstyle_torch.diffusion import ddpm, sampling, vlb
from motionstyle_torch.diffusion.ddpm import Inpainting
from motionstyle_torch.diffusion.forecast_sampling import forecast_plan, forecast_sample_loop
from motionstyle_torch.diffusion.plms import plms_sample_loop
from motionstyle_torch.diffusion.schedule import make_schedule
from motionstyle_torch.models.denoiser import MDM, MDMConfig
from motionstyle_torch.models.params import from_torch_state_dict
from tests.test_torch_diffusion import _toy_model_fn
from tests.test_torch_models import one_torch_thread  # noqa: F401

ATOL = 1e-4


def _t(a):
    return torch.from_numpy(np.array(a))


def _jtoy(g):
    W, t_scale = jnp.asarray(g["W"]), jnp.asarray(g["t_scale"])

    def model_fn(x, t_orig, cond):
        return jnp.einsum("bcft,cd->bdft", x, W) + t_scale[None, :, None, None] * t_orig.astype(
            jnp.float32).reshape(-1, 1, 1, 1)

    return model_fn


class TestClassifierGuidance:
    @pytest.mark.parametrize("method", ["ddim", "ddpm"])
    def test_cond_fn_trajectory_matches_jax(self, goldens, method):
        """A constant upward gradient (tests/test_arch_variants.py:53-70):
        DDIM shifts the score, DDPM the mean; the port's guided sample
        equals JAX's and sits above the unguided one."""
        g = goldens["sampler_toy"]
        steps = 6
        step_noise = np.random.RandomState(0).randn(steps, *g["init_noise"].shape).astype(
            np.float32)
        kw = dict(init_image=g["content"], method=method, skip_timesteps=14,
                  step_noise=step_noise)

        def jrun(cond_fn):
            return np.asarray(jsampling.sample_loop(
                jmake_schedule("cosine", 1000, "ddim20"), _jtoy(g), {}, jax.random.PRNGKey(0),
                noise=jnp.asarray(g["init_noise"]), cond_fn=cond_fn,
                **{k: jnp.asarray(v) if isinstance(v, np.ndarray) else v for k, v in kw.items()}))

        sched = make_schedule("cosine", 1000, "ddim20", device="cpu")
        base = sampling.sample_loop(sched, _toy_model_fn(g), {}, noise=_t(g["init_noise"]),
                                    **{k: _t(v) if isinstance(v, np.ndarray) else v
                                       for k, v in kw.items()})
        guided = sampling.sample_loop(sched, _toy_model_fn(g), {}, noise=_t(g["init_noise"]),
                                      cond_fn=lambda x, t, c: torch.ones_like(x) * 0.5,
                                      **{k: _t(v) if isinstance(v, np.ndarray) else v
                                         for k, v in kw.items()})
        want = jrun(lambda x, t, c: jnp.ones_like(x) * 0.5)
        np.testing.assert_allclose(guided.numpy(), want, atol=ATOL)
        # the JAX test's bound for DDIM's score shift; DDPM's mean shift (var * grad) is smaller
        assert float((guided - base).mean()) > (1e-4 if method == "ddim" else 0.0)

    def test_condition_mean_formula(self):
        """tests/test_arch_variants.py:72-80."""
        sched = make_schedule("cosine", 1000, device="cpu")
        x = torch.ones(1, 4, 1, 3)
        pmv = ddpm.PMeanVariance(x, torch.zeros_like(x), x)
        out = ddpm.condition_mean(sched, lambda *_: torch.full_like(x, 2.0), pmv, x,
                                  torch.tensor([100]), {})
        torch.testing.assert_close(out, x + 2.0, rtol=0, atol=0)

    def test_condition_score_matches_jax(self):
        r = np.random.RandomState(1)
        x, x0, grad = (r.randn(2, 4, 1, 3).astype(np.float32) for _ in range(3))
        t = np.array([100, 900])
        lv = np.full_like(x, -3.0)
        jsched = jmake_schedule("cosine", 1000)
        want = jddpm.condition_score(jsched, lambda *_: jnp.asarray(grad),
                                     jddpm.PMeanVariance(jnp.asarray(x), jnp.asarray(lv),
                                                         jnp.asarray(x0)),
                                     jnp.asarray(x), jnp.asarray(t), {})
        got = ddpm.condition_score(make_schedule("cosine", 1000, device="cpu"),
                                   lambda *_: _t(grad), ddpm.PMeanVariance(_t(x), _t(lv), _t(x0)),
                                   _t(x), _t(t), {})
        for a, b in zip(got, want):
            np.testing.assert_allclose(a.numpy(), np.asarray(b), atol=1e-5)


def _golden_mdm(goldens):
    g = goldens["mdm_model"]
    sd = {k[len("sd__"):]: g[k] for k in g.files if k.startswith("sd__")}
    cfg = MDMConfig(njoints=181, nfeats=1)
    model = MDM(cfg)
    model.load_state_dict({k[len("mdm."):]: v for k, v in from_torch_state_dict(sd, cfg).items()})
    model.eval()

    def model_fn(x, t, cond):
        with torch.no_grad():
            return model(x, t, cond["enc_text"])

    return model_fn, g


class TestCFG:
    def test_cfg_scale_one_equals_cond(self, goldens):
        """tests/test_models.py:215-227 on the port's full-width MDM."""
        model_fn, g = _golden_mdm(goldens)
        x, t = _t(g["x"][:1]), _t(g["t"][:1])
        cond = {"enc_text": _t(g["enc_text"][:1])}
        guided = ddpm.cfg_model_fn(model_fn, torch.ones(1))(x, t, cond)
        np.testing.assert_allclose(guided.numpy(), model_fn(x, t, cond).numpy(), atol=1e-5)

    def test_cfg_formula_and_reference(self, goldens):
        """tests/test_models.py:229-244, and the guided output against the
        torch reference's cond/uncond outputs' blend."""
        model_fn, g = _golden_mdm(goldens)
        x, t, enc = _t(g["x"][:1]), _t(g["t"][:1]), _t(g["enc_text"][:1])
        scale = 2.5
        guided = ddpm.cfg_model_fn(model_fn, torch.full((1,), scale))(x, t, {"enc_text": enc})
        out_c = model_fn(x, t, {"enc_text": enc})
        out_u = model_fn(x, t, {"enc_text": torch.zeros_like(enc)})
        np.testing.assert_allclose(guided.numpy(), (out_u + scale * (out_c - out_u)).numpy(),
                                   atol=ATOL)
        np.testing.assert_allclose(out_c.numpy(), g["out"][:1], atol=2e-4)

    def test_per_clip_scale_tiles_like_jax(self):
        """A per-clip scale tiled over a batch that is a multiple of it (the
        parallel-in-time sampler's folding), against the JAX wrapper."""
        r = np.random.RandomState(2)
        W = r.randn(6, 6).astype(np.float32) * 0.3
        x = r.randn(4, 6, 1, 5).astype(np.float32)
        t = np.array([3, 7, 3, 7])
        enc = r.randn(4, 8).astype(np.float32)
        scale = np.array([1.5, 3.0], np.float32)

        def jmodel(x, t, cond):
            return jnp.einsum("bcft,cd->bdft", x, jnp.asarray(W)) + cond["enc_text"].sum(
                -1).reshape(-1, 1, 1, 1) * t.reshape(-1, 1, 1, 1)

        def tmodel(x, t, cond):
            return torch.einsum("bcft,cd->bdft", x, _t(W)) + cond["enc_text"].sum(
                -1).reshape(-1, 1, 1, 1) * t.reshape(-1, 1, 1, 1)

        want = jddpm.cfg_model_fn(jmodel, jnp.asarray(scale))(
            jnp.asarray(x), jnp.asarray(t), {"enc_text": jnp.asarray(enc)})
        got = ddpm.cfg_model_fn(tmodel, _t(scale))(_t(x), _t(t), {"enc_text": _t(enc)})
        np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=1e-5)


class TestPLMS:
    def _run(self, g, order, fn=plms_sample_loop):
        return fn(make_schedule("cosine", 1000, "ddim20", device="cpu"), _toy_model_fn(g), {},
                  noise=_t(g["init_noise"]), init_image=_t(g["content"]), skip_timesteps=14,
                  order=order)

    def test_plms_order2_golden(self, goldens):
        """tests/test_plms_vlb.py:21-29, at its bound."""
        out = self._run(goldens["sampler_toy"], 2)
        np.testing.assert_allclose(out.numpy(), goldens["plms_toy"]["plms"], atol=2e-3)

    def test_plms_order1_equals_ddim(self, goldens):
        g = goldens["sampler_toy"]
        ddim = sampling.sample_loop(make_schedule("cosine", 1000, "ddim20", device="cpu"),
                                    _toy_model_fn(g), {}, noise=_t(g["init_noise"]),
                                    init_image=_t(g["content"]), method="ddim",
                                    skip_timesteps=14)
        np.testing.assert_allclose(self._run(g, 1).numpy(), ddim.numpy(), atol=ATOL)

    @pytest.mark.parametrize("order", [1, 2, 3, 4])
    def test_matches_jax(self, goldens, order):
        g = goldens["sampler_toy"]
        want = jplms(jmake_schedule("cosine", 1000, "ddim20"), _jtoy(g), {},
                     jax.random.PRNGKey(0), noise=jnp.asarray(g["init_noise"]),
                     init_image=jnp.asarray(g["content"]), skip_timesteps=10, order=order)
        got = plms_sample_loop(make_schedule("cosine", 1000, "ddim20", device="cpu"),
                               _toy_model_fn(g), {}, noise=_t(g["init_noise"]),
                               init_image=_t(g["content"]), skip_timesteps=10, order=order)
        np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=ATOL)

    def test_bad_order_raises(self, goldens):
        with pytest.raises(ValueError, match="order"):
            self._run(goldens["sampler_toy"], 5)


class TestForecastSampling:
    """tests/test_forecast_sampling.py on the port, plus the port against the
    JAX sampler with the same pinned noise."""

    B, C, T = 2, 8, 10

    def _toy(self, contractive=0.1, seed=1):
        W = np.random.RandomState(seed).randn(self.C, self.C).astype(np.float32) * contractive
        calls = []

        def model_fn(x, t, cond):
            calls.append(1)
            return torch.einsum("bcft,cd->bdft", x, _t(W))

        return model_fn, calls, W

    def _noise(self, steps):
        r = np.random.RandomState(4)
        return (r.randn(self.B, self.C, 1, self.T).astype(np.float32),
                r.randn(steps, self.B, self.C, 1, self.T).astype(np.float32))

    def _run(self, stride, method="ddpm", steps=200, inpainting=None, order=1, **kw):
        model_fn, _, _ = self._toy()
        noise, step_noise = self._noise(steps - kw.get("skip_timesteps", 0))
        return forecast_sample_loop(
            make_schedule("cosine", steps, device="cpu"), model_fn, {}, noise=_t(noise),
            method=method, inpainting=inpainting, stride=stride, order=order,
            step_noise=_t(step_noise), **kw).numpy()

    @pytest.mark.parametrize("stride, order, method", [
        (2, 1, "ddpm"), (4, 0, "ddpm"), (4, 2, "ddpm"), (3, 2, "ddim")])
    def test_matches_jax(self, stride, order, method):
        steps = 50
        _, _, W = self._toy()
        noise, step_noise = self._noise(steps)
        want = jforecast(jmake_schedule("cosine", steps),
                         lambda x, t, c: jnp.einsum("bcft,cd->bdft", x, jnp.asarray(W)), {},
                         jax.random.PRNGKey(0), noise=jnp.asarray(noise), method=method,
                         stride=stride, order=order, step_noise=jnp.asarray(step_noise))
        got = self._run(stride, method=method, steps=steps, order=order)
        np.testing.assert_allclose(got, np.asarray(want), atol=ATOL)

    def test_stride1_equals_sample_loop(self):
        model_fn, _, _ = self._toy()
        noise, step_noise = self._noise(100)
        sched = make_schedule("cosine", 100, device="cpu")
        a = forecast_sample_loop(sched, model_fn, {}, noise=_t(noise), stride=1,
                                 step_noise=_t(step_noise))
        b = sampling.sample_loop(sched, model_fn, {}, noise=_t(noise), step_noise=_t(step_noise),
                                 remat=False)
        torch.testing.assert_close(a, b, rtol=0, atol=0)

    def test_bounded_deviation_vs_exact(self):
        """The JAX test's loose worst-case ceilings (the toy x0 = 0.1 W x
        tracks the noise, which is adversarial for forecasting)."""
        exact = self._run(stride=1)
        scale = np.abs(exact).mean()
        errs = {s: np.abs(self._run(stride=s) - exact).mean() / scale for s in (2, 4)}
        assert errs[2] < 0.15 and errs[4] < 0.7 and errs[2] < errs[4], errs

    def test_order0_hold_more_robust_on_noisy_toy(self):
        exact = self._run(stride=1)
        scale = np.abs(exact).mean()
        lin = np.abs(self._run(stride=4, order=1) - exact).mean() / scale
        hold = np.abs(self._run(stride=4, order=0) - exact).mean() / scale
        assert hold < lin

    def test_order2_beats_order1_on_smooth_denoiser(self):
        steps = 200
        sched = make_schedule("cosine", steps, device="cpu")
        target = _t(np.random.RandomState(9).randn(1, self.C, 1, self.T).astype(np.float32))

        def model_fn(x, t, cond):
            s = t[0].float() / float(steps)
            return target * (0.4 + 0.9 * s * s) + 0.2 * x

        noise = _t(np.random.RandomState(4).randn(1, self.C, 1, self.T).astype(np.float32))

        def run(stride, order):
            return forecast_sample_loop(sched, model_fn, {}, noise=noise, method="ddim",
                                        stride=stride, order=order).numpy()

        exact = run(1, 1)
        scale = np.abs(exact).mean()
        errs = {o: np.abs(run(5, o) - exact).mean() / scale for o in (0, 1, 2)}
        assert errs[2] < 0.7 * errs[1] and errs[1] < errs[0], errs

    def test_final_eval_gap(self):
        """S=18, stride 4: evaluations 0, 4, 8, 12, 16 and the forced 17, one
        step after 16; its slope divides by that gap of 1."""
        do_eval, offsets, gaps = forecast_plan(18, 4)
        assert list(np.flatnonzero(do_eval)) == [0, 4, 8, 12, 16, 17]
        assert gaps[17] == 1 and gaps[16] == 4 and offsets[15] == 3
        assert np.isfinite(self._run(stride=4, steps=18)).all()

    def test_ddim_deterministic_bounded(self):
        exact = self._run(stride=1, method="ddim", steps=100)
        approx = self._run(stride=2, method="ddim", steps=100)
        assert np.abs(approx - exact).mean() / np.abs(exact).mean() < 0.15

    def test_inpainting_channels_kept_exactly(self):
        mask = torch.zeros(self.B, self.C, 1, self.T)
        mask[:, :3] = 1.0
        motion = _t(np.random.RandomState(7).randn(self.B, self.C, 1, self.T).astype(np.float32))
        out = self._run(stride=4, inpainting=Inpainting(mask, motion), init_image=motion,
                        skip_timesteps=20)
        np.testing.assert_array_equal(out[:, :3], motion[:, :3].numpy())

    def test_denoiser_called_on_stride_schedule(self):
        """S=17, stride 4: evaluations at steps 0, 4, 8, 12, 16 only."""
        model_fn, calls, _ = self._toy()
        forecast_sample_loop(make_schedule("cosine", 17, device="cpu"), model_fn, {},
                             torch.Generator().manual_seed(0), shape=(1, self.C, 1, self.T),
                             stride=4)
        assert len(calls) == 5


class TestVLB:
    def test_normal_kl_zero_for_identical(self):
        m, lv = torch.tensor([0.3, -1.0]), torch.tensor([0.1, -0.5])
        np.testing.assert_allclose(vlb.normal_kl(m, lv, m, lv).numpy(), 0.0, atol=1e-7)

    def test_normal_kl_standard(self):
        assert float(vlb.normal_kl(1.0, 0.0, 0.0, 0.0)) == pytest.approx(0.5, abs=1e-6)

    def test_discretized_ll_sums_near_one(self):
        bins = torch.linspace(-1, 1, 255)
        ll = vlb.discretized_gaussian_log_likelihood(bins, means=torch.zeros_like(bins),
                                                     log_scales=torch.full_like(bins, -2.0))
        assert 0.98 < float(ll.exp().sum()) < 1.02
        want = jvlb.discretized_gaussian_log_likelihood(
            jnp.linspace(-1, 1, 255), means=jnp.zeros(255), log_scales=jnp.full(255, -2.0))
        # as probabilities: in the tails the log of a difference of two cdfs
        # near 1 cancels, and the two packages' tanh differ by an ulp there
        np.testing.assert_allclose(ll.exp().numpy(), np.exp(np.asarray(want)), atol=1e-6)

    @pytest.mark.parametrize("t", [0, 1, 500])
    def test_vb_terms_match_jax(self, goldens, t):
        """Finite, the decoder NLL at t == 0, the KL otherwise; the port
        against JAX on the same x_t."""
        g = goldens["sampler_toy"]
        x0 = g["content"]
        x_t = np.asarray(jddpm.q_sample(jmake_schedule("cosine", 1000), jnp.asarray(x0),
                                        jnp.asarray([t]), jnp.asarray(g["init_noise"])))
        want = jvlb.vb_terms_bpd(jmake_schedule("cosine", 1000), _jtoy(g), jnp.asarray(x0),
                                 jnp.asarray(x_t), jnp.asarray([t]), {})
        got = vlb.vb_terms_bpd(make_schedule("cosine", 1000, device="cpu"), _toy_model_fn(g),
                               _t(x0), _t(x_t), _t(np.array([t])), {})
        assert torch.isfinite(got["output"]).all()
        np.testing.assert_allclose(got["output"].numpy(), np.asarray(want["output"]),
                                   rtol=1e-4, atol=1e-5)
        np.testing.assert_allclose(got["pred_xstart"].numpy(), np.asarray(want["pred_xstart"]),
                                   atol=1e-5)

    def test_prior_bpd_matches_jax(self, goldens):
        x0 = goldens["sampler_toy"]["content"]
        want = jvlb.prior_bpd(jmake_schedule("cosine", 1000), jnp.asarray(x0))
        got = vlb.prior_bpd(make_schedule("cosine", 1000, device="cpu"), _t(x0))
        np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=1e-4, atol=1e-7)

    def test_training_losses_mse_matches_jax(self, goldens):
        g = goldens["sampler_toy"]
        x0 = g["content"]
        key = jax.random.PRNGKey(0)
        noise = np.asarray(jax.random.normal(key, x0.shape, dtype=jnp.float32))
        want = jvlb.training_losses_mse(jmake_schedule("cosine", 1000), _jtoy(g),
                                        jnp.asarray(x0), jnp.asarray([500]), {}, key)
        got = vlb.training_losses_mse(make_schedule("cosine", 1000, device="cpu"),
                                      _toy_model_fn(g), _t(x0), torch.tensor([500]), {},
                                      noise=_t(noise))
        assert got["loss"].shape == (1,) and torch.isfinite(got["loss"]).all()
        np.testing.assert_allclose(got["loss"].numpy(), np.asarray(want["loss"]), rtol=1e-5)

    def test_update_ema(self):
        out = vlb.update_ema({"a": torch.ones(3)}, {"a": torch.zeros(3)}, rate=0.9)
        np.testing.assert_allclose(out["a"].numpy(), 0.9)

    def test_timestep_embedding_matches_jax(self):
        ts = np.array([0, 10, 999])
        for dim in (128, 7):
            got = vlb.timestep_embedding(_t(ts), dim)
            want = jvlb.timestep_embedding(jnp.asarray(ts), dim)
            assert got.shape == (3, dim)
            np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=1e-4)
