"""PyTorch port vs the JAX package: the fused DDPM update (kernel 3's plain
version), its Box-Muller, its noise stream and the sampler's fused path, on
the CPU. Mirrors tests/test_sampler_update.py.

The JAX kernel runs in its CPU interpret mode, whose hardware-PRNG stand-in
gives constant bits, so only the parts without noise are compared with it
(atol 1e-6: the same fp32 operations in the same order). The port's noise is
counter-based Philox, so its seed behaviour and distribution, which JAX can
test only on a TPU, are tested here on the plain version.
"""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from motionstyle.ops.sampler_update import box_muller as jbox_muller
from motionstyle.ops.sampler_update import fused_ddpm_update as jfused_ddpm_update
from motionstyle_torch.diffusion import sampling
from motionstyle_torch.diffusion.ddpm import Inpainting
from motionstyle_torch.diffusion.schedule import make_schedule
from motionstyle_torch.ops import sampler_update
from motionstyle_torch.ops.sampler_update import (
    box_muller, fused_ddpm_update, fused_ddpm_update_reference, normal_draws)
from tests.test_torch_models import one_torch_thread  # noqa: F401

B, C, T = 4, 16, 12
C1, C2 = 0.1, 0.9


def _bits(n: int, seed: int = 0) -> np.ndarray:
    return np.random.RandomState(seed).randint(-(2 ** 31), 2 ** 31, size=(2, n), dtype=np.int64)


class TestBoxMuller:
    def test_equals_jax_on_injected_bits(self):
        """Each fp32 step in the JAX order: the two agree to rtol 1e-6 (the
        log and cos of two libraries differ by an ulp)."""
        bits = _bits(1 << 18)
        want = np.asarray(jbox_muller(jnp.asarray(bits[0], jnp.int32),
                                      jnp.asarray(bits[1], jnp.int32)))
        got = box_muller(torch.from_numpy(bits[0]).to(torch.int32),
                         torch.from_numpy(bits[1]).to(torch.int32))
        np.testing.assert_allclose(got.numpy(), want, rtol=1e-6)

    def test_distribution_from_injected_bits(self):
        bits = _bits(1 << 18)
        z = box_muller(torch.from_numpy(bits[0]).to(torch.int32),
                       torch.from_numpy(bits[1]).to(torch.int32)).numpy()
        assert np.isfinite(z).all()
        assert abs(z.mean()) < 0.01 and abs(z.std() - 1.0) < 0.01
        assert abs((z < 0).mean() - 0.5) < 0.01
        assert abs((np.abs(z) > 2).mean() - 0.0455) < 0.005

    def test_extreme_bits(self):
        """INT32_MIN maps u1 to 2^-32 (log-safe), INT32_MAX maps u1 to exactly
        1 (z = 0) and u2 to exactly 1 (cos = 1); both kept from the JAX
        package, as JAX computes them."""
        lo, hi = -(2 ** 31), 2 ** 31 - 1
        pairs = torch.tensor([[lo, lo], [lo, hi], [hi, lo], [hi, hi]], dtype=torch.int32)
        z = box_muller(pairs[:, 0], pairs[:, 1])
        want = np.asarray(jbox_muller(jnp.asarray(pairs[:, 0].numpy()),
                                      jnp.asarray(pairs[:, 1].numpy())))
        assert torch.isfinite(z).all()
        np.testing.assert_allclose(z.numpy(), want, rtol=1e-6)
        assert z[2] == 0 and z[3] == 0  # u1 == 1
        assert z[1] == pytest.approx(float(np.sqrt(64 * np.log(2.0))), rel=1e-6)  # u2 == 1


class TestNormalDraws:
    def test_distribution(self):
        z = normal_draws(7, 1 << 20).numpy()
        assert abs(z.mean()) < 0.005 and abs(z.std() - 1.0) < 0.005
        assert abs((np.abs(z) > 2).mean() - 0.0455) < 0.003

    def test_depends_only_on_seed_and_index(self):
        """A prefix of a longer draw is the shorter draw (odd lengths too):
        element e's words come from the Philox of pair e >> 1."""
        long = normal_draws(11, 1001)
        for n in (1, 2, 7, 500):
            torch.testing.assert_close(normal_draws(11, n), long[:n], rtol=0, atol=0)
        assert not torch.equal(normal_draws(12, 1001), long)


class TestFusedUpdate:
    def setup_method(self):
        r = np.random.RandomState(0)
        self.x = r.randn(B, C, 1, T).astype(np.float32)
        self.x0 = r.randn(B, C, 1, T).astype(np.float32)
        self.mask = np.zeros((B, C, 1, T), np.float32)
        self.mask[:, :3] = 1.0
        self.motion = np.ones((B, C, 1, T), np.float32)

    def _port(self, sigma=0.05, nonzero=1.0, seed=7, masked=True, fn=fused_ddpm_update):
        t = torch.from_numpy
        return fn(t(self.x), t(self.x0), t(self.mask) if masked else None,
                  t(self.motion) if masked else None, C1, C2, sigma, nonzero, seed)

    def _jax(self, sigma=0.05, nonzero=1.0, seed=7):
        out, xstart = jfused_ddpm_update(
            jnp.asarray(self.x), jnp.asarray(self.x0), jnp.asarray(self.mask),
            jnp.asarray(self.motion), jnp.float32(C1), jnp.float32(C2), jnp.float32(sigma),
            jnp.float32(nonzero), seed, block_rows=32)
        return np.asarray(out), np.asarray(xstart)

    def test_deterministic_parts_match_jax(self):
        out, xstart = self._port(sigma=0.0)
        want_out, want_xstart = self._jax(sigma=0.0)
        np.testing.assert_allclose(xstart.numpy(), want_xstart, atol=1e-6)
        np.testing.assert_allclose(out.numpy(), want_out, atol=1e-6)
        blended = self.x0 * (1 - self.mask) + self.motion * self.mask
        np.testing.assert_allclose(out.numpy(), C1 * blended + C2 * self.x, atol=1e-6)

    def test_t0_no_noise_matches_jax(self):
        out, _ = self._port(sigma=1.0, nonzero=0.0)
        want, _ = self._jax(sigma=1.0, nonzero=0.0)
        np.testing.assert_allclose(out.numpy(), want, atol=1e-6)

    def test_noise_masked_matches_jax(self):
        """At sigma = 1 the kept channels carry no noise in either package."""
        out, xstart = self._port(sigma=1.0)
        want, _ = self._jax(sigma=1.0)
        mean = C1 * xstart.numpy() + C2 * self.x
        np.testing.assert_allclose(out.numpy()[:, :3], mean[:, :3], atol=1e-6)
        np.testing.assert_allclose(out.numpy()[:, :3], want[:, :3], atol=1e-6)
        assert np.abs(out.numpy()[:, 3:] - mean[:, 3:]).max() > 0.1

    def test_noise_is_the_draws(self):
        """The free channels carry sigma * normal_draws(seed): the update's
        noise is the documented stream."""
        out, xstart = self._port(sigma=1.0, seed=9)
        z = normal_draws(9, B * C * T).reshape(B, C, 1, T)
        mean = C1 * xstart + C2 * torch.from_numpy(self.x)
        np.testing.assert_allclose((out - mean)[:, 3:].numpy(), z[:, 3:].numpy(), atol=1e-6)

    def test_no_mask_equals_zero_mask(self):
        a, xa = self._port(sigma=0.5, masked=False)
        self.mask[:] = 0.0
        self.motion[:] = 0.0
        b, xb = self._port(sigma=0.5)
        torch.testing.assert_close(a, b, rtol=0, atol=0)
        torch.testing.assert_close(xa, xb, rtol=0, atol=0)

    def test_seed_reproducible_and_sensitive(self):
        a, _ = self._port(seed=42)
        b, _ = self._port(seed=42)
        c, _ = self._port(seed=43)
        torch.testing.assert_close(a, b, rtol=0, atol=0)
        assert (a - c).abs().max() > 0

    def test_reshaped_input_gives_the_same_draws(self):
        """The bits depend only on the flat element index, never on the
        layout or a tiling: (4, 16, 1, 12) and (2, 32, 1, 12) views of the
        same values give the same update."""
        out, _ = self._port(sigma=1.0, seed=5)
        t = torch.from_numpy
        shape = (2, 32, 1, 12)
        again, _ = fused_ddpm_update(
            t(self.x).reshape(shape), t(self.x0).reshape(shape), t(self.mask).reshape(shape),
            t(self.motion).reshape(shape), C1, C2, 1.0, 1.0, 5)
        torch.testing.assert_close(again.reshape(out.shape), out, rtol=0, atol=0)

    def test_wrapper_runs_the_twin_on_cpu(self):
        a = self._port(sigma=0.3, seed=3)
        b = self._port(sigma=0.3, seed=3, fn=fused_ddpm_update_reference)
        for u, v in zip(a, b):
            torch.testing.assert_close(u, v, rtol=0, atol=0)

    def test_kernel_input_checks(self):
        x = torch.zeros(B, C, 1, T)
        with pytest.raises(ValueError, match="together"):
            sampler_update._check_cuda_inputs(x, x, x, None)
        with pytest.raises(ValueError, match="contiguous float32"):
            sampler_update._check_cuda_inputs(x, x.double(), None, None)
        with pytest.raises(ValueError, match="contiguous float32"):
            sampler_update._check_cuda_inputs(x, x.transpose(1, 3), None, None)


def _toy_model(seed: int = 1, c: int = C):
    W = torch.from_numpy(np.random.RandomState(seed).randn(c, c).astype(np.float32) * 0.05)
    return lambda x, t, cond: torch.einsum("bcft,cd->bdft", x, W)


def _inpainting():
    mask = torch.zeros(2, C, 1, T)
    mask[:, :3] = 1.0
    motion = torch.from_numpy(np.random.RandomState(3).randn(2, C, 1, T).astype(np.float32))
    return Inpainting(mask, motion)


def test_sample_loop_fused_equals_normal_path_with_the_same_draws():
    """sample_loop(fused_update=True) against the normal DDPM path fed the
    plain version's draws through step_noise: base seed drawn once from the
    generator, step t seeded base + t (a 20-step respaced chain down to
    t = 0, inpainting, dumped x0). atol 1e-5: the two paths form the same
    fp32 mean in a different order."""
    sched = make_schedule("cosine", 1000, "ddim20", device="cpu")
    inp = _inpainting()
    noise = torch.from_numpy(np.random.RandomState(4).randn(2, C, 1, T).astype(np.float32))
    kw = dict(noise=noise, init_image=inp.motion, skip_timesteps=4, inpainting=inp,
              method="ddpm", dump_all_xstart=True)
    fused = sampling.sample_loop(sched, _toy_model(), {}, torch.Generator().manual_seed(5),
                                 fused_update=True, **kw)
    base = sampling.draw_base_seed(torch.Generator().manual_seed(5), "cpu")
    idx = sampling.timestep_indices(sched.num_timesteps, 4, None)
    step_noise = torch.stack([normal_draws(base + int(t), noise.numel()).reshape(noise.shape)
                              for t in idx])
    plain = sampling.sample_loop(sched, _toy_model(), {}, None, step_noise=step_noise, **kw)
    assert fused.shape == plain.shape == (len(idx), 2, C, 1, T)
    np.testing.assert_allclose(fused.numpy(), plain.numpy(), atol=1e-5)
    # every dumped x0 keeps the content's channels exactly
    assert torch.equal(fused[:, :, :3], inp.motion[None, :, :3].expand(len(idx), -1, -1, -1, -1))


def test_sampler_integration_keeps_inpainted_channels():
    """As the JAX package's test_sampler_integration: a 1000-step schedule
    stopped at 995 runs fused; every dumped x0 keeps the content's channels."""
    sched = make_schedule("cosine", 1000, device="cpu")
    inp = _inpainting()
    kw = dict(shape=(2, C, 1, T), init_image=inp.motion, method="ddpm", stop_timesteps=995,
              inpainting=inp, fused_update=True)
    out = sampling.sample_loop(sched, _toy_model(), {}, torch.Generator().manual_seed(0), **kw)
    xs = sampling.sample_loop(sched, _toy_model(), {}, torch.Generator().manual_seed(0),
                              dump_all_xstart=True, **kw)
    assert torch.isfinite(out).all() and xs.shape == (5, 2, C, 1, T)
    assert torch.equal(xs[:, :, :3], inp.motion[None, :, :3].expand(5, -1, -1, -1, -1))


@pytest.mark.parametrize("change, fused", [
    ({}, True),                            # DDPM, no grad, no hooks: fused
    ({"fused_update": False}, False),
    ({"method": "ddim"}, False),
    ({"differentiable": True}, False),
    ({"clip_denoised": True}, False),
    ({"sigma_small": False}, False),
    ({"cond_fn": lambda x, t, c: torch.zeros_like(x)}, False),
    ({"const_noise": True}, False),
    ({"step_noise": torch.zeros(5, 1, C, 1, T)}, False),
])
def test_use_fused_update_predicate(monkeypatch, change, fused):
    """The JAX loop's predicate (motionstyle/diffusion/sampling.py:146-149),
    one condition per case; when it is false the normal path runs."""
    calls = []

    def counting(*args):
        calls.append(1)
        return fused_ddpm_update(*args)

    monkeypatch.setattr(sampling, "fused_ddpm_update", counting)
    kw = dict(fused_update=True, method="ddpm", differentiable=False, clip_denoised=False,
              sigma_small=True, cond_fn=None, const_noise=False, step_noise=None)
    kw.update(change)
    assert sampling.use_fused_update(**kw) is fused
    sched = make_schedule("cosine", 1000, device="cpu")
    out = sampling.sample_loop(sched, _toy_model(), {}, torch.Generator().manual_seed(0),
                               shape=(1, C, 1, T), stop_timesteps=995, remat=False, **kw)
    assert torch.isfinite(out).all()
    assert len(calls) == (5 if fused else 0)


def test_fused_update_table():
    """Each step's [c1, c2, sigma, nonzero] as the JAX loop indexes them."""
    sched = make_schedule("cosine", 1000, "ddim20", device="cpu")
    idx = sampling.timestep_indices(sched.num_timesteps, 0, None)
    table = sampling.fused_update_table(sched, idx)
    jsig = jnp.exp(0.5 * jnp.asarray(sched.posterior_log_variance_clipped.numpy()))
    for i, t in enumerate(idx):
        assert table[i, 0] == sched.posterior_mean_coef1[t]
        assert table[i, 1] == sched.posterior_mean_coef2[t]
        np.testing.assert_allclose(float(table[i, 2]), float(jsig[t]), rtol=1e-6)
        assert table[i, 3] == (t != 0)
