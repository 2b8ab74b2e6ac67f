"""DDPM / DDIM sampling loops as a Python loop over timesteps.

Counterpart of motionstyle/diffusion/sampling.py, whose lax.scan becomes a
loop here (PyTorch runs eagerly):

  - skip_timesteps / stop_timesteps select the descending index range;
  - init_image warm start = q_sample at the first index (:1052-1054);
  - inpainting: noise *= (1 - mask) and the x0 blend in p_mean_variance;
  - dump_all_xstart returns the stacked per-step x0 predictions (S, B, ...),
    highest t first, the reference's dump list order;
  - `noise` pins the initial noise and `step_noise` (S, B, ...) the per-step
    noise, so tests replay the JAX package's draws exactly;
  - differentiable=True is the finetune unroll (:100-212): each step's x0
    prediction stays in the autograd graph while the carried sample is
    detached between steps, and with remat each step's body runs under
    torch.utils.checkpoint (jax.checkpoint's counterpart). The step noise is
    drawn before the checkpointed body; a model_fn that draws dropout must
    re-seed its own generator per call so the recompute sees the same masks.
  - cond_fn adds classifier guidance: DDPM shifts the mean
    (ddpm.condition_mean), DDIM the score (ddpm.condition_score);
  - fused_update=True runs each DDPM step's update as one kernel launch
    (ops/sampler_update.py, kernel 3) under the JAX loop's conditions: DDPM,
    no grad, no x0 clipping, sigma_small, no cond_fn, no const_noise and no
    pinned step noise; otherwise the normal path runs. Its noise comes from
    the kernel's Philox stream, seeded once per loop from `generator`.
  - each step runs inside the span sampler.step (tracing.py).
"""
from __future__ import annotations

import contextlib
from typing import Optional

import numpy as np
import torch
from torch.utils.checkpoint import checkpoint

from motionstyle_torch import tracing
from motionstyle_torch.diffusion import ddpm
from motionstyle_torch.diffusion.ddpm import Inpainting, ModelFn
from motionstyle_torch.diffusion.schedule import DiffusionSchedule
from motionstyle_torch.ops.sampler_update import fused_ddpm_update
from motionstyle_torch.parallel.mesh import draw_rows


def timestep_indices(num_timesteps: int, skip_timesteps: int,
                     stop_timesteps: Optional[int]) -> np.ndarray:
    """Descending respaced indices; parity with gaussian_diffusion.py:1047-1050."""
    lo = 0 if stop_timesteps is None else stop_timesteps
    idx = np.arange(lo, num_timesteps - skip_timesteps)[::-1]
    if len(idx) == 0:
        raise ValueError("empty timestep range")
    return idx


def min_latency_plan(num_timesteps: int, skip_timesteps: int) -> tuple:
    """(stop_timesteps, dump_pick) for the demo's under-denoise pick: the x0
    five steps from the chain's end (dump[-5]) is the one predicted at t=4
    when the chain has >= 5 live steps, so stopping there is exact and the
    pick becomes dump[-1]; shorter chains run to t=0 with the pick clamped
    to the earliest dumped x0. Same contract as the JAX package's."""
    live = num_timesteps - skip_timesteps
    if live >= 5:
        return 4, -1
    return None, -min(5, live)


def _nonzero(t: torch.Tensor, x: torch.Tensor) -> torch.Tensor:
    return (t != 0).to(x.dtype).reshape((-1,) + (1,) * (x.ndim - 1))


def _ddpm_update(pmv, x, t, noise, inpainting):
    if inpainting is not None:
        noise = noise * (1.0 - inpainting.mask)
    return pmv.mean + _nonzero(t, x) * torch.exp(0.5 * pmv.log_variance) * noise


def _ddim_update(sched, pmv, x, t, noise, inpainting, eta):
    eps = ddpm.predict_eps_from_xstart(sched, x, t, pmv.pred_xstart)
    alpha_bar = sched.extract(sched.alphas_cumprod, t, x.ndim)
    alpha_bar_prev = sched.extract(sched.alphas_cumprod_prev, t, x.ndim)
    sigma = (eta * torch.sqrt((1 - alpha_bar_prev) / (1 - alpha_bar))
             * torch.sqrt(1 - alpha_bar / alpha_bar_prev))
    if inpainting is not None:
        noise = noise * (1.0 - inpainting.mask)
    mean_pred = (pmv.pred_xstart * torch.sqrt(alpha_bar_prev)
                 + torch.sqrt(torch.clamp(1 - alpha_bar_prev - sigma ** 2, min=0.0)) * eps)
    return mean_pred + _nonzero(t, x) * sigma * noise


def use_fused_update(fused_update: bool, method: str, differentiable: bool,
                     clip_denoised: bool, sigma_small: bool, cond_fn, const_noise: bool,
                     step_noise) -> bool:
    """The JAX loop's predicate for the fused update (sampling.py:146-149):
    the hot serving configuration only."""
    return (fused_update and method != "ddim" and not differentiable and not clip_denoised
            and sigma_small and cond_fn is None and not const_noise and step_noise is None)


def draw_base_seed(generator: Optional[torch.Generator], device) -> int:
    """The fused update's base seed, in [0, 2^30), from `generator` (the JAX
    loop's randint(fold_in(rng, 7), (), 0, 2^30)); step t uses base + t. The
    one host read of a fused loop."""
    dev = generator.device if generator is not None else device
    return int(torch.randint(0, 2 ** 30, (), generator=generator, device=dev))


def fused_update_table(sched: DiffusionSchedule, idx: np.ndarray) -> torch.Tensor:
    """(len(idx), 4) fp32 on the schedule's device: each step's [c1, c2,
    sigma = exp(0.5 * posterior_log_variance_clipped), nonzero], built once
    per loop so that no step reads a scalar on the host."""
    t = torch.as_tensor(np.ascontiguousarray(idx), dtype=torch.int64, device=sched.device)
    return torch.stack([sched.posterior_mean_coef1[t], sched.posterior_mean_coef2[t],
                        torch.exp(0.5 * sched.posterior_log_variance_clipped[t]),
                        (t != 0).to(torch.float32)], dim=1)


def sample_loop(
    sched: DiffusionSchedule,
    model_fn: ModelFn,
    cond: dict,
    generator: Optional[torch.Generator] = None,
    *,
    shape: Optional[tuple] = None,
    noise: Optional[torch.Tensor] = None,
    init_image: Optional[torch.Tensor] = None,
    method: str = "ddpm",
    skip_timesteps: int = 0,
    stop_timesteps: Optional[int] = None,
    clip_denoised: bool = False,
    inpainting: Optional[Inpainting] = None,
    eta: float = 0.0,
    const_noise: bool = False,
    dump_all_xstart: bool = False,
    sigma_small: bool = True,
    step_noise: Optional[torch.Tensor] = None,
    differentiable: bool = False,
    remat: bool = True,
    cond_fn=None,
    fused_update: bool = False,
) -> torch.Tensor:
    """Run the reverse diffusion on the schedule's device. Returns the final
    sample, or the stacked per-step x0 predictions (S, B, C, F, T) with
    dump_all_xstart. Noise not pinned by `noise`/`step_noise` is drawn from
    `generator` (a torch.Generator on the schedule's device). Without
    `differentiable` the loop runs under torch.no_grad(). cond_fn(x, t_orig,
    cond) -> grad log p(y|x) guides each step; fused_update asks for the
    fused DDPM update (see the module docstring for when it runs)."""
    with contextlib.nullcontext() if differentiable else torch.no_grad():
        device = sched.device
        if noise is None:
            assert shape is not None, "need shape when noise is not given"
            img = draw_rows(lambda s: torch.randn(s, generator=generator, device=device), shape)
        else:
            img = noise.to(device=device, dtype=torch.float32)
            shape = tuple(img.shape)

        idx = timestep_indices(sched.num_timesteps, skip_timesteps, stop_timesteps)
        if step_noise is not None and step_noise.shape[0] != len(idx):
            raise ValueError(f"step_noise covers {step_noise.shape[0]} steps, "
                             f"the chain has {len(idx)}")
        if skip_timesteps and init_image is None:
            init_image = torch.zeros_like(img)
        if init_image is not None:
            t0 = torch.full((shape[0],), int(idx[0]), dtype=torch.int64, device=device)
            img = ddpm.q_sample(sched, init_image, t0, img, inpainting=inpainting)

        fused = use_fused_update(fused_update, method, differentiable, clip_denoised,
                                 sigma_small, cond_fn, const_noise, step_noise)
        if fused:
            base_seed = draw_base_seed(generator, device)
            table = fused_update_table(sched, idx)
            mask = motion = None
            if inpainting is not None:
                mask = inpainting.mask.float().expand(shape).contiguous()
                motion = inpainting.motion.float().expand(shape).contiguous()

        xs = []
        x = img
        for i, t_scalar in enumerate(idx):
            with tracing.span("sampler.step"):
                t = torch.full((shape[0],), int(t_scalar), dtype=torch.int64, device=device)
                if fused:
                    model_output = model_fn(x, sched.timestep_map[t], cond)
                    x, pred_xstart = fused_ddpm_update(
                        x, model_output.float().contiguous(), mask, motion, *table[i],
                        base_seed + int(t_scalar))
                    if dump_all_xstart:
                        xs.append(pred_xstart)  # the blended x0, as the JAX loop dumps
                    continue
                if step_noise is not None:
                    noise_step = step_noise[i].to(device)
                elif method == "ddim" and eta == 0.0:
                    noise_step = torch.zeros_like(x)  # multiplied by sigma = 0
                else:
                    noise_step = draw_rows(lambda s: torch.randn(s, generator=generator,
                                                                 device=device), shape)
                if const_noise:
                    noise_step = noise_step[:1].expand(shape)

                def step(x_in, t=t, noise_step=noise_step):
                    pmv = ddpm.p_mean_variance(sched, model_fn, x_in, t, cond,
                                               clip_denoised=clip_denoised, inpainting=inpainting,
                                               sigma_small=sigma_small)
                    if cond_fn is not None:  # classifier guidance
                        if method == "ddim":
                            pmv = ddpm.condition_score(sched, cond_fn, pmv, x_in, t, cond)
                        else:
                            pmv = ddpm.PMeanVariance(
                                ddpm.condition_mean(sched, cond_fn, pmv, x_in, t, cond),
                                pmv.log_variance, pmv.pred_xstart)
                    if method == "ddim":
                        return _ddim_update(sched, pmv, x_in, t, noise_step, inpainting, eta), \
                            pmv.pred_xstart
                    return _ddpm_update(pmv, x_in, t, noise_step, inpainting), pmv.pred_xstart

                if differentiable and remat:
                    x, pred_xstart = checkpoint(step, x, use_reentrant=False)
                else:
                    x, pred_xstart = step(x)
                if differentiable:
                    x = x.detach()  # gradients reach each step's x0 only
                if dump_all_xstart:
                    xs.append(pred_xstart)
        return torch.stack(xs) if dump_all_xstart else x
