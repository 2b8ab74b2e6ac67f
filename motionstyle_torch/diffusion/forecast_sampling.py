"""Training-free acceleration: multistep forecasting of the denoiser's x0.

Counterpart of motionstyle/diffusion/forecast_sampling.py. The denoiser is
evaluated only on every `stride`-th reverse step (and always on the last);
the steps in between extrapolate the x0 prediction from the last
evaluations by Newton backward differences (technique: "Predict to Skip",
arXiv:2602.18093). The JAX package's lax.cond per step becomes a Python
branch, so a forecast step costs a few elementwise ops and no denoiser
call. stride=1 is sample_loop exactly.

Supports ddpm/ddim, inpainting (the x0 blend commutes with the linear
forecast because the kept channels are constant), skip/stop ranges and
init_image warm starts; guidance-wrapped model_fns work unchanged. Not
supported: dump_all_xstart and differentiable (the finetune stays exact).
Runs under torch.no_grad() on the schedule's device.
"""
from __future__ import annotations

from typing import Optional

import numpy as np
import torch

from motionstyle_torch.diffusion import ddpm, sampling
from motionstyle_torch.diffusion.ddpm import Inpainting, ModelFn, PMeanVariance
from motionstyle_torch.diffusion.schedule import DiffusionSchedule


def forecast_plan(num_steps: int, stride: int) -> tuple:
    """(do_eval, offsets, gaps) per step: evaluate on steps 0, stride,
    2*stride, ... and always on the last; offsets = steps since the last
    evaluation; at an evaluation, gaps = its distance from the previous one
    (== stride except the forced last, which may be closer)."""
    do_eval = np.zeros(num_steps, dtype=bool)
    do_eval[::stride] = True
    do_eval[-1] = True
    offsets = np.zeros(num_steps, dtype=np.float32)
    gaps = np.ones(num_steps, dtype=np.float32)
    last = 0
    for i in range(num_steps):
        if do_eval[i]:
            gaps[i] = max(i - last, 1)
            last = i
        offsets[i] = i - last
    return do_eval, offsets, gaps


@torch.no_grad()
def forecast_sample_loop(
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
    sigma_small: bool = True,
    stride: int = 2,
    order: int = 1,
    step_noise: Optional[torch.Tensor] = None,
) -> torch.Tensor:
    """Reverse diffusion with denoiser calls on every stride-th step and x0
    forecasts in between; stride <= 1 delegates to sampling.sample_loop.

    order: 2 = quadratic extrapolation from the last three evaluations, 1 =
    linear from the last two, 0 = zero-order hold. Higher orders warm up
    through the lower ones: the k-th difference stays zero until k + 1
    evaluations exist. Noise not pinned by `noise`/`step_noise` is drawn from
    `generator`."""
    if stride <= 1:
        return sampling.sample_loop(
            sched, model_fn, cond, generator, shape=shape, noise=noise,
            init_image=init_image, method=method, skip_timesteps=skip_timesteps,
            stop_timesteps=stop_timesteps, clip_denoised=clip_denoised,
            inpainting=inpainting, eta=eta, sigma_small=sigma_small,
            step_noise=step_noise, remat=False)
    device = sched.device
    if noise is None:
        assert shape is not None, "need shape when noise is not given"
        img = torch.randn(shape, generator=generator, device=device)
    else:
        img = noise.to(device=device, dtype=torch.float32)
        shape = tuple(img.shape)

    idx = sampling.timestep_indices(sched.num_timesteps, skip_timesteps, stop_timesteps)
    if step_noise is not None and step_noise.shape[0] != len(idx):
        raise ValueError(f"step_noise covers {step_noise.shape[0]} steps, "
                         f"the chain has {len(idx)}")
    if skip_timesteps and init_image is None:
        init_image = torch.zeros_like(img)
    if init_image is not None:
        t0 = torch.full((shape[0],), int(idx[0]), dtype=torch.int64, device=device)
        img = ddpm.q_sample(sched, init_image, t0, img, inpainting=inpainting)

    do_eval, offsets, gaps = forecast_plan(len(idx), stride)
    x = img
    x0_last = slope = curv = torch.zeros_like(img)
    nevals = 0
    for i, t_scalar in enumerate(idx):
        t = torch.full((shape[0],), int(t_scalar), dtype=torch.int64, device=device)
        off, gap = float(offsets[i]), float(gaps[i])
        if do_eval[i]:
            x0 = model_fn(x, sched.timestep_map[t], cond)
            if inpainting is not None:
                x0 = x0 * (1.0 - inpainting.mask) + inpainting.motion * inpainting.mask
        else:
            x0 = x0_last + slope * off
            if order >= 2:
                x0 = x0 + curv * (off * (off + float(stride)) * 0.5)
        if clip_denoised:  # after the forecast, as sample_loop clips every step
            x0 = x0.clamp(-1.0, 1.0)
        if do_eval[i]:
            raw_slope = (x0 - x0_last) / gap
            new_slope = raw_slope * float(nevals >= 1) * float(min(order, 1))
            if order >= 2:
                curv = (raw_slope - slope) / gap * float(nevals >= 2)
            slope, x0_last, nevals = new_slope, x0, nevals + 1

        pmv = PMeanVariance(ddpm.q_posterior_mean(sched, x0, x, t),
                            ddpm.step_log_variance(sched, t, x.ndim, sigma_small), x0)
        if step_noise is not None:
            noise_step = step_noise[i].to(device)
        else:
            noise_step = torch.randn(shape, generator=generator, device=device)
        if method == "ddim":
            x = sampling._ddim_update(sched, pmv, x, t, noise_step, inpainting, eta)
        else:
            x = sampling._ddpm_update(pmv, x, t, noise_step, inpainting)
    return x
