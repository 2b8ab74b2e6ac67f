"""PLMS (Pseudo Linear Multistep) sampling as a Python loop with an eps
history.

Counterpart of motionstyle/diffusion/plms.py (parity:
gaussian_diffusion.py:1084-1279): the Adams-Bashforth history is a list of
the last order - 1 eps predictions, most recent first, and the first step
of an order > 1 run takes the Pseudo Improved Euler double model call
(:1134-1141). Runs under torch.no_grad() on the schedule's device.
"""
from __future__ import annotations

from typing import Optional

import torch

from motionstyle_torch.diffusion import ddpm
from motionstyle_torch.diffusion.ddpm import Inpainting, ModelFn
from motionstyle_torch.diffusion.sampling import timestep_indices
from motionstyle_torch.diffusion.schedule import DiffusionSchedule

# Adams-Bashforth coefficients for orders 1..4, most recent eps first
AB_COEF = ((1.0,), (3.0 / 2.0, -1.0 / 2.0), (23.0 / 12.0, -16.0 / 12.0, 5.0 / 12.0),
           (55.0 / 24.0, -59.0 / 24.0, 37.0 / 24.0, -9.0 / 24.0))


@torch.no_grad()
def plms_sample_loop(
    sched: DiffusionSchedule,
    model_fn: ModelFn,
    cond: dict,
    generator: Optional[torch.Generator] = None,
    *,
    shape: Optional[tuple] = None,
    noise: Optional[torch.Tensor] = None,
    init_image: Optional[torch.Tensor] = None,
    skip_timesteps: int = 0,
    clip_denoised: bool = False,
    inpainting: Optional[Inpainting] = None,
    order: int = 2,
) -> torch.Tensor:
    """PLMS sampling; the conventions of sampling.sample_loop (the initial
    noise from `generator` unless `noise` pins it)."""
    if not 1 <= int(order) <= 4:
        raise ValueError("order is invalid (should be int from 1-4).")
    device = sched.device
    if noise is None:
        assert shape is not None, "need shape when noise is not given"
        img = torch.randn(shape, generator=generator, device=device)
    else:
        img = noise.to(device=device, dtype=torch.float32)
        shape = tuple(img.shape)

    idx = timestep_indices(sched.num_timesteps, skip_timesteps, None)
    if init_image is None and skip_timesteps:
        init_image = torch.zeros_like(img)
    if init_image is not None:
        t0 = torch.full((shape[0],), int(idx[0]), dtype=torch.int64, device=device)
        img = ddpm.q_sample(sched, init_image, t0, img, inpainting=inpainting)

    def eps_of(x, t):
        pmv = ddpm.p_mean_variance(sched, model_fn, x, t, cond, clip_denoised=clip_denoised,
                                   inpainting=inpainting)
        return ddpm.predict_eps_from_xstart(sched, x, t, pmv.pred_xstart), pmv.pred_xstart

    x, history = img, []  # history: earlier steps' eps, most recent first
    for i, t_scalar in enumerate(idx):
        t = torch.full((shape[0],), int(t_scalar), dtype=torch.int64, device=device)
        alpha_bar_prev = sched.extract(sched.alphas_cumprod_prev, t, x.ndim)
        eps, pred_x0 = eps_of(x, t)
        if order > 1 and i == 0:  # Pseudo Improved Euler
            mean_pred = pred_x0 * torch.sqrt(alpha_bar_prev) + torch.sqrt(1 - alpha_bar_prev) * eps
            eps2, _ = eps_of(mean_pred, torch.clamp(t - 1, min=0))
            eps_prime = (eps + eps2) / 2.0
        else:
            hist = [eps] + history[: order - 1]
            coef = AB_COEF[len(hist) - 1]
            eps_prime = sum(c * e for c, e in zip(coef, hist))
        pred_prime = ddpm.predict_xstart_from_eps(sched, x, t, eps_prime)
        mean_pred = (pred_prime * torch.sqrt(alpha_bar_prev)
                     + torch.sqrt(1 - alpha_bar_prev) * eps_prime)
        nonzero = (t != 0).to(x.dtype).reshape((-1,) + (1,) * (x.ndim - 1))
        x = mean_pred * nonzero + pred_x0 * (1 - nonzero)
        history = ([eps] + history)[: max(order - 1, 0)]
    return x
