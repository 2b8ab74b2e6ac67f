"""Variational-lower-bound terms and training-loss utilities on torch
tensors.

Counterpart of motionstyle/diffusion/vlb.py (parity: diffusion/losses.py
normal_kl :12, approx_standard_normal_cdf :42,
discretized_gaussian_log_likelihood :50; gaussian_diffusion.py
_vb_terms_bpd :1281-1314; diffusion/nn.py update_ema :56, mean_flat :87,
sum_flat :93, timestep_embedding :110). update_ema takes dicts of tensors
(a state_dict) where the JAX package takes a pytree.
"""
from __future__ import annotations

import math
from typing import Optional

import torch

from motionstyle_torch.diffusion import ddpm
from motionstyle_torch.diffusion.schedule import DiffusionSchedule


def mean_flat(x: torch.Tensor) -> torch.Tensor:
    return x.mean(dim=tuple(range(1, x.ndim)))


def sum_flat(x: torch.Tensor) -> torch.Tensor:
    return x.sum(dim=tuple(range(1, x.ndim)))


def normal_kl(mean1, logvar1, mean2, logvar2) -> torch.Tensor:
    """KL divergence between diagonal Gaussians (nats per element); any
    argument may be a Python number."""
    mean1, logvar1, mean2, logvar2 = (torch.as_tensor(a, dtype=torch.float32)
                                      for a in (mean1, logvar1, mean2, logvar2))
    return 0.5 * (-1.0 + logvar2 - logvar1 + torch.exp(logvar1 - logvar2)
                  + ((mean1 - mean2) ** 2) * torch.exp(-logvar2))


def approx_standard_normal_cdf(x: torch.Tensor) -> torch.Tensor:
    return 0.5 * (1.0 + torch.tanh(math.sqrt(2.0 / math.pi) * (x + 0.044715 * x ** 3)))


def discretized_gaussian_log_likelihood(x, *, means, log_scales) -> torch.Tensor:
    """Log-likelihood of a Gaussian discretized to 1/255 bins ([-1, 1] data)."""
    centered_x = x - means
    inv_stdv = torch.exp(-log_scales)
    cdf_plus = approx_standard_normal_cdf(inv_stdv * (centered_x + 1.0 / 255.0))
    cdf_min = approx_standard_normal_cdf(inv_stdv * (centered_x - 1.0 / 255.0))
    log_cdf_plus = torch.log(cdf_plus.clamp(min=1e-12))
    log_one_minus_cdf_min = torch.log((1.0 - cdf_min).clamp(min=1e-12))
    log_cdf_delta = torch.log((cdf_plus - cdf_min).clamp(min=1e-12))
    return torch.where(x < -0.999, log_cdf_plus,
                       torch.where(x > 0.999, log_one_minus_cdf_min, log_cdf_delta))


def vb_terms_bpd(sched: DiffusionSchedule, model_fn, x_start: torch.Tensor,
                 x_t: torch.Tensor, t: torch.Tensor, cond: dict, clip_denoised: bool = True,
                 inpainting=None) -> dict:
    """KL(q(x_{t-1}|x_t,x_0) || p(x_{t-1}|x_t)) in bits per dim, the t=0
    decoder NLL at t == 0; parity: gaussian_diffusion.py:1281-1314."""
    true_mean = ddpm.q_posterior_mean(sched, x_start, x_t, t)
    true_logvar = sched.extract(sched.posterior_log_variance_clipped, t, x_t.ndim)
    pmv = ddpm.p_mean_variance(sched, model_fn, x_t, t, cond, clip_denoised=clip_denoised,
                               inpainting=inpainting)
    kl = mean_flat(normal_kl(true_mean, true_logvar, pmv.mean, pmv.log_variance)) / math.log(2.0)
    decoder_nll = -discretized_gaussian_log_likelihood(
        x_start, means=pmv.mean, log_scales=0.5 * pmv.log_variance)
    decoder_nll = mean_flat(decoder_nll) / math.log(2.0)
    return {"output": torch.where(t == 0, decoder_nll, kl), "pred_xstart": pmv.pred_xstart}


def prior_bpd(sched: DiffusionSchedule, x_start: torch.Tensor) -> torch.Tensor:
    """KL(q(x_T|x_0) || N(0, I)) in bits per dim."""
    t = torch.full((x_start.shape[0],), sched.num_timesteps - 1, dtype=torch.int64,
                   device=x_start.device)
    mean = sched.extract(sched.sqrt_alphas_cumprod, t, x_start.ndim) * x_start
    logvar = sched.extract(sched.log_one_minus_alphas_cumprod, t, x_start.ndim)
    return mean_flat(normal_kl(mean, logvar, 0.0, 0.0)) / math.log(2.0)


def training_losses_mse(sched: DiffusionSchedule, model_fn, x_start: torch.Tensor,
                        t: torch.Tensor, cond: dict,
                        generator: Optional[torch.Generator] = None,
                        mask: Optional[torch.Tensor] = None, inpainting=None,
                        noise: Optional[torch.Tensor] = None) -> dict:
    """The START_X MSE training loss (the reference's base-MDM pretrain
    objective, training_losses with MSE + masked_l2). The noise is drawn
    from `generator` unless `noise` pins it."""
    if noise is None:
        noise = torch.randn(x_start.shape, generator=generator, device=x_start.device)
    x_t = ddpm.q_sample(sched, x_start, t, noise, inpainting=inpainting)
    model_output = model_fn(x_t, sched.timestep_map[t], cond)
    if mask is None:
        mask = torch.ones((x_start.shape[0], 1, 1, x_start.shape[-1]), dtype=x_start.dtype,
                          device=x_start.device)
    rot_mse = ddpm.masked_l2(x_start, model_output, mask)
    return {"rot_mse": rot_mse, "loss": rot_mse}


@torch.no_grad()
def update_ema(ema_params: dict, new_params: dict, rate: float = 0.9999) -> dict:
    """EMA over a dict of tensors; parity: diffusion/nn.py:56."""
    return {k: e * rate + new_params[k] * (1 - rate) for k, e in ema_params.items()}


def timestep_embedding(timesteps: torch.Tensor, dim: int, max_period: int = 10000
                       ) -> torch.Tensor:
    """Sinusoidal timestep embeddings; parity: diffusion/nn.py:110-128."""
    half = dim // 2
    freqs = torch.exp(-math.log(max_period)
                      * torch.arange(half, dtype=torch.float32, device=timesteps.device) / half)
    args = timesteps[:, None].float() * freqs[None]
    emb = torch.cat([torch.cos(args), torch.sin(args)], dim=-1)
    if dim % 2:
        emb = torch.cat([emb, torch.zeros_like(emb[:, :1])], dim=-1)
    return emb
