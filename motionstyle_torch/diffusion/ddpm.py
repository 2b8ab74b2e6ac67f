"""DDPM math on torch tensors: q(x_t|x_0) with inpainting, the posterior,
p_mean_variance with the inpainting x0 blend, classifier guidance
(condition_mean, condition_score) and classifier-free guidance
(cfg_model_fn).

Counterpart of motionstyle/diffusion/ddpm.py (parity:
gaussian_diffusion.py:250-452, START_X mean type, FIXED_SMALL/FIXED_LARGE
variance; inpainting_gaussian_diffusion.py). The denoiser is
`model_fn(x, t_orig, cond) -> x0`, with t_orig already mapped through the
respacing timestep_map.
"""
from __future__ import annotations

from typing import Callable, NamedTuple, Optional

import torch

from motionstyle_torch.diffusion.schedule import DiffusionSchedule

ModelFn = Callable[[torch.Tensor, torch.Tensor, dict], torch.Tensor]


class Inpainting(NamedTuple):
    """Inpainting condition: mask==1 keeps `motion`'s features frozen."""

    mask: torch.Tensor  # (B, C, 1, T) float, 1 = keep ground truth
    motion: torch.Tensor  # (B, C, 1, T) the content motion to keep


def q_sample(sched: DiffusionSchedule, x_start: torch.Tensor, t: torch.Tensor,
             noise: torch.Tensor, inpainting: Optional[Inpainting] = None) -> torch.Tensor:
    """Sample q(x_t | x_0); with inpainting, no noise on kept features."""
    if inpainting is not None:
        noise = noise * (1.0 - inpainting.mask)
    return (sched.extract(sched.sqrt_alphas_cumprod, t, x_start.ndim) * x_start
            + sched.extract(sched.sqrt_one_minus_alphas_cumprod, t, x_start.ndim) * noise)


def q_posterior_mean(sched: DiffusionSchedule, x_start, x_t, t):
    return (sched.extract(sched.posterior_mean_coef1, t, x_t.ndim) * x_start
            + sched.extract(sched.posterior_mean_coef2, t, x_t.ndim) * x_t)


def predict_xstart_from_eps(sched: DiffusionSchedule, x_t, t, eps):
    return (sched.extract(sched.sqrt_recip_alphas_cumprod, t, x_t.ndim) * x_t
            - sched.extract(sched.sqrt_recipm1_alphas_cumprod, t, x_t.ndim) * eps)


def predict_eps_from_xstart(sched: DiffusionSchedule, x_t, t, xstart):
    return ((sched.extract(sched.sqrt_recip_alphas_cumprod, t, x_t.ndim) * x_t - xstart)
            / sched.extract(sched.sqrt_recipm1_alphas_cumprod, t, x_t.ndim))


class PMeanVariance(NamedTuple):
    mean: torch.Tensor
    log_variance: torch.Tensor
    pred_xstart: torch.Tensor


def step_log_variance(sched: DiffusionSchedule, t, ndim: int, sigma_small: bool):
    """FIXED_SMALL (clipped posterior) or FIXED_LARGE log variance."""
    if sigma_small:
        return sched.extract(sched.posterior_log_variance_clipped, t, ndim)
    fixed_large = torch.log(torch.cat([sched.posterior_variance[1:2], sched.betas[1:]]))
    return sched.extract(fixed_large, t, ndim)


def p_mean_variance(sched: DiffusionSchedule, model_fn: ModelFn, x: torch.Tensor,
                    t: torch.Tensor, cond: dict, clip_denoised: bool = False,
                    inpainting: Optional[Inpainting] = None,
                    sigma_small: bool = True) -> PMeanVariance:
    """Run the denoiser (START_X) and form the reverse-step Gaussian, with
    the x0-level inpainting blend (gaussian_diffusion.py:341-349)."""
    model_output = model_fn(x, sched.timestep_map[t], cond)
    if inpainting is not None:
        model_output = model_output * (1.0 - inpainting.mask) + inpainting.motion * inpainting.mask
    pred_xstart = model_output.clamp(-1.0, 1.0) if clip_denoised else model_output
    mean = q_posterior_mean(sched, pred_xstart, x, t)
    return PMeanVariance(mean, step_log_variance(sched, t, x.ndim, sigma_small), pred_xstart)


def masked_l2(a: torch.Tensor, b: torch.Tensor, mask: torch.Tensor) -> torch.Tensor:
    """Per-sample mean squared error over unmasked elements. a, b (B, C, F,
    T); mask (B, 1, 1, T). Parity: gaussian_diffusion.py:223-235
    (normalised by mask frames x C x F)."""
    loss = ((a - b) ** 2 * mask).sum(dim=(1, 2, 3))
    return loss / (mask.sum(dim=(1, 2, 3)) * (a.shape[1] * a.shape[2]))


def condition_mean(sched: DiffusionSchedule, cond_fn, pmv: PMeanVariance, x: torch.Tensor,
                   t: torch.Tensor, cond: dict) -> torch.Tensor:
    """Classifier-guidance mean shift (Sohl-Dickstein): mean + var * grad,
    cond_fn(x, t_orig, cond) -> grad log p(y|x). Parity:
    gaussian_diffusion.py:454-467."""
    gradient = cond_fn(x, sched.timestep_map[t], cond)
    return pmv.mean + torch.exp(pmv.log_variance) * gradient


def condition_score(sched: DiffusionSchedule, cond_fn, pmv: PMeanVariance, x: torch.Tensor,
                    t: torch.Tensor, cond: dict) -> PMeanVariance:
    """Score-based conditioning (Song et al.): eps shifted by
    -sqrt(1 - abar) * grad, then x0 and the mean recomputed. Parity:
    gaussian_diffusion.py:486-530."""
    alpha_bar = sched.extract(sched.alphas_cumprod, t, x.ndim)
    eps = predict_eps_from_xstart(sched, x, t, pmv.pred_xstart)
    eps = eps - torch.sqrt(1 - alpha_bar) * cond_fn(x, sched.timestep_map[t], cond)
    pred_xstart = predict_xstart_from_eps(sched, x, t, eps)
    return PMeanVariance(q_posterior_mean(sched, pred_xstart, x, t), pmv.log_variance,
                         pred_xstart)


def cfg_model_fn(model_fn: ModelFn, scale: torch.Tensor) -> ModelFn:
    """Classifier-free guidance as one batched forward over the cond and
    uncond halves (the reference's two calls, cfg_sampler.py:36-43). The
    uncond half zeroes cond['enc_text'], mask_cond's null condition. A
    per-clip scale is tiled when the batch is a multiple of it."""

    def wrapped(x, t_orig, cond):
        cond2 = dict(cond)
        enc = cond["enc_text"]
        cond2["enc_text"] = torch.cat([enc, torch.zeros_like(enc)], dim=0)
        out = model_fn(torch.cat([x, x], dim=0), torch.cat([t_orig, t_orig], dim=0), cond2)
        out_cond, out_uncond = out.chunk(2, dim=0)
        s = torch.as_tensor(scale, dtype=out.dtype, device=out.device).reshape(-1)
        s = s.repeat(x.shape[0] // s.shape[0]).reshape((-1,) + (1,) * (x.ndim - 1))
        return out_uncond + s * (out_cond - out_uncond)

    return wrapped
